"""csrc/chain_dp.cu's DP kernel and variants of it timed on one card, on
call's recorded launch and on copies of its longest row.

    python3 -m ciri_long_tpu_torch.tools.dp_variants [--inputs FILE]
        [--variants JSON]

FILE holds call's largest launch of each X2/X3 kernel (chip_smoke.py writes
build/chip_smoke/call_x_inputs.pt, the default); its ``chain_dp`` launch is
timed as recorded (``call``), and its longest row alone (``one``), in 132,
528 and 1 056 copies (a row an SM, a row a warp scheduler, two a
scheduler).  JSON maps a variant's name to a list of [old, new] text
substitutions made in csrc/chain_dp.cu, or names another ``.cu`` file
with the same C entry points; without it the source alone is timed.  Each
variant is built with nvcc into build/dp_variants/ (``-Xptxas -v``),
launched through ctypes on the port's log2 table and timed as a CUDA
graph's replay of 10 launches (kexp.time_launches); its outputs must equal
the first variant's bit for bit.  Prints one JSON line a variant (ms a set,
registers, and the counts of some instructions of the kernel's SASS from
``cuobjdump -sass``: branches, shuffles, float64 adds), with the card's
name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(HERE, 'ciri_long_tpu_torch', 'csrc', 'chain_dp.cu')
OUT = os.path.join(HERE, 'build', 'dp_variants')
INPUTS = os.path.join(HERE, 'build', 'chip_smoke', 'call_x_inputs.pt')
COPIES = {'one': 1, 'x132': 132, 'x528': 528, 'x1056': 1056}
SASS_OPS = ('BRA', 'BSSY', 'SHFL', 'WARPSYNC', 'DADD', 'DSETP', 'LDG',
            'IMAD.MOV')
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)


def build(name, text):
    """nvcc of one variant's source text; returns (library, ptxas lines,
    SASS instruction counts)."""
    from ciri_long_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, name + '.cu')
    with open(src, 'w') as f:
        f.write(text)
    lib = os.path.join(OUT, name + '.so')
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on {}:\n{}'.format(name,
                                                           proc.stderr))
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if 'registers' in ln or 'spill' in ln]
    tool = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', lib], capture_output=True,
                          text=True).stdout
    kernel = sass[sass.find('chain_dp_kernel'):]
    kernel = kernel[:kernel.find('.section', 1)]
    return lib, ptxas, {op: kernel.count(op) for op in SASS_OPS}


def launch_sets(saved):
    """{set name: (offs, r, q, ctg) CPU tensors}: the recorded launch and
    copies of its longest row."""
    import torch

    offs, r, q, c = saved[:4]
    big = int((offs[1:] - offs[:-1]).argmax())
    lo, hi = int(offs[big]), int(offs[big + 1])
    sets = {'call': (offs, r, q, c)}
    for name, n in COPIES.items():
        sets[name] = (torch.arange(n + 1, dtype=torch.int64) * (hi - lo),
                      *(x[lo:hi].repeat(n).contiguous() for x in (r, q, c)))
    return sets


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m '
                                 'ciri_long_tpu_torch.tools.dp_variants')
    ap.add_argument('--inputs', default=INPUTS)
    ap.add_argument('--variants', default=None,
                    help='JSON {name: [[old, new], ...] or "file.cu"}')
    args = ap.parse_args(argv)
    import torch

    from ciri_long_tpu_torch.misc.kexp import nvidia_smi, time_launches
    from ciri_long_tpu_torch.ops import chain

    with open(SOURCE) as f:
        source = f.read()
    variants = {'chain_dp': []}
    if args.variants:
        with open(args.variants) as f:
            variants = json.load(f)
    dev = torch.device('cuda')
    saved = torch.load(args.inputs)['chain_dp']
    k, _window, gap_r, gap_q = saved[4:]
    lg = chain.card_log2_table(chain.table_size(gap_r, gap_q), dev)
    sets = launch_sets(saved)
    card = nvidia_smi()
    first = {}
    for name, spec in variants.items():
        if isinstance(spec, str):
            with open(spec) as f:
                text = f.read()
        else:
            text = source
            for old, new in spec:
                if old not in text:
                    raise ValueError('{}: no {!r} in the source'.format(
                        name, old[:60]))
                text = text.replace(old, new)
        lib, ptxas, sass = build(name, text)
        fn = ctypes.CDLL(lib).chain_dp_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        line = dict(variant=name, ptxas=ptxas, sass=sass, card=card)
        for set_name, cols in sets.items():
            offs, r, q, c = (x.to(dev) for x in cols)
            f = torch.empty(len(r), dtype=torch.float64, device=dev)
            pre = torch.empty(len(r), dtype=torch.int32, device=dev)

            def step():
                rc = fn(offs.data_ptr(), r.data_ptr(), q.data_ptr(),
                        c.data_ptr(), len(offs) - 1, lg.data_ptr(), k,
                        gap_r, gap_q, f.data_ptr(), pre.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError('{} launch failed: cudaError '
                                       '{}'.format(name, rc))

            line[set_name + '_ms'] = time_launches(step, 10, dev,
                                                   graph=True)
            out = f.cpu().numpy().tobytes() + pre.cpu().numpy().tobytes()
            if first.setdefault(set_name, out) != out:
                raise AssertionError('{} differs from the first variant on '
                                     '{}'.format(name, set_name))
        print(json.dumps(line), flush=True)


if __name__ == '__main__':
    main()
