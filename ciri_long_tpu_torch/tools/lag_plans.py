"""csrc/lag_planes.h's segment a block, swept on the card: both kernels on
it (``lag_profile_cuda``, csrc/lag_profile.cu, and
``tandem_counts_cuda``, csrc/tandem_counts.cu) at every segment of
SEGMENTS, on each of tools/call_x_ab.py's LAG_SHAPES batches at MAX_LAG
lags, each held to its plain version and timed as a CUDA graph's replay of
10 launches; the segment ops/period.py::lag_plan picks is marked.

    python3 -m ciri_long_tpu_torch.tools.lag_plans

Prints the card's name and power limit, then one JSON line a (shape,
segment): blocks, ``profile_ms``, ``tandem_ms`` and ``planned``.  Needs a
CUDA device.
"""

import json

SEGMENTS = (4096, 2048, 1024, 512, 256)


def main():
    import torch

    from ciri_long_tpu_torch.misc.kexp import nvidia_smi, time_launches
    from ciri_long_tpu_torch.ops import period
    from ciri_long_tpu_torch.tools.call_x_ab import LAG_SHAPES, lag_case

    dev = torch.device('cuda')
    print(nvidia_smi(), flush=True)
    M = period.MAX_LAG
    planned = period._plan
    try:
        for name in LAG_SHAPES:
            x = torch.from_numpy(lag_case(name)).to(dev)
            B, W = x.shape
            want_p = period.lag_profile_plain(x, M).view(torch.int32)
            want_t = period.tandem_counts_plain(x, M)
            pick = planned(dev, B, W, M)
            for seg in SEGMENTS:
                period._plan = lambda *_, seg=seg: seg
                if not (torch.equal(period.lag_profile_cuda(x, M).view(
                        torch.int32), want_p) and torch.equal(
                            period.tandem_counts_cuda(x, M), want_t)):
                    raise AssertionError('{} at {} positions a block differs '
                                         'from the plain version'.format(
                                             name, seg))
                print(json.dumps(dict(
                    shape=name, seg=seg, planned=seg == pick,
                    blocks=B * -(-M // period.LAG_BLOCK) * -(-W // seg),
                    profile_ms=time_launches(
                        lambda: period.lag_profile_cuda(x, M), 10, dev,
                        graph=True),
                    tandem_ms=time_launches(
                        lambda: period.tandem_counts_cuda(x, M), 10, dev,
                        graph=True))), flush=True)
    finally:
        period._plan = planned


if __name__ == '__main__':
    main()
