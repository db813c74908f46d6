"""The port's small entry points on the CPU against the JAX package:

- ``tools/ssw_cli.py --device cpu``, with and without ``--cigar``, prints
  what the JAX ``ssw_cli`` prints for the same two FASTAs (exact matches,
  a gap, N bases, a pair with no positive cell, other scores);
- ``tools/convert_bed.py::convert`` writes the JAX converter's bytes for a
  ``.info`` (comments, both strands, several isoforms, none);
- ``call --profile DIR --device cpu`` writes a Chrome trace under DIR that
  loads as JSON and holds events, and calls the world's 10 BSJ reads.
"""

import json

import pytest

from ciri_long_tpu.tools import convert_bed as jax_bed
from ciri_long_tpu.tools import ssw_cli as jax_ssw
from ciri_long_tpu_torch.cli.main import main as cli_main
from ciri_long_tpu_torch.tools import convert_bed, ssw_cli
from ciri_long_tpu_torch.tools.world import skill_world
from tests.test_pipeline_call import rand_seq


@pytest.fixture
def fastas(tmp_path, rng):
    base = rand_seq(rng, 300)
    t = tmp_path / 't.fa'
    q = tmp_path / 'q.fa'
    t.write_text('>seq1\nACGTACGTTGCA\n>seq2\n{}\n>seq3\nNNNNNNNN\n'.format(
        base))
    q.write_text('>q1\nCGTACGT\n>q2\n{}\n>q3\n{}\n'.format(
        base[40:90] + base[95:160], base[10:60].replace('A', 'N')))
    return str(t), str(q)


@pytest.mark.parametrize('extra', [[], ['--cigar'],
                                   ['--cigar', '--match', '1', '--mismatch',
                                    '3', '--gap-open', '5', '--gap-extend',
                                    '2']])
def test_ssw_cli_prints_jax_output(fastas, capsys, monkeypatch, extra):
    monkeypatch.setattr('sys.argv', ['ssw', *fastas, *extra])
    jax_ssw.main()
    want = capsys.readouterr().out
    ssw_cli.main([*fastas, '--device', 'cpu', *extra])
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 10
    if extra:
        assert '\t7M\n' in got


INFO = (
    '# a comment line\n'
    'chr1\tCIRI-long\tcirc\t101\t900\t12\t+\t.\tcirc_id "chr1:101-900"; '
    'circ_type "exon"; gene_id "G1"; '
    'isoform "101-200,301-400,801-900|101-400,801-900";\n'
    'chr2\tCIRI-long\tcirc\t5001\t5600\t3\t-\t.\tcirc_id "chr2:5001-5600"; '
    'circ_type "intron"; isoform "5001-5600";\n'
    'chr2\tCIRI-long\tcirc\t7001\t7300\t2\t-\t.\tcirc_id "chr2:7001-7300"; '
    'circ_type "intergenic";\n')


def test_convert_bed_bytes(tmp_path):
    info = tmp_path / 'x.info'
    info.write_text(INFO)
    convert_bed.convert(str(info), str(tmp_path / 'port.bed'))
    jax_bed.convert(str(info), str(tmp_path / 'jax.bed'))
    got = (tmp_path / 'port.bed').read_bytes()
    assert got == (tmp_path / 'jax.bed').read_bytes()
    assert len(got.splitlines()) == 3


def test_call_profile(tmp_path):
    ref, reads = skill_world(str(tmp_path / 'w'))
    prof = tmp_path / 'prof'
    cli_main(['call', '-i', reads, '-o', str(tmp_path / 'out'), '-r', ref,
              '-p', 'vtest', '-t', '1', '--device', 'cpu', '--profile',
              str(prof)])
    trace = json.loads((prof / 'vtest.trace.json').read_text())
    assert trace['traceEvents']
    heads = [ln.split('\t')[1] for ln in open(tmp_path / 'out' /
                                              'vtest.cand_circ.fa')
             if ln.startswith('>')]
    assert heads == ['chr1:20001-20520'] * 10
    log = (tmp_path / 'out' / 'vtest.log').read_text()
    assert 'Device trace written to {}'.format(prof / 'vtest.trace.json') \
        in log
