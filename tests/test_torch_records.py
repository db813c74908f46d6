"""The port's candidate-record codec (parallel/records.py) against the JAX
package on the CPU, exact:

- every record of a real scan (tests/test_cohort.py's world, built in both
  packages from one seed) packs into the same int32 row in both packages,
  bit for bit, and decodes back to itself;
- the edge fields of test_cohort.py: negative shifts, the denovo and
  annotated splice signals, open-ended exons (``*-``, ``-*``), the
  ``partial`` tag, ``NA`` strand and signal;
- the three capacity asserts (exons, segments, sequence codes) fire in the
  port where they fire in JAX.
"""

import numpy as np
import pytest

from ciri_long_tpu.context import Context as JaxContext
from ciri_long_tpu.io.genome import Genome as JaxGenome
from ciri_long_tpu.models.aligner import GenomeAligner as JaxAligner
from ciri_long_tpu.ops.ccs import find_consensus as jax_find_consensus
from ciri_long_tpu.parallel import records as jrec
from ciri_long_tpu.pipeline.find_bsj import scan_ccs_chunk as jax_scan_chunk
from ciri_long_tpu_torch.context import Context
from ciri_long_tpu_torch.io.genome import Genome
from ciri_long_tpu_torch.models.aligner import GenomeAligner
from ciri_long_tpu_torch.ops.ccs import find_consensus
from ciri_long_tpu_torch.parallel import records as trec
from ciri_long_tpu_torch.pipeline.find_bsj import scan_ccs_chunk
from tests.test_pipeline_call import make_rolling_read, rand_seq


def cohort_worlds(rng):
    """tests/test_cohort.py's cohort_world (4 loci, 5 reads each) in both
    packages: ((port ctx, ccs_seq), (JAX ctx, ccs_seq)), the consensus of
    each read found by each package's own find_consensus (and equal)."""
    chr1 = list(rand_seq(rng, 60_000))
    loci = []
    for t in range(4):
        st = 8_000 + t * 12_000
        en = st + 300 + 60 * t
        chr1[st - 2:st] = list('AG')
        chr1[en:en + 2] = list('GT')
        loci.append((st, en))
    chr1 = ''.join(chr1)
    reads = []
    for st, en in loci:
        unit = chr1[st:en]
        for d in range(5):
            reads.append(make_rolling_read(rng, unit, copies=3.0 + 0.4 * d,
                                           rot=(d * 97) % len(unit),
                                           noise=0.02))
    worlds = []
    for G, A, C, consensus in ((Genome, GenomeAligner, Context,
                                find_consensus),
                               (JaxGenome, JaxAligner, JaxContext,
                                jax_find_consensus)):
        genome = G.from_dict({'chr1': chr1})
        ccs_seq = {}
        for read in reads:
            segments, ccs = consensus(read)
            if segments is not None:
                ccs_seq['read_{:03d}'.format(len(ccs_seq))] = [segments, ccs,
                                                               read]
        worlds.append((C(aligner=A(genome), genome=genome), ccs_seq))
    assert worlds[0][1] == worlds[1][1]
    assert len(worlds[0][1]) >= 12
    return worlds


@pytest.fixture(scope='module')
def worlds(module_rng):
    return cohort_worlds(module_rng)


def test_rows_bit_identical_on_real_records(worlds):
    (ctx, ccs_seq), (jctx, jccs_seq) = worlds
    items = [[rid] + ccs_seq[rid] for rid in ccs_seq]
    _, _, ret = scan_ccs_chunk(ctx, items, True, device='cpu')
    _, _, jret = jax_scan_chunk(jctx, [[rid] + jccs_seq[rid]
                                       for rid in jccs_seq], True)
    assert ret == jret and len(ret) >= 10
    ctg_index = {n: i for i, n in enumerate(ctx.genome.names)}
    ids = {t: rec[0] for t, rec in enumerate(ret)}
    for t, rec in enumerate(ret):
        row = trec.encode_record(rec, t, ctg_index)
        assert row.dtype == np.int32 and row.shape == (trec.REC_W,)
        assert np.array_equal(row, jrec.encode_record(rec, t, ctg_index))
        assert trec.decode_record(row, ids, ctx.genome.names) == rec
    rows, valid = trec.encode_records(list(enumerate(ret)), ctg_index)
    jrows, jvalid = jrec.encode_records(list(enumerate(ret)), ctg_index)
    assert np.array_equal(rows, jrows) and np.array_equal(valid, jvalid)
    empty = trec.encode_records([], ctg_index)
    jempty = jrec.encode_records([], ctg_index)
    assert [a.shape for a in empty] == [a.shape for a in jempty]


EDGE_RECORDS = [
    ('r0', 'chr1:100-200', '+', '100-150|51,160-200|41', 'AG-GT*|-3--5',
     '17|2-300', '0-150;150-290', 'ACGTN' * 10),
    ('r1', 'chrX:5-9', 'NA', '5-9|*-', 'NA', '0|0-7', 'partial', 'A'),
    ('r2', 'scaffold_9:1-2', '-', '1-2|-*', 'AT-AC|10-0', '3|1-2', '0-1',
     'GG'),
]


@pytest.mark.parametrize('t', range(len(EDGE_RECORDS)))
def test_edge_fields(t):
    names = ['chr1', 'chrX', 'scaffold_9']
    idx = {n: i for i, n in enumerate(names)}
    ids = {t: rec[0] for t, rec in enumerate(EDGE_RECORDS)}
    rec = EDGE_RECORDS[t]
    row = trec.encode_record(rec, t, idx)
    assert np.array_equal(row, jrec.encode_record(rec, t, idx))
    assert trec.decode_record(row, ids, names) == rec


@pytest.mark.parametrize('field', ['exons', 'segments', 'seq'])
def test_capacity_asserts(field):
    n = {'exons': trec.MAX_EXONS, 'segments': trec.MAX_SEGS,
         'seq': trec.MAX_SEQ}[field] + 1
    exons = ','.join('{}-{}|2'.format(10 * i, 10 * i + 1)
                     for i in range(n if field == 'exons' else 1))
    segs = ';'.join('{}-{}'.format(i, i + 1)
                    for i in range(n if field == 'segments' else 1))
    seq = 'A' * (n if field == 'seq' else 4)
    rec = ('r0', 'chr1:1-9', '+', exons, 'NA', '0|0-9', segs, seq)
    errors = []
    for mod in (trec, jrec):
        with pytest.raises(AssertionError) as err:
            mod.encode_record(rec, 0, {'chr1': 0})
        errors.append(str(err.value))
    cap = {'exons': 'MAX_EXONS', 'segments': 'MAX_SEGS', 'seq': 'MAX_SEQ'}
    assert errors == ['record exceeds ' + cap[field]] * 2
