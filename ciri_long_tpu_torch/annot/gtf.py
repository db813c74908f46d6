"""GTF / circRNA-bed parsing and binned annotation indices.

Reference behavior: GTFParser (align.py:48-70), index_annotation
(align.py:226-272), index_circ (align.py:275-316).  Indices:
  gtf_index:    contig -> 500-bp bin -> [Feature] (gene + exon rows)
  intron_index: contig -> 500-bp bin -> [(start, end, strand)]
  ss_index:     contig -> pos -> strand -> {'start': 1} / {'end': 1}
"""

import logging
import pickle
import re
import sys
from collections import defaultdict
from pathlib import Path

from ciri_long_tpu_torch.utils.misc import tree

LOGGER = logging.getLogger('CIRI-long')

BIN = 500
_ATTR_RE = re.compile(r'(\w+)\s+"([^"]*)"')


class Feature:
    """One gene/exon row of a GTF."""

    __slots__ = ('contig', 'source', 'type', 'start', 'end', 'strand',
                 'attr_string')

    def __init__(self, content):
        self.contig = content[0]
        self.source = content[1]
        self.type = content[2]
        self.start = int(content[3])
        self.end = int(content[4])
        self.strand = content[6]
        self.attr_string = content[8]

    @property
    def attr(self):
        return dict(_ATTR_RE.findall(self.attr_string))


def index_annotation(gtf_path):
    """Build gtf/intron/splice-site indices from a GTF file."""
    LOGGER.info('Indexing annotation GTF')
    gtf_index = defaultdict(dict)
    intron_index = defaultdict(dict)
    ss_index = tree()

    last_exon = None
    with open(gtf_path, 'r') as f:
        for line in f:
            if line.startswith('#'):
                continue
            content = line.rstrip().split('\t')
            if len(content) < 9 or content[2] not in ('gene', 'exon'):
                continue
            feat = Feature(content)

            if feat.type == 'exon':
                ss_index[feat.contig][feat.start][feat.strand]['start'] = 1
                ss_index[feat.contig][feat.end][feat.strand]['end'] = 1

                # intron between consecutive exons of one transcript
                if last_exon is not None and \
                        last_exon.attr.get('transcript_id') == feat.attr.get('transcript_id'):
                    intron_start = last_exon.end if last_exon.strand == '+' else last_exon.start
                    intron_end = feat.start if feat.strand == '+' else feat.end
                    intron_strand = feat.strand
                    lo, hi = min(intron_start, intron_end), max(intron_start, intron_end)
                    for b in range(lo // BIN, hi // BIN + 1):
                        intron_index[feat.contig].setdefault(b, []).append(
                            (lo, hi, intron_strand))
                last_exon = feat

            for b in range(feat.start // BIN, feat.end // BIN + 1):
                gtf_index[feat.contig].setdefault(b, []).append(feat)

    return gtf_index, intron_index, ss_index


def index_circ(circ_file, circ_ss_idx):
    """Merge a user circRNA bed/gtf into the splice-site index."""
    circ_path = Path(circ_file)
    if circ_ss_idx is None:
        circ_ss_idx = tree()

    if circ_path.suffix == '.gtf':
        LOGGER.info('Merging user circRNA GTF into splice-site index')
        with open(circ_path, 'r') as f:
            for line in f:
                if line.startswith('#'):
                    continue
                content = line.rstrip().split('\t')
                feat = Feature(content)
                circ_ss_idx[feat.contig][feat.start][feat.strand]['start'] = 1
                circ_ss_idx[feat.contig][feat.end][feat.strand]['end'] = 1
    elif circ_path.suffix == '.bed':
        LOGGER.info('Merging user circRNA bed into splice-site index')
        n_skip = 0
        with open(circ_path, 'r') as f:
            for line in f:
                content = line.rstrip().split('\t')
                contig = content[0]
                try:
                    start, end = int(content[1]), int(content[2])
                except ValueError:
                    n_skip += 1
                    continue
                strand = content[3]
                circ_ss_idx[contig][start][strand]['start'] = 1
                circ_ss_idx[contig][end][strand]['end'] = 1
        if n_skip:
            LOGGER.warning('{} malformed bed lines ignored'.format(n_skip))
    else:
        sys.exit('{} is not a valid bed/gtf file'.format(str(circ_path)))

    return circ_ss_idx


class _PortUnpickler(pickle.Unpickler):
    """Reads an index pickled by either package: class paths under
    ``ciri_long_tpu`` (Feature, and ``utils.misc.tree`` as the factory of
    its defaultdicts) resolve to this package's copies, so a tmp/ written
    by the JAX package resumes here without importing it."""

    def find_class(self, module, name):
        if module == 'ciri_long_tpu' or module.startswith('ciri_long_tpu.'):
            module = 'ciri_long_tpu_torch' + module[len('ciri_long_tpu'):]
        return super().find_class(module, name)


def load_index(idx_file):
    """[gtf_idx, intron_idx, ss_idx] from a tmp/ss.idx of either package."""
    with open(idx_file, 'rb') as f:
        return _PortUnpickler(f).load()
