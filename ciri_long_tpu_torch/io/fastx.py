"""FASTA/FASTQ streaming (reference: find_ccs.py:29-75 format autodetect).

Yields (read_id, seq) tuples; the id is the first whitespace token without
the '>'/'@' sigil, matching find_ccs.py:53-64."""

import gzip
import sys


def _open_any(path):
    if path.endswith('.gz'):
        return gzip.open(path, 'rt')
    return open(path, 'r')


def detect_format(path):
    base = path[:-3] if path.endswith('.gz') else path
    if base.endswith(('.fa', '.fasta')):
        return 'fasta'
    if base.endswith(('.fq', '.fastq')):
        return 'fastq'
    sys.exit('Wrong format of input')


def read_fastx(path):
    """Stream (read_id, seq) from FASTA/FASTQ, optionally gzipped.

    Uses the same two-line record walk as the reference (multi-line FASTA is
    additionally supported for plain FASTA input)."""
    fmt = detect_format(path)
    with _open_any(path) as f:
        if fmt == 'fastq':
            while True:
                header = f.readline()
                if not header:
                    break
                seq = f.readline().rstrip()
                f.readline()
                f.readline()
                read_id = header.rstrip().split(' ')[0].lstrip('@')
                yield read_id, seq
        else:
            read_id, chunks = None, []
            for line in f:
                line = line.rstrip()
                if line.startswith('>'):
                    if read_id is not None:
                        yield read_id, ''.join(chunks)
                    read_id = line.split(' ')[0].split('\t')[0].lstrip('>')
                    chunks = []
                else:
                    chunks.append(line)
            if read_id is not None:
                yield read_id, ''.join(chunks)


def write_fasta_record(fh, header, seq):
    fh.write('>{}\n{}\n'.format(header, seq))
