"""Convert a collapse `.info` GTF into BED12 with per-isoform blocks.

Port of ciri_long_tpu/tools/convert_bed.py (the same bytes).  Reference
behavior: misc/convert_bed.py:10-32 -- one BED12 row per isoform,
block starts relative to the circRNA start, strand-coloured itemRgb.
"""

import sys

from ciri_long_tpu_torch.annot.gtf import Feature


def convert(in_file, out_file):
    with open(in_file, 'r') as f, open(out_file, 'w') as out:
        for line in f:
            if line.startswith('#'):
                continue
            content = line.rstrip().split('\t')
            feat = Feature(content)
            attr = feat.attr
            tmp_line = [feat.contig, feat.start, feat.end, attr['circ_id'],
                        1000, feat.strand, feat.start, feat.end]
            item_rgb = "43,140,190" if feat.strand == "-" else "240,59,32"
            tmp_line.append(item_rgb)

            for iso in attr.get('isoform', '').split('|'):
                if not iso:
                    continue
                exons = iso.split(',')
                block_size = []
                block_starts = []
                for exon in exons:
                    exon_st, exon_en = exon.split('-')
                    block_size.append(str(int(exon_en) - int(exon_st)))
                    block_starts.append(str(int(exon_st) - feat.start))
                out.write('\t'.join(
                    str(x) for x in tmp_line + [len(exons),
                                                ','.join(block_size),
                                                ','.join(block_starts)]) + '\n')


def main():
    convert(sys.argv[1], sys.argv[2])


if __name__ == '__main__':
    main()
