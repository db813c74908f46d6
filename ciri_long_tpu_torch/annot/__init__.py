from ciri_long_tpu_torch.annot.gtf import (Feature, index_annotation,
                                           index_circ)
from ciri_long_tpu_torch.annot.signal import (
    SPLICE_SIGNAL,
    find_annotated_signal,
    find_denovo_signal,
    find_host_gene,
    find_overlap_exons,
    find_retained_introns,
    search_splice_signal,
    sort_ss,
)

__all__ = [
    "Feature", "index_annotation", "index_circ",
    "SPLICE_SIGNAL", "find_annotated_signal", "find_denovo_signal",
    "find_host_gene", "find_overlap_exons", "find_retained_introns",
    "search_splice_signal", "sort_ss",
]
