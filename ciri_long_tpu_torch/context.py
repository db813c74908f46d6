"""Shared read-only pipeline state.

The analog of the reference's fork-inherited worker globals (env.py:1-21:
ALIGNER/CONTIG_LEN/GENOME/GTF_INDEX/INTRON_INDEX/SS_INDEX) -- but passed
explicitly: the TPU pipeline is batched rather than fork-parallel, and on
multi-host runs this state is replicated per host (SURVEY.md §2).
"""

from dataclasses import dataclass
from typing import Optional


@dataclass
class Context:
    aligner: Optional[object] = None     # GenomeAligner (or None in collapse)
    genome: Optional[object] = None      # io.genome.Genome
    gtf_index: Optional[dict] = None
    intron_index: Optional[dict] = None
    ss_index: Optional[dict] = None

    @property
    def contig_len(self):
        return self.genome.contig_len if self.genome is not None else {}
