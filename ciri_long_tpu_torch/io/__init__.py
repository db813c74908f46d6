from ciri_long_tpu_torch.io.fastx import read_fastx, write_fasta_record
from ciri_long_tpu_torch.io.genome import Genome

__all__ = ["read_fastx", "write_fasta_record", "Genome"]
