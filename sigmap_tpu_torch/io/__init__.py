from .fasta import ReferenceSequence, read_fasta, write_fasta
from .paf import ChainsSummary, PAFRecord, PAFWriter
from .pore_model import PoreModel, make_synthetic_pore_model
from .signals import ReadSignal, dac_to_pa, load_all_read_signals

__all__ = [
    "ReferenceSequence", "read_fasta", "write_fasta",
    "ChainsSummary", "PAFRecord", "PAFWriter",
    "PoreModel", "make_synthetic_pore_model",
    "ReadSignal", "dac_to_pa", "load_all_read_signals",
]
