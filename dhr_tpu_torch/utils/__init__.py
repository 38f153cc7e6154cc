"""Utilities: format converters and phase timing / profiler traces."""

from dhr_tpu_torch.utils.convert import (
    convert_dpr_checkpoint,
    convert_ranking_to_trec,
    read_qrel_tsv,
    read_tsv_pairs,
)
from dhr_tpu_torch.utils.profiling import phase, report, reset, trace

__all__ = [
    "convert_dpr_checkpoint", "convert_ranking_to_trec", "phase",
    "read_qrel_tsv", "read_tsv_pairs", "report", "reset", "trace",
]
