"""Utilities: format converters and the recorder (spans, counters and
profiler traces)."""

from dhr_tpu_torch.utils.convert import (
    convert_dpr_checkpoint,
    convert_ranking_to_trec,
    read_qrel_tsv,
    read_tsv_pairs,
)
from dhr_tpu_torch.utils.profiling import (
    count, counters, report, reset, span, spans, trace)

__all__ = [
    "convert_dpr_checkpoint", "convert_ranking_to_trec", "count",
    "counters", "read_qrel_tsv", "read_tsv_pairs", "report", "reset",
    "span", "spans", "trace",
]
