"""Index planes, the GIP searcher, the synthetic corpus and TREC I/O."""

from dhr_tpu_torch.retrieval.index import DeviceIndex, PackedIndex
from dhr_tpu_torch.retrieval.searcher import SearchConfig, Searcher
from dhr_tpu_torch.retrieval.trec import (
    merge_runs,
    read_qrels,
    read_run,
    write_run,
)

__all__ = [
    "DeviceIndex", "PackedIndex", "SearchConfig", "Searcher", "merge_runs",
    "read_qrels", "read_run", "write_run",
]
