"""Index planes, the searcher, pool calibration, index diagnostics, the
synthetic corpus and TREC I/O."""

from dhr_tpu_torch.retrieval.index import DeviceIndex, PackedIndex
from dhr_tpu_torch.retrieval.searcher import (
    SearchConfig,
    Searcher,
    calibrate_pool,
)
from dhr_tpu_torch.retrieval.stats import avg_important_dims, index_stats
from dhr_tpu_torch.retrieval.trec import (
    merge_runs,
    read_qrels,
    read_run,
    write_run,
)

__all__ = [
    "DeviceIndex", "PackedIndex", "SearchConfig", "Searcher",
    "avg_important_dims", "calibrate_pool", "index_stats", "merge_runs",
    "read_qrels", "read_run", "write_run",
]
