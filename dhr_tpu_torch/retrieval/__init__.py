"""Index planes, the searcher, pool calibration, index diagnostics, the
synthetic corpus, ColBERT MaxSim retrieval and TREC I/O."""

from dhr_tpu_torch.retrieval.colbert import (
    full_ranking,
    maxsim_listwise,
    maxsim_pairwise,
    maxsim_topk,
    score_pairs,
)
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
    "avg_important_dims", "calibrate_pool", "full_ranking", "index_stats",
    "maxsim_listwise", "maxsim_pairwise", "maxsim_topk", "merge_runs",
    "read_qrels", "read_run", "score_pairs", "write_run",
]
