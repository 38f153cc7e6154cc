"""Core ops: quantization, GIP oracles, top-k, PQ, and the CUDA kernels
K1 / K2 / K3."""

from dhr_tpu_torch.ops.gip import (
    gip_scores_masked,
    gip_scores_pairwise,
    gip_scores_subindex,
    ip_scores,
    pad_indices_for_cls,
    scale_cls_tail,
    threshold_query_values,
)
from dhr_tpu_torch.ops.gip_candidates import (
    decode_packed_candidates,
    gip_candidates,
    partial_gip_candidates,
)
from dhr_tpu_torch.ops.partial_gip import partial_gip, partial_gip_scores
from dhr_tpu_torch.ops.quantize import quantize_per_dim, quantize_per_dim_np
from dhr_tpu_torch.ops.rerank_gip import rerank_gip
from dhr_tpu_torch.ops.topk import blockwise_topk, merge_topk

__all__ = [
    "blockwise_topk", "decode_packed_candidates", "gip_candidates",
    "gip_scores_masked", "gip_scores_pairwise", "gip_scores_subindex",
    "ip_scores", "merge_topk", "pad_indices_for_cls", "partial_gip",
    "partial_gip_candidates", "partial_gip_scores", "quantize_per_dim",
    "quantize_per_dim_np", "rerank_gip", "scale_cls_tail",
    "threshold_query_values",
]
