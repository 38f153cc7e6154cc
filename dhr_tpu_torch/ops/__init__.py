"""Core ops: quantization, GIP oracles, top-k, PQ, densify / aggregate, and
the CUDA kernels K1 / K2 / K3 / K4 / K5."""

from dhr_tpu_torch.ops.aggregate import aggregate, cal_remove_dim, merge_reps
from dhr_tpu_torch.ops.densify import densify, densify_sparse_rows, undensify
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
from dhr_tpu_torch.ops.lexical_pool import lexical_pool
from dhr_tpu_torch.ops.moe_combine import moe_combine
from dhr_tpu_torch.ops.partial_gip import partial_gip, partial_gip_scores
from dhr_tpu_torch.ops.quantize import quantize_per_dim, quantize_per_dim_np
from dhr_tpu_torch.ops.rerank_gip import rerank_gip
from dhr_tpu_torch.ops.topk import blockwise_topk, merge_topk
from dhr_tpu_torch.utils.profiling import counters


def kernel_launches() -> dict:
    """This process's launch counts of the CUDA kernels since the
    recorder's last reset: K1 ``partial_gip``, K2 ``rerank_gip``, K3
    ``gip_candidates``, K4 ``lexical_pool``, K5 ``moe_combine`` (each
    wrapper counts ``launches.<kernel>`` where it launches its kernel,
    never on the CPU)."""
    got = counters()
    return {k: int(got.get(f"launches.{k}", 0))
            for k in ("partial_gip", "rerank_gip", "gip_candidates",
                      "lexical_pool", "moe_combine")}


__all__ = [
    "aggregate", "blockwise_topk", "cal_remove_dim",
    "decode_packed_candidates", "densify", "densify_sparse_rows",
    "gip_candidates",
    "gip_scores_masked", "gip_scores_pairwise", "gip_scores_subindex",
    "ip_scores", "kernel_launches", "lexical_pool", "merge_reps",
    "merge_topk", "moe_combine", "pad_indices_for_cls",
    "partial_gip", "partial_gip_candidates", "partial_gip_scores",
    "quantize_per_dim", "quantize_per_dim_np", "rerank_gip",
    "scale_cls_tail", "threshold_query_values", "undensify",
]
