"""The port's escalation_probe (dhr_tpu_torch/tools/escalation_probe.py)
against the JAX tool's measurement (tools/escalation_probe.py), on the CPU.

The JAX tool is a script fixed at 204,800 rows; here both run at 49,152
rows (top 30, a full pool of 300, small pools of 120 and 60: the JAX
tool's scaling) and its 256 queries, the JAX side as its script does
(``Searcher.calibrate_escalation`` per small pool) on the port's planes as
numpy arrays.  The keys are the JAX tool's.  Both select candidates on
bf16 stage-1 scores, whose ties at a pool's edge the JAX tool's
``lax.approx_max_k`` and the port's ``torch.topk`` break differently, so
a few queries miss other rows and the calibrated margin moves: the
escalated share agrees within 0.05 (13 of 256 queries), the overlap
before and after escalation (the recovered mass) within 0.005.
"""

import numpy as np
import pytest
import torch

from dhr_tpu_torch.retrieval.synth import (
    SynthConfig, synth_index_planes, synth_reps)
from dhr_tpu_torch.tools import escalation_probe as port

ROWS, QUERIES = 49_152, 256


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reports():
    import jax  # noqa: F401  (JAX_PLATFORMS=cpu in the test environment)

    from dhr_tpu.retrieval import DeviceIndex
    from dhr_tpu.retrieval.searcher import SearchConfig, Searcher

    got = port.probe(ROWS, QUERIES, device="cpu")
    v_i8, folds, scales, _ = (t.numpy() for t in synth_index_planes(
        0, ROWS, SynthConfig(), device="cpu"))
    qv, qf, _ = (t.numpy() for t in synth_reps(
        0, QUERIES, SynthConfig(), "query", stream=1, device="cpu"))
    idx = DeviceIndex.from_arrays(
        v_i8, folds, np.arange(ROWS).astype(str).astype(object),
        lex_dim=port.LEX_DIM, value_scales=scales)
    topk = got["topk"]
    want = {"n_rows": ROWS, "topk": topk, "full_pool": 10 * topk,
            "n_queries": QUERIES, "distribution": "trained-rep (synth.py)"}
    for pool in (4 * topk, 2 * topk):
        s = Searcher(idx, SearchConfig(
            topk=topk, theta=0.3, rerank=True, agip_topk=10 * topk,
            max_important_dims=48, query_batch=64, escalate_pool=pool,
            escalate_margin=0.0))
        cal = s.calibrate_escalation(qv, qf.astype(np.int32),
                                     miss_mass_target=0.95)
        cal["calibrate_s"] = 0.0
        want[f"pool_{pool}"] = cal
    return got, want


def test_sizes_scale_as_the_jax_tool():
    """At the default size the port's pools are the JAX tool's (top 125,
    full pool 1,250, small pools 500 and 250)."""
    assert (port.N_ROWS, port.N_QUERIES) == (204_800, 256)
    assert round(1000 * port.N_ROWS / port.REF_ROWS) == 125


def test_keys_equal_the_jax_tool(reports):
    got, want = reports
    assert got.keys() == want.keys()
    assert [k for k in got if k.startswith("pool_")] == ["pool_120",
                                                        "pool_60"]
    for k in ("pool_120", "pool_60"):
        assert got[k].keys() == want[k].keys()
        for field in ("pool", "agip_topk", "n_queries"):
            assert got[k][field] == want[k][field]


@pytest.mark.parametrize("pool", ["pool_120", "pool_60"])
def test_escalated_share_and_recovered_mass_match(reports, pool):
    got, want = reports[0][pool], reports[1][pool]
    assert abs(got["frac_escalated"] - want["frac_escalated"]) \
        <= 0.05, (got, want)
    assert abs(got["overlap_after_mean"] - want["overlap_after_mean"]) \
        <= 0.005, (got, want)
    assert abs(got["overlap_small_mean"] - want["overlap_small_mean"]) \
        <= 0.005, (got, want)
    assert got["frac_deficient"] > 0  # the small pool misses rows
