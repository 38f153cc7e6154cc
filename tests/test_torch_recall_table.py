"""The port's recall_table (dhr_tpu_torch/tools/recall_table.py) against the
JAX tool (tools/recall_table.py), both on the CPU at 2,000 rows and 8
queries.

The clustered corpus and queries are the JAX tool's draws (the same numpy
stream).  The JSON keys are the JAX tool's; the int8, bf16 and stratified
int8 recalls equal its own exactly (the same exact GIP baseline and
candidates).  PQ recall comes from another k-means (the port's
``ops/pq.py`` against the reference's), so it is held within 0.05 of the
JAX tool's, and above 0.5.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from dhr_tpu_torch.tools import recall_table as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import recall_table as jax_tool  # noqa: E402

ARGS = ["--rows", "2000", "--queries", "8"]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    import contextlib
    import io

    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["recall_table.py", *ARGS]
    try:
        with contextlib.redirect_stdout(out):
            jax_tool.main()
    finally:
        sys.argv = argv
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got = port.main([*ARGS, "--device", "cpu"])
    return got, want


def test_keys_equal_the_jax_tool(tables):
    got, want = tables
    assert got.keys() == want.keys()
    assert got["modes"].keys() == want["modes"].keys()
    for name in want["modes"]:
        assert got["modes"][name].keys() == want["modes"][name].keys()
        assert got["modes"][name]["candidate_bytes_per_row"] == \
            want["modes"][name]["candidate_bytes_per_row"]
    for k in ("rows", "queries", "topk", "operating_point"):
        assert got[k] == want[k]


@pytest.mark.parametrize("mode", ["f16/bf16 planes", "int8 planes",
                                  "int8 + stratified S=8 candidates"])
def test_int8_and_bf16_recall_equal_the_jax_tool(tables, mode):
    got, want = tables
    assert got["modes"][mode]["recall_at_k_vs_exact"] == \
        want["modes"][mode]["recall_at_k_vs_exact"]


def test_pq_recall_within_tolerance(tables):
    got, want = tables
    g = got["modes"]["PQ64 codes (stage 1)"]["recall_at_k_vs_exact"]
    w = want["modes"]["PQ64 codes (stage 1)"]["recall_at_k_vs_exact"]
    assert abs(g - w) <= 0.05 and g > 0.5, (g, w)


def test_world_is_the_jax_tools_draw():
    """The port's clustered_world draws the JAX tool's arrays (its main
    draws them inline from default_rng(0))."""
    packed, qv, qi = port.clustered_world(500, 4, 32, 8)
    rng = np.random.default_rng(0)
    n_clusters = 8
    proto_lex = np.exp(-3.0 * rng.random((n_clusters, 32), np.float32))
    proto_cls = (rng.standard_normal((n_clusters, 8)) * 0.5).astype(
        np.float32)
    proto_idx = rng.integers(0, 39, (n_clusters, 32))
    member = rng.integers(0, n_clusters, 500)
    lex = proto_lex[member] * rng.uniform(0.7, 1.3, (500, 32))
    assert packed.values.dtype == np.float16
    np.testing.assert_array_equal(packed.values[:, :32],
                                  lex.astype(np.float16))
    assert packed.indices.dtype == np.uint8 and qv.shape == (4, 40)
    assert qi.dtype == np.int32 and set(np.unique(qi)) <= set(
        np.unique(proto_idx))
