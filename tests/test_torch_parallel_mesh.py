"""The mesh helpers and the data-parallel Encoder over gloo ranks.

- ``parallel.mesh`` mirrors ``dhr_tpu.parallel`` (the reference's
  tests/test_misc.py:115-178): 1-D and hybrid meshes, both rejections
  (rows spanning hosts; an ``(index, host)`` order), ``row_axes`` of a
  renamed outer axis, ``pad_rows_to_multiple``, DTensor placements,
  ``shard_batch`` in global row order (host-major on a hybrid mesh);
- ``Encoder(mesh=)``, plain and packed, over a 4-rank 1-D mesh and a 2 x 2
  hybrid mesh: byte-equal planes and the same docids as one process;
- ``evaluate_beir(mesh=)`` over 2 ranks (data-parallel encode, row-sharded
  index): the one-process metrics and ``dhr_tpu``'s over its 8-device
  mesh, within 1e-6.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dhr_tpu.encode import EncodeConfig as JaxEncodeConfig
from dhr_tpu.encode import Encoder as JaxEncoder
from dhr_tpu.eval.beir import evaluate_beir as jax_evaluate_beir
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.parallel import make_hybrid_mesh as jax_make_hybrid_mesh
from dhr_tpu.parallel import make_mesh as jax_make_mesh
from dhr_tpu.parallel import pad_rows_to_multiple as jax_pad
from dhr_tpu.parallel.tp import fsdp_param_specs as jax_fsdp_specs
from dhr_tpu.parallel.tp import tp_param_specs as jax_tp_specs
from dhr_tpu.retrieval import SearchConfig as JaxSearchConfig
from dhr_tpu_torch.data import collate
from dhr_tpu_torch.encode import (
    EncodeConfig, Encoder, iter_batches, packed_encode_batches)
from dhr_tpu_torch.eval.beir import evaluate_beir
from dhr_tpu_torch.models import BiEncoder, load_flax_params
from dhr_tpu_torch.retrieval import SearchConfig
from dhr_tpu_torch.parallel import (
    INDEX_AXIS, pad_rows_to_multiple, row_axes)
from dhr_tpu_torch.parallel.mesh import hybrid_layout
from dhr_tpu_torch.parallel.tp import fsdp_param_specs, tp_param_specs
from dhr_tpu_torch.train.optimizer import flax_path
from tests.test_torch_beir import REMOVE as BEIR_REMOVE
from tests.test_torch_beir import FakeTokenizer, write_beir_dataset
from tests.test_torch_models import CASES as MODEL_CASES
from tests.test_torch_models import configs as model_configs
from tests.test_torch_models import flax_tree as model_flax_tree
from tests.test_torch_train_step import (
    ENC, FAMILIES, configs, flax_tree, port_model)
from torch_parallel_util import run_ranks

N_DOCS, L = 22, 12


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pmesh")
    return run_ranks("mesh", 4, {}, tmp)


def _corpus():
    rng = np.random.default_rng(3)
    toks = [rng.integers(64, 1024, rng.integers(3, L - 2)).tolist()
            for _ in range(N_DOCS)]
    ids = [f"d{i}" for i in range(N_DOCS)]
    input_ids = np.zeros((N_DOCS, L), np.int32)
    mask = np.zeros((N_DOCS, L), np.int32)
    for i, t in enumerate(toks):
        row = [1, *t, 2]
        input_ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, toks, input_ids, mask


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pencode")
    jcfg, _ = configs(FAMILIES["dhr"])
    ids, toks, input_ids, mask = _corpus()
    inp = dict(enc=ENC, family=FAMILIES["dhr"], tree=flax_tree(jcfg, 5),
               loss=dict(n_passages=2, remove_dims=64), ids=ids, toks=toks,
               input_ids=input_ids, mask=mask, batch=10, remove=64, rows=3,
               row_len=L)
    return inp, run_ranks("encode", 4, inp, tmp)


def _one_process(inp):
    _, tcfg = configs(inp["family"])
    enc = Encoder(port_model(tcfg, inp["tree"]), tcfg,
                  EncodeConfig(batch_size=inp["batch"],
                               remove_dims=inp["remove"]), device="cpu")
    plain = enc.encode_corpus(iter_batches(inp["ids"], inp["input_ids"],
                                           inp["mask"], inp["batch"]))
    batches, _ = packed_encode_batches(inp["ids"], inp["toks"], inp["rows"],
                                       inp["row_len"], 4, 1, 2)
    packed = enc.encode_corpus_packed(batches)
    return {"plain": plain, "packed": packed}


@pytest.mark.parametrize("kind", ["data", "hybrid"])
@pytest.mark.parametrize("how", ["plain", "packed"])
def test_sharded_encoder_planes_equal_one_process(encoded, kind, how):
    inp, out = encoded
    want = _one_process(inp)[how]
    for res in out:
        values, indices, docids = res[kind][how]
        assert values.tobytes() == want.values.tobytes()
        assert indices.tobytes() == want.indices.tobytes()
        assert docids == list(want.docids)


def test_pad_rows_to_multiple_matches_reference():
    for n in (10, 16, 1):
        a = np.ones((n, 3))
        got, real = pad_rows_to_multiple(a, 8)
        want, wreal = jax_pad(a, 8)
        assert got.shape == want.shape and real == wreal == n
        np.testing.assert_array_equal(got, want)


def test_hybrid_layout_rejects_rows_spanning_hosts():
    """3 + 5 ranks on two hosts divide into 2 rows of 4, but a row would
    span hosts: refused, as the reference refuses rows spanning
    processes."""
    hosts = ["a"] * 3 + ["b"] * 5
    with pytest.raises(ValueError, match="span"):
        hybrid_layout(hosts, num_hosts=2)
    devs = ([types.SimpleNamespace(process_index=0, id=i) for i in range(3)]
            + [types.SimpleNamespace(process_index=1, id=i)
               for i in range(5)])
    with pytest.raises(ValueError, match="span processes"):
        jax_make_hybrid_mesh(devs, num_hosts=2)
    with pytest.raises(ValueError, match="do not divide"):
        hybrid_layout(["a"] * 6, num_hosts=4)


def test_hybrid_layout_groups_ranks_by_host():
    np.testing.assert_array_equal(
        hybrid_layout(["x", "y", "x", "y"]), [[0, 2], [1, 3]])
    # num_hosts overrides the grouping (one machine rehearsing two hosts)
    np.testing.assert_array_equal(hybrid_layout(["x"] * 4, num_hosts=2),
                                  [[0, 1], [2, 3]])


def _fake(names):
    return types.SimpleNamespace(mesh_dim_names=names)


@pytest.mark.parametrize("device,kind", [(None, "cuda"), ("cpu", "cpu")])
def test_gloo_mesh_lives_on_the_ranks_device(monkeypatch, device, kind):
    # two ranks sharing one card run gloo with CUDA tensors: their meshes
    # (and so TP, FSDP and global_put) stay on the card
    from dhr_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_rank_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    monkeypatch.setenv("LOCAL_RANK", "1")
    dev = mesh_mod.init_distributed("gloo", device=device)
    assert dev.type == kind and (kind == "cpu" or dev.index == 0)
    assert mesh_mod._mesh_device_type() == kind


def test_card_tensors_refuse_a_host_mesh():
    from dhr_tpu_torch.parallel import global_put
    from dhr_tpu_torch.parallel.mesh import check_device
    from dhr_tpu_torch.parallel.tp import shard_params_fsdp, shard_params_tp

    host = types.SimpleNamespace(device_type="cpu", ndim=1)
    card = types.SimpleNamespace(device_type="cuda", ndim=1)
    check_device("cpu", card, "host data")  # uploads are fine
    check_device("cuda:0", card, "the model")
    with pytest.raises(ValueError, match="mesh is on cpu"):
        check_device("cuda:0", host, "the model")
    # a tensor off the host (meta stands in for the card here) must not
    # be moved onto a host mesh by a DTensor put
    model = torch.nn.Linear(4, 4, device="meta")
    with pytest.raises(ValueError, match="mesh is on cpu"):
        global_put(torch.empty(4, device="meta"), host, [])
    for shard in (shard_params_fsdp, shard_params_tp):
        with pytest.raises(ValueError, match="mesh is on cpu"):
            shard(model, host)


def test_row_axes_rejects_inner_axis_on_outer_position():
    with pytest.raises(ValueError, match="outer"):
        row_axes(_fake(("index", "host")), INDEX_AXIS)


def test_row_axes_recognizes_renamed_outer_axis():
    assert row_axes(_fake(("pod", "index")), "index") == ("pod", "index")
    assert row_axes(_fake(("index",)), "index") == ("index",)
    assert row_axes(_fake(("pod", "index")), "data") == ("data",)
    assert row_axes(None, "index") == ("index",)
    assert row_axes(_fake(("host", "index", "x")), "index") == (
        "host", "index")


def test_meshes_on_ranks(ranks):
    for r, res in enumerate(ranks):
        assert res["data_shape"] == (("data",), 4)
        assert res["hybrid"] == (("pod", "index"), [[0, 1], [2, 3]])
        assert res["row_axes_hybrid"] == ("pod", "index")
        assert res["row_axes_1d"] == ("data",)
        assert res["row_axes_missing"] == ("data",)
        assert res["coords_hybrid"] == (r, 4)


def test_placements_and_shard_batch_on_ranks(ranks):
    full = np.arange(16.0).reshape(8, 2)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["full"], full)
        np.testing.assert_array_equal(res["local_shard"],
                                      full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["replicated"], 0.0)  # rank 0's
        for key in ("batch", "batch_hybrid"):
            np.testing.assert_array_equal(res[key]["b"]["c"],
                                          [2 * r, 2 * r + 1])
            assert res[key]["a"].shape == (2, 3)
        assert len(res["hosts"]) == 4 and len(set(res["hosts"])) == 1



BEIR_SEARCHES = {
    "ip": dict(topk=10, query_batch=4),
    "gip_rerank": dict(topk=10, theta=0.0, rerank=True, agip_topk=24,
                       query_batch=8),
}
BEIR_KW = dict(q_max_len=8, p_max_len=16, cls_id=1, sep_id=2)


@pytest.fixture(scope="module")
def beir_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pbeir")
    d = str(tmp / "ds")
    write_beir_dataset(d)
    jcfg, tcfg = model_configs(MODEL_CASES["dhr_pooler"])
    b = collate.pad_token_batch([[BEIR_REMOVE + 1] * 6], 8, 0, 1, 2)
    tree = model_flax_tree(jcfg, b["input_ids"], b["attention_mask"], 40)
    enc = {f.name: getattr(tcfg.encoder, f.name)
           for f in dataclasses.fields(tcfg.encoder) if f.name != "dtype"}
    family = {f.name: getattr(tcfg, f.name)
              for f in dataclasses.fields(tcfg) if f.name != "encoder"}
    inp = dict(enc=enc, family=family, tree=tree, loss={}, batch=8,
               remove=BEIR_REMOVE, dir=d, kw=BEIR_KW,
               searches=BEIR_SEARCHES)
    return inp, jcfg, tcfg, run_ranks("beir", 2, inp, tmp)


@pytest.mark.parametrize("search", sorted(BEIR_SEARCHES))
def test_sharded_evaluate_beir_equals_one_process_and_dhr_tpu(
        beir_runs, search, eight_devices):
    inp, jcfg, tcfg, ranks = beir_runs
    cfg = BEIR_SEARCHES[search]
    one = evaluate_beir(
        Encoder(load_flax_params(BiEncoder(tcfg), inp["tree"]), tcfg,
                EncodeConfig(batch_size=8, remove_dims=BEIR_REMOVE),
                device="cpu"), SearchConfig(**cfg), inp["dir"],
        FakeTokenizer(), **BEIR_KW)
    want = jax_evaluate_beir(
        JaxEncoder(JaxBiEncoder(jcfg), inp["tree"], jcfg,
                   JaxEncodeConfig(batch_size=8, remove_dims=BEIR_REMOVE),
                   mesh=jax_make_mesh(eight_devices, axis="data")),
        JaxSearchConfig(**cfg), inp["dir"], FakeTokenizer(),
        mesh=jax_make_mesh(eight_devices, axis="index"), **BEIR_KW)
    for res in ranks:
        got = res[search]
        assert sorted(got) == sorted(one) == sorted(want)
        for k in one:
            assert got[k] == pytest.approx(one[k], abs=1e-6), k
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_tp_and_fsdp_specs_follow_the_reference_rules():
    """Each port parameter's placement against the reference's spec for
    the same Flax leaf: TP shards the heads of query / key / value / out
    and the FFN width (a port ``Dense`` weight is the Flax kernel
    transposed: column-parallel is Shard(0), row-parallel Shard(1));
    FSDP shards exactly the leaves the reference's rule shards."""
    from torch.distributed.tensor import Replicate, Shard

    jcfg, tcfg = configs(FAMILIES["dhr"])
    x = {"input_ids": jnp.ones((2, 8), jnp.int32),
         "attention_mask": jnp.ones((2, 8), jnp.int32)}
    params = JaxBiEncoder(jcfg).init(jax.random.PRNGKey(0), query=x,
                            passage=x)["params"]
    model = port_model(tcfg, flax_tree(jcfg))
    jtp, jfsdp = jax_tp_specs(params), jax_fsdp_specs(params, min_size=64)
    tp, fsdp = tp_param_specs(model), fsdp_param_specs(model, min_size=64)
    n_tp = 0
    for name, _ in model.named_parameters():
        want = _leaf(jtp, flax_path(name))
        if want == P():
            assert tp[name] == Replicate(), name
        elif name.endswith("weight"):
            row = name.rsplit(".", 2)[-2] in ("out", "ffn_out")
            assert tp[name] == Shard(1 if row else 0), name
            n_tp += 1
        else:
            assert tp[name] == Shard(0), name
        assert (fsdp[name] == Shard(0)) == (
            _leaf(jfsdp, flax_path(name)) != P()), name
    assert n_tp == 2 * 6  # two layers x query, key, value, out, in, out
