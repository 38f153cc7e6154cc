"""Sharded train steps over gloo ranks on the CPU against the one-process
step and dhr_tpu's.

The weights are one perturbed Flax tree (tests/test_torch_train_step.py),
the global batch 8 queries x 4 passages.  Each scenario runs one step of a
sharded ``TrainState`` on every rank's rows (``shard_batch``) and reports
the loss, the whole gradients after the step's all-reduce and clip, and
the parameters after the AdamW update:

- data parallel, plain, packed and grad-cache (dropout on: the masks are
  drawn at the global shape, so they equal one process's; and off) and
  the in-graph TCT teacher, over 2 and 4 ranks;
- FSDP over 2 and 4 ranks, TP over a (data, model) = (1, 2) and (2, 2)
  mesh (dropout on and off: a TP rank keeps its heads' block of the
  attention mask), and the hybrid recipe (FSDP over ``data``, DP over
  ``(host, data)``, 2 x 2);
- a two-rank FSDP state saved after one step, restored into a fresh
  sharded state on 2 ranks and into an unsharded one here, and stepped
  once more: both equal the uninterrupted run;
- every TP scenario runs with ``torch.distributed._functional_collectives``
  patched to raise (the worker's ``no_functional_collectives``): the TP
  path's collectives are c10d's alone, the kind that runs under gloo with
  CUDA tensors on the card.

Each world size is one module fixture (one spawn of its ranks), so a
fault in one group costs only its own tests; the spawner's assertion
carries every rank's log tail.

Loss and gradients to 1e-5 relative L2 of the one-process step (and, with
dropout off, the loss to 1e-5 of dhr_tpu's step on the same batch);
parameters after AdamW to 1e-5 relative L2 (attention-key biases left
out, as in tests/test_torch_train_step.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dhr_tpu.train.step import make_train_step as jax_train_step
from dhr_tpu_torch.data.collate import collate_train, collate_train_packed
from dhr_tpu_torch.encode import plan_packing
from dhr_tpu_torch.train import step as tstep
from dhr_tpu_torch.train.checkpoint import restore_train_state
from dhr_tpu_torch.train.optimizer import OptimizerConfig
from dhr_tpu_torch.train.state import TrainState
from tests.test_torch_train_step import (
    ENC, FAMILIES, KEY_BIAS, N_PSG, P_LEN, Q_LEN, REMOVE, configs, examples,
    flax_tree, jax_loss_and_grads, port_model)
from torch_parallel_util import run_ranks

GLOBAL_B = 8
DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1)
OPT = dict(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1.0)
LOSS = dict(n_passages=N_PSG, remove_dims=REMOVE)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(seed):
    return collate_train(examples(seed, n_queries=GLOBAL_B), Q_LEN, P_LEN,
                         cls_id=1, sep_id=2)


def packed(seed, multiple=4):
    ex = examples(seed, n_queries=GLOBAL_B)
    rows = len(plan_packing([len(p) + 2 for _, ps, _ in ex for p in ps],
                            P_LEN, 4))
    rows = -(-rows // multiple) * multiple
    return collate_train_packed(ex, Q_LEN, P_LEN, rows, 4, cls_id=1,
                                sep_id=2)


def scenario(step="plain", mesh="data", dropout=False, **kw):
    enc = dict(ENC, **(DROPOUT if dropout else {}))
    jcfg, _ = configs(FAMILIES["dhr"])
    sc = dict(enc=enc, family=FAMILIES["dhr"], tree=flax_tree(jcfg, 11),
              loss=LOSS, opt=OPT, step=step, mesh=mesh, seed=5,
              batches=[packed(21) if step == "packed" else plain(21),
                       plain(22)])
    sc.update(kw)
    return sc


def _teacher():
    jcfg, _ = configs(FAMILIES["colbert"])
    return dict(family=FAMILIES["colbert"], tree=flax_tree(jcfg, 12))


SCENARIOS = {
    2: {
        "dp_plain_dropout": scenario(dropout=True),
        "dp_plain": scenario(),
        "dp_packed_dropout": scenario("packed", dropout=True),
        "dp_grad_cache": scenario("grad_cache"),
        "dp_grad_cache_dropout": scenario("grad_cache", dropout=True),
        "dp_tct": scenario(loss=dict(LOSS, use_tct_teacher=True),
                           teacher=_teacher()),
        "fsdp": scenario(fsdp=True),
        "tp": scenario(mesh="tp"),
        "tp_dropout": scenario(mesh="tp", dropout=True),
    },
    4: {
        "dp_plain_dropout": scenario(dropout=True),
        "fsdp": scenario(fsdp=True),
        "tp": scenario(mesh="tp"),
        "tp_dropout": scenario(mesh="tp", dropout=True),
        "hybrid_fsdp_dp": scenario(mesh="hybrid", fsdp=True),
    },
}
CASES = [(w, n) for w, scen in SCENARIOS.items() for n in scen]
# each group's wall limit: ten times its spawn's wall with six pytest
# workers busy beside it on an 8-core host (18 s on 2 ranks, 22 s on 4),
# rounded up to a minute; a hung collective fails its group's tests there
LIMIT_S = {2: 180, 4: 240}


def _spawn(tmp_path_factory, world):
    tmp = tmp_path_factory.mktemp(f"ptrain{world}")
    if world == 2:
        SCENARIOS[2]["fsdp"]["ckpt"] = str(tmp / "ckpt")
    return run_ranks("train", world, {"scenarios": SCENARIOS[world]}, tmp,
                     timeout=LIMIT_S[world])


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    return _spawn(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return _spawn(tmp_path_factory, 4)


def _runs(request, world) -> list:
    """Each rank's results of the ``world``-rank group."""
    return request.getfixturevalue(f"runs{world}")


def _one_process(sc, n_steps=1):
    """The unsharded port state after ``n_steps`` steps (one batch each)."""
    _, tcfg = configs(sc["family"], **{k: v for k, v in sc["enc"].items()
                                       if k not in ENC or ENC[k] != v})
    model = port_model(tcfg, sc["tree"])
    loss_cfg = tstep.LossConfig(**sc["loss"])
    state = TrainState.create(model, OptimizerConfig(**sc["opt"]))
    teacher = None
    if sc.get("teacher"):
        _, ccfg = configs(sc["teacher"]["family"])
        teacher = port_model(ccfg, sc["teacher"]["tree"])
    if sc["step"] == "packed":
        step = tstep.make_packed_train_step(model, tcfg, loss_cfg)
    elif sc["step"] == "grad_cache":
        step = tstep.make_grad_cache_train_step(model, tcfg, loss_cfg, 2, 2)
    else:
        step = tstep.make_train_step(model, tcfg, loss_cfg, teacher=teacher)
    losses = [float(step(state, sc["batches"][i], sc["seed"]))
              for i in range(n_steps)]
    return state, losses, tcfg


def _rel_l2(got: dict, want: dict):
    names = sorted(want)
    g = np.concatenate([np.asarray(got[n], np.float64).ravel()
                        for n in names])
    w = np.concatenate([np.asarray(want[n], np.float64).ravel()
                        for n in names])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _grads(state):
    return {n: p.grad.numpy() for n, p in state.model.named_parameters()
            if p.grad is not None}


def _params(state):
    """The parameters, attention-key biases left out as in
    tests/test_torch_train_step.py: their gradient is zero up to float
    noise, and Adam's first step moves them by +-lr on its sign."""
    return {n: p.detach().numpy() for n, p in state.model.named_parameters()
            if KEY_BIAS not in n}


@pytest.mark.parametrize("world,name", CASES)
def test_sharded_step_equals_one_process(request, world, name):
    sc = SCENARIOS[world][name]
    state, (loss,), _ = _one_process(sc)
    for r, res in enumerate(_runs(request, world)):
        got = res[name]["first"]
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (r, got["loss"])
        assert set(got["grads"]) == set(_grads(state))
        assert _rel_l2(got["grads"], _grads(state)) <= 1e-5
        assert _rel_l2(got["params"], _params(state)) <= 1e-5


@pytest.mark.parametrize("world,name", [c for c in CASES
                                        if "dropout" not in c[1]
                                        and "tct" not in c[1]])
def test_sharded_loss_equals_dhr_tpu(request, world, name):
    sc = SCENARIOS[world][name]
    jcfg, _ = configs(sc["family"])
    want, _ = jax_loss_and_grads(jax_train_step, jcfg, sc["tree"],
                                 sc["batches"][0])
    got = _runs(request, world)[0][name]["first"]["loss"]
    assert abs(got - want) <= 1e-5 * abs(want)


def test_fsdp_shards_large_and_replicates_small(runs2, runs4):
    """FSDP shards exactly the parameters of >= min_size (64) elements
    whose first dim divides by the ranks (the reference's rule)."""
    sharded = set(runs2[0]["fsdp"]["first"]["sharded"])
    state, _, _ = _one_process(SCENARIOS[2]["fsdp"])
    want = {n for n, p in state.model.named_parameters()
            if p.numel() >= 64 and p.shape[0] % 2 == 0}
    assert sharded == want
    assert any(n.endswith("ffn_in.weight") for n in sharded)
    assert any(n.endswith("term_weight.linear.bias") for n in
               dict(state.model.named_parameters())) and not any(
        n.endswith("term_weight.linear.bias") for n in sharded)
    tp = set(runs4[0]["tp"]["first"]["sharded"])
    assert any(n.endswith("attention.query.weight") for n in tp)
    assert any(n.endswith("ffn_out.weight") for n in tp)
    assert not any("embeddings" in n for n in tp)


def test_sharded_checkpoint_restores_on_two_ranks_and_one(runs2):
    """Saved from a 2-rank FSDP state after step 1, restored into a fresh
    sharded state (2 ranks) and into an unsharded one (here): the next
    step equals the uninterrupted run's second step."""
    sc = SCENARIOS[2]["fsdp"]
    ckpt = sc["ckpt"]
    want, losses, tcfg = _one_process(sc, n_steps=2)
    for res in runs2:
        got = res["fsdp"]
        assert got["step"] == 2
        assert abs(got["resumed"]["loss"] - losses[1]) <= 1e-5 * losses[1]
        assert _rel_l2(got["resumed"]["params"], _params(want)) <= 1e-5
    model = port_model(tcfg, sc["tree"])
    one = TrainState.create(model, OptimizerConfig(**sc["opt"]))
    restore_train_state(ckpt, one)
    assert one.step == 1
    step = tstep.make_train_step(model, tcfg, tstep.LossConfig(**sc["loss"]))
    loss = float(step(one, sc["batches"][1], sc["seed"]))
    assert abs(loss - losses[1]) <= 1e-5 * losses[1]
    assert _rel_l2(_params(one), _params(want)) <= 1e-5


TP_CASES = [(w, n) for w, n in CASES if SCENARIOS[w][n]["mesh"] == "tp"]


@pytest.mark.parametrize("world,name", TP_CASES)
def test_tp_step_runs_no_functional_collective(request, world, name):
    """The TP scenario ran under the guard (its step equals one process's
    above), the guard trips on a DTensor redistribution, and the DTensor
    parameters are the rules' ``Shard`` ones plus the row layers'
    replicated biases."""
    from dhr_tpu_torch.parallel.tp import tp_param_specs

    sc = SCENARIOS[world][name]
    _, tcfg = configs(sc["family"])
    specs = tp_param_specs(port_model(tcfg, sc["tree"]))
    want = {n for n, p in specs.items() if p.is_shard()}
    for res in _runs(request, world):
        assert res[name]["guard_trips"] is True
        got = res[name]["first"]
        assert want and want <= set(got["sharded"])
        assert set(got["sharded"]) - want == {
            n for n in got["sharded"]
            if n.endswith(("attention.out.bias", "ffn_out.bias"))}


def test_reps_is_a_pytree_node():
    # FSDP2 hooks its pre-backward all-gather onto the tensors it finds in
    # a forward's output; versions that look with tree_flatten must see
    # the tensors inside a Reps, not one opaque leaf
    from torch.utils._pytree import tree_flatten

    from dhr_tpu_torch.models.retrievers import Reps

    lex, sem = torch.ones(2, 3), torch.zeros(2, 4)
    leaves, _ = tree_flatten((Reps(lexical=lex, semantic=sem), None))
    assert any(t is lex for t in leaves) and any(t is sem for t in leaves)
