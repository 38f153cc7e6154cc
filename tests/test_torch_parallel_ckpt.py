"""FSDP and TP checkpoints and clipped steps through c10d, over gloo ranks
on the CPU (``parallel.collectives.gather_full``, ``optimizer._grad_norm``).

``DTensor.full_tensor``'s functional all-gather crashes under gloo with
CUDA tensors (torch 2.11), so the port gathers sharded tensors with c10d
all-gathers and sums squared shard norms with c10d all-reduces.  On the
CPU, where ``full_tensor`` works, both are held against it, over 2 and 4
ranks, on a tiny DHR model whose vocabulary (1,021) no rank count divides:

- DTensors sharded unevenly on dim 0 and dim 1 (and, on 4 ranks, over a
  2 x 2 mesh, nested) gather to the whole tensor, equal to
  ``full_tensor``'s;
- the state's host copy (parameters and AdamW moments) equals
  ``full_tensor``'s bit for bit;
- a step clipped to a global norm of 1e-3 (dropout 0.1) equals one
  process's clipped step: loss and gradients within 1e-5 relative; each
  sharded gradient's norm within 1e-6 of ``full_tensor``'s;
- the state saved after that step, restored into a fresh FSDP state, gives
  the uninterrupted run's next loss bit for bit;
- the optimizer steps FSDP's mix of DTensor shards and plain tensors one
  by one: a foreach AdamW over the mix raises (it did on the card);
- the same clipped step, host copy and restore for a TP state over a
  (data, model) = (1, 2) and (2, 2) mesh, its path run with
  ``torch.distributed._functional_collectives`` patched to raise; its
  save also restores into an unsharded state here, bit-equal to the host
  copy, whose next step equals the TP ranks' next loss.
"""

import numpy as np
import pytest
import torch

from dhr_tpu_torch.data.collate import collate_train
from dhr_tpu_torch.models import (
    BiEncoder, EncoderConfig, RetrieverConfig, load_flax_params,
    random_flax_params)
from dhr_tpu_torch.train import step as tstep
from dhr_tpu_torch.train.optimizer import OptimizerConfig
from dhr_tpu_torch.train.state import TrainState
from torch_parallel_util import run_ranks

V, REMOVE, OUT = 1021, 61, 96  # (V - REMOVE) / OUT = 10 folds
Q_LEN, P_LEN, N_PSG, GLOBAL_B = 8, 16, 4, 8
ENC = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64,
           hidden_dropout=0.1, attention_dropout=0.1)
FAMILY = dict(model_type="dhr", add_pooler=True, dlr_out_dim=OUT)
MAX_NORM = 1e-3
OPT = dict(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=MAX_NORM)
LOSS = dict(n_passages=N_PSG, remove_dims=REMOVE)
WORLDS = (2, 4)
# each group's wall limit: ten times its spawn's wall with six pytest
# workers busy beside it on an 8-core host (~16 s on 2 ranks, ~25 s on 4),
# rounded up to a minute
LIMIT_S = {2: 180, 4: 300}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ex = []
    for _ in range(GLOBAL_B):
        q = rng.integers(REMOVE, V, rng.integers(3, Q_LEN - 1)).tolist()
        ps = [rng.integers(REMOVE, V, rng.integers(2, P_LEN // 2)).tolist()
              for _ in range(N_PSG)]
        ex.append((q, ps, None))
    return collate_train(ex, Q_LEN, P_LEN, cls_id=1, sep_id=2)


def _cfg():
    return RetrieverConfig(encoder=EncoderConfig(dtype=torch.float32, **ENC),
                           **FAMILY)


def _scenario(ckpt, mesh="data"):
    return dict(enc=ENC, family=FAMILY, loss=LOSS, opt=OPT, step="plain",
                mesh=mesh, seed=5, fsdp=mesh == "data", ckpt=ckpt,
                tree=random_flax_params(_cfg(), torch.Generator()
                                        .manual_seed(3)),
                batches=[_batch(21), _batch(22)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pckpt")
    out = {}
    for w in WORLDS:
        sc = _scenario(str(tmp / f"ckpt{w}"))
        tp = _scenario(str(tmp / f"ckpt{w}_tp"), mesh="tp")
        out[w] = (sc, run_ranks("fsdp_ckpt", w, {
            "rows": V, "cols": 7, "scenario": sc, "tp_scenario": tp}, tmp,
            timeout=LIMIT_S[w]))
    return out


def _one_process(sc):
    """The unsharded clipped step: loss, gradients after the clip."""
    cfg = _cfg()
    model = load_flax_params(BiEncoder(cfg), sc["tree"])
    state = TrainState.create(model, OptimizerConfig(**sc["opt"]))
    step = tstep.make_train_step(model, cfg, tstep.LossConfig(**sc["loss"]))
    loss = float(step(state, sc["batches"][0], sc["seed"]))
    return loss, {n: p.grad.numpy() for n, p in model.named_parameters()
                  if p.grad is not None}


def _rel_l2(got: dict, want: dict):
    names = sorted(want)
    g = np.concatenate([np.asarray(got[n], np.float64).ravel()
                        for n in names])
    w = np.concatenate([np.asarray(want[n], np.float64).ravel()
                        for n in names])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return a == b


@pytest.mark.parametrize("world", WORLDS)
def test_gather_full_of_uneven_shards_equals_full_tensor(runs, world):
    _, res = runs[world]
    for rank in res:
        assert len(rank["uneven"]) == (2 if world == 2 else 5)
        for key, got in rank["uneven"].items():
            np.testing.assert_array_equal(got["gathered"], rank["whole"],
                                          err_msg=key)
            np.testing.assert_array_equal(got["full_tensor"],
                                          rank["whole"], err_msg=key)
    # the shards really are uneven: the last rank holds fewer rows
    rows = [r["uneven"]["1d [Shard(dim=0)]"]["local_rows"] for r in res]
    assert rows[0] == -(-V // world) and rows[-1] < rows[0]
    assert sum(rows) == V


def _check_host_copy(leg):
    assert leg["first"]["sharded"], "no parameter sharded"
    for part in ("model", "optimizer"):
        assert _equal_trees(leg["host_copy"][part],
                            leg["full_tensor_copy"][part]), part


def _check_clipped_step(sc, legs):
    loss, grads = _one_process(sc)
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in grads.values()))
    assert abs(total - MAX_NORM) <= 1e-5 * MAX_NORM  # the clip engaged
    for leg in legs:
        got = leg["first"]
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        assert set(got["grads"]) == set(grads)
        assert _rel_l2(got["grads"], grads) <= 1e-5
        assert leg["grad_norms"]
        for name, (c10d, full) in leg["grad_norms"].items():
            assert abs(c10d - full) <= 1e-6 * full, name


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_host_copy_equals_full_tensor(runs, world):
    _, res = runs[world]
    for rank in res:
        _check_host_copy(rank)


@pytest.mark.parametrize("world", WORLDS)
def test_clipped_fsdp_step_equals_one_process(runs, world):
    sc, res = runs[world]
    _check_clipped_step(sc, res)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_host_copy_equals_full_tensor(runs, world):
    _, res = runs[world]
    for rank in res:
        _check_host_copy(rank["tp"])


@pytest.mark.parametrize("world", WORLDS)
def test_clipped_tp_step_equals_one_process(runs, world):
    sc, res = runs[world]
    _check_clipped_step(sc, [rank["tp"] for rank in res])


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_optimizer_steps_mixed_parameters_one_by_one(runs, world):
    """FSDP leaves the indivisible vocabulary tensors and the small ones
    plain beside its DTensor shards: a multi-tensor AdamW refuses the mix,
    so the port's optimizer turns foreach off for such a model."""
    _, res = runs[world]
    for rank in res:
        assert rank["param_kinds"] == ["DTensor", "Parameter"]
        assert rank["foreach_on_mixed_raises"] is True
        assert rank["foreach"] is False


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_restore_gives_the_next_loss_bit_for_bit(runs, world):
    _, res = runs[world]
    for rank in res:
        assert rank["resumed_step"] == 1
        assert rank["resumed_loss"] == rank["next_loss"]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_restore_gives_the_next_loss_bit_for_bit(runs, world):
    _, res = runs[world]
    for rank in res:
        assert rank["tp"]["resumed_step"] == 1
        assert rank["tp"]["resumed_loss"] == rank["tp"]["next_loss"]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_checkpoint_restores_into_one_process(runs, world):
    """The TP ranks' save restored into an unsharded state here: its
    parameters and moments equal the ranks' host copy bit for bit, and its
    next step's loss equals the TP ranks' next loss."""
    from dhr_tpu_torch.train.checkpoint import restore_train_state

    sc, res = runs[world]
    cfg = _cfg()
    model = load_flax_params(BiEncoder(cfg), sc["tree"])
    one = TrainState.create(model, OptimizerConfig(**sc["opt"]))
    restore_train_state(sc["ckpt"] + "_tp", one)
    assert one.step == 1
    host = res[0]["tp"]["host_copy"]
    assert _equal_trees(dict(model.state_dict()), host["model"])
    assert _equal_trees(one.optimizer.state_dict()["state"],
                        host["optimizer"]["state"])
    step = tstep.make_train_step(model, cfg, tstep.LossConfig(**sc["loss"]))
    loss = float(step(one, sc["batches"][1], sc["seed"]))
    want = res[0]["tp"]["next_loss"]
    assert abs(loss - want) <= 1e-5 * abs(want)
