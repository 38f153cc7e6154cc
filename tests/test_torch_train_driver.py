"""The port's training driver, checkpoints and HF export.

- a run cut mid-epoch and resumed gives the uninterrupted run bit for bit
  on the CPU, dropout on (losses and final parameters);
- the background save holds the state of the step it was taken at;
- a step that raises leaves an emergency checkpoint of the last good
  state; the metrics JSONL has one line per log interval;
- the HF export loads in ``dhr_tpu`` (its ``hf_io`` and CLI loader) and in
  the port's ``encode`` with equal reps, and the reference's export loads
  in the port;
- CLI ``train`` -> ``encode`` -> ``index`` -> ``search`` with ``--device cpu``.
"""

import argparse
import dataclasses
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu.cli import main as jcli
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.models.retrievers import RetrieverConfig as JaxRetrieverConfig
from dhr_tpu.models.transformer import EncoderConfig as JaxEncoderConfig
from dhr_tpu.train.checkpoint import export_hf_checkpoint as jax_export
from dhr_tpu_torch.cli.main import main as cli
from dhr_tpu_torch.data import SamplingConfig
from dhr_tpu_torch.data.examples import write_jsonl
from dhr_tpu_torch.models import BiEncoder, EncoderConfig, RetrieverConfig
from dhr_tpu_torch.models import load_flax_params, random_flax_params
from dhr_tpu_torch.retrieval import PackedIndex, read_run
from dhr_tpu_torch.train import checkpoint as ckpt
from dhr_tpu_torch.train import driver
from dhr_tpu_torch.train.driver import RunConfig, run_training
from dhr_tpu_torch.train.optimizer import OptimizerConfig
from dhr_tpu_torch.train.state import TrainState
from dhr_tpu_torch.train.step import LossConfig

V, REMOVE, OUT = 1024, 64, 96
ENC = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(dropout=0.1, **kw):
    return RetrieverConfig(
        model_type="dhr", add_pooler=True, projection_dim=16,
        dlr_out_dim=OUT,
        encoder=EncoderConfig(dtype=torch.float32, hidden_dropout=dropout,
                              attention_dropout=dropout, **ENC), **kw)


def groups(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return [{"query": rng.integers(REMOVE, V, 5).tolist(),
             "positives": [rng.integers(REMOVE, V, 9).tolist()],
             "negatives": [rng.integers(REMOVE, V, rng.integers(4, 11))
                           .tolist() for _ in range(4)]} for _ in range(n)]


SAMPLING = SamplingConfig(n_passages=3, q_max_len=8, p_max_len=16, seed=3,
                          cls_id=1, sep_id=2)
LOSS = LossConfig(n_passages=3, remove_dims=REMOVE)
OPT = OptimizerConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12,
                      freeze_word_embeddings=True)


def run(tmp, name, **kw):
    rc = RunConfig(num_epochs=2, batch_size=4, log_steps=1, save_steps=4,
                   seed=3, ckpt_dir=str(tmp / name),
                   metrics_path=str(tmp / f"{name}.jsonl"))
    return run_training(cfg(), LOSS, OPT, dataclasses.replace(rc, **kw),
                        groups(), SAMPLING, device="cpu")


def losses(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("extra", [{}, {"pack_passages": True},
                                   {"grad_cache": True, "gc_q_chunks": 2,
                                    "gc_p_chunks": 4}])
def test_resume_mid_epoch_is_bit_identical(tmp_path, extra):
    """12 steps (2 epochs of 6) straight, against 3 steps, then a resume
    from step 3 (mid-epoch 0), dropout 0.1 throughout."""
    straight = run(tmp_path, "a", **extra)
    run(tmp_path, "b", max_steps=3, **extra)
    assert ckpt.latest_step(str(tmp_path / "b")) == 3
    resumed = run(tmp_path, "b", **extra)
    assert straight.step == resumed.step == 12
    a = [m["loss"] for m in losses(tmp_path / "a.jsonl")]
    b = [m["loss"] for m in losses(tmp_path / "b.jsonl")]
    assert len(a) == len(b) == 12 and a == b
    for (n, p), q in zip(straight.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n
    assert len(set(a)) == 12 and all(np.isfinite(a))


def test_metrics_jsonl_and_checkpoints(tmp_path):
    state = run(tmp_path, "m", num_epochs=1, log_steps=2)
    rows = losses(tmp_path / "m.jsonl")
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert set(rows[0]) == {"step", "epoch", "loss", "steps_per_sec",
                            "wall_s"}
    assert sorted(os.listdir(tmp_path / "m")) == ["step_00000004",
                                                  "step_00000006"]
    fresh = TrainState.create(load_flax_params(BiEncoder(cfg()),
                                               random_flax_params(
        cfg(), torch.Generator().manual_seed(9))), OPT)
    ckpt.restore_train_state(str(tmp_path / "m"), fresh)
    assert fresh.step == 6
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
    assert str(fresh.optimizer.state_dict()) == str(
        state.optimizer.state_dict())


def test_async_snapshot_holds_the_step_it_was_taken_at(tmp_path,
                                                       monkeypatch):
    model = load_flax_params(BiEncoder(cfg()), random_flax_params(
        cfg(), torch.Generator().manual_seed(1)))
    state = TrainState.create(model, OPT)
    state.step = 5
    want = {k: v.clone() for k, v in model.state_dict().items()}
    go = threading.Event()
    real = ckpt.write_snapshot

    def held(ckpt_dir, snap):  # the write starts after the next "step"
        assert go.wait(30)
        return real(ckpt_dir, snap)

    monkeypatch.setattr(ckpt, "write_snapshot", held)
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), state)
    with torch.no_grad():  # the next step updates in place
        for p in model.parameters():
            p.add_(1.0)
    state.step = 6
    go.set()
    path = saver.wait()
    assert path.endswith("step_00000005")
    snap = torch.load(os.path.join(path, ckpt.STATE_FILE),
                      weights_only=True)
    assert snap["step"] == 5
    for k, v in want.items():
        assert torch.equal(snap["model"][k], v), k


def test_emergency_checkpoint_on_a_failing_step(tmp_path, monkeypatch):
    real = driver.make_train_step

    def failing(*a, **kw):
        step = real(*a, **kw)

        def train_step(state, batch, seed):
            if state.step == 3:
                raise RuntimeError("boom")
            return step(state, batch, seed)

        return train_step

    monkeypatch.setattr(driver, "make_train_step", failing)
    with pytest.raises(RuntimeError, match="boom"):
        run(tmp_path, "e", num_epochs=1, save_steps=2)
    assert ckpt.latest_step(str(tmp_path / "e")) == 3
    assert len(losses(tmp_path / "e.jsonl")) == 3


def test_no_emergency_checkpoint_from_inside_an_update(tmp_path,
                                                      monkeypatch):
    """A step that raises while its update is half applied leaves no
    checkpoint of that mixed state: the last periodic save (step 2) stays
    the resume point."""
    real = TrainState.create.__func__

    def create(cls, model, opt_cfg):
        state = real(cls, model, opt_cfg)
        step = state.optimizer.step

        def failing(*a, **kw):
            if state.step == 3:
                with torch.no_grad():  # the first group is written
                    state.params[0].add_(1.0)
                raise RuntimeError("out of memory")
            return step(*a, **kw)

        state.optimizer.step = failing
        return state

    monkeypatch.setattr(TrainState, "create", classmethod(create))
    with pytest.raises(RuntimeError, match="out of memory"):
        run(tmp_path, "u", num_epochs=1, save_steps=2)
    assert ckpt.latest_step(str(tmp_path / "u")) == 2
    assert os.listdir(tmp_path / "u") == ["step_00000002"]


@pytest.mark.parametrize("chunks", [(3, 4), (2, 5)])
def test_grad_cache_run_refuses_chunks_that_do_not_divide_the_batch(
        tmp_path, chunks):
    """Batch 4 x 3 passages: 3 query chunks or 5 passage chunks are refused
    before the run starts."""
    with pytest.raises(ValueError, match="split into"):
        run(tmp_path, "g", grad_cache=True, gc_q_chunks=chunks[0],
            gc_p_chunks=chunks[1])
    assert not (tmp_path / "g").exists()


def _jax_configs(untie=False):
    e = dict(ENC, hidden_dropout=0.0, attention_dropout=0.0)
    kw = dict(model_type="dhr", add_pooler=True, projection_dim=16,
              dlr_out_dim=OUT, untie_encoder=untie)
    return (JaxRetrieverConfig(encoder=JaxEncoderConfig(dtype=jnp.float32,
                                                        **e), **kw),
            RetrieverConfig(encoder=EncoderConfig(dtype=torch.float32, **e),
                            **kw))


def _batch():
    rng = np.random.default_rng(5)
    ids = rng.integers(REMOVE, V, (3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[2, 7:], mask[2, 7:] = 0, 0
    ids[:, 0] = 1
    return ids, mask


def _cli_args(path):
    return argparse.Namespace(
        model_name_or_path=path, model="dhr", untie_encoder=False,
        add_pooler=True, projection_dim=16, pooling="cls",
        no_combine_cls=False, dlr_out_dim=OUT, agg_dim=640,
        semi_aggregate=False, skip_mlm=False, bf16=False, tiny=False,
        tiny_vocab=V, cls_token_id=1, sep_token_id=2)


def test_hf_export_loads_in_the_reference_and_back(tmp_path):
    jcfg, tcfg = _jax_configs()
    model = load_flax_params(BiEncoder(tcfg), random_flax_params(
        tcfg, torch.Generator().manual_seed(2)))
    ckpt.export_hf_checkpoint(str(tmp_path / "port"), model, tcfg)
    assert {"pytorch_model.bin", "config.json", "pooler.pt",
            "TermWeightTrans.pt"} <= set(os.listdir(tmp_path / "port"))
    _, params = jcli._load_init_params(_cli_args(str(tmp_path / "port")),
                                       jcfg)
    ids, mask = _batch()
    jb = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    want, _ = JaxBiEncoder(jcfg).apply({"params": params}, query=jb)
    with torch.no_grad():
        got, _ = model(query={"input_ids": torch.from_numpy(ids),
                              "attention_mask": torch.from_numpy(mask)})
    for f in ("lexical", "semantic"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-6)
    # the port's encode verb on the export gives the model's own planes
    write_jsonl(str(tmp_path / "c.jsonl"), (
        {"text_id": str(i), "text": row[1:int(m.sum()) - 1].tolist()}
        for i, (row, m) in enumerate(zip(ids, mask))))
    cli(["encode", "--model-name-or-path", str(tmp_path / "port"),
         "--add-pooler", "--projection-dim", "16", "--dlr-out-dim", str(OUT),
         "--remove-dims", str(REMOVE), "--cls-token-id", "1",
         "--sep-token-id", "2", "--p-max-len", "12", "--device", "cpu",
         "--input", str(tmp_path / "c.jsonl"), "--output",
         str(tmp_path / "c.npz")])
    from dhr_tpu_torch.encode import EncodeConfig, Encoder

    sep = ids.copy()
    for i, m in enumerate(mask):
        sep[i, int(m.sum()) - 1] = 2
    want_vals, want_idx = Encoder(model, tcfg, EncodeConfig(
        remove_dims=REMOVE), device="cpu").encode_batch(sep, mask, "passage")
    with np.load(tmp_path / "c.npz") as z:
        np.testing.assert_array_equal(z["values"], want_vals.numpy())
        np.testing.assert_array_equal(z["indices"], want_idx.numpy())
    # and the reference's export of those weights loads into the port
    jax_export(str(tmp_path / "ref"), {"params": params}, jcfg)
    from dhr_tpu_torch.cli.main import _load_init_params

    back = _load_init_params(_cli_args(str(tmp_path / "ref")), tcfg)
    for (n, p), q in zip(model.named_parameters(), back.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_untied_export_round_trips(tmp_path):
    _, tcfg = _jax_configs(untie=True)
    model = load_flax_params(BiEncoder(tcfg), random_flax_params(
        tcfg, torch.Generator().manual_seed(4)))
    ckpt.export_hf_checkpoint(str(tmp_path), model, tcfg)
    assert {"query_model", "passage_model"} <= set(os.listdir(tmp_path))
    from dhr_tpu_torch.models.hf_io import load_hf_state_dict

    for side, enc in (("query_model", model.encoder_q),
                      ("passage_model", model.encoder_p)):
        sd = load_hf_state_dict(str(tmp_path / side))
        np.testing.assert_array_equal(
            sd["distilbert.embeddings.word_embeddings.weight"],
            enc.backbone.encoder.embeddings.word.weight.detach().numpy())


def test_cli_train_encode_index_search_on_the_cpu(tmp_path):
    rng = np.random.default_rng(8)
    write_jsonl(str(tmp_path / "corpus.jsonl"), (
        {"text_id": f"d{i}", "text": rng.integers(REMOVE, V, rng.integers(
            3, 12)).tolist()} for i in range(40)))
    write_jsonl(str(tmp_path / "train.jsonl"), (
        {"query": rng.integers(REMOVE, V, 5).tolist(),
         "positive_pids": [f"d{int(rng.integers(40))}"],
         "negative_pids": [f"d{int(i)}" for i in rng.integers(0, 40, 5)]}
        for _ in range(12)))
    write_jsonl(str(tmp_path / "q.jsonl"), (
        {"text_id": f"q{i}", "text": rng.integers(REMOVE, V, 4).tolist()}
        for i in range(5)))
    model = ["--tiny", "--add-pooler", "--dlr-out-dim", str(OUT),
             "--remove-dims", str(REMOVE), "--cls-token-id", "1",
             "--sep-token-id", "2", "--p-max-len", "16", "--q-max-len", "8",
             "--device", "cpu"]
    out = tmp_path / "run"
    cli(["train", *model, "--train-path", str(tmp_path / "train.jsonl"),
         "--corpus-path", str(tmp_path / "corpus.jsonl"), "--output-dir",
         str(out), "--batch-size", "4", "--train-n-passages", "3",
         "--warmup-steps", "1", "--num-epochs", "2", "--metrics-path",
         str(tmp_path / "m.jsonl"), "--log-steps", "1"])
    assert len(losses(tmp_path / "m.jsonl")) == 6
    assert ckpt.latest_step(str(out)) == 6
    trained = ["--model-name-or-path", str(out / "export")]
    cli(["encode", *model, *trained, "--input", str(tmp_path / "corpus.jsonl"),
         "--output", str(tmp_path / "c.npz")])
    cli(["encode", *model, *trained, "--input", str(tmp_path / "q.jsonl"),
         "--output", str(tmp_path / "qe.npz"), "--encode-is-qry"])
    cli(["index", "--inputs", str(tmp_path / "c.npz"), "--output",
         str(tmp_path / "idx.npz"), "--quantize"])
    cli(["search", "--index-path", str(tmp_path / "idx.npz"), "--query-path",
         str(tmp_path / "qe.npz"), "--topk", "10", "--rerank", "--theta",
         "0.0", "--device", "cpu", "--output", str(tmp_path / "run.trec")])
    run = read_run(str(tmp_path / "run.trec"))
    assert sorted(run) == [f"q{i}" for i in range(5)]
    assert all(len(d) == 10 for d in run.values())
    assert PackedIndex.load(str(tmp_path / "idx.npz")).num_rows == 40
    # the trained weights differ from the random start
    cli(["encode", *model, "--input", str(tmp_path / "corpus.jsonl"),
         "--output", str(tmp_path / "c0.npz")])
    with np.load(tmp_path / "c.npz") as a, np.load(tmp_path / "c0.npz") as b:
        assert not np.array_equal(a["values"], b["values"])


def test_train_verb_defaults_to_the_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_jsonl(str(tmp_path / "t.jsonl"), [{"query": [100],
                                             "positives": [[200]],
                                             "negatives": [[300]]}])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["train", "--tiny", "--cls-token-id", "1", "--sep-token-id", "2",
             "--train-path", str(tmp_path / "t.jsonl"), "--output-dir",
             str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
