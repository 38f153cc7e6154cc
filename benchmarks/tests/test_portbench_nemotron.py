"""The Nemotron-H cell's own files at a tiny size on the CPU: the
configuration against its source, the port built by
``port_model_nemotron`` against ``reference/dhr_nemotron_h.py``, the
per-tensor weight generator, ``roofline_mamba``'s counts against a hand
count, the ``mamba.*`` and ``gqa.*`` readers on a fake run, and the whole
cell through the harness, with its fp8 control and router fault."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import benchmarks.tests.portbench_util  # noqa: F401  (the checkout's root)
from benchmarks import harness, roofline_mamba
from benchmarks.gen import weights_nemotron as wn
from benchmarks.tests.portbench_util import run_tiny
from dhr_tpu_torch.utils import profiling

CELL = "nemotron3-nano-encode-docs"
CONFIG = "dhr-nemotron-3-nano-30b-a3b-msmarco-doc"
TINY = {"num_hidden_layers": 7, "hybrid_override_pattern": "MEM*EME",
        "hidden_size": 64, "mamba_num_heads": 4, "mamba_head_dim": 16,
        "ssm_state_size": 16, "n_groups": 2, "chunk_size": 16,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "moe_intermediate_size": 32,
        "moe_shared_expert_intermediate_size": 48, "n_routed_experts": 8,
        "num_experts_per_tok": 3, "vocab_size": 512 + 768 * 2,
        "initializer_range": 0.05}


def tiny_cell(f32: bool = True):
    cell = harness.Cell(harness.manifest(), CELL)
    cell.config["model"].update(TINY)
    cell.config["head"].update(projection_dim=16)
    cell.config["encode"].update(batch_size=4, p_max_len=160)
    cell.traffic.update(passages_per_call=12, pool_calls=2,
                        checked_per_call=3,
                        passage_tokens={"mean": 60, "sigma": 0.8, "min": 8,
                                        "max": 150},
                        token_ids={"lo": 512, "hi": 2048})
    if f32:
        cell.config["encode"]["compute_dtype"] = "float32"
    return cell


def test_the_config_file_holds_its_source_whole():
    """Every key of the catalog's config stands at the file's top level and
    in the model the cell runs as the source gives it: nothing is cut, and
    the model is 31.58B parameters."""
    entry = {c["name"]: c for c in harness.manifest()["configs"]}[CONFIG]
    data = harness.load_json(harness.ROOT / entry["file"])
    source = data["source_config"]
    assert entry["reduced"] == data["reduced"] == []
    assert {k: data[k] for k in source} == source
    assert {k: data["model"][k] for k in source} == source
    d = wn.model_dims(data)
    assert (d["layers"], d["hidden"], d["experts"], d["top_k"],
            d["mamba_heads"], d["state"]) == (52, 2688, 128, 6, 64, 128)
    assert d["dt_limit"] == (0.0, float("inf"))
    assert roofline_mamba.layer_counts(data) == {"mamba": 23,
                                                 "attention": 6, "moe": 23}
    # the decoder's parameters, the routers' correction biases (buffers in
    # the port) and the DHR head's
    params = sum(torch.Size(s).numel() for _, s in wn.shapes(d))
    assert params == 31_577_937_344 + 23 * 128 + 2688 + 1 + 128 * 2688 + 128
    head = data["head"]
    assert (d["vocab"] - head["remove_dims"]) % head["dlr_out_dim"] == 0


def test_the_generator_draws_a_block_alike_alone_and_in_the_whole():
    cfg = tiny_cell().config
    d = wn.model_dims(cfg)
    whole = wn.make_weights(cfg, 2**40 + 3, "cpu", torch.float32)
    for i in (0, 1, 3):
        alone = wn.layer_weights(d, 2**40 + 3, i, "cpu")
        assert alone and all(torch.equal(v, whole[k])
                             for k, v in alone.items())
    outer = wn.outer_weights(d, 2**40 + 3, "cpu")
    assert set(outer) | {k for i in range(7) for k in
                         wn.layer_weights(d, 1, i, "cpu")} == set(whole)
    bf = wn.make_weights(cfg, 2**40 + 3, "cpu")
    assert bf["lm_head.weight"].dtype == torch.bfloat16
    assert bf["model.layers.0.mixer.conv1d.bias"].dtype == torch.bfloat16
    for name in ("model.layers.0.mixer.A_log", "model.layers.0.mixer.D",
                 "model.layers.0.mixer.dt_bias",
                 "model.layers.0.mixer.norm.weight",
                 "model.layers.1.mixer.gate.e_score_correction_bias",
                 "model.layers.1.norm.weight", "model.norm.weight"):
        assert bf[name].dtype == torch.float32, name
    assert torch.equal(whole["model.layers.0.mixer.A_log"].exp(),
                       torch.arange(1.0, 5.0))
    assert torch.equal(whole["model.layers.0.mixer.D"], torch.ones(4))
    dt = torch.nn.functional.softplus(whole["model.layers.0.mixer.dt_bias"])
    assert ((dt > 9.9e-4) & (dt < 0.101)).all()
    conv = whole["model.layers.0.mixer.conv1d.bias"]
    assert conv.abs().max() <= 0.5 and conv.std() > 0.1
    assert whole["model.layers.1.mixer.experts.up_proj"].shape == (8, 32, 64)
    assert whole["model.layers.3.mixer.k_proj.weight"].shape == (32, 64)


def test_the_port_matches_the_reference_in_f32():
    from benchmarks.drivers.encode_corpus import collate
    from benchmarks.port_model_decoder import port_bi_encoder
    from benchmarks.port_model_nemotron import retriever_config
    from benchmarks.reference.dhr_model import Math
    from benchmarks.reference.dhr_nemotron_h import dhr_reps

    cfg = tiny_cell().config
    d = wn.model_dims(cfg)
    rcfg = retriever_config(cfg, "float32")
    assert rcfg.encoder.hybrid_override_pattern == "MEM*EME"
    model = port_bi_encoder(wn.make_weights(cfg, 11, "cpu", torch.float32),
                            rcfg)
    toks = [list(range(600, 600 + n)) for n in (5, 40, 17)]
    ids, mask = collate(toks, 1, 2)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    ties = []
    with torch.no_grad():
        lex, sem = dhr_reps(d, 11, ids, mask, Math(), block=2, ties=ties)
        reps = model.encoder_q(ids, mask)
    torch.testing.assert_close(reps.lexical, lex, rtol=1e-5,
                               atol=1e-5 * float(lex.abs().max()))
    torch.testing.assert_close(reps.semantic, sem, rtol=1e-5,
                               atol=1e-5 * float(sem.abs().max()))
    near, total = map(sum, zip(*ties))
    assert total == 3 * int(mask.sum()) and 0 <= near <= total
    with torch.no_grad():
        low, _ = dhr_reps(d, 11, ids, mask, Math("fp8"))
    assert float((low - lex).norm() / lex.norm()) > 1e-3


def test_roofline_mamba_against_a_hand_count():
    cfg = tiny_cell().config
    d = wn.model_dims(cfg)
    h, P, g, N = 4, 16, 2, 16
    # 35 tokens: chunks of 16, 16 and 3; 5: one of 5
    per_chunk = {c: g * 2 * c * c * N + h * (2 * c * c * P + 4 * c * N * P)
                 for c in (16, 3, 5)}
    want = 2 * per_chunk[16] + per_chunk[3] + per_chunk[5]
    assert roofline_mamba.scan_flops([35, 5], d) == want
    assert roofline_mamba.scan_bytes([35, 5], d) == \
        40 * (2 * h * P + 4 * g * N + 4 * h + 2 * h * P)
    H, D, conv, n = 64, 64, 64 + 64, 7
    mamba = 2 * (H * (D + conv + h) + conv * 4 + D * H)
    attn = 2 * (H * (4 + 2 * 2) * 16 + 4 * 16 * H)
    moe = 2 * (H * 8 + 2 * H * (3 * 32 + 48))
    per_token = 3 * mamba + attn + 3 * moe
    pairs = 2 * 4 * (n * (n + 1) / 2) * 32
    head = (n - 1) * 2 * (H * 2048 + H)
    total = (per_token * n + pairs + head
             + 3 * roofline_mamba.scan_flops([n], d) + 2 * H * 16)
    assert roofline_mamba.tower_flops([n], d) == pytest.approx(total)


class _Event:
    def __init__(self, ms: float):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_the_mamba_and_gqa_readers_on_a_fake_run():
    """Two spans of each name inside the window, one outside: a batch is
    23 Mamba-2 blocks and 6 attention blocks; the roofline reads the
    window's work a batch over the scans' device time."""
    profiling.reset()
    t0, t1 = 1000.0, 1010.0
    for name, times in (("mamba.scan", (2.0, 4.0)),
                        ("mamba.mixer", (5.0, 7.0)),
                        ("gqa.attention", (1.0, 2.0))):
        for start, ms in ((t0 + 1, times[0]), (t0 + 2, times[1]),
                          (t1 + 1, 100.0)):
            s = profiling.record(name, start, start + 0.01)
            s.start_event, s.end_event = _Event(0.0), _Event(ms)
    cfg = harness.Cell(harness.manifest(), CELL).config
    work = {"mamba_scan_flops": 2 * 989e12 * 1e-3,
            "mamba_scan_bytes": 2 * 3.35e12 * 2e-3, "window_batches": 2}
    run = SimpleNamespace(ctx=SimpleNamespace(t_start=t0 - 20.0,
                                              setup_s=20.0, config=cfg),
                          window_s=t1 - t0, work=work)
    read = {m: harness.load_reader(m).read for m in (
        "mamba.scan_ms", "mamba.mixer_ms", "mamba.scan_roofline",
        "gqa.attention_ms")}
    assert read["mamba.scan_ms"](run) == pytest.approx(69.0)
    assert read["mamba.mixer_ms"](run) == pytest.approx(138.0)
    assert read["gqa.attention_ms"](run) == pytest.approx(9.0)
    # a batch: 2 ms of bytes against 69 ms of scans
    assert read["mamba.scan_roofline"](run) == pytest.approx(100 * 2 / 69)
    profiling.reset()
    assert all(r(run) is None for r in read.values())


def test_the_cell_runs_and_is_correct_on_the_cpu():
    line = run_tiny(tiny_cell(), trace=True)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"lexical_gap", "cls_gap", "fold_gap",
                                   "route_gap"}
    assert line["checks"]["route_gap"]["value"] == 0.0
    assert line["attempted"] >= 12
    got = line["metrics"]
    for name in ("encode.mfu_pct", "encode.transformer_ms",
                 "encode.head_ms"):
        assert name in got, name
    # the program's spans are there, but a CPU run has no device events:
    # no device ms under a device metric's name
    for name in ("mamba.mixer", "mamba.scan", "gqa.attention",
                 "moe.experts"):
        assert profiling.spans(name)
    for name in ("mamba.mixer_ms", "mamba.scan_ms", "mamba.scan_roofline",
                 "gqa.attention_ms"):
        assert name not in got, name


def test_the_cell_fails_the_fp8_control():
    from benchmarks.tools.control import run_control

    rec = run_control(CELL, 5, device="cpu", cell=tiny_cell(f32=False))
    assert rec["fails"], rec["checks"]


def test_the_router_fault_shows_in_the_route_gap_alone():
    """The f32 reference choosing its experts without the correction bias,
    in the program's place: the reps follow its routes, so they pass to
    round-off, and the route gap alone reads the fault."""
    from benchmarks.tools.control import run_control

    rec = run_control(CELL, 5, device="cpu", cell=tiny_cell(f32=False),
                      fault="router_no_bias")
    checks = rec["checks"]
    assert checks["route_gap"]["value"] > 1e-3, checks
    assert all(checks[k]["value"] < 1e-3 for k in (
        "lexical_gap", "cls_gap", "fold_gap")), checks
