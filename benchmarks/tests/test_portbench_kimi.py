"""The Kimi-Linear cell's own files at a tiny size on the CPU: the
configuration against its source, the port built by ``port_model_kimi``
against ``reference/dhr_kimi_linear.py``, the per-tensor weight generator,
``roofline_kda``'s counts against a hand count, the ``kda.*`` readers on a
fake run, and the whole cell through the harness."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import benchmarks.tests.portbench_util  # noqa: F401  (the checkout's root)
from benchmarks import harness, roofline_kda
from benchmarks.gen import weights_kimi as wk
from benchmarks.tests.portbench_util import run_tiny
from dhr_tpu_torch.utils import profiling

CELL = "kimi-linear-encode-docs"
CONFIG = "dhr-kimi-linear-48b-a3b-msmarco-doc"
TINY = {"num_hidden_layers": 4, "hidden_size": 64, "num_attention_heads": 2,
        "intermediate_size": 96, "moe_intermediate_size": 32,
        "num_experts": 4, "experts_held": [0, 4],
        "num_experts_per_token": 3, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
        "linear_attn_config": {"kda_layers": [1, 2, 4],
                               "full_attn_layers": [3], "num_heads": 2,
                               "head_dim": 16, "short_conv_kernel_size": 4},
        "vocab_size": 256 + 768 * 2, "bos_token_id": 1790,
        "eos_token_id": 1791, "initializer_range": 0.05}


def tiny_cell(f32: bool = True):
    cell = harness.Cell(harness.manifest(), CELL)
    cell.config["model"].update(TINY)
    cell.config["expert_parallel"]["published_num_experts"] = 8
    cell.config["head"].update(projection_dim=16)
    cell.config["encode"].update(batch_size=4, p_max_len=160)
    cell.traffic.update(passages_per_call=12, pool_calls=2,
                        checked_per_call=3,
                        passage_tokens={"mean": 60, "sigma": 0.8, "min": 8,
                                        "max": 150},
                        token_ids={"lo": 256, "hi": 1790})
    if f32:
        cell.config["encode"]["compute_dtype"] = "float32"
    return cell


def test_the_config_file_holds_its_source_but_the_experts_held():
    """The catalog's keys stand at the file's top level as the source gives
    them, but ``num_experts``: the 128 of 256 this chip holds, the one key
    in ``reduced``; the model the cell runs keeps every other one, at
    published widths and depth, and states the deployment."""
    entry = {c["name"]: c for c in harness.manifest()["configs"]}[CONFIG]
    data = harness.load_json(harness.ROOT / entry["file"])
    source = data["source_config"]
    assert entry["reduced"] == data["reduced"] == ["num_experts"]
    assert {k: data[k] for k in source if k != "num_experts"} == \
        {k: v for k, v in source.items() if k != "num_experts"}
    assert (source["num_experts"], data["num_experts"],
            data["model"]["num_experts"]) == (256, 128, 128)
    assert data["model"]["experts_held"] == [0, 128]
    assert data["expert_parallel"] == {"chips_per_layer": 2,
                                       "published_num_experts": 256,
                                       "experts_held": [0, 128]}
    d = wk.model_dims(data)
    assert (d["layers"], d["hidden"], d["experts"], d["top_k"],
            len(d["kda_layers"])) == (27, 2304, 256, 8, 20)
    assert roofline_kda.layer_counts(data) == {"kda": 20, "mla": 7,
                                               "moe": 26, "dense": 1}
    params = sum(torch.Size(s).numel() for _, s in wk.shapes(d))
    assert 25.4e9 < params < 25.8e9


def test_the_generator_draws_a_layer_alike_alone_and_in_the_whole():
    cfg = tiny_cell().config
    d = wk.model_dims(cfg)
    whole = wk.make_weights(cfg, 2**40 + 3, "cpu", torch.float32)
    for i in (0, 1, 2):
        alone = wk.layer_weights(d, 2**40 + 3, i, "cpu")
        assert alone and all(torch.equal(v, whole[k])
                             for k, v in alone.items())
    outer = wk.outer_weights(d, 2**40 + 3, "cpu")
    assert set(outer) | {k for i in range(4) for k in
                         wk.layer_weights(d, 1, i, "cpu")} == set(whole)
    bf = wk.make_weights(cfg, 2**40 + 3, "cpu")
    assert bf["lm_head.weight"].dtype == torch.bfloat16
    for name in ("model.layers.0.self_attn.A_log",
                 "model.layers.0.self_attn.dt_bias",
                 "model.layers.1.mlp.gate.e_score_correction_bias",
                 "model.norm.weight"):
        assert bf[name].dtype == torch.float32, name
    a_log = whole["model.layers.0.self_attn.A_log"].exp()
    assert ((a_log >= 1) & (a_log <= 16)).all()
    dt = torch.nn.functional.softplus(
        whole["model.layers.0.self_attn.dt_bias"])
    assert ((dt > 9e-4) & (dt < 0.11)).all()
    assert whole["model.layers.2.mlp.experts.gate_proj"].shape == (4, 32, 64)
    assert whole["model.layers.2.mlp.gate.weight"].shape == (8, 64)


def test_the_port_matches_the_reference_in_f32():
    from benchmarks.drivers.encode_corpus import collate
    from benchmarks.port_model_decoder import port_bi_encoder
    from benchmarks.port_model_kimi import retriever_config
    from benchmarks.reference.dhr_kimi_linear import dhr_reps
    from benchmarks.reference.dhr_model import Math

    cfg = tiny_cell().config
    d = wk.model_dims(cfg)
    rcfg = retriever_config(cfg, "float32")
    assert rcfg.encoder.n_routed_experts == 8
    assert rcfg.encoder.experts_held == (0, 4)
    model = port_bi_encoder(wk.make_weights(cfg, 11, "cpu", torch.float32),
                            rcfg)
    toks = [list(range(300, 300 + n)) for n in (5, 70, 9)]
    ids, mask = collate(toks, 1790, 1791)
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


def test_roofline_kda_against_a_hand_count():
    cfg = tiny_cell().config
    d = wk.model_dims(cfg)
    h, k = 2, 16
    # 130 tokens: chunks of 64, 64 and 2; 5: one of 5
    per_chunk = {c: c * c * (7 * k + 3 * k) + 6 * c * k * k
                 for c in (64, 2, 5)}
    want = h * (2 * per_chunk[64] + per_chunk[2] + per_chunk[5])
    assert roofline_kda.scan_flops([130, 5], d) == want
    assert roofline_kda.scan_bytes([130, 5], d) == 135 * h * (12 * k + 4)
    H, D = 64, 32
    n = 7
    kda = 2 * (3 * H * D + 3 * D * 4 + 2 * (H * k + k * D) + H * h + D * H)
    mla = 2 * (H * 2 * 32 + H * (32 + 16) + 32 * 2 * 32 + 2 * 16 * H)
    expert = 2 * 3 * H * 32
    per_token = (3 * kda + mla + 2 * 3 * H * 96
                 + 3 * (2 * H * 8 + (3 * 4 / 8 + 1) * expert))
    attn = 2 * 2 * (n * (n + 1) / 2) * (32 + 16)
    head = (n - 1) * 2 * (H * 1792 + H)
    total = (per_token * n + attn + head + 3 * roofline_kda.scan_flops([n], d)
             + 2 * H * 16)
    assert roofline_kda.tower_flops([n], d) == pytest.approx(total)


class _Event:
    def __init__(self, ms: float):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_the_kda_readers_on_a_fake_run():
    """Two ``kda.scan`` spans of 2 and 4 device ms and two ``kda.attention``
    spans of 5 and 7 inside the window, one of each outside: a batch is 20
    layers of each; the roofline reads the window's work a batch over
    that."""
    profiling.reset()
    t0, t1 = 1000.0, 1010.0
    for name, times in (("kda.scan", (2.0, 4.0)),
                        ("kda.attention", (5.0, 7.0))):
        for start, ms in ((t0 + 1, times[0]), (t0 + 2, times[1]),
                          (t1 + 1, 100.0)):
            s = profiling.record(name, start, start + 0.01)
            s.start_event, s.end_event = _Event(0.0), _Event(ms)
    cfg = harness.Cell(harness.manifest(), CELL).config
    work = {"kda_scan_flops": 2 * 989e12 * 1e-3,
            "kda_scan_bytes": 2 * 3.35e12 * 2e-3, "window_batches": 2}
    run = SimpleNamespace(ctx=SimpleNamespace(t_start=t0 - 20.0,
                                              setup_s=20.0, config=cfg),
                          window_s=t1 - t0, work=work)
    read = {m: harness.load_reader(m).read for m in (
        "kda.scan_ms", "kda.attention_ms", "kda.scan_roofline")}
    assert read["kda.scan_ms"](run) == pytest.approx(60.0)
    assert read["kda.attention_ms"](run) == pytest.approx(120.0)
    # a batch: 2 ms of bytes against 60 ms of scans
    assert read["kda.scan_roofline"](run) == pytest.approx(100 * 2 / 60)
    profiling.reset()
    assert all(r(run) is None for r in read.values())


def test_the_cell_runs_and_is_correct_on_the_cpu():
    line = run_tiny(tiny_cell(), trace=True)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"lexical_gap", "cls_gap", "fold_gap",
                                   "route_gap"}
    assert line["attempted"] >= 12
    got = line["metrics"]
    for name in ("encode.mfu_pct", "encode.transformer_ms",
                 "encode.head_ms"):
        assert name in got, name
    # the program's spans are there, but a CPU run has no device events:
    # no device ms under a device metric's name
    for name in ("kda.scan", "kda.attention", "mla.attention",
                 "moe.experts"):
        assert profiling.spans(name)
    for name in ("kda.scan_ms", "kda.attention_ms", "kda.scan_roofline"):
        assert name not in got, name


def test_the_cell_fails_the_fp8_control():
    from benchmarks.tools.control import run_control

    rec = run_control(CELL, 5, device="cpu", cell=tiny_cell(f32=False))
    assert rec["fails"], rec["checks"]


def test_the_router_fault_shows_in_the_route_gap_alone():
    """The f32 reference choosing its experts without the correction bias,
    in the program's place: the reps follow its routes, so they pass to
    round-off, and the route gap alone reads the fault (the cell's limit
    does not catch a fault that small: PERF.md, section 2)."""
    from benchmarks.tools.control import run_control

    rec = run_control(CELL, 5, device="cpu", cell=tiny_cell(f32=False),
                      fault="router_no_bias")
    checks = rec["checks"]
    assert checks["route_gap"]["value"] > 1e-3, checks
    assert all(checks[k]["value"] < 1e-3 for k in (
        "lexical_gap", "cls_gap", "fold_gap")), checks


def test_checked_routes_pick_each_document_out_of_its_batch():
    """Fake gate outputs, a call a MoE layer a batch, whose rows name
    their document and position: each checked document of the call gets
    its own real tokens' rows of every layer, in order."""
    import numpy as np

    from benchmarks.drivers.encode_docs_kimi import checked_routes
    from dhr_tpu_torch import encode as enc_mod

    ctx = SimpleNamespace(traffic={"passages_per_call": 5}, config={
        "encode": {"p_max_len": 40, "batch_size": 2}})
    lens = np.array([3, 30, 7, 1, 12, 5, 38, 9, 2, 20])
    c, n_moe = 1, 3
    real = np.minimum(lens[5:] + 2, 40)
    plan, _ = enc_mod.plan_length_buckets(real, 2, 40)
    taken = []
    for sel, _ in plan:
        rows = torch.cat([torch.stack([torch.full((int(real[i]),), int(i)),
                                       torch.arange(int(real[i]))], 1)
                          for i in sel])
        taken += [rows + 100 * j for j in range(n_moe)]
    got = checked_routes(ctx, enc_mod, lens, c, [0, 3, 4], taken, n_moe)
    for i, layers in zip([0, 3, 4], got):
        assert len(layers) == n_moe
        for j, r in enumerate(layers):
            want = torch.stack([torch.full((int(real[i]),), i),
                                torch.arange(int(real[i]))], 1) + 100 * j
            assert torch.equal(r, want)
    with pytest.raises(RuntimeError, match="gate calls"):
        checked_routes(ctx, enc_mod, lens, c, [0], taken[:-1], n_moe)


def test_the_reference_follows_given_routes_and_measures_their_gap():
    """Given its own experts, the reference returns the same reps with a
    route gap of 0; given the experts chosen without the correction bias
    (the control's planted fault), the reps move and the gap is the
    choice scores it gave up."""
    from benchmarks.drivers.encode_corpus import collate
    from benchmarks.reference.dhr_kimi_linear import dhr_reps
    from benchmarks.reference.dhr_model import Math

    cfg = tiny_cell().config
    d = wk.model_dims(cfg)
    toks = [list(range(300, 300 + n)) for n in (5, 70, 9)]
    ids, mask = map(torch.as_tensor, collate(toks, 1790, 1791))
    runs = {}
    with torch.no_grad():
        for name, kw in (("own", {}), ("no_bias", {"no_bias": True})):
            log = {"gaps": []}
            runs[name] = dhr_reps(d, 7, ids, mask, Math(), block=2, log=log,
                                  **kw), log
        (lex, sem), own = runs["own"]
        assert [len(r) for r in own["routes"]] == [3] * 3
        assert [r[0].shape for r in own["routes"]] == \
            [(n + 2, 3) for n in (5, 70, 9)]
        for name, (_, given) in runs.items():
            log = {"gaps": []}
            got = dhr_reps(d, 7, ids, mask, Math(), block=2,
                           routes=given["routes"], log=log)
            gaps = torch.tensor(log["gaps"])
            assert gaps.shape == (3 * 2, 3)
            if name == "own":
                assert torch.equal(got[0], lex) and torch.equal(got[1], sem)
                assert float(gaps[:, 0].max()) == 0.0
                assert int(gaps[:, 1].sum()) == 0
            else:
                assert float(gaps[:, 0].max()) > 1e-3
                assert int(gaps[:, 1].sum()) > 0
                assert float((got[0] - lex).norm()) > 0
