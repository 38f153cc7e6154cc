"""The DeepSeek-V2-Lite cell's own files at a tiny size on the CPU: the port
built by ``port_model_decoder`` against ``reference/dhr_decoder.py``, the
per-tensor weight generator, ``roofline_moe``'s counts against a hand
count, and the whole cell through the harness."""

from __future__ import annotations

import torch

import benchmarks.tests.portbench_util  # noqa: F401  (the checkout's root)
from benchmarks import harness, roofline_moe
from benchmarks.gen import weights_decoder as wd
from benchmarks.tests.portbench_util import run_tiny

CELL = "dsv2-lite-encode-corpus"
TINY = {"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 2,
        "intermediate_size": 96, "moe_intermediate_size": 32,
        "n_routed_experts": 8, "n_shared_experts": 1,
        "num_experts_per_tok": 2, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
        "vocab_size": 256 + 768 * 2, "bos_token_id": 1790,
        "eos_token_id": 1791, "initializer_range": 0.05}


def tiny_cell(f32: bool = True):
    cell = harness.Cell(harness.manifest(), CELL)
    cell.config["model"].update(TINY)
    cell.config["head"].update(projection_dim=16)
    cell.traffic.update(passages_per_call=40, pool_calls=2,
                        checked_per_call=4,
                        token_ids={"lo": 256, "hi": 1790})
    if f32:
        cell.config["encode"]["compute_dtype"] = "float32"
    return cell


def test_the_config_file_holds_its_source_at_the_top_level():
    """The published config.json's keys stand at the file's top level as
    the source gives them (``source_config`` is the same copy), and the
    ``model`` the cell runs keeps every one of them: ``reduced`` is []."""
    entry = {c["name"]: c for c in harness.manifest()["configs"]}[
        "dhr-deepseek-v2-lite-msmarco"]
    data = harness.load_json(harness.ROOT / entry["file"])
    source = data["source_config"]
    assert entry["reduced"] == data["reduced"] == []
    assert {k: data[k] for k in source} == source
    assert {k: data["model"][k] for k in source} == source


def test_the_generator_draws_a_layer_alike_alone_and_in_the_whole():
    cfg = tiny_cell().config
    d = wd.model_dims(cfg)
    whole = wd.make_weights(cfg, 2**40 + 3, "cpu", torch.float32)
    again = wd.make_weights(cfg, 2**40 + 3, "cpu", torch.float32)
    assert all(torch.equal(whole[k], again[k]) for k in whole)
    for i in (0, 2):
        alone = wd.layer_weights(d, 2**40 + 3, i, "cpu")
        assert alone and all(torch.equal(v, whole[k])
                             for k, v in alone.items())
    outer = wd.outer_weights(d, 2**40 + 3, "cpu")
    assert set(outer) | {k for i in range(3) for k in
                         wd.layer_weights(d, 1, i, "cpu")} == set(whole)
    other = wd.make_weights(cfg, 2**40 + 4, "cpu", torch.float32)
    assert not torch.equal(other["lm_head.weight"], whole["lm_head.weight"])
    bf = wd.make_weights(cfg, 2**40 + 3, "cpu")
    assert bf["lm_head.weight"].dtype == torch.bfloat16
    assert bf["model.norm.weight"].dtype == torch.float32
    assert (bf["term_weight.linear.bias"] - 2.0).abs().max() < 0.5


def test_the_port_matches_the_reference_in_f32():
    from benchmarks.drivers.encode_corpus import collate
    from benchmarks.port_model_decoder import port_bi_encoder, \
        retriever_config
    from benchmarks.reference.dhr_decoder import dhr_reps
    from benchmarks.reference.dhr_model import Math

    cfg = tiny_cell().config
    d = wd.model_dims(cfg)
    rcfg = retriever_config(cfg, "float32")
    model = port_bi_encoder(wd.make_weights(cfg, 11, "cpu", torch.float32),
                            rcfg)
    toks = [list(range(300, 300 + n)) for n in (5, 17, 9)]
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
    assert total == 2 * int(mask.sum()) and 0 <= near <= total
    with torch.no_grad():
        low, _ = dhr_reps(d, 11, ids, mask, Math("fp8"))
    assert float((low - lex).norm() / lex.norm()) > 1e-3


def test_roofline_moe_against_a_hand_count():
    d = wd.model_dims(tiny_cell().config)
    n = 7
    H = 64
    mla = 2 * (H * 2 * 32 + H * (32 + 16) + 32 * 2 * 32 + 2 * 16 * H)
    expert = 2 * 3 * H * 32
    per_token = 3 * mla + 1 * 2 * 3 * H * 96 + 2 * (2 * H * 8 + 3 * expert)
    attn = 3 * 2 * 2 * (n * (n + 1) / 2) * (32 + 16)
    head = (n - 1) * 2 * (H * 1792 + H)
    want = per_token * n + attn + head + 2 * H * 16
    assert roofline_moe.tower_flops([n], d) == want
    assert roofline_moe.routed_expert_flops([n, 3], d) == 2 * 10 * 2 * expert
    assert roofline_moe.layer_counts(tiny_cell().config) == (1, 2)


def test_the_cell_runs_and_is_correct_on_the_cpu():
    line = run_tiny(tiny_cell(), trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 40
    got = line["metrics"]
    for name in ("encode.mfu_pct", "encode.transformer_ms",
                 "encode.head_ms"):
        assert name in got, name
    # the program's spans are there, but a CPU run has no device events:
    # no device ms under a device metric's name
    from dhr_tpu_torch.utils import profiling

    for name in ("moe.experts", "moe.route", "mla.attention"):
        assert profiling.spans(name)
    for name in ("moe.experts_ms", "moe.route_ms", "mla.attention_ms",
                 "moe.experts_roofline"):
        assert name not in got, name
    # the CPU takes the plain twin, which reads each expert's rows: 8 a
    # layer, 2 MoE layers
    assert got["moe.host_reads"]["value"] == 16


def test_the_cell_fails_the_fp8_control():
    from benchmarks.tools.control import run_control

    rec = run_control(CELL, 5, device="cpu", cell=tiny_cell(f32=False))
    assert rec["fails"], rec["checks"]
