"""Each cell's check against its control and the faults its timed path can
have.  A tiny run of each cell on the CPU (the look for a card skipped)
with the program broken underneath must come out not correct, and the
sound run correct; the control, the reference one precision step down in
the program's place, must fail a limit.

The limits are the cells' own files'; the tiny encode and train runs
compute the model in f32, so their sound runs read round-off."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks.harness import import_program
from benchmarks.tests.portbench_util import run_tiny, tiny_cell
from benchmarks.tools.control import run_control

CELLS = ["msmarco-search-batch", "bert-base-encode-corpus",
         "bert-base-train"]


@pytest.mark.parametrize("name", CELLS + ["msmarco-online-text"])
def test_sound_run_is_correct(name):
    line = run_tiny(tiny_cell(name, f32=True))
    assert line["correct"], line["checks"]


def test_train_reference_draws_the_programs_masks():
    """With dropout on and the program in f32, the reference's three steps
    follow the program's to round-off: both draw the same masks from the
    seed, for the rows in the loader's order."""
    cell = tiny_cell("bert-base-train", f32=True)
    assert cell.config["model"]["hidden_dropout_prob"] > 0
    assert cell.config["model"]["attention_probs_dropout_prob"] > 0
    checks = run_tiny(cell)["checks"]
    assert checks["batch_mismatch"]["value"] == 0
    assert checks["loss_gap"]["value"] < 1e-5, checks
    assert checks["grad_gap"]["value"] < 1e-4, checks
    assert checks["change_gap"]["value"] < 1e-4, checks


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """At a test's size; the encode cell's at its own widths and depth (on
    a few passages), the train cell's at its own widths with two layers and
    two groups of four passages a step: fp8's error grows with the widths,
    and a tiny model's stays under the limits that the chip's readings
    set."""
    from benchmarks import harness

    cell = tiny_cell(name)
    if name == "bert-base-encode-corpus":
        cell = harness.Cell(harness.manifest(), name)
        cell.traffic.update(passages_per_call=64, pool_calls=1,
                            checked_per_call=6)
    if name == "bert-base-train":
        cell = harness.Cell(harness.manifest(), name)
        cell.config["model"]["num_hidden_layers"] = 2
        cell.config["train"].update(batch_size=2, n_passages=4)
        cell.traffic.update(groups=6, n_passages=4)
    rec = run_control(name, 7, "cpu", cell)
    assert rec["fails"], rec["checks"]


def _search_answer_altered(mp):
    s = import_program("dhr_tpu_torch.retrieval.searcher").Searcher
    orig = s.stage2

    def stage2(self, qv, qi, cand_rows):
        vals, rows = orig(self, qv, qi, cand_rows)
        rows = rows.clone()
        rows[:, 0] = (rows[:, 0] + 1) % self.index.num_rows
        return vals, rows

    mp.setattr(s, "stage2", stage2)


def _search_half_batch(mp):
    s = import_program("dhr_tpu_torch.retrieval.searcher").Searcher
    orig = s.search_batch

    def search_batch(self, qv, qv1, qi):
        h = max(qv.shape[0] // 2, 1)
        vals, rows, floor = orig(self, qv[:h], qv1[:h], qi[:h])
        idx = torch.arange(qv.shape[0]) % h
        return vals[idx], rows[idx], floor[idx]

    mp.setattr(s, "search_batch", search_batch)


def _encode_answer_altered(mp):
    e = import_program("dhr_tpu_torch.encode").Encoder
    orig = e.planes

    def planes(self, reps):
        vals, idxs = orig(self, reps)
        vals = vals.clone()
        vals[:, 0] += vals.abs().amax()
        return vals, idxs

    mp.setattr(e, "planes", planes)


def _encode_half_batch(mp):
    e = import_program("dhr_tpu_torch.encode").Encoder
    orig = e.encode_batch

    def encode_batch(self, input_ids, attention_mask, role):
        ids, mask = np.asarray(input_ids), np.asarray(attention_mask)
        h = max(len(ids) // 2, 1)
        vals, idxs = orig(self, ids[:h], mask[:h], role)
        idx = torch.arange(len(ids), device=vals.device) % h
        return vals[idx], idxs[idx]

    mp.setattr(e, "encode_batch", encode_batch)


def _train_state_unchanged(mp):
    st = import_program("dhr_tpu_torch.train.state").TrainState

    def apply_gradients(self):
        self.step += 1

    mp.setattr(st, "apply_gradients", apply_gradients)


def _train_half_batch(mp):
    step = import_program("dhr_tpu_torch.train.step")
    orig = step.compute_loss

    def compute_loss(cfg, loss_cfg, q_reps, p_reps, teacher):
        h = q_reps.lexical.shape[0] // 2
        n = loss_cfg.n_passages
        cut = type(q_reps)(lexical=q_reps.lexical[:h],
                           semantic=q_reps.semantic[:h])
        pcut = type(p_reps)(lexical=p_reps.lexical[:h * n],
                            semantic=p_reps.semantic[:h * n])
        return orig(cfg, loss_cfg, cut, pcut, teacher)

    mp.setattr(step, "compute_loss", compute_loss)


def _train_token_altered(mp):
    loader = import_program("dhr_tpu_torch.data.loader").TrainLoader
    orig = loader._collate

    def _collate(self, items, epoch, rng):
        batch = orig(self, items, epoch, rng)
        for side in ("query", "passage"):
            ids = batch[side]["input_ids"]
            ids[:, 1] = (ids[:, 1] + 1) % 1000 + 1000
        return batch

    mp.setattr(loader, "_collate", _collate)


FAULTS = [
    ("msmarco-search-batch", _search_answer_altered),
    ("msmarco-search-batch", _search_half_batch),
    ("bert-base-encode-corpus", _encode_answer_altered),
    ("bert-base-encode-corpus", _encode_half_batch),
    ("bert-base-train", _train_state_unchanged),
    ("bert-base-train", _train_half_batch),
    ("bert-base-train", _train_token_altered),
    ("msmarco-online-text", _search_answer_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run_tiny(tiny_cell(name, f32=True))
    assert not line["correct"], line["checks"]
