"""The check has to fail what it is there to catch: the reference in
bfloat16 put in the program's place, half of a call's targets left out,
and an answer altered where it is produced; and pass the program as it
is.  On the CPU at a small size (the program's plain PyTorch versions);
the last test runs a cell on the card."""

import json
import os
import subprocess
import sys

import pytest

from hmmbench.tests.helpers import ROOT, in_copy, run_tiny

CELLS = ("pfam-hmmsearch.oneshot", "pfam-hmmscan.b64")


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_as_it_is_passes(tiny_root, cell):
    result, summary = run_tiny(tiny_root, cell, seconds=0.1)
    assert result["correct"], result["checked"]
    assert [c["name"] for c in result["checked"]] == [
        "hit_diff", "env_diff", "score_gap_bits", "evalue_gap_log10",
        "fwd_gap_bits", "unclustered_compared"]
    assert list(result)[-1] == "checked"
    assert result["compared"]["unclustered_compared"] >= 1


def test_a_check_that_covers_too_few_hits_fails(tiny_root):
    # seed 12's first call of the scan answers no unclustered hit
    result, summary = run_tiny(tiny_root, CELLS[1], seed=12, seconds=0.1)
    assert result["compared"]["unclustered_compared"] == 0
    assert len(summary["checked_keys"]) == summary["calls"] * 8
    assert not result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails(tiny_root, cell):
    with in_copy(tiny_root):
        from hmmbench import control
        row = control.control(cell, 7, 3, "cpu", str(tiny_root))
    assert row["fails"], row


def test_half_the_targets_left_out_fails(tiny_root, monkeypatch):
    from pyhmmer_tpu_torch import engine
    from pyhmmer_tpu_torch.easel.sequence import DigitalSequenceBlock
    search = engine.SearchEngine.search

    def half(self, queries, targets, callback=None):
        kept = DigitalSequenceBlock(targets.alphabet,
                                    list(targets)[: len(targets) // 2])
        return search(self, queries, kept, callback)
    monkeypatch.setattr(engine.SearchEngine, "search", half)
    # seed 12's first call has unclustered hits in the half kept
    result, _ = run_tiny(tiny_root, CELLS[0], seed=12, seconds=0.1)
    assert not result["correct"]
    checked = {c["name"]: c["value"] for c in result["checked"]}
    # Z is the targets searched: every E-value moves by log10(2)
    assert checked["evalue_gap_log10"] == pytest.approx(0.30103, abs=1e-3)


def test_half_the_batch_left_out_fails(tiny_root, monkeypatch):
    from pyhmmer_tpu_torch import hmmer
    scan = hmmer._scan_via_engine

    def half(hmms, queries, *args, **kwargs):
        return scan(hmms, queries[: len(queries) // 2], *args, **kwargs)
    monkeypatch.setattr(hmmer, "_scan_via_engine", half)
    result, summary = run_tiny(tiny_root, CELLS[1], seconds=0.1)
    assert not result["correct"]
    assert result["failed"] >= 4 * summary["calls"]


# seeds whose checked answers hold an unclustered hit (the scores of
# clustered hits are not compared)
@pytest.mark.parametrize("cell, seed", zip(CELLS, (12, 11)))
def test_an_answer_altered_where_it_is_produced_fails(tiny_root,
                                                      monkeypatch, cell,
                                                      seed):
    from pyhmmer_tpu_torch.plan7.pipeline import Pipeline
    build = Pipeline._build_hit

    def altered(self, *args, **kwargs):
        hit = build(self, *args, **kwargs)
        if hit is not None:
            hit.score += 0.05
        return hit
    monkeypatch.setattr(Pipeline, "_build_hit", altered)
    result, _ = run_tiny(tiny_root, cell, seed=seed, seconds=0.1)
    assert not result["correct"]
    checked = {c["name"]: c["value"] for c in result["checked"]}
    assert checked["score_gap_bits"] == pytest.approx(0.05, abs=1e-3)


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "hmmbench/run.py", "--workload", CELLS[0],
         "--seed", "2718281828", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT),
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
