"""The port's slice as a whole: ``pyhmmer_tpu_torch.hmmsearch`` on the
CPU (the kernels' plain PyTorch versions) against the JAX engine on the
CPU and the sequential float64 oracle pipeline, on sampled and
calibrated models searched against random targets with planted
domains.  Each package searches its own objects, built from the same
seeded arrays.  Reported rows must be identical, as in
``test_execution_modes.py``."""

import io
import os
import subprocess
import sys

import pytest
import torch

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.plan7.background import Background
from pyhmmer_tpu.plan7.builder import Builder
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import DigitalSequenceBlock, SequenceFile
from test_torch_host import jax_block, jax_hmm, port_hmm

# the plain versions loop over small tensors: one intra-op thread per
# test process keeps pytest-xdist workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one model per Forward route of the JAX engine (Mp <= 384, <= 768, >)
MODELS = (40, 100, 420, 800)


def rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.included, len(h.domains)) for h in th.reported]


@pytest.fixture(scope="module")
def workload():
    """The port's models, calibrated by the JAX package (the port has no
    calibration yet) and carried back; the JAX package's oracle rows."""
    jhmms = [jax_hmm(h) for h in syn.sample_models(MODELS, seed=7)]
    bg = Background(jhmms[0].alphabet)
    for h in jhmms:
        Builder(h.alphabet).calibrate(h, bg)
    hmms = [port_hmm(h) for h in jhmms]
    targets, planted = syn.make_targets(hmms, 150, seed=8,
                                        long_lengths=(3000,))
    oracle = list(jax_hmmer.hmmsearch(jhmms, jax_block(targets),
                                      backend="oracle"))
    return hmms, targets, planted, oracle


def test_matches_oracle(workload):
    hmms, targets, planted, oracle = workload
    port = list(pyhmmer_tpu_torch.hmmsearch(hmms, targets, device="cpu"))
    assert [rows(th) for th in port] == [rows(th) for th in oracle]
    assert [th.Z for th in port] == [th.Z for th in oracle]
    assert all(th.reported for th in port), "every query reports a hit"
    # the weak gapped plants are meant to fail the later gates
    assert syn.recall(port, planted) >= 0.25


def test_matches_jax_engine(workload):
    """Against the JAX engine on the CPU, over the targets of the
    shortest length bucket (one XLA compilation per chunk)."""
    hmms, targets, _, _ = workload
    short = DigitalSequenceBlock(hmms[0].alphabet,
                                 [s for s in targets if len(s) <= 512])
    port = list(pyhmmer_tpu_torch.hmmsearch(hmms, short, device="cpu"))
    jax_engine = list(jax_hmmer.hmmsearch([jax_hmm(h) for h in hmms],
                                          jax_block(short)))
    assert [rows(th) for th in port] == [rows(th) for th in jax_engine]
    assert any(th.reported for th in port)


def force_device_cascade(monkeypatch):
    """Turn off speculation and the sparse host path, so every bias
    survivor takes the device Forward stage."""
    for name, value in (("SPECULATE_P1B", -1.0), ("HOST_MIN_PAIRS", 0),
                        ("HOST_PAIRS_PER_ROW", 0.0)):
        monkeypatch.setattr(pyhmmer_tpu_torch.engine, name, value)


def test_forced_device_cascade_matches_oracle(workload, monkeypatch):
    """Every bias survivor takes the Forward stage, and the Viterbi stage
    runs."""
    hmms, targets, _, oracle = workload
    force_device_cascade(monkeypatch)
    eng = pyhmmer_tpu_torch.SearchEngine(hmms[0].alphabet, device="cpu")
    port = eng.search(hmms, targets)
    assert [rows(th) for th in port] == [rows(th) for th in oracle]
    assert eng.last_timing["n_s2_jobs"] > 0
    assert eng.last_timing["n_s3_jobs"] > 0


def test_streamed_file_matches_block(workload):
    hmms, targets, _, oracle = workload
    fasta = io.StringIO()
    for s in targets:
        t = s.textize()
        fasta.write(f">{t.name.decode()}\n{t.sequence}\n")
    fasta.seek(0)
    with SequenceFile(fasta, digital=True, alphabet=hmms[0].alphabet) as sf:
        streamed = list(pyhmmer_tpu_torch.hmmsearch(
            hmms, sf, device="cpu", block_residues=20_000))
    assert [rows(th) for th in streamed] == [rows(th) for th in oracle]


def test_cuda_device_raises_without_cuda(workload, monkeypatch):
    hmms, targets, _, _ = workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pyhmmer_tpu_torch.hmmsearch(hmms, targets, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pyhmmer_tpu_torch.SearchEngine(hmms[0].alphabet)


@pytest.mark.parametrize("device_rows", [False, True],
                         ids=["rows_off", "rows_on"])
def test_search_never_imports_jax(device_rows):
    """A search imports neither JAX nor any module of the JAX package,
    with the device rows stage off and on (on: with the cascade forced,
    so the rows stage has pairs)."""
    force = ("for k, v in (('SPECULATE_P1B', -1.0), ('HOST_MIN_PAIRS', 0),"
             " ('HOST_PAIRS_PER_ROW', 0.0)):\n"
             "    setattr(pt.engine, k, v)\n") if device_rows else ""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import pyhmmer_tpu_torch as pt\n"
        "from pyhmmer_tpu_torch import _synthetic as syn\n"
        + force +
        "models = syn.smoke_models()[:2]\n"
        "targets, _ = syn.make_targets(models, 30, seed=1)\n"
        "res = list(pt.hmmsearch(models, targets, device='cpu', "
        f"device_rows={device_rows}))\n"
        "assert len(res) == 2 and all(th.reported for th in res)\n"
        "eng = pt.SearchEngine(models[0].alphabet, device='cpu', "
        f"device_rows={device_rows})\n"
        "eng.search(models, targets)\n"
        f"assert ('n_rows_ext' in eng.last_timing) == {device_rows}\n"
        "jax = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
        "assert not jax, jax\n"
        "ref = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'pyhmmer_tpu')\n"
        "assert not ref, ref\n"
        "print('no jax')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("no jax")
