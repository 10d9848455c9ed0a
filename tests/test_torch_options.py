"""Options of the port's application layer and engine, on the CPU: the
six functions that take the JAX package's ``cpus`` argument accept it
and ignore it, ``hmmsearch(..., backend="oracle")`` gives the JAX
package's sequential rows, and the port's ``SearchEngine`` reports the JAX engine's
rows with the native host library switched off
(``PYHMMER_TPU_NATIVE=0``), where ``domaindef`` runs in numpy and draws
from the pipeline's random stream."""

import io

import numpy as np
import pytest
import torch

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.engine import SearchEngine as JSearchEngine
from pyhmmer_tpu.ops import native as jnative
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import SequenceFile
from pyhmmer_tpu_torch.engine import SearchEngine
from pyhmmer_tpu_torch.ops import native as tnative
from pyhmmer_tpu_torch.plan7 import Background, Builder
from test_torch_host import jax_block, jax_hmm, rows

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    """Two smoke models (stored evparams), 40 targets with domains of
    them planted, and a planted target as a phmmer query."""
    models = syn.smoke_models()[:2]
    targets, planted = syn.make_targets(models, 40, seed=31, median=160.0,
                                        sigma=0.4)
    name = sorted(planted[models[0].name])[0]
    query = next(s for s in targets if s.name == name)
    return models, targets, query


def _dna():
    h = syn.sample_dna_models((60,), seed=33)[0]
    Builder(h.alphabet, device="cpu").calibrate(h, Background(h.alphabet))
    genome, _ = syn.make_genome([h], 1, 6_000, 2, seed=34, gap=500)
    return h, genome


def _nh_rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.best_domain.env_from, h.best_domain.env_to)
            for h in th.reported]


APPS = {
    "hmmsearch": lambda m, t, q, **kw: [rows(th) for th in
                                        pyhmmer_tpu_torch.hmmsearch(
                                            m, t, device="cpu", **kw)],
    "hmmscan": lambda m, t, q, **kw: [rows(th) for th in
                                      pyhmmer_tpu_torch.hmmscan(
                                          list(t)[:4], m, device="cpu",
                                          **kw)],
    "phmmer": lambda m, t, q, **kw: [rows(th) for th in
                                     pyhmmer_tpu_torch.phmmer(
                                         q, t, device="cpu", **kw)],
    "jackhmmer": lambda m, t, q, **kw: [
        (rows(r.hits), len(r.msa), r.converged) for r in next(
            pyhmmer_tpu_torch.jackhmmer(q, t, device="cpu",
                                        max_iterations=2,
                                        checkpoints=True, **kw))],
    "hmmalign": lambda m, t, q, **kw: pyhmmer_tpu_torch.hmmalign(
        m[0], list(t)[:6], **kw).alignment,
    "nhmmer": lambda m, t, q, **kw: [
        _nh_rows(th) for th in pyhmmer_tpu_torch.nhmmer(*_dna(),
                                                        device="cpu", **kw)],
}


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_accepts_cpus(small, app):
    """``cpus=4`` is taken and ignored: the same output as without."""
    models, targets, query = small
    want = APPS[app](models, targets, query)
    got = APPS[app](models, targets, query, cpus=4)
    assert got == want
    assert want, f"{app} gave no output to compare"


@pytest.mark.parametrize("source", ["block", "file"])
def test_hmmsearch_oracle_backend_matches_jax(small, source):
    """``backend="oracle"`` runs the sequential ``Pipeline`` a query, as
    the JAX package's ``hmmsearch`` does: the same rows as the JAX
    package's oracle and as the port's engine, the callback called once
    a query with the query and their count; a ``SequenceFile`` is read
    whole (one block, so the rows and Z are the block's)."""
    models, targets, _ = small
    jmodels = [jax_hmm(h) for h in models]
    want = list(jax_hmmer.hmmsearch(jmodels, jax_block(targets),
                                    backend="oracle"))
    engine = list(pyhmmer_tpu_torch.hmmsearch(models, targets,
                                              device="cpu"))
    seen = []
    if source == "file":
        fasta = io.StringIO()
        for s in targets:
            t = s.textize()
            fasta.write(f">{t.name.decode()}\n{t.sequence}\n")
        fasta.seek(0)
        with SequenceFile(fasta, digital=True,
                          alphabet=models[0].alphabet) as sf:
            got = list(pyhmmer_tpu_torch.hmmsearch(
                models, sf, device="cpu", backend="oracle",
                callback=lambda q, n: seen.append((q.name, n))))
    else:
        got = list(pyhmmer_tpu_torch.hmmsearch(
            models, targets, device="cpu", backend="oracle",
            callback=lambda q, n: seen.append((q.name, n))))
    assert [rows(th) for th in got] == [rows(th) for th in want]
    assert [rows(th) for th in got] == [rows(th) for th in engine]
    assert [th.Z for th in got] == [th.Z for th in want] == [len(targets)] * 2
    assert seen == [(h.name, len(models)) for h in models]
    assert sum(len(th.reported) for th in got) > 0


def test_engine_without_native_matches_jax(monkeypatch):
    """The first 6 smoke models against 300 seeded targets through both
    engines, each package's native library switched off: the switch is
    read once, when ``get_lib`` first loads the library, so the cached
    state is reset here too (and restored after, so later tests in this
    worker keep the native path)."""
    monkeypatch.setenv("PYHMMER_TPU_NATIVE", "0")
    asked = []
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
        real = mod.available

        def spy(real=real, mod=mod):
            ok = real()
            asked.append((mod.__name__, ok))
            return ok
        monkeypatch.setattr(mod, "available", spy)
    models = syn.smoke_models()[:6]
    targets, _ = syn.make_targets(models, 300, seed=7)
    got = SearchEngine(models[0].alphabet, device="cpu").search(
        models, targets)
    jmodels = [jax_hmm(h) for h in models]
    want = JSearchEngine(jmodels[0].alphabet).search(jmodels,
                                                     jax_block(targets))
    assert {name for name, _ in asked} == {jnative.__name__,
                                           tnative.__name__}
    assert not any(ok for _, ok in asked)
    assert tnative._lib is None and jnative._lib is None
    assert [rows(th) for th in got] == [rows(th) for th in want]
    assert sum(len(th.reported) for th in got) > 0
    assert np.all([th.Z == len(targets) for th in got])
