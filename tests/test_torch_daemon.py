"""The port's ``daemon.Client`` and ``daemon.Server`` on the CPU, over
seeded ``_synthetic.py`` targets and the 16 smoke models: the
``search_hmm``, ``search_seq`` (with ranges) and ``scan_seq`` round
trips against the sequential ``Pipeline``'s ``search_hmm``,
``search_seq`` and ``scan_seq``, a server error, concurrent clients, and
the port's client against the JAX package's server (the cases of
``tests/test_api_surface.py`` and ``tests/test_errorpaths.py``).  An HMM
query travels as HMMER3 text, so the reference searches the model read
back from that text; the wire carries scores as f32, hence the 1e-4
bits and the relative 1e-6 on ln P of the JAX package's tests.  The
server builds sequence queries with the port's ``Builder`` on the
device it is given, the card by default: the tests give it
``device="cpu"``."""

import io
import threading

import pytest
import torch

from pyhmmer_tpu import daemon as jax_daemon
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch import daemon
from pyhmmer_tpu_torch.errors import ServerError
from pyhmmer_tpu_torch.plan7 import Builder, HMMFile, Pipeline
from test_torch_host import jax_block, jax_hmm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    """A server of one sequence database (200 seeded targets with domains
    of four smoke models planted) and one HMM database (the 16 smoke
    models); the query sequence is the best hit of the third model."""
    models = syn.smoke_models()
    seqs, _ = syn.make_targets(models[:4], 200, seed=71, median=200.0,
                               sigma=0.4)
    best = Pipeline(seqs.alphabet).search_hmm(models[2], seqs).reported[0]
    query = next(s for s in seqs if s.name == best.name)
    server = daemon.Server(seqdbs=[seqs], hmmdbs=[models], port=0,
                           device="cpu")
    server.start()
    yield server, seqs, models, query
    server.shutdown()


def wire_model(hmm):
    """``hmm`` as the server reads it off the wire (HMMER3 text)."""
    buf = io.BytesIO()
    hmm.write(buf)
    with HMMFile(io.BytesIO(buf.getvalue())) as f:
        return f.read()


def assert_same_hits(got, want):
    assert len(got) == len(want) and len(got) >= 1
    for g, w in zip(got, want):
        assert g.name == w.name
        assert g.score == pytest.approx(w.score, abs=1e-4)
        assert g.lnP == pytest.approx(w.lnP, rel=1e-6)
        assert len(g.domains) == len(w.domains)
        for dg, dw in zip(g.domains, w.domains):
            assert (dg.env_from, dg.env_to) == (dw.env_from, dw.env_to)
            assert dg.score == pytest.approx(dw.score, abs=1e-4)
            if dw.alignment is not None:
                assert dg.alignment.hmm_sequence == dw.alignment.hmm_sequence
                assert dg.alignment.target_from == dw.alignment.target_from
    assert got.Z == want.Z


@pytest.mark.parametrize("query", [1, 2])
def test_client_search_hmm(served, query):
    server, seqs, models, _ = served
    want = Pipeline(seqs.alphabet).search_hmm(wire_model(models[query]),
                                              seqs)
    with daemon.Client("127.0.0.1", server.port) as client:
        got = client.search_hmm(models[query])
    assert_same_hits(got, want)
    assert got.reported


def test_client_search_seq_with_ranges(served):
    server, seqs, models, query = served
    name = query.name
    index = list(seqs).index(query)
    ranges = [(index - 50, index + 49)]
    want = Pipeline(seqs.alphabet).search_seq(
        query, seqs, Builder(seqs.alphabet, device="cpu"))
    with daemon.Client("127.0.0.1", server.port) as client:
        full = client.search_seq(query)
        sub = client.search_seq(query, ranges=ranges)
    assert_same_hits(full, want)
    # the query finds itself inside the range it lies in
    assert any(h.name == name for h in sub)
    assert {h.name for h in sub} <= {h.name for h in full}


def test_served_search_seq_builds_on_the_server_device(served):
    """A served sequence query (the best hit of the first model) is built
    by a ``Builder`` on the server's device: its hits are those of
    ``Pipeline.search_seq`` with a CPU builder."""
    server, seqs, models, _ = served
    assert server.device == torch.device("cpu")
    best = Pipeline(seqs.alphabet).search_hmm(models[0], seqs).reported[0]
    query = next(s for s in seqs if s.name == best.name)
    want = Pipeline(seqs.alphabet).search_seq(
        query, seqs, Builder(seqs.alphabet, device="cpu"))
    with daemon.Client("127.0.0.1", server.port) as client:
        got = client.search_seq(query)
    assert_same_hits(got, want)
    assert got.reported[0].name == query.name


def test_server_without_cuda_raises(monkeypatch):
    """The server's default device is the card: without CUDA it raises,
    unless it is given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        daemon.Server()
    with pytest.raises(RuntimeError, match="cuda"):
        daemon.Server(device="cuda:0")
    assert daemon.Server(device="cpu").device == torch.device("cpu")


def test_client_scan_seq(served):
    server, seqs, models, query = served
    want = Pipeline(seqs.alphabet).scan_seq(query, models)
    with daemon.Client("127.0.0.1", server.port) as client:
        got = client.scan_seq(query)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.name == w.name
        assert g.score == pytest.approx(w.score, abs=1e-4)
    assert models[2].name in {h.name for h in got}


def test_server_error(served):
    server, seqs, _, _ = served
    with daemon.Client("127.0.0.1", server.port) as client:
        with pytest.raises(ServerError):
            client.search_seq(seqs[0], db=99)     # no such database
        # the connection survives the error
        assert client.search_seq(seqs[0]).Z == len(seqs)


def test_concurrent_clients(served):
    """Several clients searching at once against one server get complete,
    identical answers."""
    server, _, models, _ = served
    results, errors = [None] * 3, []

    def go(i):
        try:
            with daemon.Client("127.0.0.1", server.port) as client:
                th = client.search_hmm(models[0])
            results[i] = [(h.name, round(h.score, 3)) for h in th.hits]
        except Exception as exc:      # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert results[0] and results[0] == results[1] == results[2]


def test_port_client_and_jax_server(served):
    """The port's client reads the JAX package's server as it reads its
    own: the same hits, byte for byte on the wire."""
    server, seqs, models, _ = served
    jserver = jax_daemon.Server(seqdbs=[jax_block(seqs)],
                                hmmdbs=[[jax_hmm(h) for h in models]],
                                port=0)
    jserver.start()
    try:
        with daemon.Client("127.0.0.1", jserver.port) as client:
            got = client.search_hmm(models[0])
        with daemon.Client("127.0.0.1", server.port) as client:
            want = client.search_hmm(models[0])
    finally:
        jserver.shutdown()
    assert [(h.name, h.score, h.lnP) for h in got] == \
        [(h.name, h.score, h.lnP) for h in want]
    assert got.Z == want.Z
    assert pyhmmer_tpu_torch.daemon is daemon
