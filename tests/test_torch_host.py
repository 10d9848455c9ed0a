"""The port's own host layers (``pyhmmer_tpu_torch.{easel,plan7}``,
``ops.{quantize,reference,native}``, ``csrc/hmmdp.cpp``) against the JAX
package's, of which they are copies: the same seeded models, profiles,
backgrounds, quantization and reference DP give identical arrays; the two
native libraries, loaded side by side in this process, give identical
outputs; the port's sequential ``Pipeline`` reports what the JAX
package's oracle ``hmmsearch`` reports.  And no module of the port, nor
``chip_smoke.py``, imports the JAX package or JAX.

The helpers here carry models and target blocks between the packages
through the port's array form (``ops.batch.hmm_arrays`` /
``block_arrays``); the other ``test_torch_*.py`` files import them."""

import ast
import os

import numpy as np
import pytest

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.easel.alphabet import Alphabet as JAlphabet
from pyhmmer_tpu.easel.sequence import DigitalSequence as JSequence
from pyhmmer_tpu.easel.sequence import DigitalSequenceBlock as JBlock
from pyhmmer_tpu.ops import native as jax_native
from pyhmmer_tpu.ops import quantize as jax_quantize
from pyhmmer_tpu.ops import reference as jax_ref
from pyhmmer_tpu.plan7.background import Background as JBackground
from pyhmmer_tpu.plan7.hmm import HMM as JHMM
from pyhmmer_tpu.plan7.profile import Profile as JProfile
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import native, quantize, reference
from pyhmmer_tpu_torch.plan7 import Background, Pipeline, Profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = (30, 90, 260)
PROFILE_FIELDS = ("tBM", "tMM", "tIM", "tDM", "tMD", "tDD", "tMI", "tII",
                  "msc", "isc", "xE", "xN", "xJ", "xC", "compo", "nj", "L",
                  "name")


def jax_hmm(hmm) -> JHMM:
    """The JAX package's HMM with the fields of the port's ``hmm``."""
    d = TB.hmm_arrays(hmm)
    out = JHMM(JAlphabet.from_type(d["alphabet"]), d["M"], name=d["name"])
    out.t[...] = d["t"]
    out.mat[...] = d["mat"]
    out.ins[...] = d["ins"]
    out.evparam[:] = d["evparam"]
    out.cutoffs[:] = d["cutoffs"]
    if d["composition"] is not None:
        out.composition = np.array(d["composition"], dtype=np.float32)
    out.flags = d["flags"]
    for name in ("accession", "description", "consensus",
                 "consensus_structure", "max_length"):
        setattr(out, name, d[name])
    return out


def port_hmm(hmm):
    """The port's HMM with the fields of the JAX package's ``hmm``."""
    return TB.hmm_from_arrays(TB.hmm_arrays(hmm))


def jax_block(block) -> JBlock:
    """The JAX package's target block with the port block's sequences."""
    d = TB.block_arrays(block)
    alphabet = JAlphabet.from_type(d["alphabet"])
    return JBlock(alphabet, [
        JSequence(alphabet, name=n, accession=a, description=s, sequence=q)
        for n, a, s, q in zip(d["names"], d["accessions"],
                              d["descriptions"], d["sequences"])])


def jax_models(Ms, seed):
    """``_synthetic.sample_models`` run by the JAX package's classes."""
    rng = np.random.default_rng(seed)
    out = []
    for M in Ms:
        h = JHMM.sample(JAlphabet.amino(), int(M), rng)
        h.name = b"smoke-M%03d" % M
        out.append(h)
    return out


def rows(th):
    return [(h.name, round(h.score, 4), float(f"{h.evalue:.4g}"),
             h.included, len(h.domains)) for h in th.reported]


@pytest.fixture(scope="module")
def models():
    return syn.sample_models(MODELS, seed=5)


@pytest.fixture(scope="module")
def lanes(models):
    return syn.make_lanes(models, 24, 300, seed=6)


def profiles(hmm, L=400, multihit=True):
    """(port, JAX) profiles of the port's ``hmm`` and its JAX copy."""
    jh = jax_hmm(hmm)
    return (Profile(hmm.M, hmm.alphabet).configure(
        hmm, Background(hmm.alphabet), L, multihit=multihit),
        JProfile(jh.M, jh.alphabet).configure(
            jh, JBackground(jh.alphabet), L, multihit=multihit))


def test_sampled_models_equal_jax(models):
    for h, jh in zip(models, jax_models(MODELS, seed=5)):
        assert type(h).__module__ == "pyhmmer_tpu_torch.plan7.hmm"
        assert h.name == jh.name and h.M == jh.M
        for name in ("t", "mat", "ins"):
            np.testing.assert_array_equal(getattr(h, name),
                                          getattr(jh, name), err_msg=name)
        h.validate()


def test_hmm_arrays_round_trip(models):
    for h in syn.smoke_models()[:3] + models:
        back = port_hmm(jax_hmm(h))
        a, b = TB.hmm_arrays(h), TB.hmm_arrays(back)
        assert a.keys() == b.keys()
        for name in a:
            if isinstance(a[name], np.ndarray):
                np.testing.assert_array_equal(a[name], b[name], name)
            else:
                assert a[name] == b[name], name


def test_block_arrays_round_trip(models):
    block, _ = syn.make_targets(models, 12, seed=3)
    back = TB.block_from_arrays(TB.block_arrays(jax_block(block)))
    assert len(back) == len(block) == 12
    for s, t in zip(block, back):
        assert (s.name, s.accession, s.description) == \
            (t.name, t.accession, t.description)
        np.testing.assert_array_equal(s.sequence, t.sequence)
    assert back.alphabet == block.alphabet


def test_background_equals_jax(models, lanes):
    codes, lengths = lanes
    bg, jbg = Background(models[0].alphabet), JBackground(JAlphabet.amino())
    np.testing.assert_array_equal(bg.residue_frequencies,
                                  jbg.residue_frequencies)
    assert (bg.L, bg.p1, bg.omega) == (jbg.L, jbg.p1, jbg.omega)
    for L in (1, 100, 2500):
        bg.set_length(L)
        jbg.set_length(L)
        assert bg.null_one(L) == jbg.null_one(L)
    prof, jprof = profiles(models[1])
    bg.set_filter(prof.M, prof.compo)
    jbg.set_filter(jprof.M, jprof.compo)
    np.testing.assert_array_equal(bg.filter_odds_table(),
                                  jbg.filter_odds_table())
    for b in range(4):
        dsq = codes[b, : lengths[b]]
        assert bg.filter_score(dsq) == jbg.filter_score(dsq)


@pytest.mark.parametrize("multihit", [True, False], ids=["multi", "uni"])
@pytest.mark.parametrize("L", [400, 37])
def test_profile_configure_equals_jax(models, multihit, L):
    for h in models:
        prof, jprof = profiles(h, L, multihit)
        for name in PROFILE_FIELDS:
            np.testing.assert_array_equal(getattr(prof, name),
                                          getattr(jprof, name), name)
        np.testing.assert_array_equal(np.asarray(prof.evparam),
                                      np.asarray(jprof.evparam))


def test_quantize_equals_jax(models):
    for h in models:
        prof, jprof = profiles(h)
        q, jq = quantize.quantize_msv(prof), jax_quantize.quantize_msv(jprof)
        for name in vars(jq):
            np.testing.assert_array_equal(getattr(q, name),
                                          getattr(jq, name), name)
    L = np.array([1, 30, 280, 35000])
    np.testing.assert_array_equal(quantize.tjb_units(L),
                                  jax_quantize.tjb_units(L))


def test_reference_dp_equals_jax(models, lanes):
    """The NumPy DP (the engine's fallback without the native library)."""
    codes, lengths = lanes
    prof, jprof = profiles(models[0])
    for b in (0, 3, 7):
        dsq = codes[b, : lengths[b]]
        assert reference.viterbi_score(prof, dsq) == \
            jax_ref.viterbi_score(jprof, dsq)
        assert reference.msv_score(prof, dsq) == \
            jax_ref.msv_score(jprof, dsq)
        f, jf = reference.forward(prof, dsq), jax_ref.forward(jprof, dsq)
        assert f.score == jf.score
        np.testing.assert_array_equal(f.xE, jf.xE)


@pytest.fixture(scope="module")
def natives():
    if not (native.available() and jax_native.available()):
        pytest.skip("native host library unavailable")
    assert native._LIB != jax_native._LIB
    return native, jax_native


def test_native_bias_filter_equals_jax(natives, models, lanes):
    codes, lengths = lanes
    cols = np.arange(0, len(lengths), 2)
    for h in models:
        prof, jprof = profiles(h)
        bg, jbg = Background(h.alphabet), JBackground(JAlphabet.amino())
        bg.set_filter(prof.M, prof.compo)
        jbg.set_filter(jprof.M, jprof.compo)
        got = native.bias_filter_rows(bg.filter_odds_table(), codes,
                                      lengths, cols)
        want = jax_native.bias_filter_rows(jbg.filter_odds_table(), codes,
                                           lengths, cols)
        np.testing.assert_array_equal(got, want)


def test_native_viterbi_equals_jax(natives, models, lanes):
    codes, lengths = lanes
    for h in models:
        prof, jprof = profiles(h)
        for b in range(0, len(lengths), 3):
            dsq = codes[b, : lengths[b]]
            assert native.viterbi_score(prof, dsq) == \
                jax_native.viterbi_score(jprof, dsq)


def test_native_domaindef_equals_jax(natives, models, lanes):
    codes, lengths = lanes
    k = len(models)
    checked = 0
    for pi, h in enumerate(models):
        prof, jprof = profiles(h)
        # the consensus lane and the planted lane of this model
        for b in (pi, k + pi):
            dsq = codes[b, : lengths[b]]
            got = native.domaindef(prof, dsq, True, 42)
            want = jax_native.domaindef(jprof, dsq, True, 42)
            assert got[0] == want[0]
            res, jres = got[1], want[1]
            for name in ("nexpected", "nregions", "nclustered", "noverlaps",
                         "nenvelopes"):
                assert getattr(res, name) == getattr(jres, name), name
            np.testing.assert_array_equal(res.n2sc, jres.n2sc)
            assert len(res.domains) == len(jres.domains)
            for d, jd in zip(res.domains, jres.domains):
                for name in ("ienv", "jenv", "envsc", "domcorrection",
                             "oasc", "iali", "jali", "hmmfrom", "hmmto"):
                    assert getattr(d, name) == getattr(jd, name), name
                for a, b_ in zip(d.trace.np_arrays, jd.trace.np_arrays):
                    np.testing.assert_array_equal(a, b_)
            checked += len(res.domains)
    assert checked > 0


def test_oracle_pipeline_equals_jax():
    """The port's ``Pipeline.search_hmm`` against the JAX package's
    ``hmmsearch(backend="oracle")``, which runs the same loop."""
    models = syn.smoke_models()[:2]
    targets, _ = syn.make_targets(models, 60, seed=9)
    want = list(jax_hmmer.hmmsearch([jax_hmm(h) for h in models],
                                    jax_block(targets), backend="oracle"))
    got = [Pipeline(targets.alphabet).search_hmm(h, targets)
           for h in models]
    assert [rows(th) for th in got] == [rows(th) for th in want]
    assert [th.Z for th in got] == [th.Z for th in want]
    assert all(th.reported for th in got)


def imported_modules(path):
    """Top-level names of every module ``path`` imports (absolute)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "pyhmmer_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 25
    bad = [(os.path.relpath(p, ROOT), m) for p in paths
           for m in imported_modules(p)
           if m.split(".")[0] in ("pyhmmer_tpu", "jax", "jaxlib")]
    assert not bad, bad
