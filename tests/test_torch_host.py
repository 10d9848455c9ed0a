"""The port's own host layers (``pyhmmer_tpu_torch.{easel,plan7}``,
``ops.{quantize,reference,native}``, ``csrc/hmmdp.cpp``) against the JAX
package's, of which they are copies: the same seeded models, profiles,
backgrounds, quantization and reference DP give identical arrays; the two
native libraries, loaded side by side in this process, give identical
outputs; the port's sequential ``Pipeline`` reports what the JAX
package's oracle ``hmmsearch`` reports; the copied statistics, priors,
alignments, bit fields, random numbers, trace alignment and iterative
search give what the originals give, and each copied module's code is
the original's but for imports, docstrings and the methods the port
leaves out or changes (``COPIES``).  And no module of the port, nor
``chip_smoke.py`` or ``scripts/make_torch_smoke_evparams.py``, imports
the JAX package or JAX.

The helpers here carry models and target blocks between the packages
through the port's array form (``ops.batch.hmm_arrays`` /
``block_arrays``); the other ``test_torch_*.py`` files import them."""

import ast
import os
import re

import numpy as np
import pytest

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.easel import containers as jax_containers
from pyhmmer_tpu.easel import msa as jax_msa
from pyhmmer_tpu.easel import random as jax_random
from pyhmmer_tpu.easel.alphabet import Alphabet as JAlphabet
from pyhmmer_tpu.easel.sequence import DigitalSequence as JSequence
from pyhmmer_tpu.easel.sequence import DigitalSequenceBlock as JBlock
from pyhmmer_tpu.ops import native as jax_native
from pyhmmer_tpu.ops import quantize as jax_quantize
from pyhmmer_tpu.ops import reference as jax_ref
from pyhmmer_tpu.plan7 import fitting as jax_fitting
from pyhmmer_tpu.plan7 import priors as jax_priors
from pyhmmer_tpu.plan7 import tracealign as jax_tracealign
from pyhmmer_tpu.plan7.background import Background as JBackground
from pyhmmer_tpu.plan7.builder import Builder as JBuilder
from pyhmmer_tpu.plan7.hmm import HMM as JHMM
from pyhmmer_tpu.plan7.pipeline import Pipeline as JPipeline
from pyhmmer_tpu.plan7.profile import Profile as JProfile
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import (Alphabet, DigitalSequence, containers,
                                     msa, random)
from pyhmmer_tpu_torch.ops import batch as TB
from pyhmmer_tpu_torch.ops import native, quantize, reference
from pyhmmer_tpu_torch.plan7 import (Background, Builder, Pipeline, Profile,
                                     fitting, priors, tracealign)

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
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "make_torch_smoke_evparams.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "pyhmmer_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 35
    for new in ("_device", "plan7/builder", "plan7/fitting", "plan7/priors",
                "plan7/tracealign", "plan7/iteration", "easel/msa",
                "easel/containers", "easel/random", "plan7/longtargets",
                "plan7/optimized", "daemon", "easel/ssi", "plan7/hmmfile",
                "plan7/pressed", "parallel/mesh", "parallel/multihost",
                "parallel/_worker", "graft_entry", "easel/gencode",
                "easel/msafile", "easel/ncbi", "plan7/output"):
        assert os.path.join(ROOT, "pyhmmer_tpu_torch", new + ".py") in paths
    bad = [(os.path.relpath(p, ROOT), m) for p in paths
           for m in imported_modules(p)
           if m.split(".")[0] in ("pyhmmer_tpu", "jax", "jaxlib")]
    assert not bad, bad


#: each copied module (path under both packages) with the definitions the
#: port leaves out (their imports reach modules it does not copy, or
#: nothing of the port uses them) and those it changes on purpose
COPIES = {
    "easel/alphabet": ((), ()),
    "easel/sequence": ((), ()),
    "easel/msa": ((), ()),
    "easel/containers": ((), ()),
    "easel/gencode": ((), ()),
    "easel/msafile": ((), ()),
    "easel/ncbi": ((), ()),
    "easel/seqfile": ((), ()),
    "easel/random": ((), ()),
    "plan7/fitting": ((), ()),
    "plan7/priors": ((), ()),
    "plan7/builder": ((), ("Builder.__init__", "Builder.copy",
                           "Builder.calibrate")),
    "plan7/tracealign": ((), ()),
    "plan7/iteration": ((), ()),
    "plan7/pipeline": ((), ()),
    "plan7/results": ((), ()),
    "plan7/output": ((), ()),
    "plan7/domaindef": ((), ()),
    "plan7/evalues": ((), ()),
    "plan7/background": ((), ()),
    "plan7/hmm": ((), ()),
    "plan7/profile": ((), ()),
    # the device gates on the port's kernels, chosen by the pipeline's
    # device; no fallback to the host path (so no warning flag); the
    # default Builder of sequence and MSA queries on the same device
    "plan7/longtargets": (("_DEVICE_GATE_WARNED = False",),
                          ("LongTargetsPipeline.__init__",
                           "LongTargetsPipeline.search_seq",
                           "LongTargetsPipeline.search_msa",
                           "LongTargetsPipeline._flush_subwindows",
                           "LongTargetsPipeline._device_gates")),
    # a pressed database is read from its exact .h3m member where it has
    # one (the JAX package rebuilds lossy models from .h3f/.h3p)
    "plan7/optimized": ((), ("HMMPressedFile.__init__",)),
    "plan7/hmmfile": ((), ()),
    "plan7/pressed": ((), ()),
    "easel/ssi": ((), ()),
    # the server's sequence queries built on the device it is given
    "daemon": ((), ("Server.__init__", "Server._run_query")),
    "plan7/views": ((), ()),
    "plan7/ensemble": ((), ()),
}


class _NoDocstrings(ast.NodeTransformer):
    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _strip


def definitions(path):
    """{name: AST dump without docstrings} of a module's functions, the
    methods (``Class.method``) and header of its classes and its other
    statements, leaving out imports, the docstring and ``__all__``."""
    tree = _NoDocstrings().visit(ast.parse(open(path).read(), path))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if (isinstance(node, ast.Expr) and isinstance(node.value,
                                                       ast.Constant)):
            continue
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            continue
        if isinstance(node, ast.ClassDef):
            body, node.body = node.body, []
            out[node.name] = ast.dump(node)
            for item in body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = ast.dump(item)
                elif not isinstance(item, ast.Pass):
                    out[f"{node.name}: {ast.unparse(item)}"] = ""
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        else:
            out[ast.unparse(node)] = ""
    return out


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copied_code_equals_jax(module):
    """The port's copy holds the original's definitions, each with the
    same code (imports and docstrings aside), but those it leaves out or
    changes on purpose."""
    left_out, changed = COPIES[module]
    got = definitions(os.path.join(ROOT, "pyhmmer_tpu_torch", module + ".py"))
    want = definitions(os.path.join(ROOT, "pyhmmer_tpu", module + ".py"))
    dropped = {k for k in want
               if k in left_out or re.split("[.:]", k)[0] in left_out}
    assert set(got) == set(want) - dropped
    differ = sorted(k for k in got if got[k] != want[k])
    assert differ == sorted(changed)


def test_fitting_equals_jax():
    rng = np.random.default_rng(31)
    x = 3.0 - np.log(-np.log(rng.uniform(size=500))) / 0.7
    for name, args in (("gumbel_fit_complete", (x,)),
                       ("gumbel_fit_complete_loc", (x, 0.7)),
                       ("exp_fit_complete", (x[:40],))):
        assert getattr(fitting, name)(*args) == \
            getattr(jax_fitting, name)(*args), name


@pytest.mark.parametrize("scheme", ["alphabet", "laplace"])
def test_priors_equal_jax(models, scheme):
    aa, jaa = models[0].alphabet, JAlphabet.amino()
    prior = priors.for_alphabet(aa, scheme)
    jprior = jax_priors.for_alphabet(jaa, scheme)
    rng = np.random.default_rng(32)
    counts = rng.gamma(0.5, 3.0, (12, aa.K))
    np.testing.assert_array_equal(priors.match_posterior(counts, prior),
                                  jax_priors.match_posterior(counts,
                                                             jprior))
    h, jh = models[0].copy(), jax_hmm(models[0])
    for m in (h, jh):
        m.mat[1:] *= 5.0
        m.ins *= 2.0
        m.t *= 3.0
    priors.parameter_estimation(h, prior)
    jax_priors.parameter_estimation(jh, jprior)
    for name in ("mat", "ins", "t"):
        np.testing.assert_array_equal(getattr(h, name), getattr(jh, name),
                                      name)


def port_and_jax_msa(codes):
    out = []
    for mod, aa in ((msa, Alphabet.amino()), (jax_msa, JAlphabet.amino())):
        m = mod.DigitalMSA(aa, name=b"aln")
        m.names = [b"s%d" % i for i in range(len(codes))]
        m.codes = codes.copy()
        out.append(m)
    return out


def test_msa_equals_jax(lanes):
    codes, lengths = lanes
    aln = codes[:12, :80].copy()
    gap = JAlphabet.amino().gap_code
    aln[:, 70:] = gap
    aln[3, :50] = gap
    aln[aln == JAlphabet.amino().nonresidue_code] = gap
    m, jm = port_and_jax_msa(aln)
    np.testing.assert_array_equal(m.compute_weights(), jm.compute_weights())
    assert list(m.mark_fragments(0.7)) == list(jm.mark_fragments(0.7))
    assert m.checksum() == jm.checksum()
    assert m.textize().rows == jm.textize().rows
    assert m.identity_filter(0.3).names == jm.identity_filter(0.3).names
    sel, jsel = (x.select(sequences=[0, 3, 5], columns=range(10, 60))
                 for x in (m, jm))
    np.testing.assert_array_equal(sel.codes, jsel.codes)
    for a, b in zip(m.sequences_as_unaligned(), jm.sequences_as_unaligned()):
        np.testing.assert_array_equal(a.sequence, b.sequence)


def test_bitfield_and_randomness_equal_jax(models):
    bits = [True, False, True, True, False]
    b, jb = containers.Bitfield(bits), jax_containers.Bitfield(bits)
    for x in (b, jb):
        x.toggle(1)
        x[-1] = True
    assert list(b) == list(jb) and b.count() == jb.count()
    r, jr = random.Randomness(42), jax_random.Randomness(42)
    assert [r.random() for _ in range(5)] == [jr.random() for _ in range(5)]
    r2, jr2 = r.copy(), jr.copy()
    assert r2.normalvariate(1.0, 2.0) == jr2.normalvariate(1.0, 2.0)
    a = DigitalSequence.sample(models[0].alphabet, 60, random.Randomness(5))
    ja = JSequence.sample(JAlphabet.amino(), 60, jax_random.Randomness(5))
    np.testing.assert_array_equal(a.sequence, ja.sequence)


def test_tracealign_equals_jax(models, lanes):
    """``TraceAligner`` on a sampled model's consensus and planted lanes,
    then the MSA of the traces."""
    codes, lengths = lanes
    k = len(models)
    h, jh = models[1], jax_hmm(models[1])
    aa, jaa = h.alphabet, JAlphabet.amino()
    picks = [1, k + 1, 2 * k + 3]
    seqs = [DigitalSequence(aa, name=b"l%d" % b,
                            sequence=codes[b, : lengths[b]]) for b in picks]
    jseqs = [JSequence(jaa, name=b"l%d" % b, sequence=codes[b, : lengths[b]])
             for b in picks]
    ta, jta = tracealign.TraceAligner(), jax_tracealign.TraceAligner()
    tr, jtr = ta.compute_traces(h, seqs), jta.compute_traces(jh, jseqs)
    for t, jt in zip(tr, jtr):
        assert (t.states, t.k, t.i) == (jt.states, jt.k, jt.i)
    for digitize in (True, False):
        got = ta.align_traces(h, seqs, tr, digitize=digitize)
        want = jta.align_traces(jh, jseqs, jtr, digitize=digitize)
        assert got.alignment == want.alignment
        assert got.names == want.names
    t, jt = (mod.trace_from_sequence(x[0])
             for mod, x in ((tracealign, seqs), (jax_tracealign, jseqs)))
    assert (t.states, t.k, t.i) == (jt.states, jt.k, jt.i)


def test_iterative_search_equals_jax():
    """``Pipeline.iterate_hmm`` (``IterativeSearch`` without an engine)
    from a calibrated smoke model over a small planted block, two
    rounds."""
    h = syn.smoke_models()[2]
    targets, _ = syn.make_targets([h], 30, seed=33, median=150.0)
    got = Pipeline(h.alphabet, incE=0.001, incdomE=0.001).iterate_hmm(
        h, targets, builder=Builder(h.alphabet, architecture="hand",
                                    device="cpu"))
    want = JPipeline(JAlphabet.amino(), incE=0.001,
                     incdomE=0.001).iterate_hmm(
        jax_hmm(h), jax_block(targets),
        builder=JBuilder(JAlphabet.amino(), architecture="hand"))
    for _ in range(2):
        g, w = next(got), next(want)
        assert rows(g.hits) == rows(w.hits)
        assert (len(g.msa), g.converged, g.iteration) == \
            (len(w.msa), w.converged, w.iteration)
        np.testing.assert_array_equal(g.msa.codes, w.msa.codes)
        assert len(g.msa) >= 1
