"""The port's file formats and host containers against the JAX package's,
on the CPU: MSA files in the 10 formats (``easel/msafile.py``,
``MSA.write``), genetic codes (``easel/gencode.py`` and the two
``translate`` methods), BLAST v4 protein volumes (``easel/ncbi.py``),
MSA formats and BLAST volumes read through ``SequenceFile``, hit tables
(``plan7/output.py``, ``TopHits.write``, nhmmer's long-target table
too), and the key hash, vectors and matrices (``easel/containers.py``).
Every fixture is built here from seeded ``_synthetic.py`` models and
targets; what either package writes must be the same bytes."""

import io
import pickle
import struct

import numpy as np
import pytest
import torch

from pyhmmer_tpu import hmmer as jax_hmmer
from pyhmmer_tpu.easel import ncbi as jax_ncbi
from pyhmmer_tpu.easel.alphabet import Alphabet as JAlphabet
from pyhmmer_tpu.easel.gencode import GeneticCode as JGeneticCode
from pyhmmer_tpu.easel.msa import TextMSA as JTextMSA
from pyhmmer_tpu.easel.msafile import MSAFile as JMSAFile
from pyhmmer_tpu.easel.seqfile import SequenceFile as JSequenceFile
from pyhmmer_tpu.easel.sequence import TextSequence as JTextSequence
from pyhmmer_tpu.plan7.background import Background as JBackground
from pyhmmer_tpu.plan7.builder import Builder as JBuilder
import pyhmmer_tpu_torch
from pyhmmer_tpu_torch import _synthetic as syn
from pyhmmer_tpu_torch.easel import (Alphabet, DigitalSequence,
                                     DigitalSequenceBlock, GeneticCode,
                                     KeyHash, MatrixD, MatrixF, MatrixI,
                                     MatrixU8, MSAFile, SequenceFile,
                                     SSIWriter, TextMSA, TextSequence,
                                     VectorD, VectorF, VectorI, VectorU8,
                                     ncbi)
from pyhmmer_tpu_torch.easel.gencode import _NCBI_TABLES
from pyhmmer_tpu_torch.plan7 import Background, Builder
from test_torch_builder import assert_same_model
from test_torch_host import jax_block, jax_hmm, rows

torch.set_num_threads(1)

ALL_FORMATS = ["stockholm", "pfam", "afa", "a2m", "psiblast", "clustal",
               "clustallike", "selex", "phylip", "phylips"]


@pytest.fixture(scope="module")
def search_case():
    """Three of the 16 smoke models (their stored evparams) and 150
    seeded targets with domains of them planted; the JAX package's
    copies."""
    models = syn.smoke_models()[:3]
    block, planted = syn.make_targets(models, 150, seed=61, median=200.0,
                                      sigma=0.4)
    return (models, block, [jax_hmm(h) for h in models], jax_block(block),
            planted)


def toy_msa(cls):
    m = cls(name=b"toy")
    m.names = [b"seq1", b"seq2", b"seq3"]
    m.rows = ["ACDE.F-H", "ACDEgFGH", "-CDE.FGH"]
    m.reference = b"xxxx.xxx"
    return m


@pytest.fixture(scope="module")
def alignments(search_case):
    """``{kind: (the port's MSA, the JAX package's)}``: a toy alignment
    with inserts and an RF line, and the planted targets of the first
    model aligned to it by each package's ``hmmalign``."""
    models, block, jmodels, jblock, planted = search_case
    names = planted[models[0].name]
    seqs = [s for s in block if s.name in names]
    jseqs = [s for s in jblock if s.name in names]
    return {
        "toy": (toy_msa(TextMSA), toy_msa(JTextMSA)),
        "hmmalign": (pyhmmer_tpu_torch.hmmalign(models[0], seqs),
                     jax_hmmer.hmmalign(jmodels[0], jseqs)),
    }


def written(msa, fmt):
    buf = io.BytesIO()
    msa.write(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["toy", "hmmalign"])
@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_msa_write_reparse_equals_jax(alignments, kind, fmt):
    """``tests/test_msa_formats.py``'s round trip on the port: the bytes
    written equal the JAX package's, and ``MSAFile`` reads back the
    names and every row's residues (and the columns, but in A2M)."""
    msa, jmsa = alignments[kind]
    data = written(msa, fmt)
    assert data == written(jmsa, fmt)
    with MSAFile(io.BytesIO(data), format=fmt) as f:
        back = f.read()
    with JMSAFile(io.BytesIO(data), format=fmt) as f:
        jback = f.read()
    assert back.names == jback.names == list(msa.names)
    assert back.rows == jback.rows
    for orig, rt in zip(msa.rows, back.rows):
        assert [c.upper() for c in orig if c.isalpha()] == \
            [c.upper() for c in rt if c.isalpha()]
    if fmt != "a2m":
        assert all(len(r) == len(msa.rows[0]) for r in back.rows)


@pytest.mark.parametrize("text, fmt, want", [
    (">one\nAC-wyFG\n>two\nACWklFG\n", "a2m",
     (b"xxx..xx", ["AC-wyFG", "ACWklFG"])),
    (">one\nACGwTT\n>two\nACGTT\n", "a2m", (b"xxx.xx", ["ACGwTT", "ACG.TT"])),
    ("one  ACDE\ntwo  AC-E\n\none  FGH-\ntwo  FGHH\n", "psiblast",
     (None, ["ACDEFGH-", "AC-EFGHH"])),
    (" 3 12\nseqA       ACGTAC\nseqB       ACGTTC\nseqC       AC--AC\n\n"
     "GTACGT\nGTACGA\nGTAC-T\n", "phylip",
     (None, ["ACGTACGTACGT", "ACGTTCGTACGA", "AC--ACGTAC-T"])),
    ("% a comment\nseq1 ACDE.F\nseq2 ACD-EF\n\nseq1 GHIK\nseq2 GH-K\n",
     "selex", (None, ["ACDE.FGHIK", "ACD-EFGH-K"])),
], ids=["a2m-inserts", "a2m-justify", "psiblast", "phylip", "selex"])
def test_msa_parsers_equal_jax(text, fmt, want):
    with MSAFile(io.BytesIO(text.encode()), format=fmt) as f:
        m = f.read()
    with JMSAFile(io.BytesIO(text.encode()), format=fmt) as f:
        jm = f.read()
    assert (m.names, m.rows, m.reference) == (jm.names, jm.rows,
                                              jm.reference)
    reference, want_rows = want
    assert m.rows == want_rows
    if reference is not None:
        assert m.reference == reference


def test_msa_a2m_mismatch_and_digital_round_trip(alignments):
    bad = b">one\nAC-deFG\n>two\nACWDEFG\n"
    with pytest.raises(ValueError):
        with MSAFile(io.BytesIO(bad), format="a2m") as f:
            f.read()
    aa = Alphabet.amino()
    d = alignments["hmmalign"][0].digitize(aa)
    buf = io.BytesIO(written(d, "a2m"))
    with MSAFile(buf, format="a2m", digital=True, alphabet=aa) as f:
        back = f.read()
    np.testing.assert_array_equal(back.codes, d.codes)


def test_msafile_ssi_fetch(alignments, tmp_path):
    """``MSAFile.fetch`` through an SSI index that the port's
    ``SSIWriter`` wrote: the second of two alignments, by name."""
    first, second = alignments["toy"][0], toy_msa(TextMSA)
    second.name = b"aligned"
    second.names = [b"other1", b"other2", b"other3"]
    a, b = written(first, "stockholm"), written(second, "stockholm")
    path = tmp_path / "two.sto"
    path.write_bytes(a + b)
    with SSIWriter(str(path) + ".ssi") as w:
        fd = w.add_file(str(path))
        w.add_key(b"toy", fd, 0)
        w.add_key(b"aligned", fd, len(a))
    with MSAFile(str(path)) as f:
        got = f.fetch(b"aligned")
        with pytest.raises(KeyError):
            f.fetch(b"nonexistent")
    with JMSAFile(str(path)) as f:
        want = f.fetch(b"aligned")
    assert got.names == want.names == second.names
    assert got.rows == want.rows


def test_jackhmmer_msa_stockholm_round_trip(search_case, tmp_path):
    """``chip_smoke.py``'s phase ``formats`` (c) on the CPU: the last
    jackhmmer round's hits' MSA, written in Stockholm by each package
    (the same bytes), reads back with ``MSAFile`` (digital) unchanged and
    builds the model that the in-memory MSA builds, and the JAX
    package's ``Builder``'s."""
    models, block, _, jblock, planted = search_case
    name = sorted(planted[models[0].name])[0]
    got = next(pyhmmer_tpu_torch.jackhmmer(
        next(s for s in block if s.name == name), block, device="cpu",
        max_iterations=2, checkpoints=True))[-1]
    want = next(jax_hmmer.jackhmmer(
        next(s for s in jblock if s.name == name), jblock,
        max_iterations=2, checkpoints=True))[-1]
    aa = block.alphabet
    msa = got.hits.to_msa(aa, all_consensus_cols=True, digitize=True)
    jmsa = want.hits.to_msa(JAlphabet.amino(), all_consensus_cols=True,
                            digitize=True)
    msa.name = jmsa.name = name
    data = written(msa, "stockholm")
    assert data == written(jmsa, "stockholm") and len(msa) >= 2
    path = tmp_path / "round.sto"
    path.write_bytes(data)
    with MSAFile(str(path), format="stockholm", digital=True,
                 alphabet=aa) as f:
        back = f.read()
    assert back.names == msa.names
    np.testing.assert_array_equal(back.codes, msa.codes)
    bg = Background(aa)
    h_mem = Builder(aa, device="cpu").build_msa(msa, bg)[0]
    h_file = Builder(aa, device="cpu").build_msa(back, bg)[0]
    h_jax = JBuilder(jmsa.alphabet).build_msa(
        jmsa, JBackground(jmsa.alphabet))[0]
    for field in ("t", "mat", "ins", "evparam"):
        np.testing.assert_array_equal(np.asarray(getattr(h_mem, field)),
                                      np.asarray(getattr(h_file, field)))
    assert_same_model(h_file, h_jax)


@pytest.mark.parametrize("fmt", ["stockholm", "a2m"])
def test_sequencefile_reads_msa_formats(alignments, fmt, tmp_path):
    """``SequenceFile`` over an MSA file gives each row's residues,
    unaligned, as the JAX package's reads them."""
    msa = alignments["hmmalign"][0]
    path = tmp_path / ("aligned." + fmt)
    path.write_bytes(written(msa, fmt))
    aa = Alphabet.amino()
    with SequenceFile(str(path), format=fmt, digital=True,
                      alphabet=aa) as f:
        got = f.read_block()
    with JSequenceFile(str(path), format=fmt, digital=True,
                       alphabet=JAlphabet.amino()) as f:
        want = f.read_block()
    assert [s.name for s in got] == [s.name for s in want] == msa.names
    for g, w, row in zip(got, want, msa.rows):
        np.testing.assert_array_equal(g.sequence, w.sequence)
        np.testing.assert_array_equal(
            g.sequence, aa.encode("".join(c for c in row
                                          if c.isalpha()).upper()))


# --- genetic codes ----------------------------------------------------------

@pytest.mark.parametrize("table", sorted(_NCBI_TABLES))
def test_translation_equals_jax(table):
    """Every NCBI table over seeded DNA codons, a quarter of them with a
    degenerate or gap base: ``GeneticCode.translate`` and the sequence
    and block ``translate`` methods against the JAX package's."""
    rng = np.random.default_rng(100 + table)
    dna, jdna = Alphabet.dna(), JAlphabet.dna()
    gc, jgc = GeneticCode(table), JGeneticCode(table)
    assert (gc.description, repr(gc)) == (jgc.description, repr(jgc))
    seqs = []
    for k in range(6):
        codes = rng.integers(0, 4, size=3 * int(rng.integers(1, 200)))
        odd = rng.random(len(codes)) < 0.08
        codes[odd] = rng.integers(4, dna.Kp, size=int(odd.sum()))
        seqs.append(codes.astype(np.uint8))
    for codes in seqs:
        np.testing.assert_array_equal(gc.translate(codes),
                                      jgc.translate(codes))
    block = DigitalSequenceBlock(dna, [
        DigitalSequence(dna, name=b"orf%d" % i, description=b"d", sequence=c)
        for i, c in enumerate(seqs)])
    jblock = jax_block(block)
    got, want = block.translate(gc), jblock.translate(jgc)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w, s, js in zip(got, want, block, jblock):
        np.testing.assert_array_equal(g.sequence, w.sequence)
        one = s.translate(gc)
        np.testing.assert_array_equal(one.sequence,
                                      js.translate(jgc).sequence)
        assert (one.name, one.description) == (s.name, s.description)
        assert one.alphabet == Alphabet.amino()


def test_translation_errors():
    with pytest.raises(ValueError):
        GeneticCode(7)
    with pytest.raises(ValueError):
        GeneticCode().translate(np.zeros(4, dtype=np.uint8))
    stop = TextSequence(sequence="TGA").digitize(Alphabet.dna())
    assert GeneticCode(1).translate(stop.sequence)[0] == \
        Alphabet.amino().unknown_code
    assert Alphabet.amino().decode(
        GeneticCode(2).translate(stop.sequence)[:1]) == "W"


# --- BLAST volumes ----------------------------------------------------------

@pytest.fixture(scope="module")
def volume_seqs(search_case):
    """The first 60 targets as text, a description on every other one:
    the port's and the JAX package's."""
    block = search_case[1]
    port, jax = [], []
    for i, s in enumerate(list(block)[:60]):
        desc = b"seeded target %d" % i if i % 2 else b""
        text = block.alphabet.decode(s.sequence)
        port.append(TextSequence(name=s.name, description=desc,
                                 sequence=text))
        jax.append(JTextSequence(name=s.name, description=desc,
                                 sequence=text))
    return port, jax


def test_blast_volume_equals_jax(volume_seqs, search_case, tmp_path):
    """A volume the port writes is the JAX package's bytes; each package
    reads the other's; ``SequenceFile(format="ncbi")`` gives the block's
    sequences, text and digital."""
    seqs, jseqs = volume_seqs
    block = search_case[1]
    base, jbase = tmp_path / "port", tmp_path / "jax"
    assert ncbi.write_protein_db(seqs, base) == len(seqs)
    assert jax_ncbi.write_protein_db(jseqs, jbase) == len(seqs)
    for ext in (".pin", ".phr", ".psq"):
        assert (open(str(base) + ext, "rb").read()
                == open(str(jbase) + ext, "rb").read()), ext
    pin = ncbi.read_pin(base)
    assert {k: pin[k] for k in ("nseq", "total_res", "maxlen")} == {
        "nseq": len(seqs), "total_res": sum(len(s.sequence) for s in seqs),
        "maxlen": max(len(s.sequence) for s in seqs)}
    assert struct.unpack_from(">II", open(str(base) + ".pin", "rb").read(),
                              0) == (4, 1)
    want = [(s.name, s.description or b"", s.sequence) for s in seqs]
    assert list(ncbi.iter_protein_db(jbase)) == want
    assert list(jax_ncbi.iter_protein_db(base)) == want
    with SequenceFile(str(base) + ".pin", format="ncbi") as f:
        assert [(s.name, s.sequence) for s in f] == \
            [(s.name, s.sequence) for s in seqs]
    with SequenceFile(base, format="ncbi", digital=True,
                      alphabet=block.alphabet) as f:
        got = f.read_block()
    assert len(got) == len(seqs)
    for g, s in zip(got, block):
        assert g.name == s.name
        np.testing.assert_array_equal(g.sequence, s.sequence)


def test_blast_volume_rejects_what_it_cannot_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        SequenceFile(tmp_path / "absent", format="ncbi")
    bad = tmp_path / "x"
    for version, dbtype in ((4, 0), (5, 1)):    # nucleotide; version
        with open(str(bad) + ".pin", "wb") as fh:
            fh.write(struct.pack(">II", version, dbtype))
        with pytest.raises(ValueError):
            ncbi.read_pin(bad)


def test_search_over_blast_volume(search_case, tmp_path):
    """The port's ``hmmsearch`` over a BLAST volume of the digital block,
    streamed in blocks, reports what it reports over the block."""
    models, block = search_case[:2]
    base = tmp_path / "targets"
    ncbi.write_protein_db(block, base)
    with SequenceFile(base, format="ncbi", digital=True,
                      alphabet=block.alphabet) as f:
        got = list(pyhmmer_tpu_torch.hmmsearch(models, f, device="cpu",
                                               block_residues=12_000))
    want = pyhmmer_tpu_torch.hmmsearch(models, block, device="cpu")
    assert [(rows(th), th.Z) for th in got] == \
        [(rows(th), th.Z) for th in want]


# --- hit tables -------------------------------------------------------------

def tables(results, fmt):
    out = []
    for th in results:
        buf = io.StringIO()
        th.write(buf, format=fmt)
        out.append(buf.getvalue())
    return out


@pytest.fixture(scope="module")
def searched(search_case):
    models, block, jmodels, jblock, _ = search_case
    return (list(pyhmmer_tpu_torch.hmmsearch(models, block, device="cpu")),
            list(jax_hmmer.hmmsearch(jmodels, jblock)))


@pytest.mark.parametrize("fmt", ["targets", "domains", "pfam"])
def test_hit_tables_equal_jax(searched, fmt):
    got, want = searched
    assert tables(got, fmt) == tables(want, fmt)
    for th, table in zip(got, tables(got, fmt)):
        assert th.reported
        assert all(h.name.decode() in table for h in th.reported)
    with pytest.raises(ValueError):
        got[0].write(io.StringIO(), format="nope")


@pytest.fixture(scope="module")
def long_searched():
    """nhmmer of a sampled DNA model (calibrated on the plain versions)
    over a seeded 40 kb record with its copies planted on both strands,
    by each package."""
    model = syn.sample_dna_models((150,), seed=63)[0]
    Builder(model.alphabet, device="cpu").calibrate(
        model, Background(model.alphabet))
    genome, _ = syn.make_genome([model], 1, 40_000, 3, seed=64, gap=5_000)
    return (list(pyhmmer_tpu_torch.nhmmer(model, genome, device="cpu")),
            list(jax_hmmer.nhmmer(jax_hmm(model), jax_block(genome))))


@pytest.mark.parametrize("fmt", ["targets", "domains", "pfam"])
def test_long_target_tables_equal_jax(long_searched, fmt):
    got, want = long_searched
    assert got[0].long_targets and got[0].reported
    assert tables(got, fmt) == tables(want, fmt)


# --- containers (``tests/test_easel_extras.py``'s cases on the port) --------

def test_keyhash():
    kh = KeyHash()
    assert kh.add(b"first") == 0
    assert kh.add(b"second") == 1
    assert kh.add(b"first") == 0
    assert kh[b"second"] == 1
    assert b"first" in kh and b"third" not in kh
    assert list(kh) == [b"first", b"second"]
    kh2 = kh.copy()
    kh.clear()
    assert len(kh) == 0 and len(kh2) == 2


def test_vector_ops():
    v = VectorD([1.0, 2.0, 3.0])
    assert v.sum() == 6.0
    assert v.argmax() == 2
    assert (v + v)[1] == 4.0
    assert (v * 2)[0] == 2.0
    assert v @ v == 14.0
    v.reverse()
    assert list(v) == [3.0, 2.0, 1.0]
    w = VectorD([1.0, 1.0, 1.0, 1.0])
    w.normalize()
    assert abs(w.sum() - 1.0) < 1e-12
    assert abs(w.entropy() - 2.0) < 1e-12
    assert abs(w.relative_entropy(VectorD([.25, .25, .25, .25]))) < 1e-12
    a = np.asarray(VectorD([1.0, 2.0]))
    assert a.dtype == np.float64 and a[1] == 2.0


@pytest.mark.parametrize("cls, dtype", [
    (VectorD, np.float64), (VectorF, np.float32), (VectorI, np.int32),
    (VectorU8, np.uint8)])
def test_vector_types(cls, dtype):
    v = cls([1, 2, 120])
    assert np.asarray(v).dtype == dtype
    assert v.itemsize == np.dtype(dtype).itemsize
    assert v.max() == 120 and len(v) == 3
    assert list(cls.zeros(4)) == [0, 0, 0, 0]
    assert list(pickle.loads(pickle.dumps(v))) == list(v)


@pytest.mark.parametrize("cls, dtype", [
    (MatrixD, np.float64), (MatrixF, np.float32), (MatrixI, np.int32),
    (MatrixU8, np.uint8)])
def test_matrix_types(cls, dtype):
    m = cls([[1, 2], [3, 4]])
    assert np.asarray(m).dtype == dtype
    assert m.shape == (2, 2)
    assert m[1, 1] == 4
    assert m.argmax() == (1, 1)
    assert list(m[0]) == [1, 2]
    assert m.sum() == 10
    assert cls.zeros(2, 3).shape == (2, 3)
    with pytest.raises(ValueError):
        cls([[1], [2, 3]])


def test_param_vector_as_vector(search_case):
    """``_ParamVector.as_vector`` of a model's E-value parameters and
    cut-offs against the JAX package's."""
    h, jh = search_case[0][0], search_case[2][0]
    for got, want in ((h.evparam, jh.evparam), (h.cutoffs, jh.cutoffs)):
        v, w = got.as_vector(), want.as_vector()
        assert isinstance(v, VectorF)
        np.testing.assert_array_equal(np.asarray(v), np.asarray(w))
