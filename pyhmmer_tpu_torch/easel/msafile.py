"""MSA file parsing/writing: Stockholm/Pfam, aligned FASTA, A2M, Clustal,
PSI-BLAST, Selex, Phylip.

Mirrors ``pyhmmer.easel.MSAFile`` (reference ``src/pyhmmer/easel.pyx:
6513-6957``; formats listed at ``easel.pyx:141-152``).

The port's copy of ``pyhmmer_tpu/easel/msafile.py``, line for line but
the imports; its SSI ``fetch`` reads through the port's ``ssi.py``.
"""

from __future__ import annotations

import io
import os
from typing import Iterator, List, Optional, Union

from .alphabet import Alphabet
from .msa import MSA, TextMSA, DigitalMSA
from .seqfile import guess_alphabet_text

__all__ = ["MSAFile", "write_stockholm", "write_afa", "write_a2m",
           "write_psiblast", "write_clustal", "write_selex",
           "write_phylip"]


def _parse_stockholm(text: str) -> Iterator[TextMSA]:
    name = None
    rows: dict = {}
    order: List[str] = []
    gc: dict = {}
    gf: dict = {}
    gs_weights: dict = {}
    started = False
    for line in text.splitlines():
        if line.startswith("# STOCKHOLM"):
            if started and order:
                yield _finish_sto(order, rows, gc, gf, gs_weights)
                rows, order, gc, gf, gs_weights = {}, [], {}, {}, {}
            started = True
        elif line.strip() == "//":
            if order:
                yield _finish_sto(order, rows, gc, gf, gs_weights)
            rows, order, gc, gf, gs_weights = {}, [], {}, {}, {}
        elif line.startswith("#=GC "):
            parts = line.split(None, 2)
            if len(parts) == 3:
                gc[parts[1]] = gc.get(parts[1], "") + parts[2].strip()
        elif line.startswith("#=GF "):
            parts = line.split(None, 2)
            if len(parts) == 3:
                gf.setdefault(parts[1], parts[2].strip())
        elif line.startswith("#=GS "):
            parts = line.split()
            if len(parts) >= 4 and parts[2] == "WT":
                gs_weights[parts[1]] = float(parts[3])
        elif line.startswith("#"):
            continue
        elif line.strip():
            parts = line.split(None, 1)
            if len(parts) == 2:
                nm, seq = parts
                if nm not in rows:
                    order.append(nm)
                    rows[nm] = ""
                rows[nm] += "".join(seq.split())
    if order:
        yield _finish_sto(order, rows, gc, gf, gs_weights)


def _finish_sto(order, rows, gc, gf, gs_weights) -> TextMSA:
    msa = TextMSA()
    msa.names = [n.encode() for n in order]
    msa.rows = [rows[n] for n in order]
    if "ID" in gf:
        msa.name = gf["ID"].encode()
    if "AC" in gf:
        msa.accession = gf["AC"].encode()
    if "DE" in gf:
        msa.description = gf["DE"].encode()
    if "AU" in gf:
        msa.author = gf["AU"].encode()
    if "RF" in gc:
        msa.reference = gc["RF"].encode()
    if "SS_cons" in gc:
        msa.consensus_structure = gc["SS_cons"].encode()
    if "MM" in gc:
        msa.model_mask = gc["MM"].encode()
    if gs_weights:
        import numpy as np
        msa.weights = np.array([gs_weights.get(n, 1.0) for n in order])
    return msa


def _parse_afa(text: str) -> Iterator[TextMSA]:
    from .seqfile import _parse_fasta
    seqs = list(_parse_fasta(text))
    if seqs:
        msa = TextMSA(sequences=seqs)
        yield msa


def _parse_a2m(text: str) -> Iterator[TextMSA]:
    """A2M (``esl_msafile_a2m``): FASTA-like dotless alignment where
    UPPERCASE/'-' are consensus (match) columns and lowercase are
    insertions relative to the consensus.  Every sequence must imply the
    same number of consensus columns; insertions are re-aligned by
    left-justifying each inter-consensus segment and padding with '.'.
    The reconstructed match/insert structure is recorded as an RF line
    ('x' = consensus)."""
    from .seqfile import _parse_fasta
    seqs = list(_parse_fasta(text))
    if not seqs:
        return
    ncols = None
    per_seq = []        # (name, match[ncols], inserts[ncols+1])
    for s in seqs:
        match: List[str] = []
        inserts: List[str] = [""]
        for c in s.sequence:
            if c == ".":
                continue
            if c == "-" or c.isupper():
                match.append(c)
                inserts.append("")
            elif c.islower():
                inserts[-1] += c
        if ncols is None:
            ncols = len(match)
        elif len(match) != ncols:
            raise ValueError(
                f"a2m: sequence {s.name!r} implies {len(match)} consensus "
                f"columns, expected {ncols}")
        per_seq.append((s.name, match, inserts))
    maxins = [max(len(p[2][i]) for p in per_seq)
              for i in range(ncols + 1)]
    rows = []
    for name, match, inserts in per_seq:
        out = []
        for i in range(ncols + 1):
            seg = inserts[i]
            out.append(seg + "." * (maxins[i] - len(seg)))
            if i < ncols:
                out.append(match[i])
        rows.append("".join(out))
    msa = TextMSA()
    msa.names = [p[0] for p in per_seq]
    msa.rows = rows
    rf = []
    for i in range(ncols + 1):
        rf.append("." * maxins[i])
        if i < ncols:
            rf.append("x")
    msa.reference = "".join(rf).encode()
    yield msa


def _parse_psiblast(text: str) -> Iterator[TextMSA]:
    """PSI-BLAST (``esl_msafile_psiblast``): interleaved blocks of
    ``name  alignedseq`` lines with '-' for gaps; no headers, no
    coordinate columns, sequences in the same order per block."""
    rows: dict = {}
    order: List[str] = []
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        nm, seg = parts[0], "".join(parts[1:])
        if not all(c.isalpha() or c in "-." for c in seg):
            continue
        if nm not in rows:
            order.append(nm)
            rows[nm] = ""
        rows[nm] += seg
    if order:
        msa = TextMSA()
        msa.names = [n.encode() for n in order]
        msa.rows = [rows[n] for n in order]
        yield msa


def _parse_clustal(text: str) -> Iterator[TextMSA]:
    rows: dict = {}
    order: List[str] = []
    for line in text.splitlines():
        s = line.strip()
        if (not s or s.startswith("CLUSTAL") or s.startswith("MUSCLE")
                or "multiple sequence alignment" in s
                or set(s) <= set(" .:*")):
            continue
        parts = line.split()
        if len(parts) >= 2:
            nm = parts[0]
            if nm not in rows:
                order.append(nm)
                rows[nm] = ""
            rows[nm] += parts[1]
    if order:
        msa = TextMSA()
        msa.names = [n.encode() for n in order]
        msa.rows = [rows[n] for n in order]
        yield msa


def _parse_phylip(text: str) -> Iterator[TextMSA]:
    """PHYLIP interleaved ("phylip") and sequential ("phylips"): a
    ``nseq alen`` header line, names in the first block, then bare
    continuation blocks (``esl_msafile_phylip`` semantics)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return
    head = lines[0].split()
    try:
        nseq, alen = int(head[0]), int(head[1])
    except (ValueError, IndexError):
        # not a phylip header: fall back to clustal-like parsing
        yield from _parse_clustal(text)
        return
    names: List[str] = []
    rows: List[str] = []
    li = 1
    # first block carries the names
    while len(names) < nseq and li < len(lines):
        ln = lines[li]
        parts = ln.split(None, 1)
        names.append(parts[0])
        rows.append("".join(parts[1].split()) if len(parts) > 1 else "")
        li += 1
    # sequential: keep filling the CURRENT shortest row; interleaved:
    # continuation blocks cycle through sequences in order
    r = 0
    while li < len(lines):
        chunk = "".join(lines[li].split())
        if len(rows[r]) >= alen:
            # find next incomplete row (covers both layouts)
            nxt = [j for j in range(nseq) if len(rows[j]) < alen]
            if not nxt:
                break
            r = nxt[0]
        rows[r] += chunk
        r = (r + 1) % nseq
        li += 1
    msa = TextMSA()
    msa.names = [n.encode() for n in names]
    msa.rows = [row[:alen] for row in rows]
    yield msa


def _parse_selex(text: str) -> Iterator[TextMSA]:
    """SELEX: ``name seq`` lines in blocks, ``#=`` annotation lines,
    ``%``/``#`` comments (``esl_msafile_selex`` semantics)."""
    rows: dict = {}
    order: List[str] = []
    rf = ""
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("#=RF"):
            rf += "".join(s.split()[1:])
            continue
        if not s or s.startswith("%") or s.startswith("#"):
            continue
        parts = line.split()
        if len(parts) >= 2:
            nm = parts[0]
            if nm not in rows:
                order.append(nm)
                rows[nm] = ""
            rows[nm] += "".join(parts[1:])
    if order:
        msa = TextMSA()
        msa.names = [n.encode() for n in order]
        msa.rows = [rows[n] for n in order]
        if rf:
            msa.reference = rf.encode()
        yield msa


class MSAFile:
    """Iterative reader over alignments in a file."""

    _PARSERS = {
        "stockholm": _parse_stockholm,
        "pfam": _parse_stockholm,
        "afa": _parse_afa,
        "a2m": _parse_a2m,
        "clustal": _parse_clustal,
        "clustallike": _parse_clustal,
        "psiblast": _parse_psiblast,
        "selex": _parse_selex,
        "phylip": _parse_phylip,
        "phylips": _parse_phylip,
    }

    def __init__(self, file: Union[str, os.PathLike, io.IOBase],
                 format: Optional[str] = None, *, digital: bool = False,
                 alphabet: Optional[Alphabet] = None):
        if isinstance(file, (str, os.PathLike)):
            with open(os.fspath(file), "r") as fh:
                self._text = fh.read()
            self.name = os.fspath(file)
        else:
            data = file.read()
            if isinstance(data, bytes):
                data = data.decode("ascii", errors="replace")
            self._text = data
            self.name = getattr(file, "name", None)
        self.format = (format or self._guess()).lower()
        if self.format not in self._PARSERS:
            raise ValueError(f"unsupported MSA format: {self.format!r}")
        self.digital = digital
        self.alphabet = alphabet
        self._iter = self._PARSERS[self.format](self._text)
        self._closed = False
        if digital and alphabet is None:
            self.alphabet = self.guess_alphabet()

    def _guess(self) -> str:
        for line in self._text.splitlines():
            s = line.strip()
            if not s:
                continue
            if s.startswith("# STOCKHOLM"):
                return "stockholm"
            if s.startswith(">"):
                return "afa"
            if s.startswith("CLUSTAL") or s.startswith("MUSCLE"):
                return "clustal"
            break
        raise ValueError("could not determine MSA file format")

    def guess_alphabet(self) -> Optional[Alphabet]:
        for parser_msa in self._PARSERS[self.format](self._text):
            for row in parser_msa.rows:
                return guess_alphabet_text(
                    "".join(c for c in row if c.isalpha()))
        return None

    def read(self):
        try:
            msa = next(self._iter)
        except StopIteration:
            return None
        if self.digital:
            return msa.digitize(self.alphabet)
        return msa

    # --- SSI-indexed random access (easel.pyx:6848 role) ------------------

    def fetch(self, key: bytes, ssi: Optional[str] = None):
        """Random access by alignment name/accession through an SSI
        index (``<file>.ssi`` by default, like ``esl_msafile`` with an
        open SSI): seeks to the indexed record offset and parses one
        MSA there.  Requires a path-backed reader."""
        from .ssi import SSIReader

        if self.name is None:
            raise ValueError("fetch() needs a path-backed MSAFile")
        if isinstance(key, str):
            key = key.encode()
        path = ssi or (self.name + ".ssi")
        with SSIReader(path) as rd:
            fd, roff, doff, L = rd.find_name(key)
        sub = self._text[roff:]
        for msa in self._PARSERS[self.format](sub):
            if self.digital:
                return msa.digitize(self.alphabet)
            return msa
        raise ValueError(f"no alignment found at SSI offset {roff}")

    def __iter__(self):
        return self

    def __next__(self):
        msa = self.read()
        if msa is None:
            raise StopIteration
        return msa

    def close(self):
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def write_stockholm(msa, fh) -> None:
    text = msa.textize() if isinstance(msa, DigitalMSA) else msa
    w = fh.write
    w("# STOCKHOLM 1.0\n")
    if text.name:
        w(f"#=GF ID {text.name.decode()}\n")
    if text.accession:
        w(f"#=GF AC {text.accession.decode()}\n")
    namew = max((len(n) for n in text.names), default=10)
    namew = max(namew, len("#=GC SS_cons"))
    for n, row in zip(text.names, text.rows):
        w(f"{n.decode():<{namew}s} {row}\n")
    if text.reference:
        w(f"{'#=GC RF':<{namew}s} {text.reference.decode()}\n")
    if text.consensus_structure:
        w(f"{'#=GC SS_cons':<{namew}s} {text.consensus_structure.decode()}\n")
    w("//\n")


def write_afa(msa, fh) -> None:
    text = msa.textize() if isinstance(msa, DigitalMSA) else msa
    for n, row in zip(text.names, text.rows):
        fh.write(f">{n.decode()}\n")
        for i in range(0, len(row), 60):
            fh.write(row[i:i + 60] + "\n")


def write_a2m(msa, fh) -> None:
    """A2M: uppercase/'-' in consensus columns, lowercase elsewhere,
    insert gaps dropped.  Consensus columns come from the RF line when
    present, otherwise every column is consensus."""
    text = msa.textize() if isinstance(msa, DigitalMSA) else msa
    alen = len(text.rows[0]) if text.rows else 0
    if text.reference and len(text.reference) == alen:
        is_cons = [chr(c) not in ".-~ " for c in text.reference]
    else:
        is_cons = [True] * alen
    for n, row in zip(text.names, text.rows):
        out = []
        for c, cons in zip(row, is_cons):
            if cons:
                out.append("-" if c in ".-~" else c.upper())
            elif c not in ".-~":
                out.append(c.lower())
        fh.write(f">{n.decode()}\n")
        s = "".join(out)
        for i in range(0, len(s), 60):
            fh.write(s[i:i + 60] + "\n")


def write_psiblast(msa, fh, width: int = 60) -> None:
    text = msa.textize() if isinstance(msa, DigitalMSA) else msa
    namew = max((len(n) for n in text.names), default=10)
    alen = len(text.rows[0]) if text.rows else 0
    for off in range(0, alen, width):
        for n, row in zip(text.names, text.rows):
            seg = row[off: off + width].replace(".", "-")
            fh.write(f"{n.decode():<{namew}s} {seg}\n")
        if off + width < alen:
            fh.write("\n")


def write_clustal(msa, fh, width: int = 60, like: bool = False) -> None:
    text = msa.textize() if isinstance(msa, DigitalMSA) else msa
    fh.write("Generated CLUSTAL-like multiple sequence alignment\n\n"
             if like else
             "CLUSTAL W (pyhmmer-tpu) multiple sequence alignment\n\n")
    namew = max((len(n) for n in text.names), default=10)
    alen = len(text.rows[0]) if text.rows else 0
    for off in range(0, alen, width):
        for n, row in zip(text.names, text.rows):
            seg = row[off: off + width].replace(".", "-")
            fh.write(f"{n.decode():<{namew}s} {seg}\n")
        fh.write("\n")


def write_selex(msa, fh) -> None:
    text = msa.textize() if isinstance(msa, DigitalMSA) else msa
    namew = max((len(n) for n in text.names), default=10)
    if text.reference:
        fh.write(f"{'#=RF':<{namew}s} {text.reference.decode()}\n")
    for n, row in zip(text.names, text.rows):
        fh.write(f"{n.decode():<{namew}s} {row}\n")


def write_phylip(msa, fh, sequential: bool = False,
                 width: int = 60) -> None:
    text = msa.textize() if isinstance(msa, DigitalMSA) else msa
    nseq = len(text.names)
    alen = len(text.rows[0]) if text.rows else 0
    fh.write(f" {nseq} {alen}\n")
    namew = max(10, max((len(n) for n in text.names), default=10))
    if sequential:
        for n, row in zip(text.names, text.rows):
            fh.write(f"{n.decode():<{namew}s} {row}\n")
    else:
        for off in range(0, alen, width):
            for si, (n, row) in enumerate(zip(text.names, text.rows)):
                label = n.decode() if off == 0 else ""
                fh.write(f"{label:<{namew}s} {row[off: off + width]}\n")
            if off + width < alen:
                fh.write("\n")
