"""NCBI BLAST database (version 4) protein volumes.

The reference reads BLAST databases through ``esl_sqio_ncbi.c``
(format listed at ``easel.pyx:158-169``); its snapshot ships no
fixture and its test suite never exercises the format, so this
implementation is built to the published formatdb/makeblastdb v4
volume layout and validated by round trip plus field-level structure
tests (``tests/test_ncbi_db.py``).

A protein volume is three files sharing a basename:

``.pin`` (index; all integers BIG-endian u32 unless noted)::

    u32   format version (4)
    u32   database type (1 = protein, 0 = nucleotide)
    u32   title length, title bytes
    u32   timestamp length, timestamp bytes
    u32   number of sequences N
    u64   total residue count   -- LITTLE-endian (the well-known v4
                                   quirk: written with the opposite
                                   byte order from every other field)
    u32   longest sequence length
    (N+1) x u32   header offsets into .phr
    (N+1) x u32   sequence offsets into .psq

``.psq``: each sequence as NCBIstdaa codes followed by one NUL byte;
sequence ``i`` occupies ``[seqoff[i], seqoff[i+1] - 1)``.

``.phr``: per-sequence ASN.1 (BER) ``Blast-def-line-set`` blobs at
``[hdroff[i], hdroff[i+1])``.  Full Seq-id parsing is out of scope;
the reader extracts the defline's leading VisibleString (tag ``0x1a``,
short- or long-form definite length) -- the ``title`` field that
carries "name description" for databases built from FASTA -- which is
what the search pipeline needs.  Nucleotide volumes (2-bit packed
``.nsq`` + ambiguity tables), alias files (``.pal``) and multi-volume
databases are not supported (documented subset).

The port's copy of ``pyhmmer_tpu/easel/ncbi.py``, line for line but the
imports.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["NCBISTDAA", "read_pin", "iter_protein_db",
           "write_protein_db"]

#: NCBIstdaa code -> residue letter (code 0 is the gap sentinel)
NCBISTDAA = "-ABCDEFGHIKLMNPQRSTVWXYZU*OJ"

_TO_STDAA = {c: i for i, c in enumerate(NCBISTDAA)}


def _basename(path) -> str:
    p = os.fspath(path)
    if p.endswith((".pin", ".phr", ".psq")):
        return p[:-4]
    return p


def read_pin(path) -> dict:
    """Parse a ``.pin`` index; returns the header fields plus the
    offset arrays."""
    base = _basename(path)
    data = open(base + ".pin", "rb").read()
    off = 0

    def u32():
        nonlocal off
        v = struct.unpack_from(">I", data, off)[0]
        off += 4
        return v

    version = u32()
    if version != 4:
        raise ValueError(f"unsupported BLAST db version {version}")
    dbtype = u32()
    if dbtype != 1:
        raise ValueError("only protein BLAST databases are supported")
    tlen = u32()
    title = data[off: off + tlen].decode("ascii", "replace")
    off += tlen
    dlen = u32()
    timestamp = data[off: off + dlen].decode("ascii", "replace")
    off += dlen
    nseq = u32()
    # the v4 quirk: the 8-byte residue total is little-endian
    total_res = struct.unpack_from("<Q", data, off)[0]
    off += 8
    maxlen = u32()
    hdr_off = np.frombuffer(data, ">u4", nseq + 1, off)
    off += 4 * (nseq + 1)
    seq_off = np.frombuffer(data, ">u4", nseq + 1, off)
    return dict(version=version, dbtype=dbtype, title=title,
                timestamp=timestamp, nseq=nseq, total_res=total_res,
                maxlen=maxlen, hdr_off=hdr_off, seq_off=seq_off)


def _first_visible_string(blob: bytes) -> Optional[bytes]:
    """The leading VisibleString of a BER ``Blast-def-line-set`` blob
    (the defline title).  Scans for tag 0x1a with a definite length."""
    i = 0
    n = len(blob)
    while i < n - 1:
        if blob[i] == 0x1A:
            j = i + 1
            ln = blob[j]
            j += 1
            if ln & 0x80:                       # long form
                nb = ln & 0x7F
                if nb == 0 or j + nb > n:
                    i += 1
                    continue
                ln = int.from_bytes(blob[j: j + nb], "big")
                j += nb
            if j + ln <= n:
                return blob[j: j + ln]
        i += 1
    return None


def iter_protein_db(path) -> Iterator[Tuple[bytes, bytes, str]]:
    """Yield ``(name, description, residues)`` for every sequence of a
    protein volume.  The name is the title's first word (makeblastdb's
    convention for FASTA-built databases)."""
    base = _basename(path)
    pin = read_pin(base)
    psq = open(base + ".psq", "rb").read()
    phr = open(base + ".phr", "rb").read()
    hdr_off, seq_off = pin["hdr_off"], pin["seq_off"]
    for i in range(pin["nseq"]):
        codes = psq[int(seq_off[i]): int(seq_off[i + 1]) - 1]
        seq = "".join(NCBISTDAA[c] if c < len(NCBISTDAA) else "X"
                      for c in codes)
        title = _first_visible_string(
            phr[int(hdr_off[i]): int(hdr_off[i + 1])]) or b"seq%d" % i
        name, _, desc = title.partition(b" ")
        yield name, desc, seq


def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _defline_blob(title: bytes) -> bytes:
    """Minimal BER ``Blast-def-line-set``: one defline whose [0] field
    carries the title VisibleString."""
    vstr = bytes([0x1A]) + _ber_len(len(title)) + title
    fld = bytes([0xA0]) + _ber_len(len(vstr)) + vstr      # [0] title
    dfl = bytes([0x30]) + _ber_len(len(fld)) + fld        # Blast-def-line
    return bytes([0x30]) + _ber_len(len(dfl)) + dfl       # ...-set


def write_protein_db(seqs, path, title: str = "pyhmmer_tpu database",
                     timestamp: str = "Jan 1, 2026  12:00 AM") -> int:
    """Write a single protein volume (``.pin``/``.phr``/``.psq``) for
    ``seqs`` (objects with ``name``/``description``/``sequence``, text
    or digital).  Returns the sequence count."""
    base = _basename(path)
    hdr_parts: List[bytes] = []
    seq_parts: List[bytes] = []
    maxlen = 0
    total = 0
    for s in seqs:
        txt = s.sequence
        if not isinstance(txt, str):            # digital residues
            txt = s.textize().sequence if hasattr(s, "textize") else \
                str(txt)
        codes = bytes(_TO_STDAA.get(c.upper(), _TO_STDAA["X"])
                      for c in txt)
        seq_parts.append(codes + b"\x00")
        title_b = s.name + (b" " + s.description
                            if s.description else b"")
        hdr_parts.append(_defline_blob(title_b))
        maxlen = max(maxlen, len(codes))
        total += len(codes)
    n = len(seq_parts)

    t = title.encode()
    d = timestamp.encode()
    pin = struct.pack(">II", 4, 1)
    pin += struct.pack(">I", len(t)) + t
    pin += struct.pack(">I", len(d)) + d
    pin += struct.pack(">I", n)
    pin += struct.pack("<Q", total)             # the v4 LE quirk
    pin += struct.pack(">I", maxlen)
    hoff = np.zeros(n + 1, dtype=">u4")
    soff = np.zeros(n + 1, dtype=">u4")
    for i in range(n):
        hoff[i + 1] = hoff[i] + len(hdr_parts[i])
        soff[i + 1] = soff[i] + len(seq_parts[i])
    pin += hoff.tobytes() + soff.tobytes()
    with open(base + ".pin", "wb") as fh:
        fh.write(pin)
    with open(base + ".phr", "wb") as fh:
        fh.write(b"".join(hdr_parts))
    with open(base + ".psq", "wb") as fh:
        fh.write(b"".join(seq_parts))
    return n
