"""SSI sequence/subsequence indexes (``.ssi`` / ``.h3i``).

The port's copy of ``pyhmmer_tpu/easel/ssi.py``: a binary-compatible
reader and writer of Easel's SSI format (the semantics of
``esl_ssi.c``), which ``hmmpress`` writes its ``.h3i`` member with.
Layout (big-endian):

header: magic u32, flags u32, offsz u8(+3 pad? -- stored as u32 here per
v3 format), nfiles u16, nprimary u64, nsecondary u64, flen u32, plen u32,
slen u32, frecsize u32, precsize u32, srecsize u32, foffset u64,
poffset u64, soffset u64.  File records then primary keys (name + fd +
roff [+ doff + L]) then secondary keys (name -> primary name).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

__all__ = ["SSIReader", "SSIWriter"]

MAGIC = 0xD3D3C9B3   # "ssi3" v3 magic (esl_ssi)
FLAG_EXTERNAL = 1 << 0
FLAG_64 = 1 << 1


class SSIReader:
    """Read an SSI index."""

    Entry = Tuple[int, int, int, int]   # fd, record offset, data offset, L

    def __init__(self, path):
        self._fh = open(os.fspath(path), "rb")
        head = self._fh.read(78)
        (magic, flags, offsz, nfiles, nprimary, nsecondary, flen, plen,
         slen, frecsize, precsize, srecsize, foffset, poffset,
         soffset) = struct.unpack(">IIIHQQIIIIIIQQQ", head)
        if magic != MAGIC:
            raise ValueError(f"bad SSI magic: {magic:#x}")
        self.nfiles = nfiles
        self.nprimary = nprimary
        self.nsecondary = nsecondary
        self._flen, self._plen, self._slen = flen, plen, slen
        self._frecsize, self._precsize, self._srecsize = (frecsize, precsize,
                                                          srecsize)
        self._foffset, self._poffset, self._soffset = (foffset, poffset,
                                                       soffset)

    def file_info(self, i: int):
        self._fh.seek(self._foffset + i * self._frecsize)
        rec = self._fh.read(self._frecsize)
        name = rec[: self._flen].rstrip(b"\x00")
        fmt, flags, bpl, rpl = struct.unpack(
            ">IIII", rec[self._flen: self._flen + 16])
        return name, fmt

    def _primary(self, i: int):
        self._fh.seek(self._poffset + i * self._precsize)
        rec = self._fh.read(self._precsize)
        name = rec[: self._plen].rstrip(b"\x00")
        fd, roff, doff, L = struct.unpack(
            ">HQQQ", rec[self._plen: self._plen + 26])
        return name, (fd, roff, doff, L)

    def find_name(self, key: bytes):
        """Binary search the primary keys; returns (fd, record offset)."""
        lo, hi = 0, self.nprimary - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            name, entry = self._primary(mid)
            if name == key:
                return entry
            if name < key:
                lo = mid + 1
            else:
                hi = mid - 1
        raise KeyError(key)

    def primary_keys(self):
        for i in range(self.nprimary):
            yield self._primary(i)[0]

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SSIWriter:
    """Write an SSI index."""

    def __init__(self, path):
        self._path = os.fspath(path)
        self._files: List[Tuple[bytes, int]] = []
        self._primary: List[Tuple[bytes, int, int, int, int]] = []
        self._secondary: List[Tuple[bytes, bytes]] = []
        self._closed = False

    def add_file(self, name, format: int = 0) -> int:
        nm = name.encode() if isinstance(name, str) else bytes(name)
        self._files.append((nm, format))
        return len(self._files) - 1

    def add_key(self, key: bytes, fd: int, record_offset: int,
                data_offset: int = 0, record_length: int = 0):
        self._primary.append((bytes(key), fd, record_offset, data_offset,
                              record_length))

    def add_alias(self, alias: bytes, key: bytes):
        self._secondary.append((bytes(alias), bytes(key)))

    def close(self):
        if self._closed:
            return
        self._primary.sort(key=lambda t: t[0])
        self._secondary.sort(key=lambda t: t[0])
        flen = max([len(n) for n, _ in self._files] + [1]) + 1
        plen = max([len(k[0]) for k in self._primary] + [1]) + 1
        slen = max([len(a) for a, _ in self._secondary] + [plen - 1]) + 1
        frecsize = flen + 16
        precsize = plen + 26
        srecsize = slen + plen
        foffset = 78
        poffset = foffset + frecsize * len(self._files)
        soffset = poffset + precsize * len(self._primary)
        with open(self._path, "wb") as fh:
            fh.write(struct.pack(
                ">IIIHQQIIIIIIQQQ", MAGIC, FLAG_64, 8, len(self._files),
                len(self._primary), len(self._secondary), flen, plen, slen,
                frecsize, precsize, srecsize, foffset, poffset, soffset))
            for name, fmt in self._files:
                fh.write(name.ljust(flen, b"\x00"))
                fh.write(struct.pack(">IIII", fmt, 0, 0, 0))
            for key, fd, roff, doff, L in self._primary:
                fh.write(key.ljust(plen, b"\x00"))
                fh.write(struct.pack(">HQQQ", fd, roff, doff, L))
            for alias, key in self._secondary:
                fh.write(alias.ljust(slen, b"\x00"))
                fh.write(key.ljust(plen, b"\x00"))
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
