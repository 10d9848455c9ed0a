"""Client and server for distributed profile-HMM search, and the hmmpgmd
wire codec that the multi-host runtime's hit records reuse.

The port's copy of ``pyhmmer_tpu/daemon.py``, line for line but the
imports and the :class:`Server`'s ``device``: a TCP protocol where the
client sends one option line (``@--seqdb <db> <flags>\\n`` or
``@--hmmdb <db> <flags>\\n``) followed by the serialized query terminated
by ``\\n//``, and receives a ``HMMD_SEARCH_STATUS`` header, a
``HMMD_SEARCH_STATS`` block and an array of serialized ``P7_HIT``
records, in network byte order.  The
:class:`Server` holds target databases in memory and answers searches
with the sequential :class:`~pyhmmer_tpu_torch.plan7.pipeline.Pipeline`;
client and server of this package are mutually compatible.
:mod:`pyhmmer_tpu_torch.parallel.multihost` serializes its partial hits
with :func:`_serialize_hit` and reads them back with :class:`_Reader`
and :func:`_deserialize_hit`.
"""

from __future__ import annotations

import io
import math
import socket
import socketserver
import struct
import threading
from typing import List, Optional, Tuple

from ._device import resolve_device
from .errors import ServerError
from .easel.alphabet import Alphabet
from .easel.sequence import DigitalSequenceBlock
from .plan7.hmm import HMM
from .plan7.pipeline import Pipeline
from .plan7.builder import Builder
from .plan7.results import TopHits, Hit, Domain, Alignment, F_INCLUDED, F_REPORTED
from .plan7 import iteration as _iteration

__all__ = ["Client", "Server", "IterativeSearch"]

DEFAULT_ADDRESS = "127.0.0.1"
DEFAULT_PORT = 51371

LOG2 = math.log(2.0)

#: ``HMMD_SEARCH_STATUS_SERIAL_SIZE``: uint32 status + uint64 msg_size.
SEARCH_STATUS_SIZE = 12

_NO_OFFSETS = 0xFFFFFFFFFFFFFFFF


# --- wire-format helpers ------------------------------------------------------


def _pack_cstring(s: Optional[bytes]) -> bytes:
    return b"" if s is None else bytes(s) + b"\x00"


class _Reader:
    """Cursor over a received byte buffer."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, fmt: str):
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals

    def take_cstring(self) -> bytes:
        end = self.buf.index(b"\x00", self.pos)
        out = self.buf[self.pos : end]
        self.pos = end + 1
        return out


def _serialize_status(status: int, msg_size: int) -> bytes:
    return struct.pack(">IQ", status, msg_size)


def _deserialize_status(buf: bytes) -> Tuple[int, int]:
    return struct.unpack(">IQ", buf[:SEARCH_STATUS_SIZE])


def _serialize_stats(th: TopHits, hit_blobs: List[bytes]) -> bytes:
    """Serialize a ``HMMD_SEARCH_STATS`` block (fields per hmmpgmd.pxd:18-39)."""
    setby = {"ntargets": 0, "option": 1, "fixed": 2}
    out = struct.pack(
        ">5d", 0.0, 0.0, 0.0, float(th.Z), float(th.domZ)
    )
    out += struct.pack(
        ">2B", setby.get(th.Z_setby, 0), setby.get(th.domZ_setby, 0)
    )
    nrep = sum(1 for h in th.hits if h.reported)
    ninc = sum(1 for h in th.hits if h.included)
    out += struct.pack(
        ">9Q",
        th.nmodels, th.nseqs, th.n_past_msv, th.n_past_bias,
        th.n_past_vit, th.n_past_fwd, len(hit_blobs), nrep, ninc,
    )
    if hit_blobs:
        offs = []
        total = 0
        for blob in hit_blobs:
            offs.append(total)
            total += len(blob)
        out += struct.pack(f">{len(offs)}Q", *offs)
    else:
        out += struct.pack(">Q", _NO_OFFSETS)
    return out


def _deserialize_stats(r: _Reader) -> dict:
    elapsed, user, sys_, Z, domZ = r.take(">5d")
    z_setby, domz_setby = r.take(">2B")
    (nmodels, nseqs, n_past_msv, n_past_bias, n_past_vit, n_past_fwd,
     nhits, nreported, nincluded) = r.take(">9Q")
    (first,) = r.take(">Q")
    if first == _NO_OFFSETS:
        hit_offsets = None
    else:
        rest = r.take(f">{nhits - 1}Q") if nhits > 1 else ()
        hit_offsets = (first,) + tuple(rest)
    setby = {0: "ntargets", 1: "option", 2: "fixed"}
    return dict(
        Z=Z, domZ=domZ,
        Z_setby=setby.get(z_setby, "ntargets"),
        domZ_setby=setby.get(domz_setby, "ntargets"),
        nmodels=nmodels, nseqs=nseqs,
        n_past_msv=n_past_msv, n_past_bias=n_past_bias,
        n_past_vit=n_past_vit, n_past_fwd=n_past_fwd,
        nhits=nhits, nreported=nreported, nincluded=nincluded,
        hit_offsets=hit_offsets,
    )


def _serialize_alignment(ad: Optional[Alignment]) -> bytes:
    if ad is None:
        return struct.pack(">B", 0)
    strings = [
        ad.hmm_name, ad.hmm_accession, ad.hmm_sequence,
        ad.target_name, ad.target_sequence, ad.identity_sequence,
        ad.posterior_probabilities,
    ]
    payload = b""
    present = 0
    for i, s in enumerate(strings):
        if s is not None:
            present |= 1 << i
            if isinstance(s, str):
                s = s.encode("ascii")
            payload += _pack_cstring(s)
    head = struct.pack(
        ">B6q",
        present,
        ad.hmm_from or 0, ad.hmm_to or 0, ad.hmm_length or 0,
        ad.target_from or 0, ad.target_to or 0, ad.target_length or 0,
    )
    return struct.pack(">B", 1) + head + payload


def _deserialize_alignment(r: _Reader) -> Optional[Alignment]:
    (has_ad,) = r.take(">B")
    if not has_ad:
        return None
    (present,) = r.take(">B")
    hmm_from, hmm_to, hmm_length, t_from, t_to, t_length = r.take(">6q")
    vals: List[Optional[bytes]] = []
    for i in range(7):
        vals.append(r.take_cstring() if present & (1 << i) else None)

    def txt(b):
        return None if b is None else b.decode("ascii")

    return Alignment(
        hmm_name=vals[0], hmm_accession=vals[1], hmm_sequence=txt(vals[2]),
        target_name=vals[3], target_sequence=txt(vals[4]),
        identity_sequence=txt(vals[5]), posterior_probabilities=txt(vals[6]),
        hmm_from=hmm_from, hmm_to=hmm_to, hmm_length=hmm_length,
        target_from=t_from, target_to=t_to, target_length=t_length,
    )


def _serialize_domain(d: Domain, dp: bool = False) -> bytes:
    # fields per include/libhmmer/p7_domain.pxd:10-27 (scores in nats on
    # the wire, matching the C struct's envsc/domcorrection/dombias).
    # dp=True stores the score block as float64 (the multihost record
    # exchange needs bit-exact merges; the hmmpgmd wire stays float32).
    out = struct.pack(
        ">4q",
        d.env_from, d.env_to, d.ali_from, d.ali_to,
    )
    out += struct.pack(
        ">5d" if dp else ">5f",
        d.envelope_score * LOG2, d.correction * LOG2, d.bias * LOG2,
        d.oasc if d.oasc is not None else 0.0,
        d.score,
    )
    out += struct.pack(">d2B", d.lnP, d.reported, d.included)
    out += _serialize_alignment(d.alignment)
    return out


def _deserialize_domain(hit: Hit, r: _Reader, dp: bool = False) -> Domain:
    ienv, jenv, iali, jali = r.take(">4q")
    envsc, corr, bias, oasc, bitscore = r.take(">5d" if dp else ">5f")
    lnP, is_rep, is_inc = r.take(">d2B")
    ad = _deserialize_alignment(r)
    d = Domain(
        hit, ienv, jenv, iali, jali, bitscore,
        bias, corr, envsc, oasc, lnP, ad,
    )
    d.flags = (F_REPORTED if is_rep else 0) | (F_INCLUDED if is_inc else 0)
    return d


def _serialize_hit(h: Hit, dp: bool = False) -> bytes:
    # fields per include/libhmmer/p7_hit.pxd:28-57
    body = struct.pack(
        ">id6d" if dp else ">id3f3d",
        0, -h.score, h.score, h.pre_score, h.sum_score,
        h.lnP, h.lnP, h.lnP,
    )
    body += struct.pack(
        ">f6i", h.nexpected, h.nregions, h.nclustered, h.noverlaps,
        h.nenvelopes, len(h.domains), h.length,
    )
    body += struct.pack(
        ">I3i", h.flags, h.nreported, h.nincluded, h.best_domain_idx,
    )
    present = (
        (1 if h.name is not None else 0)
        | (2 if h.accession is not None else 0)
        | (4 if h.description is not None else 0)
    )
    body += struct.pack(">B", present)
    body += _pack_cstring(h.name) + _pack_cstring(h.accession) + _pack_cstring(h.description)
    for d in h.domains:
        body += _serialize_domain(d, dp)
    return struct.pack(">I", len(body) + 4) + body


def _deserialize_hit(th: TopHits, r: _Reader, dp: bool = False) -> Hit:
    (_size,) = r.take(">I")
    _wl, _sortkey, score, pre, sums, lnP, _plnP, _slnP = r.take(
        ">id6d" if dp else ">id3f3d")
    nexpected, nregions, nclustered, noverlaps, nenvelopes, ndom, length = r.take(">f6i")
    flags, nreported, nincluded, best = r.take(">I3i")
    (present,) = r.take(">B")
    name = r.take_cstring() if present & 1 else None
    acc = r.take_cstring() if present & 2 else None
    desc = r.take_cstring() if present & 4 else None
    h = Hit(
        th, name or b"", acc, desc, length, score, pre, sums, lnP,
        nexpected, nregions, nclustered, noverlaps, nenvelopes,
    )
    h.flags = flags
    h.best_domain_idx = best
    for _ in range(ndom):
        h.domains.append(_deserialize_domain(h, r, dp))
    return h


# --- client -------------------------------------------------------------------


class Client:
    """A socket-based client for a profile-HMM search daemon.

    API-compatible with ``pyhmmer.daemon.Client`` (``daemon.pyx:64-513``):
    ``search_seq`` / ``search_hmm`` / ``scan_seq`` / ``iterate_seq`` /
    ``iterate_hmm``, context-manager protocol, target subranges.
    """

    def __init__(self, address: str = DEFAULT_ADDRESS, port: int = DEFAULT_PORT):
        self.address = address
        self.port = port
        self.socket = socket.socket()

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, exc_value, exc_type, traceback):
        self.close()

    def __repr__(self):
        args = []
        if self.address != DEFAULT_ADDRESS:
            args.append(repr(self.address))
        if self.port != DEFAULT_PORT:
            args.append(repr(self.port))
        return f"{type(self).__module__}.{type(self).__name__}({', '.join(args)})"

    def connect(self) -> None:
        """Connect the client to the daemon server."""
        self.socket.connect((self.address, self.port))

    def close(self) -> None:
        """Close the connection to the daemon server."""
        self.socket.close()

    # --- low level -------------------------------------------------------

    def _recvall(self, message_size: int) -> bytearray:
        buffer = bytearray(message_size)
        view = memoryview(buffer)
        received = 0
        while received < message_size:
            n = self.socket.recv_into(view)
            if n == 0:
                raise EOFError(
                    f"Expected message of size {message_size}, received {received}"
                )
            received += n
            view = view[n:]
        return buffer

    def _client(self, query, db: int, ranges, pli: Pipeline, scan: bool) -> TopHits:
        options = " ".join(pli.arguments())

        if ranges is not None:
            if len(ranges) < 1:
                raise ValueError(
                    "At least one range is needed for the `ranges` argument"
                )
            if any(len(r) != 2 for r in ranges):
                raise ValueError("`ranges` must be a list of two-element tuples")
            if not all(
                isinstance(r[0], int) and isinstance(r[1], int) for r in ranges
            ):
                raise TypeError(
                    "`ranges` must be a list where elements are 2-tuples of int"
                )

        # serialize the query in its text form + terminator (daemon.pyx:216-219)
        with io.BytesIO() as buffer:
            query.write(buffer)
            buffer.write(b"\n//")
            txt = buffer.getvalue()

        if not scan:
            if ranges is not None:
                rng = ",".join("{}..{}".format(*r) for r in ranges)
                options = f"--seqdb_ranges {rng} {options}"
            self.socket.sendall(f"@--seqdb {db} {options}\n".encode("ascii"))
        else:
            self.socket.sendall(f"@--hmmdb {db} {options}\n".encode("ascii"))
        self.socket.sendall(txt)

        # status header
        status_code, msg_size = _deserialize_status(
            bytes(self._recvall(SEARCH_STATUS_SIZE))
        )
        if status_code != 0:
            error = self.socket.recv(msg_size)
            raise ServerError(status_code, error.decode("utf-8", "replace"))

        response = bytes(self._recvall(msg_size))
        r = _Reader(response)
        stats = _deserialize_stats(r)

        hits = TopHits()
        hits._take_accounting(pli)
        hits.Z = stats["Z"]
        hits.domZ = stats["domZ"]
        hits.Z_setby = stats["Z_setby"]
        hits.domZ_setby = stats["domZ_setby"]
        hits.nmodels = stats["nmodels"]
        hits.nseqs = stats["nseqs"]
        hits.n_past_msv = stats["n_past_msv"]
        hits.n_past_bias = stats["n_past_bias"]
        hits.n_past_vit = stats["n_past_vit"]
        hits.n_past_fwd = stats["n_past_fwd"]
        hits.query_name = getattr(query, "name", None)
        hits.query_accession = getattr(query, "accession", None)
        hits.query_length = len(query) if hasattr(query, "__len__") else getattr(query, "M", 0)

        hits_start = r.pos
        for i in range(stats["nhits"]):
            if stats["hit_offsets"] is not None:
                expect = stats["hit_offsets"][i]
                if r.pos - hits_start != expect:
                    import warnings

                    warnings.warn(
                        f"Hit offset {i} did not match expected "
                        f"(expected {expect}, found {r.pos - hits_start})"
                    )
            hits.hits.append(_deserialize_hit(hits, r))
        return hits

    # --- public API --------------------------------------------------------

    def search_seq(self, query, db: int = 1, ranges=None, **options) -> TopHits:
        """Search the sequence database with a query sequence."""
        abc = getattr(query, "alphabet", Alphabet.amino())
        pli = Pipeline(abc, **options)
        return self._client(query, db, ranges, pli, scan=False)

    def search_hmm(self, query, db: int = 1, ranges=None, **options) -> TopHits:
        """Search the sequence database with a query HMM."""
        pli = Pipeline(query.alphabet, **options)
        return self._client(query, db, ranges, pli, scan=False)

    def scan_seq(self, query, db: int = 1, **options) -> TopHits:
        """Scan the profile database with a query sequence."""
        abc = getattr(query, "alphabet", Alphabet.amino())
        pli = Pipeline(abc, **options)
        return self._client(query, db, None, pli, scan=True)

    def iterate_seq(self, query, db: int = 1, ranges=None, builder=None,
                    select_hits=None, **options) -> "IterativeSearch":
        """Run a daemon-backed jackhmmer loop from a query sequence."""
        if builder is None:
            builder = Builder(Alphabet.amino(), architecture="hand")
        return IterativeSearch(self, query, db, builder, ranges, select_hits, options)

    def iterate_hmm(self, query: HMM, db: int = 1, ranges=None, builder=None,
                    select_hits=None, **options) -> "IterativeSearch":
        """Run a daemon-backed jackhmmer loop from a query HMM."""
        if builder is None:
            builder = Builder(Alphabet.amino(), architecture="hand")
        return IterativeSearch(self, query, db, builder, ranges, select_hits, options)


class IterativeSearch(_iteration.IterativeSearch):
    """A jackhmmer loop whose searches run on a daemon server
    (reference ``daemon.pyx:516-592``)."""

    def __init__(self, client: Client, query, db: int, builder: Builder,
                 ranges=None, select_hits=None, options=None):
        pipeline = Pipeline(Alphabet.amino(), **(options or {}))
        super().__init__(pipeline, builder, query, targets=None,
                         select_hits=select_hits)
        self.client = client
        self.db = db
        self.ranges = ranges
        self.options = options or {}

    def _search_hmm(self, hmm: HMM) -> TopHits:
        return self.client.search_hmm(
            hmm, db=self.db, ranges=self.ranges, **self.options
        )


# --- server -------------------------------------------------------------------

_FLAG_OPTIONS = {
    "--cut_ga": ("bit_cutoffs", "gathering"),
    "--cut_nc": ("bit_cutoffs", "noise"),
    "--cut_tc": ("bit_cutoffs", "trusted"),
    "--nobias": ("bias_filter", False),
    "--nonull2": ("null2", False),
}
_VALUE_OPTIONS = {
    "-E": ("E", float), "-T": ("T", float),
    "--domE": ("domE", float), "--domT": ("domT", float),
    "--incE": ("incE", float), "--incT": ("incT", float),
    "--incdomE": ("incdomE", float), "--incdomT": ("incdomT", float),
    "-Z": ("Z", float), "--domZ": ("domZ", float),
    "--F1": ("F1", float), "--F2": ("F2", float), "--F3": ("F3", float),
    "--seed": ("seed", int),
}


def _parse_options(tokens: List[str]):
    """Parse hmmpgmd option tokens back into Pipeline kwargs + ranges."""
    kwargs = {}
    ranges = None
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok == "--seqdb_ranges":
            i += 1
            ranges = [
                tuple(int(x) for x in part.split(".."))
                for part in tokens[i].split(",")
            ]
        elif tok in _FLAG_OPTIONS:
            key, val = _FLAG_OPTIONS[tok]
            kwargs[key] = val
        elif tok in _VALUE_OPTIONS:
            key, conv = _VALUE_OPTIONS[tok]
            i += 1
            kwargs[key] = conv(tokens[i])
        i += 1
    return kwargs, ranges


class Server:
    """A search daemon (the ``hmmpgmd`` master analog) on the sequential
    pipeline.

    Holds sequence databases (``seqdbs``: `DigitalSequenceBlock` items) and
    profile databases (``hmmdbs``: lists of `HMM`) cached in RAM like
    hmmpgmd's ``cachedb.c``, and answers `Client` searches over TCP.
    Databases are addressed by 1-based index, matching the ``db`` argument
    of the client methods.  ``device`` is where the `Builder` of a
    sequence query calibrates its model: a CUDA device (the default, which
    must exist) runs the port's kernels, ``"cpu"`` their plain versions.
    """

    def __init__(self, seqdbs=(), hmmdbs=(), address: str = DEFAULT_ADDRESS,
                 port: int = 0, device="cuda"):
        self.seqdbs = list(seqdbs)
        self.hmmdbs = list(hmmdbs)
        self.address = address
        self.port = port
        self.device = resolve_device(device)
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    # --- query handling ----------------------------------------------------

    def _parse_query(self, text: bytes, alphabet: Alphabet):
        """Parse the serialized query: HMMER3 ASCII HMM or FASTA sequence."""
        if text.lstrip().startswith(b"HMMER3"):
            from .plan7.hmmfile import HMMFile

            # repair the record terminator if the protocol terminator
            # scan consumed it (both are `//`)
            if not text.rstrip().endswith(b"//"):
                text = text + b"\n//\n"
            with HMMFile(io.BytesIO(text)) as f:
                return next(iter(f))
        from .easel.seqfile import SequenceFile

        with SequenceFile.parse(text, "fasta", digital=True,
                                alphabet=alphabet) as f:
            return f.read()

    def _run_query(self, line: str, query_text: bytes) -> TopHits:
        tokens = line[1:].split()
        mode, db = tokens[0], int(tokens[1])
        kwargs, ranges = _parse_options(tokens[2:])
        if mode == "--seqdb":
            targets = self.seqdbs[db - 1]
            alphabet = targets.alphabet
            if ranges:
                sub = DigitalSequenceBlock(alphabet)
                for start, end in ranges:
                    sub.extend(targets[start : end + 1])
                targets = sub
            query = self._parse_query(query_text, alphabet)
            pli = Pipeline(alphabet, **kwargs)
            if isinstance(query, HMM):
                return pli.search_hmm(query, targets)
            return pli.search_seq(query, targets,
                                  Builder(alphabet, device=self.device))
        elif mode == "--hmmdb":
            models = self.hmmdbs[db - 1]
            alphabet = models[0].alphabet
            query = self._parse_query(query_text, alphabet)
            pli = Pipeline(alphabet, **kwargs)
            return pli.scan_seq(query, models)
        raise ValueError(f"unknown database mode: {mode!r}")

    def _handle(self, rfile, wfile) -> bool:
        line = rfile.readline()
        if not line:
            return False
        if not line.startswith(b"@"):
            if line.strip() in (b"", b"//"):
                return True  # stray terminator fragment from the last query
            wfile.write(_serialize_status(15, 0))  # eslESYNTAX
            return False
        # read the query until the `\n//` terminator; the terminator has no
        # trailing newline (daemon.pyx:216-219), so accumulate raw chunks
        # instead of lines
        buf = bytearray()
        while not buf.rstrip().endswith(b"//"):
            chunk = rfile.read1(65536)
            if not chunk:
                return False
            buf += chunk
        stripped = bytes(buf).rstrip()
        # drop the protocol terminator (a bare `//`; HMM queries additionally
        # carry their own record terminator, repaired in _parse_query)
        query_text = stripped[:-2].rstrip() if stripped.endswith(b"//") else stripped
        try:
            th = self._run_query(line.decode("ascii").strip(), query_text)
            blobs = [_serialize_hit(h) for h in th.hits]
            stats = _serialize_stats(th, blobs)
            payload = stats + b"".join(blobs)
            wfile.write(_serialize_status(0, len(payload)) + payload)
        except Exception as err:  # report the failure to the client
            msg = str(err).encode("utf-8")
            wfile.write(_serialize_status(1, len(msg)) + msg)  # eslFAIL
        wfile.flush()
        return True

    # --- lifecycle ----------------------------------------------------------

    def _bind(self) -> None:
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while outer._handle(self.rfile, self.wfile):
                    pass

        class _TCPServer(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _TCPServer((self.address, self.port), _Handler)
        self.port = self._server.server_address[1]

    def serve_forever(self) -> None:
        """Serve requests until `shutdown` is called (blocking)."""
        self._bind()
        self._server.serve_forever()

    def start(self) -> None:
        """Start serving in a background thread (returns once listening)."""
        self._bind()
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        """Stop the server and join the background thread."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
