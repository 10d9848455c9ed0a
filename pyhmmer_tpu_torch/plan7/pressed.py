"""Reader and writer of HMMER's pressed-database members (``.h3f``/``.h3p``).

The port's copy of ``pyhmmer_tpu/plan7/pressed.py``: byte-level parsing
and writing of ``p7_oprofile_Write``'s output (HMMER's
``p7_oprofile_ReadMSV`` / ``ReadRest`` read it back).

``.h3f`` record (MSV filter part)::

    u32   magic 0xb3e6e6f3
    i32   M, i32 alphabet type
    i32 n + (n+1) bytes        name
    i32   max_length (-1 = unset)
    u8    tbm_b, tec_b, tjb_b
    f32   scale_b
    u8    base_b, bias_b
    i8    sbv[Kp][(nqb+17)*16]  striped UNBIASED match costs for SSV
                                (+17 wraparound duplicate vectors)
    u8    rbv[Kp][nqb*16]       striped BIASED match costs for MSV
                                (identical to ops/quantize.py's cost)
    f32   evparam[6]
    i64   offs[3]               moff/.h3m, foff/.h3f, poff/.h3p disk
                                offsets of this record (zero for the
                                first record)
    f32   compo[K]
    u32   sentinel magic

``.h3p`` record (Viterbi/Forward part)::

    u32   magic 0xb3e6f0f3
    i32   M, type; name/acc/desc as length-prefixed strings (-1 = none)
    char  rf/mm/cs/consensus annotation blocks, (M+2) bytes each
    i16   twv[nqw*8*8]         striped int16 Viterbi bands
    i16   rwv[Kp][nqw*8]
    i16   xw[4][2]; f32 scale_w; i16 base_w, ddbound_w; f32 ncj_roundoff
    f32   tfv[nqf][7][4] + DD[nqf][4]   transition odds, slots
          {BM(k-1), MM(k-1), IM(k-1), DM(k-1), MD(k), MI(k), II(k)};
          the trailing nqf vectors are DD(k)
    f32   rfv[Kp][nqf*4]       striped match-emission odds (exp msc)
    f32   xf[4][2]             E=[.5,.5], N/J/C=[pmove, 1-pmove]
    f32   cutoff[6], nj; i32 mode, L; u32 sentinel magic

Striping: element ``z`` of vector ``q`` is model position
``k = q + z*nv + 1`` with ``nv`` the per-width vector count
(16/8/4-wide for MSV/Viterbi/Forward).

The parsed Forward part carries the complete local-profile
parameterization (match odds + all transitions; insert emission scores
are identically 0 in HMMER's local profiles), so a search-ready model is
reconstructed without touching the ``.h3m`` member.
"""

from __future__ import annotations

import os
import struct
import numpy as np
from typing import Optional

from ..easel.alphabet import Alphabet
from .hmm import HMM, HMMFlags
from .background import Background

__all__ = ["MAGIC_H3F", "MAGIC_H3P", "is_reference_pressed",
           "read_h3f_records", "read_h3p_records",
           "reconstruct_models", "write_h3f_record", "write_h3p_record"]

MAGIC_H3F = 0xB3E6E6F3
MAGIC_H3P = 0xB3E6F0F3

_ABC_BY_TYPE = {1: "rna", 2: "dna", 3: "amino"}


def is_reference_pressed(path_f) -> bool:
    try:
        with open(path_f, "rb") as fh:
            head = fh.read(4)
        return len(head) == 4 and struct.unpack("<I", head)[0] == MAGIC_H3F
    except OSError:
        return False


def _alphabet_for(atype: int) -> Alphabet:
    kind = _ABC_BY_TYPE.get(atype)
    if kind == "amino":
        return Alphabet.amino()
    if kind == "dna":
        return Alphabet.dna()
    if kind == "rna":
        return Alphabet.rna()
    raise ValueError(f"unsupported alphabet type {atype}")


class _Cursor:
    def __init__(self, data: bytes):
        self.d = data
        self.off = 0

    def u32(self):
        v = struct.unpack_from("<I", self.d, self.off)[0]
        self.off += 4
        return v

    def i32(self):
        v = struct.unpack_from("<i", self.d, self.off)[0]
        self.off += 4
        return v

    def f32(self, n=1):
        v = np.frombuffer(self.d, "<f4", n, self.off)
        self.off += 4 * n
        return v if n > 1 else float(v[0])

    def u8(self):
        v = self.d[self.off]
        self.off += 1
        return v

    def lstring(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        if n == 0:
            return b""        # absent: length 0, no bytes follow
        s = self.d[self.off: self.off + n]
        self.off += n + 1
        return s

    def raw(self, n):
        s = self.d[self.off: self.off + n]
        self.off += n
        return s

    def eof(self):
        return self.off >= len(self.d)


def _unstripe(arr2d: np.ndarray, nv: int, lanes: int, M: int) -> np.ndarray:
    """[rows, nv*lanes] striped -> [rows, M] in model order (1-based
    position k = q + z*nv + 1 at vector q lane z)."""
    rows = arr2d.shape[0]
    out = np.zeros((rows, M), arr2d.dtype)
    a = arr2d.reshape(rows, nv, lanes)
    for z in range(lanes):
        ks = np.arange(nv) + z * nv
        sel = ks < M
        out[:, ks[sel]] = a[:, sel, z]
    return out


def read_h3f_records(path) -> list:
    """Parse every record of a reference ``.h3f``; returns dicts with
    the MSV filter parameterization in model order."""
    data = open(os.fspath(path), "rb").read()
    c = _Cursor(data)
    out = []
    while not c.eof():
        magic = c.u32()
        if magic != MAGIC_H3F:
            raise ValueError(f".h3f bad magic {magic:#x} at "
                             f"{c.off - 4}")
        M = c.i32()
        atype = c.i32()
        abc = _alphabet_for(atype)
        Kp = abc.Kp
        name = c.lstring()
        max_length = c.i32()
        tbm_b, tec_b, tjb_b = c.u8(), c.u8(), c.u8()
        scale_b = c.f32()
        base_b, bias_b = c.u8(), c.u8()
        # SSV block first: Kp rows of (nqb + 17) vectors of int8
        # UNBIASED costs (wraparound duplicate vectors appended); then
        # the MSV block: Kp rows of nqb vectors of uint8 BIASED costs
        # (identical convention to ops/quantize.py, padding 255)
        nqb = (M + 15) // 16
        nqs = nqb + 17
        c.off += Kp * nqs * 16            # sbv (redundant with rbv)
        rbv = np.frombuffer(c.d, np.uint8, Kp * nqb * 16,
                            c.off).reshape(Kp, nqb * 16)
        c.off += Kp * nqb * 16
        evparam = c.f32(6).copy()
        offs = struct.unpack_from("<3q", c.d, c.off)
        c.off += 24
        compo = c.f32(abc.K).copy()
        sentinel = c.u32()
        if sentinel != MAGIC_H3F:
            raise ValueError(".h3f record sentinel mismatch")
        cost = _unstripe(rbv.astype(np.int32), nqb, 16, M)
        out.append(dict(
            M=M, alphabet=abc, name=name, max_length=max_length,
            tbm_b=tbm_b, tec_b=tec_b, tjb_b=tjb_b, scale_b=scale_b,
            base_b=base_b, bias_b=bias_b, cost=cost,
            evparam=evparam, offs=offs, compo=compo))
    return out


_TF_SLOTS = ("BM", "MM", "IM", "DM", "MD", "MI", "II")


def read_h3p_records(path) -> list:
    """Parse every record of a reference ``.h3p``; returns dicts with
    the float Forward parameterization (match odds + transitions) in
    model order."""
    data = open(os.fspath(path), "rb").read()
    c = _Cursor(data)
    out = []
    while not c.eof():
        magic = c.u32()
        if magic != MAGIC_H3P:
            raise ValueError(f".h3p bad magic {magic:#x} at "
                             f"{c.off - 4}")
        M = c.i32()
        atype = c.i32()
        abc = _alphabet_for(atype)
        Kp = abc.Kp
        name = c.lstring()
        acc = c.lstring()
        desc = c.lstring()
        rf = c.raw(M + 2)
        mm = c.raw(M + 2)
        cs = c.raw(M + 2)
        consensus = c.raw(M + 2)
        nqw = (M + 7) // 8
        c.off += 8 * nqw * 16             # twv (recomputed)
        c.off += Kp * nqw * 16            # rwv
        c.off += 16                       # xw[4][2] int16
        scale_w = c.f32()
        c.off += 4                        # base_w, ddbound_w int16
        c.off += 4                        # ncj_roundoff f32
        nqf = (M + 3) // 4
        tfv = np.frombuffer(c.d, "<f4", 7 * nqf * 4,
                            c.off).reshape(nqf, 7, 4)
        c.off += 7 * nqf * 16
        dd = np.frombuffer(c.d, "<f4", nqf * 4, c.off).reshape(nqf, 4)
        c.off += nqf * 16
        rfv = np.frombuffer(c.d, "<f4", Kp * nqf * 4,
                            c.off).reshape(Kp, nqf * 4)
        c.off += Kp * nqf * 16
        xf = c.f32(8).copy()
        # trailing offsets block up to the sentinel
        while struct.unpack_from("<I", c.d, c.off)[0] != MAGIC_H3P:
            c.off += 4
        c.off += 4
        odds_m = _unstripe(rfv, nqf, 4, M)                 # [Kp, M]
        tr = {}
        for si, nm in enumerate(_TF_SLOTS):
            v = _unstripe(tfv[:, si, :][:, None, :].transpose(1, 0, 2)
                          .reshape(1, nqf * 4), nqf, 4, M)[0]
            tr[nm] = v
        tr["DD"] = _unstripe(dd.reshape(1, nqf * 4), nqf, 4, M)[0]
        out.append(dict(
            M=M, alphabet=abc, name=name, accession=acc,
            description=desc, rf=rf, cs=cs, consensus=consensus,
            odds_m=odds_m, tr=tr, xf=xf))
    return out


def reconstruct_models(path_f, path_p) -> list:
    """Rebuild search-ready ``HMM`` objects from a reference-pressed
    database's ``.h3f`` + ``.h3p`` members alone.

    The Forward part stores the multihit-local profile's match odds
    (``exp(msc)`` to f32) and transition probabilities; undoing the
    known local-profile configuration (odds x background, occ-weighted
    entry) recovers the core model to f32 precision.  Insert emissions
    are not stored (HMMER local profiles score inserts as 0); they are
    set to the background, which nothing in the pipeline consumes
    beyond display.
    """
    recs_f = read_h3f_records(path_f)
    recs_p = read_h3p_records(path_p)
    if len(recs_f) != len(recs_p):
        raise ValueError(".h3f/.h3p record count mismatch")
    models = []
    for rf_, rp in zip(recs_f, recs_p):
        if rf_["M"] != rp["M"] or rf_["name"] != rp["name"]:
            raise ValueError(".h3f/.h3p records out of sync")
        M = rp["M"]
        abc = rp["alphabet"]
        bg = Background(abc)
        hmm = HMM(abc, M, name=rp["name"] or b"")
        hmm.accession = rp["accession"]
        hmm.description = rp["description"]
        f = bg.residue_frequencies
        mat = rp["odds_m"][: abc.K, :].T * f[None, :]      # [M, K]
        s = mat.sum(axis=1, keepdims=True)
        mat = np.where(s > 0, mat / np.maximum(s, 1e-30), f[None, :])
        hmm.mat[1:] = mat
        hmm.mat[0] = 0.0
        hmm.mat[0, 0] = 1.0
        hmm.ins[:] = f
        tr = rp["tr"]
        # The stored transition vectors decode (position index j) as:
        #   MM/IM/DM[j] = t_core[j][*]   for j = 1..M-1  (j=0 is the
        #                                shifted-boundary zero)
        #   MD/MI/II[j] = t_core[j+1][*] for j = 0..M-1
        #   DD[j]       = t_core[j+1][DD]
        # HMM.t columns: 0=MM 1=MI 2=MD 3=IM 4=II 5=DM 6=DD.
        t = hmm.t
        t[:, :] = 0.0
        t[1: M, 0] = tr["MM"][1: M]
        t[1: M, 3] = tr["IM"][1: M]
        t[1: M, 5] = tr["DM"][1: M]
        t[1: M + 1, 1] = tr["MI"][: M]
        t[1: M + 1, 2] = tr["MD"][: M]
        t[1: M + 1, 4] = tr["II"][: M]
        t[1: M + 1, 6] = tr["DD"][: M]
        # node 0 (B row): only occ[1] = t[0][MM] + t[0][MI] is
        # observable, through the stored entry distribution
        # BM[k] = occ[k] / Z.  The occupancy recursion makes every
        # occ[k] affine in a = occ[1]; solving the k=2 ratio recovers a
        # exactly:
        #   occ[2] = a*(tMM[1]+tMI[1]) + (1-a)*tDM[1]
        #   bm[1]/bm[0] = occ[2]/a
        bm = tr["BM"]
        a = None
        if M >= 2 and bm[0] > 0:
            alpha = (t[1, 0] + t[1, 1]) - t[1, 5]
            beta = t[1, 5]
            denom = bm[1] / bm[0] - alpha
            if abs(denom) > 1e-12:
                a = float(beta / denom)
        if a is None or not (0.0 < a <= 1.0):
            a = 0.99                       # degenerate: harmless default
        t[0, 0] = a                        # occ mass via MM (split vs
        t[0, 1] = 0.0                      # MI is unobservable & unused)
        t[0, 2] = 1.0 - a
        t[0, 5], t[0, 6] = 1.0, 0.0
        # node M row: MD = 0; MM = exit mass
        t[M, 2] = 0.0
        t[M, 0] = max(1.0 - t[M, 1], 0.0)
        if t[M, 3] + t[M, 4] <= 0:
            t[M, 3: 5] = [1.0, 0.0]
        else:
            t[M, 3] = max(1.0 - t[M, 4], 0.0)
        t[M, 5], t[M, 6] = 1.0, 0.0
        # renormalize the interior rows against f32 roundtrip drift
        for sl in (slice(0, 3), slice(3, 5)):
            blk = t[1: M, sl]
            ssum = blk.sum(axis=1, keepdims=True)
            np.divide(blk, ssum, out=blk, where=ssum > 0)
        blk = t[1: M, 5: 7]
        ssum = blk.sum(axis=1, keepdims=True)
        np.divide(blk, ssum, out=blk, where=ssum > 0)
        hmm.evparam[:] = rf_["evparam"]
        hmm.flags |= HMMFlags.STATS
        co = np.asarray(rf_["compo"])
        if np.any(co != 0):
            hmm.composition = co
        else:
            hmm.set_composition()
        cons = rp["consensus"][1: M + 1]
        if any(c != 0 for c in cons):
            hmm.consensus = bytes(cons)
        else:
            hmm.set_consensus()
        models.append(hmm)
    return models


# ---------------------------------------------------------------------------
# writers: invert the byte layout above so HMMER / pyhmmer can read the
# engine's pressed output (p7_oprofile_Write role, plan7.pyx:6480-6486)
# ---------------------------------------------------------------------------

def _wordify(x, scale_w: float) -> np.ndarray:
    """int16 Viterbi quantization: round(scale_w * score), -inf (and
    anything below range) pinned to -32768."""
    x = np.asarray(x, dtype=np.float64)
    w = np.where(np.isfinite(x), np.round(scale_w * x), -32768.0)
    return np.clip(w, -32768, 32767).astype(np.int16)


def _stripe16(vals: np.ndarray, nq: int, lanes: int, fill) -> np.ndarray:
    """Model-order [.., M] -> striped [.., nq, lanes] (position
    k = q + z*nq + 1 at vector q lane z; out-of-range = fill)."""
    lead = vals.shape[:-1]
    M = vals.shape[-1]
    out = np.full(lead + (nq, lanes), fill, dtype=vals.dtype)
    for z in range(lanes):
        ks = np.arange(nq) + z * nq
        sel = ks < M
        out[..., sel, z] = vals[..., ks[sel]]
    return out


def _lstring(s: Optional[bytes]) -> bytes:
    # missing/empty strings are stored as length 0 with NO bytes (per
    # the golden fixtures: Thioesterase has no accession/description);
    # present strings carry a trailing NUL not counted in the length
    s = b"" if s is None else bytes(s)
    if not s:
        return struct.pack("<i", 0)
    return struct.pack("<i", len(s)) + s + b"\x00"


def _annot(field: Optional[bytes], M: int) -> bytes:
    """(M+2)-byte annotation block: [0]=' ', chars 1..M, trailing NUL;
    all-zero when absent.  Stored fields carry the leading space."""
    if not field:
        return b"\x00" * (M + 2)
    b = bytes(field)
    if len(b) == M:          # no leading space stored on the HMM
        b = b" " + b
    b = b[: M + 1].ljust(M + 1, b" ")
    return b + b"\x00"


def write_h3f_record(fh, hmm, quant=None, offs=(0, 0, 0)) -> None:
    """Append one reference-layout ``.h3f`` (MSV part) record
    (``p7_oprofile_Write`` filter member, byte-compatible with
    ``impl_sse/io.c``)."""
    from ..ops.quantize import quantize_msv
    from .profile import Profile
    from .background import Background

    abc = hmm.alphabet
    Kp = abc.Kp
    M = hmm.M
    if quant is None:
        prof = Profile(M, abc).configure(hmm, Background(abc), 400,
                                         multihit=True)
        quant = quantize_msv(prof)
    nqb = (M + 15) // 16
    out = [struct.pack("<I", MAGIC_H3F),
           struct.pack("<ii", M, int(abc.type)),
           _lstring(hmm.name),
           struct.pack("<i", int(getattr(hmm, "max_length", None) or -1)),
           struct.pack("<3B", quant.tbm_b, quant.tec_b,
                       int(quant.tjb_b(400))),
           struct.pack("<f", quant.scale_b),
           struct.pack("<2B", quant.base_b, quant.bias_b)]
    # rbv: striped BIASED uint8 costs (padding 255); sbv: the same
    # unbiased as int8 (clip [-128, 127]) with 17 cyclic wraparound
    # duplicate vectors appended
    cost = np.asarray(quant.cost, dtype=np.int32)        # [Kp, M]
    rbv = _stripe16(cost.astype(np.int32), nqb, 16, 255)  # [Kp, nqb, 16]
    sbv = np.clip(rbv - int(quant.bias_b), -128, 127).astype(np.int8)
    wrap = sbv[:, np.arange(nqb + 17) % nqb, :] if nqb else sbv
    out.append(wrap.astype("<i1").tobytes())
    out.append(rbv.astype("<u1").tobytes())
    out.append(np.asarray(hmm.evparam, dtype="<f4")[:6].tobytes())
    # disk offsets of this record's members: (moff in .h3m, foff in
    # .h3f, poff in .h3p) as int64 -- zeros for a standalone record
    out.append(struct.pack("<3q", *offs))

    compo = (np.asarray(hmm.composition, dtype="<f4")
             if getattr(hmm, "composition", None) is not None
             else np.zeros(abc.K, dtype="<f4"))
    out.append(compo[: abc.K].tobytes())
    out.append(struct.pack("<I", MAGIC_H3F))
    fh.write(b"".join(out))


def write_h3p_record(fh, hmm, prof=None, L: int = 400) -> None:
    """Append one reference-layout ``.h3p`` (Viterbi/Forward part)
    record.  Layouts (all validated field-by-field against the bundled
    golden dbs in ``tests/test_pressed_write.py``):

    * int16 Viterbi block: per-q groups of 7 vectors in slot order
      {BM, MM, IM, DM, MD, MI, II} followed by nqw DD vectors; slots
      BM/MM/IM/DM store source node k = q + z*nqw (k=0 invalid for
      MM/IM/DM), slots MD/MI/II/DD store node k+1; wordify =
      round(score * 500/ln2) with -32768 sentinels.
    * xw specials: E = [w(log .5)]*2, N/J/C = [w(log pmove), 0] (the
      NN/CC/JJ zero-loop filter approximation).
    * f32 Forward block: same grouping at 4 lanes in exp space.
    * trailer: cutoff[6], nj, mode, L.
    """
    from .profile import Profile
    from .background import Background

    abc = hmm.alphabet
    Kp = abc.Kp
    M = hmm.M
    if prof is None:
        prof = Profile(M, abc).configure(hmm, Background(abc), L,
                                         multihit=True)
    nqw = (M + 7) // 8
    nqf = (M + 3) // 4
    scale_w = 500.0 / np.log(2.0)

    out = [struct.pack("<I", MAGIC_H3P),
           struct.pack("<ii", M, int(abc.type)),
           _lstring(hmm.name), _lstring(hmm.accession),
           _lstring(hmm.description),
           _annot(getattr(hmm, "reference", None), M),
           _annot(getattr(hmm, "model_mask", None), M),
           _annot(getattr(hmm, "consensus_structure", None), M),
           _annot(getattr(hmm, "consensus", None), M)]

    def col(name, dk):
        """[M]-wide f64 transition column in slot-k order (k = model
        node written at stripe position k), NaN out of range."""
        a = np.asarray(getattr(prof, name), dtype=np.float64)
        v = np.full(M, np.nan)
        ks = np.arange(M) + dk
        sel = ks < len(a)
        v[sel] = a[ks[sel]]
        return v

    tBM = col("tBM", 0)
    tMM, tIM, tDM = col("tMM", 0), col("tIM", 0), col("tDM", 0)
    for v in (tMM, tIM, tDM):
        v[0] = np.nan                       # k=0 boundary
    tMD, tMI, tII = col("tMD", 1), col("tMI", 1), col("tII", 1)
    tDD = col("tDD", 1)
    slots = [tBM, tMM, tIM, tDM, tMD, tMI, tII]
    tw = np.full((nqw, 7, 8), -32768, dtype=np.int16)
    for si, v in enumerate(slots):
        tw[:, si, :] = _stripe16(_wordify(v, scale_w), nqw, 8, -32768)
    out.append(tw.astype("<i2").tobytes())
    ddw = _stripe16(_wordify(tDD, scale_w), nqw, 8, -32768)
    out.append(ddw.astype("<i2").tobytes())

    msc = np.asarray(prof.msc, dtype=np.float64)[:, 1:]   # [Kp, M]
    rwv = _stripe16(_wordify(msc, scale_w), nqw, 8, -32768)
    out.append(rwv.astype("<i2").tobytes())

    # pmove computed in f32 like the reference (1-ulp byte parity)
    pmove = float(np.float32(3.0) / np.float32(L + 3.0))
    w_move = int(np.round(scale_w * np.log(pmove)))
    w_half = int(np.round(scale_w * np.log(0.5)))
    xw = np.array([[w_half, w_half]] + [[w_move, 0]] * 3, dtype="<i2")
    out.append(xw.tobytes())
    out.append(struct.pack("<f", np.float32(scale_w)))
    # ddbound_w: max over k of w(DD k) + w(DM k+1) - w(BM k+1)
    wdd = _wordify(col("tDD", 0), scale_w).astype(np.int32)
    wdm = _wordify(tDM, scale_w).astype(np.int32)
    wbm = _wordify(tBM, scale_w).astype(np.int32)
    ddb = -32768
    for k in range(1, M - 1):
        if wdd[k] > -32768 and wdm[k + 1] > -32768 and wbm[k + 1] > -32768:
            ddb = max(ddb, int(wdd[k]) + int(wdm[k + 1]) - int(wbm[k + 1]))
    out.append(struct.pack("<hh", 12000, np.clip(ddb, -32768, 32767)))
    out.append(struct.pack("<f", 0.0))      # ncj_roundoff

    def xexp(a):
        a = np.asarray(a, np.float64)
        return np.where(np.isfinite(a),
                        np.exp(np.minimum(a, 600.0)), 0.0)

    tf = np.zeros((nqf, 7, 4), dtype="<f4")
    for si, v in enumerate(slots):
        tf[:, si, :] = _stripe16(xexp(v).astype("<f4"), nqf, 4, 0.0)
    out.append(tf.tobytes())
    out.append(_stripe16(xexp(tDD).astype("<f4"), nqf, 4,
                         0.0).tobytes())
    out.append(_stripe16(xexp(msc).astype("<f4"), nqf, 4, 0.0).tobytes())
    pm32 = np.float32(3.0) / np.float32(L + 3.0)
    xf = np.array([[0.5, 0.5]] + [[pm32, np.float32(1.0) - pm32]] * 3,
                  dtype="<f4")
    out.append(xf.tobytes())
    cut = getattr(hmm, "cutoffs", None)
    cut = (np.asarray(cut, dtype="<f4")[:6] if cut is not None
           else np.full(6, -99999.0, dtype="<f4"))
    out.append(cut.tobytes())
    out.append(struct.pack("<f", 1.0))      # nj (multihit)
    out.append(struct.pack("<ii", 1, L))    # mode (p7_LOCAL), L
    out.append(struct.pack("<I", MAGIC_H3P))
    fh.write(b"".join(out))
