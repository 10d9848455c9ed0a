"""Stage 2b: the survivor rows -- full-length Forward and Backward parsers
of single (profile, target) pairs and the posterior decode terms that the
native domain definition reads in place of its own parsers.

:func:`rows_scores` runs ``csrc/rows.cu`` on a CUDA tensor and
:func:`rows_plain`, the same function in plain PyTorch, on a CPU tensor.
It replaces the TPU kernels ``pyhmmer_tpu/ops/rows_pallas.py``
(``_fwd_rows_body`` and ``_bck_rows_body``, both launched by
``_survivor_rows_impl``).  For each pair ``g`` with target length ``L``:

* ``terms`` [G, Lmax + 1, 3] f32, already divided by the Forward score:
  ``term_b[q]`` (q = 0..L), ``term_e[q]`` and ``term_w[q]`` (q = 1..L),
  zero elsewhere; the host forms ``btot = cumsum(term_b)``,
  ``etot = cumsum(term_e)`` and ``mocc = 1 - term_w`` in float64;
* ``fsc`` [G] the f32 Forward parser score, ``bsc`` [G] the Backward
  score, which the caller holds against ``fsc``.

Both read the Forward filter kernel's packed odds tables ``fwd_emis`` /
``fwd_trans`` of ``ops/batch.py`` (S <= 24 slots a lane: the narrow
layout).  Everything is f32; the plain version uses no matmul, so no TF32
setting applies to it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, _pairs
from .batch import (FWD_WIDE_S, NEGMASS, ProfileBatch, SeqDevice,
                    packed_stripes, unpacked)

#: kernel launches made by :func:`rows_scores` (reset by the caller)
launches = 0

#: widest stripe the rows kernels are compiled for (Mk <= 768, the
#: engine's eligibility limit; ``csrc/rows.cu:PYHMMER_ROWS_STRIPES``)
MAX_S = 24
#: forward row planes the kernel keeps between its two passes
NF = 5
#: decode terms per row: term_b, term_e, term_w
NT = 3
TINY = 1e-30
#: the kernels' code paths (``csrc/rows.cu:launch_rows``): one warp a
#: pair, or several (from 12 slots a lane); ``auto``, what
#: :func:`rows_scores` takes, picks the block route where it exists
#: while the launch's pairs fit the card at once, so a pair's rows may
#: move by a few ulps with the launch's size (the routes add the D->D
#: sums in another order)
ROUTES = {"auto": 0, "warp": 1, "block": 2}


def survivor_rows(pb: ProfileBatch, seq: SeqDevice, pair_p, pair_b):
    """Rows of the pairs (profile ``pair_p[g]`` of ``pb``, target
    ``pair_b[g]`` of ``seq``), numpy int arrays.  Pairs run sorted by
    profile (stable), so a block's warps share tables; returns
    ``(terms, fsc, bsc, order)`` in that order, where ``order[g]`` is the
    input index of row ``g``."""
    pair_p, pair_b = np.asarray(pair_p), np.asarray(pair_b)
    if pair_p.shape != pair_b.shape or pair_p.ndim != 1:
        raise ValueError("pair_p and pair_b must be 1-D of one length")
    # the kernels index the tables and targets with these unchecked
    if len(pair_p) and (pair_p.min() < 0 or pair_p.max() >= pb.P
                        or pair_b.min() < 0 or pair_b.max() >= seq.B):
        raise IndexError("pair index outside the profiles or targets")
    order = np.argsort(pair_p, kind="stable")

    def dev(a):
        return torch.as_tensor(a[order].astype(np.int32), device=seq.device)
    terms, fsc, bsc = rows_scores(seq.codes, seq.lens, seq.lm, pb.fwd_emis,
                                  pb.fwd_trans, dev(pair_p), dev(pair_b))
    return terms, fsc, bsc, order


def ext_rows(terms: np.ndarray, L: int) -> np.ndarray:
    """The rows ``[3, L + 1]`` float64 (btot, etot, mocc) that
    ``ops.native.domaindef(ext_rows=)`` takes, from one pair's
    ``terms`` [>= L + 1, 3] (cumulative sums in float64)."""
    t = np.asarray(terms[: L + 1], np.float64)
    btot = np.concatenate([[0.0], np.cumsum(t[:L, 0])])
    etot = np.concatenate([[0.0], np.cumsum(t[1:, 1])])
    mocc = 1.0 - t[:, 2]
    mocc[0] = 0.0
    return np.stack([btot, etot, mocc])


def rows_scores(codes, lens, lm, emis, trans, pair_p, pair_row):
    """``codes`` [B, Lmax] uint8; ``lens`` [B] int32; ``lm`` [B, 4] f32
    length model; ``emis`` [P, Kp, S, 32, 2] f32 (M, I) emission odds and
    ``trans`` [P, S, 2, 32, 4] f32 transition odds, packed
    (``ops/batch.py``) with S <= 24; ``pair_p``/``pair_row`` [G] int32.
    Returns (terms [G, Lmax + 1, 3], fsc [G], bsc [G]), f32."""
    return _scores(codes, lens, lm, emis, trans, pair_p, pair_row, "auto")


def _scores(codes, lens, lm, emis, trans, pair_p, pair_row, route: str):
    """:func:`rows_scores` on the kernels' code path ``route``
    (:data:`ROUTES`; a path that does not compile at the width raises)."""
    B, Lmax = codes.shape
    G = pair_p.shape[0]
    _pairs.check_packed(codes, lens, lm, emis, trans, FWD_WIDE_S,
                        {"pair_p": (pair_p, torch.int32, (G,)),
                         "pair_row": (pair_row, torch.int32, (G,))})
    Kp, S = emis.shape[1], packed_stripes(trans)
    if S == 0 or S > MAX_S:
        raise ValueError(f"stripe width {S or 'of the wide route'} exceeds the rows kernels' "
                         f"{MAX_S} (model width {32 * MAX_S})")
    if codes.device.type == "cpu":
        return rows_plain(codes, lens, lm, emis, trans, pair_p, pair_row)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    f32 = dict(dtype=torch.float32, device=codes.device)
    frows = torch.empty((G, NF, Lmax + 1), **f32)
    terms = torch.zeros((G, Lmax + 1, NT), **f32)
    fsc = torch.empty((G,), **f32)
    bsc = torch.empty((G,), **f32)
    P_ = _build.ptr
    err = _build.lib().rows_launch(
        P_(codes), Lmax, P_(lens), P_(lm), P_(emis), P_(trans), P_(pair_p),
        P_(pair_row), G, Kp, S, ROUTES[route], P_(frows), P_(fsc),
        P_(terms), P_(bsc), _build.stream_ptr(codes))
    _build.check(err, "rows_launch")
    _build.count_launch(globals())
    return terms, fsc, bsc


def rows_plain(codes, lens, lm, emis, trans, pair_p, pair_row):
    """The two passes of ``csrc/rows.cu`` in plain PyTorch, batched over
    [G, Mk] with a loop over sequence rows; the forward D->D chain is a
    Hillis-Steele scan of affine maps and the backward one the same scan
    over the reversed slots.  Each backward row is rescaled by its own
    largest value (the kernel takes the row before's, which changes the
    rounding of the terms, not their value)."""
    dev = codes.device
    Lmax = codes.shape[1]
    G = pair_p.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    terms = torch.zeros((G, Lmax + 1, NT), **f32)
    if G == 0:
        return terms, torch.empty((0,), **f32), torch.empty((0,), **f32)
    ems, eis, tr = unpacked(emis, trans)
    Mk = ems.shape[-1]
    pp, pr = pair_p.long(), pair_row.long()
    ar = torch.arange(G, device=dev)
    em, ei = ems[pp], eis[pp]                          # [G, Kp, Mk]
    t = [tr[pp, k] for k in range(8)]                  # [G, Mk]
    c = codes[pr].long()
    ln = lens[pr].long()
    loop, move, log_loop, log_move = lm[pr].unbind(1)  # [G]
    zero = torch.zeros((G, Mk), **f32)
    zcol = zero[:, :1]
    Lrun = int(ln.max())

    # forward: fwd_plain's recurrence, keeping every row's specials
    levels = _pairs.dd_levels(t[7], Mk, torch.mul)
    m, iv, d = zero, zero, zero
    xN = torch.ones((G,), **f32)
    xB, xJ, xC, lsc = move, zero[:, 0], zero[:, 0], zero[:, 0]
    fB, fE, fJ, fC, rsf = [xB], [zero[:, 0]], [xJ], [xC], [lsc]

    def up(a):        # slot s takes slot s - 1
        return torch.cat([zcol, a[:, :-1]], dim=-1)

    for i in range(Lrun):
        x = c[:, i]
        nm = em[ar, x] * (up(m) * t[0] + up(iv) * t[1] + up(d) * t[2]
                          + xB[:, None] * t[3])
        ni = ei[ar, x] * (m * t[4] + iv * t[5])
        bv = nm * t[6]
        for sh, A in levels:
            bv = torch.cat([bv[:, :sh], bv[:, sh:] + bv[:, :-sh] * A[:, sh:]],
                           dim=-1)
        nd = up(bv)
        e = nm.sum(dim=-1) + nd.sum(dim=-1)
        nj = xJ * loop + e * 0.5
        nc = xC * loop + e * 0.5
        nn = xN * loop
        nb = (nn + nj) * move
        mx = torch.maximum(torch.maximum(e, nj),
                           torch.maximum(nc, nn)).clamp(min=TINY)
        inv = 1.0 / mx
        valid = ln > i
        v2 = valid[:, None]
        m = torch.where(v2, nm * inv[:, None], m)
        iv = torch.where(v2, ni * inv[:, None], iv)
        d = torch.where(v2, nd * inv[:, None], d)
        lsc = torch.where(valid, lsc + torch.log(mx), lsc)
        xJ = torch.where(valid, nj * inv, xJ)
        xC = torch.where(valid, nc * inv, xC)
        xN = torch.where(valid, nn * inv, xN)
        xB = torch.where(valid, nb * inv, xB)
        for rows, v in ((fB, xB), (fE, e * inv), (fJ, xJ), (fC, xC),
                        (rsf, lsc)):
            rows.append(v)
    fB, fE, fJ, fC, rsf = (torch.stack(r, dim=1) for r in (fB, fE, fJ, fC,
                                                           rsf))
    neg = torch.full((G,), NEGMASS, **f32)
    fsc = torch.where(xC > 0.0, torch.log(xC.clamp(min=TINY)) + lsc
                      + log_move, neg)
    live = fsc > 0.5 * NEGMASS

    # backward, from row L down to row 0; each pair's state stays zero
    # above its own length
    rlev = _pairs.dd_levels(t[7].flip(-1), Mk, torch.mul)

    def down(a):      # slot s takes slot s + 1
        return torch.cat([a[:, 1:], zcol], dim=-1)

    tn = [down(t[k]) for k in range(3)]   # transitions into slot s + 1
    m, iv = zero, zero
    xN, xB, xJ, xC, xE, lsc = (zero[:, 0],) * 6
    for r in range(Lrun, -1, -1):
        x = c[:, r] if r < Lmax else torch.zeros_like(ln)
        me = m * em[ar, x]
        nxt = down(me)
        b = (me * t[3]).sum(dim=-1)
        nj = xJ * loop + b * move
        nn = xN * loop + b * move
        nc = torch.where(ln == r, move, xC * loop)
        ne = 0.5 * (nj + nc)
        bv = (ne[:, None] + nxt * tn[2]).flip(-1)
        for sh, A in rlev:
            bv = torch.cat([bv[:, :sh], bv[:, sh:] + bv[:, :-sh] * A[:, sh:]],
                           dim=-1)
        nd = down(bv.flip(-1))                       # bD at slot s + 1
        isv = ei[ar, x]
        nm = (ne[:, None] + nxt * tn[0] + iv * t[4] * isv + nd * t[6])
        ni = nxt * tn[1] + iv * t[5] * isv
        mx = torch.maximum(torch.maximum(nm.amax(dim=-1), nj),
                           torch.maximum(nc, nn)).clamp(min=TINY)
        inv = 1.0 / mx
        active = ln >= r
        v2 = active[:, None]
        m = torch.where(v2, nm * inv[:, None], m)
        iv = torch.where(v2, ni * inv[:, None], iv)
        lsc = torch.where(active, lsc + torch.log(mx), lsc)
        xJ = torch.where(active, nj * inv, xJ)
        xC = torch.where(active, nc * inv, xC)
        xN = torch.where(active, nn * inv, xN)
        xB = torch.where(active, b * inv, xB)
        xE = torch.where(active, ne * inv, xE)
        emit = active & live
        ex1 = torch.exp(rsf[:, r] + lsc - fsc)
        tb = fB[:, r] * xB * ex1
        terms[:, r, 0] = torch.where(emit, tb, zero[:, 0])
        if r > 0:
            te = fE[:, r] * xE * ex1
            ex0 = torch.exp(rsf[:, r - 1] + lsc - fsc)
            en = torch.exp((r - 1) * log_loop + lsc - fsc)
            tw = (en * xN + (fJ[:, r - 1] * xJ + fC[:, r - 1] * xC) * ex0
                  ) * loop
            terms[:, r, 1] = torch.where(emit, te, zero[:, 0])
            terms[:, r, 2] = torch.where(emit, tw, zero[:, 0])
    bsc = torch.where(xN > 0.0, torch.log(xN.clamp(min=TINY)) + lsc, neg)
    return terms, fsc, bsc
