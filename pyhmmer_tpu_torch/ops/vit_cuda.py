"""Stage 3: the Viterbi filter score (log space, max-plus).

:func:`vit_scores` runs ``csrc/vit.cu`` on a CUDA tensor and
:func:`vit_plain`, the same function in plain PyTorch, on a CPU tensor.
It replaces the TPU kernel ``pyhmmer_tpu/ops/vit_pallas.py``
(``_vit_pallas``).  Only the (profile, column) pairs in ``need`` are
scored; the others read NEGMASS.  Both read the packed tables
``vit_emis`` / ``vit_trans`` of ``ops/batch.py``.  The plain version
uses no matmul, so no TF32 setting applies to it.
"""

from __future__ import annotations

import math

import torch

from . import _build, _pairs
from .batch import (NEGMASS, VIT_WIDE_S, ProfileBatch, SeqDevice,
                    cta_shape, packed_stripes, table_width, unpacked)

#: kernel launches made by :func:`vit_scores` (reset by the caller), and
#: those of them on the wide route
launches = 0
launches_wide = 0

LOG_HALF = math.log(0.5)

#: the kernel's code paths (``csrc/vit.cu:launch_vit``): one warp a pair,
#: or several; ``auto``, what :func:`vit_scores` takes, picks by the model
#: width and, at 16 and 24 slots a lane, by whether the launch's pairs fit
#: the card at once, so there a pair's score may move by a few ulps with
#: the launch's size (the routes add the D->D sums in another order);
#: models over 4,096 slots have one route, ``vit_cta_kernel``
ROUTES = {"auto": 0, "warp": 1, "block": 2}


def viterbi(pb: ProfileBatch, seq: SeqDevice, rows, need, pairs=None):
    """Viterbi scores [P, n] in nats for the bucket rows ``rows`` [n]
    (int64) where ``need`` [P, n] is set (``pairs``: their list from
    ``_pairs.host_pairs``, on the device, if the caller has it)."""
    return vit_scores(seq.codes, seq.lens, seq.lm, pb.vit_emis,
                      pb.vit_trans, rows, need, pairs)


def vit_scores(codes, lens, lm, emis, trans, rows, need, pairs=None):
    """``codes`` [B, Lmax] uint8; ``lens`` [B] int32; ``lm`` [B, 4] f32
    length model (the log loop and move are columns 2 and 3); ``emis``
    f32 (M, I) log emission scores and ``trans`` f32 log transitions,
    packed ([P, Kp, S, 32, 2] and [P, S, 2, 32, 4], or from ``S =
    VIT_WIDE_S`` on [P, Kp, 2, S, 32] and [P, 8, S, 32]; past 4,096
    slots the wide route's thread-major [P, Kp, SPT, W, 32, 2] and [P,
    SPT, 2, W, 32, 4]: ``ops/batch.py``); ``rows`` [n] int64; ``need``
    [P, n] bool; ``pairs`` None or the int32 [3, npairs] list of
    ``need`` (``_pairs.host_pairs``).  Returns scores [P, n] f32 nats."""
    return _scores(codes, lens, lm, emis, trans, rows, need, pairs, "auto")


def _scores(codes, lens, lm, emis, trans, rows, need, pairs, route: str):
    """:func:`vit_scores` on the kernel's code path ``route``
    (:data:`ROUTES`; a path that does not compile at the width raises)."""
    _pairs.check_packed(codes, lens, lm, emis, trans, VIT_WIDE_S,
                        _pairs.need_args(rows, need, emis.shape[0],
                                         pairs))
    if codes.device.type == "cpu":
        return vit_plain(codes, lens, lm, emis, trans, rows, need)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    Kp, S = emis.shape[1], packed_stripes(trans)
    pair_p, pair_row, pair_out, out = _pairs.pairs(rows, need, pairs)
    npairs = int(pair_p.shape[0])
    P_ = _build.ptr
    if S == 0:                                # the wide route
        if route != "auto":
            raise ValueError(f"route {route!r}: the wide route has one")
        Mk = table_width(trans)
        nt, tier = cta_shape(Mk)
        nctas = _pairs.cta_grid(codes.device, npairs)
        # a scratch row a CTA only where the row fits neither registers
        # nor shared memory
        scratch = (torch.empty((nctas, 3, Mk), dtype=torch.float32,
                               device=codes.device)
                   if tier == "global" else None)
        err = _build.lib().vit_cta_launch(
            P_(codes), codes.shape[1], P_(lens), P_(lm), P_(emis),
            P_(trans), P_(pair_p), P_(pair_row), P_(pair_out), npairs, Kp,
            Mk, nt, P_(out), None if scratch is None else P_(scratch),
            nctas, _build.stream_ptr(codes))
        _build.check(err, "vit_cta_launch")
        _build.count_launch(globals(), "wide")
        return out
    err = _build.lib().vit_launch(
        P_(codes), codes.shape[1], P_(lens), P_(lm), P_(emis), P_(trans),
        P_(pair_p), P_(pair_row), P_(pair_out), npairs, Kp, S,
        ROUTES[route], P_(out), _build.stream_ptr(codes))
    _build.check(err, "vit_launch")
    _build.count_launch(globals())
    return out


def vit_plain(codes, lens, lm, emis, trans, rows, need):
    """The Viterbi scan of ``csrc/vit.cu`` in plain PyTorch, batched over
    [P, n, Mk] with a loop over sequence rows; the D->D chain is a
    Hillis-Steele (max, +) scan."""
    dev = codes.device
    msc, isc, tr = unpacked(emis, trans)
    P, Kp, Mk = msc.shape
    n = rows.shape[0]
    out = torch.full((P, n), NEGMASS, dtype=torch.float32, device=dev)
    if n == 0 or not bool(need.any()):
        return out
    c = codes[rows]
    ln = lens[rows]
    loop = lm[rows, 2][None, :]
    move = lm[rows, 3][None, :]
    t = [tr[:, k][:, None, :] for k in range(8)]          # [P, 1, Mk]
    levels = _pairs.dd_levels(t[7], Mk, torch.add)
    neg = torch.full((P, n, Mk), NEGMASS, dtype=torch.float32, device=dev)
    negcol = neg[..., :1]
    m, iv, d = neg, neg, neg
    xN = torch.zeros((P, n), dtype=torch.float32, device=dev)
    xB = move.expand(P, n).clone()
    xJ = torch.full((P, n), NEGMASS, dtype=torch.float32, device=dev)
    xC = xJ.clone()

    def shift(a):
        return torch.cat([negcol, a[..., :-1]], dim=-1)

    Lrun = int(ln[need.any(dim=0)].max())
    for i in range(Lrun):
        x = c[:, i].long()
        nm = msc[:, x, :] + torch.maximum(
            torch.maximum(shift(m) + t[0], shift(iv) + t[1]),
            torch.maximum(shift(d) + t[2], xB[:, :, None] + t[3]))
        ni = isc[:, x, :] + torch.maximum(m + t[4], iv + t[5])
        nm = nm.clamp(min=NEGMASS)
        ni = ni.clamp(min=NEGMASS)
        bv = nm + t[6]
        for sh, A in levels:
            bv = torch.cat([bv[..., :sh], torch.maximum(
                bv[..., sh:], bv[..., :-sh] + A[..., sh:])], dim=-1)
        nd = shift(bv).clamp(min=NEGMASS)
        xE = torch.maximum(nm.amax(dim=-1), nd.amax(dim=-1))
        nJ = torch.maximum(xJ + loop, xE + LOG_HALF)
        nC = torch.maximum(xC + loop, xE + LOG_HALF)
        nN = xN + loop
        nB = torch.maximum(nN, nJ) + move
        valid = (ln > i)[None, :]
        v3 = valid[:, :, None]
        m = torch.where(v3, nm, m)
        iv = torch.where(v3, ni, iv)
        d = torch.where(v3, nd, d)
        xN = torch.where(valid, nN, xN)
        xB = torch.where(valid, nB, xB)
        xJ = torch.where(valid, nJ, xJ)
        xC = torch.where(valid, nC, xC)
    return torch.where(need, xC + move, out)
