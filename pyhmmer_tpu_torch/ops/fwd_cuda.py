"""Stage 2: the Forward filter score (odds space, parser score).

:func:`fwd_scores` runs ``csrc/fwd.cu`` on a CUDA tensor and
:func:`fwd_plain`, the same function in plain PyTorch, on a CPU tensor.
It replaces the TPU kernels ``pyhmmer_tpu/ops/fwd_pallas.py``
(``_fwd_pallas3``, ``_fwd_pallas2`` and ``_fwd_pallas``).  Only the
(profile, column) pairs in ``need`` are scored; the others read NEGMASS.
Both read the packed tables ``fwd_emis`` / ``fwd_trans`` of
``ops/batch.py``.  Everything is f32; the plain version uses no matmul,
so no TF32 setting applies to it.
"""

from __future__ import annotations

import torch

from . import _build, _pairs
from .batch import (FWD_WIDE_S, NEGMASS, ProfileBatch, SeqDevice,
                    cta_shape, packed_stripes, table_width, unpacked)

#: kernel launches made by :func:`fwd_scores` (reset by the caller), and
#: those of them on the block route (32 to 128 slots a lane) and on the
#: wide route (models over 4,096 slots)
launches = 0
launches_block = 0
launches_wide = 0

TINY = 1e-30


def forward(pb: ProfileBatch, seq: SeqDevice, rows, need, pairs=None):
    """Forward scores [P, n] in nats for the bucket rows ``rows`` [n]
    (int64) where ``need`` [P, n] is set (``pairs``: their list from
    ``_pairs.host_pairs``, on the device, if the caller has it)."""
    return fwd_scores(seq.codes, seq.lens, seq.lm, pb.fwd_emis,
                      pb.fwd_trans, rows, need, pairs)


def fwd_scores(codes, lens, lm, emis, trans, rows, need, pairs=None):
    """``codes`` [B, Lmax] uint8; ``lens`` [B] int32; ``lm`` [B, 4] f32
    length model; ``emis`` f32 (M, I) emission odds and ``trans`` f32
    transition odds, packed ([P, Kp, S, 32, 2] and [P, S, 2, 32, 4], or
    from ``S = FWD_WIDE_S`` on [P, Kp, 2, S, 32] and [P, 8, S, 32];
    past 4,096 slots the wide route's thread-major [P, Kp, SPT, W, 32,
    2] and [P, SPT, 2, W, 32, 4]: ``ops/batch.py``); ``rows`` [n]
    int64; ``need`` [P, n] bool; ``pairs`` None or the int32 [3,
    npairs] list of ``need``
    (``_pairs.host_pairs``).  Returns scores [P, n] f32 nats."""
    _pairs.check_packed(codes, lens, lm, emis, trans, FWD_WIDE_S,
                        _pairs.need_args(rows, need, emis.shape[0],
                                         pairs))
    if codes.device.type == "cpu":
        return fwd_plain(codes, lens, lm, emis, trans, rows, need)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    Kp, S = emis.shape[1], packed_stripes(trans)
    pair_p, pair_row, pair_out, out = _pairs.pairs(rows, need, pairs)
    npairs = int(pair_p.shape[0])
    P_ = _build.ptr
    if S == 0:                                # the wide route
        Mk = table_width(trans)
        nt, tier = cta_shape(Mk)
        nctas = _pairs.cta_grid(codes.device, npairs)
        # a scratch row a CTA only where the row fits neither registers
        # nor shared memory
        scratch = (torch.empty((nctas, 3, Mk), dtype=torch.float32,
                               device=codes.device)
                   if tier == "global" else None)
        err = _build.lib().fwd_cta_launch(
            P_(codes), codes.shape[1], P_(lens), P_(lm), P_(emis),
            P_(trans), P_(pair_p), P_(pair_row), P_(pair_out), npairs, Kp,
            Mk, nt, P_(out), None if scratch is None else P_(scratch),
            nctas, _build.stream_ptr(codes))
        _build.check(err, "fwd_cta_launch")
        _build.count_launch(globals(), "wide")
        return out
    err = _build.lib().fwd_launch(
        P_(codes), codes.shape[1], P_(lens), P_(lm), P_(emis), P_(trans),
        P_(pair_p), P_(pair_row), P_(pair_out), npairs, Kp, S, P_(out),
        _build.stream_ptr(codes))
    _build.check(err, "fwd_launch")
    _build.count_launch(globals(), "block" if S >= FWD_WIDE_S else None)
    return out


def fwd_plain(codes, lens, lm, emis, trans, rows, need):
    """The Forward scan of ``csrc/fwd.cu`` in plain PyTorch, batched over
    [P, n, Mk] with a loop over sequence rows; the D->D chain is a
    Hillis-Steele scan of affine maps."""
    dev = codes.device
    ems, eis, tr = unpacked(emis, trans)
    P, Kp, Mk = ems.shape
    n = rows.shape[0]
    out = torch.full((P, n), NEGMASS, dtype=torch.float32, device=dev)
    if n == 0 or not bool(need.any()):
        return out
    c = codes[rows]
    ln = lens[rows]
    loop = lm[rows, 0][None, :]
    move = lm[rows, 1][None, :]
    log_move = lm[rows, 3][None, :]
    t = [tr[:, k][:, None, :] for k in range(8)]          # [P, 1, Mk]
    levels = _pairs.dd_levels(t[7], Mk, torch.mul)
    zero = torch.zeros((P, n, Mk), dtype=torch.float32, device=dev)
    zcol = zero[..., :1]
    m, iv, d = zero, zero, zero
    xN = torch.ones((P, n), dtype=torch.float32, device=dev)
    xB = move.expand(P, n).clone()
    xJ = torch.zeros((P, n), dtype=torch.float32, device=dev)
    xC = xJ.clone()
    lsc = torch.zeros((P, n), dtype=torch.float64, device=dev)

    def shift(a):
        return torch.cat([zcol, a[..., :-1]], dim=-1)

    Lrun = int(ln[need.any(dim=0)].max())
    for i in range(Lrun):
        x = c[:, i].long()
        nm = ems[:, x, :] * (shift(m) * t[0] + shift(iv) * t[1]
                             + shift(d) * t[2] + xB[:, :, None] * t[3])
        ni = eis[:, x, :] * (m * t[4] + iv * t[5])
        bv = nm * t[6]
        for sh, A in levels:
            bv = torch.cat([bv[..., :sh],
                            bv[..., sh:] + bv[..., :-sh] * A[..., sh:]],
                           dim=-1)
        nd = shift(bv)
        e = nm.sum(dim=-1) + nd.sum(dim=-1)
        nj = xJ * loop + e * 0.5
        nc = xC * loop + e * 0.5
        nn = xN * loop
        nb = (nn + nj) * move
        mx = torch.maximum(torch.maximum(e, nj),
                           torch.maximum(nc, nn)).clamp(min=TINY)
        inv = 1.0 / mx
        valid = (ln > i)[None, :]
        v3 = valid[:, :, None]
        inv3 = inv[:, :, None]
        m = torch.where(v3, nm * inv3, m)
        iv = torch.where(v3, ni * inv3, iv)
        d = torch.where(v3, nd * inv3, d)
        # the log of the factor applied, summed in double (csrc/fwd.cu)
        lsc = torch.where(valid, lsc - torch.log(inv).double(), lsc)
        xJ = torch.where(valid, nj * inv, xJ)
        xC = torch.where(valid, nc * inv, xC)
        xN = torch.where(valid, nn * inv, xN)
        xB = torch.where(valid, nb * inv, xB)
    score = torch.where(xC > 0.0,
                        (lsc + torch.log(xC.clamp(min=TINY))
                         + log_move.double()).float(),
                        torch.full_like(xC, NEGMASS))
    return torch.where(need, score, out)
