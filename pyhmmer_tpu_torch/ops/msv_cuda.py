"""Stage 1: the MSV filter with the bias filter fused in.

:func:`msv_scores` runs ``csrc/msv.cu`` on a CUDA tensor and
:func:`msv_plain`, the same function in plain PyTorch, on a CPU tensor.
It replaces the TPU kernels ``pyhmmer_tpu/ops/msv_pallas.py``
(``_msv_pallas2`` and ``_msv_pallas``).  Outputs, each [P, B] f32:
``dx = xJ - 190`` (exact integers), ``ovf`` (1 where the uint8 DP would
have saturated) and ``biaslog`` (the bias filter's log score without the
null term), with the same meaning as the Pallas outputs.  The kernel
keeps its cells in 16 bits: ``ovf`` is the plain version's everywhere and
``dx`` on every pair it does not flag (a flagged pair's ``dx`` is
ignored by the engine; see the note in ``csrc/msv.cu``).  A model wider
than 4,096 slots (a thread-major [P, Kp, R, W, 32, 2] ``w16``) takes the
wide route, ``msv_cta_kernel``, with the same cells and the same
contract.
"""

from __future__ import annotations

import torch

from . import _build, _pairs
from .batch import ProfileBatch, SeqDevice, msv_thread_minor, unstriped

#: kernel launches made by :func:`msv_scores` (reset by the caller), and
#: those of them on the wide route
launches = 0
launches_wide = 0

BASE = 190.0
T11 = 50.0 / 51.0
T10 = 1.0 / 51.0
RENORM = 8


def msv(pb: ProfileBatch, seq: SeqDevice):
    """(dx, ovf, biaslog) [P, B] for every profile of ``pb`` against
    every target of ``seq``."""
    return msv_scores(seq.codes, seq.lens, pb.msv_w16, pb.msv_scal,
                      pb.msv_odds, seq.tjb, seq.p1)


def _check(codes, lens, w16, scal, odds, tjb, p1):
    B = codes.shape[0]
    P, Kp = w16.shape[:2]
    _pairs.check_tensors({"codes": (codes, torch.uint8, None),
                          "lens": (lens, torch.int32, (B,)),
                          "w16": (w16, torch.int16, None),
                          "scal": (scal, torch.float32, (P, 4)),
                          "odds": (odds, torch.float32, (P, Kp)),
                          "tjb": (tjb, torch.float32, (B,)),
                          "p1": (p1, torch.float32, (B,))}, w16)


def msv_scores(codes, lens, w16, scal, odds, tjb, p1):
    """``codes`` [B, Lmax] uint8; ``lens`` [B] int32; ``w16`` [P, Kp, S,
    32] int16 pre-biased quantized costs ``bias - cost``, striped (cost
    255 in padding), or thread-major [P, Kp, R, W, 32, 2] on the wide
    route (``batch.msv_thread_major``); ``scal`` [P, 4] (bias, tec, tbm,
    -); ``odds`` [P, Kp]
    bias-filter odds (0 at the nonresidue code); ``tjb``, ``p1`` [B] f32.
    Returns (dx, ovf, biaslog) [P, B]."""
    _check(codes, lens, w16, scal, odds, tjb, p1)
    if codes.device.type == "cpu":
        return msv_plain(codes, lens, w16, scal, odds, tjb, p1)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    B, Lmax = codes.shape
    P, Kp = w16.shape[:2]
    dx = torch.empty((P, B), dtype=torch.float32, device=codes.device)
    ovf = torch.empty_like(dx)
    biaslog = torch.empty_like(dx)
    P_ = _build.ptr
    wide = w16.dim() == 6
    if wide:
        err = _build.lib().msv_cta_launch(
            P_(codes), Lmax, P_(lens), P_(w16), P_(scal), P_(odds),
            P_(tjb), P_(p1), B, P, Kp, 64 * w16.shape[2] * w16.shape[3],
            P_(dx), P_(ovf), P_(biaslog), _build.stream_ptr(codes))
        _build.check(err, "msv_cta_launch")
    else:
        err = _build.lib().msv_launch(
            P_(codes), Lmax, P_(lens), P_(w16), P_(scal), P_(odds),
            P_(tjb), P_(p1), B, P, Kp, w16.shape[2], P_(dx), P_(ovf),
            P_(biaslog), _build.stream_ptr(codes))
        _build.check(err, "msv_launch")
    _build.count_launch(globals(), "wide" if wide else None)
    return dx, ovf, biaslog


def msv_plain(codes, lens, w16, scal, odds, tjb, p1):
    """The MSV + bias scan of ``csrc/msv.cu`` in plain PyTorch, batched
    over [P, B, Mk] with a loop over sequence rows (integer-valued f32,
    exact, no 16-bit limit)."""
    dev = codes.device
    B = codes.shape[0]
    w = (msv_thread_minor(w16) if w16.dim() == 6
         else unstriped(w16)).to(torch.float32)
    P, Kp, Mk = w.shape
    bias = scal[:, 0:1]                           # [P, 1]
    tec = scal[:, 1:2]
    tbm = scal[:, 2:3]
    tjb_r = tjb[None, :]                          # [1, B]
    m = torch.zeros((P, B, Mk), dtype=torch.float32, device=dev)
    xJ = torch.zeros((P, B), dtype=torch.float32, device=dev)
    xB = (BASE - tjb_r).clamp(min=0.0).expand(P, B).clone()
    t00 = p1[None, :]
    t01 = 1.0 - t00
    a0 = torch.ones((P, B), dtype=torch.float32, device=dev)
    a1 = torch.zeros_like(a0)
    lsc = torch.zeros_like(a0)
    started = torch.zeros((P, B), dtype=torch.bool, device=dev)
    Lrun = int(lens.max()) if B else 0
    for i in range(Lrun):
        x = codes[:, i].long()
        valid = (lens > i)[None, :]               # [1, B]
        c = w[:, x, :]                            # [P, B, Mk]
        xBv = (xB - tbm).clamp(min=0.0)
        prev = torch.cat([xBv[:, :, None],
                          torch.maximum(m[:, :, :-1], xBv[:, :, None])],
                         dim=2)
        sv = (prev + c).clamp(min=0.0)
        xE = sv.amax(dim=2)
        nxJ = torch.maximum(xJ, xE - tec)
        nxB = torch.clamp(nxJ, min=BASE) - tjb_r
        m = torch.where(valid[:, :, None], sv, m)
        xJ = torch.where(valid, nxJ, xJ)
        xB = torch.where(valid, nxB, xB)

        ov = odds[:, x]                           # [P, B]
        upd = (ov > 0.0) & valid
        first = upd & ~started
        na0 = torch.where(first, a0 * 0.999, a0 * t00 + a1 * T10)
        na1 = torch.where(first, a0 * 0.001, a0 * t01 + a1 * T11) * ov
        a0 = torch.where(upd, na0, a0)
        a1 = torch.where(upd, na1, a1)
        started = started | upd
        if (i + 1) % RENORM == 0:
            s = a0 + a1
            inv = 1.0 / s
            lsc = torch.where(valid, lsc + torch.log(s), lsc)
            a0 = torch.where(valid, a0 * inv, a0)
            a1 = torch.where(valid, a1 * inv, a1)
    dx = xJ - BASE
    ovf = (xJ >= 255.0 - bias - tec).to(torch.float32)
    biaslog = lsc + torch.log(a0 + a1)
    return dx, ovf, biaslog
