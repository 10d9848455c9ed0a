"""Argument checks shared by the kernel wrappers, the (profile, target)
pair list of the Forward and Viterbi wrappers (``fwd_cuda.py``,
``vit_cuda.py``) and the D->D scan levels of their plain versions."""

from __future__ import annotations

import torch

from .batch import FWD_WIDE_S, NEGMASS, STRIPES, fwd_stripes


def check_tensors(want: dict, table=None) -> None:
    """Raise unless every ``name: (tensor, dtype, shape or None)`` of
    ``want`` has that dtype and shape, lies on the first tensor's device
    and is contiguous, and the striped [P, Kp, S, 32] ``table`` (if
    given) has a compiled stripe width."""
    device = next(iter(want.values()))[0].device
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table is not None and (table.dim() != 4 or table.shape[3] != 32
            or table.shape[2] not in STRIPES or table.shape[1] > 32):
        raise ValueError(f"unsupported table shape {tuple(table.shape)}")


def check(codes, lens, lm, emis_m, emis_i, tr, rows, need):
    """Raise on what the Forward/Viterbi kernels do not take."""
    B, _ = codes.shape
    P, Kp, S, _ = emis_m.shape
    n = rows.shape[0]
    check_tensors({"codes": (codes, torch.uint8, None),
                   "lens": (lens, torch.int32, (B,)),
                   "lm": (lm, torch.float32, (B, 4)),
                   "emis_m": (emis_m, torch.float32, None),
                   "emis_i": (emis_i, torch.float32, (P, Kp, S, 32)),
                   "tr": (tr, torch.float32, (P, 8, S, 32)),
                   "rows": (rows, torch.int64, (n,)),
                   "need": (need, torch.bool, (P, n))}, emis_m)


def check_fwd(codes, lens, lm, emis, trans, rows, need):
    """Raise on what the Forward kernel does not take: ``emis`` [P, Kp, S,
    32, 2] and ``trans`` [P, S, 2, 32, 4] for a compiled stripe width
    ``S``, or from ``S = FWD_WIDE_S`` on ``emis`` [P, Kp, 2, S, 32] and
    ``trans`` [P, 8, S, 32] (``ops/batch.py``)."""
    B, _ = codes.shape
    P, Kp = emis.shape[:2]
    S = fwd_stripes(trans)
    wide = S >= FWD_WIDE_S
    if S not in STRIPES or Kp > 32 or trans.dim() != (4 if wide else 5):
        raise ValueError(f"unsupported table shape {tuple(emis.shape)}")
    n = rows.shape[0]
    check_tensors({"codes": (codes, torch.uint8, None),
                   "lens": (lens, torch.int32, (B,)),
                   "lm": (lm, torch.float32, (B, 4)),
                   "emis": (emis, torch.float32,
                            (P, Kp, 2, S, 32) if wide else (P, Kp, S, 32, 2)),
                   "trans": (trans, torch.float32,
                             (P, 8, S, 32) if wide else (P, S, 2, 32, 4)),
                   "rows": (rows, torch.int64, (n,)),
                   "need": (need, torch.bool, (P, n))})


def pairs(rows, need):
    """Flat pair arrays for the kernels: profile, bucket row and output
    offset (``p * n + column``) of every needed pair, int32 on the
    device, plus a NEGMASS-filled output [P, n]."""
    P, n = need.shape
    pc = need.nonzero()
    pair_p = pc[:, 0].to(torch.int32).contiguous()
    pair_row = rows[pc[:, 1]].to(torch.int32).contiguous()
    pair_out = (pc[:, 0] * n + pc[:, 1]).to(torch.int32).contiguous()
    out = torch.full((P, n), NEGMASS, dtype=torch.float32,
                     device=need.device)
    return pair_p, pair_row, pair_out, out


def dd_levels(step, Mk: int, combine):
    """The per-level transfer terms of a Hillis-Steele scan of the D->D
    chain: ``step`` [P, 1, Mk] holds each slot's D->D term; level ``sh``
    composes windows of ``sh`` slots.  ``combine`` is ``+`` (max-plus)
    or ``*`` (odds)."""
    levels, A, sh = [], step, 1
    while sh < Mk:
        levels.append((sh, A))
        A = torch.cat([A[..., :sh], combine(A[..., sh:], A[..., :-sh])],
                      dim=-1)
        sh *= 2
    return levels
