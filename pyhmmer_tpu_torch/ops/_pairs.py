"""Argument checks shared by the kernel wrappers, the (profile, target)
pair list of the Forward and Viterbi wrappers (``fwd_cuda.py``,
``vit_cuda.py``) and the D->D scan levels of their plain versions."""

from __future__ import annotations

import numpy as np
import torch

from .batch import (CTA_THREADS, NEGMASS, STRIPES, cta_shape,
                    msv_cta_shape, packed_stripes, stripe_width,
                    table_width)

#: CTAs a SM of the wide-route Forward and Viterbi grids (each walks over
#: pairs)
CTAS_PER_SM = 2


def wide_width(Mk: int) -> bool:
    """Whether ``Mk`` is a model width of the wide route: past the
    widest stripe, a multiple of ``CTA_THREADS``."""
    return Mk % CTA_THREADS == 0 and not stripe_width(Mk)


def cta_grid(device, npairs: int) -> int:
    """CTAs of a wide-route launch of ``npairs`` pairs: at most
    :data:`CTAS_PER_SM` a SM of ``device``, each with a scratch buffer
    of its own."""
    import torch.cuda
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(npairs, CTAS_PER_SM * sms))


def check_tensors(want: dict, table=None) -> None:
    """Raise unless every ``name: (tensor, dtype, shape or None)`` of
    ``want`` has that dtype and shape, lies on the first tensor's device
    and is contiguous, and ``table`` (if given) is an MSV table: striped
    [P, Kp, S, 32] at a compiled stripe width, or on the wide route
    thread-major [P, Kp, R, W, 32, 2] for the ``32 W`` threads
    ``batch.msv_cta_shape`` gives its width ``64 W R``."""
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
    if table is None:
        return
    if table.dim() == 6:
        r, nw = table.shape[2], table.shape[3]
        Mk = 64 * nw * r
        ok = (tuple(table.shape[4:]) == (32, 2) and wide_width(Mk)
              and msv_cta_shape(Mk)[0] == 32 * nw)
    else:
        ok = (table.dim() == 4 and table.shape[3] == 32
              and table.shape[2] in STRIPES)
    if not ok or table.shape[1] > 32:
        raise ValueError(f"unsupported table shape {tuple(table.shape)}")


def check_packed(codes, lens, lm, emis, trans, wide_s: int,
                 more: dict) -> None:
    """Raise on what the Forward, Viterbi and survivor-rows kernels do
    not take: ``emis`` [P, Kp, S, 32, 2] and ``trans`` [P, S, 2, 32, 4]
    for a compiled stripe width ``S`` below ``wide_s`` (the kernel's
    ``FWD_WIDE_S`` or ``VIT_WIDE_S``), from ``wide_s`` on the wide layout
    ``emis`` [P, Kp, 2, S, 32] and ``trans`` [P, 8, S, 32]
    (``ops/batch.py``: the kernel picks the layout from ``S``, so a table
    in the other one would be misread), and past the widest stripe the
    wide route's thread-major ``emis`` [P, Kp, SPT, W, 32, 2] and
    ``trans`` [P, SPT, 2, W, 32, 4] (``32 W`` the threads
    ``batch.cta_shape`` gives the width);
    ``more``, the caller's other arguments as :func:`check_tensors`
    takes them."""
    B, _ = codes.shape
    P, Kp = emis.shape[:2]
    if trans.dim() == 6:
        spt, nw = trans.shape[1], trans.shape[3]
        Mk = table_width(trans)
        if (not wide_width(Mk) or cta_shape(Mk)[0] != 32 * nw
                or Kp > 32):
            raise ValueError(f"unsupported table shape {tuple(emis.shape)}")
        shapes = (P, Kp, spt, nw, 32, 2), (P, spt, 2, nw, 32, 4)
    else:
        S = packed_stripes(trans)
        if S not in STRIPES or Kp > 32 or trans.dim() not in (4, 5):
            raise ValueError(
                f"unsupported table shape {tuple(emis.shape)}")
        wide = S >= wide_s
        if (trans.dim() == 4) != wide:
            raise ValueError(
                f"tables at {S} slots a lane must take the "
                f"{'wide' if wide else 'packed'} layout (wide from "
                f"{wide_s})")
        shapes = (((P, Kp, 2, S, 32), (P, 8, S, 32)) if wide
                  else ((P, Kp, S, 32, 2), (P, S, 2, 32, 4)))
    check_tensors({"codes": (codes, torch.uint8, None),
                   "lens": (lens, torch.int32, (B,)),
                   "lm": (lm, torch.float32, (B, 4)),
                   "emis": (emis, torch.float32, shapes[0]),
                   "trans": (trans, torch.float32, shapes[1]),
                   **more})


def need_args(rows, need, P: int, pairs=None) -> dict:
    """The Forward and Viterbi wrappers' column arguments for
    :func:`check_packed`: ``rows`` int64 [n], ``need`` bool [P, n] and
    ``pairs``, if given, an int32 [3, npairs] list (:func:`host_pairs`)."""
    n = rows.shape[0]
    want = {"rows": (rows, torch.int64, (n,)),
            "need": (need, torch.bool, (P, n))}
    if pairs is not None:
        want["pairs"] = (pairs, torch.int32, (3, pairs.shape[-1]))
    return want


def host_pairs(rows: np.ndarray, need: np.ndarray) -> np.ndarray:
    """The pair list of :func:`pairs` built on the host from numpy
    ``rows`` [n] and ``need`` [P, n]: int32 [3, npairs] holding each
    needed pair's profile, bucket row and output offset (``p * n +
    column``), in the order ``need.nonzero()`` gives."""
    n = need.shape[1]
    pp, col = np.nonzero(need)
    return np.stack([pp, np.asarray(rows)[col], pp * n + col]).astype(
        np.int32)


def pairs(rows, need, given=None):
    """Flat pair arrays for the kernels: profile, bucket row and output
    offset (``p * n + column``) of every needed pair, int32 on the
    device, plus a NEGMASS-filled output [P, n].  ``given`` is the list
    of :func:`host_pairs` already on the device; without it the list is
    built from ``need.nonzero()``, which synchronises with the device."""
    P, n = need.shape
    if given is None:
        pc = need.nonzero()
        given = torch.stack([pc[:, 0], rows[pc[:, 1]],
                             pc[:, 0] * n + pc[:, 1]]).to(torch.int32)
    out = torch.full((P, n), NEGMASS, dtype=torch.float32,
                     device=need.device)
    return given[0], given[1], given[2], out


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
