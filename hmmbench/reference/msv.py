"""The uint8 MSV filter of many (profile, sequence) pairs at once, in plain
PyTorch: the benchmark's reference.

The same integer recurrence as :func:`hmmbench.reference.dp.
msv_score_quantized` (HMMER's ``p7_MSVFilter`` semantics: 1/3-bit
units, a saturating bias, the loop costs restored as -3 nats), stepped
over a stack of profiles and a chunk of sequences per row instead of one
pair at a time.  Integer arithmetic, so it equals the per-pair version
exactly; the tests hold it to that.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .dp import quantize_msv


def msv_scores(profiles: Sequence, seqs: Sequence[np.ndarray], device,
               cells: int = 1 << 23) -> np.ndarray:
    """MSV scores in nats [P, B] of every profile against every sequence
    (``inf`` where the uint8 recurrence overflowed)."""
    qs = [quantize_msv(p) for p in profiles]
    P, B = len(qs), len(seqs)
    Mmax = max(q.M for q in qs)
    Kp = qs[0].cost.shape[0]
    cost = np.full((P, Kp, Mmax), 255, np.int32)
    for p, q in enumerate(qs):
        cost[p, :, : q.M] = q.cost
    scale = qs[0].scale_b
    cost = torch.as_tensor(cost, device=device)
    bias = torch.as_tensor([q.bias_b for q in qs], device=device)[:, None]
    base = torch.as_tensor([q.base_b for q in qs], device=device)[:, None]
    tec = torch.as_tensor([q.tec_b for q in qs], device=device)[:, None]
    tbm = torch.as_tensor([q.tbm_b for q in qs], device=device)[:, None]
    lens = np.array([len(s) for s in seqs], np.int64)
    out = np.empty((P, B), np.float64)
    order = np.argsort(lens, kind="stable")
    # lanes of similar length together, at most ``cells`` cells a row
    chunk = max(1, cells // (P * Mmax))
    for c0 in range(0, B, chunk):
        idx = order[c0: c0 + chunk]
        Lc = lens[idx]
        Lmax = int(Lc.max())
        codes = np.zeros((len(idx), Lmax), np.int64)
        for r, s in enumerate(idx):
            codes[r, : Lc[r]] = seqs[s]
        codes = torch.as_tensor(codes, device=device)
        Lt = torch.as_tensor(Lc, device=device)
        tjb = torch.as_tensor(qs[0].tjb_b(Lc).astype(np.int64),
                              device=device)[None, :]
        xJ = torch.zeros((P, len(idx)), dtype=torch.int64, device=device)
        xB = torch.clamp(base - tjb, min=0)
        mpv = torch.zeros((P, len(idx), Mmax), dtype=torch.int64,
                          device=device)
        ovf = torch.zeros((P, len(idx)), dtype=torch.bool, device=device)
        for i in range(Lmax):
            active = (Lt > i)[None, :]
            xBv = torch.clamp(xB - tbm, min=0)
            sv = torch.empty_like(mpv)
            sv[..., 0] = xBv
            sv[..., 1:] = torch.maximum(mpv[..., :-1], xBv[..., None])
            sv = torch.clamp(sv + bias[..., None], max=255)
            sv = torch.clamp(sv - cost[:, codes[:, i], :], min=0)
            xE = sv.max(dim=-1).values
            ovf |= active & (xE >= 255 - bias)
            xJ = torch.where(active, torch.maximum(xJ, xE - tec), xJ)
            xB = torch.where(active, torch.maximum(base, xJ) - tjb, xB)
            mpv = sv
        usc = ((xJ - tjb - base).double() / scale - 3.0).cpu().numpy()
        usc[ovf.cpu().numpy()] = np.inf
        out[:, idx] = usc
    return out
