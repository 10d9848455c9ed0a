"""The bias, Viterbi and Forward filter scores of many pairs at once, in
plain PyTorch (float64): the benchmark's reference.

The same recurrences as :mod:`hmmbench.reference.profile`'s
``Background.filter_score`` and :mod:`hmmbench.reference.dp`'s
``viterbi_score`` and ``forward`` (scores only), stepped over a batch
of (profile, sequence) pairs per residue row instead of one pair at a
time.  A batch's profiles are padded to its longest model; each pair's
own length model is set from its sequence's length, and a pair whose
sequence has ended keeps its state.  With the recurrences' precision set
to bfloat16 (``dp.set_precision``) every row is rounded to it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import dp
from .dp import NEGMASS


def _rnd(x: torch.Tensor) -> torch.Tensor:
    if dp._ROUND is None:
        return x
    return x.to(torch.bfloat16).to(torch.float64)


def _codes(seqs: Sequence[np.ndarray], device):
    L = np.array([len(s) for s in seqs], np.int64)
    codes = np.zeros((len(seqs), max(1, int(L.max()))), np.int64)
    for r, s in enumerate(seqs):
        codes[r, : len(s)] = s
    return (torch.as_tensor(codes, device=device),
            torch.as_tensor(L, device=device), L)


def bias_scores(odds: Sequence[np.ndarray], seqs: Sequence[np.ndarray],
                device) -> np.ndarray:
    """The bias filter's score (nats) of each pair: the state-1 odds
    table ``odds[b]`` [Kp] against sequence ``seqs[b]``."""
    codes, Lt, L = _codes(seqs, device)
    e1 = torch.as_tensor(np.stack(odds), device=device)      # [B, Kp]
    Ld = Lt.double()
    p1 = Ld / (Ld + 1.0)
    t00, t01 = p1, 1.0 - p1
    t11 = 50.0 / 51.0
    t10 = 1.0 - t11
    rows = torch.arange(len(seqs), device=device)
    a0 = torch.full_like(p1, 0.999)
    a1 = 0.001 * e1[rows, codes[:, 0]]
    logsc = torch.zeros_like(p1)
    for i in range(1, codes.shape[1]):
        active = Lt > i
        n0 = _rnd(a0 * t00 + a1 * t10)
        n1 = _rnd(a0 * t01 + a1 * t11)
        n1 = _rnd(n1 * e1[rows, codes[:, i]])
        s = n0 + n1
        resc = active & (s > 0) & ((s > 1e30) | (s < 1e-30))
        safe = torch.where(resc, s, torch.ones_like(s))
        n0, n1 = n0 / safe, n1 / safe
        logsc = logsc + torch.where(resc, torch.log(safe),
                                    torch.zeros_like(s))
        a0 = torch.where(active, n0, a0)
        a1 = torch.where(active, n1, a1)
    logsc = logsc + torch.log(a0 + a1)
    out = logsc + Ld * torch.log(p1) + torch.log(1.0 - p1)
    return out.cpu().numpy()


class _Tables:
    """The clamped score tables of profiles, padded to the longest model
    with scores of -inf (and D->D costs of 0, so a padded column adds
    nothing to the cost of a D run)."""

    def __init__(self, profs, device):
        self.M = M = max(p.M for p in profs)

        def t(name, cols, fill=NEGMASS):
            out = np.full((len(profs),) + cols, fill)
            for n, p in enumerate(profs):
                v = dp._clamp(getattr(p, name))
                out[(n,) + tuple(slice(0, d) for d in v.shape)] = v
            return torch.as_tensor(out, device=device)
        Kp = profs[0].msc.shape[0]
        self.msc = t("msc", (Kp, M + 1))                   # [P, Kp, M+1]
        self.isc = t("isc", (Kp, M + 1))
        for name in ("tBM", "tMM", "tIM", "tDM", "tMD"):
            setattr(self, name, t(name, (M,)))             # [P, M]
        self.tDD = t("tDD", (M,), fill=0.0)
        self.tMI, self.tII = t("tMI", (M + 1,)), t("tII", (M + 1,))
        self.xE = t("xE", (2,))                            # [P, 2]
        # c[k] = sum tDD[1..k-1]: the cost of a D run ending at node k
        c = torch.zeros((len(profs), M + 1), dtype=torch.float64,
                        device=device)
        c[:, 2:] = torch.cumsum(self.tDD[:, 1:M], dim=1)
        self.c = c
        # the columns 1..M of each profile
        k = torch.arange(M + 1, device=device)
        Ms = torch.as_tensor([p.M for p in profs], device=device)
        self.cols = (k[None, :] >= 1) & (k[None, :] <= Ms[:, None])


def _length_model(L: np.ndarray, nj: float, device):
    """Per-pair loop and move scores of N, C and J (``reconfig_length``)."""
    pmove = (2.0 + nj) / (L.astype(np.float64) + 2.0 + nj)
    loop = dp.rnd(np.log(1.0 - pmove))
    move = dp.rnd(np.log(pmove))
    return (torch.as_tensor(loop, device=device),
            torch.as_tensor(move, device=device))


def _dd_chain(new_m, tMD, c, M, logsum: bool):
    B = new_m.shape[0]
    a = torch.full((B, M + 1), NEGMASS, dtype=torch.float64,
                   device=new_m.device)
    a[:, 1:M] = new_m[:, 1:M] + tMD[:, 1:M] - c[:, 2:M + 1]
    if logsum:
        acc = torch.logcumsumexp(a[:, :M], dim=1)
    else:
        acc = torch.cummax(a[:, :M], dim=1).values
    D = torch.full_like(a, NEGMASS)
    D[:, 2:] = acc[:, 1:] + c[:, 2:]
    return torch.clamp(D, min=NEGMASS)


def _scores(profs, pidx: Sequence[int], seqs, device, forward: bool
            ) -> np.ndarray:
    T = _Tables(profs, device)
    M = T.M
    codes, Lt, L = _codes(seqs, device)
    loop, move = _length_model(L, profs[0].nj, device)
    pi = torch.as_tensor(np.asarray(pidx, np.int64), device=device)
    B = len(seqs)
    MM, IM, DM, BM = T.tMM[pi], T.tIM[pi], T.tDM[pi], T.tBM[pi]
    MI, II, MD = T.tMI[pi][:, 1:M], T.tII[pi][:, 1:M], T.tMD[pi]
    c, cols = T.c[pi], T.cols[pi]
    E0, E1 = T.xE[pi, 0], T.xE[pi, 1]
    neg = torch.full((B, M + 1), NEGMASS, dtype=torch.float64, device=device)
    mrow, irow, drow = neg.clone(), neg.clone(), neg.clone()
    xN = torch.zeros(B, dtype=torch.float64, device=device)
    xB = move.clone()
    xJ = torch.full_like(xN, NEGMASS)
    xC = torch.full_like(xN, NEGMASS)
    red = torch.logsumexp if forward else (
        lambda x, dim: torch.max(x, dim=dim).values)
    two = torch.logaddexp if forward else torch.maximum
    for i in range(codes.shape[1]):
        active = Lt > i
        x = codes[:, i]
        ms = T.msc[pi, x]                                   # [B, M+1]
        isc = T.isc[pi, x]
        src = torch.stack([mrow[:, :M] + MM, irow[:, :M] + IM,
                           drow[:, :M] + DM, xB[:, None] + BM])
        new_m = neg.clone()
        new_m[:, 1:] = ms[:, 1:] + red(src, dim=0)
        new_i = neg.clone()
        new_i[:, 1:M] = isc[:, 1:M] + two(mrow[:, 1:M] + MI,
                                          irow[:, 1:M] + II)
        new_m = torch.where(cols, _rnd(new_m), neg)
        new_i = torch.where(cols, _rnd(new_i), neg)
        new_d = torch.where(cols, _rnd(_dd_chain(new_m, MD, c, M, forward)),
                            neg)
        xE = _rnd(two(red(new_m[:, 1:], dim=1), red(new_d[:, 1:], dim=1)))
        nJ = _rnd(two(xJ + loop, xE + E0))
        nC = _rnd(two(xC + loop, xE + E1))
        nN = _rnd(xN + loop)
        nB = _rnd(two(nN + move, nJ + move))
        keep = active[:, None]
        mrow = torch.where(keep, new_m, mrow)
        irow = torch.where(keep, new_i, irow)
        drow = torch.where(keep, new_d, drow)
        xJ = torch.where(active, nJ, xJ)
        xC = torch.where(active, nC, xC)
        xN = torch.where(active, nN, xN)
        xB = torch.where(active, nB, xB)
    return (xC + move).cpu().numpy()


def viterbi_scores(profs, pidx, seqs, device) -> np.ndarray:
    """Viterbi filter scores (nats) of pairs (``profs[pidx[b]]``,
    ``seqs[b]``)."""
    return _scores(profs, pidx, seqs, device, forward=False)


def forward_scores(profs, pidx, seqs, device) -> np.ndarray:
    """Forward scores (nats) of the same pairs."""
    return _scores(profs, pidx, seqs, device, forward=True)


def batches(Ms: Sequence[int], Ls: Sequence[int], cells: int = 1 << 21
            ) -> List[List[int]]:
    """Indices of pairs with model lengths ``Ms`` and sequence lengths
    ``Ls`` in batches sorted by sequence length (so that a batch's rows
    end together), each at most ``cells`` (pairs x the batch's longest
    model) wide."""
    order = sorted(range(len(Ms)), key=lambda n: (Ls[n], Ms[n]))
    out, cur, width = [], [], 0
    for n in order:
        w = max(width, int(Ms[n]) + 1)
        if cur and w * (len(cur) + 1) > cells:
            out.append(cur)
            cur, w = [], int(Ms[n]) + 1
        cur.append(n)
        width = w
    if cur:
        out.append(cur)
    return out
