"""Posterior-heuristic domain definition, in plain NumPy: the
benchmark's reference.

A frozen copy of ``pyhmmer_tpu_torch/plan7/domaindef.py`` (its NumPy
path: regions from the special-state posteriors, isolated regions
rescored in unihit mode with a null2 by expectation and an optimal
accuracy alignment, multidomain regions resolved by stochastic traceback
clustering) and of the vectorized trace sampler of
``plan7/ensemble.py``, without the program's native library.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from . import dp as ref
from .dp import NEGMASS

RT1 = 0.25
RT2 = 0.10
RT3 = 0.20


class Trace:
    """A state path: ``states`` (N, B, M, I, D, E, C, J, S, T), ``k`` the
    model node (0 if none), ``i`` the residue 1..L (0 if silent), ``pp``
    the posterior of each emission."""

    def __init__(self):
        self.states, self.k, self.i, self.pp = [], [], [], []

    def append(self, s: str, k: int = 0, i: int = 0, pp: float = 0.0):
        self.states.append(s)
        self.k.append(k)
        self.i.append(i)
        self.pp.append(pp)

    def reverse(self):
        self.states.reverse()
        self.k.reverse()
        self.i.reverse()
        self.pp.reverse()

    def offset_i(self, delta: int):
        self.i = [i + delta if i > 0 else 0 for i in self.i]


def optimal_accuracy(prof, pp: dict, L: int) -> Tuple[float, np.ndarray]:
    Mn = prof.M
    ppM, ppI = pp["M"], pp["I"]
    ppN, ppJ, ppC = pp["N"], pp["J"], pp["C"]

    def gate(tsc):
        return np.where(tsc > NEGMASS / 2, 0.0, NEGMASS)

    gMM, gIM, gDM = gate(ref._clamp(prof.tMM)), gate(ref._clamp(prof.tIM)), gate(ref._clamp(prof.tDM))
    gMD, gDD = gate(ref._clamp(prof.tMD)), gate(ref._clamp(prof.tDD))
    gMI, gII = gate(ref._clamp(prof.tMI)), gate(ref._clamp(prof.tII))
    gBM = gate(ref._clamp(prof.tBM))
    eJ_ok = ref._clamp(prof.xE)[0] > NEGMASS / 2   # multihit?

    Mx = np.full((L + 1, Mn + 1), NEGMASS)
    Ix = np.full((L + 1, Mn + 1), NEGMASS)
    Dx = np.full((L + 1, Mn + 1), NEGMASS)
    xN = np.full(L + 1, NEGMASS)
    xB = np.full(L + 1, NEGMASS)
    xE = np.full(L + 1, NEGMASS)
    xJ = np.full(L + 1, NEGMASS)
    xC = np.full(L + 1, NEGMASS)
    xN[0] = 0.0
    xB[0] = 0.0
    for i in range(1, L + 1):
        Mx[i, 1:] = ppM[i, 1:] + np.maximum.reduce([
            Mx[i - 1, :Mn] + gMM,
            Ix[i - 1, :Mn] + gIM,
            Dx[i - 1, :Mn] + gDM,
            xB[i - 1] + gBM,
        ])
        Ix[i, 1:Mn] = ppI[i, 1:Mn] + np.maximum(
            Mx[i - 1, 1:Mn] + gMI[1:Mn],
            Ix[i - 1, 1:Mn] + gII[1:Mn],
        )
        # DD chain (max-plus prefix scan over gated transitions)
        a = np.full(Mn + 1, NEGMASS)
        c = np.zeros(Mn + 1)
        c[2:] = np.cumsum(gDD[1:Mn])
        a[1:Mn] = Mx[i, 1:Mn] + gMD[1:Mn] - c[2:Mn + 1]
        acc = np.maximum.accumulate(a[:Mn])
        Dx[i, 2:] = np.maximum(acc[1:] + c[2:], NEGMASS)
        xE[i] = max(Mx[i, 1:].max(), Dx[i, Mn])
        xJ[i] = max(xJ[i - 1] + ppJ[i], xE[i] if eJ_ok else NEGMASS)
        xC[i] = max(xC[i - 1] + ppC[i], xE[i])
        xN[i] = xN[i - 1] + ppN[i]
        xB[i] = max(xN[i], xJ[i])
    oasc = xC[L]
    return oasc, dict(M=Mx, I=Ix, D=Dx, N=xN, B=xB, E=xE, J=xJ, C=xC)


def oa_traceback(prof, pp: dict, dp: dict, L: int) -> Trace:
    """Traceback of the optimal accuracy DP (``p7_OATrace``)."""
    Mn = prof.M
    Mx, Ix, Dx = dp["M"], dp["I"], dp["D"]
    xN, xB, xE, xJ, xC = dp["N"], dp["B"], dp["E"], dp["J"], dp["C"]
    ppM, ppI = pp["M"], pp["I"]
    ppN, ppJ, ppC = pp["N"], pp["J"], pp["C"]
    eJ_ok = ref._clamp(prof.xE)[0] > NEGMASS / 2

    def close(a, b):
        return abs(a - b) < 1e-7 * max(1.0, abs(b)) + 1e-9

    tr = Trace()
    i, k, state = L, 0, "C"
    tr.append("T")
    tr.append("C", 0, 0, 0.0)
    while not (state == "N" and i == 0):
        if state == "C":
            if i > 0 and close(xC[i], xC[i - 1] + ppC[i]):
                tr.append("C", 0, i, ppC[i])  # C emits residue i on loop
                i -= 1
            else:
                state = "E"
                tr.append("E")
        elif state == "E":
            # E reached from best M(i,k) or D(i,M); ties prefer M so the
            # alignment does not grow a mute all-delete tail
            if close(xE[i], Dx[i, Mn]) and Dx[i, Mn] > Mx[i, 1:].max() + 1e-9:
                state, k = "D", Mn
                tr.append("D", Mn, 0, 0.0)
            else:
                k = int(np.argmax(Mx[i, 1:])) + 1
                state = "M"
                tr.append("M", k, i, ppM[i, k])
        elif state == "M":
            # who fed M(i,k)? value = ppM[i,k] + max(...)
            v = Mx[i, k] - ppM[i, k]
            pm, pi_, pd = Mx[i - 1, k - 1], Ix[i - 1, k - 1], Dx[i - 1, k - 1]
            pb = xB[i - 1]
            i -= 1
            if close(v, pb):
                state = "B"
                tr.append("B")
            elif close(v, pm):
                state, k = "M", k - 1
                tr.append("M", k, i, ppM[i, k])
            elif close(v, pd):
                state, k = "D", k - 1
                tr.append("D", k, 0, 0.0)
            elif close(v, pi_):
                state, k = "I", k - 1
                tr.append("I", k, i, ppI[i, k])
            else:  # fall back: B entry
                state = "B"
                tr.append("B")
        elif state == "D":
            if k >= 2 and close(Dx[i, k], Dx[i, k - 1]):
                k -= 1
                tr.append("D", k, 0, 0.0)
            else:
                k -= 1
                state = "M"
                tr.append("M", k, i, ppM[i, k])
        elif state == "I":
            if close(Ix[i, k], ppI[i, k] + Ix[i - 1, k]):
                # note: Ix[i,k] value already includes pp; compare sources
                pass
            v = Ix[i, k] - ppI[i, k]
            pm, pi_ = Mx[i - 1, k], Ix[i - 1, k]
            i -= 1
            if close(v, pm):
                state = "M"
                tr.append("M", k, i, ppM[i, k])
            else:
                tr.append("I", k, i, ppI[i, k])
        elif state == "B":
            if eJ_ok and close(xB[i], xJ[i]) and xJ[i] > xN[i] - 1e-12:
                state = "J"
                tr.append("J", 0, 0, 0.0)
            else:
                state = "N"
                tr.append("N", 0, 0, 0.0)
        elif state == "J":
            if i > 0 and close(xJ[i], xJ[i - 1] + ppJ[i]):
                tr.append("J", 0, i, ppJ[i])
                i -= 1
            else:
                state = "E"
                tr.append("E")
        elif state == "N":
            if i > 0:
                tr.append("N", 0, i, ppN[i])
                i -= 1
            else:
                break
        else:
            raise RuntimeError(f"bad state {state}")
    tr.append("S")
    tr.reverse()
    return tr


# ---------------------------------------------------------------------------
# null2 bias correction
# ---------------------------------------------------------------------------

def null2_by_expectation(prof, pp: dict, L: int,
                         emitters_only: bool = False) -> np.ndarray:
    """Posterior-weighted null2 odds ratios per residue code
    (``p7_GNull2_ByExpectation`` semantics).  Returns ``null2[Kp]``.

    ``emitters_only=True`` weights by model-emitting states only (M/I),
    excluding the N/C/J flank mass -- the behavior of the trace-ensemble
    null2 used for clustered regions (``p7_Null2_ByTrace`` averaged over
    samples only counts states on the sampled domain paths).
    """
    K = prof.alphabet.K
    Kp = prof.alphabet.Kp
    wM = pp["M"][1:].sum(axis=0)           # [M+1]
    wI = pp["I"][1:].sum(axis=0)
    wX = pp["N"][1:].sum() + pp["J"][1:].sum() + pp["C"][1:].sum()
    # odds-ratio emissions: match exp(msc), insert exp(isc) (=1), specials 1
    odds_m = np.exp(np.maximum(prof.msc[:K, :], NEGMASS))   # [K, M+1]
    odds_i = np.exp(np.maximum(prof.isc[:K, :], NEGMASS))
    null2 = np.zeros(Kp)
    if emitters_only:
        total = wM.sum() + wI.sum()
        if total <= 0:
            null2[:] = 1.0
            return null2
        null2[:K] = (odds_m @ wM + odds_i @ wI) / total
    else:
        total = float(L)
        null2[:K] = (odds_m @ wM + odds_i @ wI + wX) / total
    # degeneracies: simple average of member odds; gap/nonres/missing = 1
    for code in range(K + 1, Kp - 2):
        members = prof.alphabet.degen[code]
        null2[code] = null2[:K][members].mean()
    null2[K] = null2[Kp - 2] = null2[Kp - 1] = 1.0
    return null2


# ---------------------------------------------------------------------------
# domain definition driver
# ---------------------------------------------------------------------------

@dataclass
class DomainEnvelope:
    ienv: int
    jenv: int
    envsc: float            # nats
    domcorrection: float    # nats
    oasc: float
    trace: Trace
    # alignment coordinates derived from the trace
    iali: int = 0
    jali: int = 0
    hmmfrom: int = 0
    hmmto: int = 0


@dataclass
class DomainDefResult:
    domains: List[DomainEnvelope]
    nexpected: float
    nregions: int
    nclustered: int
    noverlaps: int
    nenvelopes: int
    n2sc: np.ndarray   # [L+1] per-residue null2 scores (nats)


def _ali_bounds(tr: Trace):
    """First/last M-state emission in the trace."""
    iali = jali = hmmfrom = hmmto = 0
    for s, k, i in zip(tr.states, tr.k, tr.i):
        if s == "M":
            if iali == 0:
                iali, hmmfrom = i, k
            jali, hmmto = i, k
    return iali, jali, hmmfrom, hmmto


def rescore_isolated_domain(prof_uni, dsq: np.ndarray, i: int, j: int,
                            do_null2: bool, n2sc: np.ndarray,
                            null2_is_done: bool = False
                            ) -> Optional[DomainEnvelope]:
    """Rescore the window ``[i..j]`` (1-based, inclusive) in isolation
    (``rescore_isolated_domain``): unihit Forward/Backward + posterior
    decoding + null2 + optimal accuracy alignment."""
    window = dsq[i - 1: j]
    Ld = j - i + 1
    fwd = ref.forward(prof_uni, window, keep_matrix=True)
    bck = ref.backward(prof_uni, window, keep_matrix=True)
    pp = ref.posterior_matrices(fwd, bck, prof_uni, window)

    domcorrection = 0.0
    if do_null2 and not null2_is_done:
        null2 = null2_by_expectation(prof_uni, pp, Ld)
        with np.errstate(divide="ignore"):
            sc = np.log(null2[dsq[i - 1: j]])
        n2sc[i: j + 1] = sc
    if do_null2:
        domcorrection = float(n2sc[i: j + 1].sum())

    oasc, dp = optimal_accuracy(prof_uni, pp, Ld)
    tr = oa_traceback(prof_uni, pp, dp, Ld)
    tr.offset_i(i - 1)
    dom = DomainEnvelope(ienv=i, jenv=j, envsc=float(fwd.score),
                         domcorrection=domcorrection, oasc=float(oasc),
                         trace=tr)
    dom.iali, dom.jali, dom.hmmfrom, dom.hmmto = _ali_bounds(tr)
    if dom.iali == 0:
        return None   # empty alignment; reject (mirrors tr->ndom == 0 check)
    return dom


def region_trace_ensemble(prof_multi, prof_uni, dsq, i: int, j: int,
                          rng: np.random.Generator, nsamples: int = 200
                          ) -> List[Tuple[int, int]]:
    """Resolve a multi-domain region into envelopes by stochastic traceback
    clustering (``region_trace_ensemble`` + ``P7_SPENSEMBLE`` semantics).

    Samples ``nsamples`` paths from the Forward matrix of the region
    (multihit, L=Ld length model as HMMER reconfigures for sampling), pools
    the sampled domain spans, single-linkage clusters them by endpoint
    overlap, and returns consensus envelopes.
    """
    window = dsq[i - 1: j]
    Ld = j - i + 1
    prof = prof_multi.copy()
    prof.reconfig_length(Ld)
    fwd = ref.forward(prof, window, keep_matrix=True)

    spans: List[Tuple[int, int]] = []       # (start, end) in window coords
    span_sample: List[int] = []             # which sample produced it
    K = prof.alphabet.K
    odds_m = np.exp(np.maximum(prof.msc[:K, :], NEGMASS))   # [K, M+1]
    odds_i = np.exp(np.maximum(prof.isc[:K, :], NEGMASS))
    # per-position null2 log-odds, averaged over the sampled ensemble:
    # each sampled domain contributes its own uniform-usage null2 over its
    # span (p7_Null2_ByTrace per domain, averaged over samples)
    n2acc = np.zeros(Ld + 2)
    all_spans = sample_traces(prof, fwd, window, rng, nsamples)
    for s_idx, sample in enumerate(all_spans):
        for (a, b, uM, uI) in sample:
            spans.append((a, b))
            span_sample.append(s_idx)
            tot = uM.sum() + uI.sum()
            if tot == 0:
                continue
            null2_t = (odds_m @ uM + odds_i @ uI) / tot
            xs = np.minimum(window[a - 1: b], K - 1)
            # degenerate/nonresidue codes contribute odds 1 (log 0)
            valid = window[a - 1: b] < K
            contrib = np.where(
                valid, np.log(np.maximum(null2_t[xs], 1e-30)), 0.0)
            n2acc[a: b + 1] += contrib
    n2_region = n2acc / nsamples
    if not spans:
        return [(i, j)], n2_region

    # single-linkage clustering by fractional overlap >= min_overlap of the
    # smaller segment (p7_spensemble_Cluster(sp, 0.8, TRUE, 64, 0.25, 0.02)).
    # Sampled spans repeat heavily across the ensemble, so linkage runs on
    # the deduplicated spans (weighted by multiplicity).
    min_overlap = 0.8
    min_posterior = 0.25
    min_endpointp = 0.02
    uniq: dict = {}
    samples_of: dict = {}
    for sp, s_idx in zip(spans, span_sample):
        uniq[sp] = uniq.get(sp, 0) + 1
        samples_of.setdefault(sp, set()).add(s_idx)
    uspans = sorted(uniq)
    n = len(uspans)
    # single-linkage = connected components of the pairwise-overlap graph;
    # built fully vectorized (n is a few thousand at most) and labeled in C
    # via scipy instead of a per-pair Python union-find
    clusters: dict = {}
    if n:
        a = np.array([s[0] for s in uspans])
        b = np.array([s[1] for s in uspans])
        ln = b - a + 1
        ov = (np.minimum(b[:, None], b[None, :])
              - np.maximum(a[:, None], a[None, :]) + 1)
        linked = (ov > 0) & (ov >= min_overlap * np.minimum(ln[:, None],
                                                            ln[None, :]))
        _, labels = connected_components(csr_matrix(linked), directed=False)
        for t in range(n):
            clusters.setdefault(int(labels[t]), []).append(t)

    envs: List[Tuple[int, int]] = []
    for members in clusters.values():
        # cluster posterior = fraction of samples containing this domain
        s_in = set()
        for t in members:
            s_in |= samples_of[uspans[t]]
        if len(s_in) / nsamples < min_posterior:
            continue
        starts: dict = {}
        ends: dict = {}
        m = 0
        for t in members:
            aa, bb = uspans[t]
            c = uniq[uspans[t]]
            starts[aa] = starts.get(aa, 0) + c
            ends[bb] = ends.get(bb, 0) + c
            m += c
        # envelope: widest endpoints with marginal prob >= min_endpointp
        sa = [aa for aa, c in starts.items() if c / m >= min_endpointp]
        sb = [bb for bb, c in ends.items() if c / m >= min_endpointp]
        if not sa:
            sa = list(starts)
        if not sb:
            sb = list(ends)
        env_a, env_b = min(sa), max(sb)
        if env_b < env_a:
            continue
        envs.append((env_a + i - 1, env_b + i - 1))
    if not envs:
        return [(i, j)], n2_region
    envs.sort()
    return envs, n2_region


def define_domains(prof_multi, prof_uni, dsq: np.ndarray,
                   fwd: ref.ParserResult, bck: ref.ParserResult,
                   do_null2: bool = True,
                   rng: Optional[np.random.Generator] = None,
                   rt1: float = RT1, rt2: float = RT2, rt3: float = RT3,
                   nsamples: int = 200) -> DomainDefResult:
    """The full ``p7_domaindef_ByPosteriorHeuristics`` driver."""
    L = len(dsq)
    btot, etot, mocc = ref.decode_specials(fwd, bck, prof_multi, L)
    n2sc = np.zeros(L + 1)
    domains: List[DomainEnvelope] = []
    nregions = nclustered = noverlaps = nenvelopes = 0

    istart = -1
    triggered = False
    for jj in range(1, L + 1):
        if not triggered:
            if mocc[jj] - (btot[jj] - btot[jj - 1]) < rt2:
                istart = jj
            elif istart == -1:
                istart = jj
            if mocc[jj] >= rt1:
                triggered = True
        elif mocc[jj] - (etot[jj] - etot[jj - 1]) < rt2:
            ii = istart
            nregions += 1
            # is_multidomain_region: maximize over split points z the
            # expected number of E events before z AND B events after z --
            # evidence of ">=2 domains in this region" (threshold rt3)
            z = np.arange(ii, jj + 1)
            expected_n = float(np.max(np.minimum(
                etot[z] - etot[ii - 1], btot[jj] - btot[z])))
            if expected_n >= rt3 and rng is not None:
                # multidomain region: stochastic traceback clustering
                nclustered += 1
                envs, n2_region = region_trace_ensemble(
                    prof_multi, prof_uni, dsq, ii, jj, rng, nsamples)
                if do_null2:
                    # position-specific null2 from the stochastic trace
                    # ensemble (p7_Null2_ByTrace per sampled domain,
                    # averaged over samples)
                    n2sc[ii: jj + 1] = n2_region[1: jj - ii + 2]
                last_end = 0
                for (a, b) in envs:
                    if a <= last_end:
                        noverlaps += 1
                    last_end = b
                    dom = rescore_isolated_domain(prof_uni, dsq, a, b,
                                                  do_null2, n2sc,
                                                  null2_is_done=True)
                    if dom is not None:
                        nenvelopes += 1
                        domains.append(dom)
            else:
                dom = rescore_isolated_domain(prof_uni, dsq, ii, jj,
                                              do_null2, n2sc)
                if dom is not None:
                    nenvelopes += 1
                    domains.append(dom)
            istart = -1
            triggered = False

    return DomainDefResult(
        domains=domains,
        nexpected=float(etot[L]),
        nregions=nregions,
        nclustered=nclustered,
        noverlaps=noverlaps,
        nenvelopes=nenvelopes,
        n2sc=n2sc,
    )


# state codes
C, E, M, D, I, B, N, J, DONE = range(9)


def sample_traces(prof, fwd: "ref.MatrixResult", dsq: np.ndarray,
                  rng: np.random.Generator, nsamples: int
                  ) -> List[List[Tuple[int, int, np.ndarray, np.ndarray]]]:
    """Sample ``nsamples`` paths; returns per-sample lists of
    ``(start, end, uM, uI)`` domain spans."""
    Mn = prof.M
    L = len(dsq)
    S = nsamples
    tMM, tIM, tDM = (ref._clamp(prof.tMM), ref._clamp(prof.tIM),
                     ref._clamp(prof.tDM))
    tMD, tDD = ref._clamp(prof.tMD), ref._clamp(prof.tDD)
    tMI, tII = ref._clamp(prof.tMI), ref._clamp(prof.tII)
    tBM = ref._clamp(prof.tBM)
    xE, xN, xJ, xC = (ref._clamp(prof.xE), ref._clamp(prof.xN),
                      ref._clamp(prof.xJ), ref._clamp(prof.xC))

    state = np.full(S, C, dtype=np.int8)
    i = np.full(S, L, dtype=np.int64)
    k = np.zeros(S, dtype=np.int64)
    end_i = np.zeros(S, dtype=np.int64)
    uM = np.zeros((S, Mn + 1))
    uI = np.zeros((S, Mn + 1))
    spans: List[List[Tuple[int, int, np.ndarray, np.ndarray]]] = [
        [] for _ in range(S)]

    def pick2(logp0, logp1, sel):
        """Binary choice per selected sample from two log-weights."""
        m = np.maximum(logp0, logp1)
        p0 = np.exp(logp0 - m)
        p1 = np.exp(logp1 - m)
        u = rng.random(sel.sum())
        return u < p1 / (p0 + p1)       # True -> option 1

    max_steps = 6 * (L + Mn) + 64
    for _ in range(max_steps):
        alive = state != DONE
        if not alive.any():
            break

        # --- C state: loop (emit) or come from E
        sel = state == C
        if sel.any():
            s = np.where(sel)[0]
            can_loop = i[s] > 0
            lp0 = np.where(can_loop, fwd.xC[np.maximum(i[s] - 1, 0)] + xC[0],
                           NEGMASS)
            lp1 = fwd.xE[i[s]] + xE[1]
            take_e = pick2(lp0, lp1, sel)
            loopers = s[~take_e]
            i[loopers] -= 1
            state[s[take_e]] = E

        # --- E state: choose M(i, 1..Mn) or D(i, Mn)
        sel = state == E
        if sel.any():
            s = np.where(sel)[0]
            end_i[s] = i[s]
            uM[s] = 0.0
            uI[s] = 0.0
            logp = np.concatenate(
                [fwd.M[i[s], 1:], fwd.D[i[s], Mn:Mn + 1]], axis=1)  # [n, Mn+1]
            g = rng.gumbel(size=logp.shape)
            choice = np.argmax(np.where(logp > NEGMASS / 2, logp + g,
                                        NEGMASS), axis=1)
            is_d = choice == Mn
            state[s[is_d]] = D
            k[s[is_d]] = Mn
            ms = s[~is_d]
            state[ms] = M
            k[ms] = choice[~is_d] + 1

        # --- M state
        sel = state == M
        if sel.any():
            s = np.where(sel)[0]
            uM[s, k[s]] += 1
            ks = k[s]
            iprev = i[s] - 1
            lp = np.stack([
                fwd.M[iprev, ks - 1] + tMM[ks - 1],
                fwd.I[iprev, ks - 1] + tIM[ks - 1],
                fwd.D[iprev, ks - 1] + tDM[ks - 1],
                fwd.xB[iprev] + tBM[ks - 1],
            ], axis=1)
            lp[ks == 1, 0:3] = NEGMASS     # M_1 only enters from B
            g = rng.gumbel(size=lp.shape)
            choice = np.argmax(np.where(lp > NEGMASS / 2, lp + g, NEGMASS),
                               axis=1)
            i[s] -= 1
            # record completed spans for B-entries
            for idx in s[choice == 3]:
                spans[idx].append((int(i[idx]) + 1, int(end_i[idx]),
                                   uM[idx].copy(), uI[idx].copy()))
            state[s[choice == 3]] = B
            m_m = s[choice == 0]
            k[m_m] -= 1
            m_i = s[choice == 1]
            state[m_i] = I
            k[m_i] -= 1
            m_d = s[choice == 2]
            state[m_d] = D
            k[m_d] -= 1

        # --- D state
        sel = state == D
        if sel.any():
            s = np.where(sel)[0]
            ks = k[s]
            take_d = pick2(fwd.M[i[s], ks - 1] + tMD[ks - 1],
                           fwd.D[i[s], ks - 1] + tDD[ks - 1], sel)
            m_m = s[~take_d]
            state[m_m] = M
            k[m_m] -= 1
            k[s[take_d]] -= 1

        # --- I state
        sel = state == I
        if sel.any():
            s = np.where(sel)[0]
            uI[s, k[s]] += 1
            ks = k[s]
            iprev = i[s] - 1
            take_i = pick2(fwd.M[iprev, ks] + tMI[ks],
                           fwd.I[iprev, ks] + tII[ks], sel)
            i[s] -= 1
            state[s[~take_i]] = M

        # --- B state
        sel = state == B
        if sel.any():
            s = np.where(sel)[0]
            take_j = pick2(fwd.xN[i[s]] + xN[1], fwd.xJ[i[s]] + xJ[1], sel)
            state[s[take_j]] = J
            state[s[~take_j]] = N

        # --- J state
        sel = state == J
        if sel.any():
            s = np.where(sel)[0]
            can_loop = i[s] > 0
            lp0 = np.where(can_loop, fwd.xJ[np.maximum(i[s] - 1, 0)] + xJ[0],
                           NEGMASS)
            lp1 = fwd.xE[i[s]] + xE[0]
            take_e = pick2(lp0, lp1, sel)
            i[s[~take_e]] -= 1
            state[s[take_e]] = E

        # --- N state
        sel = state == N
        if sel.any():
            s = np.where(sel)[0]
            done = i[s] == 0
            state[s[done]] = DONE
            i[s[~done]] -= 1

    for sp in spans:
        sp.reverse()
    return spans
