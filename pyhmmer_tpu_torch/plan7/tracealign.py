"""Trace alignment: hits -> MSA, sequences -> HMM alignment.

Mirrors ``pyhmmer.plan7.TraceAligner`` (reference ``src/pyhmmer/plan7.pyx:
9433-9613``; ``p7_tracealign`` semantics) and ``TopHits.to_msa``:
alignment columns are the model's match states 1..M plus insert columns
sized by the maximum insert run observed between consecutive match
states.
"""

from __future__ import annotations

import numpy as np
from typing import List, Optional, Sequence, Tuple

from ..easel.alphabet import Alphabet
from ..easel.msa import DigitalMSA, TextMSA
from ..easel.sequence import DigitalSequence
from .hmm import HMM
from .background import Background
from .profile import Profile
from . import domaindef as dd
from ..ops import reference as ref

__all__ = ["Trace", "Traces", "TraceAligner", "tophits_to_msa"]

Trace = dd.Trace


class Traces(list):
    """A list of traces (``pyhmmer.plan7.Traces``)."""


def trace_from_sequence(seq: DigitalSequence) -> Trace:
    """The trivial trace aligning a sequence to itself
    (``Trace.from_sequence``): every residue is a match state."""
    tr = Trace()
    tr.append("S")
    tr.append("N")
    tr.append("B")
    for i, _ in enumerate(seq.sequence, 1):
        tr.append("M", i, i)
    tr.append("E")
    tr.append("C")
    tr.append("T")
    return tr


Trace.from_sequence = staticmethod(trace_from_sequence)  # type: ignore


def _trace_columns(tr: Trace) -> List[Tuple[str, int, int]]:
    """Extract (state, k, i) for aligned M/I/D steps of a trace."""
    out = []
    for s, k, i in zip(tr.states, tr.k, tr.i):
        if s in ("M", "I", "D"):
            out.append((s, k, i))
    return out


def traces_to_msa(hmm: HMM, seqs: Sequence[DigitalSequence],
                  traces: Sequence[Trace], trim: bool = False,
                  all_consensus_cols: bool = True,
                  digitize: bool = False):
    """Merge traces into one MSA (``p7_tracealign_Seqs`` semantics)."""
    M = hmm.M
    alph = hmm.alphabet
    # insert column widths between match states (index k = after state k)
    ins_width = np.zeros(M + 1, dtype=np.int64)
    parsed = [_trace_columns(t) for t in traces]
    for cols in parsed:
        run = 0
        last_k = 0
        for s, k, i in cols:
            if s == "I":
                run += 1
                last_k = k
            else:
                if run:
                    ins_width[last_k] = max(ins_width[last_k], run)
                    run = 0
        if run:
            ins_width[last_k] = max(ins_width[last_k], run)

    # column layout: [ins0][ M1 ][ins1][ M2 ] ... [ MM ][insM]
    col_of_match = np.zeros(M + 1, dtype=np.int64)
    ins_start = np.zeros(M + 1, dtype=np.int64)
    pos = 0
    ins_start[0] = 0
    pos += ins_width[0]
    for k in range(1, M + 1):
        col_of_match[k] = pos
        pos += 1
        ins_start[k] = pos
        pos += ins_width[k]
    alen = pos

    gap = alph.gap_code
    rows = np.full((len(seqs), alen), gap, dtype=np.uint8)
    lower = np.zeros((len(seqs), alen), dtype=bool)
    for r, (sq, cols) in enumerate(zip(seqs, parsed)):
        # collect this trace's insert runs per node, then place them with
        # HMMER's rejustification (tracealign.c rejustify_insertions):
        # the first nins/2 residues are left-justified in the insert
        # block, the remainder right-justified
        ins_res: dict = {}
        for s, k, i in cols:
            if s == "M":
                rows[r, col_of_match[k]] = sq.sequence[i - 1]
            elif s == "I":
                ins_res.setdefault(k, []).append(sq.sequence[i - 1])
            # D leaves a gap in the match column (already gap)
        for k, res in ins_res.items():
            width = int(ins_width[k])
            n = len(res)
            nleft = n // 2
            for j in range(nleft):
                c = ins_start[k] + j
                rows[r, c] = res[j]
                lower[r, c] = True
            for j in range(nleft, n):
                c = ins_start[k] + width - (n - j)
                rows[r, c] = res[j]
                lower[r, c] = True

    msa = DigitalMSA(alph, name=hmm.name)
    msa.names = [s.name for s in seqs]
    msa.codes = rows
    # RF line: 'x' on match columns, '.' on inserts
    rf = np.full(alen, b".", dtype="S1")
    rf[col_of_match[1:]] = b"x"
    msa.reference = b"".join(rf)
    if digitize:
        return msa
    text = msa.textize()
    # lowercase the insert-state residues, '.' gaps on insert columns
    for r in range(len(text.rows)):
        chars = list(text.rows[r])
        for c in range(alen):
            if rf[c] == b".":
                chars[c] = chars[c].lower() if lower[r, c] else "."
        text.rows[r] = "".join(chars)
    return text


def _trace_one(hmm: HMM, bg: Background, sq: DigitalSequence) -> Trace:
    """One sequence's optimal posterior-accuracy trace.  The DP-heavy
    parts (full-matrix Forward/Backward, optimal-accuracy DP) run in the
    native library when available; only posterior combination and the
    traceback stay in NumPy/Python."""
    from ..ops import native

    L = len(sq)
    prof = Profile(hmm.M, hmm.alphabet).configure(
        hmm, bg, L, multihit=False)
    if native.available():
        fwd = native.fwdbck(prof, sq.sequence, True, False)
        bck = native.fwdbck(prof, sq.sequence, True, True)
    else:
        fwd = ref.forward(prof, sq.sequence, keep_matrix=True)
        bck = ref.backward(prof, sq.sequence, keep_matrix=True)
    pp = ref.posterior_matrices(fwd, bck, prof, sq.sequence)
    if native.available():
        oasc, dpm = native.optacc(prof, pp, L)
    else:
        oasc, dpm = dd.optimal_accuracy(prof, pp, L)
    return dd.oa_traceback(prof, pp, dpm, L)


class TraceAligner:
    """Align sequences to an HMM (``pyhmmer.plan7.TraceAligner``)."""

    def compute_traces(self, hmm: HMM, sequences) -> Traces:
        """Optimal posterior-accuracy traces of each sequence against the
        model (``p7_tracealign_computeTraces``).

        Batch-parallel over the sequence block (the reference fans
        ``compute_traces`` over a ThreadPool, ``_hmmalign.py:82-93``):
        each sequence's native DP releases the GIL, so a pool of
        core-count workers scales the batch; per-task Profile
        configuration keeps the workers state-free."""
        import concurrent.futures as _cf
        import os as _os

        bg = Background(hmm.alphabet)
        seqs = list(sequences)
        if len(seqs) >= 4:
            nthreads = max(2, _os.cpu_count() or 2)
            with _cf.ThreadPoolExecutor(nthreads) as ex:
                return Traces(ex.map(
                    lambda sq: _trace_one(hmm, bg, sq), seqs))
        return Traces(_trace_one(hmm, bg, sq) for sq in seqs)

    def align_traces(self, hmm: HMM, sequences, traces, *,
                     trim: bool = False, digitize: bool = False,
                     all_consensus_cols: bool = False):
        """Merge traces into an MSA (``p7_tracealign_Seqs``)."""
        return traces_to_msa(hmm, list(sequences), list(traces), trim=trim,
                             all_consensus_cols=all_consensus_cols,
                             digitize=digitize)


def tophits_to_msa(th, alphabet: Alphabet, sequences=None, traces=None,
                   trim=False, digitize=False, all_consensus_cols=False):
    """Alignment of all included domains of a TopHits (``TopHits.to_msa``,
    the jackhmmer feedstock)."""
    seqs: List[DigitalSequence] = []
    trs: List[Trace] = []
    for h in th.hits:
        if not h.included:
            continue
        for di, d in enumerate(h.domains):
            if not d.included:
                continue
            a = d.alignment
            # rebuild a domain trace from the alignment strings
            tr = Trace()
            tr.append("S"); tr.append("N"); tr.append("B")
            k = a.hmm_from
            i = d.ali_from
            sub = []
            for mc, tc in zip(a.hmm_sequence, a.target_sequence):
                if tc == "-":          # delete
                    tr.append("D", k, 0)
                    k += 1
                elif mc == ".":        # insert
                    tr.append("I", k - 1, len(sub) + 1)
                    sub.append(tc.upper())
                else:                  # match
                    tr.append("M", k, len(sub) + 1)
                    sub.append(tc.upper())
                    k += 1
            tr.append("E"); tr.append("C"); tr.append("T")
            name = h.name
            if len([dm for dm in h.domains if dm.included]) > 1:
                name = h.name + b"/%d-%d" % (d.ali_from, d.ali_to)
            seqs.append(DigitalSequence(alphabet, name=name,
                                        sequence=alphabet.encode("".join(sub))))
            trs.append(tr)
    if sequences:
        for sq, tr in zip(sequences, traces or
                          [trace_from_sequence(s) for s in sequences]):
            seqs.append(sq)
            trs.append(tr)
    # a fake HMM carrier for M
    class _H:
        pass
    h = _H()
    h.M = th.query_length
    h.alphabet = alphabet
    h.name = th.query_name
    return traces_to_msa(h, seqs, trs, trim=trim, digitize=digitize,
                         all_consensus_cols=all_consensus_cols)
