"""ctypes bindings for the native host DP library (csrc/hmmdp.cpp).

The port's copy of ``pyhmmer_tpu/ops/native.py``.  At first use the
library is compiled with g++ (the JAX package's flags) from the port's
own ``csrc/hmmdp.cpp`` into ``build/torch_host/`` at the root of the
checkout, under an ``fcntl`` lock on ``build/torch_host/.lock``, and
rebuilt when the source is newer.  It is a ``ctypes.CDLL`` of its own,
with its own global state, so a process may load the JAX package's
library beside it.  If no compiler is available the NumPy
implementations in :mod:`ops.reference` are used unchanged.  Disable
with ``PYHMMER_TPU_NATIVE=0``.
"""

from __future__ import annotations

import ctypes
import fcntl
import math
import os
import subprocess
import tempfile
import threading
import numpy as np
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "csrc", "hmmdp.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "torch_host")
_LIB = os.path.join(_BUILD, "libhmmdp.so")
_LOCK = os.path.join(_BUILD, ".lock")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I32 = ctypes.c_int32


def _build() -> bool:
    """Compile into a private file beside ``_LIB``, then move it into
    place (the caller holds the build lock)."""
    fd, tmp = tempfile.mkstemp(dir=_BUILD, prefix="tmp-", suffix=".so")
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native",
             # -fno-math-errno/-fno-trapping-math: value-preserving, lets
             # gcc vectorize libm calls (exp/log) through libmvec.
             # -fassociative-math + -ffinite-math-only: vectorizes the
             # row sum/max REDUCTIONS in the DP parsers (2.3x on the
             # domaindef hot path).  Safe here by construction: every
             # float crossing the C ABI is clamped finite (ProfTensors /
             # _clamp2 / the fwd_min clip), the kernels use the finite
             # NEGMASS = -1e30 sentinel instead of infinities, and the
             # odds-space rows are range-bounded by per-row rescaling.
             # Reassociated f32 sums differ from serial order at the
             # ~1e-6-relative level, far inside reported-score tolerance
             # (reported scores accumulate in float64).
             "-fno-math-errno", "-fno-trapping-math",
             "-fassociative-math", "-fno-signed-zeros",
             "-ffinite-math-only",
             "-fPIC", "-shared", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_checked() -> ctypes.CDLL:
    """Load the library and probe the newest ABI symbol so a stale
    binary raises instead of failing later."""
    lib = ctypes.CDLL(_LIB)
    lib.hmmdp_viterbi
    lib.hmmdp_core_new
    lib.hmmdp_bias_filter_idx
    lib.hmmdp_phase_get
    lib.hmmdp_has_ext_rows
    lib.hmmdp_call_times
    lib.hmmdp_domaindef_batch   # newest ABI marker; AttributeError if stale
    return lib


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
        if not _build():
            return None
    try:
        lib = _load_checked()
    except (OSError, AttributeError):
        # stale binary (e.g. a checkout whose .so predates the source,
        # or a missing symbol after an ABI change): force a rebuild
        try:
            os.remove(_LIB)
        except OSError:
            pass
        if not _build():
            return None
        try:
            lib = _load_checked()
        except (OSError, AttributeError):
            return None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded by the first caller; callers that
    arrive meanwhile (the shard engines of ``parallel.mesh`` start in
    threads of their own) wait for it."""
    global _lib, _tried
    if not _tried:
        with _load_lock:
            if not _tried:
                _lib = _load()
                _tried = True
    return _lib


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("PYHMMER_TPU_NATIVE", "1") == "0":
        return None
    os.makedirs(_BUILD, exist_ok=True)
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        lib = _build_and_load()
    if lib is None:
        return None

    sig_fb = [
        _U8, _I32,
        _D, _D, _D, _D, _D, _D, _D, _D,     # transitions
        _D, _D,                             # msc, isc
        _D, _D, _D, _D,                     # xE xN xJ xC
        _I32, _I32,
        _D, _D, _D, _D, _D,                 # specials out
        _D, _D, _D, _I32, _D,               # matrices out, keep, rowscale
    ]
    lib.hmmdp_forward.argtypes = sig_fb
    lib.hmmdp_forward.restype = ctypes.c_double
    lib.hmmdp_backward.argtypes = sig_fb
    lib.hmmdp_backward.restype = ctypes.c_double
    lib.hmmdp_optacc.argtypes = [
        _D, _D, _D, _D, _D,
        _D, _D, _D, _D, _D, _D, _D, _D,
        _I32, _I32, _I32,
        _D, _D, _D,
        _D, _D, _D, _D, _D,
    ]
    lib.hmmdp_optacc.restype = ctypes.c_double
    _I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.hmmdp_stotrace.argtypes = [
        _U8, _I32,
        _D, _D, _D,
        _D, _D, _D, _D, _D,
        _D, _D, _D, _D, _D, _D, _D, _D,
        _D, _D, _D, _D,
        _D, _D,
        _I32, _I32, _I32, ctypes.c_uint64,
        _I32P, _I32, _D,
    ]
    lib.hmmdp_stotrace.restype = ctypes.c_int32
    _I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.hmmdp_ssv_seed.argtypes = [
        _U8, ctypes.c_int64,
        _I32P,                          # cost [Kp, M]
        _I32, _I32, _I32,               # bias_b, xBv, thresh
        _I32, _I32,                     # M, Kp
        _I64P, ctypes.c_int64,
    ]
    lib.hmmdp_ssv_seed.restype = ctypes.c_int64
    lib.hmmdp_msv_quant.argtypes = [
        _U8, ctypes.c_int64,
        _I32P,                          # cost [Kp, M]
        _I32, _I32, _I32, _I32, _I32,   # bias, base, tjb, tec, tbm
        ctypes.c_double,                # scale_b
        _I32, _I32,                     # M, Kp
    ]
    lib.hmmdp_msv_quant.restype = ctypes.c_double
    _I8P = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
    _I64PP = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.hmmdp_domaindef.argtypes = [
        _U8, _I32,
        _D, _D, _D, _D, _D, _D, _D, _D,     # transitions
        _D, _D,                             # msc, isc
        _I32, _I32, _I32,                   # M, K, Kp
        _D, _D,                             # odds_m, odds_i
        _D, _U8,                            # degw, deg_one
        _I32, ctypes.c_uint64, _I32,        # do_null2, seed, nsamples
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,                    # fwd_min (exact-gate bail)
        _D, _D,                             # out_scalars, n2sc
        _I32P, _D, _I32,                    # dom_int, dom_dbl, max_dom
        _I8P, _I32P, _I32P, _D,             # trace arrays
        _I64PP, ctypes.c_int64,             # tr_off, max_tr
        ctypes.c_void_p,                    # cached ExpCore handle or NULL
        ctypes.c_void_p,                    # ext_rows [3*(L+1)] or NULL
        ctypes.c_double, ctypes.c_double,   # ext_fwdsc, audit_eps
    ]
    lib.hmmdp_domaindef.restype = ctypes.c_int32
    lib.hmmdp_core_new.argtypes = [_D, _D, _D, _D, _D, _D, _D, _D,
                                   _D, _D, _I32, _I32]
    lib.hmmdp_core_new.restype = ctypes.c_void_p
    lib.hmmdp_core_free.argtypes = [ctypes.c_void_p]
    lib.hmmdp_core_free.restype = None
    lib.hmmdp_bias_filter.argtypes = [_U8, _I32, _D]
    lib.hmmdp_bias_filter.restype = ctypes.c_double
    lib.hmmdp_bias_filter_batch.argtypes = [
        _U8, _I64PP, _I32, _I32, _D, _D]
    lib.hmmdp_bias_filter_batch.restype = None
    lib.hmmdp_bias_filter_idx.argtypes = [
        _U8, _I64PP, _I64PP, _I32, _I32, _D, _D]
    lib.hmmdp_bias_filter_idx.restype = None
    lib.hmmdp_viterbi.argtypes = [
        _U8, _I32,
        _D, _D, _D, _D, _D, _D, _D, _D,
        _D, _D, _D, _D, _D, _D, _I32, _I32]
    lib.hmmdp_viterbi.restype = ctypes.c_double
    lib.hmmdp_phase_get.argtypes = [_D]
    lib.hmmdp_phase_get.restype = None
    # called holding the GIL (a Python-API prototype): a read of two
    # thread-local sums, where dropping and retaking it would cost more
    lib.call_times = ctypes.PYFUNCTYPE(None, ctypes.POINTER(
        ctypes.c_double))(("hmmdp_call_times", lib))
    lib.hmmdp_marginal_count.argtypes = []
    lib.hmmdp_marginal_count.restype = ctypes.c_int64
    lib.hmmdp_forward_flogsum.argtypes = [
        _U8, _I32,
        _D, _D, _D, _D, _D, _D, _D, _D,
        _D, _D, _D, _D, _D, _D, _I32, _I32]
    lib.hmmdp_forward_flogsum.restype = ctypes.c_double
    lib.hmmdp_phase_reset.argtypes = []
    lib.hmmdp_phase_reset.restype = None
    # raw addresses: a batch passes few arrays, and ``ndpointer``'s
    # check and cast of each costs more than the addresses do
    _P = ctypes.c_void_p
    lib.hmmdp_domaindef_batch.argtypes = [
        _I32, _P, _P, ctypes.c_double,          # pairs: ints, floats, log 1/2
        _P, _P,                                 # per-profile tables
        _I32, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        _P,                                     # sizes out
    ]
    lib.hmmdp_domaindef_batch.restype = ctypes.c_int32
    lib.hmmdp_dd_batch_read.argtypes = [_P, _P, _P]
    lib.hmmdp_dd_batch_read.restype = None
    return lib


def ssv_seed(quant, dsq: np.ndarray, xBv: int, thresh: int,
             max_out: int = 1 << 20) -> np.ndarray:
    """Seed positions (1-based row indices) where the quantized SSV
    diagonal maximum crosses ``thresh``.  ``quant`` is an
    ``ops.quantize.MSVQuant``."""
    lib = get_lib()
    pos = np.zeros(max_out, dtype=np.int64)
    cost = np.ascontiguousarray(quant.cost, dtype=np.int32)
    dsq8 = np.ascontiguousarray(dsq, dtype=np.uint8)
    n = lib.hmmdp_ssv_seed(dsq8, len(dsq8), cost, int(quant.bias_b),
                           int(xBv), int(thresh), quant.M,
                           cost.shape[0], pos, max_out)
    return pos[:n]


def msv_quant(quant, dsq: np.ndarray) -> Optional[float]:
    """Quantized MSV filter score in nats (integer-exact twin of
    ``ops.reference.msv_score_quantized``); np.inf on uint8 overflow.
    None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    cost = np.ascontiguousarray(quant.cost, dtype=np.int32)
    dsq8 = np.ascontiguousarray(dsq, dtype=np.uint8)
    L = len(dsq8)
    sc = lib.hmmdp_msv_quant(dsq8, L, cost, int(quant.bias_b),
                             int(quant.base_b), int(quant.tjb_b(L)),
                             int(quant.tec_b), int(quant.tbm_b),
                             float(quant.scale_b), quant.M, cost.shape[0])
    return np.inf if sc >= 1e29 else float(sc)


class ProfTensors:
    """Float64-contiguous profile tensors for the C ABI (cached on the
    profile object; length-model specials refresh on reconfig).  Also owns
    the native ``ExpCore`` handle (precomputed odds tables) so repeated
    domaindef calls skip the ~10k exp() table build."""

    __slots__ = ("tBM", "tMM", "tIM", "tDM", "tMD", "tDD", "tMI", "tII",
                 "msc", "isc", "M", "Kp", "_core_handle")

    def __init__(self, prof):
        def c(a):
            return np.ascontiguousarray(
                np.where(np.isfinite(a), a, -1e30), dtype=np.float64)
        self.tBM, self.tMM, self.tIM = c(prof.tBM), c(prof.tMM), c(prof.tIM)
        self.tDM, self.tMD, self.tDD = c(prof.tDM), c(prof.tMD), c(prof.tDD)
        self.tMI, self.tII = c(prof.tMI), c(prof.tII)
        self.msc, self.isc = c(prof.msc), c(prof.isc)
        self.M = prof.M
        self.Kp = prof.alphabet.Kp
        self._core_handle = None
        lib = get_lib()
        if lib is not None:
            self._core_handle = _CoreHandle(lib.hmmdp_core_new(
                self.tBM, self.tMM, self.tIM, self.tDM, self.tMD,
                self.tDD, self.tMI, self.tII, self.msc, self.isc,
                self.M, self.Kp))

    @property
    def core(self):
        h = self._core_handle
        return h.ptr if h is not None else None


class _CoreHandle:
    """Owns one native ExpCore pointer.  Shared (never duplicated) across
    copies/deepcopies so the pointer is freed exactly once."""

    __slots__ = ("ptr",)

    def __init__(self, ptr):
        self.ptr = ptr

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    def __del__(self):
        ptr, self.ptr = self.ptr, None
        if ptr:
            try:
                _lib.hmmdp_core_free(ptr)
            except Exception:
                pass


def get_tensors(prof) -> ProfTensors:
    pt = getattr(prof, "_native_tensors", None)
    if pt is None or pt.M != prof.M:
        pt = ProfTensors(prof)
        prof._native_tensors = pt
    return pt


def _clamp2(a):
    return np.ascontiguousarray(
        np.where(np.isfinite(a), a, -1e30), dtype=np.float64)


def fwdbck(prof, dsq: np.ndarray, keep_matrix: bool, backward: bool):
    """Native forward/backward; returns the same result objects as
    ops.reference.forward/backward."""
    from . import reference as ref
    lib = get_lib()
    pt = get_tensors(prof)
    L = int(len(dsq))
    W = pt.M + 1
    xN = np.empty(L + 1); xB = np.empty(L + 1); xE = np.empty(L + 1)
    xC = np.empty(L + 1); xJ = np.empty(L + 1)
    if keep_matrix:
        Mm = np.empty((L + 1, W)); Im = np.empty((L + 1, W))
        Dm = np.empty((L + 1, W))
    else:
        Mm = Im = Dm = np.empty((1, W))
    fn = lib.hmmdp_backward if backward else lib.hmmdp_forward
    dsq8 = np.ascontiguousarray(dsq, dtype=np.uint8)
    rs = np.zeros(1)
    score = fn(dsq8, L, pt.tBM, pt.tMM, pt.tIM, pt.tDM, pt.tMD, pt.tDD,
               pt.tMI, pt.tII, pt.msc, pt.isc,
               _clamp2(prof.xE), _clamp2(prof.xN), _clamp2(prof.xJ),
               _clamp2(prof.xC), pt.M, pt.Kp,
               xN, xB, xE, xC, xJ, Mm, Im, Dm,
               1 if keep_matrix else 0, rs)
    if keep_matrix:
        return ref.MatrixResult(score, xN, xB, xE, xC, xJ, Mm, Im, Dm)
    return ref.ParserResult(score, xN, xB, xE, xC, xJ)


def forward_flogsum(prof, dsq: np.ndarray) -> Optional[float]:
    """Forward score through HMMER's 16k-entry FLogsum table (generic
    log-space DP, ``logsum.c`` role) -- the E-value calibration scorer.
    Uses the profile's CURRENT length configuration.  None without the
    native library."""
    lib = get_lib()
    if lib is None:
        return None
    pt = get_tensors(prof)
    dsq8 = np.ascontiguousarray(dsq, dtype=np.uint8)
    return lib.hmmdp_forward_flogsum(
        dsq8, int(len(dsq8)),
        pt.tBM, pt.tMM, pt.tIM, pt.tDM, pt.tMD, pt.tDD, pt.tMI, pt.tII,
        pt.msc, pt.isc,
        _clamp2(prof.xE), _clamp2(prof.xN), _clamp2(prof.xJ),
        _clamp2(prof.xC), pt.M, pt.Kp)


def viterbi_score(prof, dsq: np.ndarray) -> Optional[float]:
    """Native multihit Viterbi score in nats with the length model set
    from ``len(dsq)`` (float-exact semantics of
    ``ops.reference.viterbi_score`` on a length-reconfigured profile,
    WITHOUT mutating the shared profile -- thread-safe).  None without
    the native library."""
    lib = get_lib()
    if lib is None:
        return None
    pt = get_tensors(prof)
    L = int(len(dsq))
    pmove = 3.0 / (L + 3.0)
    ll, lm = np.log(1.0 - pmove), np.log(pmove)
    xNJC = np.ascontiguousarray([ll, lm])
    xE = np.ascontiguousarray([np.log(0.5), np.log(0.5)])
    dsq8 = np.ascontiguousarray(dsq, dtype=np.uint8)
    return lib.hmmdp_viterbi(
        dsq8, L,
        pt.tBM, pt.tMM, pt.tIM, pt.tDM, pt.tMD, pt.tDD, pt.tMI, pt.tII,
        pt.msc, pt.isc,
        xE, xNJC, xNJC, xNJC, pt.M, pt.Kp)


def optacc(prof, pp: dict, L: int):
    """Native optimal accuracy DP; returns (oasc, dp dict)."""
    lib = get_lib()
    Mn = prof.M
    W = Mn + 1

    def gate(tsc):
        t = np.where(np.isfinite(tsc), tsc, -1e30)
        return np.ascontiguousarray(
            np.where(t > -5e29, 0.0, -1e30), dtype=np.float64)

    ppM = np.ascontiguousarray(pp["M"], dtype=np.float64)
    ppI = np.ascontiguousarray(pp["I"], dtype=np.float64)
    ppN = np.ascontiguousarray(pp["N"], dtype=np.float64)
    ppJ = np.ascontiguousarray(pp["J"], dtype=np.float64)
    ppC = np.ascontiguousarray(pp["C"], dtype=np.float64)
    Mx = np.empty((L + 1, W)); Ix = np.empty((L + 1, W))
    Dx = np.empty((L + 1, W))
    xN = np.empty(L + 1); xB = np.empty(L + 1); xE = np.empty(L + 1)
    xJ = np.empty(L + 1); xC = np.empty(L + 1)
    eJ_ok = 1 if np.isfinite(prof.xE[0]) and prof.xE[0] > -5e29 else 0
    oasc = lib.hmmdp_optacc(
        ppM, ppI, ppN, ppJ, ppC,
        gate(prof.tMM), gate(prof.tIM), gate(prof.tDM),
        gate(prof.tMD), gate(prof.tDD), gate(prof.tMI), gate(prof.tII),
        gate(prof.tBM), eJ_ok, L, Mn,
        Mx, Ix, Dx, xN, xB, xE, xJ, xC)
    return oasc, dict(M=Mx, I=Ix, D=Dx, N=xN, B=xB, E=xE, J=xJ, C=xC)


def stotrace(prof, fwd, dsq: np.ndarray, nsamples: int, seed: int):
    """Native stochastic traceback ensemble over a region window.

    Returns (spans list[(sample, a, b)], n2acc[L+2]) where n2acc is the
    summed per-position trace-null2 log odds (divide by nsamples)."""
    lib = get_lib()
    pt = get_tensors(prof)
    L = int(len(dsq))
    K = prof.alphabet.K
    W = pt.M + 1
    odds_m = np.ascontiguousarray(
        np.exp(np.maximum(prof.msc[:K, :], -700.0)), dtype=np.float64)
    odds_i = np.ascontiguousarray(
        np.exp(np.maximum(prof.isc[:K, :], -700.0)), dtype=np.float64)
    max_spans = nsamples * 16
    spans = np.zeros(3 * max_spans, dtype=np.int32)
    n2acc = np.zeros(L + 2, dtype=np.float64)
    dsq8 = np.ascontiguousarray(dsq, dtype=np.uint8)
    n = lib.hmmdp_stotrace(
        dsq8, L,
        np.ascontiguousarray(fwd.M), np.ascontiguousarray(fwd.I),
        np.ascontiguousarray(fwd.D),
        np.ascontiguousarray(fwd.xN), np.ascontiguousarray(fwd.xB),
        np.ascontiguousarray(fwd.xE), np.ascontiguousarray(fwd.xC),
        np.ascontiguousarray(fwd.xJ),
        pt.tBM, pt.tMM, pt.tIM, pt.tDM, pt.tMD, pt.tDD, pt.tMI, pt.tII,
        _clamp2(prof.xE), _clamp2(prof.xN), _clamp2(prof.xJ),
        _clamp2(prof.xC),
        odds_m, odds_i,
        pt.M, K, nsamples, seed & 0x7FFFFFFFFFFFFFFF,
        spans, max_spans, n2acc)
    out = [(int(spans[3 * t]), int(spans[3 * t + 1]), int(spans[3 * t + 2]))
           for t in range(n)]
    return out, n2acc


def _null2_tables(alphabet):
    """Per-alphabet degeneracy tables for the native null2
    (``null2[code] = degw[code] @ null2[:K]``, overridden to 1.0 where
    ``deg_one``: gap / nonresidue / missing codes)."""
    cached = getattr(alphabet, "_native_null2_tables", None)
    if cached is None:
        K, Kp = alphabet.K, alphabet.Kp
        d = alphabet.degen.astype(np.float64)
        s = d.sum(axis=1, keepdims=True)
        degw = np.ascontiguousarray(np.where(s > 0, d / np.maximum(s, 1), 0.0))
        deg_one = np.zeros(Kp, dtype=np.uint8)
        deg_one[K] = deg_one[Kp - 2] = deg_one[Kp - 1] = 1
        cached = (degw, deg_one)
        alphabet._native_null2_tables = cached
    return cached


def _odds_tables(prof):
    """Per-profile emission odds tables for null2 (cached on the
    profile; rebuilt on reconfig is unnecessary -- emissions are
    length-independent)."""
    cached = getattr(prof, "_native_odds", None)
    if cached is None or cached[0] != prof.M:
        K = prof.alphabet.K
        odds_m = np.ascontiguousarray(
            np.exp(np.maximum(prof.msc[:K, :], -700.0)), dtype=np.float64)
        odds_i = np.ascontiguousarray(
            np.exp(np.maximum(prof.isc[:K, :], -700.0)), dtype=np.float64)
        cached = (prof.M, odds_m, odds_i)
        prof._native_odds = cached
    return cached[1], cached[2]


def prewarm(prof) -> None:
    """Build and cache the C-ABI tensors for a profile, and its rows of
    the batch tables (:func:`_batch_row`), off the critical path
    (first-call tensor construction otherwise lands on a worker)."""
    if get_lib() is None:
        return
    _batch_row(prof)


import threading as _threading


def marginal_count() -> int:
    """Device-rows domaindef calls that failed the audit prepass and
    recomputed the exact host parsers inside the same native call
    (diagnostic; cumulative per process)."""
    lib = get_lib()
    if lib is None:
        return 0
    return int(lib.hmmdp_marginal_count())


_dd_tls = _threading.local()


def _dd_caps(L: int, M: int):
    """The domain definition's buffers for a target of ``L`` residues and
    a model of ``M`` nodes: at most this many domains and trace steps,
    past which the call reports an overflow."""
    max_dom = max(64, min(1024, L // 2 + 8))
    return max_dom, L + max_dom * (M + 64) + 1024


def _batch_caps(lens, Ms):
    """:func:`_dd_caps` of each pair of a batch."""
    return [_dd_caps(L, M) for L, M in zip(lens, Ms)]


def _dd_buffers(max_dom: int, max_tr: int) -> dict:
    """Per-thread reusable output buffers for domaindef: allocating +
    zeroing ~1 MB of numpy arrays per survivor call costs more than the
    DP itself on small targets.  Buffers only grow."""
    bufs = getattr(_dd_tls, "bufs", None)
    if (bufs is None or bufs["max_dom"] < max_dom
            or bufs["max_tr"] < max_tr):
        md = max(max_dom, bufs["max_dom"] if bufs else 0)
        mt = max(max_tr, bufs["max_tr"] if bufs else 0)
        bufs = dict(
            max_dom=md, max_tr=mt,
            scalars=np.empty(6),
            dom_int=np.empty(md * 6, dtype=np.int32),
            dom_dbl=np.empty(md * 3),
            tr_st=np.empty(mt, dtype=np.int8),
            tr_k=np.empty(mt, dtype=np.int32),
            tr_i=np.empty(mt, dtype=np.int32),
            tr_pp=np.empty(mt),
            tr_off=np.empty(md + 1, dtype=np.int64),
        )
        _dd_tls.bufs = bufs
    return bufs


def domaindef(prof_multi, dsq: np.ndarray, do_null2: bool, seed: int,
              nsamples: int = 200, rt1: float = 0.25, rt2: float = 0.10,
              rt3: float = 0.20, fwd_min: float = -np.inf,
              ext_rows: Optional[np.ndarray] = None,
              ext_fwdsc: float = 0.0, audit_eps: float = 2e-4):
    """Full native domain definition for one Forward survivor.

    Runs the complete ``p7_domaindef_ByPosteriorHeuristics`` machinery in
    C++ (full-L fwd/bck parsers, region heuristics, stochastic-ensemble
    clustering, unihit rescoring with null2 + optimal accuracy).  Returns
    ``(fwdsc, DomainDefResult)``; ``None`` if the native library is
    unavailable or a buffer overflowed (caller falls back to Python).
    If the exact Forward score lands below ``fwd_min`` (the caller's
    F3-gate threshold in nats) the driver bails after Forward and returns
    an empty result carrying only ``fwdsc``.

    ``ext_rows`` [3, L+1] float64 (btot, etot, mocc) + ``ext_fwdsc``:
    device-computed full-L parser rows (``ops.rows_pallas``); the native
    side then skips its own parsers/decode, auditing every region
    threshold comparison against ``audit_eps`` -- if any lands inside the
    margin (f32 device rows could flip it) the call transparently reruns
    with the exact host parsers.  Matches the reference's parser-kernel
    split (``impl_sse/fwdback.c`` parser mode feeding
    ``p7_domaindef.c``)."""
    from ..plan7 import domaindef as dd
    lib = get_lib()
    if lib is None:
        return None
    pt = get_tensors(prof_multi)
    L = int(len(dsq))
    K = prof_multi.alphabet.K
    W = pt.M + 1
    odds_m, odds_i = _odds_tables(prof_multi)
    degw, deg_one = _null2_tables(prof_multi.alphabet)
    bufs = _dd_buffers(*_dd_caps(L, pt.M))
    out_scalars = bufs["scalars"]
    n2sc = np.zeros(L + 1)
    dom_int = bufs["dom_int"]
    dom_dbl = bufs["dom_dbl"]
    tr_st, tr_k, tr_i, tr_pp = (bufs["tr_st"], bufs["tr_k"],
                                bufs["tr_i"], bufs["tr_pp"])
    tr_off = bufs["tr_off"]
    max_dom, max_tr = bufs["max_dom"], bufs["max_tr"]
    dsq8 = np.ascontiguousarray(dsq, dtype=np.uint8)
    # the library is compiled -ffinite-math-only (reductions/max chains
    # vectorize); every float crossing the ABI must be finite
    fwd_min = float(np.clip(fwd_min, -1e300, 1e300))
    ext_ptr, ext_sc = None, 0.0
    if ext_rows is not None:
        ext = np.ascontiguousarray(
            np.clip(ext_rows, -1e300, 1e300), dtype=np.float64)
        assert ext.shape == (3, L + 1), ext.shape
        ext_ptr = ext.ctypes.data_as(ctypes.c_void_p)
        ext_sc = float(np.clip(ext_fwdsc, -1e300, 1e300))
    ndom = lib.hmmdp_domaindef(
        dsq8, L,
        pt.tBM, pt.tMM, pt.tIM, pt.tDM, pt.tMD, pt.tDD, pt.tMI, pt.tII,
        pt.msc, pt.isc, pt.M, K, pt.Kp,
        odds_m, odds_i, degw, deg_one,
        1 if do_null2 else 0, seed & 0x7FFFFFFFFFFFFFFF, nsamples,
        rt1, rt2, rt3, float(fwd_min),
        out_scalars, n2sc, dom_int, dom_dbl, max_dom,
        tr_st, tr_k, tr_i, tr_pp, tr_off, max_tr, pt.core,
        ext_ptr, ext_sc, float(audit_eps) if ext_ptr is not None else 0.0)
    if ndom < 0:
        return None
    domains = []
    for d in range(ndom):
        a, b, iali, jali, hmmfrom, hmmto = dom_int[6 * d: 6 * d + 6]
        o0, o1 = int(tr_off[d]), int(tr_off[d + 1])
        # numpy copies only (the shared per-thread buffers are reused on
        # the next call); the Trace materializes its list views lazily --
        # the hit path consumes the arrays directly
        tr = dd.Trace(np_arrays=(
            tr_st[o0:o1].astype(np.uint8),
            tr_k[o0:o1].copy(), tr_i[o0:o1].copy(),
            tr_pp[o0:o1].copy()))
        dom = dd.DomainEnvelope(
            ienv=int(a), jenv=int(b),
            envsc=float(dom_dbl[3 * d]),
            domcorrection=float(dom_dbl[3 * d + 1]),
            oasc=float(dom_dbl[3 * d + 2]), trace=tr,
            iali=int(iali), jali=int(jali),
            hmmfrom=int(hmmfrom), hmmto=int(hmmto))
        domains.append(dom)
    res = dd.DomainDefResult(
        domains=domains,
        nexpected=float(out_scalars[1]),
        nregions=int(out_scalars[2]),
        nclustered=int(out_scalars[3]),
        noverlaps=int(out_scalars[4]),
        nenvelopes=int(out_scalars[5]),
        n2sc=n2sc)
    return float(out_scalars[0]), res


#: per-pair status of :func:`domaindef_batch` (``csrc/hmmdp.cpp``): the
#: pair passed the F3 gate (a hit, or no domain), was dropped by the
#: Viterbi gate or by the F3 gate, or overflowed a buffer (the caller
#: runs it through :func:`domaindef`)
DD_HIT, DD_GATED_VIT, DD_GATED_F3, DD_OVERFLOW = 0, 1, 2, 3
#: columns of the batch tables (``hmmdp.cpp``'s ``BP_N`` and ``BI_N``)
_BP_N, _BI_N = 21, 5


def _batch_row(prof):
    """A profile's rows of the batch tables: the addresses of its C-ABI
    arrays (``hmmdp.cpp``'s ``BP_*`` order) and its sizes (``BI_*``:
    M, K, Kp, null2 (set per search), the consensus length), cached on
    the profile beside the arrays they point into."""
    pt = get_tensors(prof)
    cached = getattr(prof, "_native_batch_row", None)
    if cached is not None and cached[0] is pt:
        return cached[1], cached[2]
    from ..plan7.pipeline import Pipeline
    odds_m, odds_i = _odds_tables(prof)
    degw, deg_one = _null2_tables(prof.alphabet)
    sym_u, sym_l, cons_u8, cons_up, sym_up, mpos = (
        Pipeline._display_tables(prof))
    ptrs = ([a.ctypes.data for a in (pt.tBM, pt.tMM, pt.tIM, pt.tDM,
                                     pt.tMD, pt.tDD, pt.tMI, pt.tII,
                                     pt.msc, pt.isc, odds_m, odds_i)]
            + [pt.core or 0]
            + [a.ctypes.data for a in (degw, deg_one, sym_u, sym_l, sym_up,
                                       cons_u8, cons_up, mpos)])
    ints = np.array([pt.M, prof.alphabet.K, pt.Kp, 0, len(cons_u8)],
                    np.int32)
    row = np.array(ptrs, np.uint64)
    prof._native_batch_row = (pt, row, ints)
    return row, ints


class BatchTables:
    """The per-profile tables a search's batches index: one row of
    addresses and one of sizes a profile, with null2 on or off as its
    pipeline has it.  The profiles hold the arrays the rows point into,
    and this holds the profiles."""

    def __init__(self, profs, null2):
        rows = [_batch_row(p) for p in profs]
        self.profs = list(profs)
        self.ptr = np.array([r[0] for r in rows], np.uint64).reshape(
            len(rows), _BP_N)
        self.ints = np.array([r[1] for r in rows], np.int32).reshape(
            len(rows), _BI_N)
        self.ints[:, 3] = null2
        self.M = self.ints[:, 0].tolist()


def domaindef_batch(tables: BatchTables, prof_idx, dsq_ptr, lens, seeds,
                    fwd_min, vit_min, nsamples: int = 200,
                    rt1: float = 0.25, rt2: float = 0.10,
                    rt3: float = 0.20):
    """Finish a batch of survivor pairs in one native call, the GIL
    released for all of them.  Per pair (its ``tables`` row
    ``prof_idx``, its ``lens`` residues at address ``dsq_ptr``): the
    native Viterbi gate where its ``vit_min`` is finite (as
    :func:`viterbi_score`), then :func:`domaindef` with its ``seed`` and
    ``fwd_min``, and each domain's alignment display lines.

    Returns ``(ndd, out)``: the pairs that ran the domain definition,
    and the outputs, read back in one call: ``status`` [N] (``DD_*``),
    ``pair_int`` [N, 5] (regions, clustered, overlaps, envelopes,
    domains), ``n2_off`` [N] (where a hit pair's null2 scores [L+1]
    start in ``n2``, -1 for the others), ``dom_int`` [D, 6] (envelope,
    alignment and model bounds), ``dom_text`` [D, 2] (offset and length
    n in ``text`` of the model, target, identity and posterior lines, n
    bytes each), ``pair_dbl`` [N, 2] (Forward score, expected domains),
    ``dom_dbl`` [D, 3] (envelope score, null2 correction, optimal
    accuracy score), ``n2`` and ``text``; the domains in pair order."""
    lib = get_lib()
    n = len(lens)
    gated = [v is not None and math.isfinite(v) for v in vit_min]
    caps = _batch_caps(lens, [tables.M[p] for p in prof_idx])
    pair_i = np.array([
        (p, a, L, s & 0x7FFFFFFFFFFFFFFF, md, mt, g) for p, a, L, s, (md, mt), g
        in zip(prof_idx, dsq_ptr, lens, seeds, caps, gated)],
        np.int64).reshape(n, 7)
    pair_d = np.zeros((n, 4))
    pair_d[:, 0] = np.clip(fwd_min, -1e300, 1e300)
    if any(gated):
        # the floor and the length model of viterbi_score, as it
        # computes them
        on = np.flatnonzero(gated)
        pmove = 3.0 / (pair_i[on, 2] + 3.0)
        pair_d[on, 1] = [vit_min[k] for k in on.tolist()]
        pair_d[on, 2] = np.log(1.0 - pmove)
        pair_d[on, 3] = np.log(pmove)
    sizes = np.zeros(4, np.int64)
    ndd = lib.hmmdp_domaindef_batch(
        n, pair_i.ctypes.data, pair_d.ctypes.data, float(np.log(0.5)),
        tables.ptr.ctypes.data, tables.ints.ctypes.data, nsamples, rt1, rt2,
        rt3, sizes.ctypes.data)
    _, ndom, nn2, ntext = sizes.tolist()
    ints = np.empty(7 * n + 8 * ndom, np.int64)
    dbls = np.empty(2 * n + 3 * ndom + nn2)
    text = np.empty(ntext, np.uint8)
    lib.hmmdp_dd_batch_read(ints.ctypes.data, dbls.ctypes.data,
                            text.ctypes.data)
    i1, i2, i3 = n, 6 * n, 7 * n
    i4 = i3 + 6 * ndom
    d1, d2 = 2 * n, 2 * n + 3 * ndom
    return int(ndd), dict(
        status=ints[:i1], pair_int=ints[i1:i2].reshape(n, 5),
        n2_off=ints[i2:i3], dom_int=ints[i3:i4].reshape(ndom, 6),
        dom_text=ints[i4:].reshape(ndom, 2),
        pair_dbl=dbls[:d1].reshape(n, 2),
        dom_dbl=dbls[d1:d2].reshape(ndom, 3), n2=dbls[d2:], text=text)


def bias_filter_batch(odds1: np.ndarray, codes: np.ndarray,
                      lens: np.ndarray) -> Optional[np.ndarray]:
    """Native 2-state bias-filter log-odds scores (no null1 term) for a
    set of sequences against one profile's odds table.  ``odds1`` [Kp]
    f64; ``codes`` [N, Lmax] uint8 row-major; ``lens`` [N].  Returns
    logsc [N] f64, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    odds1 = np.ascontiguousarray(odds1, dtype=np.float64)
    N, Lmax = codes.shape
    out = np.empty(N, dtype=np.float64)
    lib.hmmdp_bias_filter_batch(codes, lens64, N, Lmax, odds1, out)
    return out


def bias_filter_rows(odds1: np.ndarray, codes: np.ndarray,
                     lens: np.ndarray, rows: np.ndarray
                     ) -> Optional[np.ndarray]:
    """Like :func:`bias_filter_batch` but over selected rows of a shared
    (already-contiguous) bucket matrix -- no fancy-index copy."""
    lib = get_lib()
    if lib is None:
        return None
    assert codes.flags["C_CONTIGUOUS"] and codes.dtype == np.uint8
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    rows64 = np.ascontiguousarray(rows, dtype=np.int64)
    odds1 = np.ascontiguousarray(odds1, dtype=np.float64)
    out = np.empty(len(rows64), dtype=np.float64)
    lib.hmmdp_bias_filter_idx(codes, lens64, rows64, len(rows64),
                              codes.shape[1], odds1, out)
    return out


def available() -> bool:
    return get_lib() is not None


def call_times() -> tuple:
    """``(wall, cpu)``: this thread's seconds inside ``hmmdp_domaindef``,
    ``hmmdp_domaindef_batch``, ``hmmdp_viterbi`` and
    ``hmmdp_bias_filter_idx`` since it started,
    timed by the library with the GIL released (the wait to retake it on
    return left out); ``(0.0, 0.0)`` without the library."""
    lib = get_lib()
    if lib is None:
        return 0.0, 0.0
    out = (ctypes.c_double * 2)()
    lib.call_times(out)
    return out[0], out[1]


#: phase labels for the hmmdp_phase_s diagnostic accumulators
PHASE_LABELS = ("full_fwd", "full_bck", "decode_regions", "env_fwdbck",
                "env_decode", "null2", "optacc_trace", "stotrace_cluster")


def phase_times() -> Optional[np.ndarray]:
    """Cumulative per-phase wall seconds spent inside hmmdp_domaindef,
    summed over all worker threads (the native side accumulates
    thread_local and sums under a mutex on read, so concurrent
    domaindef calls cannot lose updates)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(8, dtype=np.float64)
    lib.hmmdp_phase_get(out)
    return out


def phase_reset() -> None:
    lib = get_lib()
    if lib is None:
        return
    lib.hmmdp_phase_reset()
