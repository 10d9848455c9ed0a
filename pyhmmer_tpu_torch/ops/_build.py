"""Build and bind the port's CUDA kernels (``pyhmmer_tpu_torch/csrc``).

At first use -- never at import -- every ``csrc/*.cu`` is compiled with
``nvcc`` for ``sm_90a`` and linked into one shared library under
``build/torch_kernels/`` at the root of the checkout.  The library is
rebuilt when a source is newer than it, the way
``pyhmmer_tpu/ops/native.py`` rebuilds the host C++ library.  Processes
sharing a checkout take an ``fcntl`` lock on ``build/torch_kernels/.lock``
around the check and the build; each compiles in a directory of its own
and moves only the finished library and its report into place.

The library has a plain C interface and is loaded with ``ctypes``: every
pointer and the CUDA stream travel as ``c_void_p``, and every entry
point returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception.  The ``-Xptxas -v`` report of
the build (registers, shared memory and spills per kernel) is kept
beside the library; :func:`ptxas_report` returns it.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB = os.path.join(BUILD, "libpyhmmer_torch_kernels.so")
PTXAS_LOG = os.path.join(BUILD, "ptxas.log")
LOCK = os.path.join(BUILD, ".lock")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points and their argument types (all return an int: an error
#: code, or for ``fwd_block_warps`` a count)
SIGNATURES = {
    # codes, Lmax, lens, w16, scal, odds, tjb, p1, B, P, Kp, S,
    # dx, ovf, biaslog, stream
    "msv_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _P, _P, _P, _P],
    # codes, Lmax, lens, lm, emis, trans, pair_p, pair_row, pair_out,
    # npairs, Kp, S, route, out, stream
    "vit_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _P, _P],
    # codes, Lmax, lens, lm, emis, trans, pair_p, pair_row, pair_out,
    # npairs, Kp, S, out, stream
    "fwd_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                   _P, _P],
    # the wide route: the same, with Mk for S (vit and fwd: with Mk and
    # the CTA's threads, without a route, and with a scratch buffer and
    # its CTA count after out)
    "msv_cta_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _P, _P, _P, _P],
    "vit_cta_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P, _P, _I, _P],
    "fwd_cta_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P, _P, _I, _P],
    # S: the warps a pair of Forward's block route at S slots a lane (0:
    # none there)
    "fwd_block_warps": [_I],
    # codes, Lmax, lens, lm, emis, trans, pair_p, pair_row, npairs, Kp,
    # S, route, frows, fsc, terms, bsc, stream
    "rows_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_count_lock = threading.Lock()


def count_launch(namespace: dict, route: Optional[str] = None) -> None:
    """Add one to ``launches`` in a wrapper module's ``namespace`` and,
    for a launch of a route counted apart (``"wide"``: the wide route,
    models over 4,096 slots; ``"block"``: Forward's block route, 32 to
    128 slots a lane), to ``launches_<route>``, under a lock: the shard
    engines of ``parallel.mesh.sharded_search`` launch from threads of
    their own, and ``launches += 1`` is no atomic update."""
    with _count_lock:
        namespace["launches"] += 1
        if route:
            namespace["launches_" + route] += 1


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or nvcc on PATH)")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    t = os.path.getmtime(LIB)
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > t for s in deps)


def build() -> None:
    """Compile every source to an object in parallel in a private
    directory, link, then move the library and the report into place."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD, prefix="tmp-") as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, obj, pr in procs:
            out, _ = pr.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if pr.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        so = os.path.join(tmp, os.path.basename(LIB))
        subprocess.run([nvcc, "-shared", "-o", so,
                        *[o for _, o, _ in procs]],
                       check=True, capture_output=True, text=True)
        report = os.path.join(tmp, os.path.basename(PTXAS_LOG))
        with open(report, "w") as fh:
            fh.write("\n".join(log))
        os.replace(report, PTXAS_LOG)
        os.replace(so, LIB)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            os.makedirs(BUILD, exist_ok=True)
            with open(LOCK, "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if _stale():
                    build()
            handle = ctypes.CDLL(LIB)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.pyhmmer_cuda_error_string.argtypes = [_I]
            handle.pyhmmer_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib().pyhmmer_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptxas_report() -> str:
    """The ``-Xptxas -v`` lines of the last build (empty if none)."""
    if not os.path.exists(PTXAS_LOG):
        return ""
    with open(PTXAS_LOG) as fh:
        return fh.read()


def stream_ptr(tensor) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(
        tensor.device).cuda_stream)


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())
