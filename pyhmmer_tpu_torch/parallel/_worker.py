"""One rank of a multi-process search over a seeded workload, and the
launcher of such a run on this host.

    python -m pyhmmer_tpu_torch.parallel._worker <pid> <nproc> <port> \\
        <device> <workload> <out>

initializes ``torch.distributed`` (``gloo``) against the coordinator
``127.0.0.1:<port>``, builds the named workload (:func:`workload`:
``tiny`` for a CPU test, ``smoke`` for the card), runs
:func:`~pyhmmer_tpu_torch.parallel.multihost.multihost_search` with its
engine on ``<device>``, and writes to ``<out>`` as JSON the reported
rows and ``(Z, nseqs, n_past_msv, n_past_fwd)`` of every query, the
rank's walls, the record bytes it exchanged and the kernel launches it
made.  Every rank must write the same table, the one-process search's
(:func:`table`).  :func:`spawn` starts the ranks as fresh interpreters
(never a fork of a process that holds a CUDA context) and waits for
each with a timeout.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

#: the ``tiny`` workload: the first smoke models against a few planted
#: targets
TINY_MODELS = 3
TINY_TARGETS = 120
TINY_SEED = 77


def workload(name: str):
    """(queries, targets) of a named seeded workload: ``tiny`` (3
    calibrated smoke models, M 50-90, against 120 planted targets) or
    ``smoke`` (``chip_smoke.py``'s search: 245 queries x 4,002
    targets)."""
    from .. import _synthetic as syn
    if name == "tiny":
        models = syn.smoke_models()[:TINY_MODELS]
        targets, _ = syn.make_targets(models, TINY_TARGETS, seed=TINY_SEED)
        return models, targets
    if name == "smoke":
        queries, _, targets, _ = syn.smoke_workload()
        return queries, targets
    raise ValueError(f"unknown workload {name!r}")


def table(results) -> dict:
    """The reported rows (name, score to 9 decimals, E-value to 12,
    included) and the accounting ``[Z, nseqs, n_past_msv,
    n_past_fwd]`` of each query's ``TopHits``, as JSON values."""
    return {"rows": [[[h.name.decode(), round(h.score, 9),
                       round(h.evalue, 12), bool(h.included)]
                      for h in th.reported] for th in results],
            "acct": [[th.Z, th.nseqs, th.n_past_msv, th.n_past_fwd]
                     for th in results]}


def main(argv) -> None:
    import torch
    import torch.distributed as dist

    from ..ops import fwd_cuda, msv_cuda, rows_cuda, vit_cuda
    from . import multihost

    pid, nproc, port = (int(a) for a in argv[:3])
    device, name, out_path = argv[3:6]
    t0 = time.time()
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
    if multihost.world() != (nproc, pid):
        raise RuntimeError(f"process group {multihost.world()} is not "
                           f"({nproc}, {pid})")
    queries, targets = workload(name)
    kernels = {"msv": msv_cuda, "fwd": fwd_cuda, "vit": vit_cuda,
               "rows": rows_cuda}
    for mod in kernels.values():
        mod.launches = 0
    t1 = time.time()
    results = multihost.multihost_search(queries, targets, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t2 = time.time()
    out = dict(table(results), rank=pid, device=device,
               wall_s=time.time() - t0, run_s=t2 - t1,
               launches={k: m.launches for k, m in kernels.items()},
               **multihost.multihost_search.last_stats)
    dist.destroy_process_group()
    with open(out_path, "w") as fh:
        json.dump(out, fh)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(devices, name: str, out_dir: str, timeout: float = 600.0):
    """Run ``len(devices)`` ranks of ``name`` on this host, rank ``k``'s
    engine on ``devices[k]``, and return (each rank's JSON, in rank
    order; the number of retries).  The coordinator's port is one the OS
    had free a moment before: if a rank then fails to bind it, the run
    is made once more on another port.  A rank that fails or outlives
    ``timeout`` seconds raises (and every rank is killed)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    nproc = len(devices)
    for attempt in (0, 1):
        port = _free_port()
        outs = [os.path.join(out_dir, f"rank{p}.json")
                for p in range(nproc)]
        logs = [os.path.join(out_dir, f"rank{p}.log") for p in range(nproc)]
        procs = []
        try:
            # each rank's output goes to a file: a full pipe would stall
            # a rank that the others wait for in a collective
            for p in range(nproc):
                with open(logs[p], "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "pyhmmer_tpu_torch.parallel._worker", str(p),
                         str(nproc), str(port), str(devices[p]), name,
                         outs[p]], cwd=root, env=env, stdout=log,
                        stderr=subprocess.STDOUT))
            for proc in procs:
                proc.wait(timeout=timeout)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        errs = []
        for log in logs:
            with open(log, errors="replace") as fh:
                errs.append(fh.read())
        failed = [(p, e) for p, (proc, e) in enumerate(zip(procs, errs))
                  if proc.returncode != 0]
        if not failed:
            results = []
            for o in outs:
                with open(o) as fh:
                    results.append(json.load(fh))
            return results, attempt
        if attempt == 0 and any("EADDRINUSE" in e
                                or "ddress already in use" in e
                                for _, e in failed):
            continue
        p, e = failed[0]
        raise RuntimeError(f"rank {p} of {nproc} failed:\n{e[-3000:]}")


if __name__ == "__main__":
    main(sys.argv[1:])
