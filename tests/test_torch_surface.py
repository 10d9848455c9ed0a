"""The port covers the JAX package: every module of ``pyhmmer_tpu`` has
its counterpart module in ``pyhmmer_tpu_torch``, every function, class
and method of a counterpart is defined in the port's, and every name of
the JAX package's ``__all__`` lists resolves in the port.  The exceptions
are listed here, each with what takes its place in the port, and the
lists must be exact: a name that the port gains, or loses, fails the
test until the list says so.  Read by AST; nothing of either package
runs but the imports of the ``__all__`` check."""

import ast
import importlib
import os

import pytest

from test_torch_host import imported_modules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "pyhmmer_tpu")
PORT = os.path.join(ROOT, "pyhmmer_tpu_torch")

#: the JAX package's Pallas modules, each with the port's wrapper of the
#: hand-written CUDA kernel that replaces its kernels
PALLAS = {
    "ops/msv_pallas": "ops/msv_cuda",
    "ops/fwd_pallas": "ops/fwd_cuda",
    "ops/vit_pallas": "ops/vit_cuda",
    "ops/rows_pallas": "ops/rows_cuda",
}

#: definitions the port does not add, each with its counterpart in the
#: port as (module, definition)
NOT_ADDED = {
    # the XLA scans and their helpers: the CUDA kernels' wrappers and
    # their plain PyTorch versions
    "ops/batch": {
        "_msv_kernel": ("ops/msv_cuda", "msv_plain"),
        "msv_scores": ("ops/msv_cuda", "msv"),
        "_bias_scan": ("ops/msv_cuda", "msv_plain"),
        "bias_filter_scores": ("ops/msv_cuda", "msv"),
        "_forward_kernel": ("ops/fwd_cuda", "fwd_plain"),
        "forward_scores": ("ops/fwd_cuda", "forward"),
        "_lse": ("ops/fwd_cuda", "fwd_plain"),
        "_viterbi_kernel": ("ops/vit_cuda", "vit_plain"),
        "viterbi_scores": ("ops/vit_cuda", "viterbi"),
        "_pad8": ("ops/batch", "round_up"),
        "_pb_device": ("ops/batch", "ProfileBatch"),
        "_seqdev_strips": ("ops/batch", "SeqDevice"),
        "_seqdev_tile_bounds": ("ops/batch", "SeqDevice"),
    },
    # the JAX engine's device helpers: the port's engine launches the
    # wrappers on its buckets' device tensors and hands them pair lists
    "engine": {
        "SearchEngine._msv_dev": ("ops/msv_cuda", "msv"),
        "SearchEngine._forward_dev": ("ops/fwd_cuda", "forward"),
        "SearchEngine._viterbi_dev": ("ops/vit_cuda", "viterbi"),
        "SearchEngine._search_impl": ("engine", "SearchEngine.search"),
        "_gather_rows_dev": ("engine", "SearchEngine._survivors"),
        "_gather_rows_dev_impl": ("engine", "SearchEngine._survivors"),
        "_gather_survivors": ("engine", "SearchEngine._survivors"),
        "_gather_survivors_strips": ("engine", "SearchEngine._survivors"),
        "_pad_b": ("ops/_pairs", "host_pairs"),
        "_pt_bounds": ("ops/_pairs", "host_pairs"),
    },
    # a NamedSharding device_put: the port moves each shard's tensors
    "parallel/mesh": {
        "ShardedCascade._shard": ("parallel/mesh", "ShardedCascade._shards"),
    },
}

#: files at the root of the repository that drive the JAX package, each
#: with its counterpart in the port, or None where the port has none yet
ROOT_FILES = {
    "__graft_entry__.py": "pyhmmer_tpu_torch/graft_entry.py",
    # the end-to-end benchmark; the port measures through chip_smoke.py
    # and scripts/bench_torch_*.py until it has one
    "bench.py": None,
}


def modules(root):
    """Module paths (``easel/msa``) of every ``.py`` file under ``root``."""
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root)
                out.add(rel[:-3].replace(os.sep, "/"))
    return out


def definitions(path):
    """Top-level functions and classes and the classes' methods
    (``Class.method``) of a module."""
    out = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{item.name}" for item in node.body
                       if isinstance(item, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)))
    return out


JAX_MODULES = sorted(modules(JAX))


def test_every_module_has_its_counterpart():
    port = modules(PORT)
    assert len(JAX_MODULES) > 40
    missing = {m for m in JAX_MODULES if m not in port}
    assert missing == set(PALLAS)
    assert set(PALLAS.values()) <= port


@pytest.mark.parametrize("module", [m for m in JAX_MODULES
                                    if m not in PALLAS])
def test_every_definition_is_in_the_port(module):
    want = definitions(os.path.join(JAX, module + ".py"))
    got = definitions(os.path.join(PORT, module + ".py"))
    assert want - got == set(NOT_ADDED.get(module, {}))


@pytest.mark.parametrize("module, name", [
    (m, n) for m, names in sorted(NOT_ADDED.items()) for n in sorted(names)])
def test_each_exception_names_its_counterpart(module, name):
    where, what = NOT_ADDED[module][name]
    assert what in definitions(os.path.join(PORT, where + ".py"))


def test_root_files_of_the_jax_package():
    """The root scripts that import the JAX package are the listed ones,
    each with its counterpart where the port has one."""
    driving = {f for f in os.listdir(ROOT) if f.endswith(".py") and any(
        m.split(".")[0] == "pyhmmer_tpu"
        for m in imported_modules(os.path.join(ROOT, f)))}
    assert driving == set(ROOT_FILES)
    for counterpart in ROOT_FILES.values():
        if counterpart is not None:
            assert os.path.exists(os.path.join(ROOT, counterpart))


@pytest.mark.parametrize("module", ["", ".easel", ".plan7", ".hmmer",
                                    ".parallel"])
def test_public_names_resolve(module):
    jax = importlib.import_module("pyhmmer_tpu" + module)
    port = importlib.import_module("pyhmmer_tpu_torch" + module)
    assert jax.__all__
    missing = [n for n in jax.__all__ if not hasattr(port, n)]
    assert not missing
    assert set(jax.__all__) <= set(port.__all__)
