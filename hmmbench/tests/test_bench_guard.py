"""What a run refuses: JAX and the JAX package in the process, a machine
without a card; and what the sources import."""

import ast
import json
import os
import subprocess
import sys

import pytest

from hmmbench.harness import forbidden_modules
from hmmbench.tests.helpers import ROOT


@pytest.mark.parametrize("loaded, bad", [
    (["pyhmmer_tpu_torch", "pyhmmer_tpu_torch.engine", "numpy"], []),
    (["pyhmmer_tpu", "numpy"], ["pyhmmer_tpu"]),
    (["pyhmmer_tpu.engine"], ["pyhmmer_tpu.engine"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["jaxtyping", "pyhmmer_tpu_torchx", "flaxen"], []),
])
def test_top_level_names_compared_whole(loaded, bad):
    assert forbidden_modules(loaded) == bad


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            out.add(n.module.split(".")[0])
    return out


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in (ROOT / "hmmbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = top_level_imports(path)
        assert not names & {"jax", "jaxlib", "flax", "pyhmmer_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "hmmbench" / "reference").glob("*.py"):
        assert top_level_imports(path) <= {
            "__future__", "math", "copy", "os", "multiprocessing",
            "concurrent", "dataclasses", "typing", "numpy", "scipy",
            "torch"}, path


def test_run_without_a_card_fails_and_prints_no_result():
    if os.environ.get("CUDA_VISIBLE_DEVICES") != "":
        import torch
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "hmmbench/run.py"), "--workload",
         "pfam-hmmsearch.oneshot", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        assert "correct" not in line
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("held", [False, True])
def test_benchmark_json_names_files_that_exist(held):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if held:
        # the cells held out, as a later change would add them
        for p in sorted((ROOT / "hmmbench/held").glob("*.json")):
            for group, entries in json.loads(p.read_text()).items():
                bench[group] += entries
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (ROOT / "hmmbench/traffic" / (w["traffic"] + ".json")
                ).is_file()
        assert (ROOT / "hmmbench/limits" / (w["name"] + ".json")).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "hmmbench/metrics" / (m["name"] + ".py")).is_file()
