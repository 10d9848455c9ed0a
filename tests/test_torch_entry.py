"""The port's entry points (``pyhmmer_tpu_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU: ``entry``'s
batched Forward step (the plain version of the port's Forward kernel)
within 0.05 nats of the JAX package's under ``jax.jit`` on the same
seeded problem, and ``dryrun_multichip(4)`` over four CPU devices, its
2-process run included."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from pyhmmer_tpu_torch import graft_entry

torch.set_num_threads(1)

BAR = 0.05


def test_entry_matches_jax():
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args).numpy()
    jfn, jargs = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == want.shape == (2, 8)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < BAR
    assert all(a.device.type == "cpu" for a in args)


def test_entry_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()


def test_dryrun_multichip_on_cpu_devices(capsys):
    out = graft_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["devices"] == ["cpu"]
    assert out["mesh"] == {"model": 2, "data": 2}
    assert abs(out["fwd00"] - out["oracle00"]) < 0.1
    assert out["sharded"]["n_shards"] == 4 and out["reported"] > 0
    assert len(out["ranks"]) == 2
    assert "2-process multihost ok" in capsys.readouterr().out
