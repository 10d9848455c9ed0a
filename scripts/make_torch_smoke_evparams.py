"""Calibrate the smoke workload's sampled models once and store their
E-value parameters for the PyTorch port.

The port cannot calibrate without JAX yet (``Builder.calibrate`` scores
random sequences through ``pyhmmer_tpu.ops.batch``), so this script runs
it with the JAX package on the CPU, on a JAX-package copy of each of the
port's sampled models, and writes
``tests/data/torch_smoke_evparams.json``: for each distinct model of
``pyhmmer_tpu_torch._synthetic.SMOKE_M``, the six evparams and a
checksum of the sampled model, which ``_synthetic.smoke_models`` checks.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_evparams.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pyhmmer_tpu.easel.alphabet import Alphabet  # noqa: E402
from pyhmmer_tpu.plan7.background import Background  # noqa: E402
from pyhmmer_tpu.plan7.builder import Builder  # noqa: E402
from pyhmmer_tpu.plan7.hmm import HMM  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402


def main():
    models = syn.sample_models(syn.SMOKE_M, syn.SMOKE_SEED)
    aa = Alphabet.amino()
    bg = Background(aa)
    table = {}
    for h in models:
        jh = HMM(aa, h.M, name=h.name)
        jh.t[...], jh.mat[...], jh.ins[...] = h.t, h.mat, h.ins
        Builder(aa).calibrate(jh, bg)
        table[h.name.decode()] = {
            "evparams": [float(x) for x in jh.evparam],
            "checksum": syn.model_checksum(h)}
        print(h.name.decode(), table[h.name.decode()], flush=True)
    os.makedirs(os.path.dirname(syn.EVPARAMS), exist_ok=True)
    with open(syn.EVPARAMS, "w") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
