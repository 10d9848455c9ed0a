"""Calibrate the smoke workload's sampled models with the port's
``Builder`` and hold them against the stored E-value parameters.

For each distinct model of ``pyhmmer_tpu_torch._synthetic.SMOKE_M`` the
script runs ``Builder(aa, device=...).calibrate`` (its random sequences
scored on the port's MSV and Viterbi kernels, or on their plain PyTorch
versions with ``--device cpu``) on a copy of the sampled model and prints
its six evparams beside the ones stored in
``tests/data/torch_smoke_evparams.json``, then the largest difference of
each evparam over the models.  With ``--write`` it writes its own
evparams, with each model's checksum (which ``_synthetic.smoke_models``
checks), into that file instead.  The stored table was written by the
JAX package's ``Builder``; the tests and ``chip_smoke.py`` hold the port
against it.

    python scripts/make_torch_smoke_evparams.py [--device cpu] [--write]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch.plan7 import Background, Builder  # noqa: E402

#: the six evparams, in ``HMM.evparam`` order
NAMES = ("m_mu", "m_lambda", "v_mu", "v_lambda", "f_tau", "f_lambda")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--write", action="store_true",
                    help="write this run's evparams into the stored table")
    args = ap.parse_args()
    models = syn.sample_models(syn.SMOKE_M, syn.SMOKE_SEED)
    aa = models[0].alphabet
    bg = Background(aa)
    builder = Builder(aa, device=args.device)
    with open(syn.EVPARAMS) as fh:
        stored = json.load(fh)
    table, worst = {}, np.zeros(len(NAMES))
    for h in models:
        builder.calibrate(h, bg)
        name = h.name.decode()
        got = [float(x) for x in h.evparam]
        table[name] = {"evparams": got, "checksum": syn.model_checksum(h)}
        want = stored[name]["evparams"]
        diff = np.abs(np.asarray(got, np.float32)
                      - np.asarray(want, np.float32))
        worst = np.maximum(worst, diff)
        print(json.dumps({"model": name, "evparams": got, "stored": want}),
              flush=True)
    print(json.dumps({"device": args.device,
                      "max_abs_diff": dict(zip(NAMES, worst.tolist()))}))
    if args.write:
        with open(syn.EVPARAMS, "w") as fh:
            json.dump(table, fh, indent=1, sort_keys=True)
            fh.write("\n")


if __name__ == "__main__":
    main()
