"""The wide phmmer's self-hit through the engine and through the
sequential oracle, in the port and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/engine_oracle_gap.py

The query is the smoke workload's 9,000-residue target
(``pyhmmer_tpu_torch/_synthetic.py``), searched against itself and every
14th target, as ``chip_smoke.py``'s phase ``wide`` does on the card.
Prints one JSON line: the self-hit's score in each of the four runs.
The engine takes the forward score from the native ``domaindef`` and the
oracle from ``ops/reference.forward``; both are float64 but sum the
9,000 x 9,000 cells in other orders.  Takes about 6 minutes, most of it
the JAX package's engine on its XLA scans.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from pyhmmer_tpu import hmmer as jax_hmmer  # noqa: E402
from pyhmmer_tpu.easel.sequence import \
    DigitalSequenceBlock as JBlock  # noqa: E402
from pyhmmer_tpu.plan7.builder import Builder as JBuilder  # noqa: E402
from pyhmmer_tpu.plan7.pipeline import Pipeline as JPipeline  # noqa: E402
import pyhmmer_tpu_torch  # noqa: E402
from pyhmmer_tpu_torch import _synthetic as syn  # noqa: E402
from pyhmmer_tpu_torch.easel import DigitalSequenceBlock  # noqa: E402
from pyhmmer_tpu_torch.plan7 import Builder, Pipeline  # noqa: E402
from test_torch_host import jax_block  # noqa: E402

STRIDE = 14


def self_score(th, name):
    return next(h.score for h in th.hits if h.name == name)


def main():
    _, _, targets, _ = syn.smoke_workload()
    aa = targets.alphabet
    query = next(s for s in targets if len(s) == syn.SMOKE_LONG[0])
    subset = DigitalSequenceBlock(aa, [query] + [
        targets[i] for i in range(0, len(targets), STRIDE)])
    jsubset = jax_block(subset)
    jquery = jsubset[0]
    out = {
        "port_engine": self_score(next(pyhmmer_tpu_torch.phmmer(
            query, subset, device="cpu")), query.name),
        "port_oracle": self_score(Pipeline(aa).search_seq(
            query, subset, builder=Builder(aa, device="cpu")), query.name),
        "jax_engine": self_score(next(jax_hmmer.phmmer(jquery, jsubset)),
                                 query.name),
        "jax_oracle": self_score(JPipeline(jsubset.alphabet).search_seq(
            jquery, JBlock(jsubset.alphabet, list(jsubset)),
            builder=JBuilder(jsubset.alphabet)), query.name),
    }
    print(json.dumps({"targets": len(subset), "query_length": len(query),
                      **out}))


if __name__ == "__main__":
    main()
