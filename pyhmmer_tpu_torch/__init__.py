"""pyhmmer_tpu_torch -- the PyTorch/CUDA port of pyhmmer_tpu's search
path.

``hmmsearch``, ``hmmscan``, ``phmmer`` and ``jackhmmer`` run the filter
cascade (MSV with the fused bias filter, Forward, Viterbi) as
hand-written CUDA kernels on an NVIDIA Hopper GPU, or as their plain
PyTorch versions on the CPU, and report hits through the same exact host
postprocessing as ``pyhmmer_tpu``; ``nhmmer`` gates its long-target
subwindows on the same kernels; the model ``Builder`` calibrates
E-values on the MSV and Viterbi kernels.  Models of any width run on
the card (past 4,096 slots on the kernels' wide route).  ``hmmalign`` and
``hmmpress`` run on the host.  ``parallel.mesh`` shards a search over
devices (``sharded_search``, ``sharded_nhmmer``, ``ShardedCascade``),
``parallel.multihost`` over processes (``torch.distributed``, gloo), and
``graft_entry`` holds the entry points (``entry``,
``dryrun_multichip``).  The package keeps its own copy of the host
layers (``easel``, with the MSA files, genetic codes and BLAST volumes;
``plan7``, with the hit tables; ``ops.{native,reference,quantize}``,
``daemon``, ``csrc/hmmdp.cpp``), so that it defines every module of
``pyhmmer_tpu`` but the Pallas kernels, and imports neither JAX nor any
module of ``pyhmmer_tpu``.

Builds, each at first use and never at import, under ``build/`` at the
root of the checkout: the CUDA kernels (``csrc/*.cu``, nvcc for
``sm_90a``) into ``build/torch_kernels/`` on the first launch, and the
host DP library (``csrc/hmmdp.cpp``, g++) into ``build/torch_host/`` on
the first native call.

Tests: on the CPU, ``python -m pytest tests/test_torch_*.py`` (the GPU
tests skip); on a card, ``python3 chip_smoke.py`` and
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

__version__ = "0.1.0"

from . import daemon, easel, errors, hmmer, plan7
from .engine import SearchEngine
from .hmmer import (hmmalign, hmmpress, hmmscan, hmmsearch, jackhmmer,
                    nhmmer, phmmer)

__all__ = [
    "easel", "errors", "plan7", "hmmer", "daemon",
    "hmmsearch", "hmmscan", "phmmer", "nhmmer", "jackhmmer",
    "hmmalign", "hmmpress", "SearchEngine", "__version__",
]
