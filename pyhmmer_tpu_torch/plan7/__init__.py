"""The port's copy of the Plan7 host layer it needs: the model, the
configured and optimized profiles, model files and pressed databases, the
background, the model builder, the sequential oracle ``Pipeline``, the
long-targets (nhmmer) pipeline, iterative search, trace alignment, domain
definition and results (``pyhmmer_tpu/plan7``)."""

from .background import Background
from .builder import Builder
from .hmm import HMM
from .hmmfile import HMMFile
from .iteration import IterationResult, IterativeSearch
from .longtargets import LongTargetsPipeline
from .optimized import (HMMPressedFile, OptimizedProfile,
                        OptimizedProfileBlock)
from .pipeline import Pipeline
from .profile import Profile
from .results import Domain, Hit, TopHits
from .tracealign import Trace, TraceAligner, Traces

__all__ = ["Background", "Builder", "HMM", "HMMFile", "HMMPressedFile",
           "IterationResult", "IterativeSearch", "LongTargetsPipeline",
           "OptimizedProfile",
           "OptimizedProfileBlock", "Pipeline", "Profile", "Domain", "Hit",
           "TopHits", "Trace", "TraceAligner", "Traces"]
