"""The port's copy of the Plan7 host layer it needs: the model, the
configured and optimized profiles, model files and pressed databases, the
background, the model builder, the sequential oracle ``Pipeline``, the
long-targets (nhmmer) pipeline, iterative search, trace alignment, domain
definition, results, tabular output and the parameter views
(``pyhmmer_tpu/plan7``)."""

from .background import Background
from .builder import Builder
from .hmm import HMM, Transitions
from .hmmfile import HMMFile
from .iteration import IterationResult, IterativeSearch
from .longtargets import LongTargetsPipeline
from .optimized import (HMMPressedFile, OptimizedProfile,
                        OptimizedProfileBlock)
from .pipeline import Pipeline
from .profile import Profile, ProfileTransitions
from .results import Alignment, Domain, Hit, TopHits
from .tracealign import Trace, TraceAligner, Traces
from .views import Cutoffs, Domains, EvalueParameters, Offsets, ScoreData

__all__ = [
    "HMM", "HMMFile", "Transitions", "ProfileTransitions", "Background",
    "Profile", "Builder",
    "Pipeline", "LongTargetsPipeline", "TopHits", "Hit", "Domain", "Alignment",
    "OptimizedProfile", "OptimizedProfileBlock", "HMMPressedFile",
    "IterativeSearch", "IterationResult", "TraceAligner", "Trace", "Traces",
    "Cutoffs", "Domains", "EvalueParameters", "Offsets", "ScoreData",
]
