"""The port's copy of the Plan7 host layer it needs: the model, the
configured profile, the background, the model builder, the sequential
oracle ``Pipeline``, iterative search, trace alignment, domain definition
and results (``pyhmmer_tpu/plan7``)."""

from .background import Background
from .builder import Builder
from .hmm import HMM
from .iteration import IterationResult, IterativeSearch
from .pipeline import Pipeline
from .profile import Profile
from .results import Domain, Hit, TopHits
from .tracealign import Trace, TraceAligner, Traces

__all__ = ["Background", "Builder", "HMM", "IterationResult",
           "IterativeSearch", "Pipeline", "Profile", "Domain", "Hit",
           "TopHits", "Trace", "TraceAligner", "Traces"]
