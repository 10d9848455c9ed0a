"""The port's copy of the Plan7 host layer it needs: the model, the
configured profile, the background, the sequential oracle ``Pipeline``,
domain definition and results (``pyhmmer_tpu/plan7``)."""

from .background import Background
from .hmm import HMM
from .pipeline import Pipeline
from .profile import Profile
from .results import Domain, Hit, TopHits

__all__ = ["Background", "HMM", "Pipeline", "Profile", "Domain", "Hit",
           "TopHits"]
