"""Optimized (quantized) profiles.

Mirrors ``pyhmmer.plan7.OptimizedProfile`` / ``OptimizedProfileBlock``
(reference ``src/pyhmmer/plan7.pyx:4183-5123``).

The port's copy of ``pyhmmer_tpu/plan7/optimized.py``, for hmmscan's
``OptimizedProfile`` inputs: the quantized tables come from
:mod:`pyhmmer_tpu_torch.ops.quantize`, and an optimized profile keeps its
configured profile, whose core model the scan searches.  It leaves out
``OptimizedProfile.write`` and ``HMMPressedFile``, which read and write
pressed databases (``plan7/pressed.py``, not in the port).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..easel.alphabet import Alphabet
from ..ops import reference as refops
from ..ops.quantize import MSVQuant, quantize_msv
from .profile import Profile
from .views import Offsets

__all__ = ["OptimizedProfile", "OptimizedProfileBlock"]


class OptimizedProfile:
    """A quantized search profile (``P7_OPROFILE`` equivalent)."""

    def __init__(self, profile: Profile, quant: Optional[MSVQuant] = None):
        self._profile = profile
        self.quant = quant or quantize_msv(profile)
        self.offsets = Offsets()

    @classmethod
    def convert(cls, profile: Profile) -> "OptimizedProfile":
        return cls(profile)

    # --- delegated metadata -------------------------------------------------

    @property
    def M(self) -> int:
        return self._profile.M

    @property
    def L(self) -> int:
        return self._profile.L

    @property
    def name(self) -> bytes:
        return self._profile.name

    @property
    def accession(self):
        return self._profile.accession

    @property
    def description(self):
        return self._profile.description

    @property
    def alphabet(self) -> Alphabet:
        return self._profile.alphabet

    @property
    def evparam(self):
        return self._profile.evparam

    @property
    def evalue_parameters(self):
        """The E-value parameters view (ref ``plan7.pyx:4183+``)."""
        return self._profile.evparam

    @property
    def local(self) -> bool:
        return self._profile.local

    @property
    def multihit(self) -> bool:
        return self._profile.multihit

    @property
    def cutoffs(self):
        return self._profile.cutoffs

    @property
    def consensus(self):
        return self._profile.consensus

    @property
    def profile(self) -> Profile:
        return self._profile

    @property
    def bias(self) -> int:
        return self.quant.bias_b

    @property
    def base(self) -> int:
        return self.quant.base_b

    @property
    def scale_b(self) -> float:
        return self.quant.scale_b

    @property
    def rbv(self) -> np.ndarray:
        """uint8 MSV emission costs [Kp, M] (``om->rbv`` equivalent)."""
        return self.quant.cost.astype(np.uint8)

    # --- reference quantized-field accessors (p7_oprofile.pxd:52-109).
    # This engine keeps one quantization (the uint8 MSV bands); the
    # 16-bit Viterbi and f32 Forward run unquantized on device, so the
    # corresponding views are derived rather than stored. --------------

    @property
    def sbv(self) -> np.ndarray:
        """uint8 SSV emission costs [Kp, M] (same table as ``rbv``)."""
        return self.quant.cost.astype(np.uint8)

    @property
    def bias_b(self) -> int:
        return int(self.quant.bias_b)

    @property
    def base_b(self) -> int:
        return int(self.quant.base_b)

    @property
    def tec_b(self) -> int:
        return int(self.quant.tec_b)

    @property
    def tbm_b(self) -> int:
        return int(self.quant.tbm_b)

    # aliases used by the reference docs
    tbm = tbm_b
    tec = tec_b

    @property
    def tjb(self) -> int:
        """Quantized NJC move cost for the configured length."""
        L = self.L
        scale = self.quant.scale_b
        return int(min(255, round(-scale * np.log(3.0 / (L + 3.0)))))

    @property
    def scale_w(self) -> float:
        """16-bit Viterbi score scale (reference value 500/log2;
        informational -- the device Viterbi runs in f32)."""
        return 500.0 / np.log(2.0)

    @property
    def base_w(self) -> int:
        return 12000

    @property
    def ddbound_w(self) -> int:
        return 0

    @property
    def ncj_roundoff(self) -> float:
        return 0.0

    @property
    def rfv(self) -> np.ndarray:
        """f32 Forward emission odds [Kp, M+1] (``om->rfv`` equivalent)."""
        m = self._profile.msc
        return np.exp(np.where(np.isfinite(m), m, -np.inf)).astype(
            np.float32)

    @property
    def tfv(self) -> np.ndarray:
        """f32 Forward transition odds, ProfileTransitions order."""
        return np.exp(self._profile.transition_scores).astype(np.float32)

    @property
    def xf(self) -> np.ndarray:
        """f32 special transitions [4, 2] (E,N,J,C x (loop,move))."""
        p = self._profile
        x = np.stack([p.xE, p.xN, p.xJ, p.xC])
        return np.exp(np.where(np.isfinite(x), x, -np.inf)).astype(
            np.float32)

    @property
    def compositions(self):
        """Model mean residue composition (``om->compo``)."""
        return self._profile.compo

    @property
    def reference(self):
        return getattr(self._profile, "reference", None)

    @property
    def model_mask(self):
        return getattr(self._profile, "model_mask", None)

    @property
    def consensus_structure(self):
        return getattr(self._profile, "consensus_structure", None)

    def reconfig_length(self, L: int) -> None:
        self._profile.reconfig_length(L)

    def copy(self) -> "OptimizedProfile":
        return OptimizedProfile(self._profile.copy(), self.quant)

    # --- direct kernel entry points (plan7.pyx:4750-4851) -------------------

    def msv_filter(self, seq) -> float:
        """Quantized MSV filter score of one sequence, in nats."""
        return float(refops.msv_score_quantized(self._profile, seq.sequence))

    def ssv_filter(self, seq) -> float:
        """SSV filter score of one sequence, in nats."""
        return float(refops.ssv_score(self._profile, seq.sequence))

    def __repr__(self) -> str:
        return f"<OptimizedProfile name={self.name!r} M={self.M}>"


class OptimizedProfileBlock:
    """Container of optimized profiles sharing an alphabet
    (``plan7.pyx:4853-5123``; the per-profile locks of the reference are
    unnecessary here -- profiles are reconfigured per batched call)."""

    def __init__(self, alphabet: Alphabet, iterable=()):
        self.alphabet = alphabet
        self._profiles: List[OptimizedProfile] = []
        for p in iterable:
            self.append(p)

    def append(self, om: OptimizedProfile) -> None:
        if om.alphabet != self.alphabet:
            raise ValueError("alphabet mismatch")
        self._profiles.append(om)

    def clear(self):
        self._profiles.clear()

    def extend(self, it):
        for p in it:
            self.append(p)

    def __len__(self):
        return len(self._profiles)

    def __iter__(self):
        return iter(self._profiles)

    def __getitem__(self, i):
        if isinstance(i, slice):
            out = OptimizedProfileBlock(self.alphabet)
            out._profiles = self._profiles[i]
            return out
        return self._profiles[i]

    def __contains__(self, om) -> bool:
        return om in self._profiles

    def copy(self) -> "OptimizedProfileBlock":
        out = OptimizedProfileBlock(self.alphabet)
        out._profiles = list(self._profiles)
        return out

    def index(self, om: OptimizedProfile) -> int:
        return self._profiles.index(om)

    def insert(self, i: int, om: OptimizedProfile) -> None:
        if om.alphabet != self.alphabet:
            raise ValueError("alphabet mismatch")
        self._profiles.insert(i, om)

    def pop(self, i: int = -1) -> OptimizedProfile:
        return self._profiles.pop(i)

    def remove(self, om: OptimizedProfile) -> None:
        self._profiles.remove(om)
