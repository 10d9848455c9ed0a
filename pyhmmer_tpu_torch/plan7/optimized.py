"""Optimized (quantized) profiles and pressed profile databases.

The port's copy of ``pyhmmer_tpu/plan7/optimized.py``
(``pyhmmer.plan7.OptimizedProfile`` / ``HMMPressedFile`` /
``OptimizedProfileBlock``): the quantized tables come from
:mod:`pyhmmer_tpu_torch.ops.quantize`, and an optimized profile keeps its
configured profile, whose core model hmmscan searches.  A pressed
database's ``.h3m`` member carries the full model, so
:class:`HMMPressedFile` reconstructs optimized profiles from it (or, for
a database pressed by HMMER itself, from its ``.h3f``/``.h3p`` members,
``plan7/pressed.py``); the ``.h3f``/``.h3p`` members are written in
HMMER's byte layout.
"""

from __future__ import annotations

import os
import struct
import numpy as np
from typing import Iterator, List, Optional

from ..easel.alphabet import Alphabet
from .views import Offsets
from .hmm import HMM
from .background import Background
from .profile import Profile
from ..ops.quantize import quantize_msv, MSVQuant
from ..ops import reference as refops

__all__ = ["OptimizedProfile", "OptimizedProfileBlock", "HMMPressedFile"]


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

    def write(self, fh_filter, fh_profile) -> None:
        """Write the filter and profile parts to two binary handles in
        the REFERENCE byte layout (``p7_oprofile_Write``,
        ``plan7.pyx:6480-6486``): the output is readable by HMMER's
        ``p7_oprofile_ReadMSV``/``ReadRest`` and by
        ``plan7.pressed``."""
        from .pressed import write_h3f_record, write_h3p_record
        write_h3f_record(fh_filter, self._profile, quant=self.quant)
        write_h3p_record(fh_profile, self._profile, prof=self._profile)

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


class HMMPressedFile:
    """Iterator of OptimizedProfile from a pressed database
    (``plan7.pyx:3842-4027``).  Models are read from the ``.h3m`` member
    (which carries the complete parameterization), and only without one
    rebuilt from the ``.h3f``/``.h3p`` members.  (The JAX package
    rebuilds them from those members whenever the ``.h3f`` is in HMMER's
    layout, which its own ``hmmpress`` writes too, and so scans other
    models than the ones pressed.)"""

    def __init__(self, path):
        from .hmmfile import HMMFile
        base = os.fspath(path)
        if base.endswith((".h3m", ".h3f", ".h3p", ".h3i")):
            base = base[:-4]
        self._path = base
        self._hmms: Optional[list] = None
        self._hmm_iter = None
        from .pressed import is_reference_pressed
        if (not os.path.exists(base + ".h3m")
                and os.path.exists(base + ".h3f")
                and is_reference_pressed(base + ".h3f")):
            # no .h3m member: reconstruct the models from the .h3f/.h3p
            # members (plan7/pressed.py).  The .h3m holds the exact
            # models and the .h3f/.h3p only the configured profile's
            # f32 odds, from which some transitions and the insert
            # emissions do not come back, so a database that has a .h3m
            # (as hmmpress writes it, ours and HMMER's) is read from it
            from .pressed import reconstruct_models
            self._hmms = reconstruct_models(base + ".h3f", base + ".h3p")
            self._hmm_iter = iter(self._hmms)
            self._hmmfile = None
        else:
            for ext in (".h3m", ".h3i"):
                if not os.path.exists(base + ext):
                    raise FileNotFoundError(base + ext)
            self._hmmfile = HMMFile(base + ".h3m")
        self._bg: Optional[Background] = None

    @property
    def name(self):
        return self._path

    def read(self) -> Optional[OptimizedProfile]:
        if self._hmm_iter is not None:
            hmm = next(self._hmm_iter, None)
        else:
            hmm = self._hmmfile.read()
        if hmm is None:
            return None
        if self._bg is None or self._bg.alphabet != hmm.alphabet:
            self._bg = Background(hmm.alphabet)
        prof = Profile(hmm.M, hmm.alphabet).configure(hmm, self._bg, 400)
        return OptimizedProfile(prof)

    def rewind(self):
        if self._hmm_iter is not None:
            self._hmm_iter = iter(self._hmms)
        else:
            self._hmmfile.rewind()

    def __iter__(self) -> Iterator[OptimizedProfile]:
        return self

    def __next__(self) -> OptimizedProfile:
        om = self.read()
        if om is None:
            raise StopIteration
        return om

    def close(self):
        if self._hmmfile is not None:
            self._hmmfile.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
