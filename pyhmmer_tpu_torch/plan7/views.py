"""Small view/value classes of the plan7 object model.

Mirrors the reference's accessory classes (``src/pyhmmer/plan7.pyx``):
``Cutoffs`` (:1153-1439), ``EvalueParameters`` (:1688-1848), ``Offsets``
(:5124-5203), ``Domains`` (:1612-1687), ``ScoreData`` (:7958-7999).

``Cutoffs`` and ``EvalueParameters`` are implemented as NumPy ndarray
subclasses viewing the owner's 6-float parameter vector, so they behave
simultaneously like the reference's attribute views *and* like the raw
``evparam[6]`` / ``cutoffs[6]`` arrays the compute layers index directly.
"""

from __future__ import annotations

import numpy as np
from typing import Optional, Tuple

from ..errors import MissingCutoffs

__all__ = ["Cutoffs", "EvalueParameters", "Offsets", "Domains", "ScoreData"]

UNSET = -99999.0


class _ParamVector(np.ndarray):
    """Base: a 6-float vector with named-slot accessors."""

    def __new__(cls, owner=None):
        if owner is None:
            arr = np.full(6, UNSET, dtype=np.float32)
        else:
            # view the owner's existing parameter storage (shared memory)
            arr = np.asarray(getattr(owner, cls._owner_attr), dtype=np.float32)
        out = arr.view(cls)
        out._owner = owner
        return out

    def __array_finalize__(self, obj):
        if obj is not None and not hasattr(self, "_owner"):
            self._owner = getattr(obj, "_owner", None)

    def _set_owner_flag(self, bit: int, present: bool) -> None:
        own = getattr(self, "_owner", None)
        if own is not None and hasattr(own, "flags"):
            if present:
                own.flags |= bit
            else:
                own.flags &= ~bit

    def _get(self, i: int) -> Optional[float]:
        v = float(np.ndarray.__getitem__(self, i))
        return None if v == UNSET else v

    def _set(self, i: int, v: Optional[float]) -> None:
        np.ndarray.__setitem__(self, i, UNSET if v is None else v)

    def _get_pair(self, i: int) -> Optional[Tuple[float, float]]:
        a, b = self._get(i), self._get(i + 1)
        if a is None or b is None:
            return None
        return (a, b)

    def _set_pair(self, i: int, v) -> None:
        if v is None:
            self._set(i, None)
            self._set(i + 1, None)
        else:
            a, b = v
            self._set(i, float(a))
            self._set(i + 1, float(b))

    def as_vector(self):
        from ..easel.containers import VectorF

        return VectorF(np.asarray(self, dtype=np.float32))

    def __copy__(self):
        return self.copy()

    def __eq__(self, other) -> bool:  # type: ignore[override]
        if isinstance(other, _ParamVector):
            return bool(np.array_equal(np.asarray(self), np.asarray(other)))
        return NotImplemented

    def __ne__(self, other) -> bool:  # type: ignore[override]
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None  # type: ignore[assignment]


class Cutoffs(_ParamVector):
    """Pfam bit-score cutoffs (GA/TC/NC pairs) of a HMM or Profile.

    Reference: ``plan7.pyx:1153-1439``; layout ga1,ga2,tc1,tc2,nc1,nc2.
    """

    _owner_attr = "cutoffs"

    # --- gathering -------------------------------------------------------
    @property
    def gathering(self) -> Optional[Tuple[float, float]]:
        return self._get_pair(0)

    @gathering.setter
    def gathering(self, v) -> None:
        self._set_pair(0, v)
        self._set_owner_flag(1 << 10, v is not None)  # p7H flag bit

    @gathering.deleter
    def gathering(self) -> None:
        self._set_pair(0, None)
        self._set_owner_flag(1 << 10, False)

    @property
    def gathering1(self) -> Optional[float]:
        return self._get(0)

    @property
    def gathering2(self) -> Optional[float]:
        return self._get(1)

    # --- trusted ----------------------------------------------------------
    @property
    def trusted(self) -> Optional[Tuple[float, float]]:
        return self._get_pair(2)

    @trusted.setter
    def trusted(self, v) -> None:
        self._set_pair(2, v)
        self._set_owner_flag(1 << 11, v is not None)  # p7H flag bit

    @trusted.deleter
    def trusted(self) -> None:
        self._set_pair(2, None)
        self._set_owner_flag(1 << 11, False)

    @property
    def trusted1(self) -> Optional[float]:
        return self._get(2)

    @property
    def trusted2(self) -> Optional[float]:
        return self._get(3)

    # --- noise ------------------------------------------------------------
    @property
    def noise(self) -> Optional[Tuple[float, float]]:
        return self._get_pair(4)

    @noise.setter
    def noise(self, v) -> None:
        self._set_pair(4, v)
        self._set_owner_flag(1 << 12, v is not None)  # p7H flag bit

    @noise.deleter
    def noise(self) -> None:
        self._set_pair(4, None)
        self._set_owner_flag(1 << 12, False)

    @property
    def noise1(self) -> Optional[float]:
        return self._get(4)

    @property
    def noise2(self) -> Optional[float]:
        return self._get(5)

    def gathering_available(self) -> bool:
        return self.gathering is not None

    def trusted_available(self) -> bool:
        return self.trusted is not None

    def noise_available(self) -> bool:
        return self.noise is not None

    def __str__(self) -> str:
        return (
            f"Cutoffs(gathering={self.gathering}, trusted={self.trusted}, "
            f"noise={self.noise})"
        )


class EvalueParameters(_ParamVector):
    """The E-value statistical parameters of a HMM or Profile.

    Reference: ``plan7.pyx:1688-1848``; layout = ``evparam[6]``:
    m_mu, m_lambda (MSV Gumbel), v_mu, v_lambda (Viterbi Gumbel),
    f_tau, f_lambda (Forward exponential tail).
    """

    _owner_attr = "evparam"

    @property
    def m_mu(self) -> Optional[float]:
        return self._get(0)

    @m_mu.setter
    def m_mu(self, v) -> None:
        self._set(0, v)

    @property
    def m_lambda(self) -> Optional[float]:
        return self._get(1)

    @m_lambda.setter
    def m_lambda(self, v) -> None:
        self._set(1, v)

    @property
    def v_mu(self) -> Optional[float]:
        return self._get(2)

    @v_mu.setter
    def v_mu(self, v) -> None:
        self._set(2, v)

    @property
    def v_lambda(self) -> Optional[float]:
        return self._get(3)

    @v_lambda.setter
    def v_lambda(self, v) -> None:
        self._set(3, v)

    @property
    def f_tau(self) -> Optional[float]:
        return self._get(4)

    @f_tau.setter
    def f_tau(self, v) -> None:
        self._set(4, v)

    @property
    def f_lambda(self) -> Optional[float]:
        return self._get(5)

    @f_lambda.setter
    def f_lambda(self, v) -> None:
        self._set(5, v)

    def __str__(self) -> str:
        return (
            f"EvalueParameters(m_mu={self.m_mu}, m_lambda={self.m_lambda}, "
            f"v_mu={self.v_mu}, v_lambda={self.v_lambda}, "
            f"f_tau={self.f_tau}, f_lambda={self.f_lambda})"
        )


class Offsets:
    """Disk offsets of a profile in a pressed HMM database.

    Reference: ``plan7.pyx:5124-5203`` — the three offsets recorded by
    ``hmmpress``: model (``.h3m``), filter (``.h3f``), profile (``.h3p``).
    Unset offsets read as ``None`` (stored as -1 like ``p7_NO_OFFSET``).
    """

    __slots__ = ("_model", "_filter", "_profile")

    def __init__(self, owner=None) -> None:
        self._model = -1
        self._filter = -1
        self._profile = -1
        if owner is not None:
            off = getattr(owner, "offsets", None)
            if isinstance(off, Offsets):
                self._model, self._filter, self._profile = (
                    off._model,
                    off._filter,
                    off._profile,
                )

    def __copy__(self) -> "Offsets":
        new = Offsets()
        new._model, new._filter, new._profile = self._model, self._filter, self._profile
        return new

    def __repr__(self) -> str:
        return f"Offsets(model={self.model!r}, filter={self.filter!r}, profile={self.profile!r})"

    @property
    def model(self) -> Optional[int]:
        return None if self._model < 0 else self._model

    @model.setter
    def model(self, v: Optional[int]) -> None:
        self._model = -1 if v is None else int(v)

    @property
    def filter(self) -> Optional[int]:
        return None if self._filter < 0 else self._filter

    @filter.setter
    def filter(self, v: Optional[int]) -> None:
        self._filter = -1 if v is None else int(v)

    @property
    def profile(self) -> Optional[int]:
        return None if self._profile < 0 else self._profile

    @profile.setter
    def profile(self, v: Optional[int]) -> None:
        self._profile = -1 if v is None else int(v)


class Domains(list):
    """The list of domains of a `Hit` (reference ``plan7.pyx:1612-1687``).

    Implemented as a ``list`` subclass so the pipeline can build it
    incrementally; adds the reference's ``hit`` backlink and
    ``reported`` / ``included`` filtered views.
    """

    __slots__ = ("hit",)

    def __init__(self, hit=None, iterable=()) -> None:
        super().__init__(iterable)
        self.hit = hit

    @property
    def reported(self):
        return _SizedIterator([d for d in self if d.reported])

    @property
    def included(self):
        return _SizedIterator([d for d in self if d.included])


class _SizedIterator:
    """An iterator with a known length (reference ``utils.py``)."""

    def __init__(self, items) -> None:
        self._items = list(items)
        self._it = iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)


class ScoreData:
    """MSV/SSV per-residue score cache used by the long-targets pipeline.

    Reference: ``plan7.pyx:7958-7999`` (``P7_SCOREDATA``,
    ``p7_hmm_ScoreDataCreate``): caches the optimal per-position match
    scores so nhmmer's window splitting/extension can estimate hit spans
    without re-running DP.
    """

    __slots__ = ("Kp", "M", "ssv_scores", "opt_ext_fwd", "opt_ext_rev", "prefix_lengths", "suffix_lengths")

    def __init__(self, gm, om=None) -> None:
        # accept (gm, om) like the reference; the generic profile carries
        # everything we need
        if om is None and hasattr(gm, "profile"):
            gm = gm.profile
        prof = gm
        self.Kp = prof.alphabet.Kp
        self.M = prof.M
        # 8-bit MSV band per (position, residue-code), like p7_hmm_ScoreDataCreate
        om = om if om is not None else getattr(prof, "to_optimized", lambda: None)()
        if om is not None:
            rbv = np.asarray(om.rbv, dtype=np.uint8)
            # normalize to [M, Kp] regardless of the band layout
            self.ssv_scores = (rbv if rbv.shape[0] == self.M else rbv.T).copy()
        else:
            self.ssv_scores = np.zeros((self.M, self.Kp), dtype=np.uint8)
        # maximal per-row forward/backward extension scores (float32)
        msc = getattr(prof, "msc", None)
        if msc is not None:
            row_max = np.max(np.asarray(msc, dtype=np.float32), axis=-1)
        else:
            row_max = np.zeros(self.M, dtype=np.float32)
        self.opt_ext_fwd = np.cumsum(row_max[::-1])[::-1].astype(np.float32)
        self.opt_ext_rev = np.cumsum(row_max).astype(np.float32)
        self.prefix_lengths = np.arange(self.M, dtype=np.int32)
        self.suffix_lengths = (self.M - np.arange(self.M)).astype(np.int32)

    def __copy__(self) -> "ScoreData":
        return self.copy()

    def copy(self) -> "ScoreData":
        new = ScoreData.__new__(ScoreData)
        new.Kp = self.Kp
        new.M = self.M
        new.ssv_scores = self.ssv_scores.copy()
        new.opt_ext_fwd = self.opt_ext_fwd.copy()
        new.opt_ext_rev = self.opt_ext_rev.copy()
        new.prefix_lengths = self.prefix_lengths.copy()
        new.suffix_lengths = self.suffix_lengths.copy()
        return new
