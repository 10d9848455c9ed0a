"""The port's copy of ``pyhmmer_tpu/easel/containers.py``'s ``Bitfield``
(``pyhmmer.easel.Bitfield``, reference ``easel.pyx:721-1025``), which
``MSA.mark_fragments`` returns; backed by a NumPy array instead of
Easel's C struct.  The key hashes, vectors and matrices are not copied:
nothing in the port uses them.
"""

from __future__ import annotations

import numpy as np
from typing import Iterable, Iterator

__all__ = ["Bitfield"]


class Bitfield:
    """A packed boolean vector (``ESL_BITFIELD`` equivalent).

    Example:
        >>> b = Bitfield([True, False, True])
        >>> len(b), b.count()
        (3, 2)
        >>> b.toggle(1); b.count()
        3
    """

    def __init__(self, iterable: Iterable[object]):
        self._bits = np.array([bool(x) for x in iterable], dtype=bool)

    @classmethod
    def zeros(cls, n: int) -> "Bitfield":
        self = cls.__new__(cls)
        self._bits = np.zeros(n, dtype=bool)
        return self

    @classmethod
    def ones(cls, n: int) -> "Bitfield":
        self = cls.__new__(cls)
        self._bits = np.ones(n, dtype=bool)
        return self

    def __len__(self) -> int:
        return len(self._bits)

    def __getitem__(self, i: int) -> bool:
        return bool(self._bits[self._wrap(i)])

    def __setitem__(self, i: int, value: object) -> None:
        self._bits[self._wrap(i)] = bool(value)

    def __iter__(self) -> Iterator[bool]:
        return (bool(b) for b in self._bits)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Bitfield)
                and np.array_equal(self._bits, other._bits))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({[bool(b) for b in self._bits]!r})"

    def _wrap(self, i: int) -> int:
        n = len(self._bits)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return i

    def count(self, value: bool = True) -> int:
        """Number of positions equal to ``value``."""
        n = int(self._bits.sum())
        return n if value else len(self._bits) - n

    def toggle(self, i: int) -> None:
        i = self._wrap(i)
        self._bits[i] = not self._bits[i]

    def copy(self) -> "Bitfield":
        out = Bitfield.__new__(Bitfield)
        out._bits = self._bits.copy()
        return out
