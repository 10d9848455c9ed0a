"""Small shared helpers (reference ``pyhmmer.utils`` role).

The reference also ships a ``singledispatchmethod`` backport for
Python < 3.8; this package targets modern Python where
``functools.singledispatchmethod`` is standard, so only ``peekable``
is provided.
"""

from typing import Generic, Iterable, Iterator, TypeVar

__all__ = ["peekable"]

_T = TypeVar("_T")

_SENTINEL = object()


class peekable(Generic[_T]):
    """An iterator wrapper allowing one-item lookahead.

    Used by streaming parsers that must inspect the next record's
    header before deciding how to consume it.

    Example:
        >>> it = peekable(iter("abc"))
        >>> it.peek(), next(it), next(it), it.peek()
        ('a', 'a', 'b', 'c')
        >>> list(it)
        ['c']
    """

    def __init__(self, iterable: Iterable[_T]):
        self._it: Iterator[_T] = iter(iterable)
        self._head = _SENTINEL

    def __iter__(self) -> "peekable[_T]":
        return self

    def __next__(self) -> _T:
        if self._head is not _SENTINEL:
            item, self._head = self._head, _SENTINEL
            return item  # type: ignore[return-value]
        return next(self._it)

    def peek(self) -> _T:
        """Return the next item without consuming it (raises
        `StopIteration` when the iterator is exhausted)."""
        if self._head is _SENTINEL:
            self._head = next(self._it)
        return self._head  # type: ignore[return-value]
