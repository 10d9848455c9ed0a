"""Common exceptions for ``pyhmmer_tpu_torch`` (a copy of ``pyhmmer_tpu.errors``).

Mirrors the exception surface of ``pyhmmer.errors`` (reference
``src/pyhmmer/errors.pyx`` / ``errors.pyi``): the same class names,
attributes and messages, so error-handling code written against the
reference keeps working.  The Easel status codes (``statuscode``) follow
``easel.h``'s ``esl*`` return codes.
"""

from __future__ import annotations

import typing

__all__ = [
    "statuscode",
    "UnexpectedError",
    "AllocationError",
    "EaselError",
    "AlphabetMismatch",
    "ServerError",
    "MissingCutoffs",
    "InvalidParameter",
    "InvalidHMM",
]

#: Easel return status codes (``easel.h``: eslOK=0 .. eslETOOMANY=27).
statuscode: typing.Dict[int, str] = {
    0: "eslOK",
    1: "eslFAIL",
    2: "eslEOL",
    3: "eslEOF",
    4: "eslEOD",
    5: "eslEMEM",
    6: "eslENOTFOUND",
    7: "eslEFORMAT",
    8: "eslEAMBIGUOUS",
    9: "eslEDIVZERO",
    10: "eslEINCOMPAT",
    11: "eslEINVAL",
    12: "eslESYS",
    13: "eslECORRUPT",
    14: "eslEINCONCEIVABLE",
    15: "eslESYNTAX",
    16: "eslERANGE",
    17: "eslEDUP",
    18: "eslENOHALT",
    19: "eslENORESULT",
    20: "eslENODATA",
    21: "eslETYPE",
    22: "eslEOVERWRITE",
    23: "eslENOSPACE",
    24: "eslEUNIMPLEMENTED",
    25: "eslENOFORMAT",
    26: "eslENOALPHABET",
    27: "eslEWRITE",
}


class UnexpectedError(RuntimeError):
    """An unexpected error that happened in the underlying engine."""

    def __init__(self, code: int, function: str) -> None:
        super().__init__(code, function)
        self.code = code
        self.function = function

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.code!r}, {self.function!r})"

    def __str__(self) -> str:
        name = statuscode.get(self.code, "<unknown>")
        return (
            f"Unexpected error occurred in {self.function!r}: "
            f"{name} (status code {self.code})."
        )


class AllocationError(MemoryError):
    """A memory error that is caused by an unsuccessful allocation."""

    def __init__(self, ctype: str, itemsize: int, count: int = 1) -> None:
        super().__init__(ctype, itemsize, count)
        self.ctype = ctype
        self.itemsize = itemsize
        self.count = count

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.ctype!r}, {self.itemsize}, {self.count})"

    def __str__(self) -> str:
        if self.count == 1:
            return f"Could not allocate {self.itemsize} bytes for type {self.ctype}"
        return (
            f"Could not allocate {self.itemsize * self.count} bytes for "
            f"an array of {self.count} {self.ctype}"
        )


class EaselError(RuntimeError):
    """An error that was raised from the Easel-equivalent core."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(code, message)
        self.code = code
        self.message = message

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.code!r}, {self.message!r})"

    def __str__(self) -> str:
        name = statuscode.get(self.code, "<unknown>")
        return f"Error raised from C code: {self.message}, {name} (status code {self.code})"


class AlphabetMismatch(ValueError):
    """A value error caused by an alphabet mismatch."""

    def __init__(self, expected, actual=None) -> None:
        super().__init__(expected, actual)
        self.expected = expected
        self.actual = actual

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.expected!r}, {self.actual!r})"

    def __str__(self) -> str:
        return f"Expected {self.expected!r}, found {self.actual!r}"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, AlphabetMismatch):
            return NotImplemented
        return self.expected == other.expected and self.actual == other.actual

    __hash__ = None  # type: ignore[assignment]


class ServerError(RuntimeError):
    """A runtime error that happened in a ``hmmpgmd`` server."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(code, message)
        self.code = code
        self.message = message

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.code!r}, {self.message!r})"

    def __str__(self) -> str:
        name = statuscode.get(self.code, "<unknown>")
        return f"Error raised from server: {self.message}, {name} (status code {self.code})"


class MissingCutoffs(ValueError):
    """The model is missing bitscore cutoffs required by the pipeline."""

    def __init__(self, model_name=None, bit_cutoffs=None) -> None:
        super().__init__(model_name, bit_cutoffs)
        self.model_name = model_name
        self.bit_cutoffs = bit_cutoffs

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.model_name!r}, {self.bit_cutoffs!r})"

    def __str__(self) -> str:
        if self.model_name is not None and self.bit_cutoffs is not None:
            return f"Model {self.model_name!r} is missing the {self.bit_cutoffs} bitscore cutoffs"
        return "Model is missing bitscore cutoffs"


class InvalidParameter(ValueError):
    """An invalid parameter value was given."""

    def __init__(self, name: str, value: object, *, choices=None, hint=None) -> None:
        super().__init__(name, value)
        self.name = name
        self.value = value
        self.choices = choices
        self.hint = hint

    def __repr__(self) -> str:
        args = [repr(self.name), repr(self.value)]
        if self.choices is not None:
            args.append(f"choices={self.choices!r}")
        if self.hint is not None:
            args.append(f"hint={self.hint!r}")
        return f"{type(self).__name__}({', '.join(args)})"

    def __str__(self) -> str:
        msg = f"Invalid value for parameter {self.name!r}: {self.value!r}"
        if self.choices is not None:
            alts = ", ".join(map(repr, self.choices))
            msg = f"{msg} (expected one of: {alts})"
        elif self.hint is not None:
            msg = f"{msg} (expected {self.hint})"
        return msg


class InvalidHMM(ValueError):
    """A value error caused by a HMM that fails validation."""

    def __init__(self, hmm, message: str) -> None:
        super().__init__(hmm, message)
        self.hmm = hmm
        self.message = message

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hmm!r}, {self.message!r})"

    def __str__(self) -> str:
        name = getattr(self.hmm, "name", b"") or b""
        if isinstance(name, bytes):
            name = name.decode(errors="replace")
        return f"Invalid HMM {name!r}: {self.message}"
