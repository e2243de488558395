"""Always-on structured invariants for allocator / lifecycle code.

:func:`invariant` is an ordinary ``if``/``raise`` (nothing ``python -O``
can strip) raising :class:`InvariantError` with the failed condition's
context attached as structured fields.  :class:`InvariantError`
subclasses ``AssertionError`` so ``except AssertionError`` call sites
keep working.  Same contract as the reference package's
``analysis/invariants.py``.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["InvariantError", "invariant"]


class InvariantError(AssertionError):
    """A runtime invariant does not hold.

    ``message`` states the invariant; ``context`` holds the values that
    witnessed the violation (page ids, counters ...).
    """

    def __init__(self, message: str, **context: Any):
        self.message = message
        self.context: Dict[str, Any] = dict(context)
        if context:
            detail = ", ".join(f"{k}={v!r}" for k, v in context.items())
            message = f"{message} ({detail})"
        super().__init__(message)


def invariant(cond: Any, message: str, **context: Any) -> None:
    """Raise :class:`InvariantError` unless ``cond`` is truthy."""
    if not cond:
        raise InvariantError(message, **context)
