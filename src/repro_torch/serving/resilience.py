"""Structured admission refusal (the part of the reference's
``serving/resilience.py`` the paged engine raises)."""

from __future__ import annotations

from typing import Optional

__all__ = ["AdmissionRejected"]


class AdmissionRejected(RuntimeError):
    """The engine refuses (or can never grant) an admission.

    Subclasses ``RuntimeError`` and keeps the "can never be admitted"
    phrase in the terminal case.  Structured fields: ``uid``, ``reason``
    (``"never_admissible"`` or ``"backpressure"``), ``retry_after_s``
    (``None`` when retrying cannot help), ``need_pages``/``pool_pages``
    and ``n_lanes``.
    """

    def __init__(self, uid: int, reason: str,
                 retry_after_s: Optional[float] = None,
                 need_pages: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 n_lanes: Optional[int] = None,
                 message: Optional[str] = None):
        if message is None:
            if reason == "never_admissible":
                detail = (f"need={need_pages} pages of {pool_pages}"
                          if need_pages is not None else "dense")
                message = (f"request uid={uid} can never be admitted "
                           f"(n_lanes={n_lanes}, {detail}) and no request "
                           f"is in flight to retire")
            else:
                message = (f"request uid={uid} refused: engine under "
                           f"backpressure, retry after {retry_after_s}s")
        super().__init__(message)
        self.uid = uid
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.need_pages = need_pages
        self.pool_pages = pool_pages
        self.n_lanes = n_lanes
