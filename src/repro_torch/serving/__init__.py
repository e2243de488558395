"""Paged continuous-batching engine of the port."""

from repro_torch.serving.engine import (STATS_KEYS, PagePool, Request,
                                        ServeEngine)
from repro_torch.serving.resilience import AdmissionRejected

__all__ = ["AdmissionRejected", "PagePool", "Request", "STATS_KEYS",
           "ServeEngine"]
