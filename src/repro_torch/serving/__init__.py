"""Paged continuous-batching engine of the port."""

from repro_torch.serving.engine import (STATS_KEYS, LaneCheckpoint, PagePool,
                                        PrefixHit, Request, ServeEngine,
                                        prefix_sharing_supported)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.resilience import AdmissionRejected

__all__ = ["AdmissionRejected", "LaneCheckpoint", "PagePool", "PrefixCache",
           "PrefixHit", "Request", "STATS_KEYS", "ServeEngine",
           "prefix_sharing_supported"]
