"""Paged continuous-batching engine of the port."""

from repro_torch.serving.engine import (STATS_KEYS, LaneCheckpoint, PagePool,
                                        PrefixHit, Request, ServeEngine,
                                        prefix_sharing_supported)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.resilience import (AdmissionRejected,
                                            DegradationLadder, RetryPolicy)

__all__ = ["AdmissionRejected", "DegradationLadder", "LaneCheckpoint",
           "PagePool", "PrefixCache", "PrefixHit", "Request", "RetryPolicy",
           "STATS_KEYS", "ServeEngine", "prefix_sharing_supported"]
