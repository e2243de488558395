"""Paged continuous-batching engine of the port, its quantized weight
store, the multi-model pool and the phase model."""

from repro_torch.serving.engine import (STATS_KEYS, LaneCheckpoint, PagePool,
                                        PrefixHit, QuantizedParams, Request,
                                        ServeEngine, dequantize_params,
                                        prefix_sharing_supported,
                                        quantize_params)
from repro_torch.serving.modelpool import (ModelEntry, ModelPool,
                                           MultiModelServeEngine,
                                           device_copy, kv_page_bytes,
                                           params_nbytes)
from repro_torch.serving.phase_model import (Workload, effective_prefill_tps,
                                             kv_handoff_seconds,
                                             link_transfer_seconds, phase_tps)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.resilience import (AdmissionRejected,
                                            DegradationLadder, RetryPolicy)

__all__ = ["AdmissionRejected", "DegradationLadder", "LaneCheckpoint",
           "ModelEntry", "ModelPool", "MultiModelServeEngine", "PagePool",
           "PrefixCache", "PrefixHit", "QuantizedParams", "Request",
           "RetryPolicy", "STATS_KEYS", "ServeEngine", "Workload",
           "dequantize_params", "device_copy", "effective_prefill_tps",
           "kv_handoff_seconds", "kv_page_bytes", "link_transfer_seconds",
           "params_nbytes", "phase_tps", "prefix_sharing_supported",
           "quantize_params"]
