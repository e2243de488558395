"""SSD (Mamba-2) chunk scan: the intra-chunk CUDA kernel (K10) wrapper,
the full SSD on it, and the plain versions."""

from repro_torch.kernels.ssd_scan.ops import ssd, ssd_chunk
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref, ssd_chunked,
                                              ssd_naive)

__all__ = ["ssd", "ssd_chunk", "ssd_chunk_ref", "ssd_chunked", "ssd_naive"]
