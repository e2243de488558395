"""Quickstart on the PyTorch/CUDA port: the paper's pipeline in five
steps.

1. characterize a device (capability table / C1),
2. let the path policy reroute compute (C2, the -fmad=false analogue),
3. quantize a model ggml-style (C4),
4. predict prefill/decode throughput + energy (C3/C5),
5. run a real quantized decode with the serving engine.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(on the card unless ``--device cpu``).
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (CMP_170HX, CMP_170HX_NOFMA, TPU_V5E,
                              InferencePerfModel, PathPolicy,
                              matmul_descriptor)
from repro_torch.core.energy import efficiency
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import (Request, ServeEngine, dequantize_params,
                                 quantize_params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("=" * 70)
    print("1) capability characterization (paper C1)")
    for prof in (CMP_170HX, CMP_170HX_NOFMA, TPU_V5E):
        f32 = max(v for (p, _), v in prof.peak.items() if p == "f32")
        print(f"  {prof.name:18s} best-f32={f32:6.1f}TF "
              f"hbm={prof.hbm_bw_gbps:.0f}GB/s tdp={prof.tdp_watts:.0f}W")

    print("\n2) compute-path policy (paper C2: reroute around the throttle)")
    desc = matmul_descriptor(512, 512, 4096, "f32")
    for prof in (CMP_170HX, TPU_V5E):
        d = PathPolicy(prof).decide(desc)
        print(f"  {prof.name:18s} -> variant={d.variant:8s} "
              f"modeled={d.modeled_seconds*1e6:7.1f}us ({d.bound}-bound)")

    print("\n3) quantize a model (paper C4)")
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    qp, stats = quantize_params(params, "q4_k")
    print(f"  {stats['quantized']} matrices -> q4_k "
          f"({stats['quantized_bytes']/1e6:.1f}MB; "
          f"{stats['dense_bytes']/1e6:.1f}MB kept dense)")

    print("\n4) throughput + energy prediction (paper C3/C5, "
          "Graphs 4-1..4-3)")
    for prof in (CMP_170HX, CMP_170HX_NOFMA):
        m = InferencePerfModel(prof)
        for fmt in ("f16", "q4_k"):
            d = m.decode(fmt)
            e = efficiency(prof, fmt)
            cost = (f" ${e.usd_per_mtok:.3f}/Mtok"
                    if e.usd_per_mtok is not None else "")
            print(f"  {prof.name:18s} {fmt:5s} "
                  f"decode={d.tokens_per_s:7.1f}t/s ({d.bound}-bound) "
                  f"{d.tokens_per_joule:5.2f} tok/J{cost}")

    print(f"\n5) serve with the quantized weights (continuous batching, "
          f"{device.type})")
    engine = ServeEngine(cfg, dequantize_params(qp), n_lanes=2, max_len=48,
                         device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 12,
                                               dtype=np.int32),
                    max_new_tokens=8) for i in range(3)]
    engine.run(reqs)
    for r in reqs:
        print(f"  request {r.uid}: generated {r.generated}")
    print("\nOK")


if __name__ == "__main__":
    main()
