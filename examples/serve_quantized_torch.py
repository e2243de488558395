"""Quantized serving on the PyTorch/CUDA port: batched requests across
ggml formats.

Serves the same synthetic request batch with the dense weights and
with each quantization format (the leaves the reference quantizes,
served dequantized), comparing (a) measured tokens/s on the device
the engine runs on, (b) output agreement vs the dense weights, (c) the
capability model's predicted speedup on the paper's hardware.

Run:  PYTHONPATH=src python examples/serve_quantized_torch.py
[--device cpu] (on the card unless ``--device cpu``).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import CMP_170HX_NOFMA, InferencePerfModel
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import (Request, ServeEngine, dequantize_params,
                                 quantize_params)


def serve_once(cfg, params, prompts, device, gen=8, lanes=2):
    engine = ServeEngine(cfg, params, n_lanes=lanes,
                         max_len=prompts.shape[1] + gen + 4, device=device)
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=gen)
            for i in range(prompts.shape[0])]
    t0 = time.perf_counter()
    engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = [tuple(r.generated) for r in reqs]
    n = sum(len(t) for t in toks)
    return toks, n / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")

    ref_toks, ref_tps = serve_once(cfg, params, prompts, device)
    print(f"dense ({cfg.dtype}) weights: {ref_tps:.1f} tok/s on {where}")

    m = InferencePerfModel(CMP_170HX_NOFMA)
    base = m.decode("f32").tokens_per_s
    for fmt in ("q8_0", "q6_k", "q4_k", "q2_k"):
        qp, stats = quantize_params(params, fmt)
        toks, tps = serve_once(cfg, dequantize_params(qp), prompts, device)
        agree = np.mean([
            np.mean([a == b for a, b in zip(t1, t2)])
            for t1, t2 in zip(ref_toks, toks)])
        pred = m.decode(fmt).tokens_per_s
        print(f"{fmt:5s}: {tps:6.1f} tok/s on {where} | token-agreement "
              f"vs dense {agree:4.0%} | modeled CMP-170HX decode "
              f"{pred:7.1f} t/s ({pred/base:.1f}x vs f32)")
    print("OK")


if __name__ == "__main__":
    main()
