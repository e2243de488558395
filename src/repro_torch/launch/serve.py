"""Serving launcher: continuous batching on synthetic prompts.

``python -m repro_torch.launch.serve --arch qwen2.5-1.5b [--paged
--page-size 16] [--kv-quant int8] --requests N --prompt-len P --gen G
--lanes B [--smoke] [--device cuda|cpu] [--profile tpu-v5e] [--trace
TRACE.json]`` builds seeded random weights of the config ``--arch``
names (qwen2.5-1.5b, mamba2-780m or hymba-1.5b), serves N requests of P
prompt tokens and G generated tokens each through the fixed-lane engine
(the default) or, with ``--paged``, the page-pool engine, over a KV
cache in the compute dtype or, with ``--kv-quant int8``, in int8 with
per-token scales, and prints tokens/s with the prefill/decode split,
the decode compiles (on the card, one CUDA graph captured per
``n_steps``; with the seconds each capture took), then, as the
reference does, the capability-model prediction for the device profile
``--profile`` names.  ``--trace`` records the run with
``torch.profiler``, writes a Chrome trace and prints device time by
kernel.  Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.device_profile import get_profile
from repro_torch.core.perf_model import InferencePerfModel, LLMSpec
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="serve over the page-pool KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-quant", default=None, choices=[None, "int8"],
                    help="int8 KV cache with per-token f32 scales")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default="tpu-v5e",
                    help="device profile for the analytic prediction")
    ap.add_argument("--trace", default=None, metavar="TRACE.json",
                    help="trace the run with torch.profiler, write a "
                         "Chrome trace here and print device time by "
                         "kernel")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              kv_quant=args.kv_quant)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = build_model(cfg).init(gen, device)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                max_new_tokens=args.gen)
            for i in range(args.requests)]
    max_len = args.prompt_len + args.gen + 8
    if args.paged:                 # cache capacity is page granular
        max_len = -(-max_len // args.page_size) * args.page_size

    def make_engine():
        return ServeEngine(cfg, params, n_lanes=args.lanes, max_len=max_len,
                           paged=args.paged, page_size=args.page_size,
                           device=device, timed=args.trace is None)

    # one untimed request first: kernel build/load and library set-up
    # stay out of the numbers
    make_engine().run([Request(uid=-1, prompt=reqs[0].prompt,
                               max_new_tokens=2)])
    engine = make_engine()
    tracer = contextlib.nullcontext()
    if args.trace:
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        tracer = profile(activities=acts)
    with tracer:
        t0 = time.perf_counter()
        engine.run(reqs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    if args.trace:
        _report_profile(tracer, dt, args.trace)
    n_gen = sum(len(r.generated) for r in reqs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"served {len(reqs)} requests, {n_gen} tokens in {dt:.3f}s "
          f"({n_gen / dt:.1f} tok/s on {where})")
    if engine.timed:
        t_prefill = sum(sum(v) for v in engine.timings["prefill"].values())
        t_decode = sum(engine.timings["decode"])
        print(f"prefill {t_prefill:.3f}s over {len(reqs)} prompts "
              f"({len(reqs) * args.prompt_len / max(t_prefill, 1e-9):.1f} "
              f"prompt tok/s); decode {t_decode:.3f}s over "
              f"{engine.stats['decode_dispatches']} dispatches "
              f"({n_gen / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"stats: {engine.stats}")
    graphs = "CUDA graphs captured" if device.type == "cuda" else \
        "sizes served eagerly on the CPU"
    print(f"compiles: prefill {engine.stats['prefill_compiles']}, "
          f"decode {engine.stats['decode_compiles']} (decode: {graphs}, "
          f"one per n_steps; later dispatches replay them)")
    if engine.timed and engine.timings["capture"]:
        caps = engine.timings["capture"]
        print("capture: " + ", ".join(
            f"{k if isinstance(k, str) else f'n_steps {k}'} "
            f"{caps[k]:.3f}s" for k in sorted(caps, key=str)))

    prof = get_profile(args.profile)
    spec = LLMSpec(name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                   n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
                   tied_embeddings=cfg.tie_embeddings)
    m = InferencePerfModel(prof, spec)
    fmt = "f16"                    # the port serves no quantized weights
    print(f"capability-model prediction on {prof.name}: "
          f"prefill {m.prefill(fmt).tokens_per_s:,.0f} tok/s, "
          f"decode {m.decode(fmt).tokens_per_s:,.0f} tok/s ({fmt})")


def _report_profile(prof, wall_s: float, path: str) -> None:
    """Device time by kernel and the device's busy share of the run."""
    prof.export_chrome_trace(path)
    # device-side rows only: a CPU op's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"profile: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall ({100 * busy_us / 1e6 / wall_s:.1f}"
          f"%; idle {100 - 100 * busy_us / 1e6 / wall_s:.1f}%), trace "
          f"{path}")
    for e in rows[:20]:
        print(f"profile: {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:7d} calls  {e.key[:90]}")


if __name__ == "__main__":
    main()
