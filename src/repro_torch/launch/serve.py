"""Serving launcher: continuous batching on synthetic prompts.

``python -m repro_torch.launch.serve --arch qwen2.5-1.5b [--quant
q8_0|q6_k|q4_k|q2_k] [--paged --page-size 16] [--prefix-sharing
[--shared-prefix-len H]] [--kv-quant int8] --requests N --prompt-len P
--gen G --lanes B [--smoke] [--device cuda|cpu] [--profile tpu-v5e]
[--trace TRACE.json]`` builds seeded random weights of the config
``--arch`` names (any id of :mod:`repro_torch.configs` but the
encoder-decoder ``whisper-base``, which it refuses by name); with
``--quant`` it block-quantizes the leaves the reference quantizes
(:func:`~repro_torch.serving.quantize_params`), prints the reference's
``quantized N weight matrices`` line and serves the dequantized weights
dense, as the reference does.  It serves N requests of P prompt tokens and G
generated tokens each through the fixed-lane engine (the default) or,
with ``--paged``, the page-pool engine, over a KV cache in the compute
dtype or, with ``--kv-quant int8``, in int8 with per-token scales.
``--prefix-sharing`` (implies ``--paged``) serves with the radix prompt
cache and copy-on-write pages, over prompts that open with a common
head of H tokens (default P / 2), and prints the reference's prefix
line.  It prints tokens/s with the prefill/decode split,
the prefill and decode compiles (on the card, one CUDA graph captured
per prompt bucket and per ``n_steps``; with the seconds each capture
took and its replays), then, as the
reference does, the capability-model prediction for the device profile
``--profile`` names, in the ``--quant`` format (``f16`` without it).
``--trace`` records the run with ``torch.profiler``, writes a Chrome
trace and prints device time by kernel.  Runs on ``cuda`` unless ``--device cpu``.
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
from repro_torch.serving import (Request, ServeEngine, dequantize_params,
                                 quantize_params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default=None,
                    choices=[None, "q8_0", "q6_k", "q4_k", "q2_k"])
    ap.add_argument("--paged", action="store_true",
                    help="serve over the page-pool KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="radix prompt cache + copy-on-write page "
                         "sharing (implies --paged)")
    ap.add_argument("--shared-prefix-len", type=int, default=None,
                    help="tokens of common prompt head across the "
                         "synthetic requests (default: half the "
                         "prompt when --prefix-sharing is on)")
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

    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              kv_quant=args.kv_quant)
    if cfg.is_encdec:
        ap.error(f"--arch {args.arch}: {cfg.name} is an encoder-decoder, "
                 f"which ServeEngine does not serve (as in the reference); "
                 f"run Model.encode, Model.init_cache(enc=...) and "
                 f"Model.decode_n_steps")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = build_model(cfg).init(gen, device)
    if args.quant:
        qp, stats = quantize_params(params, args.quant)
        print(f"quantized {stats['quantized']} weight matrices "
              f"({stats['quantized_bytes']/1e6:.1f} MB vs dense "
              f"{stats['dense_bytes']/1e6:.1f} MB kept dense)")
        params = dequantize_params(qp)   # served dense, as the reference

    rng = np.random.default_rng(args.seed)
    head_len = 0
    if args.prefix_sharing:
        head_len = args.shared_prefix_len \
            if args.shared_prefix_len is not None else args.prompt_len // 2
        head_len = max(min(head_len, args.prompt_len - 1), 0)
    head = rng.integers(0, cfg.vocab_size, head_len).astype(np.int32)
    reqs = [Request(uid=i,
                    prompt=np.concatenate(
                        [head,
                         rng.integers(0, cfg.vocab_size,
                                      args.prompt_len - head_len
                                      ).astype(np.int32)]),
                    max_new_tokens=args.gen)
            for i in range(args.requests)]
    paged = args.paged or args.prefix_sharing
    max_len = args.prompt_len + args.gen + 8
    if paged:                      # cache capacity is page granular
        max_len = -(-max_len // args.page_size) * args.page_size

    def make_engine():
        return ServeEngine(cfg, params, n_lanes=args.lanes, max_len=max_len,
                           paged=paged, page_size=args.page_size,
                           prefix_sharing=args.prefix_sharing,
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
        report_profile(tracer, dt, args.trace)
    n_gen = sum(len(r.generated) for r in reqs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"served {len(reqs)} requests, {n_gen} tokens in {dt:.3f}s "
          f"({n_gen / dt:.1f} tok/s on {where})")
    if engine.timed:
        # a prefix hit streams its prompt's tail instead of a prefill
        t_prefill = (sum(sum(v) for v in engine.timings["prefill"].values())
                     + sum(engine.timings["prefix_stream"]))
        t_decode = sum(engine.timings["decode"])
        print(f"prefill {t_prefill:.3f}s over {len(reqs)} prompts "
              f"({len(reqs) * args.prompt_len / max(t_prefill, 1e-9):.1f} "
              f"prompt tok/s); decode {t_decode:.3f}s over "
              f"{engine.stats['decode_dispatches']} dispatches "
              f"({n_gen / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"stats: {dict(engine.stats)}")
    graphs = "CUDA graphs captured" if device.type == "cuda" else \
        "sizes served eagerly on the CPU"
    print(f"compiles: prefill {engine.stats['prefill_compiles']}, "
          f"decode {engine.stats['decode_compiles']} (prefill and decode: "
          f"{graphs}, one per prompt bucket and one per n_steps; later "
          f"prefills and dispatches replay them)")
    if args.prefix_sharing:
        s = engine.stats
        print(f"prefix sharing: {s['prefix_hits']} hits, "
              f"{s['prefix_tokens_matched']} prompt tokens served from "
              f"cached pages, {s['prefix_pages_saved']} prefill pages "
              f"saved, {s['prefix_cow_copies']} copy-on-write splits")
        engine.prefix_cache.flush()
    if engine.timed and engine.timings["capture"]:
        caps = engine.timings["capture"]
        print("capture: " + ", ".join(
            f"{graph_name(k)} {caps[k]:.3f}s "
            f"({engine.graphs.replays(k)} replays)"
            for k in sorted(caps, key=str)))

    prof = get_profile(args.profile)
    spec = LLMSpec(name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                   n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
                   tied_embeddings=cfg.tie_embeddings)
    m = InferencePerfModel(prof, spec)
    fmt = args.quant or "f16"
    print(f"capability-model prediction on {prof.name}: "
          f"prefill {m.prefill(fmt).tokens_per_s:,.0f} tok/s, "
          f"decode {m.decode(fmt).tokens_per_s:,.0f} tok/s ({fmt})")


def graph_name(key) -> str:
    """A graph's key as the ``capture:`` line names it."""
    if isinstance(key, tuple):
        return " ".join(str(part) for part in key)   # ("prefill", 64)
    return key if isinstance(key, str) else f"n_steps {key}"


def report_profile(prof, wall_s: float, path: str) -> None:
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
