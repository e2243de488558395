#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in
order (any failure raises and the script exits non-zero):

1. build every kernel from ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, started together) and print the card;
2. K1 (paged decode attention) against its plain version at the main
   path's shapes, float32 (TF32 off, tol 1e-4) and bfloat16 (tol 2e-2);
3. K2 (flash prefill) against its plain version, causal at Sq 64 and
   512 plus a sliding-window case, same tolerances;
4. K3 (length-aware dense decode) and K6a (masked dense decode) against
   their plain version at the fixed-lane path's shapes (S = 1024) and
   at S = 1000, same tolerances; a dead lane gives exactly 0 and K3
   equals K6a;
5. K5 (length-aware int8 dense decode), K6b (masked int8 dense decode)
   and K4 (paged int8 decode) against their plain versions at the same
   shapes, q in float32 and bfloat16, at the model's ``qblock=1``
   (per-token scales) and the reference kernels' own (32 dense, 16
   paged); a dead lane gives exactly 0, K5 equals K6b, and at
   ``qblock=1`` each agrees with the reference model's route
   (dequantize to float32, then K3 or K1);
6. end to end at SMOKE width in float32: the same requests through
   ``ServeEngine()`` (fixed-lane) and ``ServeEngine(paged=True)``,
   greedy and at temperature 0.8, on the CPU (plain versions) and on
   the card (kernels): CPU and card streams, and fixed-lane and paged
   streams on the card, must be identical; once with the cache in the
   compute dtype and once with ``kv_quant="int8"``;
7. end to end at full width, paged: qwen2.5-1.5b in bfloat16 with
   seeded random weights, 16 requests through ``ServeEngine(paged=
   True)``; every request must finish its budget and K1 and K2 must
   have launched;
8. end to end at full width, fixed-lane (the engine's default): the
   same 16 requests through ``ServeEngine()``; every request must
   finish, K2 and K3 must have launched, K3 28 times per decode step;
   then a short run at temperature 0.8 whose tokens must all finish
   inside the vocabulary;
9. end to end at full width with ``kv_quant="int8"``: the same 16
   requests fixed-lane and paged; every request must finish, K5 (resp.
   K4) must launch 28 times per decode step and the fp decode kernels
   not at all;
10. timings at the main-path shapes: each kernel, its plain version and
   PyTorch's own attention call where one computes the same function,
   beside the card's bound; for the int8 kernels also the reference
   model's route (dequantize to float32, then K3 or K1).

The last two lines are the ``{"kernels": [...]}`` summary and the
``{"ok": true, ...}`` verdict.  Exits non-zero, printing no result, when
no CUDA device is present or the port's sources are not beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 5, iters: int = 30) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} kernels built in "
          f"{time.perf_counter() - t0:.1f}s into {_build.build_dir()}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] card: {gpu_line()}")


def k1_inputs(dtype, dev):
    """Main-path shapes: B=8 lanes, H=12, Hkv=2, D=128, ps=16, T=64
    (max_len 1024), shuffled disjoint tables, ragged lengths incl. a
    dead lane and a full table."""
    import numpy as np
    import torch
    b, h, hkv, d, ps, t = 8, 12, 2, 128, 16, 64
    n_pages = b * t + 1
    rng = np.random.default_rng(SEED)
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    kp = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d),
                                              np.float32))
    bt = torch.from_numpy(rng.permutation(n_pages)[:b * t].reshape(b, t)
                          .astype(np.int32))
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, t * ps],
                        dtype=torch.int32)
    return ([x.to(dev, dtype) for x in (q, kp, vp)]
            + [bt.to(dev), lens.to(dev)])


def phase_k1(dev):
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged, decode_attention_paged_ref)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args = k1_inputs(dtype, dev)
        out = decode_attention_paged(*args)
        ref = decode_attention_paged_ref(*args)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        print(f"[K1] {dtype}: max_abs_err {err:.3e} (tol {tol})")
        if not err <= tol:
            fail(f"K1 {dtype} disagrees with its plain version: {err}")
        if not bool(torch.all(out[0] == 0)):
            fail("K1: dead lane did not give 0")
        errs[str(dtype).split(".")[-1]] = (err, tol)
    return errs


def k2_inputs(sq, dtype, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + sq)
    shapes = ((1, 12, sq, 128), (1, 2, sq, 128), (1, 2, sq, 128))
    return [torch.from_numpy(rng.standard_normal(s, np.float32)
                             ).to(dev, dtype) for s in shapes]


def phase_k2(dev):
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    errs = {}
    cases = ((64, True, None), (512, True, None), (512, True, 128))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for sq, causal, window in cases:
            q, k, v = k2_inputs(sq, dtype, dev)
            out = flash_attention(q, k, v, causal=causal, window=window)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[K2] {dtype} Sq={sq} causal={causal} window={window}: "
                  f"max_abs_err {err:.3e} (tol {tol})")
            if not err <= tol:
                fail(f"K2 {dtype} Sq={sq} window={window} disagrees: {err}")
            worst = max(worst, err)
        errs[str(dtype).split(".")[-1]] = (worst, tol)
    return errs


def dense_inputs(dtype, dev, s=1024):
    """Fixed-lane path shapes: B=8 lanes, H=12, Hkv=2, D=128, a cache of
    S positions (max_len 1024), ragged lengths incl. a dead lane and a
    full lane (clipped to S)."""
    import numpy as np
    import torch
    b, h, hkv, d = 8, 12, 2, 128
    rng = np.random.default_rng(SEED + s)
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32))
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024],
                        dtype=torch.int32).clamp(max=s)
    return [x.to(dev, dtype) for x in (q, k, v)] + [lens.to(dev)]


def phase_dense(dev):
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    errs = {"decode_attention_lengthaware": {}, "decode_attention_masked": {}}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = {name: 0.0 for name in errs}
        for s in (1024, 1000):
            args = dense_inputs(dtype, dev, s)
            la = decode_attention(*args)
            masked = decode_attention(*args, length_aware=False)
            ref = decode_attention_ref(*args)
            torch.cuda.synchronize()
            for name, out in (("decode_attention_lengthaware", la),
                              ("decode_attention_masked", masked)):
                err = max_err(out, ref)
                print(f"[K3/K6a] {name} {dtype} S={s}: max_abs_err "
                      f"{err:.3e} (tol {tol})")
                if not err <= tol:
                    fail(f"{name} {dtype} S={s} disagrees with its plain "
                         f"version: {err}")
                if not bool(torch.all(out[0] == 0)):
                    fail(f"{name}: dead lane did not give 0")
                worst[name] = max(worst[name], err)
            if not torch.equal(la, masked):
                fail(f"K3 and K6a differ ({dtype}, S={s})")
        for name in errs:
            errs[name][str(dtype).split(".")[-1]] = (worst[name], tol)
    return errs


def q8_dense_inputs(dtype, dev, s, qblock):
    """``dense_inputs`` with K/V quantized to int8 with one f32 scale per
    ``qblock`` positions (``qblock=1``: the model's per-token scales)."""
    from repro_torch.kernels.decode_attention import quantize_kv_q8
    q, k, v, lens = dense_inputs(dtype, dev, s)
    kq, ks = quantize_kv_q8(k.float(), qblock)
    vq, vs = quantize_kv_q8(v.float(), qblock)
    return [q, kq, ks, vq, vs, lens]


def q8_paged_inputs(dtype, dev, qblock):
    """``k1_inputs`` with the pools quantized to int8 with one f32 scale
    per ``qblock`` positions of a page."""
    from repro_torch.kernels.decode_attention import quantize_kv_q8
    q, kp, vp, bt, lens = k1_inputs(dtype, dev)
    kq, ks = quantize_kv_q8(kp.float(), qblock)
    vq, vs = quantize_kv_q8(vp.float(), qblock)
    return [q, kq, ks, vq, vs, bt, lens]


def _route_dense(q, kq, ks, vq, vs, lens, qblock):
    """The reference model's int8 route: dequantize the whole cache to
    float32, then the fp kernel (K3) in float32, cast back to q's dtype."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      dequant_kv_q8)
    return decode_attention(q.float(), dequant_kv_q8(kq, ks, qblock),
                            dequant_kv_q8(vq, vs, qblock), lens).to(q.dtype)


def _route_paged(q, kq, ks, vq, vs, bt, lens, qblock):
    """As :func:`_route_dense` over the pools, with K1."""
    from repro_torch.kernels.decode_attention import (decode_attention_paged,
                                                      dequant_kv_q8)
    return decode_attention_paged(q.float(), dequant_kv_q8(kq, ks, qblock),
                                  dequant_kv_q8(vq, vs, qblock), bt,
                                  lens).to(q.dtype)


def phase_q8(dev):
    """K5/K6b (dense, S 1024 at qblock 1 and 32, S 1000 at qblock 1) and
    K4 (paged, qblock 1 and 16) against their plain versions."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_q8, decode_attention_paged_q8_ref,
        decode_attention_q8, decode_attention_q8_ref)
    names = ("decode_attention_q8_lengthaware", "decode_attention_q8_masked",
             "decode_attention_paged_q8")
    errs = {name: {} for name in names}

    def check(name, out, ref, tol, what):
        err = max_err(out, ref)
        print(f"[K4/K5/K6b] {name} {what}: max_abs_err {err:.3e} "
              f"(tol {tol})")
        if not err <= tol:
            fail(f"{name} {what} disagrees: {err}")
        if not bool(torch.all(out[0] == 0)):
            fail(f"{name}: dead lane did not give 0")
        return err

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = {name: 0.0 for name in names}
        for s, qblock in ((1024, 1), (1024, 32), (1000, 1)):
            args = q8_dense_inputs(dtype, dev, s, qblock)
            la = decode_attention_q8(*args, qblock=qblock)
            masked = decode_attention_q8(*args, qblock=qblock,
                                         length_aware=False)
            ref = decode_attention_q8_ref(*args, qblock=qblock)
            torch.cuda.synchronize()
            what = f"{dtype} S={s} qblock={qblock}"
            for name, out in ((names[0], la), (names[1], masked)):
                worst[name] = max(worst[name],
                                  check(name, out, ref, tol, what))
            if not torch.equal(la, masked):
                fail(f"K5 and K6b differ ({what})")
            if qblock == 1:
                route = _route_dense(*args, qblock)
                torch.cuda.synchronize()
                err = max_err(la, route)
                print(f"[K4/K5/K6b] K5 vs dequantize + K3 {what}: "
                      f"max_abs_err {err:.3e}, bitwise {torch.equal(la, route)}")
                if not err <= tol:
                    fail(f"K5 disagrees with the reference's route: {err}")
        for qblock in (1, 16):
            args = q8_paged_inputs(dtype, dev, qblock)
            out = decode_attention_paged_q8(*args, qblock=qblock)
            ref = decode_attention_paged_q8_ref(*args, qblock=qblock)
            torch.cuda.synchronize()
            what = f"{dtype} qblock={qblock}"
            worst[names[2]] = max(worst[names[2]],
                                  check(names[2], out, ref, tol, what))
            if qblock == 1:
                route = _route_paged(*args, qblock)
                torch.cuda.synchronize()
                err = max_err(out, route)
                print(f"[K4/K5/K6b] K4 vs dequantize + K1 {what}: "
                      f"max_abs_err {err:.3e}, bitwise "
                      f"{torch.equal(out, route)}")
                if not err <= tol:
                    fail(f"K4 disagrees with the reference's route: {err}")
        for name in names:
            errs[name][str(dtype).split(".")[-1]] = (worst[name], tol)
    return errs


def _requests(cfg, n, plen_lo, plen_hi, gen, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    plens = rng.integers(plen_lo, plen_hi + 1, n)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(p)
                                               ).astype(np.int32),
                    max_new_tokens=gen) for i, p in enumerate(plens)]


def phase_smoke_e2e(dev, kv_quant=None):
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32", kv_quant=kv_quant)
    tag = f"[smoke e2e{' int8' if kv_quant else ''}]"
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED), cpu)
    on_card = copy.deepcopy(params).to(dev)
    streams = {}
    runs = [("cpu", False, 0.0), ("cuda", False, 0.0), ("cuda", True, 0.0),
            ("cpu", False, 0.8), ("cuda", False, 0.8), ("cuda", True, 0.8),
            ("cpu", True, 0.0)]
    for where, paged, temperature in runs:
        eng = ServeEngine(cfg, params if where == "cpu" else on_card,
                          n_lanes=4, max_len=128, temperature=temperature,
                          rng_seed=SEED + 3, paged=paged, page_size=16,
                          n_pages=24, device=where)
        reqs = _requests(cfg, 10, 3, 140, 16, SEED + 1)
        eng.run(reqs)
        if paged:
            eng.pool.check()
        streams[where, paged, temperature] = [r.generated for r in reqs]
    pairs = [(("cpu", True, 0.0), ("cuda", True, 0.0),
              "paged greedy, CPU vs card"),
             (("cpu", False, 0.0), ("cuda", False, 0.0),
              "fixed-lane greedy, CPU vs card"),
             (("cpu", False, 0.8), ("cuda", False, 0.8),
              "fixed-lane temperature 0.8, CPU vs card"),
             (("cuda", False, 0.0), ("cuda", True, 0.0),
              "greedy, fixed-lane vs paged on the card"),
             (("cuda", False, 0.8), ("cuda", True, 0.8),
              "temperature 0.8, fixed-lane vs paged on the card")]
    for a, b, what in pairs:
        same = sum(x == y for x, y in zip(streams[a], streams[b]))
        print(f"{tag} float32 SMOKE: {same}/{len(streams[a])} "
              f"streams identical, {what}")
        if same != len(streams[a]):
            fail(f"{tag} SMOKE streams differ: {what}")
    if streams["cuda", False, 0.0] == streams["cuda", False, 0.8]:
        fail(f"{tag} temperature 0.8 gave the greedy streams: nothing was "
             "sampled")


def init_full(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2.5-1.5b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[full e2e] {cfg.name} bf16, {n_params / 1e9:.3f}B params "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def serve_full(dev, cfg, params, tag, need, **engine_kw):
    """Serve the full-width traffic (16 requests, prompts 64-700 from the
    seed, 64 new tokens, 8 lanes, max_len 1024) through one engine with
    the launch counts zeroed just before and read just after; fail
    unless every budget finishes and every kernel in ``need`` ran."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServeEngine
    gen = 64
    eng = ServeEngine(cfg, params, n_lanes=8, max_len=1024, device=dev,
                      timed=True, **engine_kw)
    reqs = _requests(cfg, 16, 64, 700, gen, SEED + 2)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_gen = sum(len(r.generated) for r in reqs)
    if eng.paged:
        eng.pool.check()
    if not all(r.done and len(r.generated) == gen for r in reqs):
        fail(f"{tag}: full-width run did not finish every request's budget")
    toks = np.concatenate([r.generated for r in reqs])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{tag}: generated token outside the vocabulary")
    if min(counts[k] for k in need) <= 0:
        fail(f"{tag}: a kernel of the path never launched: {counts}")
    pre = eng.timings["prefill"]
    dec = eng.timings["decode"]
    print(f"[{tag}] {len(reqs)} requests, {n_gen} tokens in {wall:.3f}s "
          f"= {n_gen / wall:.1f} tok/s end to end; stats {eng.stats}")
    for bucket in sorted(pre):
        print(f"[{tag}] prefill bucket {bucket}: {len(pre[bucket])} "
              f"prompts, median {1e3 * statistics.median(pre[bucket]):.2f} "
              f"ms")
    print(f"[{tag}] decode: {len(dec)} dispatches, median "
          f"{1e3 * statistics.median(dec):.2f} ms per dispatch "
          f"({eng.dispatch_n} steps x {eng.n_lanes} lanes max)")
    print(f"[{tag}] launches: {counts}")
    summary = {"tok_s": n_gen / wall, "wall_s": wall,
               "prefill_ms": {b: 1e3 * statistics.median(v)
                              for b, v in pre.items()},
               "decode_ms_per_dispatch": 1e3 * statistics.median(dec),
               "n_dispatches": len(dec),
               "decode_steps": eng.stats["decode_steps"]}
    del eng
    torch.cuda.empty_cache()
    return counts, summary


def phase_full_paged(dev, cfg, params):
    counts, summary = serve_full(dev, cfg, params, "full e2e paged",
                                 ("decode_attention_paged",
                                  "flash_attention"),
                                 paged=True, page_size=16, n_pages=256)
    # outputs: finite last-position logits with the padded vocab masked
    import torch
    from repro_torch.models.transformer import lm_prefill_batched
    prompt = torch.from_numpy(_requests(cfg, 1, 64, 64, 1, SEED)[0]
                              .prompt[None]).to(dev)
    logits, _ = lm_prefill_batched(params, prompt, cfg)
    if logits.shape != (1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()) or \
            not bool((logits[:, cfg.vocab_size:] == -1e30).all()):
        fail("full-width prefill logits are not finite/masked as expected")
    return counts, summary


def phase_full_fixed(dev, cfg, params):
    need = ("decode_attention_lengthaware", "flash_attention")
    counts, summary = serve_full(dev, cfg, params, "full e2e fixed-lane",
                                 need)
    per_step = counts["decode_attention_lengthaware"] / summary["decode_steps"]
    print(f"[full e2e fixed-lane] K3 launches per decode step: {per_step}")
    if per_step != cfg.n_layers:
        fail(f"K3 launched {per_step} times per decode step, not "
             f"{cfg.n_layers}")
    # the same traffic sampled at temperature 0.8: every budget finishes
    # inside the vocabulary (serve_full checks both)
    _, sampled = serve_full(dev, cfg, params, "full e2e fixed-lane t=0.8",
                            need, temperature=0.8, rng_seed=SEED)
    summary["temperature_0.8"] = sampled
    return counts, summary


def phase_full_int8(dev, cfg, params):
    """The same traffic with ``kv_quant="int8"`` on both layouts: K5
    (fixed-lane) and K4 (paged) launch 28 times per decode step, the fp
    decode kernels never."""
    import dataclasses
    cfg_q = dataclasses.replace(cfg, kv_quant="int8")
    out = {}
    for tag, kernel, fp_kernel, kw in (
            ("full e2e fixed-lane int8", "decode_attention_q8_lengthaware",
             "decode_attention_lengthaware", {}),
            ("full e2e paged int8", "decode_attention_paged_q8",
             "decode_attention_paged",
             dict(paged=True, page_size=16, n_pages=256))):
        counts, summary = serve_full(dev, cfg_q, params, tag,
                                     (kernel, "flash_attention"), **kw)
        per_step = counts[kernel] / summary["decode_steps"]
        print(f"[{tag}] {kernel} launches per decode step: {per_step}")
        if per_step != cfg.n_layers:
            fail(f"{kernel} launched {per_step} times per decode step, not "
                 f"{cfg.n_layers}")
        if counts[fp_kernel] or counts["decode_attention_q8_masked"]:
            fail(f"{tag}: another decode kernel ran: {counts}")
        out[tag] = (counts, summary)
    return out


def phase_timings(dev):
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    rows = {}
    # K1: bf16, main-path shapes
    q, kp, vp, bt, lens = k1_inputs(torch.bfloat16, dev)
    ps, t = kp.shape[2], bt.shape[1]
    live = lens.clamp(max=t * ps).to(torch.int64)
    n_live = int(live.sum().item())
    hkv, d, h = kp.shape[1], kp.shape[3], q.shape[1]
    pages_live = int(((live + ps - 1) // ps).sum().item())
    k1_bytes = (2 * n_live * hkv * d * 2 + 2 * q.numel() * 2
                + 4 * pages_live + 4 * lens.numel())
    k1_flops = 4 * n_live * h * d
    rows["decode_attention_paged"] = dict(
        ms=time_ms(lambda: decode_attention_paged(q, kp, vp, bt, lens)),
        plain_ms=time_ms(lambda: decode_attention_paged_ref(q, kp, vp, bt,
                                                            lens)),
        library_ms=None, bytes=k1_bytes, flops=k1_flops)
    # K2: bf16, B=1, Sq=Sk=512, causal
    q, k, v = k2_inputs(512, torch.bfloat16, dev)
    sq = q.shape[2]
    pairs = sq * (sq + 1) // 2
    k2_flops = 4 * q.shape[0] * q.shape[1] * pairs * q.shape[3]
    k2_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    rows["flash_attention"] = dict(
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=True)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        bytes=k2_bytes, flops=k2_flops)
    # K3 / K6a: bf16, fixed-lane path shapes (S = 1024)
    q, k, v, lens = dense_inputs(torch.bfloat16, dev)
    b, hkv, s, d = k.shape
    h = q.shape[1]
    n_live = int(lens.to(torch.int64).sum().item())
    io_bytes = 2 * q.numel() * 2 + 4 * lens.numel()     # q, out, lens
    live = lens >= 1                                    # SDPA: no dead lane
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[live]
    mask = mask[:, None, None, :].contiguous()
    ql, kl, vl = q[live][:, :, None].contiguous(), k[live], v[live]
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, enable_gqa=True))
    for name, la, n_pos in (("decode_attention_lengthaware", True, n_live),
                            ("decode_attention_masked", False, b * s)):
        rows[name] = dict(
            ms=time_ms(lambda: decode_attention(q, k, v, lens,
                                                length_aware=la)),
            plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, lens)),
            library_ms=sdpa_ms,
            bytes=2 * n_pos * hkv * d * 2 + io_bytes,
            flops=4 * n_pos * h * d)
    # K5 / K6b / K4: bf16 q over int8 caches with the model's per-token
    # scales (qblock 1), the serves' layout; no single PyTorch call
    # computes int8 attention, so beside each stands the reference
    # model's route (dequantize to float32, then K3 or K1) instead
    q, kq, ks, vq, vs, lens = q8_dense_inputs(torch.bfloat16, dev, 1024, 1)
    b, hkv, s, d = kq.shape
    h = q.shape[1]
    n_live = int(lens.to(torch.int64).sum().item())
    row_bytes = hkv * (2 * d + 2 * 4)       # int8 k and v, f32 k/v scales
    route_ms = time_ms(lambda: _route_dense(q, kq, ks, vq, vs, lens, 1))
    for name, la, n_pos in (("decode_attention_q8_lengthaware", True,
                             n_live),
                            ("decode_attention_q8_masked", False, b * s)):
        rows[name] = dict(
            ms=time_ms(lambda: decode_attention_q8(q, kq, ks, vq, vs, lens,
                                                   qblock=1,
                                                   length_aware=la)),
            plain_ms=time_ms(lambda: decode_attention_q8_ref(
                q, kq, ks, vq, vs, lens, qblock=1)),
            library_ms=None, route_ms=route_ms,
            bytes=n_pos * row_bytes + io_bytes,
            flops=4 * n_pos * h * d + 2 * n_pos * hkv * d)
    q, kq, ks, vq, vs, bt, lens = q8_paged_inputs(torch.bfloat16, dev, 1)
    ps, t = kq.shape[2], bt.shape[1]
    live = lens.clamp(max=t * ps).to(torch.int64)
    n_live = int(live.sum().item())
    pages_live = int(((live + ps - 1) // ps).sum().item())
    rows["decode_attention_paged_q8"] = dict(
        ms=time_ms(lambda: decode_attention_paged_q8(q, kq, ks, vq, vs, bt,
                                                     lens, qblock=1)),
        plain_ms=time_ms(lambda: decode_attention_paged_q8_ref(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms(lambda: _route_paged(q, kq, ks, vq, vs, bt, lens,
                                              1)),
        bytes=(n_live * row_bytes + 2 * q.numel() * 2 + 4 * pages_live
               + 4 * lens.numel()),
        flops=4 * n_live * h * d + 2 * n_live * hkv * d)
    for name, r in rows.items():
        t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * r["flops"] / BF16_FLOPS_PER_S
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = r["library_ms"]
        route = (f", dequantize + fp kernel {r['route_ms']:.4f} ms"
                 if "route_ms" in r else "")
        print(f"[time] {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}{route}, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} B, "
              f"{r['flops']} flop)")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    errs = {"decode_attention_paged": phase_k1(dev),
            "flash_attention": phase_k2(dev)}
    errs.update(phase_dense(dev))
    errs.update(phase_q8(dev))
    phase_smoke_e2e(dev)
    phase_smoke_e2e(dev, kv_quant="int8")
    cfg, params = init_full(dev)
    paged_counts, paged_e2e = phase_full_paged(dev, cfg, params)
    fixed_counts, fixed_e2e = phase_full_fixed(dev, cfg, params)
    int8 = phase_full_int8(dev, cfg, params)
    del params
    rows = phase_timings(dev)

    replaces = {
        "decode_attention_paged":
            "src/repro/kernels/decode_attention/kernel.py:322",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85",
        "decode_attention_lengthaware":
            "src/repro/kernels/decode_attention/kernel.py:205",
        "decode_attention_masked":
            "src/repro/kernels/decode_attention/kernel.py:98",
        "decode_attention_paged_q8":
            "src/repro/kernels/decode_attention/kernel.py:406",
        "decode_attention_q8_lengthaware":
            "src/repro/kernels/decode_attention/kernel.py:545",
        "decode_attention_q8_masked":
            "src/repro/kernels/decode_attention/kernel.py:456",
    }
    sources = {"decode_attention_lengthaware": "decode_attention_dense",
               "decode_attention_masked": "decode_attention_dense",
               "decode_attention_q8_lengthaware": "decode_attention_dense",
               "decode_attention_q8_masked": "decode_attention_dense",
               "decode_attention_paged_q8": "decode_attention_paged"}
    # each kernel's launches come from the main-path run that drives it:
    # K1 from the paged serve, K2 and K3 from the fixed-lane (default)
    # serve, K5 from the fixed-lane int8 serve, K4 from the paged int8
    # serve; K6a and K6b are on no serving path and report the count of
    # the fixed-lane serve of their cache type, 0
    int8_fixed = int8["full e2e fixed-lane int8"][0]
    int8_paged = int8["full e2e paged int8"][0]
    launches = dict(fixed_counts)
    launches["decode_attention_paged"] = paged_counts["decode_attention_paged"]
    for name in ("decode_attention_q8_lengthaware",
                 "decode_attention_q8_masked"):
        launches[name] = int8_fixed[name]
    launches["decode_attention_paged_q8"] = \
        int8_paged["decode_attention_paged_q8"]
    kernels = []
    for name in ("decode_attention_paged", "flash_attention",
                 "decode_attention_lengthaware", "decode_attention_masked",
                 "decode_attention_paged_q8",
                 "decode_attention_q8_lengthaware",
                 "decode_attention_q8_masked"):
        r = rows[name]
        err_bf16, tol_bf16 = errs[name]["bfloat16"]
        err_f32, tol_f32 = errs[name]["float32"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err_bf16, "tol": tol_bf16,
            "max_abs_err_f32": err_f32, "tol_f32": tol_f32,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bytes": r["bytes"]})
        if "route_ms" in r:
            kernels[-1]["route_ms"] = r["route_ms"]
    e2e = {"paged": paged_e2e, "fixed_lane": fixed_e2e,
           "paged_int8": int8["full e2e paged int8"][1],
           "fixed_lane_int8": int8["full e2e fixed-lane int8"][1]}
    for name, r in e2e.items():
        print(f"[e2e] {name}: {r['tok_s']:.1f} tok/s, decode "
              f"{r['decode_ms_per_dispatch']:.2f} ms per dispatch")
    print(f"[e2e] {json.dumps(e2e)}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
