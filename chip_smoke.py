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
4. end to end at SMOKE width in float32: the same requests through
   ``ServeEngine(paged=True)`` on the CPU (plain versions) and on the
   card (kernels) must give identical greedy streams;
5. end to end at full width: qwen2.5-1.5b in bfloat16 with seeded
   random weights, 16 requests through the paged engine; every request
   must finish its budget and both kernels must have launched;
6. timings at the main-path shapes: each kernel, its plain version and
   (for K2) PyTorch's own attention call, beside the card's bound.

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


def _requests(cfg, n, plen_lo, plen_hi, gen, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    plens = rng.integers(plen_lo, plen_hi + 1, n)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(p)
                                               ).astype(np.int32),
                    max_new_tokens=gen) for i, p in enumerate(plens)]


def phase_smoke_e2e(dev):
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED), cpu)
    streams = {}
    for where, p in (("cpu", params), ("cuda", copy.deepcopy(params).to(dev))):
        eng = ServeEngine(cfg, p, n_lanes=4, max_len=128, page_size=16,
                          n_pages=24, device=where)
        reqs = _requests(cfg, 10, 3, 140, 16, SEED + 1)
        eng.run(reqs)
        streams[where] = [r.generated for r in reqs]
        eng.pool.check()
    same = sum(a == b for a, b in zip(streams["cpu"], streams["cuda"]))
    print(f"[smoke e2e] float32 SMOKE: {same}/{len(streams['cpu'])} "
          f"greedy streams identical CPU vs card")
    if same != len(streams["cpu"]):
        fail("SMOKE greedy streams differ between CPU and card")


def phase_full_e2e(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.transformer import lm_prefill_batched
    from repro_torch.serving import ServeEngine
    cfg = get_config("qwen2.5-1.5b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[full e2e] {cfg.name} bf16, {n_params / 1e9:.3f}B params "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    gen = 64
    eng = ServeEngine(cfg, params, n_lanes=8, max_len=1024, page_size=16,
                      n_pages=256, device=dev, timed=True)
    reqs = _requests(cfg, 16, 64, 700, gen, SEED + 2)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_gen = sum(len(r.generated) for r in reqs)
    eng.pool.check()
    if not all(r.done and len(r.generated) == gen for r in reqs):
        fail("full-width run did not finish every request's budget")
    toks = np.concatenate([r.generated for r in reqs])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail("generated token outside the vocabulary")
    if min(counts.values()) <= 0:
        fail(f"a kernel of the main path never launched: {counts}")
    pre = eng.timings["prefill"]
    dec = eng.timings["decode"]
    print(f"[full e2e] {len(reqs)} requests, {n_gen} tokens in {wall:.3f}s "
          f"= {n_gen / wall:.1f} tok/s end to end; stats {eng.stats}")
    for bucket in sorted(pre):
        print(f"[full e2e] prefill bucket {bucket}: {len(pre[bucket])} "
              f"prompts, median {1e3 * statistics.median(pre[bucket]):.2f} "
              f"ms")
    print(f"[full e2e] decode: {len(dec)} dispatches, median "
          f"{1e3 * statistics.median(dec):.2f} ms per dispatch "
          f"({eng.dispatch_n} steps x {eng.n_lanes} lanes max)")
    print(f"[full e2e] launches: {counts}")
    # outputs: finite last-position logits with the padded vocab masked
    prompt = torch.from_numpy(reqs[0].prompt[None, :64]).to(dev)
    logits, _ = lm_prefill_batched(params, prompt, cfg)
    if logits.shape != (1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()) or \
            not bool((logits[:, cfg.vocab_size:] == -1e30).all()):
        fail("full-width prefill logits are not finite/masked as expected")
    summary = {"tok_s": n_gen / wall, "wall_s": wall,
               "prefill_ms": {b: 1e3 * statistics.median(v)
                              for b, v in pre.items()},
               "decode_ms_per_dispatch": 1e3 * statistics.median(dec),
               "n_dispatches": len(dec)}
    del params, eng
    torch.cuda.empty_cache()
    return counts, summary


def phase_timings(dev):
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged, decode_attention_paged_ref)
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
    for name, r in rows.items():
        t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * r["flops"] / BF16_FLOPS_PER_S
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = r["library_ms"]
        print(f"[time] {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
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
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    phase_smoke_e2e(dev)
    counts, e2e = phase_full_e2e(dev)
    rows = phase_timings(dev)

    replaces = {
        "decode_attention_paged":
            "src/repro/kernels/decode_attention/kernel.py:322",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85",
    }
    errs = {"decode_attention_paged": k1_err, "flash_attention": k2_err}
    kernels = []
    for name in ("decode_attention_paged", "flash_attention"):
        r = rows[name]
        err_bf16, tol_bf16 = errs[name]["bfloat16"]
        err_f32, tol_f32 = errs[name]["float32"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": err_bf16, "tol": tol_bf16,
            "max_abs_err_f32": err_f32, "tol_f32": tol_f32,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
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
