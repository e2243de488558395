#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in
order (any failure raises and the script exits non-zero):

1. build every kernel from ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, started together) and print the card;
2. K1 (paged decode attention, one split-KV launch through the block
   table) against its plain version at the main path's shapes (pages
   of 16), and over pages of 8 and 32 and a lane of 1000 positions (so
   chunks straddle pages and the last chunk is short), float32 (TF32
   off, tol 1e-4) and bfloat16 (tol 2e-2): a dead lane gives exactly
   0, table slots past the length (page ids far outside the pools) are
   never read, a second call repeats the bits, and K1 equals K3 on the
   gathered pools bit for bit;
3. K2 (flash prefill) against its plain version at ``K2_CASES``: causal
   at Sq 64, 100, 512 and 1024, a sliding window, no mask, a window
   without causality, D 64, 96 (phi-3-vision's, causal and windowed)
   and 256, the float32 SMOKE serve's own shape (H 4, Hkv 2, D 32)
   at its prompt buckets 8 to 128, and hymba-1.5b's (H 25 over Hkv 5, D
   64, window 1024, Sq 2048 and 512; SMOKE's window 32 at D 32); float32
   on the CUDA-core kernel
   (``flash_attention_cc``, tol 1e-4) and bfloat16 on the tensor-core
   kernel (``flash_attention_mma``, tol 2e-2) at D 64 and 128, on the
   CUDA-core one at D 32, 96 and 256, each call's launch counters
   naming the kernel its dtype and D select;
4. K3 (length-aware dense decode) and K6a (masked dense decode), one
   split-KV launch each, against their plain version at the fixed-lane
   path's shapes (S = 1024) and at S = 1000, same tolerances; a dead
   lane gives exactly 0, K3 equals K6a, and a second call of each gives
   the same bits;
5. K5 (length-aware int8 dense decode), K6b (masked int8 dense decode)
   and K4 (paged int8 decode) against their plain versions at the same
   shapes, q in float32 and bfloat16, at the model's ``qblock=1``
   (per-token scales) and the reference kernels' own (32 dense, 16
   paged; K4 also over pages of 8 at qblock 1 and of 32 at qblock 16);
   a dead lane gives exactly 0, K5 equals K6b and repeats its bits, K4
   repeats its bits and equals K5 on the gathered pools at the same
   qblock, and at ``qblock=1`` each agrees with the reference model's
   route (dequantize to float32, then K3 or K1); then K3, K1, K5 and K4
   at hymba-1.5b's decode shapes (GQA group 5, D 64, a ring of 1024
   slots, four lanes at lengths 96, 1000, 1024 and 1500, so two rings
   have wrapped, paged through a shuffled table), each against its
   plain version, K1 giving K3's bits on the gathered rings and K4
   K5's;
6. end to end at SMOKE width in float32: the same requests through
   ``ServeEngine()`` (fixed-lane) and ``ServeEngine(paged=True)``,
   greedy and at temperature 0.8, on the CPU (plain versions) and on
   the card (kernels): CPU and card streams, and fixed-lane and paged
   streams on the card, must be identical; once with the cache in the
   compute dtype and once with ``kv_quant="int8"``; the card's float32
   prefill must run K2's CUDA-core kernel.  On the card every decode
   dispatch after the first of its size is a CUDA graph replay (one
   graph per ``n_steps``): each serve must count replays ==
   ``decode_dispatches - decode_compiles`` > 0, and once in each serve,
   after the ``dispatch_n`` graph is captured and with lanes live, one
   replayed dispatch is held bit for bit against the eager
   ``model.decode_n_steps`` on the same saved state (tokens, valid
   flags, budgets, lengths, next tokens, token indices and every cache
   tensor, i.e. the KV rows or ssm state written), and both are timed
   (host clock, synced; the check's own launches and replays are taken
   back out of the serve's counts);
7. end to end at full width, paged: qwen2.5-1.5b in bfloat16 with
   seeded random weights, 16 requests through ``ServeEngine(paged=
   True)``; every request must finish its budget, K2's tensor-core
   kernel must have launched and K1 28 times per decode step (counted
   through the graphs' replay accounting); the replay gate and check
   of phase 6, with each graph's capture seconds, the graph pool's
   size, and decode ms per dispatch eager and replayed;
8. end to end at full width, fixed-lane (the engine's default): the
   same 16 requests through ``ServeEngine()``; every request must
   finish, K2's tensor-core kernel and K3 must have launched, K3 28
   times per decode step; then a short run at temperature 0.8 whose
   tokens must all finish inside the vocabulary;
9. end to end at full width with ``kv_quant="int8"``: the same 16
   requests fixed-lane and paged; every request must finish, K5 (resp.
   K4) must launch 28 times per decode step and the fp decode kernels
   not at all;
10. timings at the main-path shapes, as device time per call (CUDA
   events around 20 calls queued behind a busy-wait, so the host's
   launch cost stays out): each kernel, its plain version and
   ``F.scaled_dot_product_attention`` where one call computes the same
   function, beside the card's bound; K2 in bf16 at Sq 512 and 1024 and
   in float32 at Sq 512, and in bf16 at D 96 (the CUDA-core kernel);
   for K1 also its pages gathered and then SDPA
   (no single call reads a block table); for the int8 kernels also the
   reference model's route (dequantize to float32, then K3 or K1);
11. the paper's compute path, checked: K8 (mixbench) in float32 and
   bfloat16, both arms, at 1, 16 and 128 steps, in one grid-stride
   pass and in several, aligned and not (f32 mul_add and bf16
   bitwise, f32 fma within 1e-6); K9 (fma_matmul) both variants in
   float32 and bfloat16 at (128, 1024, 512), the qwen2.5-1.5b MLP
   shapes (128, 1536, 8960) and (128, 8960, 1536), one decode row
   (1, 1536, 8960) and a ragged shape (100, 1000, 520) against one f32
   matmul (K9_TOL), every call run twice and required to repeat bit
   for bit, the launch counters showing each arm's weight stream
   there and its staged kernel (WMMA, or FMUL/FADD on 64 x 64 tiles)
   at (128, 1536, 130), whose rows are not whole 16-byte chunks; K7
   (qmatmul: dequant_dot on the bf16 tensor cores, dot_i8 on the int8
   ones) on those weights quantized on the card in all four formats
   and on a (512, 100) weight (rows that are not whole 16-byte chunks:
   the _plain kernels), dequant_dot and q8_0 dot_i8 at M 1, 8, 24, 128
   and 256 with float32 and bfloat16 activations, within 1e-5, every
   call run twice and required to repeat bit for bit, the launch
   counters naming the variant;
12. the instructions (``cuobjdump -sass``): no FFMA/HFMA2/HMMA in any
   mul_add kernel of K8 and K9 (K9's stream and staged kernels) and
   FMUL and FADD present, none in the split-K reduce either (adds
   alone), FFMA/HFMA2 in K8's fma kernels, HMMA in K9's mxu kernels --
   the paper's ``-fmad=false``; HMMA in K2's bf16 kernels and in K10's
   four kernels, and no HMMA or HGMMA in K2's CUDA-core kernels and
   the dense and paged decode kernels; HMMA in every K7 dequant_dot
   kernel, IMMA and no IDP.4A in every dot_i8 kernel;
13. the compute path through its entry points, launch counts zeroed
   before and read after: the K8 intensity sweep (2^26 float32
   elements, 1 to 1024 steps, both arms: GFLOP/s and GB/s per point,
   the fused/unfused peak ratio and the stream rate; its output at 1,
   64 and 1024 steps held to the plain version as in 11), ``matmul(x, w,
   policy=PathPolicy(p))`` for the four profiles (each must launch the
   variant the reference's policy picks) and ``qmatmul(x, qt,
   profile=CMP_170HX)`` for the four formats (dot_i8 for q8_0,
   dequant_dot otherwise);
14. timings of K8, K9 and K7 at full width beside their bounds, plain
   versions and ``torch.matmul`` (K9) or the dequantize-then-matmul
   route (K7); K9's and K7's as device time per call (launches queued
   behind a busy-wait): each K9 arm at both MLP shapes in float32 and
   bfloat16 (mxu beside TF32 or bf16 ``torch.matmul``, mul_add beside
   one f32 ``torch.matmul`` with TF32 off) with its TB/s, TFLOP/s and
   share of the bound, and each arm's staged kernel at (128, 1536,
   8958); K7's dequant_dot q4_k and dot_i8 q8_0 at both MLP shapes, M
   128 and 8, float32 and bfloat16 x (``by_shape``), and dequant_dot in
   every format at float32 (128, 1536, 8960);
15. K10 (the SSD chunk scan: C.B^T once per chunk, then the per-head
   products on the tensor cores) against its plain version at
   mamba2-780m's widths (H 48, P 64, N 128, chunk 256): S 64, 256, 1024
   and 2048, B 1 and 2, x/b/c in float32 and bfloat16, A over the
   model's range and from ``-exp(0.3 randn)``; at every serve bucket
   (one chunk of Q 8 to 256), at SMOKE's widths (H 8, P 32, N 16,
   chunk 32), at odd widths (H 3, P 30, N 20) with chunk 50, at the
   longest chunk (1024), and at hymba-1.5b's widths (H 50, P 64, N 16:
   a quarter of the kernel's state tile) at S 256, 1024 and 2048;
   relative max error <= K10_TOL on all three
   outputs; the full SSD on K10 against ``ssd_chunked`` at S 2048;
16. end to end at SMOKE width in float32, mamba2: CPU and card streams
   identical, fixed-lane and paged, greedy and at temperature 0.8, with
   lanes reused; K10 launched on every layer of every card prefill;
   the replay gate and check of phase 6, and every prompt token but
   the engine's first streamed by a replay of the captured batch-1
   decode step;
17. end to end at full width, mamba2-780m in bfloat16 with seeded
   random weights: 3 requests fixed-lane and 2 of them paged, K10
   launched 48 times per prompt; the prefill's logits at the last
   prompt position (K10's path) beside the streamed ones (the recurrent
   path); the graph gates and check of phase 16, and 64 prompt tokens
   streamed into a free lane by replays and eagerly (``decode_step`` on
   a fresh batch-1 state), logits and state bitwise equal, ms per
   token of each.  The serve discards the prefill's logits for the streamed
   ones, as the reference does, so these K10 launches (the kernels
   line's ``launches``) are counted but their output is only printed,
   not gated;
18. ``build_model(cfg).forward`` at full width: bfloat16 at S 2048 (48
   K10 launches, finite logits; timed on the host clock, and the
   device's busy time by kernel from ``torch.profiler``, K10's share
   apart), and in float32 every position of a
   512-token prompt against the logits of streaming it through
   ``lm_decode_step`` (which never runs K10), max |diff| <= SSM_FWD_TOL:
   these 48 launches (``launches_forward_checked``) are the ones whose
   output is checked; then K10's timing row beside its bound, as
   device time per call (launches queued behind a busy-wait);
19. end to end at SMOKE width in float32, hymba (the hybrid family:
   attention with a window of 32 beside Mamba-2 heads in every block),
   with the KV in float32 and in int8: the checks of phase 6 (CPU and
   card streams identical, fixed-lane and paged, greedy and at t=0.8,
   prompts that wrap the window), the prompt-stream gate of phase 16,
   K2's CUDA-core kernel and K10 on every layer of every card prefill,
   K3 and K1 (K5 and K4 in int8) in the decode;
20. end to end at full width, hymba-1.5b in bfloat16 with seeded random
   weights: prompts of 96, 700, 1000 and 1100 tokens (one wraps the
   window of 1024, one decode crosses it), 64 new tokens, 4 lanes,
   ``max_len`` 2048, fixed-lane and paged (pages of 16); K2's
   tensor-core kernel and K10 launched 32 times a prompt, K3 (resp. K1)
   32 times a decode step beside 32 times a streamed prompt token
   (replay accounting); the graph gates and checks of phase 17, the
   stream check holding the K/V the stream wrote too; tok/s, decode
   and stream ms eager and replayed, prefill ms per bucket, capture s;
21. timings at hymba-1.5b's shapes, as in phase 10: K2 bf16 at Sq 2048
   and 1024 with the window (beside SDPA with the window as a mask),
   K3, K1, K5 and K4 at the wrapped ring, K10 at N 16.

The last two lines are the ``{"kernels": [...]}`` summary and the
``{"ok": true, ...}`` verdict.  Exits non-zero, printing no result, when
no CUDA device is present or the port's sources are not beside it.
"""

from __future__ import annotations

import gc
import itertools
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


def host_ms(fn, warmup: int = 5, reps: int = 10, calls: int = 50) -> float:
    """Host time to issue one ``fn``: median over ``reps`` of the wall
    time of ``calls`` calls issued back to back from an idle card, not
    waiting for it, over ``calls``.  A host-bound serve pays this for
    every launch, whatever the device time."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_ms_queued(fn, warmup: int = 5, reps: int = 30,
                   launches: int = 20) -> float:
    """Device time of one ``fn``: median over ``reps`` of CUDA events
    around ``launches`` calls queued behind a busy-wait kernel, over
    ``launches``.  The wait lets the host enqueue every call before the
    first one starts, so the host's launch cost (which exceeds a short
    kernel's time) stays out of the reading."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)          # ~2 ms at 1.98 GHz
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


# ----------------------------------------------------------------------
# the decode dispatch's CUDA graphs
# ----------------------------------------------------------------------

def _dispatch_state(eng):
    """Clones of every tensor a decode dispatch reads or writes."""
    out = {f"cache.{k}": t.clone() for k, t in eng.cache.items()}
    for name in ("_next_token", "_remaining", "_tok_idx"):
        out[name] = getattr(eng, name).clone()
    return out


def _restore_dispatch_state(eng, state):
    for key, t in state.items():
        dst = (eng.cache[key[len("cache."):]] if key.startswith("cache.")
               else getattr(eng, key))
        dst.copy_(t)


def check_replay(eng, tag, reps: int = 3):
    """One replayed dispatch of ``eng.dispatch_n`` steps against the eager
    ``model.decode_n_steps`` on the same saved state (lengths, next
    tokens, budgets, token indices, the cache): tokens, valid flags,
    budgets, lengths, next tokens, token indices and every cache tensor
    (the KV rows or ssm state written) must be equal bit for bit.  Then
    ``reps`` of each, timed on the host clock with the device synced,
    the state restored before each.  The engine is left as it was, its
    launch counts too; returns the timings and the replays it made."""
    import torch
    from repro_torch.kernels import add_launches, launch_counts, launch_delta
    n = eng.dispatch_n
    counts = launch_counts()
    eng.map_dispatch_pages(n)             # as decode_n does before it
    saved = _dispatch_state(eng)

    def replay():
        block, first = eng.graphs.run(n, lambda: eng._decode_block(n))
        if first:
            fail(f"{tag}: the n_steps={n} graph was not captured yet")
        return {"toks": block[:n], "valid": block[n:2 * n],
                "remaining": block[2 * n], "len": eng.cache["len"],
                "next": eng._next_token, "tok_idx": eng._tok_idx}

    def eager():
        toks, valid, nxt, cache, rem, idx = eng.model.decode_n_steps(
            eng.params, eng.cache, eng._next_token, eng._rng_decode,
            eng._remaining, eng._lane_seed, eng._tok_idx, n_steps=n,
            temperature=eng.temperature, len_cap=eng.max_len - 1)
        return {"toks": toks, "valid": valid.to(torch.int32),
                "remaining": rem, "len": cache["len"], "next": nxt,
                "tok_idx": idx}

    def timed(fn):
        _restore_dispatch_state(eng, saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        out["toks"].cpu()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def written():
        """The cache tensors a live lane may read: on the paged layout
        every page but the scratch page, which dead lanes write at once
        (their values race there, and no live lane reads it)."""
        return {k: (v[:, :eng._scratch_page] if k.endswith("_pages")
                    else v) for k, v in eng.cache.items() if k != "len"}

    got, _ = timed(replay)
    got = {k: v.clone() for k, v in got.items()}
    got.update({k: v.clone() for k, v in written().items()})
    want, _ = timed(eager)
    want.update(written())
    differ = [k for k in sorted(want) if not torch.equal(got[k], want[k])]
    if differ:
        fail(f"{tag}: a replayed dispatch differs from eager "
             f"decode_n_steps on the same state in {differ}")
    graph_s = [timed(replay)[1] for _ in range(reps)]
    eager_s = [timed(eager)[1] for _ in range(reps)]
    _restore_dispatch_state(eng, saved)
    add_launches(launch_delta(launch_counts(), counts))
    torch.cuda.synchronize()
    print(f"[{tag}] replayed dispatch == eager decode_n_steps bitwise "
          f"(n_steps {n}, {len(eng.live_lanes())} live lanes: tokens, "
          f"valid, budgets, lengths, next tokens, token indices, "
          f"{len(eng.cache) - 1} cache tensors); host ms a dispatch, "
          f"synced: eager {[round(1e3 * t, 3) for t in eager_s]}, graph "
          f"{[round(1e3 * t, 3) for t in graph_s]}")
    return {"n_steps": n, "check_replays": 1 + reps,
            "decode_ms_eager": 1e3 * statistics.median(eager_s),
            "decode_ms_graph": 1e3 * statistics.median(graph_s)}


def check_replay_midway(eng, tag, out):
    """Wrap ``eng.decode_n`` so that :func:`check_replay` runs once,
    after the first dispatch that captured ``dispatch_n`` with lanes
    still live; its result goes to ``out["check"]``."""
    decode_n = eng.decode_n

    def wrapped(n=None):
        res = decode_n(n)
        if "check" not in out and eng.live_lanes() and \
                eng.dispatch_n in eng.timings["capture"]:
            out["check"] = check_replay(eng, tag)
        return res

    eng.decode_n = wrapped


def graph_summary(eng, tag, check):
    """Fail unless the serve replayed a graph for every dispatch but the
    first of each size (replays == decode_dispatches - decode_compiles
    > 0, ``check``'s own replays left out) and ``check`` ran; returns
    the serve's graph figures."""
    if check is None:
        fail(f"{tag}: the replay-vs-eager check never ran")
    sizes = sorted(k for k in eng.timings["capture"] if isinstance(k, int))
    replays = (sum(eng.graphs.replays(k) for k in sizes)
               - check["check_replays"])
    st = eng.stats
    if st["decode_compiles"] != len(sizes):
        fail(f"{tag}: decode_compiles {st['decode_compiles']} but graphs "
             f"captured for sizes {sizes}")
    if replays != st["decode_dispatches"] - st["decode_compiles"] or \
            replays <= 0:
        fail(f"{tag}: {replays} graph replays for "
             f"{st['decode_dispatches']} dispatches and "
             f"{st['decode_compiles']} compiles: the serve ran eagerly")
    dec = eng.timings["decode"]          # empty unless the engine is timed
    replayed = [t for t, r in zip(dec, eng.timings["decode_replayed"]) if r]
    first = [t for t, r in zip(dec, eng.timings["decode_replayed"]) if not r]
    return {"decode_compiles": st["decode_compiles"], "replays": replays,
            "capture_s": {str(k): eng.timings["capture"][k]
                          for k in sorted(eng.timings["capture"], key=str)},
            "pool_bytes": eng.graphs.pool_bytes(),
            "replayed_ms_median": (1e3 * statistics.median(replayed)
                                   if replayed else None),
            "first_dispatch_ms": [1e3 * t for t in first], **check}


def stream_gate(eng, tag, reqs):
    """Fail unless every prompt token but the engine's first streamed
    through the ssm step's graph (one replay a token)."""
    want = sum(min(len(r.prompt), eng.max_len - 1) for r in reqs) - 1
    got = eng.graphs.replays("ssm_step")
    if got != want:
        fail(f"{tag}: {got} replays of the prompt stream's step for "
             f"{want + 1} prompt tokens")
    return got


def print_graphs(tag, g):
    pool = g["pool_bytes"]
    print(f"[{tag}] graphs: decode_compiles {g['decode_compiles']}, "
          f"replays {g['replays']}; capture s "
          f"{ {k: round(v, 3) for k, v in g['capture_s'].items()} }; pool "
          f"{'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'};"
          f" decode ms a dispatch (n_steps {g['n_steps']}, host, synced): "
          f"eager {g['decode_ms_eager']:.3f}, graph "
          f"{g['decode_ms_graph']:.3f}; the serve's replayed dispatches "
          f"median {g['replayed_ms_median']:.3f}, first (eager; capture "
          f"excluded) {[round(t, 3) for t in g['first_dispatch_ms']]}")


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


def k1_inputs(dtype, dev, ps=16, t=64):
    """Main-path shapes: B=8 lanes, H=12, Hkv=2, D=128, ps=16, T=64
    (max_len 1024), shuffled disjoint tables, ragged lengths incl. a
    dead lane and a full table (clamped to T*ps)."""
    import numpy as np
    import torch
    b, h, hkv, d = 8, 12, 2, 128
    n_pages = b * t + 1
    rng = np.random.default_rng(SEED if (ps, t) == (16, 64) else
                                (SEED, ps, t))
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    kp = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d),
                                              np.float32))
    bt = torch.from_numpy(rng.permutation(n_pages)[:b * t].reshape(b, t)
                          .astype(np.int32))
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024],
                        dtype=torch.int32)
    return ([x.to(dev, dtype) for x in (q, kp, vp)]
            + [bt.to(dev), lens.to(dev)])


#: (page size, pages a lane) of K1's and K4's checks: the serve's pages
#: of 16, pages of 8 and 32, and a lane of 1000 positions (T*ps not a
#: multiple of the chunk)
PAGED_CASES = ((16, 64), (8, 128), (32, 32), (8, 125))


def wild_table(bt, lens, ps):
    """``bt`` with every slot past a lane's length set to a page id far
    outside the pools: a kernel that read one would fault."""
    wild = bt.clone()
    for lane, n in enumerate(lens.tolist()):
        wild[lane, -(-min(n, bt.shape[1] * ps) // ps):] = 1 << 30
    return wild


def phase_k1(dev):
    """K1 against its plain version at PAGED_CASES, f32 (tol 1e-4) and
    bf16 (tol 2e-2), through a table whose slots past each length point
    far outside the pools; a dead lane gives 0, a second call repeats
    the bits, and K1 gives the bits of K3 on the gathered pools."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_ref,
        gather_pages)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for ps, t in PAGED_CASES:
            q, kp, vp, bt, lens = k1_inputs(dtype, dev, ps, t)
            wild = wild_table(bt, lens, ps)
            out = decode_attention_paged(q, kp, vp, wild, lens)
            again = decode_attention_paged(q, kp, vp, wild, lens)
            ref = decode_attention_paged_ref(q, kp, vp, bt, lens)
            k3 = decode_attention(q, gather_pages(kp, bt),
                                  gather_pages(vp, bt), lens)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            what = f"{dtype} ps={ps} T={t}"
            print(f"[K1] {what}: max_abs_err {err:.3e} (tol {tol}), "
                  f"bitwise K3 {torch.equal(out, k3)}")
            if not err <= tol:
                fail(f"K1 {what} disagrees with its plain version: {err}")
            if not bool(torch.all(out[0] == 0)):
                fail("K1: dead lane did not give 0")
            if not torch.equal(out, again):
                fail(f"K1 did not repeat its bits ({what})")
            if not torch.equal(out, k3):
                fail(f"K1 differs from K3 on the gathered pools ({what})")
            worst = max(worst, err)
        errs[str(dtype).split(".")[-1]] = (worst, tol)
    return errs


def k2_inputs(sq, dtype, dev, d=128, h=12, hkv=2):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + sq + (0 if d == 128 else d)
                                + (0 if hkv == 2 else 1000 * hkv))
    shapes = ((1, h, sq, d), (1, hkv, sq, d), (1, hkv, sq, d))
    return [torch.from_numpy(rng.standard_normal(s, np.float32)
                             ).to(dev, dtype) for s in shapes]


#: K2's check cases (Sq, causal, window, D, H, Hkv): the full-width
#: serve's buckets 64, 512 and 1024, a ragged length, a sliding window,
#: no mask (whisper's cross-attention later), a window without
#: causality, D 64, 96 (phi-3-vision's; causal, and a ragged windowed
#: prompt) and 256, and the float32 SMOKE serve's shape (D 32, H 4) at
#: its prompt buckets (prompts of 3 to 127 tokens); then hymba-1.5b's
#: (H 25 over Hkv 5, D 64, window 1024) at its serve's largest bucket,
#: 2048, where most query tiles start past key 0, and at 512, and its
#: SMOKE serve's (window 32, D 32, H 4 over 2)
K2_CASES = ((64, True, None, 128, 12, 2), (100, True, None, 128, 12, 2),
            (512, True, None, 128, 12, 2), (512, True, 128, 128, 12, 2),
            (1024, True, None, 128, 12, 2), (200, False, None, 128, 12, 2),
            (512, False, 96, 128, 12, 2), (512, True, None, 64, 12, 2),
            (256, True, None, 96, 12, 2), (300, True, 128, 96, 12, 2),
            (256, True, None, 256, 12, 2),
            *((sq, True, None, 32, 4, 2) for sq in (8, 16, 32, 64, 128)),
            (2048, True, 1024, 64, 25, 5), (512, True, 1024, 64, 25, 5),
            (64, True, 32, 32, 4, 2))
#: (D, H) of the float32 SMOKE serve's prefill, which runs K2's CUDA-core
#: kernel on the main path
SMOKE_K2_SHAPE = (32, 4)


def phase_k2(dev):
    """K2 against its plain version at K2_CASES, float32 (tol 1e-4) and
    bfloat16 (tol 2e-2); the launch counters must name the kernel that
    ``kernel_for`` picks from the dtype and D: the tensor-core kernel
    for bf16 at D 64 and 128, the CUDA-core kernel otherwise.  Returns
    {kernel: {dtype: (worst error over its cases, tol)}}, under
    ``"smoke"`` the worst float32 error at ``SMOKE_K2_SHAPE``, and under
    ``"hymba"`` the worst at hymba-1.5b's shapes (Hkv 5)."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import kernel_for
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        key = str(dtype).split(".")[-1]
        for sq, causal, window, d, h, hkv in K2_CASES:
            kernel = f"flash_attention_{kernel_for(dtype, d)}"
            q, k, v = k2_inputs(sq, dtype, dev, d, h, hkv)
            before = launch_counts()
            out = flash_attention(q, k, v, causal=causal, window=window)
            ran = {n: c - before[n] for n, c in launch_counts().items()
                   if c != before[n]}
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[K2] {dtype} Sq={sq} causal={causal} window={window} "
                  f"D={d} H={h} Hkv={hkv}: {kernel}, max_abs_err "
                  f"{err:.3e} (tol {tol})")
            if ran != {kernel: 1}:
                fail(f"K2 {dtype} D={d} launched {ran}, not {kernel}")
            if not err <= tol:
                fail(f"K2 {dtype} Sq={sq} D={d} window={window} "
                     f"disagrees: {err}")
            worst = errs.setdefault(kernel, {}).get(key, (0.0, tol))[0]
            errs[kernel][key] = (max(worst, err), tol)
            if dtype == torch.float32 and (d, h) == SMOKE_K2_SHAPE:
                worst = errs[kernel].get("smoke", (0.0, tol))[0]
                errs[kernel]["smoke"] = (max(worst, err), tol)
            if hkv == 5:
                worst = errs[kernel].get("hymba", (0.0, tol))[0]
                errs[kernel]["hymba"] = (max(worst, err), tol)
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
    """K3 and K6a against their plain version at S 1024 and 1000, f32
    (tol 1e-4) and bf16 (tol 2e-2): a dead lane gives exactly 0, K3
    equals K6a, and a second call of each repeats the bits (the merge
    adds the chunks in a fixed order)."""
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
            again = (decode_attention(*args),
                     decode_attention(*args, length_aware=False))
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
            if not (torch.equal(la, again[0]) and
                    torch.equal(masked, again[1])):
                fail(f"K3/K6a did not repeat their bits ({dtype}, S={s})")
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


def q8_paged_inputs(dtype, dev, qblock, ps=16, t=64):
    """``k1_inputs`` with the pools quantized to int8 with one f32 scale
    per ``qblock`` positions of a page."""
    from repro_torch.kernels.decode_attention import quantize_kv_q8
    q, kp, vp, bt, lens = k1_inputs(dtype, dev, ps, t)
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
    K4 (paged: pages of 16 at qblock 1 and 16, of 8 at qblock 1, of 32
    at qblock 16, through a table whose dead slots point outside the
    pools) against their plain versions; K4 repeats its bits and gives
    those of K5 on the gathered pools."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_q8, decode_attention_paged_q8_ref,
        decode_attention_q8, decode_attention_q8_ref, gather_pages)
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
            again = decode_attention_q8(*args, qblock=qblock)
            ref = decode_attention_q8_ref(*args, qblock=qblock)
            torch.cuda.synchronize()
            what = f"{dtype} S={s} qblock={qblock}"
            for name, out in ((names[0], la), (names[1], masked)):
                worst[name] = max(worst[name],
                                  check(name, out, ref, tol, what))
            if not torch.equal(la, masked):
                fail(f"K5 and K6b differ ({what})")
            if not torch.equal(la, again):
                fail(f"K5 did not repeat its bits ({what})")
            if qblock == 1:
                route = _route_dense(*args, qblock)
                torch.cuda.synchronize()
                err = max_err(la, route)
                print(f"[K4/K5/K6b] K5 vs dequantize + K3 {what}: "
                      f"max_abs_err {err:.3e}, bitwise {torch.equal(la, route)}")
                if not err <= tol:
                    fail(f"K5 disagrees with the reference's route: {err}")
        for ps, t, qblock in ((16, 64, 1), (16, 64, 16), (8, 128, 1),
                              (32, 32, 16)):
            args = q8_paged_inputs(dtype, dev, qblock, ps, t)
            q, kq, ks, vq, vs, bt, lens = args
            wild = wild_table(bt, lens, ps)
            out = decode_attention_paged_q8(q, kq, ks, vq, vs, wild, lens,
                                            qblock=qblock)
            again = decode_attention_paged_q8(q, kq, ks, vq, vs, wild,
                                              lens, qblock=qblock)
            ref = decode_attention_paged_q8_ref(*args, qblock=qblock)
            k5 = decode_attention_q8(
                q, gather_pages(kq, bt), gather_pages(ks, bt),
                gather_pages(vq, bt), gather_pages(vs, bt), lens,
                qblock=qblock)
            torch.cuda.synchronize()
            what = f"{dtype} ps={ps} qblock={qblock}"
            worst[names[2]] = max(worst[names[2]],
                                  check(names[2], out, ref, tol, what))
            print(f"[K4/K5/K6b] K4 vs K5 on the gathered pools {what}: "
                  f"bitwise {torch.equal(out, k5)}")
            if not torch.equal(out, again):
                fail(f"K4 did not repeat its bits ({what})")
            if not torch.equal(out, k5):
                fail(f"K4 differs from K5 on the gathered pools ({what})")
            if qblock == 1 and ps == 16:
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


#: hymba-1.5b's decode attention: H 25 over Hkv 5 (GQA group 5), D 64, a
#: ring of the window's 1024 slots (paged: 64 pages of 16), four lanes
#: at cache lengths 1000, 1024, 1500 and 96 -- the first three past the
#: window's last slot or wrapped, so every slot is read, the newest
#: mid-ring -- read with the model's lengths ``min(len + 1, 1024)``
HYMBA_DECODE = dict(h=25, hkv=5, d=64, s=1024, ps=16,
                    lens=(1000, 1024, 1500, 96))


def hymba_decode_inputs(dtype, dev):
    """q (B, 25, 64), pools (B * 64 + 1, 5, 16, 64) and a shuffled table
    (B, 64) of disjoint pages, the lengths the model passes, and the
    lanes' rings gathered from the pools (B, 5, 1024, 64)."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import gather_pages
    c = HYMBA_DECODE
    b, t = len(c["lens"]), c["s"] // c["ps"]
    rng = np.random.default_rng(SEED + 5)
    q = torch.from_numpy(rng.standard_normal((b, c["h"], c["d"]),
                                             np.float32))
    pools = [torch.from_numpy(rng.standard_normal(
        (b * t + 1, c["hkv"], c["ps"], c["d"]), np.float32))
        for _ in range(2)]
    bt = torch.from_numpy(rng.permutation(b * t + 1)[:b * t]
                          .reshape(b, t).astype(np.int32)).to(dev)
    lens = torch.tensor([min(n + 1, c["s"]) for n in c["lens"]],
                        dtype=torch.int32, device=dev)
    q, kp, vp = (x.to(dev, dtype) for x in [q] + pools)
    return q, kp, vp, bt, lens, gather_pages(kp, bt), gather_pages(vp, bt)


def phase_hymba_decode(dev):
    """K3 and K1 (and, over int8 with per-token scales, K5 and K4) at
    hymba-1.5b's decode shapes (``HYMBA_DECODE``: GQA group 5, a wrapped
    ring of 1024 slots, paged through a shuffled table) against their
    plain versions, f32 (tol 1e-4) and bf16 (tol 2e-2): K1 gives K3's
    bits on the gathered rings (K4 K5's), and each repeats its bits.
    Returns {kernel: {dtype: (max_abs_err, tol)}}."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages, quantize_kv_q8)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, kp, vp, bt, lens, k, v = hymba_decode_inputs(dtype, dev)
        kq, ks = quantize_kv_q8(kp.float(), 1)
        vq, vs = quantize_kv_q8(vp.float(), 1)
        gq = [gather_pages(x, bt) for x in (kq, ks, vq, vs)]
        runs = {
            "decode_attention_lengthaware": (
                lambda: decode_attention(q, k, v, lens),
                decode_attention_ref(q, k, v, lens)),
            "decode_attention_paged": (
                lambda: decode_attention_paged(q, kp, vp, bt, lens),
                decode_attention_paged_ref(q, kp, vp, bt, lens)),
            "decode_attention_q8_lengthaware": (
                lambda: decode_attention_q8(q, *gq, lens, qblock=1),
                decode_attention_q8_ref(q, *gq, lens, qblock=1)),
            "decode_attention_paged_q8": (
                lambda: decode_attention_paged_q8(q, kq, ks, vq, vs, bt,
                                                  lens, qblock=1),
                decode_attention_paged_q8_ref(q, kq, ks, vq, vs, bt, lens,
                                              qblock=1))}
        outs = {}
        for name, (run, ref) in runs.items():
            out, again = run(), run()
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[hymba decode] {name} {dtype} H=25 Hkv=5 D=64 S=1024 "
                  f"lengths {lens.tolist()}: max_abs_err {err:.3e} (tol "
                  f"{tol})")
            if not err <= tol:
                fail(f"{name} at hymba's shapes ({dtype}) disagrees with "
                     f"its plain version: {err}")
            if not torch.equal(out, again):
                fail(f"{name} did not repeat its bits at hymba's shapes")
            errs.setdefault(name, {})[str(dtype).split(".")[-1]] = (err,
                                                                    tol)
            outs[name] = out
        for paged, dense in (("decode_attention_paged",
                              "decode_attention_lengthaware"),
                             ("decode_attention_paged_q8",
                              "decode_attention_q8_lengthaware")):
            if not torch.equal(outs[paged], outs[dense]):
                fail(f"{paged} differs from {dense} on the gathered rings "
                     f"at hymba's shapes ({dtype})")
        print(f"[hymba decode] {dtype}: K1 == K3 and K4 == K5 bitwise on "
              f"the wrapped rings through the shuffled table")
    return errs


def _requests(cfg, n, plen_lo, plen_hi, gen, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    plens = rng.integers(plen_lo, plen_hi + 1, n)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(p)
                                               ).astype(np.int32),
                    max_new_tokens=gen) for i, p in enumerate(plens)]


def phase_smoke_e2e(dev, kv_quant=None, arch="qwen2.5-1.5b"):
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32", kv_quant=kv_quant)
    tag = (f"[smoke e2e{' ' + arch if cfg.has_ssm else ''}"
           f"{' int8' if kv_quant else ''}]")
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED), cpu)
    on_card = copy.deepcopy(params).to(dev)
    streams, counts = {}, {}
    runs = [("cpu", False, 0.0), ("cuda", False, 0.0), ("cuda", True, 0.0),
            ("cpu", False, 0.8), ("cuda", False, 0.8), ("cuda", True, 0.8),
            ("cpu", True, 0.0)]
    for where, paged, temperature in runs:
        eng = ServeEngine(cfg, params if where == "cpu" else on_card,
                          n_lanes=4, max_len=128, temperature=temperature,
                          rng_seed=SEED + 3, paged=paged, page_size=16,
                          n_pages=24, device=where)
        reqs = _requests(cfg, 10, 3, 140, 16, SEED + 1)
        checked = {}
        if where == "cuda":
            check_replay_midway(
                eng, f"{tag} paged={paged} t={temperature}", checked)
        reset_launch_counts()
        eng.run(reqs)
        counts[where, paged, temperature] = launch_counts()
        if where == "cuda":
            g = graph_summary(eng, f"{tag} paged={paged} t={temperature}",
                              checked.get("check"))
            streamed = (f", {stream_gate(eng, tag, reqs)} prompt-stream "
                        f"replays" if cfg.has_ssm else "")
            print(f"{tag} paged={paged} t={temperature}: "
                  f"{g['replays']} replays, decode_compiles "
                  f"{g['decode_compiles']}{streamed}")
        k10 = counts[where, paged, temperature]["ssd_chunk"]
        if cfg.has_ssm and where == "cuda" and \
                k10 != cfg.n_layers * len(reqs):
            fail(f"{tag} K10 launched {k10} times, not {cfg.n_layers} per "
                 f"prompt ({where}, paged={paged}, t={temperature})")
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
    return counts["cuda", False, 0.0], counts["cuda", True, 0.0]


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
    checked = {}
    check_replay_midway(eng, tag, checked)
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
    graphs = graph_summary(eng, tag, checked.get("check"))
    pre = eng.timings["prefill"]
    dec = eng.timings["decode"]
    print(f"[{tag}] {len(reqs)} requests, {n_gen} tokens in {wall:.3f}s "
          f"= {n_gen / wall:.1f} tok/s end to end; stats {eng.stats}")
    print_graphs(tag, graphs)
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
               "decode_steps": eng.stats["decode_steps"], "graphs": graphs}
    del eng                     # the check's wrapper holds a cycle to it
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def phase_full_paged(dev, cfg, params):
    counts, summary = serve_full(dev, cfg, params, "full e2e paged",
                                 ("decode_attention_paged",
                                  "flash_attention_mma"),
                                 paged=True, page_size=16, n_pages=256)
    per_step = counts["decode_attention_paged"] / summary["decode_steps"]
    print(f"[full e2e paged] K1 launches per decode step: {per_step}")
    if per_step != cfg.n_layers:
        fail(f"K1 launched {per_step} times per decode step, not "
             f"{cfg.n_layers}")
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
    need = ("decode_attention_lengthaware", "flash_attention_mma")
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
                                     (kernel, "flash_attention_mma"), **kw)
        per_step = counts[kernel] / summary["decode_steps"]
        print(f"[{tag}] {kernel} launches per decode step: {per_step}")
        if per_step != cfg.n_layers:
            fail(f"{kernel} launched {per_step} times per decode step, not "
                 f"{cfg.n_layers}")
        if counts[fp_kernel] or counts["decode_attention_q8_masked"]:
            fail(f"{tag}: another decode kernel ran: {counts}")
        out[tag] = (counts, summary)
    return out


def _k2_row(q, k, v, bytes_per_elem):
    """K2's timing row at one causal shape: the kernel (through the
    wrapper, which picks the kernel by dtype and head dim), its plain
    version, and SDPA on the same inputs."""
    from torch.nn import functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    sq = q.shape[2]
    pairs = sq * (sq + 1) // 2
    return dict(
        ms=time_ms_queued(lambda: flash_attention(q, k, v, causal=True)),
        host_ms=host_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms_queued(lambda: attention_ref(q, k, v, causal=True)),
        library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        bytes=bytes_per_elem * (2 * q.numel() + k.numel() + v.numel()),
        flops=4 * q.shape[0] * q.shape[1] * pairs * q.shape[3])


def phase_timings(dev):
    """Every attention kernel at the serves' shapes as device time per
    call (``time_ms_queued``), beside its plain version, SDPA where one
    call computes the same function, K1's pages gathered and then SDPA,
    and the dequantize route of the int8 kernels."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages)
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
    # the closest library yardstick: no single call reads a block table,
    # so gather the live lanes' pages, then SDPA with the length mask
    alive = lens >= 1
    mask = (torch.arange(t * ps, device=dev)[None, :] < lens[:, None])[alive]
    mask = mask[:, None, None, :].contiguous()
    ql = q[alive][:, :, None].contiguous()

    def gather_sdpa():
        return F.scaled_dot_product_attention(
            ql, gather_pages(kp, bt)[alive], gather_pages(vp, bt)[alive],
            attn_mask=mask, enable_gqa=True)
    rows["decode_attention_paged"] = dict(
        ms=time_ms_queued(lambda: decode_attention_paged(q, kp, vp, bt,
                                                         lens)),
        host_ms=host_ms(lambda: decode_attention_paged(q, kp, vp, bt, lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_ref(
            q, kp, vp, bt, lens)),
        library_ms=None, gather_sdpa_ms=time_ms_queued(gather_sdpa),
        bytes=k1_bytes, flops=k1_flops)
    # K2: B=1, H 12, Hkv 2, D 128, causal; bf16 (the serves' dtype: the
    # tensor-core kernel) at Sq 512 and the serve's largest bucket, 1024;
    # float32 (the CUDA-core kernel) at Sq 512 beside f32 SDPA, and bf16
    # at phi-3-vision's D 96 (the CUDA-core kernel too) beside bf16 SDPA
    q, k, v = k2_inputs(512, torch.bfloat16, dev)
    rows["flash_attention_mma"] = _k2_row(q, k, v, 2)
    q, k, v = k2_inputs(1024, torch.bfloat16, dev)
    rows["flash_attention_mma"]["s1024"] = _k2_row(q, k, v, 2)
    q, k, v = k2_inputs(512, torch.float32, dev)
    rows["flash_attention_cc"] = _k2_row(q, k, v, 4)
    q, k, v = k2_inputs(512, torch.bfloat16, dev, d=96)
    rows["flash_attention_cc"]["d96"] = _k2_row(q, k, v, 2)
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
    sdpa_ms = time_ms_queued(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, enable_gqa=True))
    for name, la, n_pos in (("decode_attention_lengthaware", True, n_live),
                            ("decode_attention_masked", False, b * s)):
        rows[name] = dict(
            ms=time_ms_queued(lambda: decode_attention(q, k, v, lens,
                                                       length_aware=la)),
            host_ms=host_ms(lambda: decode_attention(q, k, v, lens,
                                                     length_aware=la)),
            plain_ms=time_ms_queued(lambda: decode_attention_ref(q, k, v,
                                                                 lens)),
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
    route_ms = time_ms_queued(lambda: _route_dense(q, kq, ks, vq, vs, lens,
                                                   1))
    for name, la, n_pos in (("decode_attention_q8_lengthaware", True,
                             n_live),
                            ("decode_attention_q8_masked", False, b * s)):
        rows[name] = dict(
            ms=time_ms_queued(lambda: decode_attention_q8(
                q, kq, ks, vq, vs, lens, qblock=1, length_aware=la)),
            host_ms=host_ms(lambda: decode_attention_q8(
                q, kq, ks, vq, vs, lens, qblock=1, length_aware=la)),
            plain_ms=time_ms_queued(lambda: decode_attention_q8_ref(
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
        ms=time_ms_queued(lambda: decode_attention_paged_q8(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        host_ms=host_ms(lambda: decode_attention_paged_q8(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_q8_ref(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_paged(q, kq, ks, vq, vs, bt,
                                                     lens, 1)),
        bytes=(n_live * row_bytes + 2 * q.numel() * 2 + 4 * pages_live
               + 4 * lens.numel()),
        flops=4 * n_live * h * d + 2 * n_live * hkv * d)
    for name, r in rows.items():
        for tag, rr in (("", r), (" Sq 1024", r.get("s1024")),
                        (" bf16 D 96", r.get("d96"))):
            if rr is None:
                continue
            # f32 products: the TF32 rule, as for K7 and K10
            peak = TF32_FLOPS_PER_S if name.endswith("_cc") else \
                BF16_FLOPS_PER_S
            t_bytes = 1e3 * rr["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e3 * rr["flops"] / peak
            rr["bound_ms"] = max(t_bytes, t_ops)
            rr["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            lib = rr["library_ms"]
            route = (f", dequantize + fp kernel {rr['route_ms']:.4f} ms"
                     if "route_ms" in rr else "")
            if "gather_sdpa_ms" in rr:
                route += (f", gather pages + SDPA "
                          f"{rr['gather_sdpa_ms']:.4f} ms")
            print(f"[time] {name}{tag}: kernel {rr['ms']:.4f} ms (host "
                  f"{rr['host_ms']:.4f} ms a call), plain "
                  f"{rr['plain_ms']:.4f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}{route}, "
                  f"bound {rr['bound_ms']:.5f} ms ({rr['bound_by']}: "
                  f"{rr['bytes']} B, {rr['flops']} flop)")
    return rows


# ----------------------------------------------------------------------
# the paper's compute path: K8 (mixbench), K9 (fma_matmul), K7 (qmatmul)
# ----------------------------------------------------------------------

#: further published H100 SXM peaks (NVIDIA data sheet) for the bounds:
#: FP32 outside the tensor cores (an unfused multiply and add issue two
#: instructions per multiply-accumulate: half of it), TF32 and int8
#: tensor cores
FP32_FLOPS_PER_S = 66.9e12
TF32_FLOPS_PER_S = 495e12
INT8_OPS_PER_S = 1979e12
SWEEP_N = 1 << 26                     # 256 MB of float32, beyond the L2
SWEEP_ITERS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
SWEEP_CHECK_ITERS = (1, 64, 1024)     # 64: the timing row's count
MLP_SHAPES = ((128, 1536, 8960), (128, 8960, 1536))   # qwen2.5-1.5b
#: the reference's choice for f32 activations at the MLP shape
#: (tests/test_torch_compute_path.py holds the port's policy to it)
POLICY_VARIANT = {"cmp-170hx": "mul_add", "cmp-170hx-nofma": "mul_add",
                  "a100-40g": "mxu", "tpu-v5e": "mxu"}
QFMTS = ("q8_0", "q6_k", "q4_k", "q2_k")
#: K9 against one f32 matmul, relative max error: mul_add sums exact f32
#: products in f32 (bf16 inputs are exact in f32); mxu runs TF32 on f32
#: inputs by design, and exact bf16 products into f32 accumulators
K9_TOL = {("mxu", "float32"): 2e-3, ("mxu", "bfloat16"): 1e-4,
          ("mul_add", "float32"): 1e-5, ("mul_add", "bfloat16"): 1e-5}


def rel_err(a, b) -> float:
    return max_err(a, b) / (float(b.float().abs().max().item()) + 1e-9)


def mlp_weights(k, n, dev):
    """A qwen2.5-1.5b-shaped MLP weight (k, n) from the seed, on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + k)
    return torch.randn(k, n, device=dev, generator=g)


def activations(m, k, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 7 * m + k)
    return torch.randn(m, k, device=dev, generator=g)


def phase_k8_check(dev):
    """K8 against its plain version by the rule of
    ``repro_torch.kernels.mixbench.check``: f32 mul_add and both bf16
    arms bit for bit, f32 fma <= 1e-6; on whole vectors in one pass and
    in several, a scalar tail, and an unaligned view (all scalar, in
    several passes)."""
    import torch
    from repro_torch.kernels.mixbench.check import (card_cases,
                                                   check_on_card, tolerance)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (what, x, block), variant, iters in itertools.product(
                card_cases(dtype, dev), ("fma", "mul_add"), (1, 16, 128)):
            r = check_on_card(x, iters, variant, block)
            rule = f"tol {r['tol']}" if r["tol"] else "must be bitwise"
            print(f"[K8] {variant} {dtype} {what} n={x.numel()} "
                  f"iters={iters}: max_abs_err {r['max_abs_err']:.3e} "
                  f"({rule}), bitwise {r['bitwise']}")
            if not r["ok"]:
                fail(f"K8 {variant} {dtype} {what} iters={iters}: {r}")
            worst[variant, dtype] = max(worst.get((variant, dtype), 0.0),
                                        r["max_abs_err"])
    return {f"mixbench_{v}": dict(
        max_abs_err=worst[v, torch.bfloat16],
        tol=tolerance(torch.bfloat16, v),
        max_abs_err_f32=worst[v, torch.float32],
        tol_f32=tolerance(torch.float32, v)) for v in ("fma", "mul_add")}


#: shapes of K9's check beyond the MLP ones: the reference bench's, one
#: decode row, and a ragged one the contract lets through (blocks
#: given), all on the weight stream; then rows that are not whole
#: 16-byte chunks (N = 130 in f32, not a multiple of 8 in bf16 either),
#: which go to each arm's staged kernel
K9_SHAPES = (((128, 1024, 512), {}), ((1, 1536, 8960), {}),
             ((100, 1000, 520), dict(bk=8, bn=8)))
K9_STAGED_SHAPE = ((128, 1536, 130), dict(bn=2))
#: (variant, staged) -> the counter of the kernel K9 must launch
K9_KERNEL = {("mxu", False): "fma_matmul_mxu",
             ("mxu", True): "fma_matmul_mxu_wmma",
             ("mul_add", False): "fma_matmul_mul_add",
             ("mul_add", True): "fma_matmul_mul_add_staged"}


def phase_k9_check(dev):
    """K9 against one f32 matmul (TF32 off) at the relative max errors
    of K9_TOL, f32 and bf16, both variants at the reference bench's
    shape, the MLP shapes, one decode row, a ragged shape and a shape
    whose rows are not whole 16-byte chunks; each call run twice and
    required to give the same bits (the split-K pieces are added in a
    fixed order), with the launch counters showing each arm's weight
    stream at the first five shapes and its staged kernel at the
    last."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.fma_matmul import matmul_ref, matmul_variant
    errs = {}
    shapes = [(s, {}) for s in ((128, 1024, 512),) + MLP_SHAPES]
    shapes += [sk for sk in K9_SHAPES if sk[0] != (128, 1024, 512)]
    shapes.append(K9_STAGED_SHAPE)
    for (m, k, n), blocks in shapes:
        x, w = activations(m, k, dev), mlp_weights(k, n, dev)
        for dtype, variant in itertools.product(("float32", "bfloat16"),
                                                ("mxu", "mul_add")):
            xd, wd = x.to(getattr(torch, dtype)), w.to(getattr(torch, dtype))
            ref = matmul_ref(xd, wd)
            before = launch_counts()
            out = matmul_variant(xd, wd, variant=variant, **blocks)
            again = matmul_variant(xd, wd, variant=variant, **blocks)
            torch.cuda.synchronize()
            ran = sorted(kk for kk, v in launch_counts().items()
                         if v != before[kk])
            rel = rel_err(out, ref)
            same = bool(torch.equal(out, again))
            tol = K9_TOL[variant, dtype]
            want = [K9_KERNEL[variant, (m, k, n) == K9_STAGED_SHAPE[0]]]
            print(f"[K9] {variant} {dtype} ({m},{k},{n}): rel max err "
                  f"{rel:.3e} (tol {tol}), repeat bitwise {same}, "
                  f"launched {ran}")
            if not rel <= tol:
                fail(f"K9 {variant} {dtype} ({m},{k},{n}): {rel}")
            if not same:
                fail(f"K9 {variant} {dtype} ({m},{k},{n}): two runs "
                     "differ")
            if ran != want:
                fail(f"K9 {variant} {dtype} ({m},{k},{n}) launched "
                     f"{ran}, want {want}")
            errs[want[0], dtype] = max(errs.get((want[0], dtype),
                                                (0.0, 0.0)),
                                       (max_err(out, ref), rel))
    return {name: dict(
        max_abs_err=errs[name, "float32"][0],
        max_rel_err=errs[name, "float32"][1], tol=K9_TOL[v, "float32"],
        max_rel_err_bf16=errs[name, "bfloat16"][1],
        tol_bf16=K9_TOL[v, "bfloat16"])
        for (v, _), name in K9_KERNEL.items()}


#: K7's check shapes (K, N, bk) beyond the MLP ones: rows of 100
#: columns are not whole 16-byte chunks (the _plain kernels); and its rows
#: M (16-row tiles up to 16, 128-row tiles beyond, two bands at 256)
K7_ODD_SHAPE = (512, 100, 512)
K7_ROWS = (1, 8, 24, 128, 256)


def phase_k7_check(dev):
    """K7: the MLP weights quantized on the card in all four formats, and
    a (512, 100) weight; dequant_dot (every format) and dot_i8 (q8_0) at
    M 1, 8, 24, 128 and 256 with float32 and bfloat16 activations,
    against their plain versions, relative max error <= 1e-5; every call
    run twice and required to give the same bits (the split-K pieces are
    added in run order), the launch counters showing the variant's
    kernel."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.qmatmul import (qmatmul_i8_ref, qmatmul_ref,
                                             qmatmul_variant)
    from repro_torch.quant import quantize
    errs = {}
    shapes = [(k, n, 512 if k % 512 == 0 else 256)     # the contract: bk | k
              for _, k, n in MLP_SHAPES] + [K7_ODD_SHAPE]
    for k, n, bk in shapes:
        w = mlp_weights(k, n, dev)
        for fmt in QFMTS:
            qt = quantize(w, fmt)
            runs = [("dequant_dot", qmatmul_ref)]
            if fmt == "q8_0":
                runs.append(("dot_i8", qmatmul_i8_ref))
            for m, dtype, (variant, plain) in itertools.product(
                    K7_ROWS, ("float32", "bfloat16"), runs):
                x = activations(m, k, dev).to(getattr(torch, dtype))
                before = launch_counts()
                out = qmatmul_variant(x, qt, variant=variant, bk=bk)
                again = qmatmul_variant(x, qt, variant=variant, bk=bk)
                ref = plain(x, qt)
                torch.cuda.synchronize()
                ran = {kk: v - before[kk] for kk, v in launch_counts().items()
                       if v != before[kk]}
                rel = rel_err(out, ref)
                same = bool(torch.equal(out, again))
                print(f"[K7] {variant} {fmt} x {dtype} ({m},{k},{n}): rel "
                      f"max err {rel:.3e} (tol 1e-05), repeat bitwise "
                      f"{same}, launched {ran}")
                if not rel <= 1e-5:
                    fail(f"K7 {variant} {fmt} x {dtype} ({m},{k},{n}): "
                         f"{rel}")
                if not same:
                    fail(f"K7 {variant} {fmt} x {dtype} ({m},{k},{n}): two "
                         "runs differ")
                if ran != {f"qmatmul_{variant}": 2}:
                    fail(f"K7 {variant} {fmt} ({m},{k},{n}) launched {ran}")
                errs[variant, dtype] = max(errs.get((variant, dtype),
                                                    (0.0, 0.0)),
                                           (max_err(out, ref), rel))
        del w
    return {f"qmatmul_{v}": dict(
        max_abs_err=errs[v, "float32"][0], max_rel_err=errs[v, "float32"][1],
        tol=1e-5, max_rel_err_bf16=errs[v, "bfloat16"][1], tol_bf16=1e-5)
        for v in ("dequant_dot", "dot_i8")}


def phase_sass():
    from repro_torch.kernels._sass import sass_report
    try:
        found, problems = sass_report()
    except FileNotFoundError as e:
        fail(str(e))
    print(f"[sass] {json.dumps(found, sort_keys=True)}")
    if problems:
        fail("SASS: " + "; ".join(problems))
    return found


def sweep(dev, reps: int = 10):
    """The measured form of the reference's ``sweep_points``: mixbench
    over SWEEP_N float32 elements, both arms in turn at each count of
    steps, timed with CUDA events (median of ``reps`` after two
    warm-ups).  The first warm-up's output at each of SWEEP_CHECK_ITERS
    is held to the plain version on the same x by the rule of phase 11
    (every thread runs many grid-stride passes here).  Then each arm's
    top point runs for about a second while ``nvidia-smi`` reads the SM
    clock and the power under that load."""
    import torch
    from repro_torch.kernels.mixbench import mixbench, mixbench_ref
    from repro_torch.kernels.mixbench.check import compare
    x = torch.rand(SWEEP_N, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    points, load, checks = {}, {}, {}
    for iters in SWEEP_ITERS:
        for variant in ("fma", "mul_add"):
            y = mixbench(x, iters=iters, variant=variant)
            if iters in SWEEP_CHECK_ITERS:
                r = compare(y, mixbench_ref(x, iters, variant), variant)
                print(f"[sweep] output of {variant} at {iters} steps, n = "
                      f"2^26: max_abs_err {r['max_abs_err']:.3e}, bitwise "
                      f"{r['bitwise']} (tol {r['tol']})")
                if not r["ok"]:
                    fail(f"K8 sweep {variant} iters={iters}: {r}")
                checks[f"{variant}/{iters}"] = r["max_abs_err"]
            del y
            ms = time_ms(lambda: mixbench(x, iters=iters, variant=variant),
                         warmup=1, iters=reps)
            flops = 2.0 * iters * SWEEP_N
            points[variant, iters] = dict(
                ms=ms, gflops=flops / ms / 1e6,
                gbps=8.0 * SWEEP_N / ms / 1e6)      # 4 B read + 4 B written
    top = SWEEP_ITERS[-1]
    for variant in ("fma", "mul_add"):
        n_runs = int(1000 / points[variant, top]["ms"]) + 1
        for _ in range(n_runs):
            mixbench(x, iters=top, variant=variant)
        time.sleep(0.5)
        load[variant] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        torch.cuda.synchronize()
    return points, load, checks


def phase_compute_main(dev):
    """The compute path through its entry points, with the launch counts
    zeroed just before and read just after: the K8 sweep, ``matmul(x, w,
    policy=PathPolicy(p))`` for the four profiles and ``qmatmul(x, qt,
    profile=CMP_170HX)`` for the four formats, at the MLP width."""
    import torch
    from repro_torch.core import PROFILES, PathPolicy
    from repro_torch.core.device_profile import CMP_170HX
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fma_matmul import matmul, matmul_ref
    from repro_torch.kernels.mixbench import sweep_points
    from repro_torch.kernels.qmatmul import (qmatmul, qmatmul_i8_ref,
                                             qmatmul_ref)
    from repro_torch.core.device_profile import Path as CPath
    from repro_torch.quant import quantize
    m, k, n = MLP_SHAPES[0]
    x, w = activations(m, k, dev), mlp_weights(k, n, dev)
    qts = {fmt: quantize(w, fmt) for fmt in QFMTS}
    ref = matmul_ref(x, w)
    torch.cuda.synchronize()
    reset_launch_counts()
    points, load, checks = sweep(dev)
    for name in sorted(PROFILES):
        before = launch_counts()
        out = matmul(x, w, policy=PathPolicy(PROFILES[name]))
        torch.cuda.synchronize()
        ran = [kk for kk, v in launch_counts().items() if v != before[kk]]
        want = f"fma_matmul_{POLICY_VARIANT[name]}"
        tol = {"fma_matmul_mxu": 2e-3, "fma_matmul_mul_add": 1e-5}[want]
        rel = rel_err(out, ref)
        print(f"[policy] matmul on {name}: launched {ran} (reference: "
              f"{want}), rel max err {rel:.3e}")
        if ran != [want] or not rel <= tol:
            fail(f"matmul(policy={name}) launched {ran}, want {want}")
    for fmt, qt in qts.items():
        before = launch_counts()
        out = qmatmul(x, qt, profile=CMP_170HX)
        torch.cuda.synchronize()
        ran = [kk for kk, v in launch_counts().items() if v != before[kk]]
        want = "qmatmul_dot_i8" if fmt == "q8_0" else "qmatmul_dequant_dot"
        plain = qmatmul_i8_ref if fmt == "q8_0" else qmatmul_ref
        rel = rel_err(out, plain(x, qt))
        print(f"[policy] qmatmul {fmt} on cmp-170hx: launched {ran}, rel "
              f"max err {rel:.3e}")
        if ran != [want] or not rel <= 1e-5:
            fail(f"qmatmul({fmt}, cmp-170hx) launched {ran}, want {want}")
    counts = launch_counts()
    print(f"[compute path] launches: {counts}")
    compute = ("mixbench_fma", "mixbench_mul_add", "fma_matmul_mxu",
               "fma_matmul_mul_add", "qmatmul_dequant_dot", "qmatmul_dot_i8")
    if min(counts[kk] for kk in compute) <= 0:
        fail(f"a kernel of the compute path never launched: {counts}")

    print("[sweep] iters  fma GFLOP/s  fma GB/s  mul_add GFLOP/s  "
          "mul_add GB/s   (f32, n = 2^26, GB/s counts read + write)")
    for iters in SWEEP_ITERS:
        f, u = points["fma", iters], points["mul_add", iters]
        print(f"[sweep] {iters:5d}  {f['gflops']:11.1f}  {f['gbps']:8.1f}  "
              f"{u['gflops']:15.1f}  {u['gbps']:12.1f}")
    peak = {v: max(points[v, i]["gflops"] for i in SWEEP_ITERS) / 1e3
            for v in ("fma", "mul_add")}
    stream = max(points[v, 1]["gbps"] for v in ("fma", "mul_add")) / 1e3
    cmp = {v: max(p["gflops"] for p in sweep_points(
        CMP_170HX, "f32", CPath(v))) / 1e3 for v in ("fma", "mul_add")}
    summary = {"output_max_abs_err": checks,
               "under_load_clock_power": load,
               "peak_fma_tflops": peak["fma"],
               "peak_mul_add_tflops": peak["mul_add"],
               "fused_over_unfused": peak["fma"] / peak["mul_add"],
               "stream_tbps_iters1": stream,
               "stream_share_of_3.35": stream * 1e12 / HBM_BYTES_PER_S,
               "cmp_170hx_modeled_unfused_over_fused":
                   cmp["mul_add"] / cmp["fma"]}
    print(f"[sweep] peak f32: fma {peak['fma']:.2f} TFLOP/s, mul_add "
          f"{peak['mul_add']:.2f} TFLOP/s; fused/unfused "
          f"{summary['fused_over_unfused']:.3f} (CMP 170HX, modeled from "
          f"the paper: unfused/fused "
          f"{summary['cmp_170hx_modeled_unfused_over_fused']:.1f}); "
          f"iters=1 stream {stream:.3f} TB/s = "
          f"{100 * summary['stream_share_of_3.35']:.1f}% of 3.35; SM "
          f"clock, power at {SWEEP_ITERS[-1]} steps: {load}")
    print(f"[sweep] {json.dumps({'points': {f'{v}/{i}': p for (v, i), p in points.items()}, **summary})}")
    return counts, summary


def with_bound(r):
    """r with its bound: bytes over 3.35 TB/s against operations over
    the peak of the variant's path, whichever is longer."""
    t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
    t_ops = 1e3 * r["flops"] / r["peak"]
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return r


def k9_row(x, w, variant, peak, **blocks):
    """K9's timing row on (x, w): the kernel, the plain version and
    torch.matmul, each as device time per call; beside mxu torch.matmul
    on x and w with TF32 on, beside mul_add one float32 product with
    TF32 off (on float32 copies of bf16 inputs: the function the arm
    computes).  Bytes count x and w read once and the f32 output
    written once."""
    import torch
    from repro_torch.kernels.fma_matmul import matmul_ref, matmul_variant
    m, k = x.shape
    n = w.shape[1]
    torch.backends.cuda.matmul.allow_tf32 = variant == "mxu"
    xl, wl = (x, w) if variant == "mxu" else (x.float(), w.float())
    lib_ms = time_ms_queued(lambda: torch.matmul(xl, wl))
    torch.backends.cuda.matmul.allow_tf32 = False
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[x.dtype]
    return dict(
        ms=time_ms_queued(lambda: matmul_variant(x, w, variant=variant,
                                                 **blocks)),
        plain_ms=time_ms_queued(lambda: matmul_ref(x, w)),
        library_ms=lib_ms,
        bytes=x.element_size() * (m * k + k * n) + 4 * m * n,
        flops=2 * m * k * n, peak=peak, shape=f"{name} ({m},{k},{n})")


def phase_compute_timings(dev):
    """Each compute-path kernel and variant at full width: kernel ms,
    plain ms, library (or route) ms, and the bound: bytes over 3.35 TB/s
    against operations over the peak of the path the variant names."""
    import torch
    from repro_torch.kernels.fma_matmul import matmul_variant
    from repro_torch.kernels.mixbench import mixbench, mixbench_ref
    from repro_torch.kernels.qmatmul import (qmatmul_i8_ref, qmatmul_ref,
                                             qmatmul_variant)
    from repro_torch.quant import dequantize, quantize
    rows = {}
    # K8: f32, n = 2^26, the reference wrapper's default 64 steps (the
    # sweep held this output, on the same x, to the plain version)
    x = torch.rand(SWEEP_N, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    for variant, peak in (("fma", FP32_FLOPS_PER_S),
                          ("mul_add", FP32_FLOPS_PER_S / 2)):
        rows[f"mixbench_{variant}"] = dict(
            ms=time_ms(lambda: mixbench(x, iters=64, variant=variant)),
            plain_ms=time_ms(lambda: mixbench_ref(x, 64, variant),
                             warmup=1, iters=5),
            library_ms=None, bytes=8 * SWEEP_N, flops=2 * 64 * SWEEP_N,
            peak=peak, shape="f32 n=2^26 iters=64")
    del x
    # K9, as device time per launch (time_ms_queued: through ctypes the
    # host takes ~0.04 ms to launch a call, longer than the mxu kernel
    # runs): each arm at both MLP shapes in f32 and bf16, the first f32
    # shape its row; each arm's staged kernel on rows that are not
    # whole 16-byte chunks (N - 2 columns)
    m, k, n = MLP_SHAPES[0]
    a, w = activations(m, k, dev), mlp_weights(k, n, dev)
    k9_peak = {("mxu", torch.float32): TF32_FLOPS_PER_S,
               ("mxu", torch.bfloat16): BF16_FLOPS_PER_S,
               ("mul_add", torch.float32): FP32_FLOPS_PER_S / 2,
               ("mul_add", torch.bfloat16): FP32_FLOPS_PER_S / 2}
    k9_shapes = {}
    for variant in ("mxu", "mul_add"):
        by_shape = k9_shapes[variant] = {}
        for (mm, kk, nn), dtype in itertools.product(
                MLP_SHAPES, (torch.float32, torch.bfloat16)):
            r = k9_row(activations(mm, kk, dev).to(dtype),
                       mlp_weights(kk, nn, dev).to(dtype), variant,
                       k9_peak[variant, dtype])
            by_shape[r["shape"]] = with_bound(r)
        name = f"fma_matmul_{variant}"
        rows[name] = dict(by_shape[f"f32 ({m},{k},{n})"])
        rows[name]["single_call_ms"] = time_ms(
            lambda: matmul_variant(a, w, variant=variant))
        rows[name]["by_shape"] = by_shape
    w2 = mlp_weights(k, n - 2, dev)
    rows["fma_matmul_mxu_wmma"] = k9_row(a, w2, "mxu", TF32_FLOPS_PER_S,
                                         bn=2)
    rows["fma_matmul_mul_add_staged"] = k9_row(
        a, w2, "mul_add", FP32_FLOPS_PER_S / 2, bn=2)
    del w2
    # K7, as device time per call: dequant_dot q4_k (the paper's Q4_K_M)
    # and dot_i8 q8_0 at both MLP shapes, M 128 and 8, f32 and bf16 x,
    # the first f32 shape each variant's row; there every format's
    # dequant_dot too.  No single PyTorch call computes a block-quantized
    # product, so the route (dequantize, then torch.matmul with TF32 off)
    # stands beside each as route_ms.  Bound: f32 products at the TF32
    # rule (as K10's), one bf16 pass at the bf16 rate, int8 at the int8
    # rate.
    k7_shapes = {}
    k7_peak = {("dequant_dot", torch.float32): TF32_FLOPS_PER_S,
               ("dequant_dot", torch.bfloat16): BF16_FLOPS_PER_S,
               ("dot_i8", torch.float32): INT8_OPS_PER_S,
               ("dot_i8", torch.bfloat16): INT8_OPS_PER_S}
    per_fmt = {}
    for (_, kk, nn), mm in itertools.product(MLP_SHAPES, (128, 8)):
        wq = mlp_weights(kk, nn, dev)
        bk = 512 if kk % 512 == 0 else 256     # the contract: bk | k
        qts = {fmt: quantize(wq, fmt) for fmt in QFMTS}
        for dtype in (torch.float32, torch.bfloat16):
            xq = activations(mm, kk, dev).to(dtype)
            tag = (f"{'f32' if dtype == torch.float32 else 'bf16'} "
                   f"({mm},{kk},{nn})")
            main = tag == f"f32 ({m},{k},{n})"
            for variant, fmt, plain in (
                    ("dequant_dot", "q4_k", qmatmul_ref),
                    ("dot_i8", "q8_0", qmatmul_i8_ref)):
                qt = qts[fmt]
                r = dict(
                    ms=time_ms_queued(lambda: qmatmul_variant(
                        xq, qt, variant=variant, bk=bk)),
                    plain_ms=time_ms_queued(lambda: plain(xq, qt)),
                    library_ms=None,
                    route_ms=time_ms_queued(lambda: xq.float() @
                                            dequantize(qt)),
                    bytes=xq.element_size() * mm * kk + 4 * mm * nn
                    + qt.nbytes(),
                    flops=2 * mm * kk * nn, peak=k7_peak[variant, dtype],
                    shape=f"{tag} {fmt}")
                k7_shapes.setdefault(variant, {})[tag] = with_bound(r)
            if main:
                for fmt in QFMTS:
                    per_fmt[fmt] = time_ms_queued(lambda: qmatmul_variant(
                        xq, qts[fmt], variant="dequant_dot", bk=bk))
        del wq, qts
    for variant, by_shape in k7_shapes.items():
        rows[f"qmatmul_{variant}"] = dict(by_shape[f"f32 ({m},{k},{n})"])
        rows[f"qmatmul_{variant}"]["by_shape"] = by_shape
    rows["qmatmul_dequant_dot"]["ms_by_format"] = per_fmt
    for name, r in rows.items():
        with_bound(r)
        lib = r["library_ms"]
        route = (f", dequantize + torch.matmul {r['route_ms']:.4f} ms"
                 if "route_ms" in r else "")
        print(f"[time] {name} ({r['shape']}): kernel {r['ms']:.4f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s), plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}{route}, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} B, "
              f"{r['flops']} flop at {r['peak'] / 1e12:.2f} T/s)")
    for variant, by_shape in k9_shapes.items():
        for shape, r in by_shape.items():
            print(f"[time] fma_matmul_{variant} {shape}: kernel "
                  f"{r['ms']:.4f} ms = {r['bytes'] / r['ms'] / 1e9:.3f} "
                  f"TB/s, {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); torch.matmul "
                  f"{r['library_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms")
        print(f"[time] fma_matmul_{variant} f32 ({m},{k},{n}) one call at "
              "a time (host launch included): "
              f"{rows[f'fma_matmul_{variant}']['single_call_ms']:.4f} ms")
    for variant, by_shape in k7_shapes.items():
        for shape, r in by_shape.items():
            print(f"[time] qmatmul_{variant} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms = {r['bytes'] / r['ms'] / 1e9:.3f} TB/s,"
                  f" {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); route "
                  f"{r['route_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms")
    print("[time] qmatmul_dequant_dot f32 ({},{},{}) by format: {}".format(
        m, k, n, ", ".join(f"{f} {v:.4f} ms" for f, v in per_fmt.items())))
    return rows


# ----------------------------------------------------------------------
# the SSM family: K10 (the SSD chunk scan), mamba2 served and forward
# ----------------------------------------------------------------------

#: mamba2-780m's SSD widths: heads (d_inner / head_dim), head dim, state
#: width, chunk
SSD_H, SSD_P, SSD_N, SSD_Q = 48, 64, 128, 256
#: K10 against its plain version, relative max error (max |diff| / max
#: |plain|) on each output: the two cumsums add in other orders, and
#: exp carries the f32 rounding of segment sums up to ~100 into y
#: (measured <= 3.2e-6 on an H100 80GB HBM3 at 700 W)
K10_TOL = 1e-5
#: float32 forward (chunked dual form on K10) against streaming the same
#: tokens through the decode recurrence, max |diff| of the logits: the
#: two forms of one function sum in other orders through 48 layers;
#: measured 3.97e-5 against logits up to 3.9 on an H100 80GB HBM3 at
#: 700 W, so 2.5x headroom
SSM_FWD_TOL = 1e-4


#: SMOKE mamba2's SSD widths (d_inner 256 / head_dim 32): heads, head
#: dim, state width, chunk
SMOKE_SSD = (8, 32, 16, 32)
#: (H, P, N) whose rows are no whole 16-byte chunks in either dtype
ODD_SSD = (3, 30, 20)
#: hymba-1.5b's SSD widths (d_inner 3200 / head_dim 64): heads, head
#: dim, state width -- N 16, a quarter of the kernel's 64-row state tile
HYMBA_SSD = (50, 64, 16)


def k10_inputs(bsz, s, dtype, a_kind, dev, seed=SEED,
               widths=(SSD_H, SSD_P, SSD_N)):
    """x (B,S,H,P), dt = softplus(randn + dt_bias), A (H,), b/c (B,S,N)
    from the seed on the card, at ``widths`` (H, P, N), mamba2-780m's by
    default; x/b/c in ``dtype``."""
    import math
    import torch
    h, p, n = widths
    g = torch.Generator(device=dev).manual_seed(seed + 31 * s + bsz)
    x = torch.randn(bsz, s, h, p, device=dev, generator=g)
    dt_bias = math.log(math.expm1(0.01))
    dt = torch.logaddexp(torch.randn(bsz, s, h, device=dev, generator=g)
                         + dt_bias, torch.zeros((), device=dev))
    if a_kind == "model":
        a = -torch.linspace(1.0, 16.0, h, device=dev)
    else:
        a = -torch.exp(0.3 * torch.randn(h, device=dev, generator=g))
    b = torch.randn(bsz, s, n, device=dev, generator=g)
    c = torch.randn(bsz, s, n, device=dev, generator=g)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype)


def k10_cases():
    """(dtype name, S, B, A kind, chunk, widths) of K10's checks: the
    forward's and the serve's lengths at mamba2-780m's widths, each serve
    bucket as the one chunk of a prompt, SMOKE's widths, odd widths at a
    ragged chunk, the longest chunk (1024), and hymba-1.5b's widths at
    its serve's buckets 256, 1024 and 2048."""
    full = (SSD_H, SSD_P, SSD_N)
    cases = [(d, s, bsz, a_kind, SSD_Q, full) for d, s, bsz, a_kind in
             itertools.product(("float32", "bfloat16"), (64, 256, 1024, 2048),
                               (1, 2), ("model", "exp"))]
    cases += [(d, q, 1, "model", SSD_Q, full)
              for d in ("float32", "bfloat16") for q in (8, 16, 32, 128)]
    h, p, n, q = SMOKE_SSD
    cases += [(d, s, 2, a_kind, q, (h, p, n))
              for d in ("float32", "bfloat16") for s in (8, 32, 128)
              for a_kind in ("model", "exp")]
    # rows of no whole 16-byte chunk (the kernel's plain-copy staging) at
    # a ragged chunk, and the longest chunk
    cases += [(d, s, bsz, "model", q, widths)
              for d in ("float32", "bfloat16")
              for s, bsz, q, widths in ((100, 2, 50, ODD_SSD),
                                        (2048, 1, 1024, full))]
    cases += [(d, s, 1, "model", SSD_Q, HYMBA_SSD)
              for d in ("float32", "bfloat16") for s in (256, 1024, 2048)]
    return cases


def phase_k10(dev):
    import torch
    from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk, ssd_chunk_ref,
                                              ssd_chunked)
    worst = {}
    for dname, s, bsz, a_kind, chunk, widths in k10_cases():
        dtype = getattr(torch, dname)
        args = k10_inputs(bsz, s, dtype, a_kind, dev, widths=widths)
        out = ssd_chunk(*args, chunk=chunk)
        ref = ssd_chunk_ref(*args, chunk)
        torch.cuda.synchronize()
        rels = [rel_err(o, r) for o, r in zip(out, ref)]
        ok = all(bool(torch.isfinite(o).all()) for o in out)
        tag = (f"{dtype} S={s} B={bsz} A={a_kind} Q={min(chunk, s)} "
               f"(H, P, N)={widths}")
        print(f"[K10] {tag}: rel max err y {rels[0]:.3e} states "
              f"{rels[1]:.3e} decay {rels[2]:.3e} (tol {K10_TOL})")
        if not ok or not max(rels) <= K10_TOL:
            fail(f"K10 {tag}: {rels}")
        key = str(dtype).split(".")[-1]
        abs_err = max(max_err(o, r) for o, r in zip(out, ref))
        for k in (key, key + " hymba") if widths == HYMBA_SSD else (key,):
            prev = worst.get(k, (0.0, 0.0))
            worst[k] = (max(prev[0], abs_err), max(prev[1], max(rels)))
    args = k10_inputs(1, 2048, torch.float32, "model", dev)
    y = ssd(*args, chunk=SSD_Q)
    rel = rel_err(y, ssd_chunked(*args, chunk=SSD_Q))
    torch.cuda.synchronize()
    print(f"[K10] full SSD on K10 vs ssd_chunked, float32 S=2048: rel max "
          f"err {rel:.3e} (tol {K10_TOL})")
    if not rel <= K10_TOL:
        fail(f"ssd on K10 disagrees with ssd_chunked: {rel}")
    return dict(max_abs_err=worst["bfloat16"][0],
                max_rel_err=worst["bfloat16"][1], tol=K10_TOL,
                max_abs_err_f32=worst["float32"][0],
                max_rel_err_f32=worst["float32"][1], tol_f32=K10_TOL,
                max_rel_err_hymba=worst["bfloat16 hymba"][1],
                max_rel_err_hymba_f32=worst["float32 hymba"][1],
                ssd_rel_err=rel)


def init_mamba(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[mamba2] {cfg.name} bf16, {n_params / 1e9:.3f}B params "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def lane_kv(eng, lane, n):
    """Clones of the K/V in ring slots ``[0, n)`` of a lane (a hybrid's;
    empty for ssm): dense, of its row; paged, of its mapped pages in
    table order."""
    import torch
    if not eng.paged:
        return {k: eng.cache[k][:, lane, :, :n].clone() for k in eng.cache
                if k in ("k", "v", "k_scale", "v_scale")}
    if not eng.lane_pages(lane):
        return {}
    pages = torch.tensor(eng.lane_pages(lane), device=eng.device)
    out = {}
    for k in eng.cache:
        if k.endswith("_pages"):
            g = eng.cache[k][:, pages]            # (L, T', Hkv, ps, D)
            g = g.permute(0, 2, 1, 3, 4).flatten(2, 3)
            out[k] = g[:, :, :n].clone()
    return out


def check_stream(eng, tag, prompt, streamed):
    """Stream ``prompt`` into a free lane through the engine (replays of
    its captured batch-1 step) and eagerly (``model.decode_step`` on a
    fresh batch-1 cache, token by token, as the engine streamed before
    its step was captured): the logits at the last token, the state and
    a hybrid's K/V must be equal bit for bit.  A paged hybrid lane maps
    its pages first (and they are zeroed before the eager stream, which
    writes them through the same table row).  ``streamed`` is the list
    the engine's first-token logits are appended to.  Leaves the lane
    dead; returns host ms per token, synced, of each."""
    import numpy as np
    import torch
    lane = eng.free_lanes()[0]
    n = len(prompt)
    if eng.paged and eng._bt_width:
        need = eng._pages_needed(n + 1)
        if not eng.pool.reserve(need):
            fail(f"{tag}: no pages free for the stream check")
        eng._lane_reserved[lane] = need
        eng._map_pages(lane, need)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._stream_ssm_prompt(prompt, lane)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    take = min(n, eng.cache["k"].shape[3]) if "k" in eng.cache else n
    got = {k: eng.cache[k][:, lane].clone() for k in ("ssm_h", "ssm_conv")}
    got.update(lane_kv(eng, lane, take), logits=streamed[-1])
    state = {}
    for key, t in eng._ssm_lane.items():
        if key.endswith("_pages"):
            state[key] = t                          # the shared pools
        elif key == "block_tables":
            state[key] = eng.cache[key][lane:lane + 1].clone()
        else:
            state[key] = torch.zeros_like(t)
    if "block_tables" in state:
        pages = torch.tensor(eng.lane_pages(lane), device=eng.device)
        for key in state:
            if key.endswith("_pages"):
                state[key][:, pages] = 0
    toks = torch.from_numpy(prompt.astype(np.int32)).to(eng.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        logits, state = eng.model.decode_step(eng.params, state,
                                              toks[t:t + 1])
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    want = {k: state[k][:, 0] for k in ("ssm_h", "ssm_conv")}
    if eng.paged:
        want.update(lane_kv(eng, lane, take))
    else:
        want.update({k: state[k][:, 0, :, :take] for k in state
                     if k in ("k", "v", "k_scale", "v_scale")})
    want["logits"] = logits.float()
    differ = [k for k in sorted(want) if not torch.equal(got[k], want[k])]
    if differ or sorted(got) != sorted(want):
        fail(f"{tag}: the replayed prompt stream differs from the eager "
             f"one in {differ or sorted(set(got) ^ set(want))}")
    eng._release_lane(lane)
    per_tok = {"stream_ms_per_token_eager": 1e3 * t_eager / n,
               "stream_ms_per_token_graph": 1e3 * t_graph / n,
               "stream_check_tokens": n}
    print(f"[{tag}] {n} prompt tokens streamed into lane {lane}: replayed "
          f"step == eager decode_step bitwise ({', '.join(sorted(want))}); "
          f"host ms per token, synced: eager "
          f"{per_tok['stream_ms_per_token_eager']:.3f}, replayed "
          f"{per_tok['stream_ms_per_token_graph']:.3f}")
    return per_tok


def serve_streamed(dev, cfg, params, tag, reqs, gen, max_len, **engine_kw):
    """Serve ``reqs`` (``gen`` new tokens each, 4 lanes) through an engine
    whose prompts are streamed (ssm or hybrid), with the launch counts
    zeroed just before and read just after; K10 must launch once a layer
    a prompt, and for a hybrid K2's tensor-core kernel too, and K3
    (fixed-lane) or K1 (paged) once a layer a decode step beside once a
    layer a streamed prompt token (replay accounting).  Also holds, for
    each prompt, the prefill's logits at ``plen - 1`` (the chunked scan
    on K10) beside the streamed logits that give the first token (the
    recurrent path), and streams 64 prompt tokens by replays and
    eagerly (:func:`check_stream`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params, n_lanes=4, max_len=max_len, device=dev,
                      timed=True, **engine_kw)
    pairs = {"prefill": [], "stream": [], "prefill_s": []}
    prefill, first = eng.model.prefill, eng._set_first_token

    def keep_prefill(*a, **kw):           # K10's logits at plen - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kv = prefill(*a, **kw)
        torch.cuda.synchronize()
        pairs["prefill_s"].append(time.perf_counter() - t0)
        pairs["prefill"].append(logits.float().clone())
        return logits, kv

    def keep_stream(logits, lane):        # the streamed logits
        pairs["stream"].append(logits.float().clone())
        return first(logits, lane)

    eng.model.prefill, eng._set_first_token = keep_prefill, keep_stream
    checked = {}
    check_replay_midway(eng, tag, checked)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_gen = sum(len(r.generated) for r in reqs)
    if not all(r.done and len(r.generated) == gen for r in reqs):
        fail(f"{tag}: did not finish every request's budget")
    toks = np.concatenate([r.generated for r in reqs])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{tag}: generated token outside the vocabulary")
    per_prompt = {"ssd_chunk": cfg.n_layers}
    if not cfg.attn_free:
        per_prompt["flash_attention_mma"] = cfg.n_layers
    for name, per in per_prompt.items():
        if counts[name] != per * len(reqs):
            fail(f"{tag}: {name} launched {counts[name]} times, not {per} x "
                 f"{len(reqs)} prompts")
    plens = [len(r.prompt) for r in reqs]
    streamed = sum(min(p, max_len - 1) for p in plens)
    per_step = None
    if not cfg.attn_free:
        kernel = ("decode_attention_paged" if eng.paged else
                  "decode_attention_lengthaware")
        per_step = ((counts[kernel] - cfg.n_layers * streamed)
                    / eng.stats["decode_steps"])
        print(f"[{tag}] {kernel} launches {counts[kernel]} = {per_step} a "
              f"decode step x {eng.stats['decode_steps']} + "
              f"{cfg.n_layers} a streamed token x {streamed}")
        if per_step != cfg.n_layers:
            fail(f"{tag}: {kernel} launched {per_step} times a decode "
                 f"step, not {cfg.n_layers}")
    if eng.paged:
        eng.pool.check()
        if cfg.attn_free and (eng.pool.n_pages != 0 or
                              "block_tables" in eng.cache):
            fail(f"{tag}: an attention-free paged engine holds pages")
    stream = list(eng.timings["ssm_stream"])   # the serve's prompts
    graphs = graph_summary(eng, tag, checked.get("check"))
    graphs["stream_replays"] = stream_gate(eng, tag, reqs)
    graphs.update(check_stream(eng, tag, reqs[-1].prompt[:64],
                               pairs["stream"]))
    v = cfg.vocab_size
    diffs = [max_err(a[:, :v], b[:, :v])
             for a, b in zip(pairs["prefill"], pairs["stream"])]
    agree = sum(int(a[:, :v].argmax()) == int(b[:, :v].argmax())
                for a, b in zip(pairs["prefill"], pairs["stream"]))
    pre, dec = eng.timings["prefill"], eng.timings["decode"]
    print(f"[{tag}] {len(reqs)} requests (prompts {plens}), {n_gen} tokens "
          f"in {wall:.3f}s = {n_gen / wall:.1f} tok/s end to end; stats "
          f"{eng.stats}")
    for bucket in sorted(pre):
        print(f"[{tag}] prefill bucket {bucket}: {len(pre[bucket])} "
              f"prompts, median {1e3 * statistics.median(pre[bucket]):.2f} "
              f"ms (chunked scan + prompt streaming)")
    print(f"[{tag}] chunked prefill (K10's path) ms per prompt: "
          f"{[round(1e3 * t, 2) for t in pairs['prefill_s']]}")
    print(f"[{tag}] prompt streaming ms per prompt: "
          f"{[round(1e3 * t, 2) for t in stream]} "
          f"({1e3 * sum(stream) / streamed:.3f} ms per prompt token)")
    print(f"[{tag}] decode: {len(dec)} dispatches, median "
          f"{1e3 * statistics.median(dec):.2f} ms per dispatch "
          f"({eng.dispatch_n} steps x {eng.n_lanes} lanes max)")
    print(f"[{tag}] K10 launches {counts['ssd_chunk']} = {cfg.n_layers} x "
          f"{len(reqs)} prompts; launches: {counts}")
    print_graphs(tag, graphs)
    print(f"[{tag}] prefill (K10) vs streamed logits at plen - 1, bf16: "
          f"max |diff| per prompt {[round(d, 4) for d in diffs]}, argmax "
          f"agrees {agree}/{len(diffs)} (no gate in bf16: the prefill conv "
          f"rounds in bf16, the decode conv in f32)")
    summary = {"tok_s": n_gen / wall, "wall_s": wall,
               "prefill_ms": {b: 1e3 * statistics.median(t)
                              for b, t in pre.items()},
               "chunked_prefill_ms_per_prompt": [1e3 * t for t in
                                                 pairs["prefill_s"]],
               "stream_ms_per_prompt": [1e3 * t for t in stream],
               "stream_ms_per_token": 1e3 * sum(stream) / streamed,
               "decode_ms_per_dispatch": 1e3 * statistics.median(dec),
               "n_dispatches": len(dec), "plens": plens, "graphs": graphs,
               "decode_launches_per_step": per_step,
               "prefill_vs_stream_max_abs": diffs,
               "prefill_vs_stream_argmax_agree": agree}
    del eng                     # the check's wrapper holds a cycle to it
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def serve_mamba(dev, cfg, params, tag, which, **engine_kw):
    """Serve the full-width ssm requests numbered ``which`` (prompts
    64-512 from seed 2: 440, 181 and 113 tokens; 32 new tokens, 4 lanes,
    max_len 1024) through :func:`serve_streamed`; K10 must launch 48
    times per prompt.  Prompt streaming cost ~29-50 ms per token at this
    depth on an H100 as eager decode steps (host-bound), so the serve
    was cut to 3 requests to keep these phases near a minute; it now
    replays a captured step."""
    reqs = _requests(cfg, 3, 64, 512, 32, SEED + 2)
    return serve_streamed(dev, cfg, params, tag, [reqs[i] for i in which],
                          32, 1024, **engine_kw)


#: the full-width hymba serve's prompt lengths: one in the 128 bucket,
#: two in the 1024 bucket (1000 + 64 new tokens decodes across position
#: 1024, the window's last slot), and one past the window (1100: the
#: ring has wrapped before the first decode step)
HYMBA_PLENS = (96, 700, 1000, 1100)


def init_hymba(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("hymba-1.5b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[hymba] {cfg.name} bf16, {n_params / 1e9:.3f}B params "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def serve_hymba(dev, cfg, params, tag, **engine_kw):
    """Serve hymba-1.5b at full width (``HYMBA_PLENS`` prompts from the
    seed, 64 new tokens, 4 lanes, max_len 2048: a ring of the window's
    1024 slots, or its 64 pages of 16) through :func:`serve_streamed`,
    which gates K2, K10 and K3/K1's launches, the replayed dispatch and
    the replayed stream."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED + 6)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n
                                               ).astype(np.int32),
                    max_new_tokens=64) for i, n in enumerate(HYMBA_PLENS)]
    return serve_streamed(dev, cfg, params, tag, reqs, 64, 2048, **engine_kw)


def phase_ssm_forward(dev, cfg, params):
    """``build_model(cfg).forward`` at full width: bf16 at B 1, S 2048
    (timed, 48 K10 launches, finite logits); then in float32 (the same
    weights, upcast) every position of a 512-token prompt against the
    logits of streaming it through ``lm_decode_step`` from a fresh
    cache, which never runs K10."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.transformer import LM
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device=dev,
                           generator=g, dtype=torch.int32)
    model.forward(params, tokens)                     # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = model.forward(params, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        k10 = launch_counts()["ssd_chunk"]
        if k10 != cfg.n_layers:
            fail(f"forward launched K10 {k10} times, not {cfg.n_layers}")
    v = cfg.vocab_size
    if logits.shape != (1, 2048, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[..., :v]).all()):
        fail("full-width forward logits are not finite of the right shape")
    fwd_ms = 1e3 * statistics.median(times)
    del logits
    # the device's busy time in the same call, by kernel (torch.profiler):
    # the call issues thousands of eager launches, more than a stream
    # queues behind a busy-wait, so CUDA events around it would count
    # the host's gaps
    from repro_torch.kernels.breakdown import kernel_ms
    by_kernel = kernel_ms(lambda: model.forward(params, tokens), reps=3)
    busy_ms = sum(by_kernel.values())
    k10_ms = sum(v for name, v in by_kernel.items() if "ssd_c" in name)
    print(f"[mamba2 forward] bf16 B=1 S=2048: median {fwd_ms:.2f} ms over "
          f"3 runs ({[round(1e3 * t, 2) for t in times]}) on the host "
          f"clock; device busy {busy_ms:.2f} ms a call, {k10_ms:.2f} of "
          f"it in K10's kernels; K10 launches {k10}, logits finite")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = LM(cfg32, dev)
    p32.load_state_dict(params.state_dict())          # upcast copies
    model32 = build_model(cfg32)
    prompt = tokens[:, :512]
    reset_launch_counts()
    full = model32.forward(p32, prompt)[0, :, :v]
    torch.cuda.synchronize()
    k10_32 = launch_counts()["ssd_chunk"]
    cache = model32.init_cache(1, 1024, device=dev)
    t0 = time.perf_counter()
    streamed = []
    for t in range(prompt.shape[1]):
        step_logits, cache = model32.decode_step(p32, cache, prompt[:, t])
        streamed.append(step_logits[0, :v])
    streamed = torch.stack(streamed)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    diff = max_err(full, streamed)
    scale = float(streamed.abs().max().item())
    agree = int((full.argmax(-1) == streamed.argmax(-1)).sum().item())
    print(f"[mamba2 forward] float32, 512 tokens (2 chunks), K10 launches "
          f"{k10_32}: forward vs streamed logits at every position: max "
          f"|diff| {diff:.3e} (max |logit| {scale:.3f}; tol "
          f"{SSM_FWD_TOL}), argmax agrees {agree}/512; streaming took "
          f"{stream_s:.2f}s")
    if k10_32 != cfg.n_layers:
        fail(f"float32 forward launched K10 {k10_32} times")
    if not diff <= SSM_FWD_TOL:
        fail(f"forward (chunked, K10) and streamed (recurrent) logits "
             f"differ by {diff}")
    del p32, model32, cache
    torch.cuda.empty_cache()
    return {"forward_bf16_s2048_ms": fwd_ms,
            "forward_bf16_s2048_runs_ms": [1e3 * t for t in times],
            "forward_bf16_s2048_busy_ms": busy_ms,
            "forward_bf16_s2048_k10_busy_ms": k10_ms,
            "fp32_forward_vs_stream_max_abs": diff,
            "fp32_max_abs_logit": scale,
            "fp32_argmax_agree_of_512": agree,
            "fp32_forward_k10_launches": k10_32,
            "fp32_stream_512_s": stream_s}


def phase_hymba_timings(dev):
    """The kernels of hymba-1.5b's path at its shapes, as device time per
    call (``time_ms_queued``) beside their plain versions, one PyTorch
    call where one computes the function, and the bound: K2 bf16 at B 1,
    H 25 over Hkv 5, D 64, window 1024, Sq 2048 (the 1100-token prompt's
    bucket; beside SDPA with the window as a boolean mask) and Sq 1024;
    K3, K1, K5 and K4 at ``HYMBA_DECODE`` (bf16 q; int8 with per-token
    scales; K1 beside its pages gathered then SDPA, the int8 kernels
    beside the dequantize route); K10 bf16 at (1, 2048, 50, 64), N 16,
    chunk 256, and at S 1024."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages, quantize_kv_q8)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    rows = {}
    win = 1024

    def k2(sq):
        q, k, v = k2_inputs(sq, torch.bfloat16, dev, 64, 25, 5)
        i = torch.arange(sq, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - win)
        pairs = int(mask.sum().item())
        return with_bound(dict(
            ms=time_ms_queued(lambda: flash_attention(q, k, v, causal=True,
                                                      window=win)),
            plain_ms=time_ms_queued(lambda: attention_ref(
                q, k, v, causal=True, window=win)),
            library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)),
            bytes=2 * (2 * q.numel() + k.numel() + v.numel()),
            flops=4 * 25 * pairs * 64, peak=BF16_FLOPS_PER_S,
            shape=f"bf16 B 1 H 25 Hkv 5 Sq {sq} D 64 window {win}"))

    rows["flash_attention_mma"] = k2(2048)
    rows["flash_attention_mma"]["s1024"] = k2(1024)
    q, kp, vp, bt, lens, k, v = hymba_decode_inputs(torch.bfloat16, dev)
    b, hkv, s, d = k.shape
    h = q.shape[1]
    n_live = int(lens.to(torch.int64).sum().item())
    ps = kp.shape[2]
    pages_live = int(((lens.to(torch.int64) + ps - 1) // ps).sum().item())
    io_bytes = 2 * q.numel() * 2 + 4 * lens.numel()
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :].contiguous()
    ql = q[:, :, None].contiguous()
    shape = (f"bf16 q, B 4 H 25 Hkv 5 D 64, S 1024 ring, lengths "
             f"{lens.tolist()}")
    rows["decode_attention_lengthaware"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention(q, k, v, lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_ref(q, k, v,
                                                             lens)),
        library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            ql, k, v, attn_mask=mask, enable_gqa=True)),
        bytes=2 * n_live * hkv * d * 2 + io_bytes,
        flops=4 * n_live * h * d, peak=BF16_FLOPS_PER_S, shape=shape))
    rows["decode_attention_paged"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_paged(q, kp, vp, bt,
                                                         lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_ref(
            q, kp, vp, bt, lens)),
        library_ms=None,
        gather_sdpa_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            ql, gather_pages(kp, bt), gather_pages(vp, bt), attn_mask=mask,
            enable_gqa=True)),
        bytes=2 * n_live * hkv * d * 2 + io_bytes + 4 * pages_live,
        flops=4 * n_live * h * d, peak=BF16_FLOPS_PER_S,
        shape=shape + ", pages of 16"))
    kq, ks = quantize_kv_q8(kp.float(), 1)
    vq, vs = quantize_kv_q8(vp.float(), 1)
    gq = [gather_pages(x, bt) for x in (kq, ks, vq, vs)]
    row_bytes = hkv * (2 * d + 2 * 4)       # int8 k and v, f32 k/v scales
    rows["decode_attention_q8_lengthaware"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_q8(q, *gq, lens,
                                                      qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_q8_ref(
            q, *gq, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_dense(q, *gq, lens, 1)),
        bytes=n_live * row_bytes + io_bytes,
        flops=4 * n_live * h * d + 2 * n_live * hkv * d,
        peak=BF16_FLOPS_PER_S, shape=shape + ", int8 per-token scales"))
    rows["decode_attention_paged_q8"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_paged_q8(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_q8_ref(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_paged(q, kq, ks, vq, vs, bt,
                                                     lens, 1)),
        bytes=n_live * row_bytes + io_bytes + 4 * pages_live,
        flops=4 * n_live * h * d + 2 * n_live * hkv * d,
        peak=BF16_FLOPS_PER_S,
        shape=shape + ", pages of 16, int8 per-token scales"))
    hh, pp, nn = HYMBA_SSD

    def k10(sq):
        args = k10_inputs(1, sq, torch.bfloat16, "model", dev,
                          widths=HYMBA_SSD)
        nc, tri = sq // SSD_Q, SSD_Q * (SSD_Q + 1) // 2
        flops = (2 * nc * tri * nn
                 + 2 * nc * hh * (tri * pp + SSD_Q * nn * pp))
        out_bytes = 4 * (args[0].numel() + nc * hh * (nn * pp + 1))
        in_bytes = sum(t.numel() * t.element_size() for t in args)
        return with_bound(dict(
            ms=time_ms_queued(lambda: ssd_chunk(*args, chunk=SSD_Q)),
            plain_ms=time_ms_queued(lambda: ssd_chunk_ref(*args, SSD_Q)),
            library_ms=None, bytes=in_bytes + out_bytes, flops=flops,
            peak=TF32_FLOPS_PER_S,
            shape=f"bf16 x/b/c (1,{sq},50,64) N 16 chunk 256"))

    rows["ssd_chunk"] = k10(2048)
    rows["ssd_chunk"]["s1024"] = k10(1024)
    for name, r in rows.items():
        for rr in (r, r.get("s1024")):
            if rr is None:
                continue
            lib = rr["library_ms"]
            extra = "".join(f", {k} {rr[k]:.4f} ms" for k in
                            ("route_ms", "gather_sdpa_ms") if k in rr)
            print(f"[time hymba] {name} ({rr['shape']}): kernel "
                  f"{rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, "
                  f"library {'n/a' if lib is None else f'{lib:.4f} ms'}"
                  f"{extra}, bound {rr['bound_ms']:.5f} ms "
                  f"({rr['bound_by']}: {rr['bytes']} B, {rr['flops']} flop)")
    return rows


def k10_timing(dev):
    """K10 at (1, 1024, 48, 64), N 128, chunk 256, bf16 x/b/c: kernel and
    plain ms as device time per call (``time_ms_queued``) beside the
    bound.  Operations: the multiply-adds the
    function needs -- C.B over each chunk's lower triangle once per
    (b, z) (B and C are shared by the heads), per head the triangle's
    products with dt*x and the N x P boundary state -- over the 495
    TFLOP/s TF32 peak, as for K7's f32 dot; bytes: every input read once
    and every output written once."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    bsz, s = 1, 1024
    args = k10_inputs(bsz, s, torch.bfloat16, "model", dev)
    x, dt, a, b, c = args
    nc, tri = s // SSD_Q, SSD_Q * (SSD_Q + 1) // 2
    flops = (2 * bsz * nc * tri * SSD_N
             + 2 * bsz * nc * SSD_H * (tri * SSD_P + SSD_Q * SSD_N * SSD_P))
    out_bytes = 4 * (x.numel() + bsz * nc * SSD_H * (SSD_N * SSD_P + 1))
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    r = dict(ms=time_ms_queued(lambda: ssd_chunk(*args, chunk=SSD_Q)),
             plain_ms=time_ms_queued(lambda: ssd_chunk_ref(*args, SSD_Q)),
             library_ms=None, bytes=in_bytes + out_bytes, flops=flops,
             shape="bf16 x/b/c (1,1024,48,64) N 128 chunk 256")
    t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / TF32_FLOPS_PER_S
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    # the forward phase's length, 8 chunks: K10's share of that forward
    long_args = k10_inputs(1, 2048, torch.bfloat16, "model", dev)
    r["ms_s2048"] = time_ms_queued(
        lambda: ssd_chunk(*long_args, chunk=SSD_Q))
    print(f"[time] ssd_chunk at S=2048: kernel {r['ms_s2048']:.4f} ms")
    print(f"[time] ssd_chunk ({r['shape']}): kernel {r['ms']:.4f} ms "
          f"({flops / r['ms'] / 1e9:.2f} TFLOP/s of the needed work), "
          f"plain {r['plain_ms']:.4f} ms, library n/a (no single call), "
          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} B "
          f"= {t_bytes:.5f} ms, {flops} flop at 495 T/s = {t_ops:.5f} ms)")
    return r


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
    errs = {"decode_attention_paged": phase_k1(dev)}
    errs.update(phase_k2(dev))
    errs.update(phase_dense(dev))
    errs.update(phase_q8(dev))
    hymba_errs = phase_hymba_decode(dev)
    smoke_counts, _ = phase_smoke_e2e(dev)
    if not smoke_counts["flash_attention_cc"]:
        fail(f"the float32 SMOKE serve never ran K2's CUDA-core kernel: "
             f"{smoke_counts}")
    phase_smoke_e2e(dev, kv_quant="int8")
    cfg, params = init_full(dev)
    paged_counts, paged_e2e = phase_full_paged(dev, cfg, params)
    fixed_counts, fixed_e2e = phase_full_fixed(dev, cfg, params)
    int8 = phase_full_int8(dev, cfg, params)
    del params
    rows = phase_timings(dev)
    compute_errs = {**phase_k8_check(dev), **phase_k9_check(dev),
                    **phase_k7_check(dev)}
    phase_sass()
    compute_counts, sweep_summary = phase_compute_main(dev)
    for key, err in sweep_summary["output_max_abs_err"].items():
        e = compute_errs["mixbench_" + key.split("/")[0]]
        e["max_abs_err_f32"] = max(e["max_abs_err_f32"], err)
    compute_rows = phase_compute_timings(dev)
    t_ssm = time.perf_counter()
    k10_errs = phase_k10(dev)
    phase_smoke_e2e(dev, arch="mamba2-780m")
    m_cfg, m_params = init_mamba(dev)
    m_fixed_counts, m_fixed = serve_mamba(dev, m_cfg, m_params,
                                          "mamba2 fixed-lane", (0, 1, 2))
    m_paged_counts, m_paged = serve_mamba(dev, m_cfg, m_params,
                                          "mamba2 paged", (1, 2),
                                          paged=True)
    m_forward = phase_ssm_forward(dev, m_cfg, m_params)
    del m_params
    torch.cuda.empty_cache()
    k10_row = k10_timing(dev)
    print(f"[mamba2] the SSM phases took {time.perf_counter() - t_ssm:.1f}s")
    t_hybrid = time.perf_counter()
    h_smoke = {}
    for kv_quant in (None, "int8"):
        fixed, paged = phase_smoke_e2e(dev, kv_quant=kv_quant,
                                       arch="hymba-1.5b")
        h_smoke[kv_quant] = fixed, paged
        need = (("decode_attention_q8_lengthaware",
                 "decode_attention_paged_q8") if kv_quant else
                ("decode_attention_lengthaware", "decode_attention_paged"))
        if not (fixed["flash_attention_cc"] and fixed["ssd_chunk"] and
                fixed[need[0]] and paged[need[1]]):
            fail(f"the float32 hymba SMOKE serves (kv {kv_quant}) missed a "
                 f"kernel of their path: {fixed} {paged}")
    h_cfg, h_params = init_hymba(dev)
    h_fixed_counts, h_fixed = serve_hymba(dev, h_cfg, h_params,
                                          "hymba fixed-lane")
    h_paged_counts, h_paged = serve_hymba(dev, h_cfg, h_params,
                                          "hymba paged", paged=True,
                                          page_size=16)
    del h_params
    torch.cuda.empty_cache()
    hymba_rows = phase_hymba_timings(dev)
    print(f"[hymba] the hybrid phases took "
          f"{time.perf_counter() - t_hybrid:.1f}s")

    replaces = {
        "decode_attention_paged":
            "src/repro/kernels/decode_attention/kernel.py:322",
        "flash_attention_mma":
            "src/repro/kernels/flash_attention/kernel.py:85",
        "flash_attention_cc":
            "src/repro/kernels/flash_attention/kernel.py:85",
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
    sources = {"flash_attention_mma": "flash_attention",
               "flash_attention_cc": "flash_attention",
               "decode_attention_lengthaware": "decode_attention_dense",
               "decode_attention_masked": "decode_attention_dense",
               "decode_attention_q8_lengthaware": "decode_attention_dense",
               "decode_attention_q8_masked": "decode_attention_dense",
               "decode_attention_paged_q8": "decode_attention_paged"}
    # each kernel's launches come from the main-path run that drives it:
    # K1 from the paged serve, K2's tensor-core kernel and K3 from the
    # fixed-lane (default) serve, K5 from the fixed-lane int8 serve, K4
    # from the paged int8 serve, K2's CUDA-core kernel from the float32
    # SMOKE serve on the card (fixed-lane, greedy); K6a and K6b are on no
    # serving path and report the count of the fixed-lane serve of their
    # cache type, 0
    # hymba-1.5b: K2's tensor-core kernel, K3 and K10 from its fixed-lane
    # serve, K1 from its paged serve, K5 and K4 from its float32 int8
    # SMOKE serves (fixed-lane and paged, greedy), K2's CUDA-core kernel
    # from its float32 SMOKE serve; errors at its shapes (bf16, f32 beside)
    hymba_launches = {
        "flash_attention_mma": h_fixed_counts["flash_attention_mma"],
        "flash_attention_cc": h_smoke[None][0]["flash_attention_cc"],
        "decode_attention_lengthaware":
            h_fixed_counts["decode_attention_lengthaware"],
        "decode_attention_paged": h_paged_counts["decode_attention_paged"],
        "decode_attention_q8_lengthaware":
            h_smoke["int8"][0]["decode_attention_q8_lengthaware"],
        "decode_attention_paged_q8":
            h_smoke["int8"][1]["decode_attention_paged_q8"],
        "ssd_chunk": h_fixed_counts["ssd_chunk"]}
    hymba_errs["flash_attention_mma"] = {
        "bfloat16": errs["flash_attention_mma"]["hymba"]}
    hymba_errs["flash_attention_cc"] = {
        "float32": errs["flash_attention_cc"]["hymba"]}

    def hymba_entry(name):
        out = {"launches": hymba_launches[name]}
        r = hymba_rows.get(name)
        if r is not None:
            out.update({k: r[k] for k in r if k not in ("peak", "s1024")})
            if "s1024" in r:
                out["s1024"] = {k: r["s1024"][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "shape")}
        for dtype, tag in (("bfloat16", ""), ("float32", "_f32")):
            if dtype in hymba_errs.get(name, {}):
                out[f"max_abs_err{tag}"], out[f"tol{tag}"] = \
                    hymba_errs[name][dtype]
        return out

    int8_fixed = int8["full e2e fixed-lane int8"][0]
    int8_paged = int8["full e2e paged int8"][0]
    launches = dict(fixed_counts)
    launches["decode_attention_paged"] = paged_counts["decode_attention_paged"]
    launches["flash_attention_cc"] = smoke_counts["flash_attention_cc"]
    for name in ("decode_attention_q8_lengthaware",
                 "decode_attention_q8_masked"):
        launches[name] = int8_fixed[name]
    launches["decode_attention_paged_q8"] = \
        int8_paged["decode_attention_paged_q8"]
    kernels = []
    for name in ("decode_attention_paged", "flash_attention_mma",
                 "flash_attention_cc", "decode_attention_lengthaware",
                 "decode_attention_masked", "decode_attention_paged_q8",
                 "decode_attention_q8_lengthaware",
                 "decode_attention_q8_masked"):
        r = rows[name]
        # max_abs_err is that of the dtype the main path launches: float32
        # for K2's CUDA-core kernel (the SMOKE serve; its own shape's
        # error stands beside, as max_abs_err_smoke_shape), bf16 for the
        # rest; the other dtype's stands beside it
        main_dtype = ("float32" if name == "flash_attention_cc"
                      else "bfloat16")
        err, tol = errs[name][main_dtype]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err, "tol": tol,
            "ms": r["ms"], "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bytes": r["bytes"]}
        for other, tag in (("float32", "f32"), ("bfloat16", "bf16")):
            if other != main_dtype and other in errs[name]:
                entry[f"max_abs_err_{tag}"], entry[f"tol_{tag}"] = \
                    errs[name][other]
        if "smoke" in errs[name]:
            entry["max_abs_err_smoke_shape"] = errs[name]["smoke"][0]
        for extra in ("route_ms", "gather_sdpa_ms"):
            if extra in r:
                entry[extra] = r[extra]
        for sub in ("s1024", "d96"):
            if sub in r:
                entry[sub] = {key: r[sub][key] for key in (
                    "ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}
        if name in hymba_launches:
            entry["hymba"] = hymba_entry(name)
        kernels.append(entry)
    compute_replaces = {
        "mixbench_fma": "src/repro/kernels/mixbench/kernel.py:56",
        "mixbench_mul_add": "src/repro/kernels/mixbench/kernel.py:56",
        "fma_matmul_mxu": "src/repro/kernels/fma_matmul/kernel.py:69",
        "fma_matmul_mxu_wmma": "src/repro/kernels/fma_matmul/kernel.py:69",
        "fma_matmul_mul_add": "src/repro/kernels/fma_matmul/kernel.py:69",
        "fma_matmul_mul_add_staged":
            "src/repro/kernels/fma_matmul/kernel.py:69",
        "qmatmul_dequant_dot": "src/repro/kernels/qmatmul/kernel.py:197",
        "qmatmul_dot_i8": "src/repro/kernels/qmatmul/kernel.py:149"}
    for name, replaced in compute_replaces.items():
        r = compute_rows[name]
        src = next(f for f in ("mixbench", "fma_matmul", "qmatmul")
                   if name.startswith(f))
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{src}.cu",
                 "replaces": replaced, "launches": compute_counts[name],
                 **compute_errs[name], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "bytes": r["bytes"], "shape": r["shape"]}
        for extra in ("route_ms", "ms_by_format", "single_call_ms",
                      "by_shape"):
            if extra in r:
                entry[extra] = r[extra]
        kernels.append(entry)
    # K10's launches: the fixed-lane (default) mamba2 serve, 48 per prompt;
    # the serve discards their output (as the reference does), the float32
    # forward's launches are the ones whose output is gated
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:68",
        "launches": m_fixed_counts["ssd_chunk"],
        "launches_paged_serve": m_paged_counts["ssd_chunk"],
        "launches_forward_checked": m_forward["fp32_forward_k10_launches"],
        **k10_errs,
        "ms": k10_row["ms"], "plain_ms": k10_row["plain_ms"],
        "bound_ms": k10_row["bound_ms"], "bound_by": k10_row["bound_by"],
        "library_ms": None, "bytes": k10_row["bytes"],
        "flops": k10_row["flops"], "shape": k10_row["shape"],
        "ms_s2048": k10_row["ms_s2048"], "hymba": {
            **hymba_entry("ssd_chunk"),
            "max_rel_err": k10_errs["max_rel_err_hymba"],
            "max_rel_err_f32": k10_errs["max_rel_err_hymba_f32"],
            "tol": K10_TOL,
            "launches_paged_serve": h_paged_counts["ssd_chunk"]}})
    e2e = {"paged": paged_e2e, "fixed_lane": fixed_e2e,
           "paged_int8": int8["full e2e paged int8"][1],
           "fixed_lane_int8": int8["full e2e fixed-lane int8"][1]}
    e2e["fixed_lane_t0.8"] = fixed_e2e.pop("temperature_0.8")
    for name, r in e2e.items():
        g = r["graphs"]
        print(f"[e2e] {name}: {r['tok_s']:.1f} tok/s, decode "
              f"{r['decode_ms_per_dispatch']:.2f} ms per dispatch (eager "
              f"{g['decode_ms_eager']:.2f}, graph {g['decode_ms_graph']:.2f}"
              f" at n_steps {g['n_steps']}), capture s {g['capture_s']}")
    for name, r in (("mamba2 fixed_lane", m_fixed), ("mamba2 paged",
                                                      m_paged)):
        g = r["graphs"]
        print(f"[e2e] {name}: {r['tok_s']:.1f} tok/s, prompt streaming "
              f"{r['stream_ms_per_token']:.3f} ms per token in the serve "
              f"(check: eager {g['stream_ms_per_token_eager']:.3f}, "
              f"replayed {g['stream_ms_per_token_graph']:.3f}), decode "
              f"eager {g['decode_ms_eager']:.2f}, graph "
              f"{g['decode_ms_graph']:.2f} ms per dispatch")
    print(f"[e2e] {json.dumps(e2e)}")
    ssm_e2e = {"fixed_lane": m_fixed, "paged": m_paged,
               "forward": m_forward}
    print(f"[mamba2] {json.dumps(ssm_e2e)}")
    for name, r in (("hymba fixed_lane", h_fixed), ("hymba paged",
                                                     h_paged)):
        g = r["graphs"]
        print(f"[e2e] {name}: {r['tok_s']:.1f} tok/s, decode "
              f"{r['decode_ms_per_dispatch']:.2f} ms per dispatch in the "
              f"serve (check at n_steps {g['n_steps']}: eager "
              f"{g['decode_ms_eager']:.2f}, replayed "
              f"{g['decode_ms_graph']:.2f}); prompt streaming "
              f"{r['stream_ms_per_token']:.3f} ms per token in the serve "
              f"(check: eager {g['stream_ms_per_token_eager']:.3f}, "
              f"replayed {g['stream_ms_per_token_graph']:.3f}); prefill ms "
              f"by bucket {({b: round(t, 2) for b, t in sorted(r['prefill_ms'].items())})}"
              f"; capture s {g['capture_s']}")
    print(f"[hymba] {json.dumps({'fixed_lane': h_fixed, 'paged': h_paged})}")
    print(f"[sweep] {json.dumps(sweep_summary)}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
