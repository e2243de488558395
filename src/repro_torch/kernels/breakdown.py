"""What holds a port kernel back, read on the card.

``python -m repro_torch.kernels.breakdown --target T`` (on a machine
with the card) builds, with ``nvcc`` (one process a copy, all started
together), copies of T's source with parts cut out, puts each copy's
library in the place of the built one, and times it at the main path's
shapes as device time per call (CUDA events around 20 calls queued
behind a busy-wait, so the host's launch cost stays out), beside one
PyTorch call that computes the same function.  Only ``full`` (the
library as built), ``before`` and k10's ``no PDL`` compute the
function; every other cut gives wrong numbers by design.  The targets and their cuts:

K9's weight stream (``csrc/fma_matmul.cu``), at the qwen2.5-1.5b MLP
shapes in float32 and bfloat16, also as device time per kernel from
``torch.profiler`` (the arm's kernel and the split-K reduce), beside
``torch.matmul`` (TF32 for ``mxu``; for ``mul_add`` one float32 product
with TF32 off, on float32 copies of the inputs); then ``nvidia-smi``
reads the SM clock, power and throttle reasons after a second of
back-to-back ``full`` calls at the first float32 shape:

* ``mxu``: ``loads+stores`` (no products: the TMA ring, and the stores
  of the zero accumulators); ``loads`` (neither products nor stores:
  products whose sums are never stored would be dropped anyway);
  ``products+stores`` (no copies: each stage's barrier is armed for no
  bytes and the products run on whatever the ring holds);
* ``mul_add``: ``no products``; ``no copies`` (as above; bf16 stages are
  still converted to f32); ``no piece stores`` (the runs write no pieces
  of tiles to the workspace; the reduce still adds what it holds).

K2, the tensor-core kernel (``csrc/flash_attention.cu``; bf16, B 1, H
12, Hkv 2, D 128, causal, Sq 512 and 1024, and phi-3-vision-4.2b's
prefill, H 32 over 32, D 96, causal Sq 1024; the CUDA-core kernel in
float32 at Sq 512, ``full`` and ``before`` only), beside
``F.scaled_dot_product_attention``:

* ``k2``: ``empty`` (every CTA returns at once: the launch's floor);
  ``no products`` (no ``mma.sync``, nor the fragment loads that feed
  them: the TMA ring, the softmax and the barriers); ``no exp``; ``no
  exp, no rescale``; ``softmax only`` (the ring, the masks, the row
  maxima and sums, the barriers).

K3 and K6a (``csrc/decode_attention_dense.cu``; the fixed-lane serve's
B 8, H 12, Hkv 2, S 1024, bf16 q, lengths 0, 1, 15, 16, 17, 300, 777,
1024) over a bf16 cache beside SDPA, and K5 and K6b, the same template
over an int8 cache at ``qblock`` 1:

* ``k3``: ``empty``; ``loads only`` (each CTA returns once its chunk has
  landed in shared memory); ``no merge`` (the last CTA of a head returns
  instead of merging).

K1 and K4 (``csrc/decode_attention_paged.cu``, the same split body,
``csrc/decode_split.cuh``, read through the block table; the paged
serve's B 8, H 12, Hkv 2, D 128, pages of 16, T 64, bf16 q, the same
lengths): K1 over bf16 pools beside its pages gathered and then SDPA
(no single call reads a block table), K4 over int8 pools at ``qblock``
1:

* ``k1``: the cuts of ``k3``, in the shared body.

K10 (``csrc/ssd_scan.cu``; mamba2-780m's H 48, P 64, N 128, chunk 256,
B 1: bf16 x/b/c at S 1024 and 2048, float32 at S 1024; no single
PyTorch call computes it, so no yardstick):

* ``k10``: ``empty`` (every CTA of both launches returns at once);
  ``no C.B`` (the C.B^T launch is left out: the per-head launch reads
  the workspace as it lies); ``no products`` (no per-head ``mma.sync``,
  in either dtype's path: the compiler then drops the A fragments that
  fed them, leaving the copies, the cumsum and the stores); ``no exp``
  (the per-element exp of the diagonal tiles); ``no states`` (the grid
  has no state CTAs); ``no PDL`` (launch 2 goes out as a plain launch,
  after launch 1's end: its prologue no longer overlaps launch 1; the
  only cut that computes the function).

K7 (``csrc/qmatmul.cu``; both qwen2.5-1.5b MLP shapes at M 128 and
M 8, f32 and bf16 x; ``dequant_dot`` in all four formats and ``dot_i8``
in q8_0 for ``full`` and ``before``, the cuts at q4_k and ``dot_i8``),
beside the route, dequantize then ``torch.matmul`` with TF32 off (no
single PyTorch call computes a block-quantized product):

* ``k7``: ``empty`` (every CTA of x's and the products' launches
  returns at once; the fold then adds what the workspace holds); ``no
  products`` (no ``mma.sync``, nor the fragment loads that feed them);
  ``no dequant/quantize`` (``dequant_dot``: stages after the first are
  not unpacked, the products read the integer tile as it lies;
  ``dot_i8``: x is not quantized, the products read the scratch as it
  lies); ``no epilogue`` (each sub-block's or block's sums are added
  unscaled, no mins); ``no split-K fold`` (the fold launch is left
  out: the tiles no run holds whole are never added up); ``no copies`` (no
  16-byte copy into the ring: the products run on what it holds).

A cut in a header applies to the copy of the source that includes it:
each copy is the source with the ``csrc`` headers it includes written
in (:func:`source_text`).

``--before TREE`` also times the package under ``TREE`` (the ``src`` of
an earlier tree, e.g. unpacked with ``git archive`` under the
git-ignored ``build/``) as it is, as ``before``, on the same inputs, in
a child process whose imports resolve there: two versions on one card
in one call.  ``--only a,b`` builds only the named cuts.  The last line
is a JSON object of the times (ms).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build

#: the split-KV body's cuts (``csrc/decode_split.cuh``), for K3 and K1
_SPLIT_CUTS = {
    "empty": ("  __shared__ bool last;\n",
              "  __shared__ bool last;\n  if (S > 0) return;\n"),
    "loads": ("    // scores: key j's 4 threads",
              "    if (S > 0) return;\n    // scores: key j's 4 threads"),
    "merge": ("  if (!last) return;\n  __threadfence();", "  return;"),
}
#: source -> cut -> (text of ``csrc/<source>.cu`` with its headers, its
#: replacement)
CUTS = {
    "fma_matmul": {
        "products": ("for (int kk = 0; kk < kBK; kk += Stream<T>::kMmaK) {",
                     "for (int kk = 0; kk < 0; kk += Stream<T>::kMmaK) {"),
        "mul_add_products": ("for (int kq = 0; kq < kBK; kq += 4) {",
                             "for (int kq = 0; kq < 0; kq += 4) {"),
        "stores": ("      Arm::store(acc, p, whole ? N : SBN, M - m0, "
                   "N - n0);",
                   "      if (false)\n"
                   "        Arm::store(acc, p, N, M - m0, N - n0);"),
        "piece_stores": ("      Arm::store(acc, p, whole ? N : SBN, M - m0, "
                         "N - n0);",
                         "      if (whole)\n"
                         "        Arm::store(acc, p, N, M - m0, N - n0);"),
        "w": ("      tma_load(st + b * BK * BOX, wmap, n0 + b * BOX, k0, "
              "bar, once);", "      ;"),
        "x": ("    tma_load(st + WSTAGE, xmap, k0, (tile / n_tiles) * SBM, "
              "bar, keep);", ""),
        "bytes": ("mbar_expect(bar, STAGE * (int)sizeof(T));",
                  "mbar_expect(bar, 0);"),
    },
    "flash_attention": {
        "empty": ("  extern __shared__ __align__(16) unsigned char "
                  "smem_raw[];\n",
                  "  extern __shared__ __align__(16) unsigned char "
                  "smem_raw[];\n  if (Sq > 0) return;\n"),
        "qk": ("      for (int np = 0; np < NT / 2; ++np) {",
               "      for (int np = 0; np < 0; ++np) {"),
        "pv": ("      for (int dp = 0; dp < DT / 2; ++dp) {",
               "      for (int dp = 0; dp < 0; ++dp) {"),
        "exp": ("exp2f(x - m[e >> 1])", "(x - m[e >> 1])"),
        "rescale": ("      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];\n"
                    "      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];\n",
                    ""),
    },
    "decode_attention_dense": _SPLIT_CUTS,
    "decode_attention_paged": _SPLIT_CUTS,
    "ssd_scan": {
        "empty_cb": ("  T* bs = cs + TILE * stride;\n",
                     "  T* bs = cs + TILE * stride;\n  if (Q > 0) return;\n"),
        "empty_chunk": ("  stage(0);\n",
                        "  if (Q > 0) return;\n  stage(0);\n"),
        "cb": ("  cb<<<dim3(RB * (RB + 1) / 2, chunks), THREADS, cb_bytes, "
               "stream>>>(\n      bm, static_cast<const T*>(c), wsf, N, Q, "
               "vec);\n", ""),
        "products": ("  for (int nb = 0; nb < MAX_P / 8; ++nb) {\n"
                     "    const int o = (k0 + t) * XS + nb * 8 + g;",
                     "  for (int nb = 0; nb < 0; ++nb) {\n"
                     "    const int o = (k0 + t) * XS + nb * 8 + g;"),
        "products_bf16": ("  for (int nb = 0; nb < MAX_P / 8; nb += 2) {",
                          "  for (int nb = 0; nb < 0; nb += 2) {"),
        "exp": ("? cb * expf((float)(cum_r[ro >> 3] - cum[j])) * dts[j]",
                "? cb * (float)(cum_r[ro >> 3] - cum[j]) * dts[j]"),
        "states": ("  cfg.gridDim = dim3(RB + NB, H, chunks);",
                   "  cfg.gridDim = dim3(RB, H, chunks);"),
        "pdl": ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;"),
    },
    "qmatmul": {
        "empty_prep": ("  griddep_launch();\n",
                       "  griddep_launch();\n"
                       "  if (K > 0) asm volatile(\"exit;\");\n"),
        "empty_dq": ("  float* eff = reinterpret_cast<float*>(Wt + 2 * "
                     "L::W_ELEMS);\n",
                     "  float* eff = reinterpret_cast<float*>(Wt + 2 * "
                     "L::W_ELEMS);\n  if (M > 0) return;\n"),
        "empty_i8": ("  using L = I8<C>;\n  extern __shared__ __align__(16) "
                     "unsigned char smem[];\n",
                     "  using L = I8<C>;\n  extern __shared__ __align__(16) "
                     "unsigned char smem[];\n  if (M > 0) return;\n"),
        "products_dq": ("      for (int p = 0; p < L::P; ++p) {",
                        "      for (int p = 0; p < 0; ++p) {"),
        "products_i8": ("      for (int j = 0; j < C::NT; ++j) "
                        "mma_s8(d[i][j], a, b[j][0], b[j][1]);",
                        "      for (int j = 0; j < 0; ++j) "
                        "mma_s8(d[i][j], a, b[j][0], b[j][1]);"),
        "dequant": ("    if (i + 1 < n)\n      unpack<F, T, C>(",
                    "    if (i + 1 < 0)\n      unpack<F, T, C>("),
        "quantize": ("  if (variant == 1) {\n    if (x_dtype == 0)\n",
                     "  if (variant == 1) {\n    if (x_dtype < 0)\n"),
        "quantize_bf16": ("    else\n      qmatmul_prep_quant_bf16",
                          "    else if (x_dtype < 0)\n"
                          "      qmatmul_prep_quant_bf16"),
        "epilogue_dq": ("    dq_epilogue<F, C>(acc, d, eff + sb * C::BN, "
                        "eff + L::NE + sb * C::BN,\n                      "
                        "xsum + sb * C::BM, wm, wn);",
                        "    for (int i = 0; i < C::MT; ++i)\n"
                        "      for (int j = 0; j < C::NT; ++j)\n"
                        "        for (int e = 0; e < 4; ++e) "
                        "acc[i][j][e] += d[i][j][e];"),
        "epilogue_i8": ("    i8_epilogue<C>(acc, d, wsc + qb * C::BN, "
                        "xs + qb * C::BM, wm, wn);",
                        "    for (int i = 0; i < C::MT; ++i)\n"
                        "      for (int j = 0; j < C::NT; ++j)\n"
                        "        for (int e = 0; e < 4; ++e) "
                        "acc[i][j][e] += (float)d[i][j][e];"),
        "fold": ("  if (iters % runs == 0 && (iters / runs) % nkb == 0) return 0;",
                 "  return 0;"),
        "copies": ("      cp16(dst + r * dld + pc * 16, in ? src + r * ld + "
                   "c * 16 : src, in);", "      ;"),
    },
}
_SPLIT_VARIANTS = {"full": (), "empty": ("empty",),
                   "loads only": ("loads",), "no merge": ("merge",)}
#: target -> (source, {variant: the cuts it applies})
TARGETS = {
    "mxu": ("fma_matmul",
            {"full": (), "loads+stores": ("products",),
             "loads": ("products", "stores"),
             "products+stores": ("w", "x", "bytes")}),
    "mul_add": ("fma_matmul",
                {"full": (), "no products": ("mul_add_products",),
                 "no copies": ("w", "x", "bytes"),
                 "no piece stores": ("piece_stores",)}),
    "k2": ("flash_attention",
           {"full": (), "empty": ("empty",), "no products": ("qk", "pv"),
            "no exp": ("exp",), "no exp, no rescale": ("exp", "rescale"),
            "softmax only": ("qk", "pv", "exp", "rescale")}),
    "k3": ("decode_attention_dense", _SPLIT_VARIANTS),
    "k1": ("decode_attention_paged", _SPLIT_VARIANTS),
    "k10": ("ssd_scan",
            {"full": (), "empty": ("empty_cb", "empty_chunk"),
             "no C.B": ("cb",), "no products": ("products", "products_bf16"),
             "no exp": ("exp",), "no states": ("states",),
             "no PDL": ("pdl",)}),
    "k7": ("qmatmul",
           {"full": (), "empty": ("empty_prep", "empty_dq", "empty_i8"),
            "no products": ("products_dq", "products_i8"),
            "no dequant/quantize": ("dequant", "quantize", "quantize_bf16"),
            "no epilogue": ("epilogue_dq", "epilogue_i8"),
            "no split-K fold": ("fold",),
            "no copies": ("copies",)}),
}
MLP_SHAPES = ((128, 1536, 8960), (128, 8960, 1536))
#: ``fma_matmul_fwd``'s argument types
_K9_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
#: {source: its library as built}, taken before any copy replaces it
_OWN = {}


def source_text(source: str) -> str:
    """The text of ``csrc/<source>.cu`` with each ``csrc`` header it
    includes (``#include "<name>.cuh"``) written in where it is first
    included, once, without its ``#pragma once``."""
    seen = set()

    def expand(text):
        def header(m):
            if m.group(1) in seen:
                return ""
            seen.add(m.group(1))
            body = (_build.CSRC / m.group(1)).read_text()
            return expand(body.replace("#pragma once\n", ""))
        return re.sub(r'^#include "(\w+\.cuh)"$', header, text,
                      flags=re.M)
    return expand((_build.CSRC / f"{source}.cu").read_text())


def source_with(source: str, cuts) -> str:
    """:func:`source_text` of ``source`` with ``cuts`` applied; each cut
    must match it exactly once."""
    text = source_text(source)
    for cut in cuts:
        old, new = CUTS[source][cut]
        if text.count(old) != 1:
            raise RuntimeError(f"cut {cut!r} no longer matches {source}.cu")
        text = text.replace(old, new)
    return text


def build(target: str, variants) -> dict:
    """{variant: library of ``target``'s source with the variant's
    cuts}, one ``nvcc`` a variant, all started together."""
    source, cuts = TARGETS[target]
    out = _build.build_dir() / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant in variants:
        slug = re.sub(r"\W+", "_", f"{target}_{variant}")
        src, lib = out / f"{slug}.cu", out / f"lib{slug}.so"
        src.write_text(source_with(source, cuts[variant]))
        procs[variant] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise _build.KernelBuildError(f"{variant}:\n{text}")
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def _use(source: str, lib) -> None:
    """Make the wrappers launch from ``lib``, a cut copy of ``source``'s
    library, or from the library as built (``lib`` None)."""
    if source not in _OWN:
        _OWN[source] = _build.load(source)
    lib = lib or _OWN[source]
    if _build._LIBS.get(source) is not lib:
        _build._LIBS[source] = lib
        _build._FUNCS.clear()


def queued_ms(call, reps: int = 30, launches: int = 20) -> float:
    """Device ms per call: median over ``reps`` of CUDA events around
    ``launches`` calls queued behind a busy-wait kernel."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(launches):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def kernel_ms(call, reps: int = 30) -> dict:
    """{kernel name: device ms per call} over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            name = re.search(r"fma_matmul_\w+", e.key)
            key = name.group(0) if name else e.key
            times[key] = (times.get(key, 0.0)
                          + e.self_device_time_total / 1e3 / reps)
    return times


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def under_load(call, seconds: float = 1.0) -> str:
    """The SM clock, power and throttle reasons that ``nvidia-smi``
    reads while about ``seconds`` of ``call`` are queued on the card."""
    for _ in range(int(seconds * 1e3 / queued_ms(call))):
        call()
    reading = smi("clocks.sm,power.draw,clocks_throttle_reasons.active")
    torch.cuda.synchronize()
    return reading


def _k9_rows(arm, dev, libs):
    from repro_torch.kernels.fma_matmul import ops
    torch.backends.cuda.matmul.allow_tf32 = arm == "mxu"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for (m, k, n), dtype in ((s, d) for s in MLP_SHAPES
                             for d in (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
        w = torch.randn(k, n, device=dev, generator=gen).to(dtype)
        runs, slots = ops.stream_plan(m, k, n, dtype, sms, arm)
        out = torch.empty(m, n, device=dev)
        ws = torch.empty(slots, min(m, ops.STREAM_BM), ops.STREAM_BN,
                         device=dev)
        code = 0 if dtype == torch.float32 else 1
        xl, wl = (x, w) if arm == "mxu" else (x.float(), w.float())
        row = rows[f"{'f32' if code == 0 else 'bf16'} ({m},{k},{n})"] = {
            "torch.matmul": queued_ms(lambda: torch.matmul(xl, wl))}
        for name, lib in libs.items():
            fn = (lib or _build.load("fma_matmul")).fma_matmul_fwd
            fn.argtypes, fn.restype = _K9_ARGS, ctypes.c_int

            def call(fn=fn, name=name):
                rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                        ws.data_ptr(), m, k, n, {"mxu": 0, "mul_add": 1}[arm],
                        code, runs, torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            times = kernel_ms(call)
            row[name] = {"kernel": sum(v for kk, v in times.items()
                                       if kk.startswith(f"fma_matmul_{arm}")),
                         "reduce": times.get("fma_matmul_splitk_reduce",
                                             0.0),
                         "queued": queued_ms(call)}
            if name == "full" and code == 0 and "load" not in rows:
                rows["load"] = {"full": under_load(call)}
    return rows


def _k2_rows(dev, libs):
    from torch.nn import functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    rows = {}
    for dtype, sq, h, hkv, d in ((torch.bfloat16, 512, 12, 2, 128),
                                 (torch.bfloat16, 1024, 12, 2, 128),
                                 (torch.float32, 512, 12, 2, 128),
                                 (torch.bfloat16, 1024, 32, 32, 96)):
        gen = torch.Generator(device=dev).manual_seed(sq)
        q, k, v = (torch.randn(1, n, sq, d, device=dev, generator=gen,
                               dtype=dtype) for n in (h, hkv, hkv))
        shape = "" if d == 128 else f" H {h} Hkv {hkv} D {d}"
        row = rows[f"{'f32' if dtype == torch.float32 else 'bf16'} "
                   f"Sq {sq}{shape}"] = {}
        for name, lib in libs.items():
            if dtype == torch.float32 and lib is not None:
                continue                # the cuts are in the bf16 kernel
            _use("flash_attention", lib)
            row[name] = queued_ms(lambda: flash_attention(q, k, v,
                                                          causal=True))
        row["sdpa"] = queued_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    return rows


def _k3_rows(dev, libs):
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_q8)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hkv, s, d = 8, 12, 2, 1024, 128
    q = torch.randn(b, h, d, device=dev, generator=gen, dtype=torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, device=dev, generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    kq, vq = (torch.randint(-127, 128, (b, hkv, s, d), device=dev,
                            generator=gen, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand(b, hkv, s, 1, device=dev, generator=gen) / 64
              for _ in range(2))
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024],
                        dtype=torch.int32, device=dev)
    calls = {
        "K3": lambda: decode_attention(q, k, v, lens),
        "K6a": lambda: decode_attention(q, k, v, lens, length_aware=False),
        "K5": lambda: decode_attention_q8(q, kq, ks, vq, vs, lens, qblock=1),
        "K6b": lambda: decode_attention_q8(q, kq, ks, vq, vs, lens, qblock=1,
                                           length_aware=False)}
    rows = {case: {} for case in calls}
    for name, lib in libs.items():
        _use("decode_attention_dense", lib)
        for case, call in calls.items():
            rows[case][name] = queued_ms(call)
    live = lens >= 1                        # SDPA: no dead lane
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[live]
    mask = mask[:, None, None, :].contiguous()
    ql, kl, vl = q[live][:, :, None].contiguous(), k[live], v[live]
    rows["K3"]["sdpa"] = rows["K6a"]["sdpa"] = queued_ms(
        lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                               enable_gqa=True))
    return rows


def _k1_rows(dev, libs):
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged, decode_attention_paged_q8, gather_pages)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hkv, d, ps, t = 8, 12, 2, 128, 16, 64
    n_pages = b * t + 1
    q = torch.randn(b, h, d, device=dev, generator=gen, dtype=torch.bfloat16)
    kp, vp = (torch.randn(n_pages, hkv, ps, d, device=dev, generator=gen,
                          dtype=torch.bfloat16) for _ in range(2))
    kq, vq = (torch.randint(-127, 128, (n_pages, hkv, ps, d), device=dev,
                            generator=gen, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand(n_pages, hkv, ps, 1, device=dev, generator=gen) / 64
              for _ in range(2))
    bt = torch.randperm(n_pages, device=dev, generator=gen)[:b * t]
    bt = bt.reshape(b, t).to(torch.int32)
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024],
                        dtype=torch.int32, device=dev)
    calls = {
        "K1": lambda: decode_attention_paged(q, kp, vp, bt, lens),
        "K4": lambda: decode_attention_paged_q8(q, kq, ks, vq, vs, bt, lens,
                                                qblock=1)}
    rows = {case: {} for case in calls}
    for name, lib in libs.items():
        _use("decode_attention_paged", lib)
        for case, call in calls.items():
            rows[case][name] = queued_ms(call)
    live = lens >= 1                        # SDPA: no dead lane
    mask = (torch.arange(t * ps, device=dev)[None, :] < lens[:, None])[live]
    mask = mask[:, None, None, :].contiguous()
    ql = q[live][:, :, None].contiguous()

    def gather_sdpa():
        return F.scaled_dot_product_attention(
            ql, gather_pages(kp, bt)[live], gather_pages(vp, bt)[live],
            attn_mask=mask, enable_gqa=True)
    rows["K1"]["gather+sdpa"] = queued_ms(gather_sdpa)
    return rows


def _k10_rows(dev, libs):
    import math
    from repro_torch.kernels.ssd_scan import ssd_chunk
    rows = {}
    for dtype, s in ((torch.bfloat16, 1024), (torch.bfloat16, 2048),
                     (torch.float32, 1024)):
        gen = torch.Generator(device=dev).manual_seed(s)
        x = torch.randn(1, s, 48, 64, device=dev, generator=gen)
        dt = torch.nn.functional.softplus(
            torch.randn(1, s, 48, device=dev, generator=gen)
            + math.log(math.expm1(0.01)))
        a = -torch.linspace(1.0, 16.0, 48, device=dev)
        b, c = (torch.randn(1, s, 128, device=dev, generator=gen)
                for _ in range(2))
        args = (x.to(dtype), dt, a, b.to(dtype), c.to(dtype))
        row = rows[f"{'f32' if dtype == torch.float32 else 'bf16'} "
                   f"S {s}"] = {}
        for name, lib in libs.items():
            _use("ssd_scan", lib)
            row[name] = queued_ms(lambda: ssd_chunk(*args, chunk=256))
    return rows


def _k7_rows(dev, libs):
    """K7 at both MLP shapes, M 128 and 8, f32 and bf16 x: ``full`` and
    ``before`` in every format and ``dot_i8``, the cuts at q4_k and
    ``dot_i8``; the route beside them."""
    from repro_torch.kernels.qmatmul import qmatmul_variant
    from repro_torch.quant import dequantize, quantize
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for (_, k, n), m, dtype in ((s, m, d) for s in MLP_SHAPES
                                for m in (128, 8)
                                for d in (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(k + m)
        w = torch.randn(k, n, device=dev, generator=gen)
        x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
        qts = {fmt: quantize(w, fmt) for fmt in ("q8_0", "q6_k", "q4_k",
                                                  "q2_k")}
        bk = 512 if k % 512 == 0 else 256       # the contract: bk | k
        calls = {f"dequant_dot {fmt}": (lambda qt=qt: qmatmul_variant(
            x, qt, variant="dequant_dot", bk=bk)) for fmt, qt in qts.items()}
        calls["dot_i8 q8_0"] = lambda: qmatmul_variant(
            x, qts["q8_0"], variant="dot_i8", bk=bk)
        tag = f"{'f32' if dtype == torch.float32 else 'bf16'} ({m},{k},{n})"
        for name, lib in libs.items():
            _use("qmatmul", lib)
            for case, call in calls.items():
                if lib is None or case in ("dequant_dot q4_k",
                                           "dot_i8 q8_0"):
                    rows.setdefault(f"{case} {tag}", {})[name] = \
                        queued_ms(call)
        for fmt, qt in qts.items():
            rows[f"dequant_dot {fmt} {tag}"]["route"] = queued_ms(
                lambda qt=qt: x.float() @ dequantize(qt))
        rows[f"dot_i8 q8_0 {tag}"]["route"] = \
            rows[f"dequant_dot q8_0 {tag}"]["route"]
        del w, qts
    return rows


def rows_of(target: str, dev, libs) -> dict:
    """{case: {variant or yardstick: ms}} of ``target``; ``libs`` maps
    each variant to its library, None for the library as built."""
    if target in ("mxu", "mul_add"):
        return _k9_rows(target, dev, libs)
    return {"k1": _k1_rows, "k2": _k2_rows, "k3": _k3_rows,
            "k7": _k7_rows, "k10": _k10_rows}[target](dev, libs)


def before_rows(target: str, tree: Path) -> dict:
    """``rows_of`` the package under ``tree`` as it is, named
    ``before``, from a child process whose imports resolve there."""
    env = {**os.environ, "PYTHONPATH": str(tree.resolve())}
    run = subprocess.run([sys.executable, "-P", __file__, "--target",
                          target, "--as-is"], env=env, stdout=subprocess.PIPE,
                         text=True, timeout=900)
    if run.returncode:
        raise RuntimeError(f"timing {tree} failed ({run.returncode})")
    return json.loads(run.stdout.strip().splitlines()[-1])


def _fmt(value) -> str:
    if isinstance(value, dict):
        return " / ".join(f"{k} {v:.5f}" for k, v in value.items())
    return value if isinstance(value, str) else f"{value:.5f}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--target", choices=sorted(TARGETS), default="mxu")
    p.add_argument("--before", type=Path, default=None,
                   help="the src of an earlier tree, timed as it is")
    p.add_argument("--only", default=None,
                   help="comma-separated cuts to build (full always runs)")
    p.add_argument("--as-is", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.as_is:
        print(json.dumps(rows_of(args.target, dev, {"before": None})))
        return 0
    variants = [v for v in TARGETS[args.target][1] if v != "full"]
    if args.only:
        variants = args.only.split(",")
    before = ({} if args.before is None
              else before_rows(args.target, args.before))
    libs = {"full": None, **build(args.target, variants)}
    rows = rows_of(args.target, dev, libs)
    for case, row in before.items():
        rows.setdefault(case, {}).update(row)
    for case, row in rows.items():
        print(f"[{args.target}] {case}: " + ", ".join(
            f"{name} {_fmt(v)}" for name, v in row.items()))
    card = smi("name,power.limit")
    print(card)
    print(json.dumps({"target": args.target, "card": card, "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
