"""What holds K9's weight stream back, read on the card.

``python -m repro_torch.kernels.fma_matmul.breakdown [--arm mxu|mul_add]``
(on a machine with the card) builds, with ``nvcc``, copies of
``csrc/fma_matmul.cu`` with parts of one arm's weight stream cut out.
For ``mxu`` (the default):

* ``full`` -- the kernel as it is;
* ``loads+stores`` -- no products: the TMA ring, and the stores of the
  (zero) accumulators to the output and the split-K workspace;
* ``loads`` -- neither products nor stores (products whose sums are
  never stored would be dropped by the compiler anyway);
* ``products+stores`` -- no copies: each stage's barrier is armed for
  no bytes and the products run on whatever the ring holds.

For ``mul_add``: ``full``; ``no products``; ``no copies`` (as above;
bf16 stages are still converted to f32, from whatever the ring holds);
``no piece stores`` -- the runs write no pieces of tiles to the
workspace (the reduce still adds what the workspace holds).

``--before SRC`` also builds another copy of the source as it is (an
earlier commit's ``fma_matmul.cu``) and times the same arm from it as
``before``, so two versions are compared in one run on one card;
``--only a,b`` builds only the named variants.

Each variant is timed at the qwen2.5-1.5b MLP shapes, in float32 and
bfloat16, twice: as device time per kernel from ``torch.profiler``
(the arm's kernel and the split-K reduce) and as device time per call
(CUDA events around 20 calls queued behind a busy-wait, so the host's
launch cost stays out).  Beside them stands ``torch.matmul``: TF32 for
``mxu``; for ``mul_add`` one float32 product with TF32 off, on float32
copies of the inputs.  Only ``full`` and ``before`` compute the
product.  Then ``nvidia-smi`` reads the SM clock, power and throttle
reasons after a second of back-to-back ``full`` calls at the first
float32 shape.  The last line is a JSON object of the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fma_matmul import ops

#: cut-out -> (text of csrc/fma_matmul.cu, its replacement)
_CUTS = {
    "products": ("for (int kk = 0; kk < kBK; kk += Stream<T>::kMmaK) {",
                 "for (int kk = 0; kk < 0; kk += Stream<T>::kMmaK) {"),
    "mul_add_products": ("for (int kq = 0; kq < kBK; kq += 4) {",
                         "for (int kq = 0; kq < 0; kq += 4) {"),
    "stores": ("      Arm::store(acc, p, whole ? N : SBN, M - m0, N - n0);",
               "      if (false)\n"
               "        Arm::store(acc, p, N, M - m0, N - n0);"),
    "piece_stores": ("      Arm::store(acc, p, whole ? N : SBN, M - m0, "
                     "N - n0);",
                     "      if (whole)\n"
                     "        Arm::store(acc, p, N, M - m0, N - n0);"),
    "w": ("      tma_load(st + b * BK * BOX, wmap, n0 + b * BOX, k0, bar, "
          "once);", "      ;"),
    "x": ("    tma_load(st + WSTAGE, xmap, k0, (tile / n_tiles) * SBM, bar, "
          "keep);", ""),
    "bytes": ("mbar_expect(bar, STAGE * (int)sizeof(T));",
              "mbar_expect(bar, 0);"),
}
#: arm -> variant -> the cuts it applies
VARIANTS = {
    "mxu": {"full": (),
            "loads+stores": ("products",),
            "loads": ("products", "stores"),
            "products+stores": ("w", "x", "bytes")},
    "mul_add": {"full": (),
                "no products": ("mul_add_products",),
                "no copies": ("w", "x", "bytes"),
                "no piece stores": ("piece_stores",)},
}
#: the C entry's code of each arm's weight stream
_CODE = {"mxu": 0, "mul_add": 1}
SHAPES = ((128, 1536, 8960), (128, 8960, 1536))


def build(name: str, cuts, source: Path = None) -> ctypes.CDLL:
    """``fma_matmul_fwd`` of the library of ``source`` (default
    ``csrc/fma_matmul.cu``) with ``cuts`` applied."""
    text = (source or _build.CSRC / "fma_matmul.cu").read_text()
    for cut in cuts:
        old, new = _CUTS[cut]
        if text.count(old) != 1:
            raise RuntimeError(f"cut {cut!r} no longer matches the source")
        text = text.replace(old, new)
    out = _build.build_dir() / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    slug = re.sub(r"\W", "_", name)
    src, lib = out / f"{slug}.cu", out / f"lib{slug}.so"
    src.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).fma_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arm", choices=sorted(VARIANTS), default="mxu")
    p.add_argument("--before", type=Path, default=None,
                   help="another fma_matmul.cu, timed as it is")
    p.add_argument("--only", default=None,
                   help="comma-separated variants to build")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    arm = args.arm
    torch.backends.cuda.matmul.allow_tf32 = arm == "mxu"
    variants = VARIANTS[arm]
    if args.only:
        variants = {v: variants[v] for v in args.only.split(",")}
    libs = {}
    if args.before is not None:
        libs["before"] = build(f"{arm}_before", (), args.before)
    libs.update({name: build(f"{arm}_{name}", cuts)
                 for name, cuts in variants.items()})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {}
    for (m, k, n), dtype in ((s, d) for s in SHAPES
                             for d in (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
        w = torch.randn(k, n, device=dev, generator=gen).to(dtype)
        runs, slots = ops.stream_plan(m, k, n, dtype, sms, arm)
        out = torch.empty(m, n, device=dev)
        ws = torch.empty(slots, min(m, ops.STREAM_BM), ops.STREAM_BN,
                         device=dev)
        code = 0 if dtype == torch.float32 else 1
        key = f"{'f32' if code == 0 else 'bf16'} ({m},{k},{n})"
        xl, wl = (x, w) if arm == "mxu" else (x.float(), w.float())
        row = {"torch.matmul": queued_ms(lambda: torch.matmul(xl, wl))}
        calls = {}
        for name, fn in libs.items():
            def call(fn=fn, name=name):
                rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                        ws.data_ptr(), m, k, n, _CODE[arm], code, runs,
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            calls[name] = call
            times = kernel_ms(call)
            row[name] = {"kernel": sum(v for kk, v in times.items()
                                       if kk.startswith(f"fma_matmul_{arm}")),
                         "reduce": times.get("fma_matmul_splitk_reduce",
                                             0.0),
                         "queued": queued_ms(call)}
        result[key] = row
        print(f"[breakdown] {arm} {key}: " + ", ".join(
            f"{name} {v:.4f}" if isinstance(v, float) else
            f"{name} {v['kernel']:.4f} + reduce {v['reduce']:.4f} "
            f"(queued {v['queued']:.4f})"
            for name, v in row.items()) + " ms")
        if "full" in calls and code == 0 and "load" not in result:
            result["load"] = under_load(calls["full"])
            print(f"[breakdown] {arm} {key} full, after 1 s of calls: "
                  f"{result['load']}")
    print(smi("name,power.limit"))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
