"""What holds K9's weight stream back, read on the card.

``python -m repro_torch.kernels.fma_matmul.breakdown`` (on a machine
with the card) builds, with ``nvcc``, copies of ``csrc/fma_matmul.cu``
with parts of the ``mxu`` weight stream cut out:

* ``full`` -- the kernel as it is;
* ``loads+stores`` -- no products: the TMA ring, and the stores of the
  (zero) accumulators to the output and the split-K workspace;
* ``loads`` -- neither products nor stores (products whose sums are
  never stored would be dropped by the compiler anyway);
* ``products+stores`` -- no copies: each stage's barrier is armed for
  no bytes and the products run on whatever the ring holds;

and times each at the qwen2.5-1.5b MLP shapes, in float32 and
bfloat16, as device time per kernel from ``torch.profiler`` beside the
split-K reduce and ``torch.matmul``.  Only ``full`` computes the
product.  The last line is a JSON object of the times.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fma_matmul import ops

#: cut-out -> (text of csrc/fma_matmul.cu, its replacement)
_CUTS = {
    "products": ("for (int kk = 0; kk < BK; kk += Stream<T>::kMmaK) {",
                 "for (int kk = 0; kk < 0; kk += Stream<T>::kMmaK) {"),
    "stores": ("      if (whole)\n        store_block(",
               "      if (whole && false)\n        store_block("),
    "stores2": ("      else\n        store_block(",
                "      else if (false)\n        store_block("),
    "w": ("      tma_load(st + b * BK * BOX, wmap, n0 + b * BOX, k0, bar, "
          "once);", "      ;"),
    "x": ("    tma_load(st + WSTAGE, xmap, k0, (tile / n_tiles) * SBM, bar, "
          "keep);", ""),
    "bytes": ("mbar_expect(bar, STAGE * (int)sizeof(T));",
              "mbar_expect(bar, 0);"),
}
VARIANTS = {"full": (),
            "loads+stores": ("products",),
            "loads": ("products", "stores", "stores2"),
            "products+stores": ("w", "x", "bytes")}
SHAPES = ((128, 1536, 8960), (128, 8960, 1536))


def build(name: str, cuts) -> ctypes.CDLL:
    """The library of the source with ``cuts`` applied."""
    text = (_build.CSRC / "fma_matmul.cu").read_text()
    for cut in cuts:
        old, new = _CUTS[cut]
        if text.count(old) != 1:
            raise RuntimeError(f"cut {cut!r} no longer matches the source")
        text = text.replace(old, new)
    out = _build.build_dir() / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"lib{name}.so"
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


def main() -> int:
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = True
    libs = {name: build(name.replace("+", "_"), cuts)
            for name, cuts in VARIANTS.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {}
    for (m, k, n), dtype in ((s, d) for s in SHAPES
                             for d in (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
        w = torch.randn(k, n, device=dev, generator=gen).to(dtype)
        runs, slots = ops.stream_plan(m, k, n, dtype, sms)
        out = torch.empty(m, n, device=dev)
        ws = torch.empty(slots, min(m, ops.STREAM_BM), ops.STREAM_BN,
                         device=dev)
        code = 0 if dtype == torch.float32 else 1
        key = f"{'f32' if code == 0 else 'bf16'} ({m},{k},{n})"
        row = {"torch.matmul": sum(kernel_ms(
            lambda: torch.matmul(x, w)).values())}
        for name, fn in libs.items():
            def call(fn=fn):
                rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                        ws.data_ptr(), m, k, n, 0, code, runs,
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            times = kernel_ms(call)
            row[name] = {"stream": sum(v for kk, v in times.items()
                                       if kk.startswith("fma_matmul_mxu")),
                         "reduce": times.get("fma_matmul_splitk_reduce",
                                             0.0)}
        result[key] = row
        print(f"[breakdown] {key}: " + ", ".join(
            f"{name} {v:.4f}" if isinstance(v, float) else
            f"{name} {v['stream']:.4f} + reduce {v['reduce']:.4f}"
            for name, v in row.items()) + " ms")
    print(torch.cuda.get_device_name(0))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
