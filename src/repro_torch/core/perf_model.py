"""First-principles inference performance model (paper C3 + C4).

Reproduces the paper's llama-bench evaluation (Graphs 4-1/4-2/4-3)
analytically from the :class:`~repro.core.device_profile.DeviceProfile`
capability tables.  The model captures the *mechanisms* the paper
identifies rather than curve-fitting individual bars:

1. **F32/F16 models** run their GEMMs in the vendor BLAS (pre-built
   binary) -> insensitive to the ``-fmad=false`` recompile.  The paper's
   "f32/f16 models showed no performance gains" falls out of
   ``profile.blas_tflops``.
2. **Quantized models** run llama.cpp's own kernels: bulk MACs on a
   BLAS-class f16 path after dequant (prompt batches) while the
   per-sub-block **scale/min epilogue runs on the FP32 path** -- the path
   the SKU throttles.  Disabling FMA reroutes that epilogue
   (0.39 -> 6.2 TFLOPS), so the quantized formats speed up and the
   smallest sub-blocks (Q2_K: 16-wide, asymmetric) gain the most --
   the paper's 2.31x.
3. **Decode** adds the memory term: every active weight byte streams once
   per token.  On the default build the FP32 epilogue can exceed the
   memory time for low-bit formats (=> noFMA lifts Q6/Q4/Q2 decode but
   not F32/F16/Q8, as observed).
4. **Theoretical ceilings** follow the paper's own scaling formulas:
   prefill ~ A100 x (70/108 SMs), decode ~ A100 x (1493/1555 GB/s).

Calibration constants (framework efficiency, epilogue ops/sub-block) are
documented inline; EXPERIMENTS.md validates the resulting predictions
against every *stated* claim band of the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.core.device_profile import (A100_40G, DeviceProfile, Path)
from repro_torch.quant.formats import DENSE_BPW, FORMATS, bytes_per_weight


# ----------------------------------------------------------------------
# Workload description
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLMSpec:
    """Minimal architecture facts the model needs (paper: Qwen2.5-1.5B)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    tied_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def params_nonembed(self) -> float:
        L, d, f = self.n_layers, self.d_model, self.d_ff
        kv = self.n_kv_heads * self.head_dim
        attn = d * d + 2 * d * kv + d * d          # q, k, v, o projections
        mlp = 3 * d * f                            # SwiGLU gate/up/down
        return float(L * (attn + mlp))

    @property
    def params_embed(self) -> float:
        n = self.d_model * self.vocab_size
        return float(n if self.tied_embeddings else 2 * n)

    @property
    def params_total(self) -> float:
        return self.params_nonembed + self.params_embed

    @property
    def active_weights(self) -> float:
        """Weights touched per token: blocks + the LM head (tied: read once)."""
        return self.params_nonembed + self.d_model * self.vocab_size

    def kv_bytes_per_token(self, kv_bytes: float = 2.0) -> float:
        return 2.0 * self.n_layers * self.n_kv_heads * self.head_dim * kv_bytes


# Paper section 4.1: Qwen2.5-1.5B (28L, d1536, 12Q/2KV GQA, tied emb).
QWEN25_1P5B = LLMSpec(
    name="qwen2.5-1.5b", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab_size=151936, tied_embeddings=True)

# Sibling of the paper's model, one size down (24L, d896, 14Q/2KV GQA):
# the second tenant in the multi-model serving experiments -- small
# enough that two models' weights plausibly share an 8 GB board.
QWEN25_0P5B = LLMSpec(
    name="qwen2.5-0.5b", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_ff=4864, vocab_size=151936, tied_embeddings=True)


# ----------------------------------------------------------------------
# Format -> path decomposition
# ----------------------------------------------------------------------

#: FP32 scale/min ops per sub-block element in a quantized kernel.  One
#: scale multiply + bookkeeping (symmetric), plus min-offset madd work
#: for asymmetric formats.  Calibrated (3.0 asym) against the paper's
#: "Q2_K prefill reaches 231% of the default-build rate".
_EPI_OPS_SYM = 2.0
_EPI_OPS_ASYM = 3.5


def f32_epilogue_ops_per_weight(fmt: str) -> float:
    if fmt in DENSE_BPW:
        return 0.0
    f = FORMATS[fmt]
    sub = f.sub_block or f.block
    return (_EPI_OPS_ASYM if f.asymmetric else _EPI_OPS_SYM) / sub


@dataclasses.dataclass(frozen=True)
class PhaseEstimate:
    tokens_per_s: float
    t_mac_s: float          # bulk MAC time per token
    t_epilogue_s: float     # f32 scale/min path time per token
    t_memory_s: float       # HBM streaming time per token
    bound: str              # "compute" | "memory"
    watts: float
    tokens_per_joule: float


class InferencePerfModel:
    """Predicts llama-bench prefill/decode throughput on a profile."""

    #: quantized-kernel MAC efficiency relative to the f16 BLAS rate
    #: (dequant-in-kernel overhead).
    QUANT_MAC_EFF = 0.85
    #: Per-op dynamic energy (pJ) by path; MUL_ADD issues 2 instructions.
    # System-level energy/op (~TDP/peak): FMA 20 pJ; the mul+add reroute
    # issues two instructions (~45 pJ) -- why the paper sees the noFMA
    # build trade efficiency for speed.  Matrix/integer engines are
    # cheaper per op.
    ENERGY_PJ = {Path.FMA: 20.0, Path.TENSOR: 3.5,
                 Path.MUL_ADD: 45.0, Path.DOT_I8: 6.0}
    #: decode GEMV re-uses unpacked scales across the activation row;
    #: its f32 epilogue is ~half the prefill epilogue per weight.
    DECODE_EPI_FACTOR = 0.6
    #: static/HBM power as a fraction of TDP.
    IDLE_FRACTION = 0.35

    def __init__(self, profile: DeviceProfile, spec: LLMSpec = QWEN25_1P5B):
        self.profile = profile
        self.spec = spec

    # ------------------------------------------------------------------
    def _f32_build_tput(self) -> float:
        path = self.profile.build_paths.get("f32", Path.FMA)
        return self.profile.throughput("f32", path)

    def _mac_tflops(self, fmt: str) -> float:
        """Effective TF of the bulk MAC path for a model format."""
        prof = self.profile
        if fmt == "f32":
            return prof.blas_tflops.get("f32", self._f32_build_tput())
        if fmt in ("f16", "bf16"):
            return prof.blas_tflops.get(
                "f16", prof.blas_tflops.get("bf16", 0.0)) or \
                prof.throughput("f16", prof.build_paths.get("f16", Path.FMA))
        # quantized: dequant + f16-class GEMM (llama.cpp prompt path)
        base = prof.blas_tflops.get("f16", 0.0) or prof.throughput(
            "f16", prof.build_paths.get("f16", Path.FMA))
        return base * self.QUANT_MAC_EFF

    def _per_token(self, fmt: str, context: int):
        spec, prof = self.spec, self.profile
        macs = spec.active_weights
        mac_tf = self._mac_tflops(fmt)
        if mac_tf <= 0:
            raise ValueError(f"{prof.name} has no MAC path for {fmt!r}")
        t_mac = 2.0 * macs / (mac_tf * 1e12)
        epi_ops = f32_epilogue_ops_per_weight(fmt) * macs
        f32_tf = self._f32_build_tput()
        t_epi = epi_ops / (f32_tf * 1e12) if epi_ops else 0.0
        w_bytes = macs * bytes_per_weight(fmt)
        kv_read = spec.kv_bytes_per_token() * context
        t_mem = (w_bytes + kv_read) / (prof.hbm_bw_gbps * 1e9
                                       * prof.gemv_efficiency)
        return t_mac, t_epi, t_mem, epi_ops, macs

    def _power(self, ops_by_path: Dict[Path, float], t_total: float) -> float:
        tdp = self.profile.tdp_watts
        dyn = sum(self.ENERGY_PJ.get(p, 1.0) * 1e-12 * n
                  for p, n in ops_by_path.items())
        return min(tdp, self.IDLE_FRACTION * tdp + dyn / max(t_total, 1e-12))

    def _mac_power_path(self, fmt: str) -> Path:
        if fmt in DENSE_BPW:
            return self.profile.build_paths.get(
                "f16" if fmt != "f32" else "f32", Path.FMA)
        return Path.DOT_I8 if ("i8", Path.DOT_I8) in self.profile.peak \
            else Path.FMA

    # -- phases ---------------------------------------------------------
    def prefill(self, fmt: str, prompt_len: int = 512,
                batch: int = 1) -> PhaseEstimate:
        """Compute-bound: all prompt tokens processed in parallel."""
        t_mac, t_epi, t_mem, epi_ops, macs = self._per_token(
            fmt, context=prompt_len // 2)
        n_tok = prompt_len * batch
        t_compute = (t_mac + t_epi) * n_tok
        t_total = max(t_compute, t_mem)   # weights stream once per pass
        tps = n_tok / t_total
        f32_path = self.profile.build_paths.get("f32", Path.FMA)
        watts = self._power({self._mac_power_path(fmt): 2 * macs * n_tok,
                             f32_path: epi_ops * n_tok}, t_total)
        return PhaseEstimate(
            tokens_per_s=tps, t_mac_s=t_mac, t_epilogue_s=t_epi,
            t_memory_s=t_mem, watts=watts, tokens_per_joule=tps / watts,
            bound="compute" if t_compute >= t_mem else "memory")

    def _decode_mac_tflops(self, fmt: str) -> float:
        """GEMV MAC path: quantized formats use the int8 dp4a vec_dot."""
        prof = self.profile
        if fmt in DENSE_BPW:
            return self._mac_tflops(fmt)
        i8 = prof.throughput("i8", Path.DOT_I8)
        return i8 if i8 > 0 else self._mac_tflops(fmt)

    def decode(self, fmt: str, context: int = 640,
               batch: int = 1) -> PhaseEstimate:
        """Memory-bound: every active weight byte streamed per token."""
        t_mac, t_epi, t_mem, epi_ops, macs = self._per_token(fmt, context)
        t_mac = 2.0 * macs / (self._decode_mac_tflops(fmt) * 1e12)
        t_epi = t_epi * self.DECODE_EPI_FACTOR
        epi_ops = epi_ops * self.DECODE_EPI_FACTOR
        t_compute = (t_mac + t_epi)
        t_total = max(t_compute, t_mem)
        tps = batch / t_total
        f32_path = self.profile.build_paths.get("f32", Path.FMA)
        watts = self._power({self._mac_power_path(fmt): 2 * macs,
                             f32_path: epi_ops}, t_total)
        return PhaseEstimate(
            tokens_per_s=tps, t_mac_s=t_mac, t_epilogue_s=t_epi,
            t_memory_s=t_mem, watts=watts, tokens_per_joule=tps / watts,
            bound="compute" if t_compute >= t_mem else "memory")

    # -- the paper's theoretical scalings --------------------------------
    def theoretical_prefill_tps(self, fmt: str, prompt_len: int = 512) -> float:
        """Paper eq. 4.2: A100-measured x (SMs_d / SMs_o) = x 70/108."""
        a100 = InferencePerfModel(A100_40G, self.spec)
        return a100.prefill(fmt, prompt_len).tokens_per_s * (70.0 / 108.0)

    def theoretical_decode_tps(self, fmt: str, context: int = 640) -> float:
        """Paper eq. 4.3: A100-measured x (bw_d / bw_o) = x 1493/1555."""
        a100 = InferencePerfModel(A100_40G, self.spec)
        return a100.decode(fmt, context).tokens_per_s * (1493.0 / 1555.0)


def sweep(profiles: Iterable[DeviceProfile],
          fmts: Iterable[str] = ("f32", "f16", "q8_0", "q6_k", "q4_k", "q2_k"),
          spec: LLMSpec = QWEN25_1P5B,
          ) -> Dict[str, Dict[str, Dict[str, PhaseEstimate]]]:
    """The full Graph 4-1/4-2 grid: profile x format x phase."""
    out: Dict[str, Dict[str, Dict[str, PhaseEstimate]]] = {}
    for prof in profiles:
        m = InferencePerfModel(prof, spec)
        out[prof.name] = {
            fmt: {"prefill": m.prefill(fmt), "decode": m.decode(fmt)}
            for fmt in fmts}
    return out
