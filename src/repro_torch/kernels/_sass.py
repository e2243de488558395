"""The paper's ``-fmad=false``, and which kernels use the tensor cores,
checked on the instructions.

``cuobjdump -sass`` of the built mixbench (K8), fma_matmul (K9),
flash_attention (K2), decode_attention_dense (K3/K5/K6a/K6b),
decode_attention_paged (K1/K4) and ssd_scan (K10) libraries is read
kernel by kernel and the floating-point instructions counted by
class.  :func:`sass_report` applies the rules: no FFMA,
HFMA2 or HMMA in a ``mul_add`` kernel (K8's, and K9's weight stream and
staged kernel) and its multiplies and adds present; the same in K9's
split-K reduce, which the ``mul_add`` stream launches too and which has
adds alone; FFMA (HFMA2) in K8's ``fma`` kernels; HMMA in every one of
K9's ``mxu`` kernels (the weight stream's ``mma.sync`` and the WMMA
kernel's), in K2's bf16 tensor-core kernels and in both of K10's
kernels (C.B^T and the per-head products); no HMMA and no HGMMA in
K2's CUDA-core kernels and in the dense and paged decode kernels
(one split-KV body), whose f32 arithmetic stays off the tensor cores;
in qmatmul (K7) HMMA in every ``dequant_dot`` kernel (bf16 products of
integer weights), IMMA in every ``dot_i8`` kernel (int8 products) and
no IDP.4A (``__dp4a``) left in one.  ``chip_smoke.py`` and the
cuda-marked test both call it.  Nothing runs at import.
"""

from __future__ import annotations

import collections
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import _build

__all__ = ["SASS_KERNELS", "SASS_LIBS", "check_counts", "cuobjdump", "kernel_counts",
           "parse_sass", "sass_counts", "sass_report"]

SASS_KERNELS = ("mixbench_f32_fma", "mixbench_bf16_fma",
                "mixbench_f32_mul_add", "mixbench_bf16_mul_add",
                "fma_matmul_mxu_f32", "fma_matmul_mxu_bf16",
                "fma_matmul_mxu_wmma_f32", "fma_matmul_mxu_wmma_bf16",
                "fma_matmul_mul_add_f32", "fma_matmul_mul_add_bf16",
                "fma_matmul_mul_add_staged_f32",
                "fma_matmul_mul_add_staged_bf16",
                "fma_matmul_splitk_reduce",
                "flash_attention_mma_bf16_d64",
                "flash_attention_mma_bf16_d128",
                "flash_attention_cc_f32_d32", "flash_attention_cc_f32_d64",
                "flash_attention_cc_f32_d96", "flash_attention_cc_f32_d128",
                "flash_attention_cc_f32_d256", "flash_attention_cc_bf16_d32",
                "flash_attention_cc_bf16_d96", "flash_attention_cc_bf16_d256",
                "decode_dense_f32", "decode_dense_bf16",
                "decode_dense_masked_f32", "decode_dense_masked_bf16",
                "decode_dense_q8_f32", "decode_dense_q8_bf16",
                "decode_dense_q8_masked_f32", "decode_dense_q8_masked_bf16",
                "decode_paged_f32", "decode_paged_bf16",
                "decode_paged_q8_f32", "decode_paged_q8_bf16",
                "ssd_cb_f32", "ssd_cb_bf16", "ssd_chunk_f32",
                "ssd_chunk_bf16") + tuple(
    f"qmatmul_dequant_dot_{fmt}_{dtype}_m{rows}{copy}"
    for fmt in ("q8_0", "q6_k", "q4_k", "q2_k")
    for dtype in ("f32", "bf16") for rows in (16, 128)
    for copy in ("", "_plain")) + tuple(
    f"qmatmul_dot_i8_m{rows}{copy}" for rows in (16, 128)
    for copy in ("", "_plain"))
#: the libraries whose kernels SASS_KERNELS names
SASS_LIBS = ("mixbench", "fma_matmul", "flash_attention",
             "decode_attention_dense", "decode_attention_paged",
             "ssd_scan", "qmatmul")


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump``, else Triton's copy."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [Path("/usr/local/cuda/bin/cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        for loc in spec.submodule_search_locations:
            cands.append(Path(loc) / "backends" / "nvidia" / "bin" /
                         "cuobjdump")
    for c in cands:
        if c.exists():
            return str(c)
    raise FileNotFoundError("cuobjdump not found: the instruction check "
                            "cannot run")


def parse_sass(text: str) -> Dict[str, collections.Counter]:
    """{kernel symbol: Counter of instruction classes} from the text of
    ``cuobjdump -sass``.  ``hmma`` counts ``mma.sync`` (HMMA), ``hgmma``
    ``wgmma`` (HGMMA), ``imma`` integer ``mma.sync`` (IMMA), ``idp``
    ``__dp4a`` (IDP.4A).  ``fma`` counts FFMA and HFMA2 except the
    ``HFMA2.MMA Rd, -RZ, RZ, c`` form, which computes -0 * 0 + c: a
    constant move ptxas issues on that pipe, counted as ``mov``."""
    counts, func = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if not (m and func):
            continue
        op, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
        c = counts[func]
        if op.startswith(("FFMA", "HFMA2")):
            if op.startswith("HFMA2") and args[1:3] == ["-RZ", "RZ"]:
                c["mov"] += 1
            else:
                c["fma"] += 1
        elif op.startswith(("FMUL", "HMUL2")):
            c["mul"] += 1
        elif op.startswith(("FADD", "HADD2")):
            c["add"] += 1
        elif op.startswith("HMMA"):
            c["hmma"] += 1
        elif op.startswith("HGMMA"):
            c["hgmma"] += 1
        elif op.startswith("IMMA"):
            c["imma"] += 1
        elif op.startswith("IDP"):
            c["idp"] += 1
    return counts


def sass_counts(lib) -> Dict[str, collections.Counter]:
    """:func:`parse_sass` of one built library."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return parse_sass(text)


def check_counts(found: Dict[str, dict]) -> List[str]:
    """The rules above applied to {kernel: counts}; one line per
    breach, and one per kernel of SASS_KERNELS that is missing."""
    problems = [f"{k}: not found" for k in SASS_KERNELS if k not in found]
    for kern, c in found.items():
        if "mul_add" in kern:
            if c.get("fma", 0) or c.get("hmma", 0) or not (
                    c.get("mul", 0) and c.get("add", 0)):
                problems.append(f"{kern} is not a separate multiply and "
                                f"add: {c}")
        elif kern == "fma_matmul_splitk_reduce":
            if c.get("fma", 0) or c.get("hmma", 0) or not c.get("add", 0):
                problems.append(f"{kern} is not plain adds: {c}")
        elif kern.startswith(("flash_attention_cc", "decode_dense",
                              "decode_paged")):
            if c.get("hmma", 0) or c.get("hgmma", 0):
                problems.append(f"{kern} runs on the tensor cores: {c}")
        elif kern.startswith(("flash_attention_mma", "ssd_")) and \
                not c.get("hmma", 0):
            problems.append(f"{kern} does not use the tensor cores: {c}")
        elif kern.startswith("qmatmul_dequant_dot") and \
                not c.get("hmma", 0):
            problems.append(f"{kern} does not use the tensor cores: {c}")
        elif kern.startswith("qmatmul_dot_i8") and (
                not c.get("imma", 0) or c.get("idp", 0)):
            problems.append(f"{kern} is not on the int8 tensor cores: {c}")
        elif kern.startswith("mixbench") and not c.get("fma", 0):
            problems.append(f"{kern} has no fused multiply-add: {c}")
        elif kern.startswith("fma_matmul") and not c.get("hmma", 0):
            problems.append(f"{kern} does not use the tensor cores: {c}")
    return problems


def kernel_counts(by_symbol: Dict[str, collections.Counter]
                  ) -> Dict[str, dict]:
    """{kernel of SASS_KERNELS: counts} from {mangled symbol: counts}."""
    return {kern: dict(c) for sym, c in by_symbol.items()
            for kern in SASS_KERNELS if re.search(rf"\d{kern}E", sym)}


def sass_report() -> Tuple[Dict[str, dict], List[str]]:
    """({kernel: counts}, [problems]) for the built libraries of
    SASS_LIBS (build them first)."""
    found = {}
    for lib in SASS_LIBS:
        found.update(kernel_counts(sass_counts(_build._lib_path(lib))))
    return found, check_counts(found)
