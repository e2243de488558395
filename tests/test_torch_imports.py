"""Guards of the port: no JAX and nothing of the reference package at
runtime, the CUDA default without a silent CPU fallback, and no kernel
launch from a CPU call."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import DeviceUnavailable, resolve_device  # noqa: E402
from repro_torch.kernels import (launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for m in ('serving.engine', 'rng', 'kernels.decode_attention.ops',\n"
        "          'core.device_profile', 'core.compute_path',\n"
        "          'core.perf_model', 'launch.serve',\n"
        "          'quant.formats', 'quant.quantize', 'kernels.mixbench.ops',\n"
        "          'kernels.fma_matmul.ops', 'kernels.qmatmul.ops',\n"
        "          'kernels.mixbench.check', 'kernels._sass',\n"
        "          'kernels.ssd_scan.ops', 'kernels.ssd_scan.ref',\n"
        "          'models.ssm', 'configs.mamba2_780m',\n"
        "          'configs.hymba_1_5b', 'serving.prefix_cache',\n"
        "          'configs.olmo_1b', 'configs.mistral_nemo_12b',\n"
        "          'configs.qwen2_5_32b', 'configs.qwen1_5_110b',\n"
        "          'obs.metrics', 'obs.trace', 'obs.events', 'obs.flight',\n"
        "          'obs.requests', 'obs.slo', 'obs.schema', 'obs.dump',\n"
        "          'serving.resilience', 'analysis.sanitizer',\n"
        "          'analysis.interleave', 'core.energy',\n"
        "          'serving.phase_model', 'serving.modelpool',\n"
        "          'fleet', 'fleet.workload', 'fleet.faults',\n"
        "          'fleet.execution', 'obs.calibration', 'models.moe',\n"
        "          'models.whisper', 'models.mlp', 'models.registry',\n"
        "          'configs.moonshot_v1_16b_a3b', 'configs.arctic_480b',\n"
        "          'configs.phi_3_vision_4_2b', 'configs.whisper_base'):\n"
        "    assert 'repro_torch.' + m in names, names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 82


def test_no_source_names_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert bad == []


def test_default_device_is_cuda_without_fallback():
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), cpu)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(DeviceUnavailable):
        resolve_device(None)
    with pytest.raises(DeviceUnavailable):
        ServeEngine(cfg, params)
    assert resolve_device("cpu") == cpu


def test_cpu_serving_launches_no_kernel():
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), cpu)
    reset_launch_counts()
    for paged, kv_quant in ((False, None), (True, None), (False, "int8"),
                            (True, "int8")):
        eng = ServeEngine(dataclasses.replace(cfg, kv_quant=kv_quant),
                          params, n_lanes=2, max_len=32, paged=paged,
                          page_size=8, temperature=0.5 * paged,
                          device="cpu")
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 9 + i
                                                   ).astype(np.int32),
                        max_new_tokens=4) for i in range(3)]
        eng.run(reqs)
        assert all(len(r.generated) == 4 for r in reqs)
    for arch in ("mamba2-780m", "hymba-1.5b"):
        ssm = get_config(arch, smoke=True)
        ssm_params = build_model(ssm).init(torch.Generator().manual_seed(0),
                                           cpu)
        for paged in (False, True):
            eng = ServeEngine(ssm, ssm_params, n_lanes=2, max_len=32,
                              paged=paged, page_size=8, device="cpu")
            reqs = [Request(uid=i, prompt=np.arange(5 + i, dtype=np.int32),
                            max_new_tokens=4) for i in range(3)]
            eng.run(reqs)
            assert all(len(r.generated) == 4 for r in reqs)
        build_model(ssm).forward(ssm_params,
                                 torch.zeros((1, 40), dtype=torch.int32))
    assert launch_counts() == {"decode_attention_paged": 0,
                               "decode_attention_lengthaware": 0,
                               "decode_attention_masked": 0,
                               "decode_attention_paged_q8": 0,
                               "decode_attention_q8_lengthaware": 0,
                               "decode_attention_q8_masked": 0,
                               "flash_attention_mma": 0,
                               "flash_attention_cc": 0,
                               "mixbench_fma": 0,
                               "mixbench_mul_add": 0,
                               "fma_matmul_mxu": 0,
                               "fma_matmul_mxu_wmma": 0,
                               "fma_matmul_mul_add": 0,
                               "fma_matmul_mul_add_staged": 0,
                               "qmatmul_dequant_dot": 0,
                               "qmatmul_dot_i8": 0,
                               "ssd_chunk": 0}
