"""The port's serving launcher against the reference's: ``--profile``
names a device profile and the closing line is the reference's
capability-model prediction, computed by the port's copy of
``core.perf_model``; ``--trace`` writes the ``torch.profiler`` trace.

The perf model is plain Python arithmetic on the same profile tables,
so the port's copy must equal the reference's exactly, field for
field, for every profile and format.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import perf_model as jax_perf_model  # noqa: E402
from repro.core.device_profile import PROFILES as JAX_PROFILES  # noqa: E402
from repro_torch.core import PROFILES, perf_model  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

FORMATS = ("f16", "bf16", "f32", "q8_0", "q6_k", "q4_k", "q2_k")


def _phase(model, phase, fmt):
    """(PhaseEstimate fields, None) or (None, the error's text)."""
    try:
        return dataclasses.astuple(getattr(model, phase)(fmt)), None
    except ValueError as e:
        return None, str(e)


def test_profiles_are_the_reference_profiles():
    assert sorted(PROFILES) == sorted(JAX_PROFILES)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_perf_model_equals_reference(name, fmt):
    ours = perf_model.InferencePerfModel(PROFILES[name])
    ref = jax_perf_model.InferencePerfModel(JAX_PROFILES[name])
    for phase in ("prefill", "decode"):
        got, want = _phase(ours, phase, fmt), _phase(ref, phase, fmt)
        assert got == want, (name, fmt, phase)
        if got[0] is not None:
            est = getattr(ours, phase)(fmt)
            assert est.tokens_per_s > 0 and est.watts > 0
    assert perf_model.f32_epilogue_ops_per_weight(fmt) == \
        jax_perf_model.f32_epilogue_ops_per_weight(fmt)


def test_perf_model_sweep_and_spec_equal_reference():
    assert dataclasses.astuple(perf_model.QWEN25_1P5B) == \
        dataclasses.astuple(jax_perf_model.QWEN25_1P5B)
    ours = perf_model.sweep([PROFILES[n] for n in sorted(PROFILES)])
    ref = jax_perf_model.sweep([JAX_PROFILES[n] for n in sorted(PROFILES)])
    flat = {p: {f: {ph: dataclasses.astuple(e) for ph, e in d.items()}
                for f, d in fm.items()} for p, fm in ours.items()}
    flat_ref = {p: {f: {ph: dataclasses.astuple(e) for ph, e in d.items()}
                    for f, d in fm.items()} for p, fm in ref.items()}
    assert flat == flat_ref


def _reference_line(arch, profile):
    """The reference launcher's closing line for ``arch`` (SMOKE) on
    ``profile``, computed through the reference's own perf model."""
    cfg = jax_get_config(arch, smoke=True)
    prof = JAX_PROFILES[profile]
    spec = jax_perf_model.LLMSpec(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size, tied_embeddings=cfg.tie_embeddings)
    m = jax_perf_model.InferencePerfModel(prof, spec)
    return (f"capability-model prediction on {prof.name}: "
            f"prefill {m.prefill('f16').tokens_per_s:,.0f} tok/s, "
            f"decode {m.decode('f16').tokens_per_s:,.0f} tok/s (f16)")


@pytest.mark.parametrize("profile", [None, "tpu-v5e", "cmp-170hx"])
def test_launcher_prints_the_reference_prediction(profile, capsys,
                                                  tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--smoke", "--device", "cpu", "--requests", "1", "--gen", "2"]
    if profile is not None:
        argv += ["--profile", profile]
    serve_launcher.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == _reference_line("qwen2.5-1.5b",
                                        profile or "tpu-v5e")
    assert "profile: device busy" not in "\n".join(lines)
    assert list(tmp_path.iterdir()) == []       # no trace was written


def test_launcher_prediction_for_the_ssm_family(capsys):
    serve_launcher.main(["--arch", "mamba2-780m", "--smoke", "--device",
                         "cpu", "--requests", "1", "--prompt-len", "8",
                         "--gen", "2", "--profile", "a100-40g"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == _reference_line("mamba2-780m", "a100-40g")


def test_launcher_trace_writes_the_trace(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / "t.json"
    serve_launcher.main(["--smoke", "--device", "cpu", "--requests", "1",
                         "--gen", "2", "--profile", "tpu-v5e", "--trace",
                         str(trace)])
    out = capsys.readouterr().out
    assert trace.is_file() and trace.stat().st_size > 0
    assert "profile: device busy" in out
    assert f"trace {trace}" in out
    assert out.splitlines()[-1] == _reference_line("qwen2.5-1.5b",
                                                   "tpu-v5e")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["t.json"]
    assert not (tmp_path / "tpu-v5e").exists()
