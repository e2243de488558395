"""Quantized-weight serving of the port against the reference's.

* ``quantize_params`` quantizes exactly the reference's leaves: the
  rule runs on the reference's tree, where block weights are stacked
  ``(L, k, n)`` and stay dense, so SMOKE qwen2.5-1.5b and olmo-1b give
  one quantized leaf (``embed.tok``) and the reference's dense count;
  stats equal the reference's on float32 configs, planes bitwise, and
  the dequantized leaves are bitwise too; a stacked 1-D leaf of a
  32-layer model is quantized along the layer axis, as the reference
  quantizes its ``(L, n)`` stack;
* on a bf16 config the counts and the planes' bytes are the
  reference's and the dense bytes are what the port holds (bf16
  weights, float32 norm scales) where the reference holds float32;
* the dequantized q8_0 and q4_k weights serve the reference's greedy
  streams token for token, fixed-lane and paged;
* the launcher's ``--quant`` prints the reference's ``quantized N
  weight matrices`` line and its prediction in the ``--quant`` format,
  and the README's canonical launch runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import perf_model as jax_perf_model  # noqa: E402
from repro.core.device_profile import PROFILES as JAX_PROFILES  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serving import dequantize_params as jax_dequantize  # noqa: E402
from repro.serving import quantize_params as jax_quantize  # noqa: E402
from repro.serving.modelpool import (  # noqa: E402
    params_nbytes as jax_params_nbytes)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.quant import PLANES  # noqa: E402
from repro_torch.serving import (Request, ServeEngine,  # noqa: E402
                                 dequantize_params, params_nbytes,
                                 quantize_params)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
FORMATS = ("q8_0", "q6_k", "q4_k", "q2_k")
ENGINE_KW = dict(n_lanes=2, max_len=32, dispatch_n=4, page_size=8)


@pytest.fixture(scope="module")
def models():
    """``models(arch, n_layers=None)`` -> (jcfg, jparams, cfg, params),
    float32 SMOKE, the reference's weights carried over; built once."""
    built = {}

    def get(arch, n_layers=None):
        key = (arch, n_layers)
        if key not in built:
            jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                       dtype="float32")
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32")
            if n_layers is not None:
                jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
                cfg = dataclasses.replace(cfg, n_layers=n_layers)
            jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
            built[key] = (jcfg, jparams, cfg,
                          params_from_jax(jax.device_get(jparams), cfg, CPU))
        return built[key]
    return get


def _ref_leaf(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _planes_equal(port_qt, ref_qt):
    for name in PLANES:
        ours, theirs = getattr(port_qt, name), getattr(ref_qt, name)
        assert (ours is None) == (theirs is None), name
        if ours is not None:
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs),
                                          err_msg=name)


def _ref_quantized_paths(jqp):
    from repro.quant.quantize import QTensor as JaxQTensor
    flat = jax.tree_util.tree_flatten_with_path(
        jqp, is_leaf=lambda x: isinstance(x, JaxQTensor))[0]
    return {".".join(k.key for k in path): leaf for path, leaf in flat
            if isinstance(leaf, JaxQTensor)}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("arch", ["qwen2.5-1.5b", "olmo-1b"])
def test_quantize_params_matches_reference(models, arch, fmt):
    _, jparams, _, params = models(arch)
    jqp, jstats = jax_quantize(jparams, fmt)
    qp, stats = quantize_params(params, fmt)
    assert stats == jstats
    assert stats["quantized"] == 1
    if arch == "qwen2.5-1.5b":
        assert stats["dense"] == 13    # leaves, not per-layer tensors
    ref_q = _ref_quantized_paths(jqp)
    assert sorted(qp.quantized) == sorted(ref_q) == ["embed.tok"]
    for path, qt in qp.quantized.items():
        _planes_equal(qt, ref_q[path])
    # the quantized store is the reference's size; dense leaves shared
    assert params_nbytes(qp) == jax_params_nbytes(jqp)
    assert qp.dense.blocks[0].attn.wq is params.blocks[0].attn.wq
    deq = dequantize_params(qp)
    jdeq = jax.device_get(jax_dequantize(jqp))
    np.testing.assert_array_equal(deq.embed.tok.numpy(),
                                  np.asarray(jdeq["embed"]["tok"]))
    assert params_nbytes(deq) == jax_params_nbytes(jdeq) \
        == params_nbytes(params)
    # every other leaf is the original tensor, untouched
    assert deq.blocks[1].mlp.w_up is params.blocks[1].mlp.w_up


def test_stacked_layer_leaf_is_quantized_like_the_reference(models):
    """At 32 layers a stacked 1-D leaf (norm scales, q/k/v biases; here
    ``(32, 128)`` with ``min_size`` 4096) passes the reference's rule:
    the port stacks its per-layer tensors, quantizes the stack along the
    layer axis, and hands each layer back its row of the dequantized
    stack -- the reference's values, bitwise."""
    _, jparams, _, params = models("qwen2.5-1.5b", n_layers=32)
    jqp, jstats = jax_quantize(jparams, "q8_0", min_size=4096)
    qp, stats = quantize_params(params, "q8_0", min_size=4096)
    assert stats == jstats
    ref_q = _ref_quantized_paths(jqp)
    assert sorted(qp.quantized) == sorted(ref_q)
    assert "blocks.norm1.scale" in ref_q and "blocks.attn.bq" in ref_q
    for path, qt in qp.quantized.items():
        _planes_equal(qt, ref_q[path])
    deq = dequantize_params(qp)
    jdeq = jax.device_get(jax_dequantize(jqp))
    for path in sorted(ref_q):
        want = np.asarray(_ref_leaf(jdeq, path))
        if path.startswith("blocks."):
            branch, leaf = path.split(".")[1:]
            got = np.stack([getattr(getattr(b, branch), leaf).numpy()
                            for b in deq.blocks])
        else:
            got = _ref_leaf_port(deq, path)
        np.testing.assert_array_equal(got, want, err_msg=path)


def _ref_leaf_port(lm, path):
    mod = lm
    for part in path.split("."):
        mod = getattr(mod, part)
    return mod.numpy()


def test_bf16_counts_and_bytes():
    """On the bf16 SMOKE config the counts and the planes are the
    reference's; the dense bytes are what the port holds: bf16 weights
    and float32 norm scales, where the reference's tree is float32."""
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    jparams = jax_init_lm(jax.random.PRNGKey(0),
                          jax_get_config("qwen2.5-1.5b", smoke=True))
    _, jstats = jax_quantize(jparams, "q8_0")
    qp, stats = quantize_params(params, "q8_0")
    assert (stats["quantized"], stats["dense"],
            stats["quantized_bytes"]) == (
        jstats["quantized"], jstats["dense"], jstats["quantized_bytes"])
    held = sum(t.numel() * t.element_size() for t in params.parameters()
               if t is not params.embed.tok)
    assert stats["dense_bytes"] == held < jstats["dense_bytes"]
    assert qp.quantized["embed.tok"].values.dtype == torch.int8
    deq = dequantize_params(qp)
    assert deq.embed.tok.dtype == torch.bfloat16


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_dequantized_streams_token_exact(models, fmt, paged):
    jcfg, jparams, cfg, params = models("qwen2.5-1.5b")
    jdeq = jax_dequantize(jax_quantize(jparams, fmt)[0])
    deq = dequantize_params(quantize_params(params, fmt)[0])
    prompts = _prompts(cfg, [5, 11, 7])
    want = [JaxRequest(uid=i, prompt=p.copy(), max_new_tokens=10)
            for i, p in enumerate(prompts)]
    JaxServeEngine(jcfg, jdeq, paged=paged, **ENGINE_KW).run(want)
    got = [Request(uid=i, prompt=p.copy(), max_new_tokens=10)
           for i, p in enumerate(prompts)]
    ServeEngine(cfg, deq, paged=paged, device="cpu", **ENGINE_KW).run(got)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 10 for r in got)


def _reference_lines(fmt):
    """The reference launcher's stats line (on its float32 tree, SMOKE
    qwen2.5-1.5b) and its closing prediction line in ``fmt``."""
    jcfg = jax_get_config("qwen2.5-1.5b", smoke=True)
    _, st = jax_quantize(jax_init_lm(jax.random.PRNGKey(0), jcfg), fmt)
    spec = jax_perf_model.LLMSpec(
        name=jcfg.name, n_layers=jcfg.n_layers, d_model=jcfg.d_model,
        n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff,
        vocab_size=jcfg.vocab_size, tied_embeddings=jcfg.tie_embeddings)
    m = jax_perf_model.InferencePerfModel(JAX_PROFILES["tpu-v5e"], spec)
    pred = (f"capability-model prediction on tpu-v5e: "
            f"prefill {m.prefill(fmt).tokens_per_s:,.0f} tok/s, "
            f"decode {m.decode(fmt).tokens_per_s:,.0f} tok/s ({fmt})")
    return st, pred


@pytest.mark.parametrize("extra", [
    ["--prompt-len", "8", "--lanes", "2"],
    ["--paged", "--page-size", "16", "--prefix-sharing"]],
    ids=["fixed-lane", "readme-canonical"])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_launcher_quant(fmt, extra, capsys):
    serve_launcher.main(["--arch", "qwen2.5-1.5b", "--smoke", "--quant",
                         fmt, "--device", "cpu", "--requests", "2",
                         "--gen", "4"] + extra)
    lines = capsys.readouterr().out.splitlines()
    jstats, pred = _reference_lines(fmt)
    qline = [ln for ln in lines if ln.startswith("quantized ")]
    assert len(qline) == 1
    # counts and planes' MB are the reference's; the dense MB are the
    # port's bf16 weights (the reference prints its float32 tree's)
    assert qline[0].startswith(
        f"quantized {jstats['quantized']} weight matrices "
        f"({jstats['quantized_bytes']/1e6:.1f} MB vs dense ")
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    st = quantize_params(params, fmt)[1]
    assert qline[0] == (f"quantized {st['quantized']} weight matrices "
                        f"({st['quantized_bytes']/1e6:.1f} MB vs dense "
                        f"{st['dense_bytes']/1e6:.1f} MB kept dense)")
    assert lines[-1] == pred
    served = [ln for ln in lines if ln.startswith("served ")]
    assert served and served[0].startswith("served 2 requests, 8 tokens")
    if "--prefix-sharing" in extra:
        assert any(ln.startswith("prefix sharing: 1 hits")
                   for ln in lines), lines


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "serve_quantized_torch"])
def test_examples_run_on_cpu(name, capsys):
    """The port's versions of the reference's two examples run end to
    end on the CPU (on the card without ``--device cpu``)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "OK"
    if name == "quickstart_torch":
        assert "1 matrices -> q4_k" in out and "tok/J" in out
    else:
        assert all(f"{fmt:5s}:" in out for fmt in ("q8_0", "q6_k", "q4_k",
                                                  "q2_k"))
