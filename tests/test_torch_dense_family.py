"""The rest of the dense family against the reference: LayerNorm and
OLMo's non-parametric LN, and the olmo-1b, mistral-nemo-12b,
qwen2.5-32b and qwen1.5-110b configs at SMOKE width.

* ``apply_norm`` of each kind against the reference's on float32 and
  bf16 inputs.  Not bitwise: XLA's CPU ``rsqrt`` is not torch's (each is
  within one ulp of ``1/sqrt``, on different inputs) and XLA sums a row
  in another order, so the float32 outputs differ by a few ulps and a
  bf16 output by at most one bf16 ulp (ROADMAP section 3);
* ``params_from_jax`` maps olmo SMOKE (no norm leaves) and olmo SMOKE
  with ``norm="layernorm"`` (scale and bias, set to random values on
  the reference's side so that each leaf is checked) leaf by leaf;
* prefill logits and KV and greedy decode logits of every new SMOKE
  config, of the layernorm variant, and of a SMOKE whose ``head_dim``
  (64) is not ``d_model / n_heads`` (128 / 4), within 1e-5 (float32);
* the engines token-exact against the reference's, on both layouts,
  greedy, for the four SMOKE configs; olmo also at t=0.8 and with int8
  KV.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.common import apply_norm as jax_apply_norm  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    init_lm as jax_init_lm, init_paged_cache as jax_init_paged_cache,
    lm_decode_step as jax_lm_decode_step,
    lm_prefill_batched as jax_lm_prefill_batched)
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import (LayerNorm,  # noqa: E402
                                       NonParametricLN, RMSNorm, apply_norm,
                                       make_norm)
from repro_torch.models.transformer import (  # noqa: E402
    init_paged_cache, lm_decode_step, lm_prefill_batched)
from repro_torch.serving import STATS_KEYS, Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 1e-5
NEW_ARCHS = ("olmo-1b", "mistral-nemo-12b", "qwen2.5-32b", "qwen1.5-110b")
#: SMOKE variants held to the reference beside the four configs:
#: olmo with LayerNorm (no dense config uses it; whisper will), and a
#: head_dim that is not d_model / n_heads (mistral-nemo-12b's case: 128
#: against 5120 / 32)
VARIANTS = {"olmo-layernorm": ("olmo-1b", dict(norm="layernorm")),
            "nemo-head_dim-64": ("mistral-nemo-12b", dict(head_dim=64))}


def _configs(name):
    arch, extra = VARIANTS.get(name, (name, {}))
    kw = dict(extra, dtype="float32")
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def _affine_norms(jparams, seed):
    """The reference's norm leaves set to random values (its init makes
    them ones and zeros, which would hide a swapped or dropped leaf)."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        return jnp.asarray(1 + 0.1 * rng.standard_normal(leaf.shape),
                           jnp.float32)

    for part in ("norm1", "norm2"):
        jparams["blocks"][part] = {k: fill(v) for k, v in
                                   jparams["blocks"][part].items()}
    jparams["final_norm"] = {k: fill(v) for k, v in
                             jparams["final_norm"].items()}
    return jparams


@pytest.fixture(scope="module")
def models():
    """``models(name)`` -> (jcfg, jparams, cfg, params) in float32, the
    reference's weights converted through numpy; each built once."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, cfg = _configs(name)
            jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
            if jcfg.norm == "layernorm":
                jparams = _affine_norms(jparams, seed=3)
            params = params_from_jax(jax.device_get(jparams), cfg, CPU)
            built[name] = (jcfg, jparams, cfg, params)
        return built[name]
    return get


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

def _norm_inputs(d, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((4, 9, d)) + 0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, tx, rng


@pytest.mark.parametrize("d", [128, 2048, 5120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layernorm", "nonparametric_ln",
                                  "rmsnorm"])
def test_apply_norm_matches_reference(kind, dtype, d):
    """Each kind against the reference's on the same inputs: float32
    outputs within 8 float32 ulps of their magnitude, bf16 outputs
    within one bf16 ulp, and the module's type picks the kind."""
    jx, tx, rng = _norm_inputs(d, dtype, seed=d)
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True), d_model=d,
                              norm=kind)
    p = make_norm(cfg)
    assert type(p) is {"rmsnorm": RMSNorm, "layernorm": LayerNorm,
                       "nonparametric_ln": NonParametricLN}[kind]
    jp = {}
    for name, w in p.named_parameters():
        val = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        w.data.copy_(torch.from_numpy(val))
        jp[name] = jnp.asarray(val)
    assert sorted(jp) == {"rmsnorm": ["scale"],
                          "layernorm": ["bias", "scale"],
                          "nonparametric_ln": []}[kind]
    want = np.asarray(jax.jit(lambda a: jax_apply_norm(jp, a, kind))(jx)
                      .astype(jnp.float32))
    got = apply_norm(p, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    scale = np.maximum(np.abs(want), 1.0)
    ulps = 8 * np.finfo(np.float32).eps if dtype == "float32" else 2.0 ** -7
    assert np.all(np.abs(got - want) <= ulps * scale), \
        np.abs(got - want).max()


def test_layernorm_variance_is_the_population_variance():
    """The variance divides by n, as ``jnp.var``, not by n - 1 as
    ``torch.var`` does by default: a row of two values normalises to
    exactly -1 and +1 (up to eps)."""
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True), d_model=2)
    out = apply_norm(make_norm(cfg), torch.tensor([[1.0, 3.0]]), eps=0.0)
    assert out.tolist() == [[-1.0, 1.0]]


# ----------------------------------------------------------------------
# configs, conversion, logits
# ----------------------------------------------------------------------

def test_new_configs_copy_the_reference():
    for arch in NEW_ARCHS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            jcfg = jax_get_config(arch, smoke=smoke)
            for f in dataclasses.fields(cfg):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), \
                    (arch, f.name)
            assert cfg.hd == jcfg.hd
    nemo = get_config("mistral-nemo-12b")
    assert nemo.hd == 128 != nemo.d_model // nemo.n_heads
    olmo = get_config("olmo-1b")
    assert olmo.norm == "nonparametric_ln"
    assert olmo.n_kv_heads == olmo.n_heads


@pytest.mark.parametrize("name", ["olmo-1b", "olmo-layernorm"])
def test_params_from_jax_maps_norm_leaves(models, name):
    jcfg, jparams, cfg, params = models(name)
    n_ref = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    names = {n for n, _ in params.named_parameters()}
    if cfg.norm == "nonparametric_ln":
        assert not any("norm" in n for n in names)
        assert jparams["final_norm"] == {}
        return
    for i, blk in enumerate(params.blocks):
        for part in ("norm1", "norm2"):
            mod = getattr(blk, part)
            for leaf in ("scale", "bias"):
                np.testing.assert_array_equal(
                    getattr(mod, leaf).numpy(),
                    np.asarray(jparams["blocks"][part][leaf][i]))
    for leaf in ("scale", "bias"):
        np.testing.assert_array_equal(
            getattr(params.final_norm, leaf).numpy(),
            np.asarray(jparams["final_norm"][leaf]))
        assert getattr(params.final_norm, leaf).dtype == torch.float32


@pytest.mark.parametrize("name", list(NEW_ARCHS) + sorted(VARIANTS))
def test_prefill_and_decode_logits_match(models, name):
    """Prefill logits and KV at two ragged last positions, then eight
    greedy paged decode steps through shuffled block tables: logits
    within 1e-5, every argmax equal."""
    jcfg, jparams, cfg, params = models(name)
    if name == "nemo-head_dim-64":
        assert params.blocks[0].attn.wq.shape == (128, 4 * 64)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    last = np.array([15, 9], np.int32)
    jl, (jk, jv) = jax_lm_prefill_batched(jparams, jnp.asarray(toks), jcfg,
                                          last_pos=jnp.asarray(last))
    before = launch_counts()
    logits, (k, v) = lm_prefill_batched(params, torch.from_numpy(toks), cfg,
                                        last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=0)
    b, max_len, ps = 3, 32, 8
    jcache = jax_init_paged_cache(jcfg, b, max_len, page_size=ps)
    t_w = jcache["block_tables"].shape[1]
    bt = rng.permutation(b * t_w).reshape(b, t_w).astype(np.int32)
    jcache["block_tables"] = jnp.asarray(bt)
    cache = init_paged_cache(cfg, b, max_len, page_size=ps, device=CPU)
    cache["block_tables"] = torch.from_numpy(bt)
    step = jax.jit(lambda c, t: jax_lm_decode_step(jparams, jcfg, c, t))
    tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for i in range(8):
        jl, jcache = step(jcache, jtok)
        tl, cache = lm_decode_step(params, cfg, cache, ttok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0, err_msg=f"step {i}")
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {i}"
    assert launch_counts() == before          # CPU: no kernel launched


def test_unported_families_are_refused_by_name():
    """Every family of the reference is ported (moe, vlm and the whisper
    encoder-decoder build); a decoder of any other family, a moe family without its MoEConfig, an "audio"
    config without encoder layers and an unknown norm are refused by
    name."""
    for arch, family in (("moonshot-v1-16b-a3b", "moe"),
                         ("phi-3-vision-4.2b", "vlm"),
                         ("whisper-base", "audio")):
        jcfg = jax_get_config(arch, smoke=True)
        assert jcfg.family == family
        assert build_model(get_config(arch, smoke=True)).cfg.family == family
    for family in ("moe", "audio", "retnet"):
        cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                                  name=f"olmo-as-{family}", family=family)
        with pytest.raises(ValueError, match=family):
            build_model(cfg)
    with pytest.raises(ValueError, match="norm"):
        build_model(dataclasses.replace(get_config("olmo-1b", smoke=True),
                                        norm="groupnorm"))


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------

N_LANES, MAX_LEN, PAGE, DISPATCH = 2, 48, 8, 4
PLENS = [5, 20, 9, 60, 13]                 # 60 > MAX_LEN - 1: truncated
GENS = [8, 5, 10, 6, 7]


@pytest.mark.parametrize("name,paged,temperature,kv_quant", [
    ("olmo-1b", False, 0.0, None), ("olmo-1b", True, 0.0, None),
    ("olmo-1b", False, 0.8, None), ("olmo-1b", True, 0.8, None),
    ("olmo-1b", False, 0.0, "int8"), ("olmo-1b", True, 0.0, "int8"),
    ("mistral-nemo-12b", False, 0.0, None),
    ("mistral-nemo-12b", True, 0.0, None),
    ("qwen2.5-32b", False, 0.0, None), ("qwen2.5-32b", True, 0.0, None),
    ("qwen1.5-110b", False, 0.0, None), ("qwen1.5-110b", True, 0.0, None)])
def test_engine_lockstep_matches_reference(models, name, paged,
                                           temperature, kv_quant):
    """Admission by admission and block by block, more requests than
    lanes and one prompt past ``max_len - 1``: every admission, every
    ``decode_n`` block and every ``STATS_KEYS`` counter equal."""
    jcfg, jparams, cfg, params = models(name)
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    kw = dict(n_lanes=N_LANES, max_len=MAX_LEN, dispatch_n=DISPATCH,
              temperature=temperature, rng_seed=4)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    jreqs = [JaxRequest(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    treqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    pending = list(range(len(treqs)))
    while pending or teng.live_lanes():
        while pending and teng.free_lanes():
            i = pending[0]
            ok = teng.admit(treqs[i])
            assert jeng.admit(jreqs[i]) == ok, f"admit uid={i}"
            if not ok:
                break
            pending.pop(0)
        assert teng.decode_n(DISPATCH) == jeng.decode_n(DISPATCH)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.generated == jr.generated, tr.uid
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    if paged:
        teng.pool.check()
        assert teng.pool.n_in_use == 0
