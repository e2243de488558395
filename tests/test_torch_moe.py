"""The moe family against the reference: moonshot-v1-16b-a3b (64
experts top-6 at full width, two shared experts) and arctic-480b (128
experts top-2 with a dense residual FFN beside), at SMOKE width in
float32.

* the configs copy the reference's, ``MoEConfig`` field by field;
* ``moe_forward``'s ``out`` and ``aux`` within 1e-5 of the reference's
  (relative to the output's largest magnitude: the reference's expert
  stacks take their fan-in scale from the first axis, E, so the outputs
  run to tens, where float32 rounding in another summation order alone
  is a few 1e-6 absolute):
  with capacity dropping assignments, through Arctic's block with its
  dense residual, and chunked (the reference's ``REPRO_MOE_CHUNK`` set
  with ``monkeypatch``, the same chunk passed to the port);
* ``params_from_jax`` maps the moe tree leaf by leaf (stacked ``(L, E,
  d, f)`` experts, ``(L, d, E)`` router, shared experts, Arctic's
  ``mlp`` beside ``moe``), and ``quantize_params`` picks the leaves the
  reference's picks on it;
* prefill logits and KV and paged decode logits within 1e-5;
* the engines token-exact against the reference's on both layouts
  (greedy; moonshot also at t=0.8 and with prefix sharing).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.moe import init_moe as jax_init_moe  # noqa: E402
from repro.models.moe import moe_forward as jax_moe_forward  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    block_forward as jax_block_forward, init_lm as jax_init_lm,
    init_paged_cache as jax_init_paged_cache,
    lm_decode_step as jax_lm_decode_step, lm_forward as jax_lm_forward,
    lm_prefill_batched as jax_lm_prefill_batched)
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serving import quantize_params as jax_quantize_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models.common import embed  # noqa: E402
from repro_torch.models.moe import MoE, capacity, moe_forward  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    block_forward, init_paged_cache, lm_decode_step, lm_forward,
    lm_prefill_batched)
from repro_torch.serving import (STATS_KEYS, Request,  # noqa: E402
                                 ServeEngine, quantize_params)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 1e-5
ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b")


def _configs(arch):
    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, cfg = _configs(arch)
            jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
            params = params_from_jax(jax.device_get(jparams), cfg, CPU)
            built[arch] = (jcfg, jparams, cfg, params)
        return built[arch]
    return get


def _port_moe(jp, d, moe):
    """A port MoE holding the reference's ``init_moe`` leaves."""
    p = MoE(d, moe, torch.float32)
    for name, w in p.named_parameters():
        node = jp
        for part in name.split("."):
            node = node[part]
        w.data.copy_(torch.from_numpy(np.array(node, np.float32)))
    return p


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close(got, want, what=""):
    """max |got - want| <= TOL x max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _drops(jp, x, moe):
    """Assignments past their expert's capacity, counted in numpy."""
    xf = x.reshape(-1, x.shape[-1])
    logits = xf @ np.asarray(jp["router"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :moe.top_k]
    per = np.bincount(top.reshape(-1), minlength=moe.n_experts)
    return int(np.maximum(per - capacity(len(xf), moe), 0).sum())


# ----------------------------------------------------------------------
# configs and the layer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch):
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        jcfg = jax_get_config(arch, smoke=smoke)
        for f in dataclasses.fields(cfg):
            if f.name != "moe":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    full = get_config(arch)
    assert full.family == "moe" and not full.is_encdec


@pytest.mark.parametrize("case", ["drops", "shared"])
def test_moe_forward_matches_reference(case):
    """moonshot SMOKE's experts (8, top-3, one shared): at a capacity
    factor of 0.5 (96 assignments for 64 slots, so at least 32 dropped),
    and at the config's own factor."""
    _, cfg = _configs("moonshot-v1-16b-a3b")
    moe = cfg.moe
    if case == "drops":
        moe = dataclasses.replace(moe, capacity_factor=0.5)
    jmoe = jax_get_config("moonshot-v1-16b-a3b", smoke=True).moe
    jmoe = dataclasses.replace(jmoe, capacity_factor=moe.capacity_factor)
    jp = jax_init_moe(jax.random.PRNGKey(3), cfg.d_model, jmoe)
    x = _x((2, 16, cfg.d_model), seed=7)
    if case == "drops":
        assert capacity(32, moe) == 8 and _drops(jp, x, moe) >= 32
    want, want_aux = jax_moe_forward(jp, jnp.asarray(x), jmoe)
    p = _port_moe(jp, cfg.d_model, moe)
    out, aux = moe_forward(p, torch.from_numpy(x), moe)
    assert_close(out.numpy(), want, "out")
    assert_close(float(aux), float(want_aux), "aux")
    again, _ = moe_forward(p, torch.from_numpy(x), moe)
    assert torch.equal(out, again)


def test_moe_forward_chunked_matches_reference(monkeypatch):
    """64 tokens in chunks of 16 (each chunk its own capacity, the aux
    losses averaged) against the reference with ``REPRO_MOE_CHUNK=16``;
    the chunked aux differs from the unchunked one."""
    _, cfg = _configs("moonshot-v1-16b-a3b")
    jmoe = jax_get_config("moonshot-v1-16b-a3b", smoke=True).moe
    jp = jax_init_moe(jax.random.PRNGKey(4), cfg.d_model, jmoe)
    x = _x((2, 32, cfg.d_model), seed=8)
    monkeypatch.setenv("REPRO_MOE_CHUNK", "16")
    want, want_aux = jax_moe_forward(jp, jnp.asarray(x), jmoe)
    p = _port_moe(jp, cfg.d_model, cfg.moe)
    out, aux = moe_forward(p, torch.from_numpy(x), cfg.moe, chunk=16)
    assert_close(out.numpy(), want, "out")
    assert_close(float(aux), float(want_aux), "aux")
    _, whole = moe_forward(p, torch.from_numpy(x), cfg.moe, chunk=0)
    assert abs(float(whole) - float(aux)) > 1e-6


def test_dense_residual_block_matches_reference(models):
    """Arctic's block: attention, then the experts plus the dense
    residual FFN on the same normed stream; x and aux within 1e-5."""
    jcfg, jparams, cfg, params = models("arctic-480b")
    assert cfg.moe.dense_residual and hasattr(params.blocks[0], "mlp")
    x = _x((2, 12, cfg.d_model), seed=9)
    jblk = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"])
    want, want_aux = jax_block_forward(jblk, jnp.asarray(x), jcfg)
    got, _, aux = block_forward(params.blocks[1], torch.from_numpy(x), cfg)
    assert_close(got.numpy(), want, "x")
    assert_close(float(aux), float(want_aux), "aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_maps_the_moe_tree(models, arch):
    jcfg, jparams, cfg, params = models(arch)
    n_ref = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    moe = jparams["blocks"]["moe"]
    e, f, d = cfg.moe.n_experts, cfg.moe.d_expert_ff, cfg.d_model
    assert moe["w_gate"].shape == (cfg.n_layers, e, d, f)
    assert moe["router"].shape == (cfg.n_layers, d, e)
    for i, blk in enumerate(params.blocks):
        assert blk.moe.router.dtype == torch.float32
        for name, w in blk.moe.named_parameters():
            node = moe
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(w.numpy(), np.asarray(node[i]))
    assert hasattr(params.blocks[0].moe, "shared") == \
        bool(cfg.moe.n_shared_experts)
    assert hasattr(params.blocks[0], "mlp") == cfg.moe.dense_residual


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_quantize_params_picks_the_reference_leaves(models, fmt):
    """The reference's rule on its stacked moe tree: the expert stacks
    are 4-D, the router and shared experts 3-D, so only the embedding
    and (q8_0) the head are quantized; the stats count as the
    reference's."""
    jcfg, jparams, cfg, params = models("moonshot-v1-16b-a3b")
    jqp, jstats = jax_quantize_params(jparams, fmt)
    qp, stats = quantize_params(params, fmt)
    want = sorted(".".join(str(getattr(k, "key", k)) for k in path)
                  for path, leaf in jax.tree_util.tree_flatten_with_path(
                      jqp, is_leaf=lambda v: type(v).__name__ == "QTensor"
                  )[0] if type(leaf).__name__ == "QTensor")
    # the head is (d, V): its first axis, 128, is not a multiple of
    # q4_k's 256-block
    assert sorted(qp.quantized) == want == (
        ["embed.head", "embed.tok"] if fmt == "q8_0" else ["embed.tok"])
    for key in ("quantized", "dense", "quantized_bytes", "dense_bytes"):
        assert stats[key] == jstats[key], key


# ----------------------------------------------------------------------
# logits
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match(models, arch):
    """``lm_forward`` logits, the blocks' aux summed against the
    reference's ``lm_forward`` aux, prefill logits and KV at two ragged
    last positions, then eight greedy paged decode steps (3 lanes, so
    the decode's capacity is 8 and nothing drops): within 1e-5, every
    argmax equal."""
    jcfg, jparams, cfg, params = models(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jaux = jax_lm_forward(jparams, jnp.asarray(toks), jcfg)
    before = launch_counts()
    logits = lm_forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL,
                               rtol=0)
    x, aux = embed(params.embed, torch.from_numpy(toks)), 0.0
    for blk in params.blocks:
        x, _, a = block_forward(blk, x, cfg)
        aux = aux + a
    assert_close(float(aux), float(jaux), "aux")
    assert float(aux) > 0
    last = np.array([15, 9], np.int32)
    jl, (jk, jv) = jax_lm_prefill_batched(jparams, jnp.asarray(toks), jcfg,
                                          last_pos=jnp.asarray(last))
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


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------

N_LANES, MAX_LEN, PAGE, DISPATCH = 2, 48, 8, 4
PLENS = [5, 20, 9, 60, 13]                 # 60 > MAX_LEN - 1: truncated
GENS = [8, 5, 10, 6, 7]


def lockstep(jcfg, jparams, cfg, params, prompts, gens, **kw):
    """Admission by admission and block by block: every admission, every
    ``decode_n`` block and every ``STATS_KEYS`` counter equal; returns
    the port's engine."""
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    jreqs = [JaxRequest(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    treqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
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
    if teng.paged:
        teng.pool.check()
    return teng


@pytest.mark.parametrize("arch,paged,temperature,sharing", [
    ("moonshot-v1-16b-a3b", False, 0.0, False),
    ("moonshot-v1-16b-a3b", True, 0.0, False),
    ("moonshot-v1-16b-a3b", True, 0.8, False),
    ("moonshot-v1-16b-a3b", True, 0.0, True),
    ("arctic-480b", False, 0.0, False), ("arctic-480b", True, 0.0, False)])
def test_engine_lockstep_matches_reference(models, arch, paged, temperature,
                                           sharing):
    """More requests than lanes and one prompt past ``max_len - 1``; with
    sharing, the prompts open with one 12-token head (a prefix hit
    streams its tail through the batch-1 decode step, whose capacity is
    the decode's, as the reference's does)."""
    jcfg, jparams, cfg, params = models(arch)
    kw = dict(n_lanes=N_LANES, max_len=MAX_LEN, dispatch_n=DISPATCH,
              temperature=temperature, rng_seed=4)
    if paged:
        kw.update(paged=True, page_size=PAGE, prefix_sharing=sharing)
    rng = np.random.default_rng(5)
    head = rng.integers(0, cfg.vocab_size, 12 if sharing else 0)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, n)]
                              ).astype(np.int32) for n in PLENS]
    teng = lockstep(jcfg, jparams, cfg, params, prompts, GENS, **kw)
    if sharing:
        assert teng.stats["prefix_hits"] > 0
        teng.prefix_cache.flush()
    if paged:
        assert teng.pool.n_in_use == 0


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device (the dispatch is captured in a CUDA graph)")
def test_moe_forward_captures_and_replays_bitwise():
    """The dispatch makes no host sync and no data-dependent shape: a
    CUDA graph of ``moe_forward`` at moonshot SMOKE's widths captures,
    and its replay gives the eager bits, drops included."""
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    moe = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = MoE(cfg.d_model, moe, torch.bfloat16, dev)
    for w in p.parameters():
        w.data.copy_(0.1 * torch.randn(w.shape, generator=gen, device=dev))
    x = torch.randn((8, 4, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    eager, eager_aux = moe_forward(p, x, moe)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe_forward(p, x, moe)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, aux = moe_forward(p, x, moe)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.equal(aux, eager_aux)
