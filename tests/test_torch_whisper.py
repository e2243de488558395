"""whisper-base's encoder-decoder against the reference, at SMOKE width
in float32 (its LayerNorm affines set to random values on the
reference's side, so that every leaf is checked).

* the config copies the reference's; ``params_from_jax`` maps the
  ``encoder``/``decoder`` trees leaf by leaf;
* ``attention_forward(causal=False)`` and ``gelu_mlp``, then ``encode``,
  ``decode_forward`` (cross-attention at S_dec != S_enc),
  ``init_whisper_cache``'s cross K/V and ``whisper_decode_step``'s
  logits: each within 1e-5 of the reference's, relative to the output's
  largest magnitude (at least 1);
* ``Model.decode_n_steps`` (greedy and t=0.8, with a lane whose budget
  runs out) gives the reference's valid tokens, valid flags, budgets,
  token indices and lengths;
* on the port, each step's log-probabilities against
  ``decode_forward``'s at the same position within the reference's own
  bound (``tests/test_decode_consistency.py``, 2e-2);
* the int8 KV cache, ``ServeEngine``, the launcher and the paged cache
  refuse the encoder-decoder, by name where a name is asked for;
* training: cross-attention runs K2's Function when autograd records
  and the plain pass otherwise, and the training passes (remat on and
  off) give serving's values (the loss and its gradients against the
  reference are in ``tests/test_torch_train.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.attention import (  # noqa: E402
    attention_forward as jax_attention_forward)
from repro.models.mlp import gelu_mlp as jax_gelu_mlp  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.models.whisper import (  # noqa: E402
    decode_forward as jax_decode_forward, encode as jax_encode,
    init_whisper as jax_init_whisper,
    init_whisper_cache as jax_init_whisper_cache,
    whisper_decode_step as jax_whisper_decode_step)
from repro_torch import rng as trng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import attention_forward  # noqa: E402
from repro_torch.models.mlp import gelu_mlp  # noqa: E402
from repro_torch.models.whisper import (  # noqa: E402
    Whisper, cross_attention, decode_forward, decode_forward_train,
    enc_kv, encode, encode_train, init_whisper_cache, whisper_decode_step)
from repro_torch.serving import ServeEngine  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 1e-5
ARCH = "whisper-base"
B, S_ENC, S_DEC = 3, 40, 12


def assert_close(got, want, what=""):
    """max |got - want| <= TOL x max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _affine_norms(jparams, seed):
    """Every LayerNorm's scale and bias set to random values (the init
    makes them ones and zeros, which would hide a swapped leaf)."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(1 + 0.1 * rng.standard_normal(a.shape),
                                  jnp.float32), tree)

    for stack, parts in (("encoder", ("norm1", "norm2")),
                         ("decoder", ("norm1", "norm_x", "norm2"))):
        for part in parts:
            jparams[stack][part] = fill(jparams[stack][part])
    for part in ("enc_final_norm", "final_norm"):
        jparams[part] = fill(jparams[part])
    return jparams


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    jparams = _affine_norms(jax_init_whisper(jax.random.PRNGKey(0), jcfg),
                            seed=3)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    return jcfg, jparams, cfg, params, frames, toks


def test_config_and_params_copy_the_reference(model):
    for smoke in (False, True):
        cfg = get_config(ARCH, smoke=smoke)
        jcfg = jax_get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.is_encdec
    assert get_config(ARCH).hd == 64
    jcfg, jparams, cfg, params, _, _ = model
    assert isinstance(params, Whisper)
    n_ref = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref
    for stack in ("encoder", "decoder"):
        for i, blk in enumerate(getattr(params, stack)):
            for name, w in blk.named_parameters():
                node = jparams[stack]
                for part in name.split("."):
                    node = node[part]
                np.testing.assert_array_equal(w.numpy(), np.asarray(node[i]),
                                              err_msg=f"{stack}[{i}].{name}")
    for part in ("enc_final_norm", "final_norm"):
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(
                getattr(getattr(params, part), leaf).numpy(),
                np.asarray(jparams[part][leaf]))


def test_unmasked_attention_and_gelu_mlp_match_reference(model):
    jcfg, jparams, cfg, params, frames, _ = model
    jblk = jax.tree_util.tree_map(lambda a: a[0], jparams["encoder"])
    x = jnp.asarray(frames)
    for causal in (False, True):
        want = jax_attention_forward(jblk["attn"], x, jcfg, causal=causal)
        got = attention_forward(params.encoder[0].attn,
                                torch.from_numpy(frames), cfg, causal=causal)
        assert_close(got.numpy(), want, f"attention causal={causal}")
    unmasked = attention_forward(params.encoder[0].attn,
                                 torch.from_numpy(frames), cfg, causal=False)
    assert not torch.allclose(unmasked, got)
    assert_close(gelu_mlp(params.encoder[0].mlp,
                          torch.from_numpy(frames)).numpy(),
                 jax_gelu_mlp(jblk["mlp"], x), "gelu_mlp")


def test_encode_and_decode_forward_match_reference(model):
    jcfg, jparams, cfg, params, frames, toks = model
    jenc = jax_encode(jparams, jnp.asarray(frames), jcfg)
    enc = encode(params, torch.from_numpy(frames), cfg)
    assert enc.shape == (B, S_ENC, cfg.d_model)
    assert_close(enc.numpy(), jenc, "encode")
    want = jax_decode_forward(jparams, jnp.asarray(toks), jenc, jcfg)
    got = decode_forward(params, torch.from_numpy(toks), enc, cfg)
    assert got.shape == (B, S_DEC, cfg.padded_vocab)
    v = cfg.vocab_size           # past it the padded vocab's -1e30
    assert_close(got[..., :v].numpy(), np.asarray(want)[..., :v],
                 "decode_forward")
    via_model = build_model(cfg).forward(params, torch.from_numpy(toks),
                                         frames=torch.from_numpy(frames))
    assert torch.equal(via_model, got)


def test_cache_and_decode_steps_match_reference(model):
    """The cross K/V of ``init_whisper_cache``, then S_DEC teacher-forced
    steps: every step's logits against the reference's (and its
    self-attention cache rows), and on the port each step's
    log-probabilities against ``decode_forward``'s at that position."""
    jcfg, jparams, cfg, params, frames, toks = model
    jenc = jax_encode(jparams, jnp.asarray(frames), jcfg)
    enc = encode(params, torch.from_numpy(frames), cfg)
    jcache = jax_init_whisper_cache(jparams, jenc, jcfg, B, S_DEC + 4)
    cache = build_model(cfg).init_cache(B, S_DEC + 4, params=params, enc=enc)
    for key in ("cross_k", "cross_v"):
        assert cache[key].shape == (cfg.n_layers, B, cfg.n_kv_heads, S_ENC,
                                    cfg.hd)
        assert_close(cache[key].numpy(), jcache[key], key)
    step = jax.jit(lambda c, t: jax_whisper_decode_step(jparams, jcfg, c, t))
    full = decode_forward(params, torch.from_numpy(toks), enc, cfg)
    for t in range(S_DEC):
        jl, jcache = step(jcache, jnp.asarray(toks[:, t]))
        tl, cache = whisper_decode_step(params, cfg, cache,
                                        torch.from_numpy(toks[:, t]))
        v = cfg.vocab_size
        assert_close(tl[:, :v].numpy(), np.asarray(jl)[:, :v], f"step {t}")
        inc = torch.log_softmax(tl[:, :v], dim=-1)
        ref = torch.log_softmax(full[:, t, :v], dim=-1)
        assert float((inc - ref).abs().max()) < 2e-2
    assert cache["len"].tolist() == [S_DEC] * B
    assert_close(cache["k"].numpy(), jcache["k"], "self k")
    assert_close(cache["v"].numpy(), jcache["v"], "self v")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_n_steps_matches_reference(model, temperature):
    """Two dispatches of 5 steps from a cache over the encoder states,
    one lane's budget 3 (it runs out in the first dispatch), the length
    capped at max_len - 1."""
    jcfg, jparams, cfg, params, frames, _ = model
    jmodel, tmodel = jax_build_model(jcfg), build_model(cfg)
    jenc = jmodel.encode(jparams, jnp.asarray(frames))
    enc = tmodel.encode(params, torch.from_numpy(frames))
    max_len = 9
    jcache = jmodel.init_cache(jparams, B, max_len, enc=jenc)
    cache = tmodel.init_cache(B, max_len, params=params, enc=enc)
    tok = np.array([1, 7, 300], np.int32)
    rem = np.array([8, 3, 8], np.int32)
    seed = np.array([0, 1, 2], np.int32)
    idx = np.zeros(B, np.int32)
    jstate = [jnp.asarray(a) for a in (tok, rem, idx)]
    tstate = [torch.from_numpy(a.copy()) for a in (tok, rem, idx)]
    jrng = jax.random.PRNGKey(11)
    trng_key = trng.PRNGKey(11)
    for _ in range(2):
        jt, jv, jtok, jcache, jrem, jidx = jmodel.decode_n_steps(
            jparams, jcache, jstate[0], jrng, jstate[1], jnp.asarray(seed),
            jstate[2], n_steps=5, temperature=temperature,
            len_cap=max_len - 1)
        tt, tv, ttok, cache, trem, tidx = tmodel.decode_n_steps(
            params, cache, tstate[0], trng_key, tstate[1],
            torch.from_numpy(seed), tstate[2], n_steps=5,
            temperature=temperature, len_cap=max_len - 1)
        # a lane out of budget still samples, and the sample is
        # discarded: the port draws it at another token index (its noise
        # is drawn for the whole dispatch up front), so only valid
        # samples and live lanes' next tokens are compared
        valid = np.asarray(jv)
        live = np.asarray(jrem) > 0
        np.testing.assert_array_equal(tt.numpy()[valid], np.asarray(jt)[valid])
        np.testing.assert_array_equal(ttok.numpy()[live],
                                      np.asarray(jtok)[live])
        for got, want in ((tv, jv), (trem, jrem), (tidx, jidx),
                          (cache["len"], jcache["len"])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jstate, tstate = [jtok, jrem, jidx], [ttok, trem, tidx]
    assert int(tv[:, 1].sum()) == 0 and cache["len"].tolist()[1] == 3


def test_encoder_decoder_refusals(model):
    jcfg, jparams, cfg, params, frames, _ = model
    enc = encode(params, torch.from_numpy(frames), cfg)
    cache = init_whisper_cache(params, enc, cfg, B, 8)
    q8 = dataclasses.replace(cfg, kv_quant="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        whisper_decode_step(params, q8, cache, torch.zeros(B, dtype=torch.int32))
    for paged in (False, True):
        with pytest.raises(ValueError, match="whisper"):
            ServeEngine(cfg, params, paged=paged, device="cpu")
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    tmodel = build_model(cfg)
    with pytest.raises(ValueError, match="paged"):
        tmodel.init_paged_cache(B, 16, device=CPU)
    with pytest.raises(ValueError, match="enc"):
        tmodel.init_cache(B, 16, device=CPU)


def test_launcher_names_whisper_when_refusing(capsys):
    with pytest.raises(SystemExit) as exc:
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert exc.value.code != 0
    assert "whisper" in capsys.readouterr().err


def _graph_nodes(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_training_passes_run_the_function_and_give_servings_values(model):
    _, _, cfg, _, frames, toks = model
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU,
                                   train=True)
    enc_in = torch.from_numpy(frames)
    x = torch.randn(B, S_DEC, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    p = params.decoder[0].cross_attn
    out = cross_attention(p, x, enc_kv(p, enc_in, cfg), cfg)
    assert "FlashAttentionFnBackward" in _graph_nodes(out)
    with torch.no_grad():
        plain = cross_attention(p, x, enc_kv(p, enc_in, cfg), cfg)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())
    served_enc = encode(params, enc_in, cfg)
    served = decode_forward(params, torch.from_numpy(toks), served_enc, cfg)
    assert served.grad_fn is None
    for remat in (False, True):
        enc = encode_train(params, enc_in, cfg, remat=remat)
        logits = decode_forward_train(params, torch.from_numpy(toks), enc,
                                      cfg, remat=remat)
        assert "FlashAttentionFnBackward" in _graph_nodes(logits)
        assert torch.equal(enc.detach(), served_enc)
        assert torch.equal(logits.detach(), served)
