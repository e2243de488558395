"""Dense decode attention (K3 length-aware, K6a masked) against the
reference.

On the CPU the wrapper takes its plain PyTorch version for both values
of ``length_aware``; that is held against the reference's
``decode_attention_lengthaware_pallas`` and ``decode_attention_pallas``
in interpret mode and against its jnp ``decode_attention_ref``, on the
same numpy inputs, at 2e-5 (float32, sums in another order; the
reference's own kernel tests use the same bound).  The Pallas kernels
need ``S % min(512, S) == 0``, so S is 64 or 1024 here.  The CUDA
kernels are held against the plain version by the ``cuda`` test, which
skips where there is no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_lengthaware_pallas, decode_attention_pallas)
from repro.kernels.decode_attention import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.models.attention import \
    attention_decode as jax_attention_decode  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref, decode_attention_split_ref,
    merge_partials, split_partials, split_plan)
from repro_torch.models.attention import attention_decode  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = 2e-5


def _inputs(h, hkv, s, d=32, seed=0):
    rng = np.random.default_rng(seed)
    b = 6
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    # dead lane, sub-block, block-aligned, partial, full, one past full
    lens = np.array([0, 7, s // 2, s // 2 + 3, s, s], np.int32)
    return q, k, v, lens


@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 4), (12, 2)])
def test_dense_decode_plain_matches_pallas(h, hkv, s):
    q, k, v, lens = _inputs(h, hkv, s)
    targs = [torch.from_numpy(a) for a in (q, k, v, lens)]
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    bk = min(512, s)
    before = launch_counts()
    la = decode_attention(*targs).numpy()
    masked = decode_attention(*targs, length_aware=False).numpy()
    assert launch_counts() == before        # CPU: plain version, no launch
    ref = np.asarray(jax_decode_ref(*jargs))
    pallas_la = np.asarray(decode_attention_lengthaware_pallas(
        *jargs, bk=bk, interpret=True))
    pallas_masked = np.asarray(decode_attention_pallas(
        *jargs, bk=bk, interpret=True))
    for out in (la, masked):
        assert np.max(np.abs(out - pallas_la)) < TOL
        assert np.max(np.abs(out - pallas_masked)) < TOL
        assert np.max(np.abs(out - ref)) < TOL
        assert np.all(out[0] == 0.0)        # dead lane: exactly 0
    assert np.array_equal(la, masked)


def test_dense_decode_scale_and_any_length():
    """``scale`` passes through; S need not be a multiple of a block."""
    q, k, v, lens = _inputs(12, 2, 100)
    lens = np.minimum(lens, 100).astype(np.int32)
    targs = [torch.from_numpy(a) for a in (q, k, v, lens)]
    out = decode_attention(*targs, scale=0.3).numpy()
    ref = np.asarray(jax_decode_ref(*map(jnp.asarray, (q, k, v, lens)),
                                     scale=0.3))
    assert np.max(np.abs(out - ref)) < TOL


def test_attention_decode_step_matches_reference():
    """One decode step of one layer writes the ring slot and attends
    exactly as the reference's ``attention_decode`` (fp cache)."""
    import dataclasses
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg,
                             torch.device("cpu"))
    rng = np.random.default_rng(3)
    b, smax = 3, 16
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((b, cfg.n_kv_heads, smax, cfg.hd)
                             ).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    clen = np.array([0, 9, 20], np.int32)   # 20 wraps the ring (slot 4)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])["attn"]
    jx, jkc, jvc, jlen = map(jnp.asarray, (x, kc, vc, clen))
    jout, jk, jv = jax_attention_decode(jp, jx, jcfg, jkc, jvc, jlen)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, k2, v2 = attention_decode(params.blocks[0].attn,
                                   torch.from_numpy(x), cfg, tk, tv,
                                   torch.from_numpy(clen))
    assert k2 is tk and v2 is tv            # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_int8_kv_cache_layouts_match_reference():
    """``build_model`` takes ``kv_quant="int8"``, and both cache layouts
    have the reference's keys, dtypes and shapes (scales initialised to
    ones, as the reference's)."""
    import dataclasses
    from repro.models.transformer import init_cache as jax_init_cache
    from repro.models.transformer import \
        init_paged_cache as jax_init_paged_cache
    from repro_torch.models import build_model
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               kv_quant="int8")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              kv_quant="int8")
    model = build_model(cfg)
    cpu = torch.device("cpu")
    pairs = [(model.init_cache(3, 40, device=cpu), jax_init_cache(jcfg, 3, 40)),
             (model.init_paged_cache(3, 48, page_size=16, n_pages=7,
                                     device=cpu),
              jax_init_paged_cache(jcfg, 3, 48, page_size=16, n_pages=7))]
    for mine, ref in pairs:
        assert sorted(mine) == sorted(ref)
        for key, val in ref.items():
            assert str(mine[key].dtype).split(".")[-1] == str(val.dtype), key
            assert tuple(mine[key].shape) == val.shape, key
            assert np.array_equal(mine[key].numpy(), np.asarray(val)), key


def test_dense_wrapper_rejects_unsupported_device():
    q, k, v, lens = map(torch.from_numpy, _inputs(4, 2, 64))
    with pytest.raises(ValueError):
        decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                         lens.to("meta"))


@pytest.mark.parametrize("bad", ["lens_int64", "lens_batch", "head_dim",
                                 "strided_k", "q_dtype", "group"])
def test_kernel_input_checks(bad):
    """The checks a CUDA launch passes first (shared by K1 and K3/K6a)
    turn away what the kernels do not take."""
    from repro_torch.kernels.decode_attention import ops
    q, k, v, lens = map(torch.from_numpy, _inputs(12, 2, 64))
    ops._check(q, k, v, {"kv_lengths": lens}, "(B,Hkv,S,D)")   # accepted
    if bad == "lens_int64":
        lens = lens.long()
    elif bad == "lens_batch":
        lens = lens[:3]
    elif bad == "head_dim":
        k = k[..., :16].contiguous()
    elif bad == "strided_k":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "q_dtype":
        q = q.double()
    else:                                    # H/Hkv above the kernel's 64
        q = torch.zeros(6, 65 * 2, 32)
    with pytest.raises((TypeError, ValueError)):
        ops._check(q, k, v, {"kv_lengths": lens}, "(B,Hkv,S,D)")


# ----------------------------------------------------------------------
# the split-KV plan and its plain version (the card's algorithm)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s,b,hkv", [(1, 1, 1), (64, 6, 4), (100, 3, 2),
                                     (1000, 8, 2), (1024, 8, 2),
                                     (1024, 1, 2), (4097, 3, 2),
                                     (32768, 8, 2)])
def test_split_plan_covers_every_position_once(s, b, hkv):
    """The dense kernels' grid is a function of S, B and Hkv alone: CH is
    64 where that still gives each of the 132 SMs a CTA, else 32, and the
    chunks [c CH, (c + 1) CH) cut at S hold every position exactly once,
    in order."""
    ch, n = split_plan(s, b, hkv)
    assert ch in (32, 64) and n == -(-s // ch)
    assert (ch == 64) == (b * hkv * -(-s // 64) >= 132)
    pos = np.concatenate([np.arange(c * ch, min((c + 1) * ch, s))
                          for c in range(n)])
    assert np.array_equal(pos, np.arange(s))
    assert all(c * ch < s for c in range(n))      # no chunk starts past S


def test_split_plan_at_the_serve_shape():
    """The fixed-lane serve (8 lanes, 2 kv heads, a cache of 1024): 64
    positions a chunk, 16 chunks a head, 256 CTAs."""
    ch, n = split_plan(1024, 8, 2)
    assert (ch, n, 8 * 2 * n) == (64, 16, 256)
    with pytest.raises(ValueError):
        split_plan(0, 8, 2)


@pytest.mark.parametrize("s", [128, 1000])
@pytest.mark.parametrize("ch", [32, 64])
def test_split_plain_matches_reference(ch, s):
    """The chunked block softmax and its merge in chunk order (the dense
    kernels' algorithm, in plain PyTorch) equal the reference's
    ``decode_attention_ref`` within 1e-6 at SMOKE widths (H 4, Hkv 2,
    D 32), on lengths that end inside, at the edge of and past a chunk,
    and give exactly 0 for a lane of length 0."""
    q, k, v, lens = _inputs(4, 2, s)
    lens = np.array([0, 7, ch, ch + 1, s - 3, s], np.int32)
    out = decode_attention_split_ref(*map(torch.from_numpy, (q, k, v, lens)),
                                     ch=ch).numpy()
    ref = np.asarray(jax_decode_ref(*map(jnp.asarray, (q, k, v, lens))))
    assert np.max(np.abs(out - ref)) <= 1e-6
    assert np.all(out[0] == 0.0)


def test_split_empty_chunks_are_exact_zeros():
    """A chunk with no live position leaves m = -1e30 and l = acc = 0
    exactly, so whether the merge reads it (K6a's chunks past the length)
    or not (K3's) changes no bit; a partly live chunk's dead slots add
    nothing either."""
    q, k, v, lens = map(torch.from_numpy, _inputs(12, 2, 256))
    lens = torch.tensor([0, 7, 64, 65, 200, 256], dtype=torch.int32)
    m, l, acc = split_partials(q, k, v, lens, ch=64)
    n_live = (lens + 63) // 64
    for lane in range(6):
        dead = slice(int(n_live[lane]), None)
        assert torch.all(m[lane, :, dead] == -1e30)
        assert torch.all(l[lane, :, dead] == 0)
        assert torch.all(acc[lane, :, dead] == 0)
    # the merge over the live chunks alone gives the same bits
    for lane in range(1, 6):
        c = int(n_live[lane])
        sl = slice(lane, lane + 1)
        whole = merge_partials(m[sl], l[sl], acc[sl], torch.float32)
        live = merge_partials(m[sl, :, :c], l[sl, :, :c], acc[sl, :, :c],
                              torch.float32)
        assert torch.equal(whole, live)
    # a partly live chunk: the dead keys' values change nothing
    k2, v2 = k.clone(), v.clone()
    k2[1, :, 7:64] = 5.0
    v2[1, :, 7:64] = -3.0
    m2, l2, acc2 = split_partials(q, k2, v2, lens, ch=64)
    assert torch.equal(acc2[1], acc[1]) and torch.equal(l2[1], l[1])


# ----------------------------------------------------------------------
# on the card: the CUDA kernels against their plain version
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("s", [1024, 1000])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_dense_decode_kernels_on_card(dtype, tol, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    dt = getattr(torch, dtype)
    q, k, v, lens = _inputs(12, 2, s, d=128)
    lens = np.minimum(lens, s).astype(np.int32)
    args = [torch.from_numpy(a).cuda() for a in (q, k, v, lens)]
    args[:3] = [a.to(dt) for a in args[:3]]
    la = decode_attention(*args)
    masked = decode_attention(*args, length_aware=False)
    ref = decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert (la.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(la, masked)
    assert torch.all(la[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1024, 1000])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_dense_split_repeats_bitwise_on_card(dtype, tol, s):
    """K3 and K6a at the serve's widths (B 8 lanes, H 12, Hkv 2, D 128):
    one launch each, every call the same bits, K3 equal to K6a, both
    within ``tol`` of the plain chunked version and 0 on a dead lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s)
    q = rng.standard_normal((8, 12, 128)).astype(np.float32)
    k = rng.standard_normal((8, 2, s, 128)).astype(np.float32)
    v = rng.standard_normal((8, 2, s, 128)).astype(np.float32)
    lens = np.minimum([0, 1, 15, 16, 17, 300, 777, 1024], s).astype(np.int32)
    args = [torch.from_numpy(a).cuda() for a in (q, k, v, lens)]
    args[:3] = [a.to(dt) for a in args[:3]]
    before = launch_counts()
    outs = [decode_attention(*args, length_aware=la)
            for la in (True, True, False, False)]
    after = launch_counts()
    assert after["decode_attention_lengthaware"] - \
        before["decode_attention_lengthaware"] == 2
    assert after["decode_attention_masked"] - \
        before["decode_attention_masked"] == 2
    plain = decode_attention_split_ref(*args, ch=split_plan(s, 8, 2)[0])
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert (outs[0].float() - plain.float()).abs().max().item() <= tol
    assert torch.all(outs[0][0] == 0)
