"""int8 KV decode attention (K5 length-aware, K6b masked, K4 paged) and
the int8 decode step against the reference.

On the CPU each q8 wrapper takes its plain PyTorch version; that is held
against the reference's jnp oracles and its Pallas kernels
(``decode_attention_q8_lengthaware_pallas``, ``decode_attention_q8_pallas``,
``decode_attention_paged_q8_pallas``) in interpret mode, on the same
numpy inputs, at the model's ``qblock=1`` and at the kernels' own (32
dense, 16 for 16-token pages), with tolerance 1e-5 (float32, sums in
another order); K4's chunked plain version (the split kernel's
algorithm, ``decode_attention_paged_q8_split_ref``) the same way, over
pages of 8, 16 and 32.  Quantization is held bitwise: int8 values and f32
scales equal the reference's on the same input.  The CUDA kernels are
held against the plain versions by the ``cuda`` tests, which skip where
there is no card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_paged_q8_pallas, decode_attention_q8_lengthaware_pallas,
    decode_attention_q8_pallas)
from repro.kernels.decode_attention import \
    decode_attention_paged_q8_ref as jax_paged_q8_ref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention_q8_ref as jax_q8_ref  # noqa: E402
from repro.kernels.decode_attention import \
    quantize_kv_q8 as jax_quantize_kv_q8  # noqa: E402
from repro.models.attention import \
    attention_decode as jax_attention_decode  # noqa: E402
from repro.models.attention import \
    attention_decode_paged as jax_attention_decode_paged  # noqa: E402
from repro.models.attention import \
    quantize_kv_token as jax_quantize_kv_token  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_paged, decode_attention_paged_q8,
    decode_attention_paged_q8_ref, decode_attention_paged_q8_split_ref,
    decode_attention_q8, decode_attention_q8_ref, dequant_kv_q8,
    gather_pages, quantize_kv_q8, split_plan)
from repro_torch.kernels.decode_attention.ops import CHUNKS  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    attention_decode, attention_decode_paged, quantize_kv_token)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = 1e-5


def _q8_cache(rng, shape, qblock):
    """int8 values over the whole range and positive f32 scales, one per
    ``qblock`` positions of axis 2."""
    kq = rng.integers(-127, 128, shape).astype(np.int8)
    sshape = shape[:2] + (shape[2] // qblock, 1)
    ks = rng.uniform(0.002, 0.05, sshape).astype(np.float32)
    return kq, ks


def _dense_inputs(h, hkv, s, qblock, d=32, seed=0):
    rng = np.random.default_rng(seed)
    b = 6
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kq, ks = _q8_cache(rng, (b, hkv, s, d), qblock)
    vq, vs = _q8_cache(rng, (b, hkv, s, d), qblock)
    # dead lane, sub-block, half, half + 3, full, full
    lens = np.array([0, 7, s // 2, s // 2 + 3, s, s], np.int32)
    return q, kq, ks, vq, vs, lens


def _paged_inputs(h, hkv, qblock, d=32, ps=16, t=4, n_pages=30, seed=0):
    rng = np.random.default_rng(seed)
    b = 5
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp, ksp = _q8_cache(rng, (n_pages, hkv, ps, d), qblock)
    vp, vsp = _q8_cache(rng, (n_pages, hkv, ps, d), qblock)
    # disjoint, shuffled tables: physical naming must not show in the math
    bt = rng.permutation(n_pages)[:b * t].reshape(b, t).astype(np.int32)
    lens = np.array([0, 7, 16, 33, t * ps], np.int32)
    return q, kp, ksp, vp, vsp, bt, lens


# ----------------------------------------------------------------------
# quantization: bitwise against the reference
# ----------------------------------------------------------------------

def _kv_rows(shape, seed=0):
    """Normal rows plus an all-zero row (scale 0 -> 1) and a row whose
    quotients fall on .5 ties (round half to even)."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    ties = np.arange(shape[-1], dtype=np.float32) - shape[-1] / 2 + 0.5
    ties[0] = 127.0                        # amax 127: scale exactly 1
    flat[1] = ties
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 2, 32), (2, 2, 9, 32)])
def test_quantize_kv_token_matches_reference(dtype, shape):
    x = _kv_rows(shape)
    tq, ts = quantize_kv_token(torch.from_numpy(x).to(getattr(torch, dtype)))
    jq, js = jax_quantize_kv_token(jnp.asarray(x).astype(getattr(jnp, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == shape[:-1] + (1,)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.all(ts.numpy().reshape(-1)[0] == 1.0)       # zero row
    assert set(np.unique(tq.numpy().reshape(-1, shape[-1])[1, 1:] % 2)) \
        <= {0}                                          # ties went even


@pytest.mark.parametrize("qblock", [1, 32])
def test_quantize_kv_q8_matches_reference(qblock):
    x = _kv_rows((2, 2, 64, 32))
    tq, ts = quantize_kv_q8(torch.from_numpy(x), qblock)
    jq, js = jax_quantize_kv_q8(jnp.asarray(x), qblock)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    back = dequant_kv_q8(tq, ts, qblock).numpy()
    assert np.max(np.abs(back - x)) <= np.max(ts.numpy()) / 2 + 1e-6


# ----------------------------------------------------------------------
# plain q8 versions against the reference's oracles and Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("qblock", [1, 32])
@pytest.mark.parametrize("h,hkv", [(4, 4), (12, 2)])
def test_dense_q8_plain_matches_pallas(h, hkv, qblock):
    args = _dense_inputs(h, hkv, 64, qblock)
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    before = launch_counts()
    la = decode_attention_q8(*targs, qblock=qblock).numpy()
    masked = decode_attention_q8(*targs, qblock=qblock,
                                 length_aware=False).numpy()
    assert launch_counts() == before        # CPU: plain version, no launch
    ref = np.asarray(jax_q8_ref(*jargs, qblock=qblock))
    pallas_la = np.asarray(decode_attention_q8_lengthaware_pallas(
        *jargs, qblock=qblock, interpret=True))
    pallas_masked = np.asarray(decode_attention_q8_pallas(
        *jargs, qblock=qblock, interpret=True))
    for out in (la, masked):
        assert np.max(np.abs(out - ref)) < TOL
        assert np.max(np.abs(out - pallas_la)) < TOL
        assert np.max(np.abs(out - pallas_masked)) < TOL
        assert np.all(out[0] == 0.0)        # dead lane: exactly 0
    assert np.array_equal(la, masked)


@pytest.mark.parametrize("qblock", [1, 16])
@pytest.mark.parametrize("h,hkv", [(4, 4), (12, 2)])
def test_paged_q8_plain_matches_pallas(h, hkv, qblock):
    args = _paged_inputs(h, hkv, qblock)
    before = launch_counts()
    out = decode_attention_paged_q8(*map(torch.from_numpy, args),
                                    qblock=qblock).numpy()
    assert launch_counts() == before
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jax_paged_q8_ref(*jargs, qblock=qblock))
    pallas = np.asarray(decode_attention_paged_q8_pallas(
        *jargs, qblock=qblock, interpret=True))
    assert np.max(np.abs(out - ref)) < TOL
    assert np.max(np.abs(out - pallas)) < TOL
    assert np.all(out[0] == 0.0)


#: pages per lane for each page size: T*ps (104, 112, 160) is not a
#: multiple of the 64-position chunk
SPLIT_T = {8: 13, 16: 7, 32: 5}


def _split_paged_inputs(h, hkv, ps, qblock, d=32, seed=1):
    """int8 pools with a scratch page 0 (values 127, scales 1) that the
    table slots past each lane's length point at; lengths: a dead lane,
    inside the first page, three past a page edge, across a 32-position
    chunk edge, one short of full, past T*ps (clamped)."""
    rng = np.random.default_rng(seed)
    t = SPLIT_T[ps]
    b = 6
    n_pages = b * t + 1
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp, ksp = _q8_cache(rng, (n_pages, hkv, ps, d), qblock)
    vp, vsp = _q8_cache(rng, (n_pages, hkv, ps, d), qblock)
    for a in (kp, vp):
        a[0] = 127
    for a in (ksp, vsp):
        a[0] = 1.0
    bt = (1 + rng.permutation(n_pages - 1)).reshape(b, t).astype(np.int32)
    lens = np.array([0, 5, ps + 3, 40, t * ps - 1, t * ps + 7], np.int32)
    for lane, n in enumerate(lens):
        bt[lane, -(-min(int(n), t * ps) // ps):] = 0
    return q, kp, ksp, vp, vsp, bt, lens


@pytest.mark.parametrize("ps,qblock", [(8, 1), (16, 1), (16, 16),
                                       (32, 16)])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (12, 2)])
def test_paged_q8_split_plain_matches_pallas(h, hkv, ps, qblock):
    """K4 as the split kernel computes it (chunks of 32 and of 64 over
    the lane's T*ps positions, each element times its scale in f32)
    against the reference's interpret-mode Pallas kernel and its jnp
    oracle, at the model's qblock 1 and the reference kernel's 16; the
    dead lane gives exactly 0."""
    args = _split_paged_inputs(h, hkv, ps, qblock)
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(decode_attention_paged_q8_pallas(
        *jargs, qblock=qblock, interpret=True))
    ref = np.asarray(jax_paged_q8_ref(*jargs, qblock=qblock))
    targs = [torch.from_numpy(a) for a in args]
    assert SPLIT_T[ps] * ps % CHUNKS[1]
    for ch in CHUNKS:
        out = decode_attention_paged_q8_split_ref(*targs, ch=ch,
                                                  qblock=qblock)
        assert np.max(np.abs(out.numpy() - ref)) < TOL
        assert np.max(np.abs(out.numpy() - pallas)) < TOL
        assert torch.all(out[0] == 0.0)


def test_qblock1_is_the_models_route():
    """At ``qblock=1`` the q8 wrappers compute what the reference model
    computes: dequantize with per-token scales, then fp decode."""
    q, kq, ks, vq, vs, lens = map(torch.from_numpy,
                                  _dense_inputs(12, 2, 64, 1))
    route = decode_attention(q, kq.float() * ks, vq.float() * vs, lens)
    assert torch.equal(decode_attention_q8(q, kq, ks, vq, vs, lens,
                                           qblock=1), route)
    q, kp, ksp, vp, vsp, bt, lens = map(torch.from_numpy,
                                        _paged_inputs(12, 2, 1))
    route = decode_attention_paged(q, kp.float() * ksp, vp.float() * vsp,
                                   bt, lens)
    assert torch.equal(decode_attention_paged_q8(q, kp, ksp, vp, vsp, bt,
                                                 lens, qblock=1), route)


def test_q8_scale_passes_through():
    args = _dense_inputs(12, 2, 64, 32)
    out = decode_attention_q8(*map(torch.from_numpy, args),
                              scale=0.3).numpy()
    ref = np.asarray(jax_q8_ref(*map(jnp.asarray, args), scale=0.3))
    assert np.max(np.abs(out - ref)) < TOL


def test_q8_wrappers_reject_unsupported_device():
    dense = [torch.from_numpy(a).to("meta")
             for a in _dense_inputs(4, 2, 64, 32)]
    paged = [torch.from_numpy(a).to("meta") for a in _paged_inputs(4, 2, 16)]
    with pytest.raises(ValueError):
        decode_attention_q8(*dense)
    with pytest.raises(ValueError):
        decode_attention_paged_q8(*paged, qblock=16)


@pytest.mark.parametrize("bad", ["kv_bf16", "scale_f64", "scale_shape",
                                 "qblock_divides", "strided_scale",
                                 "scale_device", "v_int16"])
def test_q8_input_checks(bad):
    """The checks a CUDA launch of K4/K5/K6b passes first turn away what
    the kernels do not take: int8 values, f32 scales of shape
    (..., rows/qblock, 1) with rows % qblock == 0, contiguous."""
    from repro_torch.kernels.decode_attention import ops
    q, kq, ks, vq, vs, lens = map(torch.from_numpy,
                                  _dense_inputs(12, 2, 64, 32))
    qblock = 32
    ints = {"kv_lengths": lens}
    ops._check_q8(q, kq, ks, vq, vs, ints, "(B,Hkv,S,D)", qblock)  # accepted
    if bad == "kv_bf16":
        kq = kq.to(torch.bfloat16)
    elif bad == "scale_f64":
        ks = ks.double()
    elif bad == "scale_shape":
        ks = torch.ones(ks.shape[:2] + (ks.shape[2] * 2, 1))
    elif bad == "qblock_divides":
        qblock = 24
    elif bad == "strided_scale":
        vs = torch.ones(vs.shape[:3] + (2,))[..., :1]
    elif bad == "scale_device":
        vs = vs.to("meta")
    else:
        vq = vq.to(torch.int16)
    with pytest.raises((TypeError, ValueError)):
        ops._check_q8(q, kq, ks, vq, vs, ints, "(B,Hkv,S,D)", qblock)


# ----------------------------------------------------------------------
# one int8 decode step of one layer against the reference
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32", kv_quant="int8")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32", kv_quant="int8")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg,
                             torch.device("cpu"))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])["attn"]
    return jcfg, jp, cfg, params.blocks[0].attn


def _same_writes(mine, ref):
    """int8 rows equal; scales equal up to float32 rounding: the
    projected K/V row the step quantizes comes from a matmul whose sums
    run in another order in the two frameworks, so its ``amax`` (and the
    scale) can differ in the last bit.  Quantization of one same input
    is held bitwise above."""
    for m, r in zip(mine[:2], ref[:2]):
        assert np.array_equal(m.numpy(), np.asarray(r))
    for m, r in zip(mine[2:], ref[2:]):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)


def test_attention_decode_int8_step_matches_reference(layer):
    """Writes the quantized row and its scale at the ring slot in place
    and attends through the q8 wrapper (``qblock=1``), as the
    reference's ``attention_decode`` does with its dequantized cache."""
    jcfg, jp, cfg, p = layer
    rng = np.random.default_rng(3)
    b, smax = 3, 16
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kc, ks = _q8_cache(rng, (b, cfg.n_kv_heads, smax, cfg.hd), 1)
    vc, vs = _q8_cache(rng, (b, cfg.n_kv_heads, smax, cfg.hd), 1)
    clen = np.array([0, 9, 20], np.int32)   # 20 wraps the ring (slot 4)
    jout, jk, jv, jks, jvs = jax_attention_decode(
        jp, jnp.asarray(x), jcfg, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(clen), jnp.asarray(ks), jnp.asarray(vs))
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs))
    out, *caches = attention_decode(p, torch.from_numpy(x), cfg, tk, tv,
                                    torch.from_numpy(clen), tks, tvs)
    assert all(a is b for a, b in zip(caches, (tk, tv, tks, tvs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)
    _same_writes((tk, tv, tks, tvs), (jk, jv, jks, jvs))


def test_attention_decode_paged_int8_step_matches_reference(layer):
    jcfg, jp, cfg, p = layer
    rng = np.random.default_rng(4)
    b, ps, t, n_pages = 3, 8, 3, 10
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kp, ksp = _q8_cache(rng, (n_pages, cfg.n_kv_heads, ps, cfg.hd), 1)
    vp, vsp = _q8_cache(rng, (n_pages, cfg.n_kv_heads, ps, cfg.hd), 1)
    bt = rng.permutation(n_pages)[:b * t].reshape(b, t).astype(np.int32)
    clen = np.array([0, 11, 26], np.int32)  # 26 wraps 24 positions
    jout, jk, jv, jks, jvs = jax_attention_decode_paged(
        jp, jnp.asarray(x), jcfg, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(clen), jnp.asarray(ksp),
        jnp.asarray(vsp))
    tk, tv, tks, tvs = (torch.from_numpy(a.copy())
                        for a in (kp, vp, ksp, vsp))
    out, *caches = attention_decode_paged(
        p, torch.from_numpy(x), cfg, tk, tv, torch.from_numpy(bt),
        torch.from_numpy(clen), tks, tvs)
    assert all(a is b for a, b in zip(caches, (tk, tv, tks, tvs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)
    _same_writes((tk, tv, tks, tvs), (jk, jv, jks, jvs))


# ----------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("s,qblock", [(1024, 1), (1024, 32), (1000, 1)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_dense_q8_kernels_on_card(dtype, tol, s, qblock):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    q, kq, ks, vq, vs, lens = _dense_inputs(12, 2, s, qblock, d=128)
    args = [torch.from_numpy(a).cuda() for a in (q, kq, ks, vq, vs, lens)]
    args[0] = args[0].to(getattr(torch, dtype))
    la = decode_attention_q8(*args, qblock=qblock)
    masked = decode_attention_q8(*args, qblock=qblock, length_aware=False)
    ref = decode_attention_q8_ref(*args, qblock=qblock)
    torch.cuda.synchronize()
    assert (la.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(la, masked)
    assert torch.all(la[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("qblock", [1, 16])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_paged_q8_kernel_on_card(dtype, tol, qblock):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    args = [torch.from_numpy(a).cuda()
            for a in _paged_inputs(12, 2, qblock, d=128, t=64,
                                   n_pages=5 * 64 + 1)]
    args[0] = args[0].to(getattr(torch, dtype))
    out = decode_attention_paged_q8(*args, qblock=qblock)
    again = decode_attention_paged_q8(*args, qblock=qblock)
    ref = decode_attention_paged_q8_ref(*args, qblock=qblock)
    q, kp, ksp, vp, vsp, bt, lens = args
    k5 = decode_attention_q8(q, gather_pages(kp, bt), gather_pages(ksp, bt),
                             gather_pages(vp, bt), gather_pages(vsp, bt),
                             lens, qblock=qblock)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.all(out[0] == 0)
    assert torch.equal(out, again)          # repeats bit for bit
    assert torch.equal(out, k5)             # K5 on the gathered pools


@pytest.mark.cuda
@pytest.mark.parametrize("ps,qblock", [(8, 1), (16, 1), (16, 16),
                                       (32, 16)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_paged_q8_split_kernel_on_card(dtype, tol, ps, qblock):
    """K4 at the serve's widths (H 12, Hkv 2, D 128) over pages of 8, 16
    and 32: within ``tol`` of its chunked plain version, the bits of K5
    at the same qblock on the gathered pools and of its own second
    call, 0 on the dead lane, and table slots past the length -- page
    ids far outside the pools -- never read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    q, kp, ksp, vp, vsp, bt, lens = (
        torch.from_numpy(a).cuda()
        for a in _split_paged_inputs(12, 2, ps, qblock, d=128))
    q = q.to(getattr(torch, dtype))
    wild = bt.clone()
    for lane, n in enumerate(lens.tolist()):
        wild[lane, -(-min(n, bt.shape[1] * ps) // ps):] = 1 << 30
    outs = [decode_attention_paged_q8(q, kp, ksp, vp, vsp, wild, lens,
                                      qblock=qblock) for _ in range(2)]
    ch = split_plan(bt.shape[1] * ps, 6, 2)[0]
    plain = decode_attention_paged_q8_split_ref(q, kp, ksp, vp, vsp, bt,
                                                lens, ch=ch, qblock=qblock)
    k5 = decode_attention_q8(q, gather_pages(kp, bt), gather_pages(ksp, bt),
                             gather_pages(vp, bt), gather_pages(vsp, bt),
                             lens, qblock=qblock)
    torch.cuda.synchronize()
    assert (outs[0].float() - plain.float()).abs().max().item() <= tol
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], k5)
    assert torch.all(outs[0][0] == 0)
