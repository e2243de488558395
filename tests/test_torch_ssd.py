"""The port's SSD scan (K10's plain version, the full SSD on it, the
Mamba-2 block and the ssm model) against the reference.

Inputs are made with numpy from a seed and fed to both packages.  The
reference's Pallas kernel runs in interpret mode, as its own tests run
it on the CPU.  Tolerances: the intra-chunk pass 1e-5 on ``y_intra``
and ``states`` and 1e-6 on the decay (the reference's own test); the
full SSD 1e-5 against ``ssd_pallas`` and ``ssd_chunked`` and 1e-4
against the step recurrence (a different summation); the block and the
model in float32 1e-5 (both sum the same products in other orders).
The kernel's split TF32 arithmetic is emulated here in plain PyTorch
and held within 1e-6 of the plain version (one TF32 product is not);
the ``cuda`` test holds K10 to its plain version on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunk_pallas, ssd_intra_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.kernels.ssd_scan import ssd_naive as jax_ssd_naive  # noqa: E402
from repro.kernels.ssd_scan import ssd_pallas  # noqa: E402
from repro.models.ssm import mamba2_decode as jax_mamba2_decode  # noqa: E402
from repro.models.ssm import mamba2_forward as jax_mamba2_forward  # noqa: E402
from repro.models.ssm import init_mamba2_state as jax_init_state  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.models.transformer import lm_forward as jax_lm_forward  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import breakdown, launch_counts  # noqa: E402
from repro_torch.kernels._sass import (SASS_KERNELS, SASS_LIBS,  # noqa: E402
                                       check_counts, kernel_counts,
                                       parse_sass)
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk,  # noqa: E402
                                          ssd_chunk_ref, ssd_chunked,
                                          ssd_naive)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.ssm import (_dims, init_mamba2_state,  # noqa: E402
                                    mamba2_decode, mamba2_forward)
from repro_torch.models.transformer import lm_prefill_batched  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
#: the reference test's three shapes (B, S, H, P, N, chunk) and SMOKE's
#: (d_inner 256 / head_dim 32 = 8 heads, N 16, chunk 32)
SHAPES = [(1, 64, 2, 8, 4, 16), (2, 128, 3, 16, 8, 32),
          (1, 256, 2, 32, 16, 64), (2, 96, 8, 32, 16, 32)]


def _inputs(b, s, h, p, n, seed=0, a_model_range=False):
    """x, dt, a, b, c as float32 numpy: dt = softplus(randn) * 0.2 and
    A = -exp(0.3 randn), as the reference's test; or with
    ``a_model_range`` dt = softplus(randn + dt_bias) and A =
    -linspace(1, 16, H), the model's range."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    raw = rng.standard_normal((b, s, h))
    if a_model_range:
        dt = np.logaddexp(raw + np.log(np.expm1(0.01)), 0.0)
        a = -np.linspace(1.0, 16.0, h)
    else:
        dt = np.logaddexp(raw, 0.0) * 0.2
        a = -np.exp(0.3 * rng.standard_normal(h))
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt.astype(np.float32), a.astype(np.float32), bm, cm


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("model_range", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_chunk_matches_pallas_and_intra_ref(shape, model_range):
    b, s, h, p, n, chunk = shape
    args = _inputs(b, s, h, p, n, a_model_range=model_range)
    jargs = [jnp.asarray(a) for a in args]
    pallas = ssd_chunk_pallas(*jargs, chunk=chunk, interpret=True)
    intra = ssd_intra_ref(*jargs, chunk=chunk)
    before = launch_counts()
    ours = ssd_chunk(*_torch(args), chunk=chunk)
    assert launch_counts() == before          # CPU: the plain version
    plain = ssd_chunk_ref(*_torch(args), chunk)
    nc = s // chunk
    assert tuple(ours[0].shape) == (b, s, h, p)
    assert tuple(ours[1].shape) == (b, nc, h, n, p)
    assert tuple(ours[2].shape) == (b, nc, h)
    for ref in (pallas, intra):
        for got, want, tol in zip(ours, ref, (1e-5, 1e-5, 1e-6)):
            assert got.dtype == torch.float32
            assert _err(got, want) < tol
    for got, want in zip(ours, plain):
        assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_full_ssd_matches_pallas_chunked_and_naive(chunk):
    args = _inputs(2, 64, 2, 8, 4, seed=1)
    jargs = [jnp.asarray(a) for a in args]
    ours = ssd(*_torch(args), chunk=chunk)
    assert _err(ours, ssd_pallas(*jargs, chunk=chunk, interpret=True)) < 1e-5
    assert _err(ours, jax_ssd_chunked(*jargs, chunk=chunk)) < 1e-5
    assert _err(ours, jax_ssd_naive(*jargs)) < 1e-4


@pytest.mark.parametrize("s,chunk", [(96, 64), (96, 32), (20, 32)])
def test_full_ssd_pads_to_the_chunk(s, chunk):
    """A length that is not a multiple of the chunk is zero-padded (dt
    0) as ``ssd_chunked`` pads it; a length below the chunk is one
    chunk of its own length."""
    args = _inputs(1, s, 3, 8, 4, seed=2, a_model_range=True)
    jargs = [jnp.asarray(a) for a in args]
    ours = ssd(*_torch(args), chunk=chunk)
    assert tuple(ours.shape) == (1, s, 3, 8)
    assert _err(ours, jax_ssd_chunked(*jargs, chunk=chunk)) < 1e-5
    assert _err(ours, jax_ssd_naive(*jargs)) < 1e-4
    if s % min(chunk, s) == 0:
        assert _err(ours, ssd_pallas(*jargs, chunk=chunk,
                                     interpret=True)) < 1e-5


def test_oracle_copies_match_the_reference():
    args = _inputs(2, 80, 3, 8, 4, seed=3)
    jargs = [jnp.asarray(a) for a in args]
    targs = _torch(args)
    assert _err(ssd_chunked(*targs, chunk=32),
                jax_ssd_chunked(*jargs, chunk=32)) < 1e-5
    assert _err(ssd_naive(*targs), jax_ssd_naive(*jargs)) < 1e-5


def test_bf16_inputs_are_computed_in_float32():
    """x/b/c in bfloat16 are read as their float32 values: the same
    outputs as the float32 copies of those values."""
    x, dt, a, b, c = _torch(_inputs(1, 64, 2, 8, 4, seed=4))
    xb, bb, cb = (t.to(torch.bfloat16) for t in (x, b, c))
    got = ssd_chunk(xb, dt, a, bb, cb, chunk=32)
    want = ssd_chunk(xb.float(), dt, a, bb.float(), cb.float(), chunk=32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    y = ssd(xb, dt, a, bb, cb, chunk=32)
    assert y.dtype == torch.bfloat16


# ----------------------------------------------------------------------
# the kernel's arithmetic, emulated: TF32 parts and the split products
# ----------------------------------------------------------------------

def _tf32(v):
    """float32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (to
    nearest, ties away from zero: add half of the 13 dropped bits to the
    magnitude, then clear them)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _emulated_chunk(x, dt, a, b, c, parts, cum):
    """``(y_intra, states)`` of one chunk (B 1, S = Q) as the kernel
    computes them, from ``cum`` (H, Q), the cumsum of f32 ``dt * a``: each
    difference ``cum_i - cum_j`` taken in ``cum``'s dtype and rounded to
    f32 before its exp; C.B^T exact for bf16 and 3xTF32 for f32; ``W' =
    (C.B^T) exp(cum_i - cum_j) dt_j`` and ``B_j exp(cum_{Q-1} - cum_j)
    dt_j`` rounded to f32; their products with the raw x taken as
    ``parts`` TF32 products: 1 (one TF32 product), 2 (``A_hi x_hi + A_lo
    x_hi``, as exact as the kernel's three bf16 parts of A for bf16 x) or
    3 (3xTF32, ``+ A_hi x_lo``), each product exact and the sums in f64."""
    f64 = torch.float64
    xf, bf, cf = x[0].float(), b[0].float(), c[0].float()
    q = xf.shape[0]
    if x.dtype == torch.bfloat16:
        g = (cf.to(f64) @ bf.to(f64).T).float()
    else:
        (ch, cl), (bh, bl) = _split(cf), _split(bf)
        g = sum(u.to(f64) @ v.to(f64).T
                for u, v in ((cl, bh), (ch, bl), (ch, bh))).float()
    mask = torch.ones(q, q, dtype=torch.bool).tril()
    seg = (cum[:, :, None] - cum[:, None, :]).float()
    decay = torch.exp(seg.masked_fill(~mask, float("-inf")))
    w = (g[None] * decay) * dt[0].T[:, None, :]                     # (H,Q,Q)
    to_end = torch.exp((cum[:, -1:] - cum).float()) * dt[0].T
    bw = (bf[None] * to_end[..., None]).transpose(1, 2)             # (H,N,Q)
    xh = xf.permute(1, 0, 2)                                        # (H,Q,P)

    def products(lhs):
        if parts == 1:
            return (_tf32(lhs).to(f64) @ _tf32(xh).to(f64)).float()
        (lh, ll), (rh, rl) = _split(lhs), _split(xh)
        out = ll.to(f64) @ rh.to(f64) + lh.to(f64) @ rh.to(f64)
        if parts == 3:
            out = out + lh.to(f64) @ rl.to(f64)
        return out.float()
    return products(w).permute(1, 0, 2)[None], products(bw)[None, None]


def _chunk_oracle(x, dt, a, b, c):
    """``(y_intra, states)`` of one chunk in float64 from the same
    (rounded) inputs."""
    f64 = torch.float64
    xf, bf, cf = x[0].to(f64), b[0].to(f64), c[0].to(f64)
    q = xf.shape[0]
    cum = torch.cumsum(dt[0].to(f64) * a.to(f64)[None], 0).T
    mask = torch.ones(q, q, dtype=torch.bool).tril()
    seg = (cum[:, :, None] - cum[:, None, :]).masked_fill(~mask,
                                                          float("-inf"))
    w = (cf @ bf.T)[None] * torch.exp(seg) * dt[0].T.to(f64)[:, None, :]
    to_end = torch.exp(cum[:, -1:] - cum) * dt[0].T.to(f64)
    xh = xf.permute(1, 0, 2)
    bw = (bf[None] * to_end[..., None]).transpose(1, 2)
    return (w @ xh).permute(1, 0, 2)[None], (bw @ xh)[None, None]


def _rel(got, want):
    return [float((g.double() - w.double()).abs().max()
                  / w.double().abs().max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("dtype,parts", [("bfloat16", 2), ("float32", 3)])
def test_split_products_hold_the_plain_version(dtype, parts):
    """At mamba2-780m's widths on one chunk (Q 256, H 48, P 64, N 128, A
    over the model's range), the kernel's split products, fed the plain
    version's cumsum, stay within 1e-6 relative of ``ssd_chunk_ref``:
    two TF32 parts (or three bf16 parts) of A for bf16 x/b/c (x is exact),
    3xTF32 for float32.  One TF32 product misses the card's 1e-5
    tolerance, and two miss it for float32 x."""
    x, dt, a, b, c = _torch(_inputs(1, 256, 48, 64, 128, seed=9,
                                    a_model_range=True))
    dty = getattr(torch, dtype)
    args = (x.to(dty), dt, a, b.to(dty), c.to(dty))
    want = ssd_chunk_ref(*args, 256)[:2]
    cum = torch.cumsum(dt[0] * a[None, :], 0).T          # the plain version's
    assert max(_rel(_emulated_chunk(*args, parts, cum), want)) <= 1e-6
    assert min(_rel(_emulated_chunk(*args, 1, cum), want)) > 1e-5
    if dtype == "float32":
        assert min(_rel(_emulated_chunk(*args, 2, cum), want)) > 1e-5


@pytest.mark.parametrize("dtype,parts", [("bfloat16", 2), ("float32", 3)])
def test_cumsum_in_f64_keeps_long_chunks_exact(dtype, parts):
    """At the longest chunk (Q 1024, A to -16) the kernel keeps the cumsum
    in f64 and rounds each difference ``cum_i - cum_j`` once: within
    1e-6 of a float64 oracle.  Rounding each cum to f32 first (as a
    float32 cumsum does) puts an ulp of |cum| ~ 270 into the exponent of
    every near-diagonal weight: more than 1e-5 off, the card's whole
    tolerance."""
    x, dt, a, b, c = _torch(_inputs(1, 1024, 8, 64, 128, seed=9,
                                    a_model_range=True))
    dty = getattr(torch, dtype)
    args = (x.to(dty), dt, a, b.to(dty), c.to(dty))
    want = _chunk_oracle(*args)
    cum = torch.cumsum((dt[0] * a[None, :]).double(), 0).T
    assert max(_rel(_emulated_chunk(*args, parts, cum), want)) <= 1e-6
    assert max(_rel(_emulated_chunk(*args, parts, cum.float()), want)) > 1e-5


def test_kernel_takes_every_admitted_shape():
    """One kernel pair takes every shape the wrapper admits -- any chunk
    from 1 to 1024, N <= 128, P <= 64, at most 65535 chunks -- with a
    C.B^T workspace of ``QP x QP`` floats a chunk (``QP``: the chunk
    rounded up to 64); the wrapper refuses the rest before any launch."""
    meta = torch.device("meta")

    def args(bsz, s, h, p, n, dtype=torch.bfloat16):
        return (torch.empty(bsz, s, h, p, device=meta, dtype=dtype),
                torch.empty(bsz, s, h, device=meta),
                torch.empty(h, device=meta),
                torch.empty(bsz, s, n, device=meta, dtype=dtype),
                torch.empty(bsz, s, n, device=meta, dtype=dtype))
    for q, n, p in ((1, 1, 1), (8, 128, 64), (32, 16, 32), (256, 128, 64),
                    (1000, 100, 48), (1024, 128, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            ssd_ops._check(*args(2, 2 * q, 3, p, n, dtype), q)
    for q, n, p in ((8, 129, 64), (8, 128, 65), (1025, 16, 32)):
        with pytest.raises(ValueError):
            ssd_ops._check(*args(1, q, 3, p, n), q)
    with pytest.raises(ValueError, match="chunks"):
        ssd_ops._check(*args(1, 65536, 1, 8, 4), 1)
    assert ssd_ops.workspace_floats(1, 1024, 256) == 4 * 256 * 256
    assert ssd_ops.workspace_floats(2, 2048, 256) == 16 * 256 * 256
    assert ssd_ops.workspace_floats(1, 8, 8) == 64 * 64
    assert ssd_ops.workspace_floats(2, 300, 100) == 6 * 128 * 128
    assert ssd_ops.workspace_floats(1, 1024, 1024) == 1024 * 1024


@pytest.mark.parametrize("variant", list(breakdown.TARGETS["k10"][1]))
def test_k10_breakdown_cuts_match_the_source(variant):
    """Every cut of the ``k10`` breakdown finds its text exactly once in
    ``csrc/ssd_scan.cu`` and changes it (``full`` leaves it as it is);
    every cut of the source's table is used by some variant."""
    source, variants = breakdown.TARGETS["k10"]
    assert source == "ssd_scan"
    text = breakdown.source_text(source)
    cut = breakdown.source_with(source, variants[variant])
    assert (cut == text) == (variant == "full")
    assert {c for cuts in variants.values() for c in cuts} \
        == set(breakdown.CUTS[source])


_SASS_SSD = """
        Function : _ZN12_GLOBAL__N_110ssd_cb_f32EPKfS1_Pfii
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        Function : _ZN12_GLOBAL__N_111ssd_cb_bf16EPK13__nv_bfloat16S2_Pfii
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        Function : _ZN12_GLOBAL__N_113ssd_chunk_f32EPKfS1_S1_S1_S1_PfS2_S2_iiii
        /*0000*/                   MUFU.EX2 R5, R5 ;
        /*0010*/                   HMMA.1688.F32.TF32 R20, R8, R12, R20 ;
        Function : _ZN12_GLOBAL__N_114ssd_chunk_bf16EPK13__nv_bfloat16PKfS4_S2_S4_PfS5_S5_iiii
        /*0000*/                   FFMA R5, R4, R2, R3 ;
        /*0010*/                   HMMA.1688.F32.TF32 R20, R8, R12, R20 ;
"""


@pytest.mark.parametrize("edit,breach", [
    (None, None),
    (("HMMA.1688.F32.TF32 R4, R8, R12, R4", "FFMA R4, R8, R12, R4"),
     "ssd_cb_f32"),
    (("HMMA.16816.F32.BF16 R4, R8, R12, R4", "FMUL R4, R8, R12"),
     "ssd_cb_bf16"),
    (("MUFU.EX2 R5, R5 ;\n        /*0010*/                   HMMA.1688.F32."
      "TF32 R20, R8, R12, R20", "MUFU.EX2 R5, R5 ;\n        /*0010*/       "
      "            FFMA R20, R8, R12, R20"), "ssd_chunk_f32"),
])
def test_sass_rules_cover_the_ssd_kernels(edit, breach):
    """K10's four kernels (C.B^T and the per-head products, each in f32
    and bf16) must run HMMA (``mma.sync``); one that lost it is named."""
    text = _SASS_SSD if edit is None else _SASS_SSD.replace(*edit)
    assert text.count(edit[1]) == 1 if edit else True
    found = kernel_counts(parse_sass(text))
    assert set(found) == {"ssd_cb_f32", "ssd_cb_bf16", "ssd_chunk_f32",
                          "ssd_chunk_bf16"} <= set(SASS_KERNELS)
    assert "ssd_scan" in SASS_LIBS
    problems = [p for p in check_counts(found) if "not found" not in p]
    assert [p.split()[0] for p in problems] == ([breach] if breach else [])


def test_wrapper_checks():
    x, dt, a, b, c = _torch(_inputs(1, 64, 2, 8, 4))
    with pytest.raises(ValueError):
        ssd_chunk(x.to("meta"), dt.to("meta"), a.to("meta"), b.to("meta"),
                  c.to("meta"), chunk=16)
    with pytest.raises(ValueError):
        ssd_chunk(x, dt, a, b, c, chunk=48)        # 64 % 48
    ssd_ops._check(x, dt, a, b, c, 16)
    with pytest.raises(TypeError):
        ssd_ops._check(x.double(), dt, a, b, c, 16)
    with pytest.raises(TypeError):
        ssd_ops._check(x, dt.to(torch.bfloat16), a, b, c, 16)
    with pytest.raises(ValueError):
        ssd_ops._check(x, dt, a, b[:, :32], c, 16)
    wide = torch.zeros(1, 64, 2, ssd_ops.MAX_P + 1)
    with pytest.raises(ValueError):
        ssd_ops._check(wide, dt, a, b, c, 16)
    with pytest.raises(ValueError):
        ssd_ops._check(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                       a, b, c, 16)


# ----------------------------------------------------------------------
# the Mamba-2 block and the ssm model, SMOKE in float32
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jax_get_config("mamba2-780m", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              dtype="float32")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _layer0(jparams):
    return jax.tree_util.tree_map(lambda t: t[0], jparams["blocks"]["ssm"])


def test_block_forward_matches_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    x = np.random.default_rng(5).standard_normal(
        (2, 70, cfg.d_model)).astype(np.float32)
    want = jax_mamba2_forward(_layer0(jparams), jnp.asarray(x), jcfg)
    got = mamba2_forward(params.blocks[0].ssm, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32
    assert _err(got, want) < 1e-5


def test_block_decode_matches_reference(smoke):
    """Five steps from the zero state: outputs and both states."""
    jcfg, jparams, cfg, params = smoke
    xs = np.random.default_rng(6).standard_normal(
        (5, 2, 1, cfg.d_model)).astype(np.float32)
    jstate = jax_init_state(jcfg, 2)
    st = init_mamba2_state(cfg, 2, CPU)
    _, d_inner, nh, conv_ch = _dims(cfg)
    assert tuple(st["h"].shape) == (2, nh, cfg.ssm.state_dim,
                                    cfg.ssm.head_dim)
    assert tuple(st["conv"].shape) == (2, cfg.ssm.conv_width - 1, conv_ch)
    for x in xs:
        want, jstate = jax_mamba2_decode(_layer0(jparams), jnp.asarray(x),
                                         jcfg, jstate)
        got = mamba2_decode(params.blocks[0].ssm, torch.from_numpy(x), cfg,
                            st["h"], st["conv"])
        assert _err(got, want) < 1e-5
        assert _err(st["h"], jstate["h"]) < 1e-5
        assert _err(st["conv"], jstate["conv"]) < 1e-5


def test_forward_and_prefill_match_reference(smoke):
    """``Model.forward`` at every position and the serving prefill's
    ``last_pos`` logits against the reference's ``lm_forward``, at a
    length that is not a multiple of the chunk (70, chunk 32)."""
    jcfg, jparams, cfg, params = smoke
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 70)).astype(np.int32)
    want, _ = jax_lm_forward(jparams, jnp.asarray(tokens), jcfg)
    want = np.asarray(want)
    before = launch_counts()
    got = build_model(cfg).forward(params, torch.from_numpy(tokens))
    assert tuple(got.shape) == (2, 70, cfg.padded_vocab)
    assert _err(got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]) < 1e-5
    last = torch.tensor([69, 40], dtype=torch.int32)
    logits, kv = lm_prefill_batched(params, torch.from_numpy(tokens), cfg,
                                    last_pos=last)
    assert kv is None
    assert _err(logits[:, :cfg.vocab_size],
                want[[0, 1], [69, 40], :cfg.vocab_size]) < 1e-5
    assert launch_counts() == before


def test_family_guard_refuses_unported_families():
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.transformer import LM
    for family in ("moe", "vlm", "audio"):
        cfg = ModelConfig(name=f"x-{family}", family=family, n_layers=1,
                          d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                          vocab_size=64)
        with pytest.raises(ValueError, match=family):
            build_model(cfg)
        with pytest.raises(ValueError, match=family):
            LM(cfg)
    # the hybrid family is ported; a hybrid with another norm is not
    hybrid = get_config("hymba-1.5b", smoke=True)
    assert build_model(hybrid).cfg is hybrid
    layernorm = dataclasses.replace(hybrid, norm="layernorm")
    with pytest.raises(ValueError, match="layernorm"):
        build_model(layernorm)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K10 is a CUDA kernel")


#: (H, P, N) of mamba2-780m's SSD, of its SMOKE config, and widths whose
#: rows are not whole 16-byte chunks (the kernel's plain-copy staging)
SSD_WIDTHS = {"mamba2": (48, 64, 128), "smoke": (8, 32, 16),
              "odd": (3, 30, 20)}


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(SSD_WIDTHS))
@pytest.mark.parametrize("q", [8, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 1024])
def test_ssd_chunk_kernel_on_card(s, dtype, q, widths):
    """K10 against its plain version on the card at mamba2-780m's widths
    (H 48, P 64, N 128), SMOKE's (H 8, P 32, N 16) and odd ones (H 3, P
    30, N 20: rows of no whole 16-byte chunks), at chunks of 8, 64 and
    256 (the serve's buckets run every Q from 8 to 256), relative
    max error <= 1e-5 on all three outputs (the products are split TF32
    parts and the cumsum adds in another order); one call counts once."""
    _need_cuda()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    h, p, n = SSD_WIDTHS[widths]
    args = _torch(_inputs(2, s, h, p, n, seed=8, a_model_range=True))
    x, dt, a, b, c = (t.to(dev) for t in args)
    dty = getattr(torch, dtype)
    x, b, c = (t.to(dty) for t in (x, b, c))
    before = launch_counts()["ssd_chunk"]
    out = ssd_chunk(x, dt, a, b, c, chunk=q)
    ref = ssd_chunk_ref(x, dt, a, b, c, q)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_chunk"] == before + 1
    for o, r in zip(out, ref):
        rel = float((o - r).abs().max() / r.abs().max())
        assert rel <= 1e-5, rel
