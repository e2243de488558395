"""The port's SSD scan (K10's plain version, the full SSD on it, the
Mamba-2 block and the ssm model) against the reference.

Inputs are made with numpy from a seed and fed to both packages.  The
reference's Pallas kernel runs in interpret mode, as its own tests run
it on the CPU.  Tolerances: the intra-chunk pass 1e-5 on ``y_intra``
and ``states`` and 1e-6 on the decay (the reference's own test); the
full SSD 1e-5 against ``ssd_pallas`` and ``ssd_chunked`` and 1e-4
against the step recurrence (a different summation); the block and the
model in float32 1e-5 (both sum the same products in other orders).
The ``cuda`` test holds K10 to its plain version on the card.
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
from repro_torch.kernels import launch_counts  # noqa: E402
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
    for family in ("moe", "hybrid", "vlm", "audio"):
        cfg = ModelConfig(name=f"x-{family}", family=family, n_layers=1,
                          d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                          vocab_size=64)
        with pytest.raises(ValueError, match=family):
            build_model(cfg)
        with pytest.raises(ValueError, match=family):
            LM(cfg)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K10 is a CUDA kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 1024])
def test_ssd_chunk_kernel_on_card(s, dtype):
    """K10 at mamba2-780m's widths (H 48, P 64, N 128, Q 256) against its
    plain version on the card, relative max error <= 1e-5 on all three
    outputs (the card's cumsum adds in another order)."""
    _need_cuda()
    dev = torch.device("cuda")
    args = _torch(_inputs(2, s, 48, 64, 128, seed=8, a_model_range=True))
    x, dt, a, b, c = (t.to(dev) for t in args)
    dty = getattr(torch, dtype)
    x, b, c = (t.to(dty) for t in (x, b, c))
    before = launch_counts()["ssd_chunk"]
    out = ssd_chunk(x, dt, a, b, c, chunk=256)
    ref = ssd_chunk_ref(x, dt, a, b, c, 256)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_chunk"] == before + 1
    for o, r in zip(out, ref):
        rel = float((o - r).abs().max() / r.abs().max())
        assert rel <= 1e-5, rel
