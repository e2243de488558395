"""Port kernels (K1 paged decode, K2 flash prefill) against the reference.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the reference's Pallas kernels run in interpret mode and its jnp
oracles, on the same numpy inputs (tolerance 2e-5 in float32, as the
reference's own kernel tests).  The CUDA kernels are held against the
plain versions on the card by the tests marked ``cuda``; they skip where
there is no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_paged_pallas, decode_attention_paged_ref as jax_paged_ref)
from repro.kernels.flash_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_paged, decode_attention_paged_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = 2e-5


def _paged_inputs(h, hkv, d=32, ps=32, t=8, n_pages=48, seed=0):
    rng = np.random.default_rng(seed)
    b = 5
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    # disjoint, shuffled tables: physical naming must not show in the math
    bt = rng.permutation(n_pages)[:b * t].reshape(b, t).astype(np.int32)
    # dead lane, sub-page, page-aligned, partial, full
    lens = np.array([0, 7, 64, 130, 256], np.int32)
    return q, kp, vp, bt, lens


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (12, 2)])
def test_paged_decode_plain_matches_pallas(h, hkv):
    q, kp, vp, bt, lens = _paged_inputs(h, hkv)
    before = launch_counts()
    out = decode_attention_paged(*map(torch.from_numpy, (q, kp, vp, bt,
                                                         lens))).numpy()
    assert launch_counts() == before        # CPU: plain version, no launch
    pallas = np.asarray(decode_attention_paged_pallas(
        *map(jnp.asarray, (q, kp, vp, bt, lens)), interpret=True))
    ref = np.asarray(jax_paged_ref(*map(jnp.asarray, (q, kp, vp, bt, lens))))
    assert np.max(np.abs(out - pallas)) < TOL
    assert np.max(np.abs(out - ref)) < TOL
    assert np.all(out[0] == 0.0)            # dead lane: exactly 0


def _flash_inputs(h, hkv, sq, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((1, hkv, sq, d)).astype(np.float32)
    v = rng.standard_normal((1, hkv, sq, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq", [8, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 32)])
def test_flash_plain_matches_pallas(sq, causal, window):
    q, k, v = _flash_inputs(4, 2, sq)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, interpret=True))
    ref = np.asarray(jax_attention_ref(jq, jk, jv, causal=causal,
                                       window=window))
    assert np.max(np.abs(out - pallas)) < TOL
    assert np.max(np.abs(out - ref)) < TOL


def test_wrappers_reject_unsupported_device():
    q, kp, vp, bt, lens = map(torch.from_numpy, _paged_inputs(4, 2))
    with pytest.raises(ValueError):
        decode_attention_paged(q.to("meta"), kp.to("meta"), vp.to("meta"),
                               bt.to("meta"), lens.to("meta"))


# ----------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ----------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_paged_decode_kernel_on_card(dtype, tol):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, kp, vp, bt, lens = _paged_inputs(12, 2, d=128, ps=16, t=16,
                                        n_pages=96)
    lens = np.array([0, 7, 64, 130, 256], np.int32)
    args = [torch.from_numpy(a).cuda() for a in (q, kp, vp, bt, lens)]
    args[:3] = [a.to(dt) for a in args[:3]]
    out = decode_attention_paged(*args)
    ref = decode_attention_paged_ref(*args)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.all(out[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,causal,window", [(64, True, None),
                                              (200, False, None),
                                              (512, True, 96)])
def test_flash_kernel_on_card(sq, causal, window):
    _need_cuda()
    q, k, v = (torch.from_numpy(a).cuda() for a in
               _flash_inputs(12, 2, sq, d=128))
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4
