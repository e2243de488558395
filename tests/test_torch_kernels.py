"""Port kernels (K1 paged decode, K2 flash prefill) against the reference.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the reference's Pallas kernels run in interpret mode and its jnp
oracles, on the same numpy inputs (tolerance 2e-5 in float32, as the
reference's own kernel tests).  K1's chunked plain version (the split
kernel's algorithm, ``decode_attention_paged_split_ref``) is held the
same way, and bit for bit against the dense chunked version on the
lanes' gathered view.  The CUDA kernels are held against the plain
versions on the card by the tests marked ``cuda``; they skip where there
is no card.
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
    decode_attention, decode_attention_paged, decode_attention_paged_ref,
    decode_attention_paged_split_ref, decode_attention_split_ref,
    gather_pages, split_plan)
from repro_torch.kernels.decode_attention.ops import CHUNKS  # noqa: E402
from repro_torch.kernels import breakdown  # noqa: E402
from repro_torch.kernels._sass import (SASS_KERNELS,  # noqa: E402
                                       check_counts, kernel_counts,
                                       parse_sass)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.flash_attention import \
    ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    HEAD_DIMS, MMA_HEAD_DIMS, kernel_for)

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


def _paged_oracle(q, kp, vp, bt, lens):
    """Paged decode attention in float64 numpy, lane by lane and head by
    head over the live positions: the yardstick each side is measured
    against."""
    b, h, d = q.shape
    hkv, ps = kp.shape[1], kp.shape[2]
    out = np.zeros((b, h, d))
    for lane in range(b):
        n = min(int(lens[lane]), bt.shape[1] * ps)
        if n == 0:
            continue
        k, v = (x[bt[lane]].transpose(1, 0, 2, 3).reshape(hkv, -1, d)[:, :n]
                .astype(np.float64) for x in (kp, vp))
        for head in range(h):
            s = k[head // (h // hkv)] @ (q[lane, head] * d ** -0.5)
            p = np.exp(s - s.max())
            out[lane, head] = p @ v[head // (h // hkv)] / p.sum()
    return out


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
    # should a comparison fail, name the side that moved: each side's
    # distance to the float64 oracle
    oracle = _paged_oracle(q, kp, vp, bt, lens)
    sides = ", ".join(f"{name} {np.max(np.abs(x - oracle)):.2e}"
                      for name, x in (("port", out), ("pallas", pallas),
                                      ("jnp", ref)))
    assert np.max(np.abs(out - pallas)) < TOL, f"from the oracle: {sides}"
    assert np.max(np.abs(out - ref)) < TOL, f"from the oracle: {sides}"
    assert np.all(out[0] == 0.0)            # dead lane: exactly 0


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (12, 2)])
def test_paged_decode_plain_is_stable(h, hkv):
    """The port's side of the parity test above is the float64 oracle
    rounded once to float32, bit for bit, at 1, 2 and 4 intra-op
    threads, with its inputs at any alignment and on every repeat.  It
    used to take its products from the BLAS library, whose first batched
    product in a loaded process once came out of one thread with ~5e-5
    errors in the scores (the parity test's flake)."""
    args = _paged_inputs(h, hkv)
    oracle = _paged_oracle(*args)

    def shifted(a, off):                    # a copy ``off`` bytes past 64
        buf = np.empty(a.nbytes + 128, np.uint8)
        start = (-buf.ctypes.data) % 64 + off
        view = buf[start:start + a.nbytes].view(a.dtype).reshape(a.shape)
        view[...] = a
        return view

    threads = torch.get_num_threads()
    outs = []
    try:
        for n, off in ((1, 0), (2, 4), (4, 8), (2, 16), (2, 0)):
            torch.set_num_threads(n)
            outs.append(decode_attention_paged(*(
                torch.from_numpy(shifted(a, off)) for a in args)).numpy())
    finally:
        torch.set_num_threads(threads)
    assert all(np.array_equal(o, oracle.astype(np.float32)) for o in outs)


#: pages per lane for each page size of the split tests: T*ps (104, 112,
#: 160) is not a multiple of the 64-position chunk, and at 8 and 16 not
#: of the 32-position one either
SPLIT_T = {8: 13, 16: 7, 32: 5}


def _split_paged_inputs(h, hkv, ps, d=32, seed=1):
    """Pools with a scratch page 0 of large values; each lane's live
    pages shuffled, its table slots past the live length pointing at the
    scratch page (as the serve's do).  Lengths: a dead lane, inside the
    first page, three past a page edge, across a 32-position chunk edge
    (a chunk that straddles pages), one short of full, and past T*ps
    (clamped)."""
    rng = np.random.default_rng(seed)
    t = SPLIT_T[ps]
    b = 6
    n_pages = b * t + 1
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    kp[0], vp[0] = 300.0, -300.0
    bt = (1 + rng.permutation(n_pages - 1)).reshape(b, t).astype(np.int32)
    lens = np.array([0, 5, ps + 3, 40, t * ps - 1, t * ps + 7], np.int32)
    for lane, n in enumerate(lens):
        bt[lane, -(-min(int(n), t * ps) // ps):] = 0
    return q, kp, vp, bt, lens


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (12, 2)])
def test_paged_split_plain_matches_pallas(h, hkv, ps):
    """K1 as the split kernel computes it (chunks of 32 and of 64 over the
    lane's T*ps positions, whatever the page size) against the
    reference's interpret-mode Pallas kernel and its jnp oracle within
    2e-5; the dead lane gives exactly 0, and what the stale table slots
    point at changes no bit."""
    q, kp, vp, bt, lens = _split_paged_inputs(h, hkv, ps)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, lens)]
    pallas = np.asarray(decode_attention_paged_pallas(*jargs,
                                                      interpret=True))
    ref = np.asarray(jax_paged_ref(*jargs))
    targs = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    kp2, vp2 = targs[1].clone(), targs[2].clone()
    kp2[0], vp2[0] = -7.0, 11.0                  # other stale values
    assert SPLIT_T[ps] * ps % CHUNKS[1]
    for ch in CHUNKS:
        out = decode_attention_paged_split_ref(*targs, ch=ch)
        assert np.max(np.abs(out.numpy() - pallas)) < TOL
        assert np.max(np.abs(out.numpy() - ref)) < TOL
        assert torch.all(out[0] == 0.0)
        assert torch.equal(out, decode_attention_paged_split_ref(
            targs[0], kp2, vp2, *targs[3:], ch=ch))


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_split_equals_dense_split_on_gathered_view(ps):
    """A dense cache scattered into shuffled pages: the paged chunked
    version over the pools gives the dense chunked version's bits over
    the cache, at either chunk length -- the identity the card's K1 and
    K3 are held to -- and ``gather_pages`` inverts the scatter."""
    rng = np.random.default_rng(ps)
    b, h, hkv, d, t = 4, 12, 2, 32, SPLIT_T[ps]
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, t * ps, d))
                             .astype(np.float32)) for _ in range(2))
    bt = torch.from_numpy(rng.permutation(b * t).reshape(b, t)
                          .astype(np.int32))
    kp, vp = (torch.zeros(b * t, hkv, ps, d) for _ in range(2))
    for lane in range(b):
        for j in range(t):
            page = int(bt[lane, j])
            kp[page] = k[lane, :, j * ps:(j + 1) * ps]
            vp[page] = v[lane, :, j * ps:(j + 1) * ps]
    assert torch.equal(gather_pages(kp, bt), k)
    lens = torch.tensor([0, 33, ps * t - 5, ps * t], dtype=torch.int32)
    for ch in CHUNKS:
        paged = decode_attention_paged_split_ref(q, kp, vp, bt, lens, ch=ch)
        dense = decode_attention_split_ref(q, k, v, lens, ch=ch)
        assert torch.equal(paged, dense)


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


@pytest.mark.parametrize("dtype,d,kernel", [
    ("float32", 32, "cc"), ("float32", 64, "cc"), ("float32", 96, "cc"),
    ("float32", 128, "cc"), ("float32", 256, "cc"), ("bfloat16", 32, "cc"),
    ("bfloat16", 64, "mma"), ("bfloat16", 96, "mma"), ("bfloat16", 128, "mma"),
    ("bfloat16", 256, "cc")])
def test_flash_kernel_dispatch(dtype, d, kernel):
    """K2's dispatch rule, by dtype and head dim alone: bf16 at D 64, 96
    (phi-3-vision's: rows of three 64-byte TMA boxes) and 128 runs the
    tensor-core kernel;
    float32 (full f32 products, which the float32 tolerance and
    token-exact serve need), bf16 at D 256 (accumulators too large for
    registers) and at D 32 (no bf16 model serves it) the CUDA-core
    kernel.  Each choice names a kernel the source instantiates, held by
    the SASS rule."""
    dt = getattr(torch, dtype)
    assert kernel_for(dt, d) == kernel
    assert d in HEAD_DIMS and (kernel == "mma") == (
        dt == torch.bfloat16 and d in MMA_HEAD_DIMS)
    tag = "f32" if dt == torch.float32 else "bf16"
    assert f"flash_attention_{kernel}_{tag}_d{d}" in SASS_KERNELS


@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)])
def test_flash_head_dim_96_plain_matches_pallas(causal, window):
    """D 96 (phi-3-vision-4.2b: d 3072 over 32 heads), which the
    reference's blocks take since they span the whole head dim: the port
    admits it on the card (``HEAD_DIMS``; bf16 on the tensor-core kernel,
    float32 on the CUDA-core one), and its CPU path at D 96 matches the
    Pallas kernel in interpret mode and the jnp oracle."""
    assert 96 in HEAD_DIMS and 96 in MMA_HEAD_DIMS
    assert kernel_for(torch.bfloat16, 96) == "mma"
    assert kernel_for(torch.float32, 96) == "cc"
    q, k, v = _flash_inputs(4, 2, 64, d=96, seed=96)
    before = launch_counts()
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window).numpy()
    assert launch_counts() == before
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, interpret=True))
    ref = np.asarray(jax_attention_ref(jq, jk, jv, causal=causal,
                                       window=window))
    assert out.shape == (1, 4, 64, 96)
    assert np.max(np.abs(out - pallas)) < TOL
    assert np.max(np.abs(out - ref)) < TOL


@pytest.mark.parametrize("dtype,offset,refused", [
    ("bfloat16", 1, True), ("bfloat16", 4, True), ("bfloat16", 8, False),
    ("float32", 1, False)])
def test_flash_check_refuses_unaligned_d96_view(dtype, offset, refused):
    """The tensor-core kernel reads q, k and v by TMA, so a bf16 D 96
    view that does not start on 16 bytes is refused before any launch;
    float32 (the CUDA-core kernel) takes it.  ``_check`` reads only
    pointers and shapes, so CPU tensors stand in for the card's."""
    dt = getattr(torch, dtype)
    n = 1 * 2 * 64 * 96
    buf = torch.zeros(n + 16, dtype=dt)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:offset + n].view(1, 2, 64, 96)
    aligned = torch.zeros(1, 2, 64, 96, dtype=dt)
    for q, k, v in ((view, aligned, aligned), (aligned, view, aligned),
                    (aligned, aligned, view)):
        if refused:
            with pytest.raises(ValueError, match="16-byte"):
                flash_ops._check(q, k, v, None)
        else:
            flash_ops._check(q, k, v, None)


def test_flash_cpu_launches_no_kernel():
    """On the CPU both dtypes take the plain version: no counter moves."""
    q, k, v = map(torch.from_numpy, _flash_inputs(4, 2, 16))
    before = launch_counts()
    flash_attention(q, k, v)
    flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert launch_counts() == before


_SASS_ATTN = """
        Function : _ZN12_GLOBAL__N_129flash_attention_mma_bf16_d128EPK13__nv_bfloat16S2_S2_PS0_iiiiiif
        /*0000*/                   LDSM.16.M88.4 R20, [R2+UR4] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   MUFU.EX2 R5, R5 ;
        Function : _ZN12_GLOBAL__N_128flash_attention_mma_bf16_d96E14CUtensorMap_stS0_S0_P13__nv_bfloat16iiiiiif
        /*0000*/                   LDSM.16.MT88.4 R28, [R2+UR4] ;
        /*0010*/                   HMMA.16816.F32.BF16 R24, R28, R12, R24 ;
        Function : _ZN12_GLOBAL__N_127flash_attention_cc_f32_d128EPKfS1_S1_Pfiiiiiif
        /*0000*/                   FFMA R5, R4, R2, R3 ;
        Function : _ZN12_GLOBAL__N_117decode_dense_bf16EPK13__nv_bfloat16S2_PKfS2_S4_PKiPS0_PfS8_Piiiiiiif
        /*0000*/                   LDS.64 R8, [R2] ;
        /*0010*/                   FFMA R5, R4, R2, R3 ;
        Function : _ZN12_GLOBAL__N_126decode_dense_q8_masked_f32EPKfPKaS1_S3_S1_PKiPfS6_S6_Piiiiiiif
        /*0000*/                   FMUL R5, R4, R2 ;
        /*0010*/                   FFMA R5, R4, R2, R3 ;
        Function : _ZN12_GLOBAL__N_119decode_paged_q8_f32EPKfPKaS1_S3_S1_PKiS5_PfS6_S6_Piiiiiiiif
        /*0000*/                   I2F R6, R6 ;
        /*0010*/                   FADD R5, R4, R2 ;
        Function : _ZN12_GLOBAL__N_117decode_paged_bf16EPK13__nv_bfloat16S2_PKfS2_S4_PKiS6_PS0_PfS8_Piiiiiiiif
        /*0000*/                   LDS.128 R8, [R2] ;
        /*0010*/                   FFMA R5, R4, R2, R3 ;
"""


@pytest.mark.parametrize("edit,breach", [
    (None, None),
    (("HMMA.16816.F32.BF16 R4, R8, R12, R4", "FFMA R4, R8, R12, R4"),
     "flash_attention_mma_bf16_d128"),
    (("HMMA.16816.F32.BF16 R24, R28, R12, R24", "FFMA R24, R28, R12, R24"),
     "flash_attention_mma_bf16_d96"),
    (("FFMA R5, R4, R2, R3 ;\n        Function : _ZN12_GLOBAL__N_117",
      "HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n        Function : "
      "_ZN12_GLOBAL__N_117"), "flash_attention_cc_f32_d128"),
    (("LDS.64 R8, [R2]", "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24"),
     "decode_dense_bf16"),
    (("FMUL R5, R4, R2", "HMMA.1684.F32.TF32 R4, R8, R12, R4"),
     "decode_dense_q8_masked_f32"),
    (("LDS.128 R8, [R2]", "HMMA.16816.F32.BF16 R8, R8, R12, R8"),
     "decode_paged_bf16"),
    (("I2F R6, R6", "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24"),
     "decode_paged_q8_f32"),
])
def test_sass_rules_cover_the_attention_kernels(edit, breach):
    """K2's bf16 kernels (D 64, 96 and 128) must run HMMA (mma.sync);
    a D 96 one without HMMA is flagged like the others; its CUDA-core
    kernel
    and every dense and paged decode kernel (one split-KV body) must hold
    no HMMA and no HGMMA (wgmma): their f32 arithmetic stays off the
    tensor cores."""
    text = _SASS_ATTN if edit is None else _SASS_ATTN.replace(*edit)
    assert text.count(edit[1]) == 1 if edit else True
    found = kernel_counts(parse_sass(text))
    assert set(found) == {"flash_attention_mma_bf16_d128",
                          "flash_attention_mma_bf16_d96",
                          "flash_attention_cc_f32_d128",
                          "decode_dense_bf16", "decode_dense_q8_masked_f32",
                          "decode_paged_bf16", "decode_paged_q8_f32"}
    problems = [p for p in check_counts(found) if "not found" not in p]
    assert [p.split()[0] for p in problems] == ([breach] if breach else [])
    for name in ("decode_dense_f32", "decode_dense_masked_bf16",
                 "decode_dense_q8_bf16", "flash_attention_mma_bf16_d64",
                 "flash_attention_cc_bf16_d256", "decode_paged_f32",
                 "decode_paged_q8_bf16", "flash_attention_mma_bf16_d96"):
        assert name in SASS_KERNELS
    assert "flash_attention_cc_bf16_d96" not in SASS_KERNELS


@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k in ("k1", "k2", "k3") for v in breakdown.TARGETS[k][1]])
def test_attention_breakdown_cuts_match_the_source(kernel, variant):
    """Every cut of the K1/K2/K3 breakdown still finds its text exactly
    once in the source with the headers it includes written in (K1's
    and K3's cuts are in their shared body, ``decode_split.cuh``), and
    changes it (``full`` leaves it as it is); every cut of the source's
    table is used by some variant."""
    name, variants = breakdown.TARGETS[kernel]
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{name}.cu").read_text()
    if name.startswith("decode_attention"):
        assert '#include "decode_split.cuh"' in text
        assert "__shared__ bool last;" not in text       # in the header
    text = breakdown.source_text(name)
    assert "#include \"" not in text
    cut = breakdown.source_with(name, variants[variant])
    assert (cut == text) == (variant == "full")
    assert {c for cuts in variants.values() for c in cuts} \
        == set(breakdown.CUTS[name])


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
    before = launch_counts()
    out = decode_attention_paged(*args)
    again = decode_attention_paged(*args)
    after = launch_counts()
    ref = decode_attention_paged_ref(*args)
    k3 = decode_attention(args[0], gather_pages(args[1], args[3]),
                          gather_pages(args[2], args[3]), args[4])
    torch.cuda.synchronize()
    assert after["decode_attention_paged"] - \
        before["decode_attention_paged"] == 2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.all(out[0] == 0)
    assert torch.equal(out, again)          # repeats bit for bit
    assert torch.equal(out, k3)             # K3 on the gathered pools


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_paged_split_kernel_on_card(dtype, tol, ps):
    """K1 at the serve's widths (H 12, Hkv 2, D 128) over pages of 8, 16
    and 32 (chunks that straddle pages, T*ps not a multiple of the
    chunk): within ``tol`` of its chunked plain version, the bits of K3
    on the gathered pools and of its own second call, 0 on the dead
    lane, and table slots past the length -- here page ids far outside
    the pools -- never read."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, kp, vp, bt, lens = _split_paged_inputs(12, 2, ps, d=128)
    q, kp, vp = (torch.from_numpy(a).cuda().to(dt) for a in (q, kp, vp))
    bt, lens = torch.from_numpy(bt).cuda(), torch.from_numpy(lens).cuda()
    wild = bt.clone()
    for lane, n in enumerate(lens.tolist()):
        wild[lane, -(-min(n, bt.shape[1] * ps) // ps):] = 1 << 30
    outs = [decode_attention_paged(q, kp, vp, wild, lens) for _ in range(2)]
    ch = split_plan(bt.shape[1] * ps, 6, 2)[0]
    plain = decode_attention_paged_split_ref(q, kp, vp, bt, lens, ch=ch)
    k3 = decode_attention(q, gather_pages(kp, bt), gather_pages(vp, bt),
                          lens)
    torch.cuda.synchronize()
    assert (outs[0].float() - plain.float()).abs().max().item() <= tol
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], k3)
    assert torch.all(outs[0][0] == 0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
@pytest.mark.parametrize("sq", [64, 100, 512, 1024])
def test_flash_mma_kernel_on_card(sq, causal, window, d):
    """The bf16 tensor-core kernel against the plain version within 2e-2
    (P is rounded to bf16 before the P V product; the output to bf16):
    the serve's buckets, a ragged length, a window, no mask, D 64 and
    128; the counter shows that kernel ran, once."""
    _need_cuda()
    q, k, v = (torch.from_numpy(a).cuda().bfloat16() for a in
               _flash_inputs(12, 2, sq, d=d, seed=sq + d))
    before = launch_counts()
    out = flash_attention(q, k, v, causal=causal, window=window)
    after = launch_counts()
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert after["flash_attention_mma"] - before["flash_attention_mma"] == 1
    assert after["flash_attention_cc"] == before["flash_attention_cc"]
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 128)])
@pytest.mark.parametrize("sq", [100, 512])
def test_flash_d96_kernel_on_card(sq, causal, window, dtype, tol):
    """K2 at D 96 (phi-3-vision's head dim, which the reference takes),
    causal and windowed, against ``attention_ref``: float32 on the
    CUDA-core kernel within 1e-4, bf16 on the tensor-core kernel within
    2e-2; the counters show that kernel ran, once, and the other not."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in
               _flash_inputs(12, 2, sq, d=96, seed=sq + 96))
    before = launch_counts()
    out = flash_attention(q, k, v, causal=causal, window=window)
    after = launch_counts()
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran, idle = (("flash_attention_mma", "flash_attention_cc")
                 if dt == torch.bfloat16 else
                 ("flash_attention_cc", "flash_attention_mma"))
    assert after[ran] - before[ran] == 1
    assert after[idle] == before[idle]
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", [
    (1, 12, 2, 100, 100, True), (1, 12, 2, 1000, 1000, True),
    (2, 12, 2, 300, 300, True), (1, 12, 2, 200, 256, False),
    (1, 16, 4, 512, 512, True), (1, 32, 32, 1024, 1024, True)])
def test_flash_mma_d96_kernel_on_card(b, h, hkv, sq, sk, causal):
    """bf16 D 96 on the tensor-core kernel (rows of 192 bytes, three
    64-byte TMA boxes) against ``attention_ref`` within 2e-2: Sq not a
    multiple of 64, B 2 (the TMA maps span B x H), no mask with Sk past
    Sq, GQA group 4 and phi-3-vision's prefill; one tensor-core launch
    and no CUDA-core one."""
    _need_cuda()
    rng = np.random.default_rng(b * 1000 + sq + sk + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().bfloat16() for s in ((b, h, sq, 96), (b, hkv, sk, 96),
                                            (b, hkv, sk, 96)))
    before = launch_counts()
    out = flash_attention(q, k, v, causal=causal)
    after = launch_counts()
    ref = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert after["flash_attention_mma"] - before["flash_attention_mma"] == 1
    assert after["flash_attention_cc"] == before["flash_attention_cc"]
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("h,sq,d", [(4, 8, 32), (4, 128, 32),
                                    (12, 256, 256)])
def test_flash_cc_kernel_on_card(h, sq, d, dtype, tol):
    """The CUDA-core kernel at the head dims the tensor-core kernel
    leaves to it, in both dtypes: D 32 at the float32 SMOKE serve's
    shape (H 4, Hkv 2) and its smallest and largest prompt buckets, and
    D 256; the counter shows that kernel ran, once."""
    _need_cuda()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in
               _flash_inputs(h, 2, sq, d=d, seed=sq + d))
    before = launch_counts()
    out = flash_attention(q, k, v, causal=True)
    after = launch_counts()
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert after["flash_attention_cc"] - before["flash_attention_cc"] == 1
    assert after["flash_attention_mma"] == before["flash_attention_mma"]
    assert (out.float() - ref.float()).abs().max().item() <= tol
