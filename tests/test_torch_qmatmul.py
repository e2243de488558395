"""K7's arithmetic on the tensor cores, emulated on the CPU.

``csrc/qmatmul.cu`` computes ``dequant_dot`` as integer weights times x
in bf16 parts, one sum per sub-block, scaled per (sub-block, column) in
f32, the mins of q4_k/q2_k subtracted through x's sums per sub-block;
and ``dot_i8`` as exact int32 dots per q8_0 block with an f32 epilogue.
The CUDA kernels run only on the card; here a PyTorch emulation of that
arithmetic is held to the reference's Pallas kernel in interpret mode
and to the port's plain versions, on the same numpy inputs, at the
kernels' tolerance (relative max error 1e-5).  The launch plan and the
breakdown's cuts are checked as text and integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.qmatmul import qmatmul_pallas  # noqa: E402
from repro.quant import quantize as jax_quantize  # noqa: E402
from repro.quant.quantize import QTensor as JaxQTensor  # noqa: E402
from repro_torch.convert import qtensor_from_numpy  # noqa: E402
from repro_torch.kernels import breakdown  # noqa: E402
from repro_torch.kernels.qmatmul import (TILES, qmatmul_i8_ref,  # noqa: E402
                                         qmatmul_plan, qmatmul_ref)
from repro_torch.quant.quantize import (true_div,  # noqa: E402
                                        unpack_nibbles)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

FMTS = ("q8_0", "q6_k", "q4_k", "q2_k")
TOL = 1e-5


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-9))


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _planes(fmt, k, n, zero_block=True):
    """The reference's planes of a seeded (k, n) weight as numpy; with
    ``zero_block`` the first scale row's first four columns are 0: for
    q8_0 a block scale of 0 (its weights are 0), for the k-quants a
    sub-scale of 0, whose effective scale is read as 1."""
    host = jax.device_get(jax_quantize(jnp.asarray(_normal((k, n), 1)),
                                       fmt))
    planes = {name: None if getattr(host, name) is None
              else np.array(getattr(host, name))
              for name in ("values", "super_scales", "sub_scales",
                           "sub_mins", "super_mins")}
    if zero_block:
        key = "super_scales" if fmt == "q8_0" else "sub_scales"
        planes[key][0, :4] = 0
    return host.shape, planes


def _pair(fmt, k, n, zero_block=True):
    shape, planes = _planes(fmt, k, n, zero_block)
    jqt = JaxQTensor(fmt=fmt, shape=shape, **{
        name: None if v is None else jnp.asarray(v)
        for name, v in planes.items()})
    return jqt, qtensor_from_numpy(fmt, shape, **planes)


def x_parts(x: torch.Tensor, parts: int = 3):
    """x as the kernel feeds it to the products: bf16 x as it is; f32 x
    as ``parts`` bf16 values each (the leading 8 bits, the next 8 of
    what is left, the rest), held as f32."""
    if x.dtype == torch.bfloat16:
        return [x.float()]
    out, rest = [], x.float()
    for _ in range(parts):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def dequant_dot_emulated(x: torch.Tensor, qt, parts: int = 3):
    """``dequant_dot`` as the kernel computes it: per sub-block, the
    integer weights times x's bf16 parts summed in f32, then acc +=
    eff_d * sums and, for q4_k/q2_k, acc -= eff_m * (x summed over the
    sub-block), with eff_d = sub * super (0 read as 1; q8_0: the block's
    scale) and eff_m = sub_min * super_min."""
    fmt = qt.format
    k, n = qt.shape
    sub = fmt.sub_block or fmt.block
    if fmt.values_per_byte > 1:
        q = unpack_nibbles(qt.values, fmt.bits).float()
    else:
        q = qt.values.float()
    if qt.fmt == "q8_0":
        eff_d = qt.super_scales
    else:
        per = fmt.block // sub
        eff_d = qt.sub_scales.float() * qt.super_scales.repeat_interleave(
            per, dim=0)
        eff_d = torch.where(eff_d == 0, torch.ones_like(eff_d), eff_d)
        if fmt.asymmetric:
            eff_m = qt.sub_mins.float() * qt.super_mins.repeat_interleave(
                per, dim=0)
    xs = x_parts(x, parts)
    xsum = x.float().reshape(x.shape[0], k // sub, sub).sum(dim=2)
    acc = torch.zeros((x.shape[0], n))
    for s in range(k // sub):
        rows = slice(s * sub, (s + 1) * sub)
        d = sum(p[:, rows] @ q[rows] for p in xs)
        acc = acc + eff_d[s] * d
        if fmt.asymmetric:
            acc = acc - eff_m[s] * xsum[:, s:s + 1]
    return acc


def dot_i8_emulated(x: torch.Tensor, qt):
    """``dot_i8`` as the kernel computes it: x quantized per (row,
    32-block) by IEEE division and rounding half to even, exact int32
    dots per block, then acc + (part * x_scale) * w_scale block by
    block."""
    m, k = x.shape
    xb = x.float().reshape(m, k // 32, 32)
    scale = true_div(xb.abs().amax(dim=2), 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    xq = torch.round(xb / scale[:, :, None]).clamp(-127, 127).to(torch.int64)
    wq = qt.values.to(torch.int64).reshape(k // 32, 32, -1)
    acc = torch.zeros((m, qt.shape[1]))
    for b in range(k // 32):
        part = (xq[:, b] @ wq[b]).float()
        acc = acc + part * scale[:, b:b + 1] * qt.super_scales[b]
    return acc


def test_three_bf16_parts_hold_f32_x():
    """The kernel's split: three bf16 parts add up to f32 x exactly
    (held in float64), over many magnitudes; two parts do not."""
    x = torch.from_numpy(np.concatenate([
        _normal((4096,), 0), _normal((4096,), 1, 1e-3),
        _normal((4096,), 2, 1e4)]))
    three = sum(p.double() for p in x_parts(x))
    assert torch.equal(three, x.double())
    assert not torch.equal(sum(p.double() for p in x_parts(x, 2)),
                           x.double())


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_dot_emulation_matches_pallas_and_plain(fmt, dtype):
    """Integer weights, per-sub-block f32 scales, the mins through x's
    sums, f32 x in three bf16 parts: within 1e-5 of the reference's
    Pallas kernel (interpret mode) and of ``qmatmul_ref``, with a block
    whose effective scale is 0."""
    m, k, n = 16, 512, 128
    x = _normal((m, k), 0)
    jqt, tqt = _pair(fmt, k, n)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = dequant_dot_emulated(xt, tqt)
    pallas = qmatmul_pallas(jnp.asarray(xt.float().numpy()), jqt,
                            variant="dequant_dot", bm=8, bk=256, bn=128,
                            interpret=True)
    assert _rel(out.numpy(), pallas) <= TOL
    assert _rel(out.numpy(), qmatmul_ref(xt, tqt).numpy()) <= TOL


@pytest.mark.parametrize("fmt", FMTS)
def test_unsplit_bf16_x_misses_the_tolerance(fmt):
    """One bf16 pass over f32 x is no substitute for the split: it
    misses 1e-5 of the plain version, where three parts hold it."""
    x = torch.from_numpy(_normal((16, 512), 0))
    _, tqt = _pair(fmt, 512, 128, zero_block=False)
    ref = qmatmul_ref(x, tqt).numpy()
    assert _rel(dequant_dot_emulated(x, tqt, parts=1).numpy(), ref) > TOL
    assert _rel(dequant_dot_emulated(x, tqt, parts=3).numpy(), ref) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_i8_emulation_matches_pallas_and_plain(dtype):
    """Exact int32 block dots and the f32 epilogue in the reference's
    order, block by block: within 1e-5 of ``qmatmul_i8_ref``, a zero
    block scale included, and for f32 x of the reference's int8 Pallas
    path (interpret mode).  bf16 x meets ties (x / scale = j + 1/2),
    which the jitted reference rounds the other way in a few places
    (its division is not the IEEE quotient there): the port's plain
    version is 5.4e-4 from it on these inputs, as the emulation is."""
    m, k, n = 16, 512, 128
    x = torch.from_numpy(_normal((m, k), 0)).to(getattr(torch, dtype))
    jqt, tqt = _pair("q8_0", k, n)
    out = dot_i8_emulated(x, tqt)
    assert _rel(out.numpy(), qmatmul_i8_ref(x, tqt).numpy()) <= TOL
    if dtype == "float32":
        pallas = qmatmul_pallas(jnp.asarray(x.numpy()), jqt,
                                variant="dot_i8", bm=8, bk=256, bn=128,
                                interpret=True)
        assert _rel(out.numpy(), pallas) <= TOL


def _slice_of(it, iters, runs):
    return ((it + 1) * runs + iters - 1) // iters - 1


@pytest.mark.parametrize("variant", ["dequant_dot", "dot_i8"])
@pytest.mark.parametrize("m,k,n", [(128, 1536, 8960), (128, 8960, 1536),
                                   (8, 1536, 8960), (8, 8960, 1536),
                                   (256, 512, 100), (1, 96, 8)])
def test_qmatmul_plan_covers_every_step_once(variant, m, k, n):
    """The products' runs (one CTA per SM, equal runs of K steps over
    all tiles): every step of every tile in exactly one run, each piece
    of a split tile in a distinct workspace slot below ``slots``, and
    the workspace the kernel checks for."""
    runs, slots, slot_rows, tile_n = qmatmul_plan(m, k, n, variant, 132)
    bm, bn, bk = TILES[variant, m > 16]
    assert (slot_rows, tile_n) == (min(m, bm), bn)
    tiles = -(-m // bm) * -(-n // bn)
    nkb = -(-k // bk)
    iters = tiles * nkb
    assert runs == min(132, iters) and slots == runs + tiles - 1
    seen = set()
    for tile in range(tiles):
        first = _slice_of(tile * nkb, iters, runs)
        last = _slice_of(tile * nkb + nkb - 1, iters, runs)
        for r in range(first, last + 1):
            assert r * iters // runs < (tile + 1) * nkb
            assert (r + 1) * iters // runs > tile * nkb
            if first != last:
                assert r + tile < slots and r + tile not in seen
                seen.add(r + tile)
    assert [_slice_of(it, iters, runs) for it in range(iters)] == [
        r for r in range(runs)
        for _ in range(r * iters // runs, (r + 1) * iters // runs)]


def test_qmatmul_plan_fills_the_card_at_the_mlp_shapes():
    """At both MLP shapes, M 128 and M 8, every SM gets a run (split-K
    where the column tiles are fewer than the SMs)."""
    for variant in ("dequant_dot", "dot_i8"):
        for m, k, n in ((128, 1536, 8960), (128, 8960, 1536),
                        (8, 1536, 8960), (8, 8960, 1536)):
            runs = qmatmul_plan(m, k, n, variant, 132)[0]
            bm, bn, _ = TILES[variant, m > 16]
            assert runs == 132 and -(-m // bm) * -(-n // bn) < 132, (
                variant, m, k, n)


@pytest.mark.parametrize("variant", list(breakdown.TARGETS["k7"][1]))
def test_k7_breakdown_cuts_match_the_source(variant):
    """Every cut of the ``k7`` breakdown finds its text exactly once in
    ``csrc/qmatmul.cu`` and changes it (``full`` leaves it as it is);
    every cut of the source's table is used by some variant."""
    source, variants = breakdown.TARGETS["k7"]
    assert source == "qmatmul"
    text = breakdown.source_text(source)
    cut = breakdown.source_with(source, variants[variant])
    assert (cut == text) == (variant == "full")
    assert {c for cuts in variants.values() for c in cuts} \
        == set(breakdown.CUTS[source])
