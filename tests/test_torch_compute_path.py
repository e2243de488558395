"""The port's compute path -- device profiles, ``PathPolicy``, K8
(mixbench), K9 (path-selectable matmul), K7 (block-quantized matmul) --
against the reference.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the reference's Pallas kernels in interpret mode on the same
numpy inputs, at the reference's own kernel-test tolerances
(``tests/test_kernels.py``).  The policy objects must make the same
decisions as the reference's for every profile.  The CUDA kernels are
held against the plain versions by the tests marked ``cuda``; they skip
where there is no card.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.compute_path as jax_cp  # noqa: E402
import repro.core.device_profile as jax_dp  # noqa: E402
import repro.kernels.fma_matmul.ops as jax_matmul_ops  # noqa: E402
from repro.kernels.fma_matmul import fma_matmul_pallas  # noqa: E402
from repro.kernels.mixbench import mixbench_pallas  # noqa: E402
from repro.kernels.mixbench import sweep_points as jax_sweep  # noqa: E402
from repro.kernels.qmatmul import qmatmul_pallas  # noqa: E402
from repro.kernels.qmatmul import select_variant as jax_select  # noqa: E402
from repro.quant import quantize as jax_quantize  # noqa: E402
from repro_torch.convert import qtensor_from_numpy  # noqa: E402
from repro_torch.core import compute_path as cp  # noqa: E402
from repro_torch.core import device_profile as dp  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels._sass import (SASS_KERNELS, SASS_LIBS,  # noqa: E402
                                       check_counts, kernel_counts,
                                       parse_sass, sass_report)
from repro_torch.kernels.fma_matmul import (matmul, matmul_ref,  # noqa: E402
                                            matmul_variant, policy_variant,
                                            stream_plan, stream_rows)
from repro_torch.kernels.mixbench import (arithmetic_intensity,  # noqa: E402
                                          mixbench, mixbench_ref,
                                          sweep_points)
from repro_torch.kernels.mixbench.check import (card_cases,  # noqa: E402
                                                check_on_card, compare,
                                                tolerance)
from repro_torch.kernels.qmatmul import (qmatmul, qmatmul_i8_ref,  # noqa: E402
                                         qmatmul_ref, qmatmul_variant,
                                         select_variant)
from repro_torch.quant import quantize  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

PROFILE_NAMES = sorted(jax_dp.PROFILES)
FMTS = ("q8_0", "q6_k", "q4_k", "q2_k")


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-9))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------------------
# device profiles and the policy
# ----------------------------------------------------------------------

def _profile_fields(p):
    d = dataclasses.asdict(p)
    d["peak"] = {(prec, path.value): tf for (prec, path), tf in p.peak.items()}
    d["build_paths"] = {k: v.value for k, v in p.build_paths.items()}
    return d


def test_profiles_copied():
    assert sorted(dp.PROFILES) == PROFILE_NAMES
    assert [p.value for p in dp.Path] == [p.value for p in jax_dp.Path]
    for name in PROFILE_NAMES:
        assert _profile_fields(dp.get_profile(name)) == \
            _profile_fields(jax_dp.get_profile(name))
        mine, ref = dp.get_profile(name), jax_dp.get_profile(name)
        for prec in ("f32", "f16", "bf16", "f64", "i32", "i8"):
            for path in dp.Path:
                assert mine.throughput(prec, path) == ref.throughput(
                    prec, jax_dp.Path(path.value))
            assert mine.fraction_of_theoretical(prec, dp.Path.FMA) == \
                ref.fraction_of_theoretical(prec, jax_dp.Path.FMA)
    with pytest.raises(KeyError):
        dp.get_profile("h100")
    assert cp.VARIANT_TO_PATH.keys() == jax_cp.VARIANT_TO_PATH.keys()


def _decision(policy, op):
    try:
        d = policy.decide(op)
    except ValueError:
        return "ValueError"
    return (d.variant, d.path.value, d.modeled_seconds, d.compute_seconds,
            d.memory_seconds, d.bound)


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_path_policy_decides_as_reference(name):
    shapes = ((1, 1536, 1536), (8, 8960, 1536), (128, 1536, 8960),
              (4096, 4096, 4096))
    precs = ("f32", "bf16", "f16", "i8")
    supports = (("fma", "mul_add"), ("mxu", "mul_add"), ("dot_i8", "fma"),
                ("mul_add",))
    forced = (None, "fma", "mul_add", "dot_i8", "mxu")
    n = 0
    for (m, k, nn), prec, sup, force, bpw in itertools.product(
            shapes, precs, supports, forced, (2.0, 0.5625)):
        mine = cp.PathPolicy(dp.get_profile(name), force_variant=force)
        ref = jax_cp.PathPolicy(jax_dp.get_profile(name),
                                force_variant=force)
        op = cp.matmul_descriptor(m, nn, k, prec, bytes_per_weight=bpw,
                                  supports=sup)
        jop = jax_cp.matmul_descriptor(m, nn, k, prec, bytes_per_weight=bpw,
                                       supports=sup)
        assert dataclasses.asdict(op) == dataclasses.asdict(jop)
        assert _decision(mine, op) == _decision(ref, jop), (m, k, nn, prec,
                                                            sup, force)
        n += 1
    assert n == 4 * 4 * 4 * 5 * 2


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_sweep_points_match_reference(name):
    for prec, path in itertools.product(("f32", "f16", "bf16", "i8"),
                                        dp.Path):
        for dtype_bytes in (4, 2):
            assert sweep_points(dp.get_profile(name), prec, path,
                                dtype_bytes=dtype_bytes) == jax_sweep(
                jax_dp.get_profile(name), prec, jax_dp.Path(path.value),
                dtype_bytes=dtype_bytes)
    assert arithmetic_intensity(64) == 32.0
    assert arithmetic_intensity(64, torch.bfloat16) == 64.0


@pytest.mark.parametrize("fmt", FMTS)
def test_select_variant_matches_reference(fmt):
    for name in PROFILE_NAMES + [None]:
        mine = select_variant(fmt, None if name is None
                              else dp.get_profile(name))
        ref = jax_select(fmt, None if name is None
                         else jax_dp.get_profile(name))
        assert mine == ref
    if fmt == "q8_0":
        assert select_variant(fmt, dp.CMP_170HX) == "dot_i8"


@pytest.mark.parametrize("name", PROFILE_NAMES + [None])
def test_matmul_policy_chooses_reference_variant(name, monkeypatch):
    """``matmul(x, w, policy=)`` runs the variant the reference's
    ``matmul`` runs for the same profile, shape and dtype (its choice is
    read by stubbing its ``matmul_variant``)."""
    chosen = []
    monkeypatch.setattr(jax_matmul_ops, "matmul_variant",
                        lambda x, w, *, variant, interpret: chosen.append(
                            variant))
    shapes = ((16, 128, 128), (128, 1536, 8960), (128, 8960, 1536),
              (1024, 4096, 4096))
    for (m, k, n), (tdt, jdt) in itertools.product(
            shapes, ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16))):
        x, w = torch.zeros((m, k), dtype=tdt), torch.zeros((k, n), dtype=tdt)
        jx, jw = jnp.zeros((m, k), jdt), jnp.zeros((k, n), jdt)
        mine_pol = None if name is None else cp.PathPolicy(
            dp.get_profile(name))
        ref_pol = None if name is None else jax_cp.PathPolicy(
            jax_dp.get_profile(name))
        chosen.clear()
        try:
            jax_matmul_ops.matmul(jx, jw, policy=ref_pol)
            ref = chosen[0]
        except ValueError:
            ref = "ValueError"
        try:
            mine = policy_variant(x, w, mine_pol)
        except ValueError:
            mine = "ValueError"
        assert mine == ref, (name, m, k, n, tdt)


def test_policy_reroutes_the_cmp():
    x, w = torch.zeros((128, 1536)), torch.zeros((1536, 8960))
    assert policy_variant(x, w, cp.PathPolicy(dp.CMP_170HX)) == "mul_add"
    assert policy_variant(x, w, cp.PathPolicy(dp.CMP_170HX_NOFMA)) == \
        "mul_add"
    assert policy_variant(x, w, cp.PathPolicy(dp.A100_40G)) == "mxu"
    assert policy_variant(x, w, cp.PathPolicy(dp.TPU_V5E)) == "mxu"
    assert policy_variant(x, w, None) == "mxu"


# ----------------------------------------------------------------------
# K8 mixbench
# ----------------------------------------------------------------------

def _chain(x: np.ndarray, iters: int, fused: bool) -> np.ndarray:
    """The float32 chain in numpy: fused rounds each step once (the
    product and sum exact in float64), unfused rounds the product and
    the sum separately."""
    a, b = np.float32(0.999), np.float32(1e-3)
    y = x.copy()
    for _ in range(iters):
        if fused:
            y = (y.astype(np.float64) * a + b).astype(np.float32)
        else:
            y = (y * a).astype(np.float32) + b
    return y


@pytest.mark.parametrize("variant", ["fma", "mul_add"])
@pytest.mark.parametrize("iters", [1, 16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixbench_plain_matches_pallas(variant, iters, dtype):
    """Each Pallas arm against the port's plain version of the fused
    chain, at the reference test's tolerance: on the CPU XLA contracts
    both arms of the reference into a fused multiply-add (logged in
    ROADMAP section 3, pinned below).  The port's own arm is the chain
    its name says, bit for bit in float32."""
    x = np.linspace(0, 1, 2048).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = launch_counts()
    out = mixbench(tx, iters=iters, variant=variant, block=512)
    assert launch_counts() == before        # CPU: plain version, no launch
    assert out.dtype == tx.dtype and out.shape == tx.shape
    pallas = np.asarray(mixbench_pallas(jx, iters=iters, variant=variant,
                                        block=512, interpret=True
                                        ).astype(jnp.float32))
    fused = mixbench_ref(tx, iters, "fma").float().numpy()
    if dtype == "float32":
        assert np.max(np.abs(fused - pallas)) < 1e-6
        np.testing.assert_array_equal(out.numpy(),
                                      _chain(x, iters, variant == "fma"))
    else:
        # a bf16 product is exact in f32: both arms round as the
        # reference's chain does, bit for bit
        np.testing.assert_array_equal(fused, pallas)
        np.testing.assert_array_equal(out.float().numpy(), pallas)


def test_mixbench_reference_mul_add_is_fused_on_cpu():
    """Pins the reference's divergence: its ``mul_add`` arm (``t = y *
    a; y = t + b``) runs as one fused multiply-add per step under XLA on
    the CPU, so it equals the fused chain bit for bit and drifts from
    the separate multiply and add the arm names.  The smallest count of
    steps at which the drift passes the reference test's 1e-6 on its
    own input (linspace(0, 1, 2048)) is 17; the port's ``mul_add`` is
    the unfused chain."""
    x = np.linspace(0, 1, 2048).astype(np.float32)

    def ref_mul_add(iters):
        return np.asarray(mixbench_pallas(jnp.asarray(x), iters=iters,
                                          variant="mul_add", block=512,
                                          interpret=True))
    for iters in (16, 17):
        ref = ref_mul_add(iters)
        np.testing.assert_array_equal(ref, _chain(x, iters, fused=True))
        mine = mixbench(torch.from_numpy(x), iters=iters,
                        variant="mul_add").numpy()
        np.testing.assert_array_equal(mine, _chain(x, iters, fused=False))
        drift = float(np.max(np.abs(mine - ref)))
        assert (drift > 1e-6) == (iters == 17), (iters, drift)


def test_mixbench_contract():
    x = torch.zeros(2048)
    with pytest.raises(AssertionError):
        mixbench(x, iters=4, block=1000)
    with pytest.raises(ValueError):
        mixbench(x, iters=4, variant="fused")
    assert torch.equal(mixbench(x[:100], iters=2, block=1024),
                       mixbench_ref(x[:100], 2, "fma"))


@pytest.mark.parametrize("variant", ["fma", "mul_add"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixbench_card_rule(variant, dtype):
    """The rule the card check applies (``mixbench.check.compare``):
    f32 mul_add and both bf16 arms bit for bit, f32 fma within 1e-6;
    one unit in the last place is refused wherever bits must match."""
    dt = getattr(torch, dtype)
    ref = mixbench_ref(torch.linspace(0, 1, 4096).to(dt), 16, variant)
    assert compare(ref.clone(), ref, variant)["ok"]
    bits = ref.clone().view(torch.int32 if dtype == "float32"
                            else torch.int16)
    bits[1234] += 1                                 # one ulp up
    off = bits.view(dt)
    bitwise = not (dtype == "float32" and variant == "fma")
    assert tolerance(dt, variant) == (0.0 if bitwise else 1e-6)
    assert compare(off, ref, variant)["ok"] == (not bitwise)
    far = ref.clone()
    far[4000] += 1e-2
    assert not compare(far, ref, variant)["ok"]
    assert not compare(ref.to(torch.float16), ref, variant)["ok"]


def test_mixbench_card_cases_reach_every_path():
    """The card cases run one grid-stride pass and several over whole
    vectors, a scalar tail, and unaligned views: the kernel's grid is
    at most 8 blocks of 256 threads per SM (132 SMs on the H100), four
    elements per vector."""
    threads = 132 * 8 * 256
    cases = {what: (x, block) for what, x, block in
             card_cases(torch.float32, "cpu")}
    assert set(cases) == {"one pass", "passes", "tail", "unaligned"}
    for what, (x, block) in cases.items():
        assert x.numel() % block == 0
        assert x.min() >= 0 and x.max() <= 1
        aligned = x.data_ptr() % 16 == 0
        assert aligned == ("unaligned" not in what), what
        # aligned: vectors grid-stride; unaligned: every element does
        work = x.numel() // 4 if aligned else x.numel()
        assert (work > threads) == (what in ("passes", "unaligned")), what
    assert cases["tail"][0].numel() % 4 and cases["passes"][0].numel() % 4
    assert cases["one pass"][0].numel() % 4 == 0


# ----------------------------------------------------------------------
# K9 path-selectable matmul
# ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["mxu", "mul_add"])
@pytest.mark.parametrize("m,k,n,dtype", [
    (32, 128, 128, "float32"),
    (64, 256, 384, "float32"),
    (16, 512, 128, "bfloat16"),
])
def test_matmul_plain_matches_pallas(variant, m, k, n, dtype):
    x, w = _normal((m, k), 0), _normal((k, n), 1)
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    before = launch_counts()
    out = matmul_variant(tx, tw, variant=variant, bm=16, bk=128, bn=128)
    assert launch_counts() == before
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    pallas = fma_matmul_pallas(jx, jw, variant=variant, bm=16, bk=128,
                               bn=128, interpret=True)
    assert _rel(out.numpy(), pallas) < 1e-4
    assert torch.equal(out, matmul_ref(tx, tw))


def test_matmul_policy_entry_on_cpu():
    x, w = _normal((32, 256), 0), _normal((256, 128), 1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for profile in (dp.CMP_170HX, dp.A100_40G, dp.TPU_V5E, None):
        policy = None if profile is None else cp.PathPolicy(profile)
        assert torch.equal(matmul(tx, tw, policy=policy),
                           matmul_ref(tx, tw))
    with pytest.raises(ValueError):            # CMP has no bf16 path
        matmul(tx.bfloat16(), tw.bfloat16(),
               policy=cp.PathPolicy(dp.CMP_170HX))


@pytest.mark.parametrize("m,k,n,dtype,runs,slots", [
    (128, 1536, 8960, "float32", 132, 166),     # 35 tiles of 48 K blocks
    (128, 8960, 1536, "float32", 132, 137),     # 6 tiles of 280
    (128, 1536, 8960, "bfloat16", 132, 166),    # 35 tiles of 24
    (1, 1536, 8960, "float32", 132, 166),
    (300, 512, 256, "float32", 48, 50),         # 3 tiles of 16 blocks
    (8, 64, 256, "bfloat16", 1, 1),             # one block in all
])
def test_matmul_stream_plan(m, k, n, dtype, runs, slots):
    """The weight stream cuts the K blocks of its 128 x 256 tiles into
    one run per SM (132 on the H100), fewer when there are fewer
    blocks; a run may hold a piece of a tile, so the workspace has a
    slot for each (run, tile) pair that can meet: runs + tiles - 1."""
    assert stream_plan(m, k, n, getattr(torch, dtype), 132) == (runs, slots)


@pytest.mark.parametrize("m,k,n,dtype,runs,slots", [
    (128, 1536, 8960, "float32", 132, 166),     # 35 tiles of 48 K blocks
    (128, 1536, 8960, "bfloat16", 132, 166),    # 35 tiles of 48, not 24
    (128, 8960, 1536, "bfloat16", 132, 137),    # 6 tiles of 280
    (300, 512, 256, "bfloat16", 48, 50),        # 3 tiles of 16 (mxu: 8)
    (8, 64, 256, "bfloat16", 2, 2),             # two blocks (mxu: one)
])
def test_matmul_stream_plan_mul_add(m, k, n, dtype, runs, slots):
    """The mul_add arm stages 32 K a block in both types (mxu stages 64
    in bfloat16), so its plan cuts bfloat16 into twice the blocks."""
    assert stream_plan(m, k, n, getattr(torch, dtype), 132,
                       "mul_add") == (runs, slots)


def test_matmul_stream_rows():
    """The weight stream takes x and w whose rows TMA can read: whole
    16-byte chunks on 16-byte-aligned bases; other operands go to the
    WMMA kernel."""
    assert stream_rows(torch.zeros((4, 1028)), torch.zeros((1028, 8)))
    assert not stream_rows(torch.zeros((4, 130)), torch.zeros((130, 8)))
    assert not stream_rows(torch.zeros((4, 128)), torch.zeros((128, 130)))
    shifted = torch.zeros(132)[1:129].view(1, 128)     # base 4 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert not stream_rows(shifted, torch.zeros((128, 8)))
    bf16 = dict(dtype=torch.bfloat16)
    assert not stream_rows(torch.zeros((4, 132), **bf16),
                           torch.zeros((132, 8), **bf16))
    assert stream_rows(torch.zeros((4, 128), **bf16),
                       torch.zeros((128, 16), **bf16))


def test_matmul_breakdown_cuts_match_the_source():
    """The card-side breakdown of K9's weight stream cuts parts out of
    ``csrc/fma_matmul.cu`` by text: each cut of either arm must still
    match exactly once, and each variant must apply cuts that exist."""
    from repro_torch.kernels import _build, breakdown
    text = (_build.CSRC / "fma_matmul.cu").read_text()
    cuts = breakdown.CUTS["fma_matmul"]
    assert {old: text.count(old) for old, _ in cuts.values()} \
        == {old: 1 for old, _ in cuts.values()}
    arms = {target: variants for target, (source, variants)
            in breakdown.TARGETS.items() if source == "fma_matmul"}
    assert set(arms) == {"mxu", "mul_add"}
    assert all(c in cuts for arm in arms.values()
               for variant in arm.values() for c in variant)
    assert {c for arm in arms.values()
            for variant in arm.values() for c in variant} == set(cuts)


@pytest.mark.parametrize("bad", ["m", "k", "n", "variant"])
def test_matmul_contract(bad):
    x, w = torch.zeros((48, 256)), torch.zeros((256, 192))
    kw = dict(variant="mxu", bm=16, bk=128, bn=64)
    if bad == "variant":
        kw["variant"] = "fma"
        with pytest.raises(ValueError):
            matmul_variant(x, w, **kw)
        return
    kw[{"m": "bm", "k": "bk", "n": "bn"}[bad]] = {"m": 32, "k": 96,
                                                  "n": 128}[bad]
    with pytest.raises(AssertionError):
        matmul_variant(x, w, **kw)


# ----------------------------------------------------------------------
# K7 block-quantized matmul
# ----------------------------------------------------------------------

def _qt_pair(fmt, k, n, seed=1):
    """The reference's QTensor and the port's, carried across the
    numpy planes."""
    jqt = jax_quantize(jnp.asarray(_normal((k, n), seed)), fmt)
    host = jax.device_get(jqt)
    return jqt, qtensor_from_numpy(fmt, host.shape, host.values,
                                   host.super_scales, host.sub_scales,
                                   host.sub_mins, host.super_mins)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("m,k,n", [(16, 256, 128), (32, 512, 256),
                                   (8, 1024, 128)])
def test_qmatmul_dequant_plain_matches_pallas(fmt, m, k, n):
    x = _normal((m, k), 0)
    jqt, tqt = _qt_pair(fmt, k, n)
    before = launch_counts()
    out = qmatmul_variant(torch.from_numpy(x), tqt, variant="dequant_dot",
                          bm=8, bk=256, bn=128)
    assert launch_counts() == before
    pallas = qmatmul_pallas(jnp.asarray(x), jqt, variant="dequant_dot",
                            bm=8, bk=256, bn=128, interpret=True)
    assert _rel(out.numpy(), pallas) < 1e-5
    assert torch.equal(out, qmatmul_ref(torch.from_numpy(x), tqt))


@pytest.mark.parametrize("k", [256, 512])
def test_qmatmul_dot_i8_plain_matches_pallas(k):
    x = _normal((16, k), 0)
    jqt, tqt = _qt_pair("q8_0", k, 128)
    out = qmatmul_variant(torch.from_numpy(x), tqt, variant="dot_i8",
                          bm=8, bk=256, bn=128)
    pallas = qmatmul_pallas(jnp.asarray(x), jqt, variant="dot_i8", bm=8,
                            bk=256, bn=128, interpret=True)
    assert _rel(out.numpy(), pallas) < 1e-5
    assert torch.equal(out, qmatmul_i8_ref(torch.from_numpy(x), tqt))


@pytest.mark.parametrize("fmt", FMTS)
def test_qmatmul_policy_entry_on_cpu(fmt):
    x = torch.from_numpy(_normal((8, 512), 0))
    _, tqt = _qt_pair(fmt, 512, 128)
    out = qmatmul(x, tqt, profile=dp.CMP_170HX)
    want = (qmatmul_i8_ref(x, tqt) if fmt == "q8_0"
            else qmatmul_ref(x, tqt))
    assert torch.equal(out, want)
    assert torch.equal(qmatmul(x, tqt), qmatmul_ref(x, tqt))


@pytest.mark.parametrize("bad", ["k_block", "m", "n", "variant",
                                 "dot_i8_q6_k"])
def test_qmatmul_contract(bad):
    fmt = "q6_k" if bad == "dot_i8_q6_k" else "q8_0"
    tqt = quantize(torch.from_numpy(_normal((768, 128), 0)), fmt)
    x = torch.zeros((24, 768))
    kw = dict(variant="dequant_dot", bm=8, bk=256, bn=128)
    if bad == "variant":
        kw["variant"] = "mxu"
        with pytest.raises(ValueError):
            qmatmul_variant(x, tqt, **kw)
        return
    if bad == "dot_i8_q6_k":
        kw["variant"] = "dot_i8"
        with pytest.raises(ValueError):
            qmatmul_variant(x, tqt, **kw)
        return
    # bk clamps down to a multiple of the block: 300 -> 288 does not
    # divide 768; bm 16 does not divide 24; bn 96 does not divide 128
    kw.update({"k_block": {"bk": 300}, "m": {"bm": 16},
               "n": {"bn": 96}}[bad])
    with pytest.raises(AssertionError):
        qmatmul_variant(x, tqt, **kw)


def test_wrappers_refuse_other_devices():
    """No silent CPU fallback: a tensor on neither the CPU nor the card
    is refused by every wrapper."""
    x = torch.zeros(1024, device="meta")
    with pytest.raises(ValueError):
        mixbench(x, iters=2)
    a, w = torch.zeros((16, 128), device="meta"), torch.zeros(
        (128, 128), device="meta")
    with pytest.raises(ValueError):
        matmul_variant(a, w, variant="mul_add")
    tqt = quantize(torch.from_numpy(_normal((256, 128), 0)), "q8_0")
    with pytest.raises(ValueError):
        qmatmul_variant(torch.zeros((8, 256), device="meta"), tqt)


_SASS = """
        Function : _ZN12_GLOBAL__N_120mixbench_f32_mul_addEPKfPflifb
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R5, R4, R2 ;
        /*0020*/                   FADD R5, R5, R3 ;
        /*0030*/              @!P0 HFMA2.MMA R3, -RZ, RZ, 0, 0 ;
        Function : _ZN12_GLOBAL__N_116mixbench_f32_fmaEPKfPflifb
        /*0000*/                   FFMA R5, R4, R2, R3 ;
        /*0010*/                   HFMA2.BF16 R6, R4, R2, R3 ;
        Function : _ZN12_GLOBAL__N_118fma_matmul_mxu_f32EPKfS1_Pfiii
        /*0000*/                   HMMA.1684.F32.TF32 R4, R8, R12, R4 ;
        Function : _ZN12_GLOBAL__N_119fma_matmul_mxu_bf16EPK13__nv_bfloat16S2_PfS3_iiiiil
        /*0000*/                   LDSM.16.MT88.4 R20, [R2+UR4] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        Function : _ZN12_GLOBAL__N_123fma_matmul_mxu_wmma_f32EPKfS1_Pfiii
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""


def test_sass_parse_and_rules():
    """The instruction counts the SASS check reads: the HFMA2.MMA move
    form is no multiply-add; a mul_add kernel with one FFMA, or an mxu
    kernel without HMMA, is a breach; missing kernels are named."""
    found = kernel_counts(parse_sass(_SASS))
    assert found == {"mixbench_f32_mul_add": {"mul": 1, "add": 1, "mov": 1},
                     "mixbench_f32_fma": {"fma": 2},
                     "fma_matmul_mxu_f32": {"hmma": 1},
                     "fma_matmul_mxu_bf16": {"hmma": 1},
                     "fma_matmul_mxu_wmma_f32": {"hmma": 1}}
    problems = check_counts(found)
    assert sorted(problems) == sorted(f"{k}: not found" for k in SASS_KERNELS
                                      if k not in found)
    fused = _SASS.replace("FADD R5, R5, R3", "FFMA R5, R5, R2, R3")
    assert any("mixbench_f32_mul_add is not" in p for p in
               check_counts(kernel_counts(parse_sass(fused))))
    no_mma = _SASS.replace("HMMA.1684.F32.TF32", "FFMA")
    assert any("fma_matmul_mxu_f32 does not" in p for p in
               check_counts(kernel_counts(parse_sass(no_mma))))
    # the WMMA kernel is one of the mxu kernels, held to the same rule,
    # and the stream's name does not match it (nor it the stream's)
    no_wmma_mma = _SASS.replace("HMMA.1688.F32.TF32", "FMUL")
    problems = check_counts(kernel_counts(parse_sass(no_wmma_mma)))
    assert any("fma_matmul_mxu_wmma_f32 does not" in p for p in problems)
    assert not any(p.startswith("fma_matmul_mxu_f32 ") for p in problems)
    assert {"fma_matmul_mxu_wmma_f32", "fma_matmul_mxu_wmma_bf16",
            "fma_matmul_mxu_f32", "fma_matmul_mxu_bf16"} <= set(SASS_KERNELS)


_SASS_MUL_ADD = """
        Function : _ZN12_GLOBAL__N_129fma_matmul_mul_add_staged_f32EPKfS1_Pfiii
        /*0000*/                   FMUL R5, R4, R2 ;
        /*0010*/                   FADD R5, R5, R3 ;
        Function : _ZN12_GLOBAL__N_122fma_matmul_mul_add_f32EPKfS1_PfS2_14CUtensorMap_stS3_iiiiil
        /*0000*/                   LDS.128 R8, [R2] ;
        /*0010*/                   FMUL R5, R4, R2 ;
        /*0020*/                   FADD R5, R5, R3 ;
        Function : _ZN12_GLOBAL__N_124fma_matmul_splitk_reduceEPKfPfiiiill
        /*0000*/                   LDG.E.128 R4, [R2.64] ;
        /*0010*/                   FADD R5, R5, R9 ;
"""


@pytest.mark.parametrize("edit,breach", [
    (None, None),
    (("FADD R5, R5, R9", "FFMA R5, R5, R2, R9"), "fma_matmul_splitk_reduce"),
    (("FADD R5, R5, R9", "HMMA.1684.F32.TF32 R4, R8, R12, R4"),
     "fma_matmul_splitk_reduce"),
    (("FADD R5, R5, R9", "MOV R5, R9"), "fma_matmul_splitk_reduce"),
    (("FADD R5, R5, R3 ;\n        Function : _ZN12_GLOBAL__N_122",
      "FFMA R5, R5, R2, R3 ;\n        Function : _ZN12_GLOBAL__N_122"),
     "fma_matmul_mul_add_staged_f32"),
    (("LDS.128 R8, [R2]", "HFMA2 R8, R4, R2, R3"), "fma_matmul_mul_add_f32"),
])
def test_sass_rules_cover_the_mul_add_arm(edit, breach):
    """Every kernel the mul_add arm launches is held by the SASS rule:
    the stream and the staged kernel need FMUL and FADD and no fused or
    matrix instruction; the split-K reduce, which has no multiply, needs
    its adds and no FFMA, HFMA2 or HMMA.  The stream's name does not
    match the staged kernel (nor it the stream's)."""
    text = _SASS_MUL_ADD if edit is None else _SASS_MUL_ADD.replace(*edit)
    assert text.count(edit[1]) == 1 if edit else True
    found = kernel_counts(parse_sass(text))
    assert set(found) == {"fma_matmul_mul_add_staged_f32",
                          "fma_matmul_mul_add_f32",
                          "fma_matmul_splitk_reduce"}
    problems = [p for p in check_counts(found) if "not found" not in p]
    assert [p.split()[0] for p in problems] == ([breach] if breach else [])
    assert {"fma_matmul_mul_add_staged_f32", "fma_matmul_mul_add_staged_bf16",
            "fma_matmul_splitk_reduce"} <= set(SASS_KERNELS)


def _sym(name: str) -> str:
    """The mangled symbol of a kernel of the anonymous namespace."""
    return (f"_ZN43_GLOBAL__N__f7884295_10_qmatmul_cu_0be9709f{len(name)}"
            f"{name}EPKhS1_S1_S1_S1_S1_PKfPfS4_iiiiiix")


_SASS_K7 = f"""
        Function : {_sym("qmatmul_dequant_dot_q4_k_f32_m128")}
        /*0000*/                   LDSM.16.MT88.4 R20, [R2+UR4] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   FFMA R5, R4, R2, R3 ;
        Function : {_sym("qmatmul_dequant_dot_q4_k_f32_m128_plain")}
        /*0000*/                   HMMA.16816.F32.BF16 R24, R8, R12, R24 ;
        Function : {_sym("qmatmul_dot_i8_m16")}
        /*0000*/                   PRMT R5, R4, 0x5140, R6 ;
        /*0010*/                   IMMA.16832.S8.S8 R4, R8.ROW, R12.COL, R4 ;
        /*0020*/                   FMUL R5, R4, R2 ;
        Function : {_sym("qmatmul_dot_i8_m16_plain")}
        /*0000*/                   IMMA.16832.S8.S8 R20, R8.ROW, R12.COL, R20 ;
"""


@pytest.mark.parametrize("edit,breach", [
    (None, None),
    (("HMMA.16816.F32.BF16 R4, R8, R12, R4", "FFMA R4, R8, R12, R4"),
     "qmatmul_dequant_dot_q4_k_f32_m128"),
    (("HMMA.16816.F32.BF16 R24, R8, R12, R24", "FMUL R24, R8, R12"),
     "qmatmul_dequant_dot_q4_k_f32_m128_plain"),
    (("IMMA.16832.S8.S8 R4, R8.ROW, R12.COL, R4",
      "IDP.4A.S8.S8 R4, R8, R12, R4"), "qmatmul_dot_i8_m16"),
    (("PRMT R5, R4, 0x5140, R6", "IDP.4A.S8.S8 R5, R4, R6, R5"),
     "qmatmul_dot_i8_m16"),
    (("IMMA.16832.S8.S8 R20, R8.ROW, R12.COL, R20",
      "HMMA.16816.F32.BF16 R20, R8, R12, R20"), "qmatmul_dot_i8_m16_plain"),
])
def test_sass_rules_hold_k7(edit, breach):
    """K7's SASS rules: HMMA in every dequant_dot kernel, IMMA and no
    IDP.4A (``__dp4a``) in every dot_i8 kernel; a kernel's name does not
    match its ``_plain`` twin (nor the twin its)."""
    text = _SASS_K7 if edit is None else _SASS_K7.replace(*edit)
    assert text.count(edit[1]) == 1 if edit else True
    found = kernel_counts(parse_sass(text))
    assert set(found) == {"qmatmul_dequant_dot_q4_k_f32_m128",
                          "qmatmul_dequant_dot_q4_k_f32_m128_plain",
                          "qmatmul_dot_i8_m16", "qmatmul_dot_i8_m16_plain"}
    if edit is None:
        assert found["qmatmul_dot_i8_m16"] == {"imma": 1, "mul": 1}
        assert found["qmatmul_dequant_dot_q4_k_f32_m128"] == {"hmma": 1,
                                                              "fma": 1}
    problems = [p for p in check_counts(found) if "not found" not in p]
    assert [p.split()[0] for p in problems] == ([breach] if breach else [])
    assert set(found) <= set(SASS_KERNELS) and "qmatmul" in SASS_LIBS


# ----------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ----------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fma", "mul_add"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixbench_kernel_on_card(variant, dtype):
    """The rule and the cases of ``mixbench.check``, as chip_smoke.py
    applies them: one grid-stride pass and several, aligned and not."""
    _need_cuda()
    for (what, x, block), iters in itertools.product(
            card_cases(getattr(torch, dtype), "cuda"), (1, 16, 128)):
        r = check_on_card(x, iters, variant, block)
        assert r["ok"], (what, iters, r)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mxu", "mul_add"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_kernel_on_card(variant, dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = {("mxu", "float32"): 2e-3, ("mxu", "bfloat16"): 1e-4}.get(
        (variant, dtype), 1e-5)
    for m, k, n in ((128, 1024, 512), (128, 1536, 8960), (128, 8960, 1536),
                    (1, 1536, 8960), (100, 1000, 520), (37, 100, 77)):
        x = torch.from_numpy(_normal((m, k), 0)).cuda().to(getattr(torch,
                                                                   dtype))
        w = torch.from_numpy(_normal((k, n), 1)).cuda().to(getattr(torch,
                                                                   dtype))
        out = matmul_variant(x, w, variant=variant, bm=1, bk=1, bn=1)
        ref = matmul_ref(x, w)
        torch.cuda.synchronize()
        assert _rel(out.cpu(), ref.cpu()) <= tol


def _check_stream_and_staged(variant, tol, dtype):
    """One arm's two kernels: the weight stream at the MLP shapes, the
    reference bench's, one decode row and a ragged shape, the staged
    kernel on rows that are not whole 16-byte chunks; each within
    ``tol`` of one f32 matmul, and each call repeated bit for bit (the
    split-K pieces are added in one fixed order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    stream, staged = {"mxu": ("fma_matmul_mxu", "fma_matmul_mxu_wmma"),
                      "mul_add": ("fma_matmul_mul_add",
                                  "fma_matmul_mul_add_staged")}[variant]
    cases = [((128, 1536, 8960), {}, stream),
             ((128, 8960, 1536), {}, stream),
             ((128, 1024, 512), {}, stream),
             ((1, 1536, 8960), {}, stream),
             ((100, 1000, 520), dict(bk=8, bn=8), stream),
             ((128, 1536, 130), dict(bn=2), staged)]
    for (m, k, n), blocks, kernel in cases:
        x = torch.from_numpy(_normal((m, k), 0)).cuda().to(getattr(torch,
                                                                   dtype))
        w = torch.from_numpy(_normal((k, n), 1)).cuda().to(getattr(torch,
                                                                   dtype))
        before = launch_counts()
        out = matmul_variant(x, w, variant=variant, **blocks)
        again = matmul_variant(x, w, variant=variant, **blocks)
        torch.cuda.synchronize()
        ran = {kk: v - before[kk] for kk, v in launch_counts().items()
               if v != before[kk]}
        assert ran == {kernel: 2}, ((m, k, n), ran)
        assert torch.equal(out, again), (m, k, n)
        assert _rel(out.cpu(), matmul_ref(x, w).cpu()) <= tol, (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_mxu_kernels_on_card(dtype):
    """The mxu arm: the weight stream and the WMMA kernel, TF32 (f32)
    and bf16 products within their tolerances."""
    _need_cuda()
    _check_stream_and_staged("mxu", {"float32": 2e-3,
                                     "bfloat16": 1e-4}[dtype], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_mul_add_kernels_on_card(dtype):
    """The mul_add arm: the weight stream's register-tiled FMUL/FADD
    product and the staged kernel, exact f32 products summed in f32,
    within 1e-5."""
    _need_cuda()
    _check_stream_and_staged("mul_add", 1e-5, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,fmt", [("dequant_dot", f) for f in FMTS]
                         + [("dot_i8", "q8_0")])
def test_qmatmul_kernel_on_card(variant, fmt):
    """Both MLP shapes and (K 512, N 100), whose rows are not whole
    16-byte chunks (the ``_plain`` kernels); M 1, 8, 24, 128 and 256, f32
    and bf16 x; within 1e-5 of the plain version, each call repeated bit
    for bit (the split-K pieces are added in run order)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for k, n, bk in ((1536, 8960, 512), (8960, 1536, 256), (512, 100, 512)):
        qt = quantize(torch.from_numpy(_normal((k, n), 1)).cuda(), fmt)
        for m, dtype in itertools.product((1, 8, 24, 128, 256),
                                          (torch.float32, torch.bfloat16)):
            x = torch.from_numpy(_normal((m, k), 0)).cuda().to(dtype)
            out = qmatmul_variant(x, qt, variant=variant, bk=bk)
            again = qmatmul_variant(x, qt, variant=variant, bk=bk)
            ref = (qmatmul_i8_ref(x, qt) if variant == "dot_i8"
                   else qmatmul_ref(x, qt))
            torch.cuda.synchronize()
            assert _rel(out.cpu(), ref.cpu()) <= 1e-5, (m, k, n, dtype)
            assert torch.equal(out, again), (m, k, n, dtype)


@pytest.mark.cuda
def test_mul_add_kernels_hold_no_fused_multiply_add_on_card():
    """The paper's -fmad=false, on the instructions: ``cuobjdump -sass``
    of the built libraries of SASS_LIBS shows no FFMA/HFMA2 in any
    mul_add kernel, FFMA/HFMA2 in mixbench's fma kernels, HMMA in
    fma_matmul's mxu kernels and K2's bf16 kernels, and none in the
    f32 attention kernels (the rules chip_smoke.py applies)."""
    _need_cuda()
    from repro_torch.kernels import _build
    _build.build_all(SASS_LIBS)
    found, problems = sass_report()
    assert sorted(found) == sorted(SASS_KERNELS)
    assert problems == []
