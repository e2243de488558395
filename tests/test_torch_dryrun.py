"""The dry run on one device and the parallel layer under it against the
reference's.

* ``_model_flops`` and ``input_specs`` (shapes and dtypes) for every
  cell of ``all_cells()``, ``active_params`` / ``total_params`` for all
  11 configs, and ``RooflineTerms.to_json()`` / ``markdown_table`` on
  the same inputs are the reference's;
* ``param_spec`` is the reference's for every leaf of every SMOKE arch
  -- on the port's (1, 1) mesh and, since the rule functions read only
  ``axis_names`` and ``shape``, on mesh-like objects of the reference's
  16x16 and 2x16x16 shapes, in train and serve mode; ``param_shardings``
  over a port module gives each per-layer tensor its stacked leaf's
  spec without the layer entry;
* ``compressed_psum`` over one participant and
  ``compress_roundtrip_error`` match the reference's (``shard_map`` over
  a one-device CPU mesh) within one float32 ulp at the tensor's scale;
* ``blockwise_attention`` matches the reference's blockwise and the
  port's ``attention_ref`` within 1e-5 (float32), causal, windowed and
  unmasked;
* the meta pass's counted FLOPs on SMOKE configs of each family equal
  ``derived_flops``, the step's matmuls worked out from the config
  (see its docstring: the remat recompute, skipping each block's last
  product, and the backward's 2x / five attention products / 3x SSD
  are counted), and ``FlopCounterMode``'s own total; the ratio to the
  reference's ``cost_analysis()["flops"]`` for qwen2.5-1.5b SMOKE is
  printed (information, not a gate);
* the ``meta`` arms are taken only on ``meta``: a CPU call still runs
  the plain version, another device still raises, and ``repeated``'s
  shortcut counts what the full loop counts on the CPU;
* ``run_cell`` records, the refused production meshes, and the
  moment-less control of the memory check.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
import repro.core.roofline as jax_roofline  # noqa: E402
import repro.core.hlo_analysis as jax_hlo  # noqa: E402
import repro.parallel.sharding as jax_sharding  # noqa: E402
from repro.kernels.flash_attention.blockwise import \
    blockwise_attention as jax_blockwise  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import compression as jax_compression  # noqa: E402

# the reference's dry run forces 512 host devices through XLA_FLAGS when
# it is imported; keep this process's flags as they were
_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jax_dryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

import repro_torch.configs as configs  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.op_analysis import (CollectiveStats,  # noqa: E402
                                          OpAnalysis, count_convert_pairs,
                                          op_census)
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.blockwise import \
    blockwise_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.models.registry import param_module  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.parallel import (constrain, current_mesh,  # noqa: E402
                                  current_mode, param_shardings, param_spec,
                                  use_mesh)
from repro_torch.parallel import sharding  # noqa: E402

pytestmark = [pytest.mark.torch_port]

CELLS = configs.all_cells()
ARCHS = sorted(configs._MODULES)
META = torch.device("meta")


class DuckMesh:
    """A mesh as the rule functions read one: axis names and sizes."""

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


MESHES = {"1x1": make_test_mesh((1, 1)),
          "16x16": DuckMesh((16, 16), ("data", "model")),
          "2x16x16": DuckMesh((2, 16, 16), ("pod", "data", "model"))}


# ----------------------------------------------------------------------
# the matrix, parameter counts and the roofline
# ----------------------------------------------------------------------

def test_matrix_equals_reference():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert "qwen2.5-1.5b" not in configs.ARCH_IDS
    assert configs.SHAPES == jax_configs.SHAPES
    assert configs.LONG_CONTEXT_ARCHS == jax_configs.LONG_CONTEXT_ARCHS
    assert CELLS == jax_configs.all_cells() and len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_input_specs_equal_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    assert dryrun._model_flops(cfg, shape) == \
        jax_dryrun._model_flops(jcfg, shape)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in dryrun.input_specs(cfg, shape).items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jax_dryrun.input_specs(jcfg, shape).items()}
    assert got == want
    assert all(t.device.type == "meta"
               for t in dryrun.input_specs(cfg, shape).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    for smoke in (False, True):
        cfg = configs.get_config(arch, smoke)
        jcfg = jax_configs.get_config(arch, smoke)
        assert cfg.active_params_per_layer() == \
            jcfg.active_params_per_layer()
        assert cfg.active_params() == jcfg.active_params()
        assert cfg.total_params() == jcfg.total_params()


def test_roofline_equals_reference(tmp_path):
    """``analyze`` / ``to_json`` / ``markdown_table`` / ``load_jsonl`` on
    every cell, the same inputs into both packages (the counted FLOPs of
    ``derived_flops``, made-up bytes)."""
    rows, jrows = [], []
    for i, (arch, shape) in enumerate(CELLS):
        cfg = configs.get_config(arch)
        sh = configs.SHAPES[shape]
        args = (f"{arch}/{shape}/1x1", 1,
                float(dryrun.derived_flops(cfg, sh["kind"],
                                           sh["global_batch"],
                                           sh["seq_len"])),
                1e12 * (i + 1), 0.0, dryrun._model_flops(cfg, shape))
        rows.append(roofline.analyze(*args))
        jrows.append(jax_roofline.analyze(*args))
        assert rows[-1].to_json() == jrows[-1].to_json()
    assert roofline.markdown_table(rows) == jax_roofline.markdown_table(jrows)
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r.to_json()) + "\n"
                            for r in rows[:3]))
    assert roofline.load_jsonl(str(path)) == jax_roofline.load_jsonl(
        str(path))


def test_collective_stats_equal_reference():
    a, b = CollectiveStats(), jax_hlo.CollectiveStats()
    for kind, n in (("all_reduce", 64), ("all-gather", 128),
                    ("all_reduce", 32), ("collective_permute", 8)):
        a.add(kind, n)
        b.add(kind, n)
    assert (a.bytes_by_kind, a.count_by_kind, a.total_bytes, a.total_count,
            a.summary()) == (b.bytes_by_kind, b.count_by_kind,
                             b.total_bytes, b.total_count, b.summary())
    assert CollectiveStats().summary() == "no collectives"


# ----------------------------------------------------------------------
# the parallel layer
# ----------------------------------------------------------------------

def _ref_leaves(arch):
    cfg = jax_configs.get_config(arch, smoke=True)
    tree = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference(arch):
    leaves = _ref_leaves(arch)
    assert leaves
    for mesh in MESHES.values():
        for mode in ("train", "serve"):
            for path, leaf in leaves:
                ps = jax_sharding._path_str(path)
                want = tuple(jax_sharding.param_spec(mesh, path, leaf, mode))
                assert param_spec(mesh, ps, leaf, mode) == want, (ps, mode)
    # param_shardings over the port's per-layer module: a block tensor
    # takes its stacked leaf's spec without the layer entry
    want = {jax_sharding._path_str(p): tuple(
        jax_sharding.param_spec(MESHES["16x16"], p, leaf))
        for p, leaf in leaves}
    module = param_module(configs.get_config(arch, smoke=True), META)
    from repro_torch.models.common import reference_path
    for name, spec in param_shardings(MESHES["16x16"], module).items():
        path, layer = reference_path(name)
        assert spec == (want[path][1:] if layer is not None
                        else want[path]), name


def test_moment_rules_and_batch_cache_specs_equal_reference():
    mesh = MESHES["2x16x16"]
    for ps in ("mu/blocks/attn/wq/q", "nu/blocks/mlp/w_down",
               "blocks/moe/w_up", "embed/tok", "blocks/ssm/in_proj",
               "opt/mu/blocks/moe/w_gate/scale"):
        for nd in (2, 3, 4):
            assert sharding._rule_for(ps, nd) == \
                tuple(jax_sharding._rule_for(ps, nd))
    for shape, logical in (((256, 4096), ("batch", None)),
                           ((3, 4096), ("batch", None)),
                           ((8, 64, 12), ("batch", "seq", "tp"))):
        for mode in ("train", "serve"):
            assert sharding._spec_with_div(mesh, shape, logical, mode) == \
                tuple(jax_sharding._spec_with_div(mesh, shape, logical,
                                                  mode))
    specs = {"tokens": torch.empty(64, 32, device=META),
             "frames": torch.empty(64, 32, 8, device=META)}
    assert sharding.batch_shardings(mesh, specs) == {
        "tokens": (("pod", "data"), None),
        "frames": (("pod", "data"), None, None)}
    cache = {"k": torch.empty(2, 64, 8, 512, 64, device=META),
             "len": torch.empty(64, device=META)}
    assert sharding.cache_shardings(mesh, cache) == {
        "k": (None, ("pod", "data"), None, "model", None), "len": (None,)}


def test_meshes_and_context():
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            make_production_mesh(multi_pod=multi)
    mesh = make_test_mesh((1, 1))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_test_mesh((2, 1))
    x = torch.arange(6.0)
    assert current_mesh() is None and current_mode() == "train"
    with use_mesh(mesh, mode="serve"):
        assert current_mesh() is mesh and current_mode() == "serve"
        assert constrain(x, "batch") is x
        with use_mesh(None):
            assert current_mesh() is None
        assert current_mesh() is mesh
    assert current_mesh() is None and current_mode() == "train"
    assert sharding.replicated(mesh) == ()


@pytest.mark.parametrize("shape,chunk", [((4196,), 2048), ((3, 1000), 512)])
def test_compressed_psum_matches_reference(shape, chunk):
    """One participant: the port with no process group against the
    reference inside ``shard_map`` over a one-device mesh.  Tolerance:
    one float32 ulp at the tensor's scale (2^-23 max|x|)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    x.reshape(-1)[:7] = 0.0                  # a chunk with zeros in it
    mesh = jax.make_mesh((1,), ("pod",), devices=jax.devices()[:1])
    f = jax.shard_map(lambda g: jax_compression.compressed_psum(
        g, axis="pod", chunk=chunk), mesh=mesh,
        in_specs=jax.sharding.PartitionSpec(),
        out_specs=jax.sharding.PartitionSpec())
    jmean, jresid = (np.asarray(t) for t in f(jnp.asarray(x)))
    mean, resid = compression.compressed_psum(torch.from_numpy(x),
                                              chunk=chunk)
    tol = 2.0 ** -23 * float(np.max(np.abs(x)))
    assert mean.dtype == torch.float32 and tuple(mean.shape) == shape
    assert np.max(np.abs(mean.numpy() - jmean)) <= tol
    assert np.max(np.abs(resid.numpy() - jresid)) <= tol
    err = compression.compress_roundtrip_error(torch.from_numpy(x), chunk)
    jerr = jax_compression.compress_roundtrip_error(jnp.asarray(x), chunk)
    assert err == pytest.approx(jerr, rel=1e-6)
    assert 0 < err < 0.01


def test_compressed_psum_over_a_process_group_of_one():
    """Through ``torch.distributed`` (gloo, one process): the same mean
    and residual as with no group."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.randn(3000, generator=torch.Generator().manual_seed(4))
        got = compression.compressed_psum(x, group=dist.group.WORLD,
                                          chunk=512)
        want = compression.compressed_psum(x, chunk=512)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_blockwise_matches_reference_and_plain(causal, window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 256, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 256, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, 256, 32)).astype(np.float32)
    got = blockwise_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              causal=causal, window=window, block=64)
    want = np.asarray(jax_blockwise(*(jnp.asarray(t) for t in (q, k, v)),
                                    causal=causal, window=window, block=64))
    plain = attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                          causal=causal, window=window)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5
    assert torch.max(torch.abs(got - plain)).item() <= 1e-5


# ----------------------------------------------------------------------
# counted FLOPs
# ----------------------------------------------------------------------

#: one SMOKE config of each family
FAMILY_ARCHS = ("qwen2.5-1.5b", "moonshot-v1-16b-a3b", "mamba2-780m",
                "hymba-1.5b", "phi-3-vision-4.2b", "whisper-base")
STEPS = [("train", 2, 64, True), ("train", 2, 64, False),
         ("train", 2, 48, True), ("prefill", 2, 64, True),
         ("decode", 3, 40, True)]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_counted_flops_equal_derived(arch):
    cfg = configs.get_config(arch, smoke=True)
    for kind, b, s, remat in STEPS:
        a = dryrun.analyze_step(cfg, kind, b, s, remat=remat)
        want = dryrun.derived_flops(cfg, kind, b, s, remat=remat)
        assert a["flops"] == want, (kind, b, s, remat)
        assert a["collectives"].total_count == 0
        assert a["peak_bytes"] >= a["argument_bytes"] > 0


def test_counts_come_from_flop_counter_and_reference_ratio():
    """The FLOPs are ``FlopCounterMode``'s: its own total over the same
    meta step equals the analysis's.  The ratio to the reference's
    compiled ``cost_analysis()["flops"]`` (qwen2.5-1.5b SMOKE, unrolled,
    one microbatch) is printed: XLA counts elementwise work too and
    fuses, so it is information, not a gate."""
    cfg = configs.get_config("qwen2.5-1.5b", smoke=True)
    b, s = 2, 64
    state = dryrun.train_state(cfg)
    specs = dryrun.batch_specs(cfg, "train", b, s)
    from repro_torch.train import TrainConfig, make_train_step
    step = make_train_step(cfg, TrainConfig(remat=True))
    with FlopCounterMode(display=False) as fc:
        with OpAnalysis() as oa:
            step(state, specs)
    assert oa.flops == fc.get_total_flops() == dryrun.derived_flops(
        cfg, "train", b, s)
    census = op_census(oa)
    assert census["mm"] > 0 and sum(census.values()) > 100
    assert count_convert_pairs(oa) >= 0

    from repro.optim import AdamWConfig
    from repro.train import TrainConfig as JTC, init_train_state, \
        make_train_step as jmake
    jcfg = jax_configs.get_config("qwen2.5-1.5b", smoke=True)
    prev = os.environ.get("REPRO_SCAN_UNROLL")
    os.environ["REPRO_SCAN_UNROLL"] = "1"
    try:
        jstep = jmake(jcfg, JTC(optimizer=AdamWConfig(), remat=True,
                                microbatches=1))
        jstate = jax.eval_shape(lambda key: init_train_state(
            jax_build_model(jcfg), key), jax.random.PRNGKey(0))
        jbatch = jax_dryrun.input_specs(jcfg, "train_4k")
        jbatch = {k: jax.ShapeDtypeStruct((b, s), v.dtype)
                  for k, v in jbatch.items()}
        cost = jax_dryrun._cost_dict(
            jax.jit(jstep).lower(jstate, jbatch).compile())
    finally:
        if prev is None:
            os.environ.pop("REPRO_SCAN_UNROLL")
        else:
            os.environ["REPRO_SCAN_UNROLL"] = prev
    print(f"qwen2.5-1.5b SMOKE train (B {b}, S {s}): counted "
          f"{oa.flops:.4e} FLOPs, reference cost_analysis "
          f"{float(cost['flops']):.4e}, ratio "
          f"{oa.flops / float(cost['flops']):.4f}")
    assert float(cost["flops"]) > 0


# ----------------------------------------------------------------------
# the meta arms
# ----------------------------------------------------------------------

class _Elsewhere:
    """A tensor-like on a device the wrappers do not take."""

    def __init__(self, shape):
        self.shape = torch.Size(shape)
        self.device = torch.device("xpu")


def test_meta_arms_only_on_meta():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 96, 32, generator=g)
    k = torch.randn(1, 2, 96, 32, generator=g)
    v = torch.randn(1, 2, 96, 32, generator=g)
    before = (flash_ops.COUNTER_MMA.n, flash_ops.COUNTER_CC.n,
              ssd_ops.COUNTER.n, decode_ops.COUNTER_LENGTHAWARE.n)
    # K2: the CPU takes the plain version, bitwise
    assert torch.equal(flash_ops.flash_attention(q, k, v, window=40),
                       attention_ref(q, k, v, window=40))
    out = flash_ops.flash_attention(q.to(META), k.to(META), v.to(META))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="unsupported device"):
        flash_ops.flash_attention(_Elsewhere(q.shape), k, v)
    # K3: likewise
    lens = torch.tensor([96], dtype=torch.int32)
    q1 = q[:, :, 0].contiguous()
    assert torch.equal(decode_ops.decode_attention(q1, k, v, lens),
                       decode_attention_ref(q1, k, v, lens,
                                            scale=32 ** -0.5))
    out = decode_ops.decode_attention(q1.to(META), k.to(META), v.to(META),
                                      lens.to(META))
    assert out.device.type == "meta" and out.shape == q1.shape
    with pytest.raises(ValueError, match="unsupported device"):
        decode_ops.decode_attention(_Elsewhere(q1.shape), k, v, lens)
    # K10: likewise
    x = torch.randn(1, 64, 2, 8, generator=g)
    dt = torch.rand(1, 64, 2, generator=g)
    a = -torch.rand(2, generator=g)
    bb = torch.randn(1, 64, 4, generator=g)
    cc = torch.randn(1, 64, 4, generator=g)
    for got, want in zip(ssd_ops.ssd_chunk(x, dt, a, bb, cc, chunk=16),
                         ssd_chunk_ref(x, dt, a, bb, cc, 16)):
        assert torch.equal(got, want)
    outs = ssd_ops.ssd_chunk(*(t.to(META) for t in (x, dt, a, bb, cc)),
                             chunk=16)
    assert all(t.device.type == "meta" for t in outs)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_ops.ssd_chunk(_Elsewhere(x.shape), dt, a, bb, cc, chunk=16)
    # the Functions run forward and backward on meta
    qm, km, vm = (t.to(META).requires_grad_() for t in (q, k, v))
    flash_ops.flash_attention_fn(qm, km, vm).sum().backward()
    assert qm.grad.device.type == "meta" and km.grad.shape == k.shape
    ins = [t.to(META).requires_grad_() for t in (x, dt, a, bb, cc)]
    sum(o.sum() for o in ssd_ops.ssd_chunk_fn(*ins, chunk=16)).backward()
    assert all(t.grad is not None for t in ins)
    # no kernel was launched, no counter moved
    assert before == (flash_ops.COUNTER_MMA.n, flash_ops.COUNTER_CC.n,
                      ssd_ops.COUNTER.n, decode_ops.COUNTER_LENGTHAWARE.n)


def _counts(fn, args):
    with OpAnalysis() as oa:
        oa.hold(args)
        fn(*args)
    return oa.flops, oa.bytes, op_census(oa), oa.peak_bytes


@pytest.mark.parametrize("what", ["blockwise", "backward"])
def test_repeated_shortcut_counts_the_full_loop(what, monkeypatch):
    """On meta one block (one chunk) stands for all: FLOPs, bytes, the
    census and the peak equal the CPU's full loop under the analysis."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 128, 16, generator=g)
    k = torch.randn(2, 2, 128, 16, generator=g)
    v = torch.randn(2, 2, 128, 16, generator=g)
    # the backward's chunk: one (batch, KV head) row, four chunks
    monkeypatch.setattr(flash_ops, "BWD_CHUNK_BYTES", 2 * 128 * 128 * 4)

    def run(a, b, c, d_out):
        if what == "blockwise":
            return blockwise_attention(a, b, c, window=50, block=32)
        return flash_ops.attention_backward(a, b, c, d_out)

    args = (q, k, v, torch.ones_like(q))
    cpu = _counts(run, args)
    meta = _counts(run, [t.to(META) for t in args])
    assert cpu[:3] == meta[:3]
    assert cpu[3] == meta[3]
    assert cpu[0] > 0


# ----------------------------------------------------------------------
# run_cell and the memory control
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_run_cell_record(arch):
    rec = dryrun.run_cell(arch, "long_500k", verbose=False)
    cfg, sh = configs.get_config(arch), configs.SHAPES["long_500k"]
    assert rec["mesh"] == "1x1" and rec["chips"] == 1
    assert rec["collective_bytes"] == 0 and rec["cost_method"] == "counted"
    assert rec["model_flops"] == jax_dryrun._model_flops(
        jax_configs.get_config(arch), "long_500k")
    assert rec["hlo_flops"] == dryrun.derived_flops(
        cfg, "decode", sh["global_batch"], sh["seq_len"])
    assert rec["hlo_flops"] >= rec["model_flops"]
    assert rec["bytes_per_device"] >= rec["argument_size_in_bytes"] > 0
    assert rec["fits_device"] == (rec["bytes_per_device"]
                                  < rec["device_bytes"])
    r = roofline.analyze(f"{arch}/long_500k/1x1", rec["chips"],
                         rec["hlo_flops"], rec["hlo_bytes"],
                         rec["collective_bytes"], rec["model_flops"])
    assert r.dominant in ("compute", "memory")


def test_production_meshes_refused():
    with pytest.raises(ValueError, match="needs 512 devices"):
        dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=True)
    for flag in ("--multi-pod", "--both-meshes"):
        with pytest.raises(SystemExit) as exc:
            dryrun.main([flag, "--arch", "olmo-1b"])
        assert exc.value.code != 0


def test_moment_control_drops_the_moments_bytes():
    """The control of the card's memory check: the moments left out of
    the held arguments lower the argument bytes by exactly their size
    (two float32 copies of the masters) and the peak with them."""
    cfg = configs.get_config("olmo-1b", smoke=True)
    full = dryrun.analyze_step(cfg, "train", 2, 32)
    ctrl = dryrun.analyze_step(cfg, "train", 2, 32, moment_dtype="none")
    n = sum(p.numel() for p in dryrun.train_state(cfg).params.parameters())
    assert full["argument_bytes"] - ctrl["argument_bytes"] == 2 * 4 * n + 4
    assert full["peak_bytes"] - ctrl["peak_bytes"] == 2 * 4 * n + 4
    assert full["flops"] == ctrl["flops"]
