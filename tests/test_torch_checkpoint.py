"""The port's checkpointer against the reference's, at SMOKE width.

* the layout is the reference's: the same ``tree.json`` (names in its
  flatten order, stacked shapes, dtype names) and the same bytes in
  ``shard_0.npz`` for the same state, bf16 leaves as ``|V2`` as the
  reference writes them;
* a round trip through the port for each moment dtype (f32, bf16,
  int8) restores every leaf bitwise;
* atomicity (an uncommitted directory is skipped), the async writer and
  pruning;
* a reference-written directory restores in the port and a port-written
  one in the reference (f32 moments), bitwise: qwen2.5-1.5b's tree, and
  the moe (moonshot, arctic), ssm (mamba2), hybrid (hymba) and
  encoder-decoder (whisper-base) trees;
* on a bf16 or int8 directory the reference's own ``restore`` raises
  ``ValueError: No cast function available`` (ml_dtypes' bfloat16
  does not survive ``np.savez``), while the port restores it bitwise
  from the dtype ``tree.json`` names.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jax_restore  # noqa: E402
from repro.checkpoint import save as jax_save  # noqa: E402
from repro.checkpoint.checkpointer import _flatten_with_names  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.train import TrainState as JaxTrainState  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    latest_step, restore, restore_latest,
                                    save)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.checkpoint import (empty_train_state,  # noqa: E402
                                    train_state_to_numpy)
from repro_torch.convert import train_state_from_jax  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
MOMENTS = ("f32", "bf16", "int8")


def _cfgs(arch="qwen2.5-1.5b"):
    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


@pytest.fixture(scope="module")
def ref_states():
    """The reference's SMOKE state after one AdamW update with seeded
    gradients, per moment dtype (so the moments are not all zero)."""
    jcfg, _ = _cfgs()
    out = {}
    for md in MOMENTS:
        state = jax_init_train_state(jax_build_model(jcfg),
                                     jax.random.PRNGKey(0), md)
        rng = np.random.default_rng(0)
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32)), state.params)
        cfg = JaxAdamWConfig(lr=1e-2, warmup_steps=1, moment_dtype=md)
        params, opt, _ = jax.jit(lambda p, g, o: jax_adamw_update(
            cfg, p, g, o))(state.params, grads, state.opt)
        out[md] = jax.device_get(JaxTrainState(params=params, opt=opt))
    return out


def _ref_named(tree):
    out = {}
    for name, x in _flatten_with_names(tree):
        x = np.asarray(x)
        out[name] = x.view(np.uint16) if str(x.dtype) == "bfloat16" else x
    return out


def _assert_state_equals(state, want):
    got = train_state_to_numpy(state)
    assert [n for n, _, _ in got] == list(want)
    for name, arr, _ in got:
        assert arr.shape == want[name].shape, name
        assert np.array_equal(arr, want[name]), name


@pytest.mark.parametrize("md", MOMENTS)
def test_layout_is_the_references(tmp_path, ref_states, md):
    _, cfg = _cfgs()
    state = train_state_from_jax(ref_states[md], cfg, CPU)
    jax_save(str(tmp_path / "ref"), 1, ref_states[md])
    save(str(tmp_path / "port"), 1, state)
    paths = [tmp_path / d / "step_00000001" for d in ("ref", "port")]
    assert [sorted(os.listdir(p)) for p in paths] == [
        ["_COMPLETE", "shard_0.npz", "tree.json"]] * 2
    metas = [json.loads((p / "tree.json").read_text()) for p in paths]
    assert metas[0] == metas[1]
    kinds = {m["dtype"] for m in metas[0]["leaves"]}
    assert kinds == {"f32": {"float32", "int32"},
                     "bf16": {"float32", "int32", "bfloat16"},
                     "int8": {"float32", "int32", "bfloat16", "int8"}}[md]
    with np.load(paths[0] / "shard_0.npz") as a, \
            np.load(paths[1] / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].shape == b[key].shape, key
            assert a[key].tobytes() == b[key].tobytes(), key
        if md != "f32":
            assert any(a[k].dtype == np.dtype("V2") for k in a.files)


@pytest.mark.parametrize("md", MOMENTS)
def test_round_trip_in_the_port(tmp_path, ref_states, md):
    _, cfg = _cfgs()
    state = train_state_from_jax(ref_states[md], cfg, CPU)
    save(str(tmp_path), 7, state)
    got = restore(str(tmp_path), 7, empty_train_state(cfg, CPU, md))
    _assert_state_equals(got, _ref_named(ref_states[md]))
    assert all(p.requires_grad for p in got.params.parameters())


@pytest.mark.parametrize("ahead", [False, True])
def test_reader_matches_np_load(tmp_path, ref_states, ahead):
    """The restore's reader (each ``.npz`` member read at its offset;
    with ``ahead``, inside ``with``, the next leaves read on worker
    threads) gives every leaf of a reference-written bf16-moment step
    as ``np.load`` does, bytes, dtype and shape; a compressed member
    reads too; a flipped byte in a member's data raises on its
    CRC-32."""
    import contextlib
    import zipfile
    from repro_torch.checkpoint import checkpointer

    def _read(directory, step):
        shard = checkpointer._read(directory, step)
        return shard if ahead else contextlib.nullcontext(shard)
    jax_save(str(tmp_path), 2, ref_states["bf16"])
    npz = tmp_path / "step_00000002" / "shard_0.npz"
    meta = json.loads((npz.parent / "tree.json").read_text())
    with np.load(npz) as data:
        want = {m["name"]: data[f"a{i}"]
                for i, m in enumerate(meta["leaves"])}
    with _read(str(tmp_path), 2) as leaves:
        assert list(leaves) == list(want)
        for name, arr in want.items():
            got, dt = leaves[name]
            assert dt == meta["leaves"][list(want).index(name)]["dtype"]
            assert (got.dtype, got.shape) == (arr.dtype, arr.shape), name
            assert got.tobytes() == arr.tobytes(), name
    # the same arrays compressed
    with np.load(npz) as data:
        np.savez_compressed(npz, **{k: data[k] for k in data.files})
    with _read(str(tmp_path), 2) as leaves:
        for name, arr in want.items():
            assert leaves[name][0].tobytes() == arr.tobytes(), name
    # stored again, then one byte of the largest member's data flipped
    np.savez(npz, **{f"a{i}": a for i, a in enumerate(want.values())})
    with zipfile.ZipFile(npz) as z:
        info = max(z.infolist(), key=lambda i: i.file_size)
    name = list(want)[int(info.filename[1:-4])]
    with open(npz, "r+b") as f:
        f.seek(info.header_offset + 30 + len(info.filename)
               + info.file_size - 1)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 1]))
    with _read(str(tmp_path), 2) as leaves:
        with pytest.raises(ValueError, match="CRC-32"):
            leaves[name]


def test_atomicity_async_and_prune(tmp_path, ref_states):
    _, cfg = _cfgs()
    d = str(tmp_path)
    state = train_state_from_jax(ref_states["f32"], cfg, CPU)
    save(d, 1, state)
    os.makedirs(os.path.join(d, "step_00000009"))          # torn write
    os.makedirs(os.path.join(d, "step_00000010.tmp"))      # mid-write
    assert latest_step(d) == 1
    ck = AsyncCheckpointer(d, keep=2)
    for s in (2, 3, 4):
        with torch.no_grad():
            state.params.final_norm.scale.fill_(float(s))
        ck.save(s, state)       # copies to the host before returning
    ck.close()
    committed = sorted(n for n in os.listdir(d)
                       if os.path.exists(os.path.join(d, n, "_COMPLETE")))
    assert committed == ["step_00000003", "step_00000004"]
    step, got = restore_latest(d, empty_train_state(cfg, CPU))
    assert step == 4
    assert torch.equal(got.params.final_norm.scale,
                       torch.full((cfg.d_model,), 4.0))
    got3 = restore(d, 3, empty_train_state(cfg, CPU))
    assert torch.equal(got3.params.final_norm.scale,
                       torch.full((cfg.d_model,), 3.0))
    assert restore_latest(str(tmp_path / "none"),
                          empty_train_state(cfg, CPU)) == (None, None)
    with pytest.raises(ValueError, match="checkpoint leaves differ"):
        restore(d, 4, empty_train_state(cfg, CPU, "int8"))


def test_reference_save_port_restore_f32(tmp_path, ref_states):
    _, cfg = _cfgs()
    jax_save(str(tmp_path), 5, ref_states["f32"])
    step, got = restore_latest(str(tmp_path), empty_train_state(cfg, CPU))
    assert step == 5
    _assert_state_equals(got, _ref_named(ref_states["f32"]))


def test_port_save_reference_restore_f32(tmp_path, ref_states):
    jcfg, cfg = _cfgs()
    state = train_state_from_jax(ref_states["f32"], cfg, CPU)
    with torch.no_grad():     # a state of the port's own
        for p in state.params.parameters():
            p.mul_(1.5)
    save(str(tmp_path), 2, state)
    template = jax_init_train_state(jax_build_model(jcfg),
                                    jax.random.PRNGKey(1))
    got = _ref_named(jax.device_get(jax_restore(str(tmp_path), 2,
                                                template)))
    want = train_state_to_numpy(state)
    assert list(got) == [n for n, _, _ in want]
    for name, arr, _ in want:
        assert np.array_equal(got[name], arr), name


@pytest.mark.parametrize("md", ["bf16", "int8"])
def test_reference_cannot_restore_low_precision_moments_port_can(
        tmp_path, ref_states, md):
    """Pins the reference's fault: its bf16 leaves come back from
    ``np.savez`` as ``|V2``, which its ``restore`` cannot cast."""
    jcfg, cfg = _cfgs()
    jax_save(str(tmp_path), 3, ref_states[md])
    template = jax_init_train_state(jax_build_model(jcfg),
                                    jax.random.PRNGKey(0), md)
    with pytest.raises(ValueError, match="No cast function available"):
        jax_restore(str(tmp_path), 3, template)
    got = restore(str(tmp_path), 3, empty_train_state(cfg, CPU, md))
    _assert_state_equals(got, _ref_named(ref_states[md]))


#: the other families' trees: moe (shared experts; a dense residual
#: FFN), ssm, hybrid and encoder-decoder
FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b", "mamba2-780m",
                "hymba-1.5b", "whisper-base")


@pytest.fixture(scope="module")
def family_states():
    """Each family's reference SMOKE state (f32 moments) after one AdamW
    update with seeded gradients."""
    out = {}
    for arch in FAMILY_ARCHS:
        jcfg, _ = _cfgs(arch)
        state = jax_init_train_state(jax_build_model(jcfg),
                                     jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32)), state.params)
        cfg = JaxAdamWConfig(lr=1e-2, warmup_steps=1)
        params, opt, _ = jax_adamw_update(cfg, state.params, grads,
                                          state.opt)
        out[arch] = jax.device_get(JaxTrainState(params=params, opt=opt))
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_reference_save_port_restore_f32(tmp_path, family_states,
                                                arch):
    _, cfg = _cfgs(arch)
    jax_save(str(tmp_path), 5, family_states[arch])
    step, got = restore_latest(str(tmp_path), empty_train_state(cfg, CPU))
    assert step == 5
    _assert_state_equals(got, _ref_named(family_states[arch]))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_port_save_reference_restore_f32(tmp_path, family_states,
                                                arch):
    jcfg, cfg = _cfgs(arch)
    state = train_state_from_jax(family_states[arch], cfg, CPU)
    with torch.no_grad():     # a state of the port's own
        for p in state.params.parameters():
            p.mul_(1.5)
    save(str(tmp_path), 2, state)
    template = jax_init_train_state(jax_build_model(jcfg),
                                    jax.random.PRNGKey(1))
    got = _ref_named(jax.device_get(jax_restore(str(tmp_path), 2,
                                                template)))
    want = train_state_to_numpy(state)
    assert list(got) == [n for n, _, _ in want]
    for name, arr, _ in want:
        assert np.array_equal(got[name], arr), name
