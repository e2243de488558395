"""The encoder-decoder family and int8 on a mesh of several ranks, on the
CPU: gloo, SMOKE configs in float32, one process a rank, one
microbatch.

* ``WHISPER_CASES``: whisper-base on (4, 2) and (2, 4) (SMOKE's 4 heads:
  2 and 1 a rank; the rows of ``frames``, ``tokens`` and ``labels`` over
  ``data``): the placement, the loss and every gradient leaf within 1e-5
  of the single-device port's and of the reference's jitted
  ``value_and_grad(whisper_loss)``, three steps within 1e-4 (losses) and
  1e-2 (each parameter's change) of the single-device port's; four
  serve-mode decode steps, each rank's cache its lanes and KV heads with
  the cross K/V made from its own columns, whose logits are within 1e-5
  of both and whose gathered ``k``/``v``/``cross_k``/``cross_v`` are
  within 1e-5 of both caches; the (4, 2) state after three steps,
  checkpointed on the mesh, restores onto the unsharded model bit for
  bit;
* olmo-1b with int8 moments on (4, 2): three steps within the same gates
  of the single-device port's int8 run and the int8-moment invariant
  after each (every rank holding part of a row has the same ``scale``,
  bitwise; a nonzero row's gathered max |q| is 127, a zero row's 0 with
  scale 1); the state checkpointed on the mesh restores onto it bit for
  bit, and four new ranks resume it on ``elastic_remesh_plan(4, 2) ==
  (2, 2)`` with every leaf, each ``q`` and ``scale`` among them, bitwise
  the saved one; a control, ``optim/adamw.py`` copied under the test's
  temporary directory with each block's own row maxima (the per-block
  scale), fails the invariant;
* qwen2.5-1.5b with an int8 KV cache on the (4, 2) serve mesh: four
  decode steps (K5 at the local heads, one KV head a rank) against the
  single-device port's and the reference's, at the gates of
  ``INT8_KV_GATES``.

One group of eight ranks runs all but the resume (180 s).
"""

import dataclasses
import importlib.util
import json
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded import (BATCH, CPU, FAMILY_DECODE_TOKENS,  # noqa: E402
                                FAMILY_TRAIN, LOGIT_TOL, OPT, SRC,
                                STEP_LOSS_TOL, STEP_REL_TOL, _batch, _cfg,
                                _check_decode, _check_train, _max_err,
                                _rank_main, _reference, _rel, _restored,
                                _smoke_of, _spawn, _train_step)

pytestmark = pytest.mark.torch_port

#: case -> mesh (whisper-base SMOKE)
WHISPER_CASES = {"whisper-4x2": (4, 2), "whisper-2x4": (2, 4)}
#: the stub frontend's frames a row (S_enc != S_dec: cross-attention's K2
#: runs at Sq 32 against Sk 48)
S_ENC = 48
#: the decode cache's depth (four steps of four lanes)
MAX_LEN = 16
INT8_OPT = dict(OPT, moment_dtype="int8")
#: the int8 KV decode's gates against the single-device port and the
#: reference.  A rank's K and V projections sum its columns in another
#: order, which moves a per-token scale by a few ulps (``scale_rel``) and
#: may flip a code by one (``code``); a lane holding a flipped code reads
#: a K or V element one step off from then on.  So a lane with no
#: flipped code has its logits within ``logits`` (absolute, as the other
#: decode tests); every lane's greedy token is the single-device one's
#: (``tests/test_torch_engine_int8.py`` holds the token streams exactly),
#: and its logits' distance from the unquantized float32 step's is at
#: most ``dense_ratio`` times the unsharded int8 step's
INT8_KV_GATES = dict(logits=LOGIT_TOL, code=1, scale_rel=1e-6,
                     dense_ratio=2.0)


def _whisper_cfg():
    return _cfg("whisper-base")


def _frames(seed, b):
    """The stub frontend's frames (b, S_ENC, d) of ``seed``."""
    d = _whisper_cfg().d_model
    return np.random.default_rng(seed).standard_normal(
        (b, S_ENC, d)).astype(np.float32)


def _whisper_batch(step):
    """The pipeline's batch ``step`` and seeded frames."""
    batch = _batch(step, _whisper_cfg())
    batch["frames"] = _frames(100 + step, BATCH)
    return batch


def _int8_cfg():
    return dataclasses.replace(_cfg("qwen2.5-1.5b"), kv_quant="int8")


# ----------------------------------------------------------------------
# the ranks (this file run as a script)
# ----------------------------------------------------------------------

def _specs_of(mesh, module):
    from repro_torch.parallel import sharding
    return {n: [list(mesh.axes(e)) for e in sharding.spec_of(p)]
            for n, p in module.named_parameters()}


def _rank_whisper(rank, world, out, ckdir):
    """Every case of ``WHISPER_CASES``: the gradients, three steps and
    four serve-mode decode steps, each writing under its own directory;
    the (4, 2) state after the steps checkpointed on the mesh."""
    from repro_torch.checkpoint import (empty_train_state, restore, save,
                                        train_state_to_numpy)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.attention import local_heads
    from repro_torch.models.whisper import (encode, init_whisper_cache,
                                            whisper_decode_step)
    from repro_torch.parallel import comm, sharding, use_mesh
    from repro_torch.train.train_loop import batch_to_device
    cfg = _whisper_cfg()
    frames = torch.from_numpy(_frames(7, 4))
    for case, shape in WHISPER_CASES.items():
        t0 = time.perf_counter()
        res = out / case
        res.mkdir(exist_ok=True)
        mesh = make_test_mesh(shape)
        step = _train_step(cfg, FAMILY_TRAIN)
        with use_mesh(mesh):
            state = _restored(ckdir, cfg, mesh)
            specs = {n: sharding.spec_of(p)
                     for n, p in state.params.named_parameters()}
            loss, grads = step.grads_of(
                state.params, batch_to_device(_whisper_batch(0), CPU))
            grads = {n: comm.gather_full(g, mesh, specs[n]).numpy()
                     for n, g in grads.items()}
            losses = []
            for i in range(3):
                state, m = step(state, _whisper_batch(i))
                losses.append(float(m["loss"]))
            leaves = train_state_to_numpy(state)
            if case == "whisper-4x2":
                save(str(res / "ck"), 3, state)
            train_specs = _specs_of(mesh, state.params)
        params = restore(ckdir, 0, empty_train_state(cfg, CPU)).params
        sharding.place_params(mesh, params, cfg, "serve")
        logits = []
        with use_mesh(mesh, mode="serve"):
            heads = local_heads(cfg)
            enc = encode(params, frames, cfg)
            cache = init_whisper_cache(params, enc, cfg, 4, MAX_LEN)
            shapes = {k: list(v.shape) for k, v in cache.items()}
            for toks in FAMILY_DECODE_TOKENS:
                lg, cache = whisper_decode_step(
                    params, cfg, cache, torch.tensor(toks, dtype=torch.int32))
                logits.append(lg.numpy())
            whole = sharding.gather_cache(mesh, cache, cfg)
        if rank == 0:
            np.savez(res / "grads.npz", **grads)
            np.savez(res / "state.npz", **{n: a for n, a, _ in leaves})
            np.save(res / "logits.npy", np.stack(logits))
            np.savez(res / "cache.npz",
                     **{k: v.numpy() for k, v in whole.items()})
            (res / "result.json").write_text(json.dumps(
                {"loss": float(loss), "losses": losses,
                 "heads": [heads[0], heads[1], list(heads[2])],
                 "cache_shapes": shapes, "specs": train_specs,
                 "serve_specs": _specs_of(mesh, params),
                 "seconds": time.perf_counter() - t0}))


def _broken_adamw(path):
    """The copy of ``optim/adamw.py`` at ``path`` (the per-block scale)
    as a module of its own."""
    spec = importlib.util.spec_from_file_location("broken_adamw", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def _rank_int8_moments(rank, world, out, ckdir, broken):
    """olmo-1b with int8 moments on (4, 2): three steps, the invariant
    after each, a checkpoint restored on the mesh, and the control."""
    from repro_torch.checkpoint import (empty_train_state, restore, save,
                                        train_state_to_numpy)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import q8_invariant
    from repro_torch.parallel import use_mesh
    from repro_torch.train.train_loop import batch_to_device
    cfg = _cfg("olmo-1b")
    mesh = make_test_mesh((4, 2))
    step = _train_step_int8(cfg)
    with use_mesh(mesh):
        state = restore(ckdir, 0, empty_train_state(cfg, CPU, "int8", mesh))
        losses, invariant = [], []
        for i in range(3):
            state, m = step(state, _batch(i, cfg))
            losses.append(float(m["loss"]))
            invariant.append(q8_invariant(state, mesh))
        leaves = train_state_to_numpy(state)
        save(str(out / "ck"), 3, state)
        again = restore(str(out / "ck"), 3,
                        empty_train_state(cfg, CPU, "int8", mesh))
        again = {n: a for n, a, _ in train_state_to_numpy(again)}
        restored = all(again[n].tobytes() == a.tobytes()
                       for n, a, _ in leaves)
        # the control: the first step's update with the per-block scale
        control = restore(ckdir, 0, empty_train_state(cfg, CPU, "int8",
                                                      mesh))
        _, grads = step.grads_of(control.params,
                                 batch_to_device(_batch(0, cfg), CPU))
        params, opt, _ = _broken_adamw(broken).adamw_update(
            AdamWConfig(**INT8_OPT), control.params, grads, control.opt)
        control = q8_invariant(types.SimpleNamespace(params=params, opt=opt),
                               mesh)
    if rank == 0:
        np.savez(out / "state.npz", **{n: a for n, a, _ in leaves})
        (out / "result.json").write_text(json.dumps(
            {"losses": losses, "invariant": invariant,
             "restored": restored, "control": control}))


def _train_step_int8(cfg):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    return make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(**INT8_OPT), **FAMILY_TRAIN))


def _rank_int8_kv(rank, world, out, params_path):
    """qwen2.5-1.5b with an int8 KV cache: four decode steps on the (4,
    2) serve mesh, the cache gathered."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.attention import local_heads
    from repro_torch.models.registry import param_module
    from repro_torch.models.transformer import init_cache, lm_decode_step
    from repro_torch.parallel import sharding, use_mesh
    cfg = _int8_cfg()
    mesh = make_test_mesh((4, 2))
    params = param_module(cfg, CPU)
    params.load_state_dict(torch.load(params_path))
    sharding.place_params(mesh, params, cfg, "serve")
    logits = []
    with use_mesh(mesh, mode="serve"):
        heads = local_heads(cfg)
        cache = init_cache(cfg, 4, 64, device=CPU)
        shapes = {k: list(v.shape) for k, v in cache.items()}
        for toks in FAMILY_DECODE_TOKENS:
            lg, cache = lm_decode_step(params, cfg, cache, torch.tensor(
                toks, dtype=torch.int32))
            logits.append(lg.numpy())
        whole = sharding.gather_cache(mesh, cache, cfg)
    if rank == 0:
        np.save(out / "logits.npy", np.stack(logits))
        np.savez(out / "cache.npz", **{k: v.numpy() for k, v in whole.items()})
        (out / "result.json").write_text(json.dumps(
            {"cache_shapes": shapes,
             "heads": [heads[0], heads[1], list(heads[2])]}))


def _rank_encdec(rank, world, out, ckdirs, params_path, broken):
    """Every part in one group of eight ranks, each writing under its own
    directory."""
    seconds = {}
    for name, part, kw in (
            ("whisper", _rank_whisper, {"ckdir": ckdirs["whisper"]}),
            ("int8_moments", _rank_int8_moments,
             {"ckdir": ckdirs["olmo-int8"], "broken": broken}),
            ("int8_kv", _rank_int8_kv, {"params_path": params_path})):
        (out / name).mkdir(exist_ok=True)
        t0 = time.perf_counter()
        part(rank, world, out / name, **kw)
        seconds[name] = time.perf_counter() - t0
    if rank == 0:           # each part's share of the group's time limit
        (out / "seconds.json").write_text(json.dumps(seconds))


def _rank_resume_int8(rank, world, out, ckdir):
    """Four ranks resume the int8 state on the re-mesh plan."""
    from repro_torch.checkpoint import train_state_to_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import use_mesh
    from repro_torch.train.fault_tolerance import (elastic_remesh_plan,
                                                   elastic_resume)
    plan = elastic_remesh_plan(n_alive_chips=world, model_parallel=2)
    mesh = make_test_mesh(plan)
    got, state = elastic_resume(ckdir, _cfg("olmo-1b"), mesh, CPU, "int8")
    with use_mesh(mesh):
        restored = train_state_to_numpy(state)
    if rank == 0:
        np.savez(out / "restored.npz", **{n: a for n, a, _ in restored})
        (out / "result.json").write_text(json.dumps(
            {"plan": list(plan), "step": got}))


RANK_CASES = {"encdec": _rank_encdec, "resume": _rank_resume_int8}


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------

#: the line of ``optim/adamw.py`` the control changes: the leaves whose
#: rows are split are stored at once, each block with its own maxima
SPLIT_TEST = "row_axes = sharding.axes_of(p, -1)"
PER_BLOCK = "row_axes = ()"


@pytest.fixture(scope="module")
def world_encdec(tmp_path_factory):
    """The reference's initial states (whisper-base's, olmo-1b's with
    int8 moments; port checkpoints of them), the reference's qwen2.5-1.5b
    parameters, the control's copy of ``adamw.py``, the single-device
    runs they are held to (filled at first use) and the eight-rank
    group's output."""
    jax, jax_get_config, jax_build_model = _reference()
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.checkpoint import save
    from repro_torch.convert import params_from_jax, train_state_from_jax
    tmp = tmp_path_factory.mktemp("mesh_encdec")
    w = types.SimpleNamespace(ref={}, tmp=tmp)
    smoke = _smoke_of(jax_get_config)
    w.jcfg = dataclasses.replace(smoke("whisper-base"), dtype="float32")
    w.js = jax.device_get(jax_init_train_state(jax_build_model(w.jcfg),
                                               jax.random.PRNGKey(0)))
    w.ocfg = dataclasses.replace(smoke("olmo-1b"), dtype="float32")
    w.js8 = jax.device_get(jax_init_train_state(
        jax_build_model(w.ocfg), jax.random.PRNGKey(0), "int8"))
    ckdirs = {"whisper": str(tmp / "initial_whisper"),
              "olmo-int8": str(tmp / "initial_olmo_int8")}
    save(ckdirs["whisper"], 0, train_state_from_jax(w.js, _whisper_cfg(),
                                                    CPU))
    save(ckdirs["olmo-int8"], 0, train_state_from_jax(w.js8, _cfg("olmo-1b"),
                                                      CPU))
    w.ckdirs = ckdirs
    w.qcfg = dataclasses.replace(smoke("qwen2.5-1.5b"), dtype="float32",
                                 kv_quant="int8")
    w.jparams = jax_build_model(w.qcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(w.jparams), _int8_cfg(), CPU)
    torch.save(params.state_dict(), tmp / "qwen.pt")
    source = (SRC / "repro_torch" / "optim" / "adamw.py").read_text()
    assert source.count(SPLIT_TEST) == 1
    broken = tmp / "adamw_per_block.py"
    broken.write_text(source.replace(SPLIT_TEST, PER_BLOCK))
    w.out = _spawn(tmp, "encdec", 8, script=__file__, ckdirs=ckdirs,
                   params_path=str(tmp / "qwen.pt"), broken=str(broken))
    return w


def _whisper_ref(w):
    """The port's single-device runs of whisper (gradients and loss of
    batch 0, three steps' losses and final state, four decode steps'
    logits and cache) and the reference's (jitted ``value_and_grad``,
    decode steps' logits and cache) from the reference's initial
    state."""
    if "whisper" in w.ref:
        return w.ref["whisper"]
    jax, _, jax_build_model = _reference()
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import _flatten_with_names
    from repro.models.whisper import encode as jax_encode
    from repro.models.whisper import (
        init_whisper_cache as jax_init_whisper_cache)
    from repro.models.whisper import (
        whisper_decode_step as jax_whisper_decode_step)
    from repro_torch.checkpoint import train_state_to_numpy
    from repro_torch.convert import train_state_from_jax
    from repro_torch.models.whisper import (encode, init_whisper_cache,
                                            whisper_decode_step)
    from repro_torch.train.train_loop import batch_to_device
    cfg, jcfg, js = _whisper_cfg(), w.jcfg, w.js
    state = train_state_from_jax(js, cfg, CPU)
    r = types.SimpleNamespace(logits=[], jlogits=[])
    r.start = {n: a for n, a, _ in train_state_to_numpy(state)}
    frames = _frames(7, 4)
    cache = init_whisper_cache(state.params, encode(
        state.params, torch.from_numpy(frames), cfg), cfg, 4, MAX_LEN)
    jcache = jax_init_whisper_cache(js.params, jax_encode(
        js.params, jnp.asarray(frames), jcfg), jcfg, 4, MAX_LEN)
    for toks in FAMILY_DECODE_TOKENS:
        lg, cache = whisper_decode_step(state.params, cfg, cache,
                                        torch.tensor(toks, dtype=torch.int32))
        jlg, jcache = jax_whisper_decode_step(js.params, jcfg, jcache,
                                              jnp.asarray(toks, jnp.int32))
        r.logits.append(lg.numpy())
        r.jlogits.append(np.asarray(jlg))
    r.cache = {k: v.numpy() for k, v in cache.items()}
    r.jcache = {k: np.asarray(v) for k, v in jax.device_get(jcache).items()}
    step = _train_step(cfg, FAMILY_TRAIN)
    batch0 = _whisper_batch(0)
    loss, grads = step.grads_of(state.params, batch_to_device(batch0, CPU))
    r.loss, r.grads = float(loss), {n: g.numpy() for n, g in grads.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss))(
        js.params, {k: jnp.asarray(v) for k, v in batch0.items()})
    r.jloss = float(jloss)
    r.jgrads = {n: np.asarray(x) for n, x in _flatten_with_names(
        jax.device_get(jgrads))}
    r.losses = []
    for i in range(3):
        state, m = step(state, _whisper_batch(i))
        r.losses.append(float(m["loss"]))
    r.final = {n: a for n, a, _ in train_state_to_numpy(state)}
    w.ref["whisper"] = r
    return r


@pytest.mark.parametrize("case", list(WHISPER_CASES))
def test_sharded_whisper_train_matches_single_device(world_encdec, case):
    """The placement (attention by heads, the GELU MLP's d_ff and the
    vocab over ``model``, FSDP over ``data``; serve mode's attention by
    heads alone), the loss and every gradient leaf (cross-attention's
    and the MLPs' biases among them) against the single-device port and
    the reference's jitted ``value_and_grad(whisper_loss)``, three steps
    against the single-device port."""
    ref = _whisper_ref(world_encdec)
    shape = WHISPER_CASES[case]
    out = world_encdec.out / "whisper" / case
    res = json.loads((out / "result.json").read_text())
    spec, serve = res["specs"], res["serve_specs"]
    data = ["data"] if shape[0] > 1 else []
    assert spec["decoder.0.cross_attn.wq"] == [data, ["model"]]
    assert spec["decoder.0.cross_attn.wo"] == [["model"], data]
    assert spec["encoder.0.mlp.w1"] == [data, ["model"]]
    assert spec["encoder.0.mlp.b1"] == [["model"]]
    assert spec["decoder.0.mlp.b2"] == [[]]
    assert spec["embed.tok"] == [["model"], data]
    assert serve["decoder.0.cross_attn.wk"] == [[], ["model"]]
    assert serve["decoder.0.mlp.w1"] == [[], data + ["model"]]
    cfg = _whisper_cfg()
    assert res["heads"] == [cfg.n_heads // shape[1],
                            cfg.n_kv_heads // shape[1], ["model"]]
    grads = np.load(out / "grads.npz")
    assert {"decoder.0.cross_attn.wk", "decoder.1.mlp.b1",
            "encoder.0.mlp.b2"} <= set(grads.files)
    _check_train(out, res, grads, ref)


@pytest.mark.parametrize("case", list(WHISPER_CASES))
def test_sharded_whisper_decode_step(world_encdec, case):
    """Four serve-mode decode steps: the logits within 1e-5 of the
    single-device port's and the reference's, the gathered ``k``, ``v``,
    ``cross_k`` and ``cross_v`` within 1e-5 of both caches, each rank's
    cache its lanes and KV heads."""
    ref = _whisper_ref(world_encdec)
    cfg = _whisper_cfg()
    shape = WHISPER_CASES[case]
    out = world_encdec.out / "whisper" / case
    res = json.loads((out / "result.json").read_text())
    _check_decode(out, cfg, ref)
    assert sorted(ref.jcache) == ["cross_k", "cross_v", "k", "len", "v"]
    for name, s in (("k", MAX_LEN), ("cross_k", S_ENC)):
        assert res["cache_shapes"][name] == [
            cfg.n_layers, 4 // shape[0], cfg.n_kv_heads // shape[1], s,
            cfg.hd]


def test_sharded_whisper_checkpoint_restores_unsharded(world_encdec):
    """The (4, 2) state after three steps, checkpointed on the mesh
    (gathered, rank 0 writing), restores onto the unsharded model equal,
    leaf by leaf and bit for bit, to the gathered state."""
    from repro_torch.checkpoint import (empty_train_state, restore,
                                        train_state_to_numpy)
    cfg = _whisper_cfg()
    out = world_encdec.out / "whisper" / "whisper-4x2"
    state = restore(str(out / "ck"), 3, empty_train_state(cfg, CPU))
    assert state.params.decoder[0].cross_attn.wq.shape == (
        cfg.d_model, cfg.n_heads * cfg.hd)
    got = {n: a for n, a, _ in train_state_to_numpy(state)}
    want = np.load(out / "state.npz")
    assert sorted(got) == sorted(want.files)
    assert any(n.endswith("/cross_attn/wk") for n in got)
    for name, arr in got.items():
        assert arr.shape == want[name].shape, name
        assert arr.tobytes() == want[name].tobytes(), name


def test_int8_moments_on_mesh_match_single_device(world_encdec):
    """Three steps with int8 moments on (4, 2) against the single-device
    port's int8 run: the losses within 1e-4 relative, each parameter's
    change within 1e-2 (relative L2); the gathered moments' shapes the
    unsharded ones'."""
    from repro_torch.checkpoint import train_state_to_numpy
    from repro_torch.convert import train_state_from_jax
    cfg = _cfg("olmo-1b")
    out = world_encdec.out / "int8_moments"
    res = json.loads((out / "result.json").read_text())
    state = train_state_from_jax(world_encdec.js8, cfg, CPU)
    start = {n: a for n, a, _ in train_state_to_numpy(state)}
    step = _train_step_int8(cfg)
    losses = []
    for i in range(3):
        state, m = step(state, _batch(i, cfg))
        losses.append(float(m["loss"]))
    one = {n: a for n, a, _ in train_state_to_numpy(state)}
    got = np.load(out / "state.npz")
    assert sorted(got.files) == sorted(one)
    assert any(n.endswith("/q") for n in one)
    assert np.max(np.abs(np.array(res["losses"]) - losses)
                  / np.abs(losses)) <= STEP_LOSS_TOL
    for name, final in one.items():
        assert got[name].shape == final.shape, name
        if name.startswith(".params/"):
            change = got[name] - start[name]
            assert _rel(change, final - start[name]) <= STEP_REL_TOL, name


@pytest.mark.parametrize("step", [1, 2, 3])
def test_int8_moment_invariant_on_mesh(world_encdec, step):
    """After each step on (4, 2), every rank holding part of a row holds
    the same scale, bitwise, and each row's gathered max |q| is 127 (0
    with scale 1 for a zero row); some leaves' rows are split."""
    res = json.loads((world_encdec.out / "int8_moments" /
                      "result.json").read_text())
    same, full, split = res["invariant"][step - 1]
    assert same and full and split > 0, res["invariant"]


def test_int8_moment_invariant_control_fails(world_encdec):
    """``adamw.py`` copied with each block's own row maxima (the per-block
    scale) breaks the invariant: the ranks of a split row hold different
    scales."""
    res = json.loads((world_encdec.out / "int8_moments" /
                      "result.json").read_text())
    same, _, split = res["control"]
    assert split > 0 and not same, res["control"]


def test_int8_moments_checkpoint_and_elastic_resume(world_encdec, tmp_path):
    """The int8 state after three steps on (4, 2), checkpointed on the
    mesh, restores onto it bit for bit; four new ranks resume it on the
    re-mesh plan (2, 2) with every leaf, each ``q`` and ``scale`` among
    them, bitwise the saved one."""
    from repro_torch.checkpoint.checkpointer import _read
    first = world_encdec.out / "int8_moments"
    assert json.loads((first / "result.json").read_text())["restored"]
    second = _spawn(tmp_path, "resume", 4, script=__file__,
                    ckdir=str(first / "ck"))
    res = json.loads((second / "result.json").read_text())
    assert res == {"plan": [2, 2], "step": 3}
    saved = _read(str(first / "ck"), 3)
    restored = np.load(second / "restored.npz")
    assert sorted(restored.files) == sorted(saved)
    assert any(n.endswith("/scale") and "/.mu/" in n for n in saved)
    for name, (arr, _) in saved.items():
        arr = np.asarray(arr)
        assert restored[name].shape == arr.shape, name
        assert restored[name].tobytes() == arr.tobytes(), name


def test_sharded_int8_kv_decode_step(world_encdec):
    """Four decode steps of qwen2.5-1.5b with an int8 KV cache on the (4,
    2) serve mesh (K5 at one KV head a rank): the logits against the
    single-device port's and the reference's, and the gathered ``k``,
    ``v``, ``k_scale``, ``v_scale`` against both caches, at
    ``INT8_KV_GATES``."""
    jax, _, _ = _reference()
    import jax.numpy as jnp
    from repro.models.transformer import init_cache as jax_init_cache
    from repro.models.transformer import lm_decode_step as jax_decode_step
    from repro_torch.convert import params_from_jax
    from repro_torch.models.transformer import init_cache, lm_decode_step
    cfg, jcfg = _int8_cfg(), world_encdec.qcfg
    jparams = world_encdec.jparams
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    out = world_encdec.out / "int8_kv"
    res = json.loads((out / "result.json").read_text())
    assert res["heads"] == [cfg.n_heads // 2, cfg.n_kv_heads // 2, ["model"]]
    assert res["cache_shapes"]["k_scale"] == [cfg.n_layers, 1,
                                              cfg.n_kv_heads // 2, 64, 1]
    got = np.load(out / "logits.npy")
    whole = np.load(out / "cache.npz")
    dense = dataclasses.replace(cfg, kv_quant=None)
    dparams = params_from_jax(jax.device_get(jparams), dense, CPU)
    cache, jcache = init_cache(cfg, 4, 64, device=CPU), \
        jax_init_cache(jcfg, 4, 64)
    dcache = init_cache(dense, 4, 64, device=CPU)
    ones, refs, dense_logits = [], [], []
    for toks in FAMILY_DECODE_TOKENS:
        toks = torch.tensor(toks, dtype=torch.int32)
        one, cache = lm_decode_step(params, cfg, cache, toks)
        ref, jcache = jax_decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(toks.numpy()))
        lg, dcache = lm_decode_step(dparams, dense, dcache, toks)
        ones.append(one.numpy())
        refs.append(np.asarray(ref))
        dense_logits.append(lg.numpy())
    jcache = {k: np.asarray(t) for k, t in jax.device_get(jcache).items()}
    assert sorted(whole.files) == sorted(jcache) == \
        ["k", "k_scale", "len", "v", "v_scale"]
    assert whole["len"].tolist() == [len(FAMILY_DECODE_TOKENS)] * 4
    v = cfg.vocab_size
    for want, want_logits in (({k: t.numpy() for k, t in cache.items()},
                               ones), (jcache, refs)):
        flipped = np.zeros(4, bool)
        for name in ("k", "v"):
            assert whole[name].dtype == np.int8, name
            diff = np.abs(whole[name].astype(np.int32)
                          - want[name].astype(np.int32))
            assert diff.max() <= INT8_KV_GATES["code"], name
            flipped |= diff.max(axis=(0, 2, 3, 4)) > 0
        for name in ("k_scale", "v_scale"):
            assert _max_err(whole[name] / want[name], 1.0) <= \
                INT8_KV_GATES["scale_rel"], name
        for i, (lg, want_lg, dlg) in enumerate(zip(got, want_logits,
                                                   dense_logits)):
            lg, want_lg, dlg = lg[:, :v], want_lg[:, :v], dlg[:, :v]
            err = np.max(np.abs(lg - want_lg), axis=1)
            assert np.all(err[~flipped] <= INT8_KV_GATES["logits"]), (i, err)
            assert np.array_equal(lg.argmax(1), want_lg.argmax(1)), i
            assert np.max(np.abs(lg - dlg)) <= INT8_KV_GATES[
                "dense_ratio"] * np.max(np.abs(want_lg - dlg)), i

if __name__ == "__main__":
    sys.path.insert(0, str(SRC))
    _rank_main(sys.argv[1:], RANK_CASES)
