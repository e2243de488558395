"""The port on a mesh of several ranks, on the CPU: gloo, SMOKE configs
in float32, one process a rank.

The reference proves its mesh on forced host devices, holding the
sharded step against the single-device one; the port is held the same
way, against both the single-device port and the reference's
single-device step (the reference's own sharded runs do not run under
the installed jax):

* (a) olmo-1b trains on a (4, 2) mesh (FSDP over ``data``, TP over
  ``model``, remat, two microbatches): ``grads_of``'s gradients within
  1e-5 of each leaf's max |g| of the single-device port's and of the
  reference's jitted ``value_and_grad``, the loss within 1e-5 relative;
  after three steps the losses within 1e-4 relative and each
  parameter's change within 1e-2 (relative L2) of both single-device
  runs'; an ssm and a moe config refused by name on the same mesh;
* (b) qwen2.5-1.5b decodes three steps on a (4, 2) serve mesh (the MLP
  over all eight ranks, attention over ``model``, the cache's lanes over
  ``data``): each step's logits within 1e-5 of the single-device port's
  and the reference's, the cache's ``len`` advanced, each rank's cache
  its lanes and KV heads, and every weight the step reads its stored
  block (no weight gathered);
* attention whole where the model axis does not divide the KV heads
  (olmo-1b on (1, 8)): gradients within 1e-5 of the single-device
  port's;
* (c) ``compressed_psum`` over ``pod`` of a (2, 4) mesh: the mean within
  the reference's 2% of the exact mean and within one float32 ulp of a
  numpy model of the reference's per-participant arithmetic, the
  residual bitwise;
* (d) elastic resume: three steps on (4, 2), a checkpoint, then four new
  ranks on ``elastic_remesh_plan(4, 2) == (2, 2)`` restore it (every
  leaf bitwise the saved one) and take three more steps on the repeated
  batch: the losses fall as in the reference's test, and all six are
  within 1e-4 relative of the single-device port's six;
* (e) the launcher under ``torch.distributed.run`` with two ranks,
  ``--mesh 1,2``, and ``--mesh 2,2`` on two ranks refused with both
  numbers;

Each group of ranks is spawned here (``python`` on this file, a file
store under the test's temporary directory), joins with a 180 s
timeout, and is killed if it overruns; a failing rank's log (its
traceback) is reported with every other rank's.  One group of eight
ranks runs (a), (b), (c) and (d)'s first phase (a module fixture), so
the file spawns three groups in all: that one, (d)'s four ranks and
(e)'s launcher.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CPU = torch.device("cpu")
#: seconds a group of ranks may take, start to exit
GROUP_TIMEOUT = 180
GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
STEP_LOSS_TOL = 1e-4
STEP_REL_TOL = 1e-2
LOGIT_TOL = 1e-5
#: the train tests' schedule (moves the weights within three steps)
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)
TRAIN = dict(remat=True, microbatches=2)
BATCH, SEQ = 8, 32
DECODE_TOKENS = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]


def _cfg(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _batch(step, cfg):
    from repro_torch.data import DataConfig, synth_batch
    return synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH), step)


def _train_step(cfg):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    return make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(**OPT),
                                            **TRAIN))


# ----------------------------------------------------------------------
# the ranks (this file run as a script)
# ----------------------------------------------------------------------

def _restored(ckdir, cfg, mesh):
    """The state of ``ckdir``'s step 0, placed on ``mesh``."""
    from repro_torch.checkpoint import empty_train_state, restore
    return restore(ckdir, 0, empty_train_state(cfg, CPU, mesh=mesh))


def _rank_train(rank, world, out, ckdir):
    """(a): gradients, three steps and the refusals on (4, 2)."""
    from repro_torch.checkpoint import train_state_to_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import comm, sharding, use_mesh
    from repro_torch.train import init_train_state
    from repro_torch.train.train_loop import batch_to_device
    cfg = _cfg("olmo-1b")
    mesh = make_test_mesh((4, 2))
    refusals = {}
    for arch in ("mamba2-780m", "moonshot-v1-16b-a3b"):
        try:
            init_train_state(build_model(_cfg(arch)), torch.Generator(),
                             CPU, mesh=mesh)
        except ValueError as e:
            refusals[arch] = str(e)
    step = _train_step(cfg)
    with use_mesh(mesh):
        state = _restored(ckdir, cfg, mesh)
        specs = {n: sharding.spec_of(p)
                 for n, p in state.params.named_parameters()}
        loss, grads = step.grads_of(state.params,
                                    batch_to_device(_batch(0, cfg), CPU))
        grads = {n: comm.gather_full(g, mesh, specs[n]).numpy()
                 for n, g in grads.items()}
        losses = []
        for i in range(3):
            state, m = step(state, _batch(i, cfg))
            losses.append(float(m["loss"]))
        leaves = train_state_to_numpy(state)
    if rank == 0:
        np.savez(out / "grads.npz", **grads)
        np.savez(out / "state.npz", **{n: a for n, a, _ in leaves})
        (out / "result.json").write_text(json.dumps(
            {"loss": float(loss), "losses": losses, "refusals": refusals,
             "specs": {n: [list(mesh.axes(e)) for e in s]
                       for n, s in specs.items()}}))


def _rank_whole_heads(rank, world, out, ckdir):
    """(a)'s gradients on a (1, 8) mesh, where model does not divide
    olmo's 4 heads: attention stays whole on every rank, the MLP and
    the vocab split eight ways."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.attention import local_heads
    from repro_torch.parallel import comm, sharding, use_mesh
    from repro_torch.train.train_loop import batch_to_device
    cfg = _cfg("olmo-1b")
    mesh = make_test_mesh((1, 8))
    with use_mesh(mesh):
        state = _restored(ckdir, cfg, mesh)
        heads = local_heads(cfg)
        loss, grads = _train_step(cfg).grads_of(
            state.params, batch_to_device(_batch(0, cfg), CPU))
        grads = {n: comm.gather_full(g, mesh, sharding.spec_of(p)).numpy()
                 for (n, g), p in zip(grads.items(),
                                      state.params.parameters())}
    if rank == 0:
        np.savez(out / "grads.npz", **grads)
        (out / "result.json").write_text(json.dumps(
            {"loss": float(loss), "heads": [heads[0], heads[1],
                                            list(heads[2])],
             "w_gate": list(state.params.blocks[0].mlp.w_gate.shape),
             "wq": list(state.params.blocks[0].attn.wq.shape)}))


def _rank_decode(rank, world, out, params_path):
    """(b): three decode steps on a (4, 2) serve mesh."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.attention import local_heads
    from repro_torch.models.registry import param_module
    from repro_torch.models.transformer import init_cache, lm_decode_step
    from repro_torch.parallel import sharding, use_mesh
    cfg = _cfg("qwen2.5-1.5b")
    mesh = make_test_mesh((4, 2))
    params = param_module(cfg, CPU)
    params.load_state_dict(torch.load(params_path))
    sharding.place_params(mesh, params, cfg, "serve")
    logits = []
    with use_mesh(mesh, mode="serve"):
        # the blocks the step's products read (as attention and SwiGLU
        # ask for them), each the stored tensor itself
        att, mlp = params.blocks[0].attn, params.blocks[0].mlp
        heads = local_heads(cfg)[2]
        reads = [(w, sharding.weight(w, None, heads))
                 for w in (att.wq, att.wk, att.wv)]
        reads += [(b, sharding.weight(b, heads))
                  for b in (att.bq, att.bk, att.bv)]
        reads += [(att.wo, sharding.weight(att.wo, heads, None)),
                  (mlp.w_gate, sharding.weight(mlp.w_gate, None, ...)),
                  (mlp.w_down, sharding.weight(mlp.w_down, ..., None))]
        stationary = all(r.data_ptr() == w.data_ptr() and
                         r.shape == w.shape for w, r in reads)
        cache = init_cache(cfg, 4, 64, device=CPU)
        shapes = {k: list(v.shape) for k, v in cache.items()}
        for toks in DECODE_TOKENS:
            lg, cache = lm_decode_step(params, cfg, cache, torch.tensor(
                toks, dtype=torch.int32))
            logits.append(lg.numpy())
    if rank == 0:
        np.save(out / "logits.npy", np.stack(logits))
        (out / "result.json").write_text(json.dumps(
            {"len": cache["len"].tolist(), "cache_shapes": shapes,
             "stationary": stationary,
             "wq": list(params.blocks[0].attn.wq.shape),
             "w_gate": list(params.blocks[0].mlp.w_gate.shape)}))


def _psum_input():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((2, 4096)) * 1e-3).astype(np.float32)
    g[1, :2048] = 0.0                        # a chunk of zeros (scale 1)
    return g


def _rank_psum(rank, world, out):
    """(c): compressed_psum over pod of (2, 4)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.compression import compressed_psum
    mesh = make_test_mesh((2, 4), ("pod", "data"))
    x = torch.from_numpy(_psum_input()[mesh.coords["pod"]])
    mean, resid = compressed_psum(x, group=mesh.get_group("pod"))
    if mesh.coords["data"] == 0:
        np.savez(out / f"psum_{mesh.coords['pod']}.npz",
                 mean=mean.numpy(), resid=resid.numpy())


def _rank_elastic(rank, world, out, ckdir, phase):
    """(d): phase 1 trains three steps on (4, 2) and saves; phase 2 (four
    ranks) resumes on the re-mesh plan and trains three more."""
    from repro_torch.checkpoint import save, train_state_to_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import use_mesh
    from repro_torch.train.fault_tolerance import (elastic_remesh_plan,
                                                   elastic_resume)
    cfg = _cfg("olmo-1b")
    step = _train_step(cfg)
    batch = _batch(0, cfg)
    losses = []
    if phase == 1:
        mesh = make_test_mesh((4, 2))
        with use_mesh(mesh):
            state = _restored(ckdir, cfg, mesh)
            for _ in range(3):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            save(str(out / "ck"), 3, state)
        result = {"losses": losses}
    else:
        plan = elastic_remesh_plan(n_alive_chips=world, model_parallel=2)
        mesh = make_test_mesh(plan)
        got, state = elastic_resume(ckdir, cfg, mesh, CPU)
        with use_mesh(mesh):
            restored = train_state_to_numpy(state)
            for _ in range(3):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
        result = {"losses": losses, "plan": list(plan), "step": got}
        if rank == 0:
            np.savez(out / "restored.npz", **{n: a for n, a, _ in restored})
    if rank == 0:
        (out / "result.json").write_text(json.dumps(result))


def _rank_world8(rank, world, out, ckdir, params_path):
    """(a), (d)'s first phase, (b), (c) and the whole-heads case in one
    group of eight ranks, each case writing under its own directory."""
    for name, case, kw in (
            ("train", _rank_train, {"ckdir": ckdir}),
            ("elastic", _rank_elastic, {"ckdir": ckdir, "phase": 1}),
            ("decode", _rank_decode, {"params_path": params_path}),
            ("psum", _rank_psum, {}),
            ("whole_heads", _rank_whole_heads, {"ckdir": ckdir})):
        (out / name).mkdir(exist_ok=True)
        case(rank, world, out / name, **kw)


RANK_CASES = {"world8": _rank_world8, "elastic": _rank_elastic}


def _rank_main(argv):
    case, rank, world, store, out, kw = argv
    torch.set_num_threads(1)
    from repro_torch.parallel import runtime
    with runtime.process_group(store, int(rank), int(world), CPU):
        RANK_CASES[case](int(rank), int(world), Path(out), **json.loads(kw))


def _spawn(tmp_path, case, world, **kw) -> Path:
    """Run ``case`` on ``world`` ranks; their output directory.  Fails
    with every rank's log when one exits non-zero or the group
    overruns ``GROUP_TIMEOUT``."""
    tag = f"{case}_{world}_{len(list(tmp_path.iterdir()))}"
    out = tmp_path / tag
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world),
         str(tmp_path / f"store_{tag}"), str(out), json.dumps(kw)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + GROUP_TIMEOUT
    overran = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            overran = True
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()
    if overran or any(p.returncode for p in procs):
        report = "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n"
            f"{(out / f'rank{r}.log').read_text()[-3000:]}"
            for r, p in enumerate(procs))
        what = f"overran {GROUP_TIMEOUT} s" if overran else "failed"
        pytest.fail(f"{case} on {world} ranks {what}:\n{report}")
    return out


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------

def _reference():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    return jax, jax_get_config, jax_build_model


class World8:
    """The single-device inputs of the eight-rank group and its output:
    the reference's initial olmo-1b training state (``js``) and a
    checkpoint of it as the port's (``ckdir``), the reference's qwen2.5-
    1.5b parameters (``jparams``), and ``out``, a directory a case."""


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """One group of eight ranks runs (a), (d)'s first phase, (b) and (c)
    (one spawn for four cases: each is a test below)."""
    jax, jax_get_config, jax_build_model = _reference()
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.checkpoint import save
    from repro_torch.convert import params_from_jax
    tmp = tmp_path_factory.mktemp("mesh")
    w = World8()
    w.jcfg = dataclasses.replace(jax_get_config("olmo-1b", smoke=True),
                                 dtype="float32")
    w.js = jax.device_get(jax_init_train_state(jax_build_model(w.jcfg),
                                               jax.random.PRNGKey(0)))
    w.ckdir = str(tmp / "initial")
    save(w.ckdir, 0, _port_state(w))
    w.qcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                                 dtype="float32")
    w.jparams = jax_build_model(w.qcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(w.jparams), _cfg("qwen2.5-1.5b"),
                             CPU)
    torch.save(params.state_dict(), tmp / "params.pt")
    w.out = _spawn(tmp, "world8", 8, ckdir=w.ckdir,
                   params_path=str(tmp / "params.pt"))
    return w


def _port_state(w):
    """A fresh single-device port state of the reference's initial one."""
    from repro_torch.convert import train_state_from_jax
    return train_state_from_jax(w.js, _cfg("olmo-1b"), CPU)


def _max_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_sharded_train_matches_single_device(world8):
    """(a) and the refusals of (f)."""
    jax, _, jax_build_model = _reference()
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import _flatten_with_names
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_make_train_step
    from repro_torch.checkpoint import train_state_to_numpy
    from repro_torch.models.common import reference_path
    from repro_torch.train.train_loop import batch_to_device
    jcfg, js, state = world8.jcfg, world8.js, _port_state(world8)
    start = {n: a for n, a, _ in train_state_to_numpy(state)}
    out = world8.out / "train"
    res = json.loads((out / "result.json").read_text())
    cfg = _cfg("olmo-1b")
    # the placements are the reference's rules: FSDP over data, TP over
    # model (olmo's 4 heads: 2 a rank)
    assert res["specs"]["blocks.0.attn.wq"] == [["data"], ["model"]]
    assert res["specs"]["blocks.0.attn.wo"] == [["model"], ["data"]]
    assert res["specs"]["embed.tok"] == [["model"], ["data"]]
    for arch, family in (("mamba2-780m", "ssm"),
                         ("moonshot-v1-16b-a3b", "moe")):
        msg = res["refusals"].get(arch, "")
        assert f"the {family} family" in msg and "mesh" in msg, arch
    # gradients: the single-device port and the reference's jitted
    # value_and_grad on the same batch
    step = _train_step(cfg)
    batch0 = _batch(0, cfg)
    loss1, grads1 = step.grads_of(state.params, batch_to_device(batch0, CPU))
    jm = jax_build_model(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        js.params, {k: jnp.asarray(v) for k, v in batch0.items()})
    jflat = {n: np.asarray(x) for n, x in _flatten_with_names(
        jax.device_get(jgrads))}
    grads = np.load(out / "grads.npz")
    assert sorted(grads.files) == sorted(grads1)
    for name, g1 in grads1.items():
        path, layer = reference_path(name)
        want = jflat[path] if layer is None else jflat[path][layer]
        assert grads[name].shape == tuple(g1.shape), name
        assert _max_err(grads[name], g1.numpy()) <= GRAD_TOL, name
        assert _max_err(grads[name], want) <= GRAD_TOL, name
    assert abs(res["loss"] - float(loss1)) <= LOSS_TOL * abs(float(loss1))
    assert abs(res["loss"] - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    # three steps against the single-device port and the reference's
    # jitted step
    losses1 = []
    for i in range(3):
        state, m = step(state, _batch(i, cfg))
        losses1.append(float(m["loss"]))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxAdamWConfig(**OPT), **TRAIN)))
    for i in range(3):
        js, _ = jstep(js, {k: jnp.asarray(v)
                           for k, v in _batch(i, cfg).items()})
    jleaves = dict(_flatten_with_names(jax.device_get(js)))
    got = np.load(out / "state.npz")
    one = {n: a for n, a, _ in train_state_to_numpy(state)}
    assert np.max(np.abs(np.array(res["losses"]) - losses1)
                  / np.abs(losses1)) <= STEP_LOSS_TOL
    assert res["losses"][-1] < res["losses"][0]
    for name in one:
        if not name.startswith(".params/"):
            continue
        change = got[name] - start[name]
        assert _rel(change, one[name] - start[name]) <= STEP_REL_TOL, name
        assert _rel(change, np.asarray(jleaves[name]) - start[name]) <= \
            STEP_REL_TOL, name


def test_sharded_decode_step(world8):
    """(b)."""
    jax, _, _ = _reference()
    import jax.numpy as jnp
    from repro.models.transformer import init_cache as jax_init_cache
    from repro.models.transformer import lm_decode_step as jax_decode_step
    from repro_torch.convert import params_from_jax
    from repro_torch.models.transformer import init_cache, lm_decode_step
    cfg = _cfg("qwen2.5-1.5b")
    jcfg, jparams = world8.qcfg, world8.jparams
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    out = world8.out / "decode"
    res = json.loads((out / "result.json").read_text())
    got = np.load(out / "logits.npy")
    # serve mode: the MLP's d_ff and the vocab over (data, model), the
    # heads over model (qwen's 2 KV heads; attention's weights stored so
    # too, each data rank a copy), each rank one lane of four
    assert res["w_gate"] == [cfg.d_model, cfg.d_ff // 8]
    assert res["wq"] == [cfg.d_model, cfg.n_heads * cfg.hd // 2]
    assert res["stationary"]
    assert res["cache_shapes"]["k"] == [cfg.n_layers, 1, 1, 64, cfg.hd]
    assert res["len"] == [3, 3, 3, 3]
    cache = init_cache(cfg, 4, 64, device=CPU)
    jcache = jax_init_cache(jcfg, 4, 64)
    for i, toks in enumerate(DECODE_TOKENS):
        one, cache = lm_decode_step(params, cfg, cache, torch.tensor(
            toks, dtype=torch.int32))
        ref, jcache = jax_decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(toks, jnp.int32))
        v = cfg.vocab_size
        assert np.max(np.abs(got[i][:, :v] - one.numpy()[:, :v])) <= \
            LOGIT_TOL, i
        assert np.max(np.abs(got[i][:, :v] - np.asarray(ref)[:, :v])) <= \
            LOGIT_TOL, i


def test_sharded_grads_with_whole_heads(world8):
    """Attention whole on every rank where the model axis does not
    divide the KV heads (olmo's 4 on (1, 8)), as ``_spec_with_div``
    drops such an axis, beside the MLP and the vocab split eight ways:
    the gradients within 1e-5 of each leaf's max |g| of the
    single-device port's, the loss within 1e-5 relative."""
    from repro_torch.train.train_loop import batch_to_device
    cfg = _cfg("olmo-1b")
    out = world8.out / "whole_heads"
    res = json.loads((out / "result.json").read_text())
    assert res["heads"] == [cfg.n_heads, cfg.n_kv_heads, []]
    assert res["w_gate"] == [cfg.d_model, cfg.d_ff // 8]
    assert res["wq"] == [cfg.d_model, cfg.n_heads * cfg.hd // 8]
    loss1, grads1 = _train_step(cfg).grads_of(
        _port_state(world8).params, batch_to_device(_batch(0, cfg), CPU))
    grads = np.load(out / "grads.npz")
    assert sorted(grads.files) == sorted(grads1)
    for name, g1 in grads1.items():
        assert _max_err(grads[name], g1.numpy()) <= GRAD_TOL, name
    assert abs(res["loss"] - float(loss1)) <= LOSS_TOL * abs(float(loss1))


def test_compressed_psum_over_pod(world8):
    """(c): each pod rank quantizes its own row; the numpy model is the
    reference's arithmetic per participant (absmax / 127 a chunk of
    2048, round half to even, clip, dequantize), summed in float32 in
    rank order and halved."""
    from repro_torch.optim.compression import CHUNK
    out = world8.out / "psum"
    g = _psum_input()
    local = []
    for row in g:
        flat = np.pad(row, (0, (-row.size) % CHUNK)).reshape(-1, CHUNK)
        scale = np.max(np.abs(flat), axis=1, keepdims=True) / \
            np.float32(127.0)
        scale = np.where(scale == 0, np.float32(1.0), scale)
        q = np.clip(np.round(flat / scale), -127, 127).astype(np.int8)
        local.append((q.astype(np.float32) * scale).reshape(-1)[:row.size])
    model = (local[0] + local[1]) / np.float32(2.0)
    exact = g.mean(axis=0)
    for pod in (0, 1):
        r = np.load(out / f"psum_{pod}.npz")
        err = np.max(np.abs(r["mean"] - exact)) / np.max(np.abs(exact))
        assert err < 0.02, err
        ulp = np.spacing(np.abs(model).astype(np.float32))
        assert np.all(np.abs(r["mean"] - model) <= ulp)
        assert np.array_equal(r["resid"], g[pod] - local[pod])


def test_elastic_resume_smaller_mesh(world8, tmp_path):
    """(d): the first phase ran in the eight-rank group."""
    state = _port_state(world8)
    first = world8.out / "elastic"
    second = _spawn(tmp_path, "elastic", 4, ckdir=str(first / "ck"),
                    phase=2)
    r1 = json.loads((first / "result.json").read_text())
    r2 = json.loads((second / "result.json").read_text())
    assert r2["plan"] == [2, 2] and r2["step"] == 3
    from repro.train.fault_tolerance import elastic_remesh_plan as jax_plan
    assert jax_plan(4, 2) == (2, 2)
    from repro_torch.checkpoint.checkpointer import _read
    saved = _read(str(first / "ck"), 3)
    restored = np.load(second / "restored.npz")
    assert sorted(restored.files) == sorted(saved)
    for name, (arr, _) in saved.items():
        arr = np.asarray(arr)
        assert restored[name].shape == arr.shape, name
        assert restored[name].tobytes() == arr.tobytes(), name
    losses = r1["losses"] + r2["losses"]
    assert losses[3] < losses[0], losses
    assert losses[-1] < losses[3], losses
    cfg = _cfg("olmo-1b")
    step = _train_step(cfg)
    batch = _batch(0, cfg)
    one = []
    for _ in range(6):
        state, m = step(state, batch)
        one.append(float(m["loss"]))
    assert np.max(np.abs(np.array(losses) - one) / np.abs(one)) <= \
        STEP_LOSS_TOL, (losses, one)


def test_mesh_context_reaches_autograd_threads():
    """The mesh context is process-wide: on the card autograd runs a
    backward, and the checkpoint recompute inside it, on its own
    thread, which must see the mesh and the batch split."""
    import threading
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import sharding, use_mesh
    mesh = make_test_mesh((1, 1))
    seen = {}

    def look():
        seen["mesh"] = sharding.current_mesh()
        seen["mode"] = sharding.current_mode()
        seen["split"] = sharding.batch_split_axes()
    with use_mesh(mesh, mode="serve"), sharding.split_batch(("data",)):
        t = threading.Thread(target=look)
        t.start()
        t.join()
    assert seen == {"mesh": mesh, "mode": "serve", "split": ("data",)}
    assert sharding.current_mesh() is None
    assert sharding.batch_split_axes() == ()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(mesh, *extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(_free_port()), "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--smoke", "--device", "cpu", "--mesh", mesh,
         "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
         *extra], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=GROUP_TIMEOUT)


def test_launcher_under_torch_distributed_run(tmp_path):
    """(e)."""
    ok = _torchrun("1,2", "--ckpt-dir", str(tmp_path / "ck"),
                   "--ckpt-every", "2")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    lines = ok.stdout.splitlines()
    assert lines[0].startswith("mesh {'data': 1, 'model': 2} over 2 ranks "
                               "(gloo, cpu)"), lines
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "1"],
                                                     ["step", "2"]]
    assert lines[-1] == "done"
    assert (tmp_path / "ck" / "step_00000002" / "_COMPLETE").exists()
    no = _torchrun("2,2")
    assert no.returncode != 0
    assert "mesh (2, 2) needs 4 devices; the world has 2 ranks" in no.stderr


if __name__ == "__main__":
    sys.path.insert(0, str(SRC))
    _rank_main(sys.argv[1:])
