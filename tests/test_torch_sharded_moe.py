"""The moe family on a mesh of several ranks, on the CPU: gloo, SMOKE
configs in float32, one process a rank, one microbatch.

The experts are split over ``model`` (the reference's ``expert`` axis)
and, in train mode, the rows over ``data``; the sharded step is held
against the single-device port's and the reference's jitted
``value_and_grad`` and decode step, as ``test_torch_sharded.py`` holds
the other families (its helpers run the cases):

* ``MOE_CASES``: moonshot on (4, 2) and (2, 4) (its shared expert read
  whole in train mode, stored as the dense MLP in serve mode), moonshot
  with ``capacity_factor`` 0.5 on (4, 2) (C 48 against ~96 assignments
  an expert: drops decided by each assignment's slot in the unsharded
  call), arctic on (4, 2) (its dense residual FFN column- and
  row-parallel; 2 KV heads): the placement, the loss and every gradient
  leaf (router, experts and shared expert among them) within 1e-5 of
  both, three steps within 1e-4 (losses) and 1e-2 (each parameter's
  change) of the single-device port's, four serve-mode decode steps'
  logits within 1e-5 of both and the gathered cache within 1e-5;
* the moonshot (4, 2) state after three steps, checkpointed on the
  mesh, restores onto the unsharded model bit for bit;
* ``moe_forward``'s chunked dispatch with the rows split over ``data``:
  chunks on one rank and chunks that span two ranks, against the
  unsharded call with the same chunk.

One group of eight ranks runs them all (180 s).
"""

import dataclasses
import json
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded import (BATCH, CPU, GRAD_TOL, SEQ, SRC,  # noqa: E402
                                _check_decode, _check_train, _family_cfg,
                                _family_key, _family_ref,
                                _rank_cases, _rank_main, _reference,
                                _smoke_of, _spawn)

pytestmark = pytest.mark.torch_port

#: case -> (arch, mesh, MoEConfig fields replaced); each config's
#: initial state is the reference's (one checkpoint a config)
MOE_CASES = {
    "moonshot-4x2": ("moonshot-v1-16b-a3b", (4, 2), {}),
    "moonshot-2x4": ("moonshot-v1-16b-a3b", (2, 4), {}),
    "moonshot-cf0.5-4x2": ("moonshot-v1-16b-a3b", (4, 2),
                           {"capacity_factor": 0.5}),
    "arctic-4x2": ("arctic-480b", (4, 2), {}),
}
#: the leaves the train test names among every gradient leaf it checks
MOE_LEAVES = ("moe.router", "moe.w_gate", "moe.w_up", "moe.w_down")
SHARED_LEAVES = ("moe.shared.w_gate", "moe.shared.w_up", "moe.shared.w_down")
#: ``moe_forward``'s dispatch chunks on (4, 2), 64 tokens a rank: 32
#: (two chunks on each rank) and 128 (a chunk spans two ranks), at
#: ``capacity_factor`` 0.5 so that each chunk drops
CHUNKS = (32, 128)


# ----------------------------------------------------------------------
# the ranks (this file run as a script)
# ----------------------------------------------------------------------

def _rank_chunks(rank, world, out):
    """``moe_forward`` on layer 0's experts of the cf 0.5 config with
    each of ``CHUNKS``: this rank's rows against the same rows of the
    unsharded call, and the aux shares summed over ``data`` against its
    aux."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe import moe_forward
    from repro_torch.models.transformer import init_lm
    from repro_torch.parallel import comm, sharding, use_mesh
    cfg = _family_cfg("moonshot-cf0.5-4x2", cases=MOE_CASES)
    mesh = make_test_mesh((4, 2))
    whole = init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    placed = init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    sharding.place_params(mesh, placed, cfg, "train")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32))
    res = {}
    with torch.no_grad():
        for chunk in CHUNKS:
            want, want_aux = moe_forward(whole.blocks[0].moe, x, cfg.moe,
                                         chunk=chunk)
            with use_mesh(mesh), sharding.split_batch(("data",)):
                got, aux = moe_forward(placed.blocks[0].moe,
                                       comm.take(x, mesh, 0, "data"),
                                       cfg.moe, chunk=chunk)
            err = torch.max(torch.abs(
                got - comm.take(want, mesh, 0, "data"))).reshape(1)
            err = comm.all_reduce(err, mesh, ("data", "model"), op="max")
            aux = comm.all_reduce(aux, mesh, "data")
            res[str(chunk)] = {"err": float(err),
                               "out_max": float(want.abs().max()),
                               "aux": float(aux), "want_aux": float(want_aux)}
    if rank == 0:
        (out / "result.json").write_text(json.dumps(res))


def _rank_moe(rank, world, out, ckdirs):
    """Every case of ``MOE_CASES``, then the chunked dispatch."""
    seconds = {}
    for name, case, kw in (
            ("cases", _rank_cases, {"ckdirs": ckdirs, "cases": MOE_CASES,
                                    "ck_case": "moonshot-4x2"}),
            ("chunks", _rank_chunks, {})):
        (out / name).mkdir(exist_ok=True)
        t0 = time.perf_counter()
        case(rank, world, out / name, **kw)
        seconds[name] = time.perf_counter() - t0
    if rank == 0:           # each part's share of the group's time limit
        (out / "seconds.json").write_text(json.dumps(seconds))


RANK_CASES = {"moe": _rank_moe}


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_moe(tmp_path_factory):
    """The reference's initial state of each config (``fstates``; port
    checkpoints of them), the single-device runs they are held to
    (``fref``, filled at first use), and the eight-rank group's output
    (``out``)."""
    jax, jax_get_config, jax_build_model = _reference()
    from repro.train import init_train_state as jax_init_train_state
    from repro_torch.checkpoint import save
    from repro_torch.convert import train_state_from_jax
    tmp = tmp_path_factory.mktemp("mesh_moe")
    w = types.SimpleNamespace(fstates={}, fref={})
    ckdirs = {}
    for case in MOE_CASES:
        key = _family_key(case, MOE_CASES)
        if key in w.fstates:
            continue
        jcfg = _family_cfg(case, _smoke_of(jax_get_config), MOE_CASES)
        w.fstates[key] = jax.device_get(jax_init_train_state(
            jax_build_model(jcfg), jax.random.PRNGKey(0)))
        ckdirs[key] = str(tmp / f"initial_{key}")
        save(ckdirs[key], 0, train_state_from_jax(
            w.fstates[key], _family_cfg(case, cases=MOE_CASES), CPU))
    w.out = _spawn(tmp, "moe", 8, script=__file__, ckdirs=ckdirs)
    return w


def _case_out(w, case):
    out = w.out / "cases" / case
    return out, json.loads((out / "result.json").read_text())


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_sharded_moe_train_matches_single_device(world_moe, case):
    """The placement (experts over ``model`` with d over ``data`` in
    train mode, resident with the expert-ff over ``data`` in serve mode;
    the shared expert by the experts' rule in train mode and as the dense
    MLP in serve mode), the loss and every gradient leaf (router, experts
    and shared expert among them) against the single-device port and
    the reference, three steps against the single-device port."""
    from repro_torch.models.moe import capacity
    ref = _family_ref(world_moe, case, MOE_CASES)
    cfg = _family_cfg(case, cases=MOE_CASES)
    out, res = _case_out(world_moe, case)
    spec, serve = res["specs"], res["serve_specs"]
    assert res["expert_axes"] == ["model"]
    assert spec["blocks.0.moe.w_gate"] == [["model"], ["data"], []]
    assert spec["blocks.0.moe.w_down"] == [["model"], [], ["data"]]
    assert spec["blocks.0.moe.router"] == [["data"], []]
    assert serve["blocks.0.moe.w_gate"] == [["model"], [], ["data"]]
    assert serve["blocks.0.moe.w_down"] == [["model"], ["data"], []]
    grads = np.load(out / "grads.npz")
    leaves = {n.split(".", 2)[2] for n in grads.files
              if n.startswith("blocks.")}
    assert set(MOE_LEAVES) <= leaves
    if cfg.moe.n_shared_experts:
        assert set(SHARED_LEAVES) <= leaves
        assert spec["blocks.0.moe.shared.w_gate"] == [["model"], ["data"]]
        assert spec["blocks.0.moe.shared.w_down"] == [["model"], []]
        assert serve["blocks.0.moe.shared.w_gate"] == [[], ["data",
                                                            "model"]]
        assert serve["blocks.0.moe.shared.w_down"] == [["data", "model"],
                                                       []]
    if cfg.moe.dense_residual:
        assert spec["blocks.0.mlp.w_gate"] == [["data"], ["model"]]
        assert "mlp.w_down" in leaves
    if cfg.moe.capacity_factor < 1:
        # the capacity of the whole batch's 256 tokens drops some of
        # their assignments, and differs from four ranks' own capacities
        t = BATCH * SEQ
        assert cfg.moe.n_experts * capacity(t, cfg.moe) < t * cfg.moe.top_k
        assert 4 * capacity(t // 4, cfg.moe) != capacity(t, cfg.moe)
    _check_train(out, res, grads, ref)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_sharded_moe_decode_step(world_moe, case):
    """Four serve-mode decode steps: the logits within 1e-5 of the
    single-device port's and the reference's, the gathered K/V within
    1e-5 of both, each rank's cache its lanes and its KV heads (whole
    where ``model`` does not divide them)."""
    ref = _family_ref(world_moe, case, MOE_CASES)
    cfg = _family_cfg(case, cases=MOE_CASES)
    shape = MOE_CASES[case][1]
    out, res = _case_out(world_moe, case)
    _check_decode(out, cfg, ref)
    heads = shape[1] if cfg.n_kv_heads % shape[1] == 0 else 1
    assert res["head_axes"] == (["model"] if heads > 1 else [])
    assert res["cache_shapes"]["k"][1:3] == [4 // shape[0],
                                             cfg.n_kv_heads // heads]


def test_sharded_moe_checkpoint_restores_unsharded(world_moe):
    """The moonshot (4, 2) state after three steps, checkpointed on the
    mesh (gathered, rank 0 writing), restores onto the unsharded model
    equal, leaf by leaf and bit for bit, to the gathered state."""
    from repro_torch.checkpoint import (empty_train_state, restore,
                                        train_state_to_numpy)
    cfg = _family_cfg("moonshot-4x2", cases=MOE_CASES)
    out, _ = _case_out(world_moe, "moonshot-4x2")
    state = restore(str(out / "ck"), 3, empty_train_state(cfg, CPU))
    moe = state.params.blocks[0].moe
    assert moe.w_gate.shape == (cfg.moe.n_experts, cfg.d_model,
                                cfg.moe.d_expert_ff)
    got = {n: a for n, a, _ in train_state_to_numpy(state)}
    want = np.load(out / "state.npz")
    assert sorted(got) == sorted(want.files)
    assert any(n.endswith("/moe/shared/w_gate") for n in got)
    for name, arr in got.items():
        assert arr.shape == want[name].shape, name
        assert arr.tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("chunk", CHUNKS)
def test_sharded_moe_chunked_dispatch(world_moe, chunk):
    """``moe_forward`` with the rows split over ``data`` and the global
    token count past ``chunk``: each rank's output within 1e-5 of the
    largest output of the unsharded call's same rows, and the aux shares'
    sum within 1e-5 relative of its aux."""
    res = json.loads((world_moe.out / "chunks" / "result.json").read_text())
    r = res[str(chunk)]
    assert r["err"] <= GRAD_TOL * r["out_max"], r
    assert abs(r["aux"] - r["want_aux"]) <= GRAD_TOL * abs(r["want_aux"]), r


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_check_mesh_family_places_moe(shape):
    """The rules place moonshot and arctic on a mesh of eight ranks, and
    whisper-base and an int8 KV cache beside them: no family is refused
    any more (``check_mesh_family`` is gone), every parameter has a spec,
    and every cache entry its placement, the heads dim of the K/V, an
    int8 cache's scales and whisper's cross K/V over ``head_axes``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.registry import param_module
    from repro_torch.models.transformer import init_cache
    from repro_torch.parallel import sharding
    assert not hasattr(sharding, "check_mesh_family")
    mesh = DeviceMesh.__new__(DeviceMesh)    # the rules read its shape
    mesh.sizes, mesh.axis_names = shape, ("data", "model")
    meta = torch.device("meta")
    int8 = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                               kv_quant="int8")
    for cfg in (get_config("moonshot-v1-16b-a3b"), get_config("arctic-480b"),
                get_config("whisper-base"), int8):
        module = param_module(cfg, meta)
        for mode in ("train", "serve"):
            specs = sharding.param_shardings(mesh, module, mode)
            assert sorted(specs) == sorted(
                n for n, _ in module.named_parameters()), cfg.name
        heads = sharding.head_axes(mesh, cfg, "serve")
        if cfg.is_encdec:
            d = (cfg.n_layers, 4, cfg.n_kv_heads, 16, cfg.hd)
            cache = {"len": torch.empty(4, device=meta),
                     **{n: torch.empty(d, device=meta)
                        for n in ("k", "v", "cross_k", "cross_v")}}
        else:
            cache = init_cache(cfg, 4, 16, device=meta)
        layout = sharding.cache_layout(mesh, cfg, cache, "serve")
        assert sorted(layout) == sorted(cache), cfg.name
        for name, spec in layout.items():
            if name != "len":
                assert mesh.axes(spec[2]) == heads, (cfg.name, name)

if __name__ == "__main__":
    sys.path.insert(0, str(SRC))
    _rank_main(sys.argv[1:], RANK_CASES)
