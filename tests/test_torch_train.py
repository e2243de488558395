"""Training on the port against the reference, at SMOKE width in float32.

* the data pipeline: ``synth_batch`` and ``DataLoader``'s order bitwise;
* AdamW: ``lr_schedule`` bitwise at steps 0, 1, warmup, mid and end;
  ``global_norm`` within 1e-6; ``adamw_update`` with f32, bf16 and int8
  moments over three steps with the same gradients, bitwise against
  the reference's update run op by op (its jitted step fuses and
  differs in the last bits); the decayed-leaf set equals the
  reference's on every family's tree;
* ``Model.loss`` and every gradient leaf against ``jax.value_and_grad``
  of the reference's ``Model.loss``: qwen2.5-1.5b, olmo-1b,
  phi-3-vision (the vision mask), moonshot and arctic (the experts' aux
  loss; each layer's routing equals the reference's first), mamba2 and
  hymba (K10's Function, at a length padded to the chunk and past
  hymba's window) and whisper-base (``whisper_loss`` over frames):
  loss within 1e-5, each gradient leaf within 1e-5 relative (L2 over
  the reference's stacked leaf; observed ~1.5e-6);
* three steps of ``make_train_step`` against the reference's jitted
  step, remat on and off, microbatches 1 and 2, all three moment
  dtypes, and one case (remat, 2 microbatches) for each of moonshot,
  arctic, mamba2, hymba and whisper-base: losses within 1e-4, and per
  leaf the parameters' change and the moments within 1e-2 relative.  AdamW's first steps move each
  weight by ~lr * sign(g), so the few elements whose gradient sits at
  float32 noise (observed: 1-60 of 16k-98k a leaf) take opposite
  steps; the gradients themselves are held to 1e-5 above.  Remat on
  against off is bitwise in the port;
* K2's autograd Function on the CPU: its backward against autograd
  through ``attention_ref`` within 1e-5 (causal, window, GQA, Sq != Sk
  unmasked), ``grad_fn`` is its node, its output and a no-grad call
  bitwise ``flash_attention``'s, and the model's attention runs it
  when training;
* the fault-tolerance harness: ``run_resumable`` with injected failures
  gives the uninterrupted loss series bitwise, ``StragglerMonitor`` and
  ``elastic_remesh_plan`` equal the reference's;
* the launcher as a subprocess (CPU), olmo-1b and mamba2-780m: a run
  with checkpoints, then a resumed one that prints ``resumed from step
  6``; a ``--mesh`` of more than one device refused with its device
  count (``--mesh 1,1`` taken), and whisper-base (no frames in the
  pipeline); serving's parameters stay frozen, and every family's
  training parameters are float32 tracked leaves.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import AsyncCheckpointer as JaxAsyncCheckpointer  # noqa: E402
from repro.checkpoint.checkpointer import _flatten_with_names  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import DataLoader as JaxDataLoader  # noqa: E402
from repro.data import synth_batch as jax_synth_batch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import global_norm as jax_global_norm  # noqa: E402
from repro.optim import lr_schedule as jax_lr_schedule  # noqa: E402
from repro.optim.adamw import _NO_DECAY as JAX_NO_DECAY  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import TrainState as JaxTrainState  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train import fault_tolerance as jax_ft  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.common import embed as jax_embed  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    train_state_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.data import DataConfig, DataLoader, synth_batch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, attention_ref, flash_attention, flash_attention_fn)
from repro_torch.launch.train import parse_args  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import attention_forward  # noqa: E402
from repro_torch.models.common import reference_path  # noqa: E402
from repro_torch.models.registry import param_module  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update,  # noqa: E402
                               global_norm, lr_schedule)
from repro_torch.optim.adamw import decays  # noqa: E402
from repro_torch.train import (TrainConfig, TrainState,  # noqa: E402
                               make_train_step)
from repro_torch.train import fault_tolerance as ft  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
STEP_LOSS_TOL = 1e-4
STEP_REL_TOL = 1e-2
ATTN_TOL = 1e-5
#: a schedule that moves the weights within three steps
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _values(arr, dtype_name):
    """A leaf as float64 values (a bf16 leaf from its uint16 bits)."""
    arr = np.asarray(arr)
    if dtype_name == "bfloat16":
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).astype(np.float64)
    return arr.astype(np.float64)


def _ref_leaves(tree):
    """The reference's leaves by checkpoint name (bf16 as uint16 bits)."""
    out = {}
    for name, x in _flatten_with_names(jax.device_get(tree)):
        x = np.asarray(x)
        out[name] = x.view(np.uint16) if str(x.dtype) == "bfloat16" else x
    return out


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=32, global_batch=4),
    dict(vocab_size=151936, seq_len=64, global_batch=8, n_hosts=2,
         host_id=1, seed=3)])
def test_synth_batch_and_loader_bitwise(kw):
    cfg, jcfg = DataConfig(**kw), JaxDataConfig(**kw)
    for step in (0, 1, 7, 1000):
        got, want = synth_batch(cfg, step), jax_synth_batch(jcfg, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (step, k)
    loader, jloader = DataLoader(cfg, start_step=5), JaxDataLoader(
        jcfg, start_step=5)
    try:
        for i in range(4):
            got, want = next(loader), next(jloader)
            assert np.array_equal(got["tokens"], want["tokens"]), i
            assert np.array_equal(got["tokens"],
                                  synth_batch(cfg, 5 + i)["tokens"])
    finally:
        loader.close()
        jloader.close()


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------

def test_lr_schedule_and_global_norm():
    jc = JaxAdamWConfig(warmup_steps=20, total_steps=100)
    c = AdamWConfig(warmup_steps=20, total_steps=100)
    for step in (0, 1, 20, 60, 100):
        want = np.asarray(jax_lr_schedule(jc, jnp.asarray(step, jnp.int32)))
        got = lr_schedule(c, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy() == want, step
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (17,), (2, 5, 6))]
    want = float(jax_global_norm([jnp.asarray(x) for x in leaves]))
    got = float(global_norm([torch.from_numpy(x) for x in leaves]))
    assert abs(got - want) <= 1e-6 * want
    assert float(global_norm({str(i): torch.from_numpy(x)
                              for i, x in enumerate(leaves)})) == got


def _grads_for(port_params, ref_tree_grads):
    flat = dict(_flatten_with_names(ref_tree_grads))
    out = {}
    for name, _ in port_params.named_parameters():
        path, layer = reference_path(name)
        arr = np.asarray(flat[path])
        out[name] = torch.from_numpy(np.array(
            arr[layer] if layer is not None else arr))
    return out


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16", "int8"])
def test_adamw_update_bitwise_with_same_grads(moment_dtype):
    """Three updates of a SMOKE tree converted from the reference, fed
    the same gradients (small enough that the clip stays 1, so the
    global norm's summation order cannot reach the update)."""
    jcfg, cfg = _cfgs("qwen2.5-1.5b")
    js = jax_init_train_state(jax_build_model(jcfg), jax.random.PRNGKey(0),
                              moment_dtype)
    state = train_state_from_jax(jax.device_get(js), cfg, CPU)
    opt = dict(OPT, moment_dtype=moment_dtype)
    jopt_cfg, opt_cfg = JaxAdamWConfig(**opt), AdamWConfig(**opt)
    jparams, jopt = js.params, js.opt
    rng = np.random.default_rng(1)
    for _ in range(3):
        jg = jax.tree_util.tree_map(
            lambda p: jnp.asarray((rng.standard_normal(p.shape) * 1e-4
                                   ).astype(np.float32)), jparams)
        jparams, jopt, jm = jax_adamw_update(jopt_cfg, jparams, jg, jopt)
        params, opt_state, m = adamw_update(
            opt_cfg, state.params, _grads_for(state.params, jg), state.opt)
        state = TrainState(params, opt_state)
        assert float(m["lr"]) == float(jm["lr"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    want = _ref_leaves(JaxTrainState(params=jparams, opt=jopt))
    got = train_state_to_numpy(state)
    assert [n for n, _, _ in got] == list(want)
    for name, arr, _ in got:
        assert arr.dtype == want[name].dtype, name
        assert np.array_equal(arr, want[name]), name


@pytest.mark.parametrize("arch", ["qwen2.5-1.5b", "olmo-1b",
                                  "phi-3-vision-4.2b", "mamba2-780m",
                                  "hymba-1.5b", "moonshot-v1-16b-a3b",
                                  "whisper-base", "arctic-480b"])
def test_decayed_leaf_set_equals_reference(arch):
    """The reference decays a leaf by its name and ITS (stacked) ndim."""
    jcfg = jax_get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda k: jax_build_model(jcfg).init(k),
                            jax.random.PRNGKey(0))
    want = {name for name, x in _flatten_with_names(shapes)
            if name.split("/")[-1] not in JAX_NO_DECAY and len(x.shape) >= 2}
    params = param_module(get_config(arch, smoke=True), CPU)
    got = {reference_path(n)[0] for n, p in params.named_parameters()
           if decays(n, p)}
    kept = {reference_path(n)[0] for n, p in params.named_parameters()
            if not decays(n, p)}
    assert got | kept == {name for name, _ in _flatten_with_names(shapes)}
    assert got == want
    assert not got & kept


# ----------------------------------------------------------------------
# loss and gradients
# ----------------------------------------------------------------------

def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:     # frames as long as the tokens, as arch smoke's
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return batch


def _routes_port(params, cfg, tokens, monkeypatch):
    """Each layer's expert ids (t, k) in the port's forward."""
    from repro_torch.models import moe as moe_mod
    routes, inner = [], moe_mod._moe_tokens

    def recording(p, x, moe):
        logits = torch.matmul(x.reshape(-1, x.shape[-1]).float(),
                              p.router.float())
        routes.append(torch.topk(torch.softmax(logits, -1),
                                 moe.top_k)[1].numpy())
        return inner(p, x, moe)

    monkeypatch.setattr(moe_mod, "_moe_tokens", recording)
    with torch.no_grad():
        transformer.lm_forward_train(params, torch.from_numpy(tokens), cfg)
    monkeypatch.undo()
    return routes


def _routes_reference(jparams, jcfg, tokens, monkeypatch):
    """Each layer's expert ids in the reference's forward, run a layer at
    a time outside ``lax.scan`` so that the ids are concrete values."""
    routes, inner = [], jax_transformer.moe_forward

    def recording(p, x, moe):
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", x.reshape(-1, x.shape[-1]).astype(jnp.float32),
            p["router"].astype(jnp.float32)), axis=-1)
        routes.append(np.asarray(jax.lax.top_k(probs, moe.top_k)[1]))
        return inner(p, x, moe)

    monkeypatch.setattr(jax_transformer, "moe_forward", recording)
    x = jax_embed(jparams["embed"], jnp.asarray(tokens), jcfg.compute_dtype)
    for i in range(jcfg.n_layers):
        layer = jax.tree_util.tree_map(lambda a: a[i], jparams["blocks"])
        x, _ = jax_transformer.block_forward(layer, x, jcfg)
    monkeypatch.undo()
    return routes


#: the gradient tests' lengths: 40 pads mamba2's and hymba's SSD to two
#: chunks of 32 and passes hymba's window of 32
LOSS_SEQ = {"mamba2-780m": 40, "hymba-1.5b": 40}


@pytest.mark.parametrize("arch", ["qwen2.5-1.5b", "olmo-1b",
                                  "phi-3-vision-4.2b", "moonshot-v1-16b-a3b",
                                  "arctic-480b", "mamba2-780m",
                                  "hymba-1.5b", "whisper-base"])
def test_loss_and_every_gradient_leaf_match_reference(arch, monkeypatch):
    jcfg, cfg = _cfgs(arch)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    seq = LOSS_SEQ.get(arch, 24)
    batch = _batch(cfg, 2, seq, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_state_from_jax(jax.device_get(jax_init_train_state(
        jm, jax.random.PRNGKey(0))), cfg, CPU)
    params = state.params
    if cfg.moe is not None:   # a flipped route would differ grossly
        got = _routes_port(params, cfg, batch["tokens"], monkeypatch)
        want = _routes_reference(jparams, jcfg, batch["tokens"],
                                 monkeypatch)
        assert len(got) == len(want) == cfg.n_layers
        for layer, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), layer
    loss = build_model(cfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    if cfg.n_vision_tokens:   # the mask is live: without it, another loss
        unmasked = build_model(cfg).loss(params, {
            "loss_mask": torch.ones(2, seq),
            **{k: torch.from_numpy(v) for k, v in batch.items()}})
        assert abs(unmasked.item() - loss.item()) > 1e-3
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    want = {n: np.asarray(x) for n, x in _flatten_with_names(jgrads)}
    by_leaf, stacked = {}, set()
    for name, g in zip(names, grads):
        path, layer = reference_path(name)
        by_leaf.setdefault(path, []).append(g.numpy())
        if layer is not None:
            stacked.add(path)
    assert sorted(by_leaf) == sorted(want)
    for path, gs in by_leaf.items():
        got = np.stack(gs) if path in stacked else gs[0]
        assert got.shape == want[path].shape, path
        assert _rel(got, want[path]) <= GRAD_TOL, (path, _rel(got,
                                                              want[path]))


# ----------------------------------------------------------------------
# train steps
# ----------------------------------------------------------------------

STEP_CASES = [pytest.param("qwen2.5-1.5b", md, remat, mb,
                           id=f"{md}-{remat}-{mb}")
              for md, remat, mb in (
                  ("f32", False, 1), ("f32", True, 1), ("f32", False, 2),
                  ("f32", True, 2), ("bf16", True, 1), ("int8", False, 2))]
STEP_CASES += [pytest.param(arch, "f32", True, 2, id=f"{arch}-f32-True-2")
               for arch in ("moonshot-v1-16b-a3b", "arctic-480b",
                            "mamba2-780m", "hymba-1.5b", "whisper-base")]


def _step_batch(dc, step, d_model=None, synth=synth_batch):
    """``synth``'s batch of ``step`` (the port's pipeline or the
    reference's); with ``d_model`` (an encoder-decoder) also seeded
    frames (B, S, d_model)."""
    batch = synth(dc, step)
    if d_model:
        batch["frames"] = np.random.default_rng(100 + step).standard_normal(
            (dc.global_batch, dc.seq_len, d_model)).astype(np.float32)
    return batch


def _run_steps(state, step, n, seq=32, batch=4, vocab=512, d_model=None):
    dc = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch)
    losses = []
    for i in range(n):
        state, m = step(state, _step_batch(dc, i, d_model))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("arch,moment_dtype,remat,microbatches", STEP_CASES)
def test_train_steps_match_reference(arch, moment_dtype, remat,
                                     microbatches):
    jcfg, cfg = _cfgs(arch)
    opt = dict(OPT, moment_dtype=moment_dtype)
    js = jax_init_train_state(jax_build_model(jcfg), jax.random.PRNGKey(0),
                              moment_dtype)
    start = _ref_leaves(js)
    state = train_state_from_jax(jax.device_get(js), cfg, CPU)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxAdamWConfig(**opt), remat=remat,
        microbatches=microbatches)))
    step = make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(**opt), remat=remat,
        microbatches=microbatches))
    d_model = cfg.d_model if cfg.is_encdec else None
    dc = JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    jlosses = []
    for i in range(3):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in _step_batch(
            dc, i, d_model, jax_synth_batch).items()})
        jlosses.append(float(jm["loss"]))
    state, losses = _run_steps(state, step, 3, d_model=d_model)
    assert np.max(np.abs(np.array(losses) - jlosses)) <= STEP_LOSS_TOL
    assert jlosses[-1] < jlosses[0] - 0.1       # the steps do learn
    want = _ref_leaves(js)
    got = train_state_to_numpy(state)
    assert [n for n, _, _ in got] == list(want)
    for name, arr, dt in got:
        if name == ".opt/.step":
            assert int(arr) == int(want[name]) == 3
            continue
        a, b = _values(arr, dt), _values(want[name], dt)
        if name.startswith(".params/"):
            a, b = a - _values(start[name], dt), b - _values(start[name], dt)
        assert _rel(a, b) <= STEP_REL_TOL, (name, _rel(a, b))


def test_remat_bitwise_in_port():
    jcfg, cfg = _cfgs("qwen2.5-1.5b")
    js = jax.device_get(jax_init_train_state(jax_build_model(jcfg),
                                             jax.random.PRNGKey(0)))
    runs = []
    for remat in (False, True):
        step = make_train_step(cfg, TrainConfig(
            optimizer=AdamWConfig(**OPT), remat=remat))
        state, losses = _run_steps(train_state_from_jax(js, cfg, CPU),
                                   step, 3)
        runs.append((losses, train_state_to_numpy(state)))
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    for (n, a, _), (_, b, _) in zip(s0, s1):
        assert np.array_equal(a, b), n


# ----------------------------------------------------------------------
# K2 under autograd
# ----------------------------------------------------------------------

ATTN_CASES = [  # b, h, hkv, sq, sk, d, causal, window
    (2, 4, 2, 33, 33, 32, True, None),
    (1, 8, 2, 40, 40, 16, True, 8),
    (2, 8, 2, 24, 24, 32, True, None),
    (2, 4, 1, 17, 29, 32, False, None)]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_fn_backward_matches_plain_autograd(case):
    b, h, hkv, sq, sk, d, causal, window = case
    gen = torch.Generator().manual_seed(sq * 31 + h)
    q, k, v = (torch.randn(s, generator=gen).requires_grad_()
               for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    d_out = torch.randn(b, h, sq, d, generator=gen)
    out = flash_attention_fn(q, k, v, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert out.grad_fn.__class__.__qualname__.startswith(
        FlashAttentionFn.__name__)
    got = torch.autograd.grad(out, (q, k, v), d_out)
    ref_out = attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(ref_out, (q, k, v), d_out)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= ATTN_TOL
    plain = flash_attention(q.detach(), k.detach(), v.detach(),
                            causal=causal, window=window)
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        again = flash_attention_fn(q, k, v, causal=causal, window=window)
    assert again.grad_fn is None and torch.equal(again, plain)


def _graph_nodes(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_model_attention_runs_the_function_when_training():
    _, cfg = _cfgs("qwen2.5-1.5b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU,
                                   train=True)
    x = torch.randn(2, 8, cfg.d_model)
    out = attention_forward(params.blocks[0].attn, x, cfg)
    assert "FlashAttentionFnBackward" in _graph_nodes(out)
    with torch.no_grad():
        assert torch.equal(
            attention_forward(params.blocks[0].attn, x, cfg), out.detach())


def test_serving_parameters_stay_frozen():
    jcfg, cfg = _cfgs("qwen2.5-1.5b")
    served = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    assert not any(p.requires_grad for p in served.parameters())
    conv = params_from_jax(jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(0))), cfg, CPU)
    assert not any(p.requires_grad for p in conv.parameters())
    for arch in ("qwen2.5-1.5b", "mamba2-780m", "whisper-base"):
        trained = build_model(get_config(arch, smoke=True)).init(
            torch.Generator().manual_seed(0), CPU, train=True)
        assert all(p.requires_grad and p.dtype == torch.float32
                   for p in trained.parameters()), arch


# ----------------------------------------------------------------------
# fault tolerance
# ----------------------------------------------------------------------

def test_run_resumable_gives_the_uninterrupted_series(tmp_path):
    jcfg, cfg = _cfgs("qwen2.5-1.5b")
    js = jax.device_get(jax_init_train_state(jax_build_model(jcfg),
                                             jax.random.PRNGKey(0)))
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(**OPT),
                                            remat=False))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    taken = []

    def recorded(state, batch):
        at = int(state.opt.step)
        state, m = step(state, batch)
        taken.append((at + 1, float(m["loss"])))
        return state, m

    def run(directory, fails):
        taken.clear()
        pending = dict.fromkeys(fails, True)
        ck = AsyncCheckpointer(str(directory), keep=3)
        report = ft.run_resumable(
            recorded, lambda: train_state_from_jax(js, cfg, CPU),
            lambda s: synth_batch(dc, s), ck, total_steps=8, ckpt_every=3,
            failure_injector=lambda s: pending.pop(s, False))
        ck.close()
        return report, list(taken)

    clean, clean_taken = run(tmp_path / "clean", ())
    faulty, faulty_taken = run(tmp_path / "faulty", (4, 7))
    series = dict(clean_taken)
    assert [s for s, _ in clean_taken] == list(range(1, 9))
    assert (clean.restarts, faulty.restarts) == (0, 2)
    assert clean.final_step == faulty.final_step == 8
    # every step, replays included, repeats the uninterrupted loss
    assert [s for s, _ in faulty_taken] == [1, 2, 3, 4, 4, 5, 6, 7, 7, 8]
    assert all(loss == series[s] for s, loss in faulty_taken)
    assert clean.losses == [series[i] for i in range(1, 9)]
    assert faulty.losses == [loss for _, loss in faulty_taken]
    # the reference's loop takes the same path on the same schedule
    pending = {4: True, 7: True}
    jck = JaxAsyncCheckpointer(str(tmp_path / "ref"), keep=3)
    ref = jax_ft.run_resumable(
        lambda s, b: (s + b, {"loss": jnp.asarray(float(s))}),
        lambda: jnp.asarray(0.0), lambda s: jnp.asarray(1.0), jck,
        total_steps=8, ckpt_every=3,
        failure_injector=lambda s: pending.pop(s, False))
    jck.close()
    assert (ref.steps_run, ref.restarts, ref.final_step) == (
        faulty.steps_run, faulty.restarts, faulty.final_step)


def test_straggler_monitor_and_remesh_equal_reference():
    rng = np.random.default_rng(0)
    times = rng.uniform(0.5, 1.5, (12, 5))
    times[:, 3] *= 2.5
    clock = {"t": 0.0}
    mons = [mod.StragglerMonitor(n_hosts=5, warmup=2,
                                 clock=lambda: clock["t"])
            for mod in (ft, jax_ft)]
    for row in times:
        for mon in mons:
            for h, dt in enumerate(row[:4]):
                mon.record(h, float(dt))
            mon.begin(4)
        clock["t"] += float(row[4])
        assert mons[0].end(4) == mons[1].end(4)
        assert mons[0].stragglers() == mons[1].stragglers()
        assert np.array_equal(mons[0].ewma, mons[1].ewma)
    assert mons[0].stragglers() == [3]
    for mon in mons:
        mon.reset(3)
        assert mon.add_host() == 5
    assert mons[0].stragglers() == mons[1].stragglers()
    for alive in (1, 7, 8, 240, 256):
        for mp in (1, 2, 8, 16):
            for min_data in (1, 2):
                assert ft.elastic_remesh_plan(alive, mp, min_data) == \
                    jax_ft.elastic_remesh_plan(alive, mp, min_data)


# ----------------------------------------------------------------------
# launcher
# ----------------------------------------------------------------------

def _launch(*args, arch="olmo-1b"):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq",
         "32", "--log-every", "2", *args], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)


def _launch_and_resume(tmp_path, arch):
    ck = str(tmp_path / "ck")
    first = _launch("--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3",
                    arch=arch)
    assert first.returncode == 0, first.stderr
    lines = first.stdout.splitlines()
    assert lines[0].startswith("step     1 loss ") and "stragglers=[]" in \
        lines[0]
    assert lines[-1] == "done" and "resumed" not in first.stdout
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000003", "step_00000006"]
    second = _launch("--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "3",
                     arch=arch)
    assert second.returncode == 0, second.stderr
    lines = second.stdout.splitlines()
    assert lines[0] == "resumed from step 6"
    assert lines[1].startswith("step     7 loss ")
    assert lines[-1] == "done"


def test_launcher_checkpoints_and_resumes(tmp_path):
    _launch_and_resume(tmp_path, "olmo-1b")


def test_launcher_trains_an_ssm_model_and_resumes(tmp_path):
    """The ssm family through the launcher: K10's Function in every
    step (its plain version here), checkpoints, a resume."""
    _launch_and_resume(tmp_path, "mamba2-780m")


def test_launcher_refuses_a_mesh(capsys):
    """A mesh of more than one device is refused with the count it
    needs; a one-device mesh is taken."""
    with pytest.raises(SystemExit) as exc:
        parse_args(["--arch", "olmo-1b", "--mesh", "2,2"])
    assert exc.value.code != 0
    assert "needs 4 devices" in capsys.readouterr().err
    assert parse_args(["--arch", "olmo-1b", "--mesh", "1,1"]).mesh.size == 1


def test_launcher_refuses_whisper_by_name(capsys):
    with pytest.raises(SystemExit) as exc:
        parse_args(["--arch", "whisper-base", "--smoke"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "whisper-base" in err and "frames" in err
