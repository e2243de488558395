"""The mesh on the card: a mesh of one rank over NCCL equals the
unsharded step bit for bit.

A process group of one rank (NCCL, on the card) with a (1, 1) mesh
active: the train step's loss and every gradient leaf, three steps'
parameters, and three decode steps' logits and cache are the same bits
as the same calls with no process group and no mesh (SMOKE qwen2.5-1.5b
in bf16).  This checks only that the model is unchanged under an NCCL
group of one: a mesh of one rank is not active
(``sharding.active()`` is ``None``), so no collective runs and the NCCL
branch of ``parallel/comm.py`` is not reached.  The CPU side of the
mesh (several ranks under gloo) is ``tests/test_torch_sharded.py``.

Marked ``cuda``: skipped where there is no device.
"""

import socket

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, synth_batch  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import (init_cache,  # noqa: E402
                                            lm_decode_step)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import runtime, use_mesh  # noqa: E402
from repro_torch.train import (TrainConfig, init_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.train.train_loop import batch_to_device  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


def _run(dev):
    """Grads, three steps and three decode steps of SMOKE qwen2.5-1.5b
    (bf16) on ``dev``, under whatever mesh is active."""
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    model = build_model(cfg)
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
        lr=1e-2, warmup_steps=2, total_steps=10), remat=True))
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             dev)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    loss, grads = step.grads_of(state.params,
                                batch_to_device(synth_batch(dc, 0), dev))
    for i in range(3):
        state, _ = step(state, synth_batch(dc, i))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    cache = init_cache(cfg, 4, 64, device=dev)
    logits = []
    for t in ([1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]):
        lg, cache = lm_decode_step(params, cfg, cache, torch.tensor(
            t, dtype=torch.int32, device=dev))
        logits.append(lg)
    return (loss, grads, dict(state.params.named_parameters()), logits,
            cache)


def test_mesh_of_one_rank_over_nccl_equals_unsharded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the mesh's NCCL group)")
    dev = torch.device("cuda", 0)
    want = _run(dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert runtime.backend_for(dev, 1) == "nccl"
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
        device_id=dev)
    try:
        mesh = make_test_mesh((1, 1))
        assert mesh.tmesh is not None
        with use_mesh(mesh):
            got = _run(dev)
    finally:
        runtime.shutdown()
    loss, grads, params, logits, cache = got
    assert torch.equal(loss, want[0])
    assert all(torch.equal(grads[n], want[1][n]) for n in grads)
    assert all(torch.equal(params[n], want[2][n]) for n in params)
    assert all(torch.equal(a, b) for a, b in zip(logits, want[3]))
    assert all(torch.equal(cache[k], want[4][k]) for k in cache)
