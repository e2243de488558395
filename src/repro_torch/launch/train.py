"""Training launcher: ``python -m repro_torch.launch.train --arch olmo-1b
[--smoke] [--steps N] [--batch B] [--seq S] [--lr LR] [--microbatches M]
[--ckpt-dir DIR --ckpt-every K] [--log-every K] [--device cuda|cpu]
[--mesh D,M] [--trace TRACE.json]``.

The reference's training launcher on one device: seeded random float32
master weights (the seed is 0, as the reference's ``PRNGKey(0)``), the
synthetic data pipeline, AdamW with the reference's schedule (warmup 20
steps, cosine to ``--steps``), remat unless ``--smoke``, async
checkpoints every ``--ckpt-every`` steps and at the end, resume from the
latest committed step.  It prints the reference's lines: ``resumed from
step N``, ``step N loss L (X tok/s) stragglers=[...]`` every
``--log-every`` steps (and on the first), and ``done``.  ``--trace``
records every step after the first with ``torch.profiler``, writes a
Chrome trace and prints device time by kernel and the device's busy
share (the serve launcher's report).  Runs on
``cuda`` unless ``--device cpu``.  ``--mesh`` takes the reference's
mesh sizes (data, model), whose product must be the world size: ``--mesh
1,1`` in one process trains under ``use_mesh`` exactly as without one,
and a larger mesh runs one process a rank under ``python -m
torch.distributed.run --nproc-per-node N -m repro_torch.launch.train
... --mesh D,M`` (each rank on ``cuda:{LOCAL_RANK % cards}``, NCCL when
every rank has a card, gloo otherwise): the dense, moe, ssm, hybrid and
vlm families train FSDP over ``data`` and TP over ``model`` (the Mamba-2
mixer by SSD heads, a moe block's experts over ``model`` as the
reference's ``expert`` axis; ``repro_torch.parallel.sharding``); rank 0
prints and writes the checkpoints.  A mesh that does not match the
world is refused with both numbers.
Every decoder family trains (dense, moe, ssm, hybrid, vlm); an
encoder-decoder (``whisper-base``) is refused by name: the data
pipeline has no ``frames`` for its encoder.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve import report_profile
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import runtime, use_mesh
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.fault_tolerance import StragglerMonitor

SEED = 0
MESH_AXES = ("data", "model")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="mesh sizes (data, model); their product must "
                         "be the world size (torch.distributed.run's "
                         "ranks, 1 without it)")
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"])
    ap.add_argument("--trace", default=None, metavar="TRACE.json",
                    help="trace the steps after the first with "
                         "torch.profiler, write a Chrome trace here and "
                         "print device time by kernel")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    args.mesh_sizes = None
    if args.mesh:
        try:
            sizes = tuple(int(x) for x in args.mesh.split(","))
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
        if math.prod(sizes) != world or len(sizes) > 2:
            ap.error(f"--mesh {args.mesh}: mesh {sizes} needs "
                     f"{math.prod(sizes)} devices; the world has {world} "
                     f"rank{'s' if world != 1 else ''}")
        args.mesh_sizes = sizes
        # a world of one needs no process group: the mesh is made here
        args.mesh = make_test_mesh(sizes, MESH_AXES[:len(sizes)]) \
            if world == 1 else None
    elif world > 1:
        ap.error(f"a run of {world} ranks needs --mesh D,M with D * M = "
                 f"{world}")
    if get_config(args.arch, smoke=args.smoke).is_encdec:
        ap.error(f"--arch {args.arch}: an encoder-decoder trains on "
                 f"frames (B, S_enc, d) beside its tokens, and the data "
                 f"pipeline gives tokens and labels only (no frames), as "
                 f"the reference's does; train it through make_train_step "
                 f"with a batch that holds frames")
    return args


def train_config(args: argparse.Namespace) -> TrainConfig:
    """The reference launcher's schedule and remat choice."""
    return TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps),
        remat=not args.smoke, microbatches=args.microbatches)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    joined = args.mesh_sizes is not None and args.mesh is None
    if joined:                      # one rank of torch.distributed.run
        runtime.init_from_env(device)
        args.mesh = make_test_mesh(args.mesh_sizes,
                                   MESH_AXES[:len(args.mesh_sizes)])
    try:
        _train(args, device)
    finally:
        if joined:
            runtime.shutdown()


def _train(args: argparse.Namespace, device: torch.device) -> None:
    say = print if runtime.rank() == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    step_fn = make_train_step(cfg, train_config(args))
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_train_state(model, gen, device, mesh=args.mesh)
    if args.mesh is not None and args.mesh.size > 1:
        say(f"mesh {args.mesh.shape} over {args.mesh.size} ranks "
            f"({torch.distributed.get_backend()}, {device.type})")
    traced = contextlib.ExitStack()
    if args.mesh is not None:
        traced.enter_context(use_mesh(args.mesh))
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        got, restored = restore_latest(args.ckpt_dir, state)
        if got is not None:
            start, state = got, restored
            say(f"resumed from step {start}")

    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                 global_batch=args.batch), start_step=start)
    monitor = StragglerMonitor(n_hosts=1)
    t_tokens = args.batch * args.seq
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    tracer = None
    if args.trace:
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        tracer = profile(activities=acts)
    try:
        t_last = time.time()
        for i, batch in zip(range(start, args.steps), data):
            if tracer is not None and i == start + 1:
                sync()
                traced.enter_context(tracer)
                t_trace = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if (i + 1) % args.log_every == 0 or i == start:
                loss = float(metrics["loss"])
                dt = time.time() - t_last
                t_last = time.time()
                monitor.record(0, dt)
                say(f"step {i+1:5d} loss {loss:.4f} "
                      f"({t_tokens * args.log_every / max(dt, 1e-9):,.0f} "
                      f"tok/s) stragglers={monitor.stragglers()}")
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save(i + 1, state)
        sync()
        t_end = time.perf_counter()
        if ckpt:
            ckpt.save(args.steps, state)
            ckpt.close()
    finally:
        traced.close()
        data.close()
    if tracer is not None and args.steps - start > 1 and \
            runtime.rank() == 0:
        report_profile(tracer, t_end - t_trace, args.trace)
    say("done")


if __name__ == "__main__":
    main()
