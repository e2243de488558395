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
mesh sizes (data, model); the port runs on one device, so a mesh whose
sizes multiply to 1 (``--mesh 1,1``) trains under ``use_mesh`` exactly
as without one, and a larger mesh is refused with the device count it
needs.
Every decoder family trains (dense, moe, ssm, hybrid, vlm); an
encoder-decoder (``whisper-base``) is refused by name: the data
pipeline has no ``frames`` for its encoder.
"""

from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.parallel import use_mesh
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.fault_tolerance import StragglerMonitor

SEED = 0


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
                    help="mesh sizes (data, model); the port runs on one "
                         "device, so their product must be 1")
    ap.add_argument("--device", default=None, choices=[None, "cuda", "cpu"])
    ap.add_argument("--trace", default=None, metavar="TRACE.json",
                    help="trace the steps after the first with "
                         "torch.profiler, write a Chrome trace here and "
                         "print device time by kernel")
    args = ap.parse_args(argv)
    if args.mesh:
        try:
            sizes = tuple(int(x) for x in args.mesh.split(","))
            args.mesh = make_test_mesh(sizes, ("data", "model")[:len(sizes)])
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
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
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    step_fn = make_train_step(cfg, train_config(args))
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_train_state(model, gen, device)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        got, restored = restore_latest(args.ckpt_dir, state)
        if got is not None:
            start, state = got, restored
            print(f"resumed from step {start}")

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
    traced = contextlib.ExitStack()
    if args.mesh is not None:
        traced.enter_context(use_mesh(args.mesh))
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
                print(f"step {i+1:5d} loss {loss:.4f} "
                      f"({t_tokens * args.log_every / max(dt, 1e-9):,.0f} "
                      f"tok/s) stragglers={monitor.stragglers()}")
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save(i + 1, state)
        sync()
        t_end = time.perf_counter()
    finally:
        traced.close()
        data.close()
    if tracer is not None and args.steps - start > 1:
        report_profile(tracer, t_end - t_trace, args.trace)
    if ckpt:
        ckpt.save(args.steps, state)
        ckpt.close()
    print("done")


if __name__ == "__main__":
    main()
