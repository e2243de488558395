"""Training step: remat + microbatched gradient accumulation + AdamW, the
reference's ``train/train_loop.py``.

Precision is the reference's: every parameter leaf is held in float32
(the masters of ``Model.init(..., train=True)``) and cast to the compute
dtype at use.  Here the cast is one copy a step into a compute-dtype
module whose leaves autograd tracks (no copy when the compute dtype is
float32: the masters run the forward themselves); the cotangent of each
copied leaf, cast to float32, is the gradient the reference's transpose
of ``astype`` gives.  Gradients reach the optimizer in float32, and
microbatch gradients are summed in float32 and scaled by ``1/n``.

On a mesh of more than one rank (``init_train_state(..., mesh=)``) the
state is this rank's block of every leaf, placed by the reference's
``param_shardings`` (FSDP over ``data``, TP over ``model``), the compute
copy holds the same blocks, and the step takes the whole batch on every
rank: each microbatch is split by rows over the ``batch`` axes
(``place_batch``), each rank differentiates its share of the loss, and
the weights' gradients sum over those axes (``sharding.weight``).  The
reported loss is the sum of the shares, the microbatches as before.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import ModelConfig, trainable
from repro_torch.models.registry import Model, build_model, param_module
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw)
from repro_torch.parallel import sharding


class TrainState(NamedTuple):
    params: nn.Module     # float32 masters (LM or Whisper), tracked
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: bool = True
    microbatches: int = 1


def init_train_state(model: Model, generator: torch.Generator,
                     device: torch.device, moment_dtype: str = "f32",
                     mesh=None) -> TrainState:
    """Float32 masters drawn from ``generator`` and fresh moments.  With
    a ``mesh`` of more than one rank every rank draws the same whole
    masters and keeps its block (``sharding.place_params``, train mode);
    the moments are made at the blocks' shapes (an int8 momentum's
    scale, one a row, whole on the axes that split the row:
    ``adamw_update`` gives each block the whole row's)."""
    params = model.init(generator, device, train=True)
    if mesh is not None and mesh.size > 1:
        sharding.place_params(mesh, params, model.cfg, "train")
    return TrainState(params=params, opt=init_adamw(params, moment_dtype))


def batch_to_device(batch: Mapping[str, Any], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (the data pipeline's) or tensors as
    tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
        out[k] = t.to(device)
    return out


class _ComputeCopy:
    """The compute-dtype parameters a step differentiates: the masters
    themselves when the config computes in float32, else one module in
    the compute dtype (made at first use and kept) refilled from the
    masters each step."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.work = None

    @torch.no_grad()
    def of(self, master: nn.Module) -> nn.Module:
        if self.cfg.compute_dtype == torch.float32:
            return master
        if self.work is None:
            first = next(master.parameters())
            if sharding.spec_of(first) is None:
                self.work = trainable(param_module(self.cfg, first.device))
            else:                    # the masters' blocks
                self.work = trainable(sharding.placed_like(
                    param_module(self.cfg, torch.device("meta")), master))
        for w, m in zip(self.work.parameters(), master.parameters()):
            w.copy_(m)
        return self.work


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()
                    ) -> Callable[[TrainState, Mapping[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``(state, batch) -> (state, metrics)``; metrics ``loss``,
    ``grad_norm`` and ``lr`` are float32 scalars on the device.  The
    state is updated in place (the reference's jitted step donates it).
    ``batch`` holds ``tokens`` and ``labels`` (B, S), numpy or tensors,
    and optionally ``loss_mask`` and ``vision_embeds`` (a vlm's (B, n,
    d)); an encoder-decoder's also holds ``frames`` (B, S_enc, d).  With
    microbatches every entry is split along its batch axis."""
    model = build_model(cfg)
    compute = _ComputeCopy(cfg)

    def value_and_grad(work: nn.Module, batch) -> Tuple[torch.Tensor,
                                                 List[torch.Tensor]]:
        leaves = list(work.parameters())
        loss = model.loss(work, batch, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [
            torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            if g is None else g.float() for t, g in zip(leaves, grads)]

    def split_grad(work: nn.Module, mb):
        """One microbatch (whole on every rank): on a mesh, this rank's
        rows differentiated under ``split_batch``, the loss summed over
        the rows' axes."""
        mesh = sharding.active()
        if mesh is None:
            return value_and_grad(work, mb)
        axes = sharding.batch_axes(mesh, mb["tokens"].shape[0])
        with sharding.split_batch(axes):
            loss, grads = value_and_grad(work, sharding.place_batch(mesh,
                                                                    mb))
        return sharding.all_reduce(loss, axes), grads

    def grads_of(params: nn.Module, batch):
        work = compute.of(params)
        n = tcfg.microbatches
        if n <= 1:
            loss, grads = split_grad(work, batch)
        else:
            mbs = [{k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = None
            for mb in mbs:
                mb_loss, g = split_grad(work, mb)
                loss = loss + mb_loss
                grads = g if grads is None else [
                    a + b for a, b in zip(grads, g)]
            scale = 1.0 / n
            loss = loss * scale
            grads = [g * scale for g in grads]
        names = [name for name, _ in params.named_parameters()]
        return loss, dict(zip(names, grads))

    def train_step(state: TrainState, batch: Mapping[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        device = state.opt.step.device
        loss, grads = grads_of(state.params, batch_to_device(batch, device))
        params, opt, metrics = adamw_update(tcfg.optimizer, state.params,
                                            grads, state.opt)
        metrics = dict(metrics, loss=loss)
        return TrainState(params=params, opt=opt), metrics

    train_step.grads_of = grads_of
    return train_step
