"""AdamW with decoupled weight decay and global-norm clipping: the
reference's ``optim/adamw.py``.

Parameters are a module tree (the float32 masters of
``Model.init(..., train=True)``), gradients a ``{name: float32 tensor}``
map over its ``named_parameters``, and the moments maps of the same
names.  The update runs in place on the parameters and moments (the
reference's step donates its state to the same effect) and keeps the
reference's float32 arithmetic in its order: clip, moments, bias
corrections ``1 - b**step``, update.  Divisions by a Python number go
through :func:`~repro_torch.quant.quantize.true_div`, because PyTorch's
CUDA division by a number multiplies by its reciprocal; square roots
through :func:`_sqrt`.  Run op by op, the reference's update gives the
same bits on the CPU (its jitted step fuses, so there it differs in the
last bits).
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Iterable, List, Mapping, NamedTuple,
                    Optional, Union)

import torch
from torch import nn

from repro_torch.models.common import reference_path
from repro_torch.parallel import comm, sharding
from repro_torch.quant.quantize import true_div


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # moment storage: "f32" | "bf16" | "int8".  "int8" = row-wise int8
    # momentum + bf16 variance: linear int8 cannot span the second
    # moment's dynamic range (tiny nu quantizes to 0 and updates
    # explode), while bf16's 8-bit exponent holds it -- 4+1+2 B/param.
    moment_dtype: str = "f32"


@dataclasses.dataclass
class Q8Moment:
    """Row-wise int8-encoded momentum (8-bit Adam storage): ``q`` int8 of
    the parameter's shape, ``scale`` one float32 absmax / 127 per
    last-axis row, shape ``param.shape[:-1] + (1,)``."""

    q: torch.Tensor
    scale: torch.Tensor


Moment = Union[torch.Tensor, Q8Moment]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.  PyTorch's
    vectorized CPU ``sqrt`` is not (about one element in eight is an ulp
    off); the double's root rounds to the float32 one.  CUDA's float32
    ``sqrtf`` is IEEE-exact; a ``meta`` tensor (the dry run) takes the
    card's route, so its pass sees no float64 copy."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _q8_store(x: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> Q8Moment:
    """``x`` row-wise int8: ``amax`` is each row's largest magnitude
    (``x``'s own rows' when ``None``)."""
    if amax is None:
        amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = true_div(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return Q8Moment(q=q, scale=scale.float())


def _q8_load(st: Q8Moment) -> torch.Tensor:
    return st.q.float() * st.scale


def _split_row_amax(params: nn.Module, grads: Mapping[str, torch.Tensor],
                    mu: Mapping[str, Q8Moment], clip: torch.Tensor,
                    b1: float) -> Dict[str, torch.Tensor]:
    """The whole rows' maxima of this step's int8 momenta whose rows are
    split over mesh axes (a parameter whose last dim is): a row's scale
    is the whole row's, as the reference's ``max`` over a sharded dim
    gives it.  Each block's updated momentum is formed for its row
    maxima and dropped, and the maxima are maxed over the axes that
    split the row -- one all-reduce for each set of such axes, every
    leaf that shares it together -- so no float32 momentum outlives its
    leaf and every rank holding part of a row stores the same scale.
    Empty with no mesh."""
    groups: Dict[tuple, Dict[str, torch.Tensor]] = {}
    for name, p in params.named_parameters():
        row_axes = sharding.axes_of(p, -1)
        if row_axes:        # the update's own arithmetic, in its order
            mu_f = b1 * _q8_load(mu[name]) + (1 - b1) * (
                grads[name].float() * clip)
            groups.setdefault(row_axes, {})[name] = torch.amax(
                torch.abs(mu_f), dim=-1, keepdim=True)
    out = {}
    for axes, amax in groups.items():
        flat = sharding.all_reduce(
            torch.cat([a.reshape(-1) for a in amax.values()]), axes,
            op="max")
        for (name, a), row in zip(amax.items(), torch.split(
                flat, [a.numel() for a in amax.values()])):
            out[name] = row.view_as(a)
    return out


def q8_invariant(state, mesh) -> List:
    """The int8-moment invariant over every momentum of ``state`` (a
    ``TrainState`` of this rank's blocks, int8 moments; every rank of
    ``mesh``, the active one, takes part): ``[same, full, split]`` --
    whether the ranks holding parts of each row hold the same ``scale``
    bitwise, whether each row's max |q| over those parts is 127 (or 0
    with scale 1: a zero row), and how many leaves have their rows
    split."""
    same = full = True
    split = 0
    for name, p in state.params.named_parameters():
        m = state.opt.mu[name]
        axes = sharding.axes_of(p, -1)
        split += bool(axes)
        scales = comm.all_gather(m.scale, mesh, axes, m.scale.dim() - 1)
        same &= bool(torch.all(scales == scales[..., :1]))
        qmax = comm.all_reduce(torch.amax(torch.abs(m.q.int()), -1,
                                          keepdim=True), mesh, axes, "max")
        full &= bool(torch.all((qmax == 127) | ((qmax == 0)
                                                & (m.scale == 1))))
    ok = comm.all_reduce(torch.tensor([int(same), int(full)],
                                      device=p.device), mesh,
                         mesh.axis_names, "sum")
    return [int(ok[0]) == mesh.size, int(ok[1]) == mesh.size, split]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: Dict[str, Moment]
    nu: Dict[str, torch.Tensor]


MOMENT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def init_adamw(params: nn.Module, moment_dtype: str = "f32") -> AdamWState:
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if moment_dtype == "int8":
        mu = {n: _q8_store(torch.zeros(p.shape, dtype=torch.float32,
                                       device=device))
              for n, p in named.items()}
        nu = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=device)
              for n, p in named.items()}
        return AdamWState(step=step, mu=mu, nu=nu)
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {moment_dtype!r}: one of f32, bf16, "
                         f"int8")
    dt = MOMENT_DTYPES[moment_dtype]

    def z():
        return {n: torch.zeros(p.shape, dtype=dt, device=device)
                for n, p in named.items()}

    return AdamWState(step=step, mu=z(), nu=z())


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (float32 scalar)."""
    step = step.float()
    warm = torch.clamp(true_div(step, max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp(true_div(step - cfg.warmup_steps,
                             max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Union[Mapping[str, torch.Tensor],
                            Iterable[torch.Tensor]],
                specs: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """The 2-norm of every leaf together.  With ``specs`` ({name: spec}
    of a mapping's leaves, each this rank's block) on a mesh, a leaf's
    squares count on the ranks that own its block -- the first along
    every axis it is whole on -- and the sum runs over the mesh: the
    norm of the whole tensors, the same on every rank."""
    mesh = sharding.active()
    if specs is None or mesh is None:
        leaves = tree.values() if isinstance(tree, Mapping) else tree
        return _sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
    total = None
    for name, x in tree.items():
        if sharding.owns(mesh, specs[name]):
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(tree.values())).device)
    return _sqrt(sharding.all_reduce(total, mesh.axis_names))


_NO_DECAY = ("scale", "bias", "a_log", "dt_bias", "d_skip", "norm_scale",
             "conv_b", "bq", "bk", "bv", "b1", "b2")


def decays(name: str, param: torch.Tensor) -> bool:
    """The reference's rule, on ITS leaf: decayed unless the leaf's name
    is in ``_NO_DECAY`` or the leaf has fewer than 2 dims.  A block leaf
    is stacked ``(L, ...)`` there, so a per-layer vector here (a 1-D
    leaf of ``blocks.i``) is 2-D there and decays unless its name is
    listed."""
    _, layer = reference_path(name)
    ref_ndim = param.dim() + (layer is not None)
    return name.split(".")[-1] not in _NO_DECAY and ref_ndim >= 2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: nn.Module,
                 grads: Mapping[str, torch.Tensor], state: AdamWState):
    """One AdamW step, in place. Returns (params, new_state, metrics).

    With ``moment_dtype="int8"`` the momentum is dequantized, updated in
    float32, and re-quantized row-wise each step (8-bit Adam).  On a
    mesh every leaf is this rank's block (the update is elementwise) and
    the clipping norm is the whole tree's (:func:`global_norm`); an
    int8 momentum whose rows are split takes the whole row's scale
    (:func:`_split_row_amax`)."""
    specs = {n: sharding.spec_of(p) for n, p in params.named_parameters()}
    gnorm = global_norm(grads, specs if any(
        v is not None for v in specs.values()) else None)
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                       / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step_f = step.float()
    c1 = 1 - torch.pow(b1, step_f)
    c2 = 1 - torch.pow(b2, step_f)
    q8 = cfg.moment_dtype == "int8"
    amax = _split_row_amax(params, grads, state.mu, clip, b1) if q8 else {}
    new_mu, new_nu = {}, {}
    for name, p in params.named_parameters():
        mu, nu = state.mu[name], state.nu[name]
        g_f = grads[name].float() * clip
        mu_f = _q8_load(mu) if q8 else mu.float()
        nu_f = nu.float()
        mu_f = b1 * mu_f + (1 - b1) * g_f
        nu_f = b2 * nu_f + (1 - b2) * g_f * g_f
        upd = (mu_f / c1) / (_sqrt(nu_f / c2) + cfg.eps)
        if decays(name, p):
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        if q8:
            new_mu[name] = _q8_store(mu_f, amax.get(name))
            new_nu[name] = nu.copy_(nu_f)
        else:
            new_mu[name] = mu.copy_(mu_f)
            new_nu[name] = nu.copy_(nu_f)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=new_mu, nu=new_nu), metrics
