"""Sharding rules of the reference's parallel layer, and the placement
and layouts of the port's sharded model.

The reference shards over its production mesh (FSDP + TP + EP + SP):

=========  =====================  ======================================
logical    mesh axes              used for
=========  =====================  ======================================
``batch``  ("pod", "data")        data parallelism (activations, tokens)
``fsdp``   ("pod", "data")        weight/optimizer sharding (ZeRO-3)
``tp``     ("model",)             d_ff / flattened head / vocab dims
``seq``    ("model",)             sequence parallelism inside attention
``expert`` ("model",)             MoE expert parallelism
=========  =====================  ======================================

The rules are pure logic and are copied: a spec is a tuple with one
entry per tensor dim -- a mesh-axis name, a tuple of names, or ``None``
-- the counterpart of the reference's ``PartitionSpec``; an axis whose
size does not divide the dim is dropped for that dim.  The rules read
only ``mesh.axis_names`` and ``mesh.shape``, so they take the port's
:class:`~repro_torch.launch.mesh.DeviceMesh` or any mesh-like object.

Placement (:func:`place_params`, :func:`place_batch`,
:func:`place_cache`) hands each rank its block of every tensor under
those specs; a placed parameter remembers its spec (``_spec``).  The
sharded model is explicit, not propagated: at each product a stored
weight is brought to the block the product reads (:func:`weight`: FSDP's
gather over the batch axes, nothing over the tp axes it keeps), the
attention and the MLP are column- then row-parallel over the tp axes
(:func:`copy_in`, :func:`reduce_out`), each rank's kernels see plain
tensors of its local heads, and the batch is split over the ``batch``
axes before the step.  The Mamba-2 mixer is split the same way by its
SSD heads (:func:`ssd_head_axes`): each rank reads the whole ``in_proj``
and conv weights and uses its heads' columns and B and C whole, so the
gradients of those reads sum over the heads' axes (``weight(...,
partial=)``).  The experts are split over ``expert`` as the reference
stores them (:func:`expert_axes`): activations stay whole over
``model``, so each rank routes every token it holds, runs only its own
experts' slots of the ``(E, C, d)`` buffer and adds its partial combine,
and the sum over the expert axes is a :func:`reduce_out` -- no
all-to-all.  Capacity and drops are the unsharded call's: an
assignment's slot counts the assignments of the lower batch ranks to
its expert.  ``seq`` is not in this slice: tensors the reference
constrains by it keep the layout they get, and the KV cache, which the
reference splits by ``seq`` over ``model``, holds each rank's heads
there instead (:func:`cache_layout`), the layout the decode kernels
read -- an int8 cache's per-token scales and the encoder-decoder's
cross K/V with them; the recurrent state holds each rank's SSD heads.
For the same reason serve mode stores attention's weights by heads
alone, not over the reference's (data, model), the mixer's by SSD heads
and a moe block's shared expert as the dense MLP (:func:`place_params`),
so a decode step gathers no weight.  Every family runs on a mesh of
more than one rank: the dense, moe, ssm, hybrid and vlm families and the
encoder-decoder (whisper: its cross-attention split by heads as its
self-attention, its GELU MLPs as the dense MLP), in the compute dtype
or with an int8 KV cache.

:func:`use_mesh` keeps the reference's mesh context, process-wide
rather than thread-local: on the card autograd runs a backward (and
``torch.utils.checkpoint``'s recompute in it) on a thread of its own,
which must see the mesh the forward ran under.  With no mesh, or a
mesh of one rank, every function here is the identity and the model
runs as it does unsharded.
"""

from __future__ import annotations

import contextlib
import types
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.parallel import comm

Spec = Tuple[Any, ...]

#: the mesh context: one a process (see the module docstring)
_ctx = types.SimpleNamespace()


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def mesh_logical_axes(mesh, mode: str = "train") -> Dict[str, Any]:
    """Logical-axis -> mesh-axis mapping.

    ``train``: FSDP over (pod, data) + TP over model + SP over model.
    ``serve``: weight-stationary 2-D TP -- feature dims shard over
    (data, model) jointly, no fsdp gathering; batch rides the pod axis
    when present (the KV cache keeps its own batch/data sharding).
    """
    names = mesh.axis_names
    dp: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
    dp_ax: Any = dp if len(dp) > 1 else (dp[0] if dp else None)
    tp = "model" if "model" in names else None
    flat = tuple(names) or None
    if mode == "serve":
        tp2 = tuple(a for a in ("data", "model") if a in names) or None
        return {"batch": "pod" if "pod" in names else None,
                "fsdp": None, "tp": tp2, "seq": tp, "expert": tp,
                "edata": "data" if "data" in names else None,
                "flat": flat}
    return {"batch": dp_ax, "fsdp": dp_ax, "tp": tp, "seq": tp,
            "expert": tp, "flat": flat}


# ----------------------------------------------------------------------
# mesh context
# ----------------------------------------------------------------------

@contextlib.contextmanager
def use_mesh(mesh, mode: str = "train"):
    """Make ``mesh`` (and ``mode``) current in this process; the outer
    context's come back on exit."""
    prev = getattr(_ctx, "mesh", None)
    prev_mode = getattr(_ctx, "mode", "train")
    _ctx.mesh = mesh
    _ctx.mode = mode
    try:
        yield
    finally:
        _ctx.mesh = prev
        _ctx.mode = prev_mode


def current_mesh():
    return getattr(_ctx, "mesh", None)


def current_mode() -> str:
    return getattr(_ctx, "mode", "train")


def _fallback_axes(mesh, dim: int, axes):
    """Progressively drop leading axes of a tuple until divisible."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    while axes:
        if dim % _axis_size(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[1:]
    return None


def constrain(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical axis
    names; ``x`` comes back unchanged, and no model module calls it.

    The port's sharded model is laid out explicitly, so each of the
    reference's sites holds the layout its constraint names without a
    call: the projections' ``(batch, -, tp)`` (its ``attention.py``
    37-41, 66-68, 105-107, 163-165) and the MLP's hidden ``tp`` dim
    (``mlp.py`` 27, 45) come from their column-parallel weights
    (:func:`weight`, :func:`copy_in`); the residual stream's ``(batch,
    seq, -)`` and the Megatron-SP boundaries (``transformer.py`` 60, 65,
    127, 132, 157) have the batch split by :func:`place_batch` before
    the step, and ``seq`` is not in this slice, so the sequence stays
    whole.  The moe sites (``moe.py`` 114-135) hold theirs the same way:
    the buffer is this rank's experts (:func:`expert_axes`), its ``d``
    whole, and the combine's output is this rank's rows.  The whisper
    sites (``whisper.py`` 79-141) hold theirs the same way: the frames'
    and tokens' ``(batch, seq, -)`` from :func:`place_batch`, the
    encoder's and the decoder's attention and GELU MLP from their
    column-parallel weights, cross-attention's K/V of the encoder states
    at this rank's heads.
    With no mesh it is the identity, as the reference's is."""
    return x


# ----------------------------------------------------------------------
# parameter sharding rules
# ----------------------------------------------------------------------

#: param-name -> logical axes per dim (matched by the *last* path element,
#: with container names joined for disambiguation).
_PARAM_RULES: Dict[str, Sequence[Optional[str]]] = {
    # embedding / head
    "tok": ("tp", "fsdp"),
    "head": ("fsdp", "tp"),
    # attention
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    # dense mlp
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "w1": ("fsdp", "tp"), "b1": ("tp",),
    "w2": ("tp", "fsdp"), "b2": (None,),
    # moe (3-D expert tensors; matched with the moe/ prefix below)
    "router": ("fsdp", None),
    "moe/w_gate": ("expert", "fsdp", None),
    "moe/w_up": ("expert", "fsdp", None),
    "moe/w_down": ("expert", None, "fsdp"),
    # mamba2
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"), "conv_b": ("tp",),
    "a_log": (None,), "dt_bias": (None,), "d_skip": (None,),
    "norm_scale": ("tp",),
    # norms
    "scale": (None,), "bias": (None,),
}


def _path_str(path) -> str:
    """A leaf's path as the reference's ``a/b/c`` string: a string is
    taken as it is, a sequence of keys joined by ``/``."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def _rule_for(path_str: str, ndim: int) -> Sequence[Optional[str]]:
    leaf = path_str.rsplit("/", 1)[-1]
    # int8-Adam moments keep the parameter's shape: route "q"/"scale"
    # leaves to the parent parameter's rule (scale has last dim 1, which
    # the divisibility fallback leaves unsharded automatically).
    if (("/mu/" in path_str or path_str.startswith("mu/")
         or "/nu/" in path_str or path_str.startswith("nu/"))
            and leaf in ("q", "scale")):
        return _rule_for(path_str.rsplit("/", 1)[0], ndim)
    # stacked layer params gain a leading layer dim
    lead = 1 if ("blocks/" in path_str or "encoder/" in path_str
                 or "decoder/" in path_str) else 0
    if "moe/" in path_str and "moe/" + leaf in _PARAM_RULES:
        rule = _PARAM_RULES["moe/" + leaf]
    elif leaf in _PARAM_RULES:
        rule = _PARAM_RULES[leaf]
    else:
        rule = (None,) * (ndim - lead)
    full = (None,) * lead + tuple(rule)
    if len(full) < ndim:   # e.g. shared-expert swiglu under moe
        full = full + (None,) * (ndim - len(full))
    return full[:ndim]


#: serve-mode overrides: expert weights stay resident -- experts over
#: `model`, expert-ff over `data` (never gathered during decode).
_SERVE_OVERRIDES: Dict[str, Sequence[Optional[str]]] = {
    "moe/w_gate": ("expert", None, "edata"),
    "moe/w_up": ("expert", None, "edata"),
    "moe/w_down": ("expert", "edata", None),
}


def param_spec(mesh, path, leaf, mode: str = "train") -> Spec:
    """Spec of one leaf of the reference's parameter tree: ``path`` its
    reference path (``"blocks/attn/wq"``, or the keys), ``leaf``
    anything with ``.shape`` and ``.ndim`` -- a block leaf at its stacked
    ``(L, ...)`` shape."""
    la = mesh_logical_axes(mesh, mode)
    ps = _path_str(path)
    rule = _rule_for(ps, leaf.ndim)
    if mode == "serve":
        leaf_name = ps.rsplit("/", 1)[-1]
        key = "moe/" + leaf_name if "moe/" in ps else leaf_name
        if key in _SERVE_OVERRIDES:
            lead = 1 if ("blocks/" in ps or "encoder/" in ps
                         or "decoder/" in ps) else 0
            rule = (None,) * lead + tuple(_SERVE_OVERRIDES[key])
            rule = rule[:leaf.ndim]
    spec = []
    for dim, name in zip(leaf.shape, rule):
        axes = la.get(name) if name else None
        spec.append(_fallback_axes(mesh, dim, axes))
    return tuple(spec)


class _Stacked:
    """The reference's stacked ``(L, ...)`` shape of a port leaf."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def param_shardings(mesh, params: nn.Module, mode: str = "train"
                    ) -> Dict[str, Spec]:
    """``{port parameter name: spec}`` for a port module (an ``LM`` or
    ``Whisper``).  Each leaf takes the reference rule of the leaf it is
    a slice of: a block's per-layer tensor is one layer of a stacked
    ``(L, ...)`` leaf there, so its spec is that leaf's without the
    layer entry."""
    from repro_torch.models.common import reference_path
    n_layers: Dict[str, int] = {}
    for name, _ in params.named_parameters():
        path, layer = reference_path(name)
        if layer is not None:
            n_layers[path] = max(n_layers.get(path, 0), layer + 1)
    out = {}
    for name, t in params.named_parameters():
        path, layer = reference_path(name)
        if layer is None:
            out[name] = param_spec(mesh, path, t, mode)
        else:
            stacked = _Stacked((n_layers[path],) + tuple(t.shape))
            out[name] = param_spec(mesh, path, stacked, mode)[1:]
    return out


# ----------------------------------------------------------------------
# batch / cache shardings
# ----------------------------------------------------------------------

def _spec_with_div(mesh, shape, logical, mode: str = "train") -> Spec:
    la = mesh_logical_axes(mesh, mode)
    out = []
    for dim, name in zip(shape, logical):
        axes = la.get(name) if name else None
        out.append(_fallback_axes(mesh, dim, axes))
    return tuple(out)


_BATCH_RULES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "loss_mask": ("batch", None),
    "frames": ("batch", None, None),
    "vision_embeds": ("batch", None, None),
}

_CACHE_RULES = {
    "k": (None, "kv_batch", None, "seq", None),
    "v": (None, "kv_batch", None, "seq", None),
    "k_scale": (None, "kv_batch", None, "seq", None),
    "v_scale": (None, "kv_batch", None, "seq", None),
    "cross_k": (None, "kv_batch", None, "seq", None),
    "cross_v": (None, "kv_batch", None, "seq", None),
    "ssm_h": (None, "kv_batch", None, "tp", None),
    "ssm_conv": (None, "kv_batch", None, "tp"),
    "len": (None,),
}


def batch_shardings(mesh, batch: Mapping[str, Any]) -> Dict[str, Spec]:
    """``{name: spec}`` of a batch of tensors (or shape stand-ins)."""
    out = {}
    for name, leaf in batch.items():
        ndim = len(leaf.shape)
        rule = _BATCH_RULES.get(name, ("batch",) + (None,) * (ndim - 1))
        out[name] = _spec_with_div(mesh, leaf.shape, rule)
    return out


def cache_shardings(mesh, cache: Mapping[str, Any]) -> Dict[str, Spec]:
    """KV/state cache specs: batch over (pod, data), seq over model --
    identical in train and serve modes."""
    la = {"kv_batch": tuple(a for a in ("pod", "data")
                            if a in mesh.axis_names) or None,
          "seq": "model" if "model" in mesh.axis_names else None,
          "tp": "model" if "model" in mesh.axis_names else None}
    out = {}
    for name, leaf in cache.items():
        rule = _CACHE_RULES.get(name, (None,) * len(leaf.shape))
        out[name] = tuple(
            _fallback_axes(mesh, dim, la.get(r) if r else None)
            for dim, r in zip(leaf.shape, rule))
    return out


def replicated(mesh) -> Spec:
    """The empty spec: every dim whole on every device."""
    return ()


# ----------------------------------------------------------------------
# the sharded model: layouts, placement, and the products' boundaries
# ----------------------------------------------------------------------

def active():
    """The current mesh when it has more than one rank, else ``None``
    (no mesh, or a mesh of one rank: the unsharded model)."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def batch_axes(mesh, n: int, mode: Optional[str] = None
               ) -> Tuple[str, ...]:
    """The axes a batch of ``n`` rows is split over: the ``batch`` axes,
    leading ones dropped until they divide ``n``."""
    la = mesh_logical_axes(mesh, mode or current_mode())
    return mesh.axes(_fallback_axes(mesh, n, la["batch"]))


def kv_batch_axes(mesh, n: int) -> Tuple[str, ...]:
    """The axes a decode cache's ``n`` lanes are split over (the
    reference's ``kv_batch``: pod and data)."""
    kv = tuple(a for a in ("pod", "data") if a in mesh.axis_names) or None
    return mesh.axes(_fallback_axes(mesh, n, kv))


def head_axes(mesh, cfg, mode: Optional[str] = None) -> Tuple[str, ...]:
    """The axes attention's heads are split over: the ``tp`` axes not
    holding the cache's lanes, leading ones dropped until they divide
    the KV heads (a split is whole heads, and a query head group stays
    with its KV head); none when nothing divides, and attention is whole
    on every rank."""
    la = mesh_logical_axes(mesh, mode or current_mode())
    kv = {a for a in ("pod", "data") if a in mesh.axis_names}
    tp = tuple(a for a in mesh.axes(la["tp"]) if a not in kv)
    return mesh.axes(_fallback_axes(mesh, cfg.n_kv_heads, tp or None))


def expert_axes(w_gate: torch.Tensor) -> Tuple[str, ...]:
    """The axes a moe layer's experts are stored over: those of its
    placed ``w_gate``'s dim 0 (E), ``expert`` (``model``) by the
    reference's rules; none with no mesh, or when the axis does not
    divide E (``_fallback_axes`` leaves the experts whole, and every
    rank runs all of them)."""
    return axes_of(w_gate, 0)


def ssd_dims(cfg) -> Tuple[int, int, int]:
    """A Mamba-2 mixer's (d_inner, SSD heads, state dim N): the heads
    are ``d_inner // head_dim`` (48 at mamba2-780m, 50 at hymba-1.5b),
    not ``cfg.n_heads``."""
    s = cfg.ssm
    d_inner = s.d_inner_override or (s.expand * cfg.d_model)
    return d_inner, d_inner // s.head_dim, s.state_dim


def ssd_head_axes(mesh, cfg, mode: Optional[str] = None
                  ) -> Tuple[str, ...]:
    """The axes the Mamba-2 mixer's SSD heads are split over: the ``tp``
    axes not holding the cache's lanes, leading ones dropped until they
    divide the SSD heads; none when nothing divides, and the mixer is
    whole on every rank."""
    la = mesh_logical_axes(mesh, mode or current_mode())
    kv = {a for a in ("pod", "data") if a in mesh.axis_names}
    tp = tuple(a for a in mesh.axes(la["tp"]) if a not in kv)
    return mesh.axes(_fallback_axes(mesh, ssd_dims(cfg)[1], tp or None))


#: the cache entries whose dim 2 holds the KV heads
_HEAD_ENTRIES = ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v")


def cache_layout(mesh, cfg, cache: Mapping[str, Any],
                 mode: Optional[str] = None) -> Dict[str, Spec]:
    """The port's spec of each entry of a decode cache: the reference's
    (:func:`cache_shardings`), lanes over ``kv_batch``, with its ``seq``
    and ``tp`` entries (not in this slice) replaced by the layout the
    step reads; ``len`` whole on every rank.

    * ``k``, ``v``, an int8 cache's ``k_scale``/``v_scale`` and the
      encoder-decoder's ``cross_k``/``cross_v``: the KV-head dim over
      :func:`head_axes` (the reference's ``seq`` on the positions
      dropped).
    * ``ssm_h`` (L, B, nh, N, P): the SSD-head dim over
      :func:`ssd_head_axes` (the reference's ``tp`` on the state dim N
      dropped).
    * ``ssm_conv`` (L, B, W-1, conv_ch): the entry on the channels names
      :func:`ssd_head_axes`, but the block is not contiguous: it is the
      x channels of this rank's heads followed by B and C whole
      (:func:`_conv_block`), where the reference splits the channels
      contiguously over ``tp``, which would leave B and C on one rank.
    """
    ref = cache_shardings(mesh, cache)
    heads = head_axes(mesh, cfg, mode) if not cfg.attn_free else ()
    ssd = ssd_head_axes(mesh, cfg, mode) if cfg.has_ssm else ()
    out = {}
    for name, leaf in cache.items():
        spec = list(ref[name])
        if name == "len":
            pass
        elif name in _HEAD_ENTRIES:
            spec[2], spec[3] = heads or None, None
        elif name == "ssm_h":
            spec[2], spec[3] = ssd or None, None
        elif name == "ssm_conv":
            spec[3] = ssd or None
        else:
            raise ValueError(f"cache entry {name!r} has no placement on a "
                             f"mesh of more than one rank ({_HEAD_ENTRIES}, "
                             f"ssm_h, ssm_conv and len do)")
        out[name] = tuple(spec)
    return out


def _conv_block(t: torch.Tensor, mesh, axes, d_inner: int
                ) -> torch.Tensor:
    """This rank's channels (last dim) of a Mamba-2 conv tensor whole on
    that dim (``[x | B | C]``, x of ``d_inner`` channels): the x
    channels of its SSD heads over ``axes``, then B and C whole."""
    x = comm.take(t.narrow(-1, 0, d_inner), mesh, t.dim() - 1, axes)
    return torch.cat([x, t.narrow(-1, d_inner, t.shape[-1] - d_inner)], -1)


def _rebind(module: nn.Module, name: str, t: torch.Tensor, spec) -> None:
    """Replace parameter ``name`` of ``module`` by ``t`` with ``spec``."""
    owner, _, leaf = name.rpartition(".")
    sub = module.get_submodule(owner) if owner else module
    old = sub._parameters[leaf]
    p = nn.Parameter(t, requires_grad=old.requires_grad)
    p._spec = spec
    sub._parameters[leaf] = p


#: attention's parameters and the dim of each that holds the heads
_HEAD_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0,
              "bv": 0}
#: the modules holding attention (whisper's decoder has two a layer)
_ATTN_OWNERS = ("attn", "self_attn", "cross_attn")
#: the Mamba-2 mixer's parameters whose first dim is d_inner, which
#: serve mode stores by SSD heads; its others it stores whole
_SSD_HEAD_ROWS = ("out_proj", "norm_scale")


@torch.no_grad()
def place_params(mesh, module: nn.Module, cfg, mode: str = "train"
                 ) -> nn.Module:
    """Each parameter of ``module`` (whole on every rank, the same
    values) replaced by this rank's block under :func:`param_shardings`,
    which it remembers as ``_spec``; the module is returned.  A mesh of
    one rank leaves it as it is.

    In serve mode attention's head dim is stored over :func:`head_axes`
    alone, not over the reference's (data, model): the decode step runs
    attention on the cache's lanes (over ``data``) at its local heads,
    which would otherwise gather the ``data`` blocks of every layer's
    weights each step.  Each ``data`` rank holds a copy of its heads'
    weights instead.  The Mamba-2 mixer likewise: ``out_proj``'s rows
    and ``norm_scale`` over :func:`ssd_head_axes`, and ``in_proj`` and
    the conv weights, whose columns do not line up with the heads
    (``[z | x | B | C | dt]``), whole on every rank.  A moe block's
    shared expert, which the reference's ``moe/`` rule stores as the
    experts (its ``w_gate`` d over ``model``), is stored in serve mode
    as the dense MLP, its d_ff over the tp axes; in train mode it keeps
    the reference's layout and is read whole."""
    if mesh.size == 1:
        return module
    specs = param_shardings(mesh, module, mode)
    if mode == "serve":
        params = dict(module.named_parameters())

        def entry(axes):
            return axes[0] if len(axes) == 1 else (axes or None)
        heads = entry(head_axes(mesh, cfg, mode)) \
            if not cfg.attn_free else None
        ssd = entry(ssd_head_axes(mesh, cfg, mode)) if cfg.has_ssm else None
        for name, spec in specs.items():
            owner, _, leaf = name.rpartition(".")
            owner = owner.rpartition(".")[2]
            spec = list(spec)
            if owner in _ATTN_OWNERS and leaf in _HEAD_DIMS:
                spec[_HEAD_DIMS[leaf]] = heads
            elif owner == "ssm":
                spec = [None] * len(spec)
                if leaf in _SSD_HEAD_ROWS:
                    spec[0] = ssd
            elif owner == "shared":
                spec = list(param_spec(mesh, leaf, params[name], mode))
            specs[name] = tuple(spec)
    for name, p in list(module.named_parameters()):
        _rebind(module, name, comm.local_of(p.detach(), mesh, specs[name]),
                specs[name])
    return module


def placed_like(module: nn.Module, placed: nn.Module) -> nn.Module:
    """``module`` (a parameter module of the same config, on the meta
    device or whole) with every parameter an empty tensor of
    ``placed``'s block shape and device, in ``module``'s own dtype, and
    ``placed``'s specs; returned."""
    src = dict(placed.named_parameters())
    for name, p in list(module.named_parameters()):
        ref = src[name]
        _rebind(module, name, torch.empty(ref.shape, dtype=p.dtype,
                                          device=ref.device),
                getattr(ref, "_spec", None))
    return module


def place_batch(mesh, batch: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch whole on every rank, by
    :func:`batch_shardings`."""
    specs = batch_shardings(mesh, batch)
    return {k: comm.local_of(v, mesh, specs[k]) for k, v in batch.items()}


@torch.no_grad()
def place_cache(mesh, cache: Mapping[str, torch.Tensor], cfg,
                mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """This rank's block of every entry of a decode cache whole on every
    rank, by :func:`cache_layout`."""
    specs = cache_layout(mesh, cfg, cache, mode)
    out = {}
    for k, v in cache.items():
        spec = list(specs[k])
        if k == "ssm_conv":
            conv, spec[3] = spec[3], None
        v = comm.local_of(v, mesh, spec)
        if k == "ssm_conv":
            v = _conv_block(v, mesh, conv, ssd_dims(cfg)[0]).contiguous()
        out[k] = v
    return out


@torch.no_grad()
def gather_cache(mesh, cache: Mapping[str, torch.Tensor], cfg,
                 mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The whole decode cache of this rank's block ``cache`` (the inverse
    of :func:`place_cache`; every rank of the mesh takes part)."""
    b = cache["len"].shape[0]
    d_inner, nh, n = ssd_dims(cfg) if cfg.has_ssm else (0, 0, 0)
    heads = dict.fromkeys(_HEAD_ENTRIES, cfg.n_kv_heads)
    heads["ssm_h"] = nh
    whole = {}
    for k, v in cache.items():
        shape = list(v.shape)
        if k != "len":
            shape[1] = b
        if k in heads:
            shape[2] = heads[k]
        elif k == "ssm_conv":
            shape[3] = d_inner + 2 * n
        whole[k] = _Stacked(shape)
    specs = cache_layout(mesh, cfg, whole, mode)
    out = {}
    for k, v in cache.items():
        spec = list(specs[k])
        if k == "ssm_conv":
            d_l = v.shape[-1] - 2 * n
            x = comm.all_gather(v[..., :d_l], mesh, spec[3], v.dim() - 1)
            v, spec[3] = torch.cat([x, v[..., d_l:]], -1), None
        out[k] = comm.gather_full(v, mesh, spec)
    return out


def owns(mesh, spec: Optional[Spec]) -> bool:
    """Whether this rank holds the first copy of its block of a tensor
    under ``spec``: its index is 0 along every axis the spec leaves the
    tensor whole on."""
    split = set()
    for entry in spec or ():
        split.update(mesh.axes(entry))
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in split)


def spec_of(t: torch.Tensor) -> Optional[Spec]:
    """A placed parameter's spec (``None`` for a tensor not placed)."""
    return getattr(t, "_spec", None)


_KEEP = ...


def weight(t: torch.Tensor, *dst, partial=()) -> torch.Tensor:
    """A parameter as the product at hand reads it: with no mesh ``t``;
    on a mesh, ``t``'s stored block brought to the spec ``dst`` (one
    entry a dim; ``...`` keeps the stored entry), whose gradient sums
    over the axes the batch is split over (:func:`split_batch`).

    ``partial`` names axes whose ranks each use only their part of what
    they read (the Mamba-2 mixer reads its weights whole and uses its
    SSD heads' part, B and C for its heads only): the gradient sums over
    them too.  Only a read that every rank of ``partial`` gets whole may
    name them (a block that differs along them would be summed with
    other blocks)."""
    mesh = active()
    spec = spec_of(t)
    if mesh is None:
        if spec is not None:
            raise ValueError("a parameter placed on a mesh is used with no "
                             "mesh of more than one rank active")
        return t
    if spec is None:
        raise ValueError(f"a parameter of shape {tuple(t.shape)} is used "
                         f"on {mesh} without a placement")
    dst = tuple(s if d is _KEEP else d for s, d in zip(spec, dst))
    sum_axes = mesh.axes(batch_split_axes() + mesh.axes(partial))
    return comm.Gather.apply(t, mesh, spec, dst, sum_axes)


def axes_of(t: torch.Tensor, dim: int) -> Tuple[str, ...]:
    """The mesh axes a placed parameter's dim is stored over (none with
    no mesh)."""
    mesh = active()
    spec = spec_of(t)
    return () if mesh is None or spec is None else mesh.axes(spec[dim])


def copy_in(x: torch.Tensor, axes) -> torch.Tensor:
    """The input of a product split over ``axes`` (column-parallel):
    ``x``; its gradient sums over them."""
    mesh = active()
    if mesh is None or not mesh.axes(axes):
        return x
    return comm.CopyIn.apply(x, mesh, axes)


def reduce_out(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes`` of a row-parallel product's partial
    outputs."""
    mesh = active()
    if mesh is None or not mesh.axes(axes):
        return x
    return comm.ReduceOut.apply(x, mesh, axes)


def sum_shared(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes`` of each rank's partial ``x``, which each rank
    then uses for its own part (the gated norm's sum of squares over the
    SSD heads): an all-reduce whose gradient is all-reduced too."""
    return copy_in(reduce_out(x, axes), axes)


def extent(axes) -> int:
    """Ranks along ``axes`` on the active mesh (1 with none)."""
    mesh = active()
    return 1 if mesh is None else mesh.extent(axes)


def block_of(n: int, axes) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of a dim of ``n`` split over
    ``axes`` (all of it with no mesh)."""
    mesh = active()
    return (0, n) if mesh is None else comm.block(mesh, n, axes)


def relayout(t: torch.Tensor, dim: int, src, dst) -> torch.Tensor:
    """:func:`comm.relayout` on the active mesh (``t`` with none)."""
    mesh = active()
    return t if mesh is None else comm.relayout(t, mesh, dim, src, dst)


def to_lanes(t: torch.Tensor, n: int, back: bool = False) -> torch.Tensor:
    """A decode step's ``t`` (rows first) from the step's rows of a
    batch of ``n`` lanes (:func:`batch_axes`) to this rank's cache lanes
    (:func:`kv_batch_axes`), or back with ``back`` (``t`` with no
    mesh)."""
    mesh = active()
    if mesh is None:
        return t
    rows, lanes = batch_axes(mesh, n), kv_batch_axes(mesh, n)
    return comm.relayout(t, mesh, 0, *((lanes, rows) if back
                                       else (rows, lanes)))


def all_reduce(t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """:func:`comm.all_reduce` on the active mesh (``t`` with none); no
    gradient."""
    mesh = active()
    return t if mesh is None else comm.all_reduce(t, mesh, axes, op)


def batch_split_axes() -> Tuple[str, ...]:
    """The axes :func:`split_batch` says the batch is split over (none
    outside it)."""
    return getattr(_ctx, "sum_axes", ())


@contextlib.contextmanager
def split_batch(axes: Tuple[str, ...]):
    """Within: the batch is split over ``axes``, so a weight's gradient
    sums over them."""
    prev = batch_split_axes()
    _ctx.sum_axes = tuple(axes)
    try:
        yield
    finally:
        _ctx.sum_axes = prev
