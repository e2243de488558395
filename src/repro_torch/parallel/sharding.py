"""Sharding rules of the reference's parallel layer, on the port's one
device.

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

On one device every constraint is the identity, as the reference's is
with no mesh active: :func:`constrain` returns its input.
:func:`use_mesh` keeps the reference's thread-local mesh context (the
port's models read nothing from it).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from torch import nn

from repro_torch.models.common import reference_path

Spec = Tuple[Any, ...]

_ctx = threading.local()


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
    """Make ``mesh`` (and ``mode``) current on this thread; the outer
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
    names: on one device every constraint is the identity, so ``x``
    comes back unchanged."""
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
