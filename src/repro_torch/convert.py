"""Reference parameters and quantized tensors -> the port's objects.

:func:`params_from_jax`: the input is the nested dict the reference's
``init_lm`` (or, for an encoder-decoder, ``init_whisper``) returns,
brought to the host as numpy arrays (``jax.device_get(params)``).  A
decoder's tree is ``embed`` (``tok``, and ``head`` when untied),
``blocks`` with every leaf stacked ``(L, ...)`` along the layer axis
(``norm1``, ``attn``, ``norm2``, ``mlp``; a moe block's ``moe`` --
``router`` (L, d, E), ``w_gate``/``w_up`` (L, E, d, f), ``w_down`` (L,
E, f, d), ``shared`` -- with Arctic's ``mlp`` beside it; an ssm model's
``norm1`` and ``ssm``; a hybrid model's ``norm1``, ``attn``, ``ssm``,
``norm2`` and ``mlp``), and ``final_norm``.  Whisper's holds ``embed``,
``encoder`` (``norm1``, ``attn``, ``norm2``, ``mlp``) and ``decoder``
(``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``,
``mlp``), each stacked, ``enc_final_norm`` and ``final_norm``.  Taking
numpy only keeps JAX out of the port.

:func:`train_state_from_jax`: the reference's ``TrainState`` brought to
the host becomes the port's (float32 masters tracked by autograd,
moments per port parameter), through the checkpoint's layout
(:mod:`repro_torch.checkpoint.layout`), which names and stacks its
leaves as the reference's tree does.

:func:`qtensor_from_numpy`: the planes of a reference ``QTensor``
(``jax.device_get`` of each) become a port :class:`QTensor` with the
same bytes, so a test can quantize once and feed both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.layout import empty_train_state, load_train_state
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper
from repro_torch.quant import PLANES, QTensor, plane_layout

__all__ = ["params_from_jax", "qtensor_from_numpy", "train_state_from_jax"]


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    arr = np.array(src, dtype=np.float32)      # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {arr.shape}, port expects "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr).to(dst.dtype))


def _leaf(tree: Mapping[str, Any], name: str, layer: int) -> Any:
    """Layer ``layer`` of the stacked leaf a port parameter names:
    ``"moe.shared.w_gate"`` is ``tree["moe"]["shared"]["w_gate"][layer]``."""
    node = tree
    for part in name.split("."):
        node = node[part]
    return node[layer]


def _copy_stack(blocks: nn.ModuleList, tree: Mapping[str, Any],
                where: str) -> None:
    """Every layer's parameters from the reference's stacked subtree."""
    for i, blk in enumerate(blocks):
        for name, w in blk.named_parameters():
            _copy(w, _leaf(tree, name, i), f"{where}[{i}].{name}")


def _copy_norm(norm: nn.Module, tree: Mapping[str, Any], where: str) -> None:
    """A norm's leaves: RMSNorm "scale", LayerNorm "scale" and "bias",
    OLMo's non-parametric LN none (the reference's ``{}``)."""
    for name, w in norm.named_parameters():
        _copy(w, tree[name], f"{where}.{name}")


@torch.no_grad()
def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig,
                    device: torch.device,
                    dtype: Optional[torch.dtype] = None
                    ) -> Union[LM, Whisper]:
    """Unstack the ``(L, ...)`` blocks into per-layer modules on
    ``device``: an :class:`LM`, or a :class:`Whisper` for an
    encoder-decoder config.  Weights are stored in ``dtype`` (default:
    the config's compute dtype) -- the values the reference gets from
    its cast at each use; norm scales and a moe router stay float32 as
    the reference reads them."""
    if dtype is not None and dtype != cfg.compute_dtype:
        raise ValueError(f"dtype {dtype} differs from the config's "
                         f"{cfg.compute_dtype}; replace cfg.dtype instead")
    cpu = torch.device("cpu")
    model = Whisper(cfg, cpu) if cfg.is_encdec else LM(cfg, cpu)
    emb = np_params["embed"]
    _copy(model.embed.tok, emb["tok"], "embed.tok")
    if not cfg.tie_embeddings:
        _copy(model.embed.head, emb["head"], "embed.head")
    if cfg.is_encdec:
        _copy_stack(model.encoder, np_params["encoder"], "encoder")
        _copy_stack(model.decoder, np_params["decoder"], "decoder")
        _copy_norm(model.enc_final_norm, np_params["enc_final_norm"],
                   "enc_final_norm")
    else:
        _copy_stack(model.blocks, np_params["blocks"], "blocks")
    _copy_norm(model.final_norm, np_params["final_norm"], "final_norm")
    return model.to(device)


def qtensor_from_numpy(fmt: str, shape, values: Any, super_scales: Any,
                       sub_scales: Any = None, sub_mins: Any = None,
                       super_mins: Any = None,
                       device: Union[str, torch.device] = "cpu"
                       ) -> QTensor:
    """A port :class:`QTensor` holding the given planes bit for bit.

    Each plane must already have the dtype and shape the format gives
    it (values int8, or packed uint8 for q4_k/q2_k; sub-scales and
    sub-mins int8; super scales and mins float32); nothing is cast, so
    a plane of another type is refused rather than rounded."""
    k, n = (int(d) for d in shape)
    want = plane_layout(fmt, (k, n))
    given = dict(zip(PLANES, (values, super_scales, sub_scales, sub_mins,
                              super_mins)))
    planes = {}
    for name, arr in given.items():
        if name not in want:
            if arr is not None:
                raise ValueError(f"{fmt} has no {name} plane")
            continue
        if arr is None:
            raise ValueError(f"{fmt} needs its {name} plane")
        t = torch.from_numpy(np.array(arr))       # a copy, never a cast
        w_shape, w_dtype = want[name]
        if t.dtype != w_dtype or tuple(t.shape) != w_shape:
            raise ValueError(f"{fmt} {name}: {t.dtype}{tuple(t.shape)}, "
                             f"want {w_dtype}{w_shape}")
        planes[name] = t.to(device)
    return QTensor(fmt=fmt, shape=(k, n), **planes)


# ----------------------------------------------------------------------
# Training state
# ----------------------------------------------------------------------

def _reference_leaves(np_state) -> Dict[str, Tuple[np.ndarray, str]]:
    """The reference's ``TrainState`` (numpy leaves) by leaf name."""
    out: Dict[str, Tuple[np.ndarray, str]] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(f"{prefix}/{key}", node[key])
        elif hasattr(node, "q") and hasattr(node, "scale"):
            walk(f"{prefix}/q", node.q)
            walk(f"{prefix}/scale", node.scale)
        else:
            arr = np.asarray(node)
            out[prefix] = (arr, str(arr.dtype))

    walk(".params", np_state.params)
    walk(".opt/.step", np_state.opt.step)
    walk(".opt/.mu", np_state.opt.mu)
    walk(".opt/.nu", np_state.opt.nu)
    return out


def train_state_from_jax(np_state, cfg: ModelConfig, device: torch.device):
    """The reference's ``TrainState`` brought to the host
    (``jax.device_get(state)``) as the port's on ``device``: float32
    masters, and moments in the reference's storage (f32, bf16, or int8
    momentum beside bf16 variance)."""
    leaves = _reference_leaves(np_state)
    mu = next(v for k, v in leaves.items() if k.startswith(".opt/.mu/"))
    if any(k.startswith(".opt/.mu/") and k.endswith("/q") for k in leaves):
        moment_dtype = "int8"
    else:
        moment_dtype = "bf16" if mu[1] == "bfloat16" else "f32"
    state = empty_train_state(cfg, device, moment_dtype)
    return load_train_state(state, leaves)
