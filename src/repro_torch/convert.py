"""Reference parameters and quantized tensors -> the port's objects.

:func:`params_from_jax`: the input is the nested dict the reference's ``init_lm`` returns, brought
to the host as numpy arrays (``jax.device_get(params)``): ``embed``
(``tok``, and ``head`` when untied), ``blocks`` with every leaf stacked
``(L, ...)`` along the layer axis (``norm1``, ``attn``, ``norm2``,
``mlp``; an ssm model's ``norm1`` and ``ssm``; a hybrid model's
``norm1``, ``attn``, ``ssm``, ``norm2`` and ``mlp``), and
``final_norm``.  Taking numpy only
keeps JAX out of the port.

:func:`qtensor_from_numpy`: the planes of a reference ``QTensor``
(``jax.device_get`` of each) become a port :class:`QTensor` with the
same bytes, so a test can quantize once and feed both packages.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.quant import PLANES, QTensor, plane_layout

__all__ = ["params_from_jax", "qtensor_from_numpy"]


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    arr = np.array(src, dtype=np.float32)      # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {arr.shape}, port expects "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr).to(dst.dtype))


@torch.no_grad()
def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig,
                    device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> LM:
    """Unstack the ``(L, ...)`` blocks into per-layer modules on
    ``device``.  Weights are stored in ``dtype`` (default: the config's
    compute dtype) -- the values the reference gets from its cast at
    each use; norm scales stay float32 as the reference reads them."""
    if dtype is not None and dtype != cfg.compute_dtype:
        raise ValueError(f"dtype {dtype} differs from the config's "
                         f"{cfg.compute_dtype}; replace cfg.dtype instead")
    lm = LM(cfg, torch.device("cpu"))
    emb = np_params["embed"]
    _copy(lm.embed.tok, emb["tok"], "embed.tok")
    if not cfg.tie_embeddings:
        _copy(lm.embed.head, emb["head"], "embed.head")
    blocks = np_params["blocks"]
    for i, blk in enumerate(lm.blocks):
        # the block's modules are the reference's subtrees, one level
        # deep: "attn.wq" is blocks["attn"]["wq"][i]
        for name, w in blk.named_parameters():
            branch, leaf = name.split(".")
            _copy(w, blocks[branch][leaf][i], name)
    _copy(lm.final_norm.scale, np_params["final_norm"]["scale"],
          "final_norm.scale")
    return lm.to(device)


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
