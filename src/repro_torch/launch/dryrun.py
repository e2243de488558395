"""Dry run on one device: every (arch x shape) cell's step on the meta
device, with its FLOPs, bytes and peak memory.

``python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
[--out dryrun_results.jsonl] [--append] [--skip-done]
[--microbatches M]``

The counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each cell for its 16x16 / 2x16x16 TPU mesh and reads XLA's
memory and cost analyses.  The port targets one H100 (mesh ``1x1``);
``--multi-pod`` and ``--both-meshes`` are refused by name.  For each
cell it

1. builds stand-ins on ``torch.device("meta")`` -- the counterpart of
   ``jax.eval_shape``, nothing is allocated: the train state (float32
   masters, AdamW moments, int8 ones where ``total_params() > 1e11``),
   the serving weights (the port's serving layout: matrices in the
   compute dtype), the batch and the decode cache;
2. runs the cell's real step on them: the train step of
   ``make_train_step`` with remat, the batched prefill, or one decode
   step, under :class:`~repro_torch.core.op_analysis.OpAnalysis`
   (kernels take their ``meta`` arms: K2 the blockwise attention, K3
   the blockwise attention over the full cache, K10 its plain version);
3. records the counted FLOPs under ``hlo_flops`` (the reference's key,
   so :func:`repro_torch.core.roofline.load_jsonl` readers take both
   packages' records; every matmul counted once per execution, the
   remat recompute and the backward included, ``cost_method``
   ``"counted"``), the dispatched ops' input and output bytes under
   ``hlo_bytes`` (the unfused upper bound), ``argument_size_in_bytes``
   (state + batch + cache) and ``bytes_per_device`` (the peak live set,
   by storage lifetime), the fit against the card's memory
   (``total_memory`` when a card is present, else an H100's 80 GiB) and
   ``fits_16g`` (the reference's TPU v5e capacity), ``model_flops``
   (6 N D for train, 2 N D for serving), ``chips`` 1, ``mesh`` ``"1x1"``
   and ``collective_bytes`` 0.

:func:`analyze_step` is the level underneath: (cfg, kind, batch, seq),
for a shape that is not in ``SHAPES``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.core.op_analysis import OpAnalysis, count_convert_pairs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import ModelConfig, trainable
from repro_torch.models.registry import build_model, param_module
from repro_torch.models.transformer import lm_prefill_batched
from repro_torch.models.whisper import decode_forward, encode
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import Q8Moment, init_adamw
from repro_torch.train import TrainConfig, TrainState, make_train_step

META = torch.device("meta")
#: an H100's memory, the capacity the dry run targets without a card
H100_BYTES = 80 * 1024 ** 3
#: the reference's per-chip capacity (TPU v5e), kept as ``fits_16g``
V5E_BYTES = 16 * 1024 ** 3


def _empty(shape, dtype, device=META) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, kind: str, batch: int, seq: int,
                device=META) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of a step: tokens (and labels for
    train) (B, S) int32, whisper's frames (B, S, d) and a vlm's
    vision_embeds (B, n, d) float32; one token (B,) for decode."""
    if kind in ("train", "prefill"):
        specs = {"tokens": _empty((batch, seq), torch.int32, device)}
        if kind == "train":
            specs["labels"] = _empty((batch, seq), torch.int32, device)
        if cfg.is_encdec:
            specs["frames"] = _empty((batch, seq, cfg.d_model),
                                     torch.float32, device)
        if cfg.n_vision_tokens:
            specs["vision_embeds"] = _empty(
                (batch, cfg.n_vision_tokens, cfg.d_model), torch.float32,
                device)
        return specs
    if kind != "decode":
        raise ValueError(f"kind {kind!r}: one of train, prefill, decode")
    # decode: one new token against a seq-deep cache
    return {"tokens": _empty((batch,), torch.int32, device)}


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of a cell (the reference's
    ``ShapeDtypeStruct`` dict)."""
    sh = SHAPES[shape_name]
    return batch_specs(cfg, sh["kind"], sh["global_batch"], sh["seq_len"])


def _model_flops(cfg: ModelConfig, shape_name: str) -> float:
    sh = SHAPES[shape_name]
    n_active = cfg.active_params()
    tokens = sh["global_batch"] * (sh["seq_len"]
                                   if sh["kind"] != "decode" else 1)
    if sh["kind"] == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def _attn_proj(cfg: ModelConfig, t: int) -> int:
    """q, k, v and o projections of ``t`` tokens."""
    d, hd = cfg.d_model, cfg.hd
    return 2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)


def _ssd_flops(cfg: ModelConfig, b: int, s: int) -> Tuple[int, int]:
    """(intra, inter) products of one SSD over (b, s): the intra-chunk
    pass's three einsums (C.B^T, y, states) and the inter-chunk output's
    matmul, S zero-padded to a multiple of ``Q = min(chunk, S)``."""
    sc = cfg.ssm
    d_in = sc.d_inner_override or sc.expand * cfg.d_model
    nh, n, p = d_in // sc.head_dim, sc.state_dim, sc.head_dim
    q = min(sc.chunk, s)
    nc = -(-s // q)
    intra = 2 * b * nc * q * q * n + 2 * b * nc * nh * q * q * p \
        + 2 * b * nc * nh * n * p * q
    return intra, 2 * b * nc * nh * q * n * p


def _moe_flops(cfg: ModelConfig, t: int) -> int:
    """Router, capacity-padded expert products, shared experts and a
    dense residual FFN for ``t`` tokens (routed ``DEFAULT_CHUNK`` at a
    time when more and divisible, as ``moe_forward``)."""
    from repro_torch.models.moe import DEFAULT_CHUNK, capacity
    m, d = cfg.moe, cfg.d_model
    c = DEFAULT_CHUNK if (t > DEFAULT_CHUNK and t % DEFAULT_CHUNK == 0) \
        else t
    experts = (t // c) * 3 * 2 * m.n_experts * capacity(c, m) * d * \
        m.d_expert_ff
    out = 2 * t * d * m.n_experts + experts
    out += 3 * 2 * t * d * m.d_expert_ff * m.n_shared_experts
    if m.dense_residual:
        out += 3 * 2 * t * d * cfg.d_ff
    return out


def _last_product(cfg: ModelConfig, t: int) -> int:
    """The blocks' last products, which the remat recompute skips: the
    checkpoint stops recomputing once every tensor the backward saved is
    back, and a block's last matmul only feeds a sum whose backward
    saves nothing (SwiGLU's or GELU's down projection -- an encoder's
    and a decoder's --, an SSM block's out projection, a moe block's
    dense residual FFN's, or its last routed chunk's shared experts' or
    experts')."""
    d = cfg.d_model
    if cfg.is_encdec:
        return (cfg.n_layers + cfg.n_encoder_layers) * 2 * t * cfg.d_ff * d
    if cfg.attn_free:
        sc = cfg.ssm
        d_in = sc.d_inner_override or sc.expand * d
        return cfg.n_layers * 2 * t * d_in * d
    if cfg.moe is not None:
        from repro_torch.models.moe import DEFAULT_CHUNK, capacity
        m = cfg.moe
        if m.dense_residual:
            return cfg.n_layers * 2 * t * cfg.d_ff * d
        # a routed chunk ends with its shared experts (or its experts)
        c = DEFAULT_CHUNK if (t > DEFAULT_CHUNK and t % DEFAULT_CHUNK == 0) \
            else t
        if m.n_shared_experts:
            return cfg.n_layers * 2 * c * m.d_expert_ff * \
                m.n_shared_experts * d
        return cfg.n_layers * 2 * m.n_experts * capacity(c, m) * \
            m.d_expert_ff * d
    return cfg.n_layers * 2 * t * cfg.d_ff * d


def derived_flops(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
                  remat: bool = True, microbatches: int = 1) -> int:
    """The step's matmul FLOPs worked out from the config: what
    :func:`analyze_step` must count.

    Forward, per block of a decoder over T = B S tokens: the q/k/v/o
    projections; attention's two products, ``2 B H Sq Sk D`` each, over
    every key block (the meta arm's blockwise attention computes masked
    blocks too; a decode step's keys are the cache's ``min(S, window)``
    rows); SwiGLU's three products (a GELU MLP's two); a moe block's
    router, capacity-padded experts, shared experts and dense residual;
    an SSM block's in/out projections and the SSD (intra-chunk einsums,
    inter-chunk matmul; a decode step's conv and state-read einsums).
    The head is ``2 T d V_pad`` at every position for train (and
    whisper's prefill, whose ``decode_forward`` makes all logits), at the
    last position for a decoder's prefill and at the one token of a
    decode step.  A train step adds, per block: the remat recompute of
    the whole forward, then the backward: twice each matmul, five
    attention products (S recomputed, dV, dP, dQ, dK) for the forward's
    two, and three times the SSD's intra-chunk pass (its backward
    recomputes it in float32, then differentiates it); the head's
    backward twice its forward.  Microbatches split B."""
    if kind == "train" and microbatches > 1:
        return microbatches * derived_flops(
            cfg, kind, batch // microbatches, seq, remat=remat)
    b, s = batch, seq
    d, hd, vp = cfg.d_model, cfg.hd, cfg.padded_vocab
    t = b * (s if kind != "decode" else 1)
    s_cache = min(s, cfg.sliding_window) if cfg.sliding_window else s

    def attn_unit(sq, sk):
        return 2 * b * cfg.n_heads * sq * sk * hd

    # forward, summed over the blocks: matmuls, attention's products,
    # the SSD's intra-chunk pass
    mm, units, intra = 0, 0, 0
    if cfg.is_encdec:
        mlp = 2 * 2 * t * d * cfg.d_ff
        if kind != "decode":        # encoder over S frames
            mm += cfg.n_encoder_layers * (_attn_proj(cfg, b * s) + mlp)
            units += cfg.n_encoder_layers * 2 * attn_unit(s, s)
        cross_kv = 2 * 2 * b * s * d * cfg.n_kv_heads * hd
        cross_q_o = 2 * 2 * t * d * cfg.n_heads * hd
        sq = 1 if kind == "decode" else s
        mm += cfg.n_layers * (_attn_proj(cfg, t) + cross_q_o + mlp
                              + (0 if kind == "decode" else cross_kv))
        units += cfg.n_layers * 2 * (attn_unit(sq, s) + attn_unit(sq, s))
    else:
        sq = 1 if kind == "decode" else s
        sk = s_cache if kind == "decode" else s
        per = 0
        if not cfg.attn_free:
            per += _attn_proj(cfg, t)
            units += cfg.n_layers * 2 * attn_unit(sq, sk)
            if cfg.moe is not None:
                per += _moe_flops(cfg, t)
            else:
                per += 3 * 2 * t * d * cfg.d_ff
        if cfg.has_ssm:
            sc = cfg.ssm
            d_in = sc.d_inner_override or sc.expand * d
            nh, n = d_in // sc.head_dim, sc.state_dim
            per += 2 * t * d * (2 * d_in + 2 * n + nh) + 2 * t * d_in * d
            if kind == "decode":
                conv_ch = d_in + 2 * n
                per += 2 * b * sc.conv_width * conv_ch + \
                    2 * b * n * nh * sc.head_dim
            else:
                f_intra, f_inter = _ssd_flops(cfg, b, s)
                per += f_inter
                intra += cfg.n_layers * f_intra
        mm += cfg.n_layers * per
    head_t = t if (kind == "train" or (kind == "prefill" and cfg.is_encdec)) \
        else b
    head = 2 * head_t * d * vp
    if kind != "train":
        return mm + units + intra + head
    fwd = mm + units + intra
    # ``units`` holds two attention products a layer: the backward's five
    out = fwd + head + 2 * mm + 5 * units // 2 + 3 * intra + 2 * head
    if remat:
        out += fwd - _last_product(cfg, t)
    return out


def moment_dtype_for(cfg: ModelConfig) -> str:
    """>=100B-parameter archs train with 8-bit moments (the reference's
    rule: f32 Adam moments do not fit), the rest with f32."""
    return "int8" if cfg.total_params() > 1e11 else "f32"


def _state_tensors(state: TrainState):
    out = list(state.params.parameters()) + [state.opt.step]
    for moments in (state.opt.mu, state.opt.nu):
        for m in moments.values():
            out.extend([m.q, m.scale] if isinstance(m, Q8Moment) else [m])
    return out


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def train_state(cfg: ModelConfig, device=META,
                moment_dtype: Optional[str] = None) -> TrainState:
    """The train state's stand-ins (zero-filled off meta): float32
    masters of the family's module tracked by autograd, and AdamW
    moments."""
    master = dataclasses.replace(cfg, dtype="float32")
    params = trainable(param_module(master, device))
    return TrainState(params=params, opt=init_adamw(
        params, moment_dtype or moment_dtype_for(cfg)))


def analyze_step(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
                 microbatches: int = 1, moment_dtype: Optional[str] = None,
                 remat: bool = True, device=META) -> dict:
    """Run one ``kind`` step of ``cfg`` at (batch, seq) on ``device``
    (meta: shapes only) under :class:`OpAnalysis` and return its counts:
    ``flops``, ``bytes``, ``argument_bytes``, ``peak_bytes``,
    ``op_count``, ``census``, ``convert_pairs``, ``collectives`` and the
    pass's wall seconds.  ``moment_dtype`` (train) defaults to
    :func:`moment_dtype_for`; ``"none"`` leaves the moments out of the
    held arguments (a control: the step still updates them)."""
    model = build_model(cfg)
    specs = batch_specs(cfg, kind, batch, seq, device)
    held = list(specs.values())
    if kind == "train":
        mdt = moment_dtype or moment_dtype_for(cfg)
        state = train_state(cfg, device, "f32" if mdt == "none" else mdt)
        held += (list(state.params.parameters()) if mdt == "none"
                 else _state_tensors(state))
        step = make_train_step(cfg, TrainConfig(
            optimizer=AdamWConfig(moment_dtype="f32" if mdt == "none"
                                  else mdt),
            remat=remat, microbatches=microbatches))

        def run():
            return step(state, specs)
    else:
        params = param_module(cfg, device)
        held += list(params.parameters())
        if kind == "prefill":
            if cfg.is_encdec:
                @torch.no_grad()
                def run():
                    enc = encode(params, specs["frames"], cfg)
                    return decode_forward(params, specs["tokens"], enc,
                                          cfg)[:, -1]
            else:
                def run():
                    return lm_prefill_batched(
                        params, specs["tokens"], cfg,
                        vision_embeds=specs.get("vision_embeds"))
        else:
            if cfg.is_encdec:
                with torch.no_grad():
                    enc = _empty((batch, seq, cfg.d_model),
                                 cfg.compute_dtype, device)
                    cache = model.init_cache(batch, seq, params=params,
                                             enc=enc)
                    del enc
            else:
                cache = model.init_cache(batch, seq, device=device)
            held += list(cache.values())

            def run():
                return model.decode_step(params, cache, specs["tokens"])
    t0 = time.perf_counter()
    with OpAnalysis() as oa:
        oa.hold(held)
        out = run()
        del out
    seconds = time.perf_counter() - t0
    return {"flops": oa.flops, "bytes": oa.bytes,
            "argument_bytes": _nbytes(held), "peak_bytes": oa.peak_bytes,
            "op_count": sum(oa.census.values()), "census": oa.census,
            "convert_pairs": count_convert_pairs(oa),
            "collectives": oa.collectives, "seconds": seconds}


def device_capacity() -> int:
    """Bytes of the card the dry run targets: the visible card's, else an
    H100's 80 GiB."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_BYTES


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, microbatches: Optional[int] = None
             ) -> dict:
    """One cell of the matrix on the port's one device (mesh 1x1).
    ``multi_pod`` asks for the reference's 2x16x16 mesh and is refused
    with the device count it needs.  ``microbatches`` (train) defaults
    to 1."""
    if multi_pod:
        make_production_mesh(multi_pod=True)   # raises without 512 ranks
        raise ValueError("the dry run analyses one device (mesh 1x1); a "
                         "cell on a mesh larger than 1 is not in it")
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    mb = (microbatches or 1) if kind == "train" else 1
    a = analyze_step(cfg, kind, sh["global_batch"], sh["seq_len"],
                     microbatches=mb)
    cap = device_capacity()
    peak = int(a["peak_bytes"])
    rec = {
        "arch": arch, "shape": shape_name, "mesh": "1x1", "kind": kind,
        "chips": 1,
        "hlo_flops": float(a["flops"]),
        "hlo_flops_raw": float(a["flops"]),
        "hlo_bytes": float(a["bytes"]),
        "collective_bytes": float(a["collectives"].total_bytes),
        "cost_method": "counted",
        "collectives": a["collectives"].bytes_by_kind,
        "collective_counts": a["collectives"].count_by_kind,
        "model_flops": _model_flops(cfg, shape_name),
        "microbatches": mb,
        "moment_dtype": moment_dtype_for(cfg) if kind == "train" else None,
        "op_count": a["op_count"], "convert_pairs": a["convert_pairs"],
        "meta_s": round(a["seconds"], 2),
        "argument_size_in_bytes": int(a["argument_bytes"]),
        "temp_size_in_bytes": peak - int(a["argument_bytes"]),
        "bytes_per_device": peak,
        "device_bytes": cap,
        "fits_device": peak < cap,
        "fits_16g": peak < V5E_BYTES,
    }
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "hlo_flops",
                           "collective_bytes", "meta_s")}))
        print("  memory:", {k: rec.get(k) for k in
                            ("argument_size_in_bytes", "temp_size_in_bytes",
                             "bytes_per_device", "fits_device",
                             "fits_16g")})
        print("  collectives:", a["collectives"].summary())
    return rec


def _cell_or_error(arch: str, shape: str, microbatches: int) -> dict:
    try:
        return run_cell(arch, shape, verbose=False,
                        microbatches=microbatches)
    except Exception as e:  # noqa: BLE001 -- one cell's failure, recorded
        return {"arch": arch, "shape": shape, "mesh": "1x1",
                "error": repr(e), "traceback": traceback.format_exc()}


def run_cells(cells: Sequence[Tuple[str, str]], workers: int = 1,
              microbatches: int = 1) -> List[dict]:
    """:func:`run_cell` for each cell, in order, over ``workers`` spawned
    processes (the meta pass is host work, one core a cell); a failed
    cell's record holds its ``error`` and ``traceback``."""
    if workers <= 1:
        return [_cell_or_error(a, s, microbatches) for a, s in cells]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        futs = [pool.submit(_cell_or_error, a, s, microbatches)
                for a, s in cells]
        return [f.result() for f in futs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 mesh: refused")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the reference's two meshes: refused")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="train cells' gradient-accumulation microbatches")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run in parallel, one process each")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already recorded (resume a run)")
    args = ap.parse_args(argv)
    for flag, multi in (("--multi-pod", args.multi_pod),
                        ("--both-meshes", args.both_meshes)):
        if multi:
            try:
                make_production_mesh(multi_pod=True)
            except ValueError as e:
                ap.error(f"{flag}: {e}")
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))
        args.append = True

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    cells = [c for c in cells if (c[0], c[1], "1x1") not in done]
    failures = []
    with open(args.out, "a" if args.append else "w") as f:
        for rec in run_cells(cells, args.workers, args.microbatches):
            tag = f"{rec['arch']}/{rec['shape']}/1x1"
            if "error" in rec:
                failures.append((tag, rec["error"]))
                print(rec.pop("traceback"))
            else:
                print(f"=== {tag}: {rec['hlo_flops']:.4e} FLOPs, "
                      f"{rec['bytes_per_device'] / 2**30:.2f} GiB peak "
                      f"({rec['meta_s']}s)")
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"\n{len(cells) - len(failures)} cells OK, {len(failures)} failed")
    for tag, err in failures:
        print("FAILED:", tag, err)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
