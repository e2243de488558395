"""On the card: one replayed decode dispatch (a CUDA graph per
``n_steps``) equals the eager dispatch bit for bit on the same saved
state -- tokens, valid flags, budgets, lengths, next tokens, token
indices and every cache tensor -- for qwen2.5-1.5b SMOKE (fixed-lane
and paged, KV in float32 and int8, greedy and t=0.8), mamba2-780m SMOKE
and hymba-1.5b SMOKE (both layouts), in float32 with port-made random
weights; a hybrid prompt streamed by replays of the captured batch-1
step equals the same prompt streamed eagerly from the same state
(logits, SSM state, and the K/V it wrote), on both layouts; and a
capture is not broken by an earlier engine's graphs being collected.
Marked ``cuda``: skipped where there is no device.  The CPU side of the
graphs is in ``tests/test_torch_cuda_graphs.py``.
"""

import copy
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

MAX_LEN, PAGE, N = 64, 8, 4


def _state(eng):
    """Clones of every tensor a dispatch reads or writes."""
    out = {f"cache.{k}": t.clone() for k, t in eng.cache.items()}
    for name in ("_next_token", "_remaining", "_tok_idx"):
        out[name] = getattr(eng, name).clone()
    return out


def _restore(eng, state):
    for key, t in state.items():
        dst = (eng.cache[key[len("cache."):]] if key.startswith("cache.")
               else getattr(eng, key))
        dst.copy_(t)


@pytest.mark.parametrize("arch,paged,kv_quant,temperature", [
    ("qwen2.5-1.5b", False, None, 0.0), ("qwen2.5-1.5b", True, None, 0.8),
    ("qwen2.5-1.5b", False, "int8", 0.8),
    ("qwen2.5-1.5b", True, "int8", 0.0), ("mamba2-780m", False, None, 0.8),
    ("hymba-1.5b", False, None, 0.0), ("hymba-1.5b", True, None, 0.8),
    ("hymba-1.5b", True, "int8", 0.0)])
def test_replayed_dispatch_equals_eager_on_card(arch, paged, kv_quant,
                                                temperature):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs are captured on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32", kv_quant=kv_quant)
    dev = torch.device("cuda", 0)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   torch.device("cpu"))
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    eng = ServeEngine(cfg, copy.deepcopy(params).to(dev), n_lanes=2,
                      max_len=MAX_LEN, dispatch_n=N, temperature=temperature,
                      device=dev, **kw)
    rng = np.random.default_rng(5)
    for i in range(2):
        prompt = rng.integers(0, cfg.vocab_size, 9 + 4 * i).astype(np.int32)
        assert eng.admit(Request(uid=i, prompt=prompt, max_new_tokens=30))
    eng.decode_n(N)                            # eager, then captured
    assert eng.stats["decode_compiles"] == 1
    eng.map_dispatch_pages(N)                  # as decode_n does
    saved = _state(eng)
    block, first = eng.graphs.run(N, lambda: eng._decode_block(N))
    assert not first and eng.graphs.replays(N) == 1
    replayed = {"block": block.clone(), **_state(eng)}
    _restore(eng, saved)
    eager = {"block": eng._decode_block(N), **_state(eng)}
    torch.cuda.synchronize()
    assert sorted(eager) == sorted(replayed)
    for key in sorted(eager):
        a, b = eager[key], replayed[key]
        if key.endswith("_pages"):   # dead lanes race on the scratch page
            a, b = a[:, :eng._scratch_page], b[:, :eng._scratch_page]
        assert torch.equal(a, b), key
    assert not torch.equal(saved["cache.len"], eager["cache.len"])


def _lane_kv(eng, lane, n):
    """Clones of the K/V in ring slots ``[0, n)`` of a lane: dense, of its
    row; paged, of its mapped pages in table order."""
    if not eng.paged:
        return {k: eng.cache[k][:, lane, :, :n].clone() for k in eng.cache
                if k in ("k", "v", "k_scale", "v_scale")}
    pages = torch.tensor(eng.lane_pages(lane), device=eng.device)
    out = {}
    for k in eng.cache:
        if k.endswith("_pages"):
            g = eng.cache[k][:, pages]            # (L, T', Hkv, ps, D)
            g = g.permute(0, 2, 1, 3, 4).flatten(2, 3)
            out[k] = g[:, :, :n].clone()
    return out


@pytest.mark.parametrize("paged,kv_quant", [(False, None), (True, None),
                                            (True, "int8")])
def test_replayed_hybrid_stream_equals_eager_on_card(paged, kv_quant):
    """A hymba prompt longer than the window, streamed into a lane by
    replays of the captured batch-1 step, against the same tokens
    through eager ``decode_step`` on a fresh batch-1 cache (the lane's
    pages zeroed first, paged): the last logits, the lane's SSM state
    and the K/V the stream wrote are equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs are captured on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype="float32", kv_quant=kv_quant)
    dev = torch.device("cuda", 0)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   torch.device("cpu")).to(dev)
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    eng = ServeEngine(cfg, params, n_lanes=2, max_len=MAX_LEN, device=dev,
                      **kw)
    rng = np.random.default_rng(6)
    assert eng.admit(Request(uid=0, prompt=rng.integers(
        0, cfg.vocab_size, 5).astype(np.int32), max_new_tokens=4))
    assert "ssm_step" in eng.graphs.capture_s       # later steps replay
    req = Request(uid=1, prompt=rng.integers(
        0, cfg.vocab_size, cfg.sliding_window + 9).astype(np.int32),
        max_new_tokens=4)
    logits = []
    first = eng._set_first_token
    eng._set_first_token = lambda lg, lane: (logits.append(lg.clone()),
                                             first(lg, lane))
    replays = eng.graphs.replays("ssm_step")
    assert eng.admit(req)
    lane = eng.lane_req.index(req)
    assert eng.graphs.replays("ssm_step") - replays == len(req.prompt)
    take = min(len(req.prompt), cfg.sliding_window)
    got = {k: eng.cache[k][:, lane].clone() for k in ("ssm_h", "ssm_conv")}
    got.update(_lane_kv(eng, lane, take), logits=logits[-1])

    cache = {}
    for key, t in eng._ssm_lane.items():
        if key.endswith("_pages"):
            cache[key] = t                          # the shared pools
        elif key == "block_tables":
            cache[key] = eng.cache[key][lane:lane + 1].clone()
        else:
            cache[key] = torch.zeros_like(t)
    if paged:
        pages = torch.tensor(eng.lane_pages(lane), device=dev)
        for key in cache:
            if key.endswith("_pages"):
                cache[key][:, pages] = 0
    toks = torch.from_numpy(req.prompt).to(dev)
    for t in range(len(req.prompt)):
        out, cache = eng.model.decode_step(eng.params, cache, toks[t:t + 1])
    torch.cuda.synchronize()
    want = {k: cache[k][:, 0] for k in ("ssm_h", "ssm_conv")}
    if paged:
        want.update(_lane_kv(eng, lane, take))
    else:
        want.update({k: cache[k][:, 0, :, :take] for k in cache
                     if k in ("k", "v", "k_scale", "v_scale")})
    want["logits"] = out
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert torch.equal(got[key], want[key]), key


def test_capture_survives_a_collected_engine():
    """An engine whose graphs sit in a reference cycle is garbage when
    the next engine captures: it must be collected before the capture,
    not in the middle of it, where destroying its graphs invalidates the
    capture.  The collector is held off until the capture has begun and
    then runs at every allocation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs are captured on the card)")
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    dev = torch.device("cuda", 0)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   torch.device("cpu")).to(dev)
    rng = np.random.default_rng(3)

    def requests():
        return [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 7).astype(np.int32), max_new_tokens=9)
            for i in range(3)]

    def engine():
        return ServeEngine(cfg, params, n_lanes=2, max_len=MAX_LEN,
                           dispatch_n=N, device=dev)

    first = engine()
    first.cycle = first                    # only the collector frees it
    first.run(requests())
    assert first.stats["decode_compiles"] == 2
    thresholds, enabled = gc.get_threshold(), gc.isenabled()
    gc.disable()
    try:
        del first                          # garbage, not yet collected
        second = engine()
        block = second._decode_block

        def collect_mid_capture(n):
            if torch.cuda.is_current_stream_capturing():
                gc.set_threshold(1, 1, 1)
                gc.enable()
            return block(n)

        second._decode_block = collect_mid_capture
        reqs = second.run(requests())
    finally:
        gc.set_threshold(*thresholds)
        (gc.enable if enabled else gc.disable)()
    torch.cuda.synchronize()
    assert all(r.done for r in reqs)
    assert second.stats["decode_compiles"] == 2
    assert second.graphs.replays(N) + second.graphs.replays(1) == \
        second.stats["decode_dispatches"] - 2
