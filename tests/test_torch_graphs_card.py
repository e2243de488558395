"""On the card: one replayed decode dispatch (a CUDA graph per
``n_steps``) equals the eager dispatch bit for bit on the same saved
state -- tokens, valid flags, budgets, lengths, next tokens, token
indices and every cache tensor -- for qwen2.5-1.5b SMOKE (fixed-lane
and paged, KV in float32 and int8, greedy and t=0.8) and mamba2-780m
SMOKE, in float32 with port-made random weights; and a capture is not
broken by an earlier engine's graphs being collected.  Marked ``cuda``:
skipped where there is no device.  The CPU side of the graphs is in
``tests/test_torch_cuda_graphs.py``.
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
    ("qwen2.5-1.5b", True, "int8", 0.0), ("mamba2-780m", False, None, 0.8)])
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
