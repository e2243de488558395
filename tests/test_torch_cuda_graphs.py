"""The port's decode dispatch as a CUDA graph per ``n_steps``, checked
where it can be without a card, and on the card where there is one.

* ``decode_compiles`` equals the reference engine's on the same
  requests, with budgets that force dispatch sizes 8, 4, 2 and 1 and
  with ``dispatch_n=3``, on both layouts, greedy and at t=0.8 (the
  streams too);
* the dispatch keeps every tensor it reads and writes at its address
  (the cache, ``len``, next tokens, budgets, token indices, and the
  ssm prompt stream's buffers): what a captured graph replays;
* neither a decode dispatch nor the ssm prompt stream makes a tensor
  from Python data (``torch.tensor``/``torch.as_tensor`` are patched
  to refuse it): a pageable host-to-device copy, which stream capture
  refuses;
* the replay accounting of the launch counters as plain functions, and
  ``StepGraphs`` on the CPU (eager every time, first use reported).

A replayed dispatch against the eager one on the card is in
``tests/test_torch_graphs_card.py`` (no JAX there).

SMOKE configs in float32.
"""

import contextlib
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_lm as jax_init_lm  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import (COUNTERS, add_launches,  # noqa: E402
                                 launch_counts, launch_delta)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import STATS_KEYS, Request, ServeEngine  # noqa: E402
from repro_torch.serving.cuda_graphs import _Graph, StepGraphs  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
MAX_LEN, PAGE = 64, 8
#: (dispatch_n, budgets, sizes the dispatches take): two lanes, so each
#: pair of budgets is one round of dispatches
MIXES = {"sizes_8_4_2_1": (8, [8, 8, 4, 4, 2, 2, 1, 1, 3], 4),
         "dispatch_n_3": (3, [7, 7, 2, 2, 1, 1], 3)}


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", **kw)


@pytest.fixture(scope="module")
def qwen():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32")
    cfg = _cfg("qwen2.5-1.5b")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def ported():
    """Port-only random weights of both SMOKE families (no reference)."""
    out = {}
    for arch in ("qwen2.5-1.5b", "mamba2-780m"):
        cfg = _cfg(arch)
        out[arch] = cfg, build_model(cfg).init(
            torch.Generator().manual_seed(0), CPU)
    return out


def _prompts(n, vocab, seed=5, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(p)).astype(np.int32)
            for p in rng.integers(lo, hi + 1, n)]


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_compiles_match_reference(qwen, mix, temperature, paged):
    jcfg, jparams, cfg, params = qwen
    dispatch_n, gens, sizes = MIXES[mix]
    kw = dict(n_lanes=2, max_len=MAX_LEN, dispatch_n=dispatch_n,
              temperature=temperature, rng_seed=4)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    prompts = _prompts(len(gens), cfg.vocab_size)
    jreqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in treqs] == gens
    assert teng.stats["decode_compiles"] == sizes
    for k in STATS_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["decode_dispatches"] > sizes     # sizes recur


def _addresses(eng):
    """data_ptr of every tensor the dispatch and the stream touch."""
    out = {f"cache.{k}": t.data_ptr() for k, t in sorted(eng.cache.items())}
    for name in ("_next_token", "_remaining", "_tok_idx", "_lane_seed",
                 "_rng_decode"):
        out[name] = getattr(eng, name).data_ptr()
    if eng.cfg.attn_free:
        out.update({f"ssm_lane.{k}": t.data_ptr()
                    for k, t in sorted(eng._ssm_lane.items())})
        out["_ssm_tok"] = eng._ssm_tok.data_ptr()
    return out


@pytest.mark.parametrize("arch,paged,kv_quant", [
    ("qwen2.5-1.5b", False, None), ("qwen2.5-1.5b", True, None),
    ("qwen2.5-1.5b", False, "int8"), ("qwen2.5-1.5b", True, "int8"),
    ("mamba2-780m", False, None), ("mamba2-780m", True, None)])
def test_dispatch_keeps_fixed_addresses(ported, arch, paged, kv_quant):
    cfg, params = ported[arch]
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    eng = ServeEngine(cfg, params, n_lanes=2, max_len=MAX_LEN,
                      dispatch_n=4, temperature=0.8, device="cpu", **kw)
    cache, keys, want = eng.cache, sorted(eng.cache), _addresses(eng)
    dispatches = []
    decode_n = eng.decode_n

    def checked(n=None):
        out = decode_n(n)
        dispatches.append(n)
        assert eng.cache is cache and sorted(eng.cache) == keys
        assert _addresses(eng) == want
        return out

    eng.decode_n = checked
    reqs = [Request(uid=i, prompt=p, max_new_tokens=g) for i, (p, g) in
            enumerate(zip(_prompts(5, cfg.vocab_size), [6, 3, 9, 1, 5]))]
    eng.run(reqs)
    assert all(r.done for r in reqs) and len(dispatches) >= 4
    assert _addresses(eng) == want


@contextlib.contextmanager
def _no_host_tensors(calls):
    """Patch ``torch.tensor``/``torch.as_tensor`` to refuse data that is
    not already a tensor; ``calls`` counts the guarded entries."""
    real = {name: getattr(torch, name) for name in ("tensor", "as_tensor")}

    def guard(name):
        def refuse(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"torch.{name} of {type(data).__name__}"
                                     " data on the captured path")
            return real[name](data, *args, **kwargs)
        return refuse

    calls.append(1)
    try:
        for name in real:
            setattr(torch, name, guard(name))
        yield
    finally:
        for name, fn in real.items():
            setattr(torch, name, fn)


def _guarded(fn, calls):
    def run(*args, **kwargs):
        with _no_host_tensors(calls):
            return fn(*args, **kwargs)
    return run


@pytest.mark.parametrize("arch,paged,kv_quant,temperature", [
    ("qwen2.5-1.5b", False, None, 0.0), ("qwen2.5-1.5b", False, None, 0.8),
    ("qwen2.5-1.5b", True, "int8", 0.8), ("mamba2-780m", False, None, 0.8)])
def test_captured_path_makes_no_host_tensor(ported, arch, paged, kv_quant,
                                            temperature):
    """One ``decode_n`` (fixed-lane: all of it; paged: the dispatch, as
    the host maps pages before it) and, for the ssm model, each prompt
    stream, with host-made tensors refused; the engine's own set-up
    outside them is not patched."""
    cfg, params = ported[arch]
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    eng = ServeEngine(cfg, params, n_lanes=2, max_len=MAX_LEN,
                      dispatch_n=4, temperature=temperature, device="cpu",
                      **kw)
    calls = []
    if paged:
        eng._decode_block = _guarded(eng._decode_block, calls)
    else:
        eng.decode_n = _guarded(eng.decode_n, calls)
    if cfg.attn_free:
        eng._stream_ssm_prompt = _guarded(eng._stream_ssm_prompt, calls)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(_prompts(3, cfg.vocab_size))]
    eng.run(reqs)
    assert all(r.done and len(r.generated) == 5 for r in reqs)
    assert len(calls) >= 2 + (3 if cfg.attn_free else 0)
    with pytest.raises(AssertionError, match="captured path"):
        with _no_host_tensors([]):
            torch.tensor(1.0)               # the guard itself bites


def test_replay_accounting_adds_the_captured_delta():
    before = launch_counts()
    delta = {"decode_attention_paged": 28, "flash_attention_mma": 2}
    # what a capture records and takes back out
    add_launches(delta)
    assert launch_delta(before, launch_counts()) == delta
    add_launches(delta, -1)
    assert launch_counts() == before
    for n in (1, 4):
        add_launches(delta, n)
        assert launch_delta(before, launch_counts()) == {
            k: n * v for k, v in delta.items()}
        add_launches(delta, -n)
    assert launch_counts() == before
    assert launch_delta(before, before) == {}
    assert set(delta) <= set(COUNTERS)


def test_step_graphs_replay_counts_launches():
    """``StepGraphs``' replay path with a stand-in graph: each replay
    adds the captured delta once and returns the capture's outputs."""
    class Recorded:
        n = 0

        def replay(self):
            self.n += 1

    graphs = StepGraphs(CPU)
    out = torch.zeros(3)
    delta = {"decode_attention_lengthaware": 28}
    graphs._graphs[8] = _Graph(Recorded(), out, delta)
    before = launch_counts()
    for _ in range(5):
        assert graphs._replay(8) is out
    assert graphs._graphs[8].graph.n == 5 and graphs.replays(8) == 5
    assert launch_delta(before, launch_counts()) == {
        "decode_attention_lengthaware": 140}
    add_launches(delta, -5)


def test_step_graphs_on_cpu_run_eagerly():
    graphs = StepGraphs(CPU)
    calls = []

    def fn():
        calls.append(1)
        return len(calls)

    assert graphs.run(8, fn) == (1, True)
    assert graphs.run(8, fn) == (2, False)
    assert graphs.run(4, fn) == (3, True)
    assert graphs.replays(8) == 0 and graphs.capture_s == {}
    assert graphs.pool_bytes() is None


def test_launcher_prints_the_compiles(capsys):
    serve_launcher.main(["--smoke", "--device", "cpu", "--requests", "3",
                         "--gen", "11", "--lanes", "2"])
    out = capsys.readouterr().out
    m = re.search(r"^compiles: prefill (\d+), decode (\d+) ", out, re.M)
    stats = re.search(r"^stats: (\{.*\})$", out, re.M)
    assert m and stats
    got = eval(stats.group(1))                # the engine's stats dict
    assert (int(m.group(1)), int(m.group(2))) == (
        got["prefill_compiles"], got["decode_compiles"])
    # budgets of 11 at dispatch_n 8: sizes 8 then 4
    assert got["decode_compiles"] == 2
    assert "capture:" not in out              # no graph on the CPU
