"""The port's resilience and lifecycle-analysis layer held against the
reference's.

* ``DegradationLadder`` and ``RetryPolicy``: the same signal sequences
  (pressure samples, blocked admissions, clear signals, forced moves)
  give the same transitions, levels, ``dispatch_n``, ``retry_after_s``,
  ``backoff_s``, ``allows`` and ``degrade.transition`` events;
* ``PageSanitizer``: each violation class gets the reference's verdict
  on the same scripted ops (the reference tests' seeded mutations),
  strict mode raises the port's ``InvariantError`` family, the offline
  replay and the ``pages.jsonl`` round trip agree, and a shadow that
  diverges from the pool is caught;
* ``PagePool``: the same call sequence gives the reference's page ids,
  counters, monitor op stream and ``<prefix>.pages.*`` gauges;
* the interleaving explorer: the sweep at the reference's fast depth is
  clean and visits the reference's number of states, and
  ``RefcountBlindPool`` is caught with the reference's trace, which
  replays deterministically.
"""

import json

import pytest

pytest.importorskip("jax")

from repro.analysis import interleave as jinterleave  # noqa: E402
from repro.analysis.sanitizer import \
    PageSanitizer as JaxSanitizer  # noqa: E402
from repro.obs import EventLog as JaxEventLog  # noqa: E402
from repro.obs import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.obs.events import DEFAULT_LOG as JAX_LOG  # noqa: E402
from repro.serving import DegradationLadder as JaxLadder  # noqa: E402
from repro.serving import PagePool as JaxPagePool  # noqa: E402
from repro.serving import RetryPolicy as JaxRetryPolicy  # noqa: E402
from repro_torch.analysis import interleave  # noqa: E402
from repro_torch.analysis.invariants import InvariantError  # noqa: E402
from repro_torch.analysis.sanitizer import (VIOLATIONS,  # noqa: E402
                                            PageSanitizer, SanitizerError,
                                            load_jsonl)
from repro_torch.obs import EventLog, MetricsRegistry  # noqa: E402
from repro_torch.obs.events import DEFAULT_LOG  # noqa: E402
from repro_torch.serving import (DegradationLadder, PagePool,  # noqa: E402
                                 RetryPolicy)
from repro_torch.serving.resilience import DEGRADE_LEVELS  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.analysis]


# ----------------------------------------------------------------------
# degradation ladder + retry policy
# ----------------------------------------------------------------------

#: signal scripts: ("p", occupancy) / ("b", uid) / ("ok",) / ("up",) /
#: ("down",)
SIGNALS = {
    "pressure_climb_and_cool": [("p", 0.95)] * 8 + [("p", 0.1)] * 20,
    "blocked_admissions": [("b", i) for i in range(5)] + [("ok",)] * 12
    + [("b", 9), ("p", 0.99)],
    "flapping": [("p", 0.95), ("p", 0.2)] * 6 + [("p", 0.93)] * 3,
    "forced_moves": [("up",)] * 5 + [("p", 0.5)] * 3 + [("down",)] * 5
    + [("b", 1), ("b", 2)],
}
LADDER_KW = {"default": {}, "tight": dict(page_pressure=0.5, trip_after=1,
                                          cooldown=3, min_dispatch_n=2)}


def _drive(ladder, log, script):
    log.clear()
    trail = []
    for sig in script:
        kind = sig[0]
        if kind == "p":
            ladder.note_pressure(sig[1])
        elif kind == "b":
            ladder.note_admission_blocked(sig[1])
        elif kind == "ok":
            ladder.note_ok()
        elif kind == "up":
            ladder.escalate("slo")
        else:
            ladder.deescalate("slo")
        trail.append((ladder.level, ladder.level_name, ladder.dispatch_n(8),
                      ladder.dispatch_n(3), ladder.refusing_admissions,
                      ladder.should_evict, ladder.retry_after_s(),
                      ladder.retry_after_s(0.2)))
    events = [(e.name, dict(e.fields)) for e in log.records()]
    return trail, ladder.transitions, events


@pytest.mark.parametrize("kw", sorted(LADDER_KW))
@pytest.mark.parametrize("script", sorted(SIGNALS))
def test_ladder_matches_reference(script, kw):
    ref = _drive(JaxLadder(name="node0", **LADDER_KW[kw]), JAX_LOG,
                 SIGNALS[script])
    port = _drive(DegradationLadder(name="node0", **LADDER_KW[kw]),
                  DEFAULT_LOG, SIGNALS[script])
    assert port == ref
    assert all(name == "degrade.transition" for name, _ in port[2])
    assert len(port[2]) == len(port[1])


def test_ladder_refuses_a_bad_pressure():
    with pytest.raises(InvariantError):
        DegradationLadder(page_pressure=1.5)
    assert DEGRADE_LEVELS == ("normal", "shed_batch", "backpressure",
                              "evict")


@pytest.mark.parametrize("kw", [{}, dict(max_attempts=5, base_backoff_s=0.1,
                                         backoff_cap_s=0.5, deadline_s=2.0,
                                         hedge_after_s=0.3)])
def test_retry_policy_matches_reference(kw):
    ref, port = JaxRetryPolicy(**kw), RetryPolicy(**kw)
    assert [port.backoff_s(a) for a in range(8)] == \
        [ref.backoff_s(a) for a in range(8)]
    grid = [(a, w) for a in range(7) for w in (0.0, 1.0, 1.99, 2.0, 5.0)]
    assert [port.allows(a, w) for a, w in grid] == \
        [ref.allows(a, w) for a, w in grid]
    assert port.hedge_after_s == ref.hedge_after_s


# ----------------------------------------------------------------------
# sanitizer: the reference tests' scripted ops, one per violation class
# ----------------------------------------------------------------------

def _ops(n_pages=4):
    return [("init", dict(n_pages=n_pages, page_size=8, scratch=n_pages))]


SCRIPTS = {
    "double_free": _ops() + [
        ("reserve", dict(n=1, ok=True)), ("alloc", dict(pages=[0], holder=0)),
        ("free", dict(pages=[0], holder=0)),
        ("free", dict(pages=[0], holder=0))],
    "scratch_page": _ops() + [
        ("reserve", dict(n=1, ok=True)), ("alloc", dict(pages=[4], holder=0)),
        ("write", dict(lane=0, pages=[4], kind="decode")),
        ("capture", dict(lane=0, pages=[1, 4])),
        ("free", dict(pages=[4], holder=0))],
    "missing_cow": _ops() + [
        ("reserve", dict(n=2, ok=True)),
        ("alloc", dict(pages=[0, 1], holder=0)),
        ("share", dict(pages=[0], holder=1)), ("map", dict(lane=1, pages=[0])),
        ("write", dict(lane=0, pages=[0], kind="decode")),
        ("write", dict(lane=1, pages=[0], kind="decode")),
        ("reserve", dict(n=1, ok=True)),
        ("cow", dict(old=0, new=2, holder=1)),
        ("write", dict(lane=1, pages=[2], kind="cow_copy"))],
    "unshared_map_and_write": _ops() + [
        ("reserve", dict(n=1, ok=True)), ("alloc", dict(pages=[0], holder=0)),
        ("map", dict(lane=1, pages=[0])),
        ("write", dict(lane=1, pages=[0], kind="decode"))],
    "accounting": _ops() + [
        ("unreserve", dict(n=1)), ("alloc", dict(pages=[0], holder=0)),
        ("share", dict(pages=[3], holder=1)), ("reserve", dict(n=1, ok=True)),
        ("cow", dict(old=0, new=1, holder=0)),
        ("write", dict(lane=0, pages=[2], kind="decode"))],
    "unknown_page_and_op": _ops() + [
        ("reserve", dict(n=2, ok=True)), ("alloc", dict(pages=[9], holder=0)),
        ("grow", dict(pages=[1])), ("shrink", dict(pages=[2])),
        ("grow", dict(pages=[2])), ("bogus", dict(pages=[0]))],
    "clean_lifecycle": _ops(6) + [
        ("reserve", dict(n=3, ok=True)),
        ("alloc", dict(pages=[0, 1], holder=0)),
        ("map", dict(lane=0, pages=[0, 1])),
        ("write", dict(lane=0, pages=[0, 1], kind="prefill")),
        ("share", dict(pages=[0], holder="cache")),
        ("reserve", dict(n=2, ok=True)), ("share", dict(pages=[0], holder=1)),
        ("map", dict(lane=1, pages=[0])), ("cow", dict(old=0, new=2,
                                                       holder=1)),
        ("write", dict(lane=1, pages=[2], kind="cow_copy")),
        ("capture", dict(lane=1, pages=[2])),
        ("free", dict(pages=[2], holder=1)), ("unreserve", dict(n=1)),
        ("free", dict(pages=[0, 1], holder=0)), ("unreserve", dict(n=1)),
        ("free", dict(pages=[0], holder="cache"))],
}


def _run_script(cls, ops, strict=False):
    san = cls(strict=strict)
    raised = None
    for op, fields in ops:
        try:
            san.record(op, **fields)
        except AssertionError as e:
            raised = (op, type(e).__name__, str(e))
            break
    return ([v.as_dict() for v in san.violations], san.ops_seen, raised,
            san.clean)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_sanitizer_verdicts_match_reference(script):
    ops = SCRIPTS[script]
    assert _run_script(PageSanitizer, ops) == _run_script(JaxSanitizer, ops)
    assert _run_script(PageSanitizer, ops, strict=True) == \
        _run_script(JaxSanitizer, ops, strict=True)
    codes = [v["code"] for v in _run_script(PageSanitizer, ops)[0]]
    assert all(c in VIOLATIONS for c in codes)
    assert (codes == []) == (script == "clean_lifecycle")


def test_sanitizer_strict_raises_the_ports_invariant_error():
    san = PageSanitizer(strict=True)
    for op, fields in SCRIPTS["double_free"][:-1]:
        san.record(op, **fields)
    with pytest.raises(SanitizerError) as ei:
        san.record("free", pages=[0], holder=0)
    assert isinstance(ei.value, InvariantError)
    assert ei.value.violation.code == "DOUBLE_FREE"
    assert ei.value.violation.as_dict()["op"]["op"] == "free"


def test_sanitizer_replay_and_jsonl_match_reference(tmp_path):
    out = []
    for cls, log_cls in ((JaxSanitizer, JaxEventLog),
                         (PageSanitizer, EventLog)):
        log = log_cls(clock=lambda: 0.0)
        live = cls(strict=True, log=log)
        for op, fields in SCRIPTS["clean_lifecycle"]:
            live.record(op, **fields)
        path = tmp_path / f"pages_{cls.__module__}.jsonl"
        n = log.dump(path, prefix="page")
        records = load_jsonl(path)
        replayed = cls.replay(records)
        bad = cls.replay(records + [{"op": "free", "pages": [1],
                                     "holder": 0}])
        out.append((n, live.ops_seen, replayed.clean, replayed.ops_seen,
                    [v.as_dict() for v in bad.violations],
                    path.read_text()))
    assert out[1] == out[0]
    assert out[1][2] and out[1][4][0]["code"] == "DOUBLE_FREE"


def test_sanitizer_crosscheck_catches_divergence():
    pool = PagePool(4, 8)
    san = PageSanitizer(strict=False)
    pool.monitor = san
    san.record("init", n_pages=4, page_size=8, scratch=4)
    pool.reserve(2)
    pages = pool.alloc(2, holder=0)
    san.crosscheck(pool)
    assert san.clean
    pool._free.append(pages[0])              # tamper behind the monitor
    san.crosscheck(pool)
    assert "CONSERVATION" in [v.code for v in san.violations]


# ----------------------------------------------------------------------
# the page pool's counters, monitor stream and gauges
# ----------------------------------------------------------------------

def _pool_script(pool_cls, san_cls, log_cls, reg_cls):
    pool = pool_cls(6, 8)
    log = log_cls(clock=lambda: 0.0)
    pool.monitor = san_cls(strict=True, log=log)
    pool.monitor.record("init", n_pages=6, page_size=8, scratch=6)
    reg = reg_cls()
    pool.bind_registry(reg, prefix="serve.pool")
    snaps = []
    assert pool.reserve(4)
    a = pool.alloc(2, holder=0)
    pool.share([a[0]], holder="cache")
    pool.share([a[0]], holder=1)
    new = pool.cow(a[0], holder=1)
    snaps.append(reg.collect())
    assert not pool.reserve(9)
    pool.free([new], holder=1)
    pool.free(a, holder=0)
    pool.unreserve(1)
    pool.free([a[0]], holder="cache")
    snaps.append(reg.collect())
    pool.check()
    pool.monitor.crosscheck(pool)
    return (a, new, pool.alloc_count, pool.free_count, pool.share_count,
            pool.cow_count, pool.hwm, snaps, reg.to_prometheus(),
            [(e.name, dict(e.fields)) for e in log.records()])


def test_pagepool_counters_monitor_and_gauges_match_reference():
    ref = _pool_script(JaxPagePool, JaxSanitizer, JaxEventLog, JaxRegistry)
    port = _pool_script(PagePool, PageSanitizer, EventLog, MetricsRegistry)
    assert port == ref
    assert sorted(port[7][-1]) == sorted(
        f"serve.pool.pages.{k}" for k in (
            "free", "in_use", "reserved", "disabled", "hwm", "allocs",
            "frees", "shared", "cow_splits"))
    assert port[7][-1]["serve.pool.pages.in_use"] == 0


# ----------------------------------------------------------------------
# interleaving explorer
# ----------------------------------------------------------------------

def test_interleave_sweep_clean_and_same_state_space():
    visited = interleave.explore(lambda: interleave.LifecycleHarness(),
                                 depth=4)
    assert visited > 100
    assert visited == jinterleave.explore(
        lambda: jinterleave.LifecycleHarness(), depth=4)


def test_interleave_catches_refcount_blind_allocator():
    with pytest.raises(interleave.InterleavingBug) as ei:
        interleave.explore(lambda: interleave.LifecycleHarness(
            pool_cls=interleave.RefcountBlindPool), depth=4)
    with pytest.raises(jinterleave.InterleavingBug) as jei:
        jinterleave.explore(lambda: jinterleave.LifecycleHarness(
            pool_cls=jinterleave.RefcountBlindPool), depth=4)
    bug = ei.value
    assert bug.trace == jei.value.trace
    assert len(bug.trace) >= 2 and bug.trace[0][0] in ("admit", "hit")
    assert "->" in str(bug)
    # the trace is a reproducer: a fresh harness fails on it again
    h = interleave.LifecycleHarness(pool_cls=interleave.RefcountBlindPool)
    with pytest.raises(InvariantError):
        for op in bug.trace:
            h.apply(op)
            h.verify()


def test_interleave_random_walks_match_reference():
    """Fixed index walks (a seeded stand-in for the reference's
    Hypothesis walk) apply the same ops on both harnesses, clean."""
    import numpy as np

    rng = np.random.default_rng(5)
    for _ in range(40):
        idx = [int(i) for i in rng.integers(0, 64, size=12)]
        h, jh = interleave.LifecycleHarness(), jinterleave.LifecycleHarness()
        assert h.apply_indices(idx) == jh.apply_indices(idx)
        assert json.dumps(sorted(h.pool._free)) == \
            json.dumps(sorted(jh.pool._free))
        assert h.san.clean
