"""The port's ``repro_torch.obs`` held against the reference's ``obs``.

Each module is driven by one script through both packages, on an
injected counting clock, and the outputs compared: the registry's
Prometheus text and JSON snapshot, the tracer's Chrome JSON and queries,
``RequestTimeline.as_dict()`` and ``gaps()`` on the reference tests'
hand-built lives (clean, no first token, an unmatched evict, a
migration's restore, decode before admission), the per-request track
re-projection, the event log, the flight ring with its dump/load, and
the SLO burn rates with the controller's moves.  The schema catalog is
the reference's, name for name, and every name is in
``docs/observability.md``; the dump CLI reads the port's artifacts.
The port's flight guard dumps on its own ``InvariantError`` (and the
sanitizer's subclass of it) and on nothing else.
"""

import itertools
import json
import os

import pytest

pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.obs import dump as jdump  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.serving import DegradationLadder as JaxLadder  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.analysis.invariants import InvariantError  # noqa: E402
from repro_torch.analysis.sanitizer import PageSanitizer  # noqa: E402
from repro_torch.obs import dump as tdump  # noqa: E402
from repro_torch.obs import schema as tschema  # noqa: E402
from repro_torch.serving import DegradationLadder  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.obs]

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
PACKAGES = {"ref": (jobs, JaxLadder), "port": (obs, DegradationLadder)}


def _clock():
    ticks = itertools.count(1)
    return lambda: next(ticks) * 0.25


def _both(script):
    """``script(pkg, ladder_cls)`` through the reference and the port."""
    return [script(*PACKAGES[k]) for k in ("ref", "port")]


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

def _metrics_script(pkg, _ladder):
    reg = pkg.MetricsRegistry()
    c = reg.counter("serve.decode.dispatches", help="dispatches")
    c.inc()
    c.inc(4)
    g = reg.gauge("slo.burn_rate.short", help="short burn")
    g.set(2.5)
    g.set_max(1.0)
    box = {"v": 7}
    reg.gauge("serve.pool.pages.free", fn=lambda: box["v"])
    box["v"] = 3
    h = reg.histogram("span.admit.seconds")
    for v in (0.25, 0.5, 1.0, 4.0):
        h.observe(v)
    refused = []
    for make in (lambda: reg.gauge("serve.decode.dispatches"),
                 lambda: reg.histogram("slo.burn_rate.short")):
        try:
            make()
        except AssertionError as e:
            refused.append(str(e))
    view = pkg.StatsView(reg, {"decode_dispatches":
                               "serve.decode.dispatches"})
    view["decode_dispatches"] += 2
    bad = []
    try:
        view["invented"] = 1
    except KeyError as e:
        bad.append(str(e))
    return (reg.to_prometheus(), json.dumps(reg.collect(), sort_keys=True),
            reg.names(), reg.sum_prefix("serve"), refused, dict(view),
            view == {"decode_dispatches": 7}, bad,
            reg.counter("serve.decode.dispatches") is c,
            h.percentile(50), h.percentile(99))


def test_metrics_registry_matches_reference():
    ref, port = _both(_metrics_script)
    assert port == ref
    assert "serve_decode_dispatches 7" in port[0]
    assert "# HELP slo_burn_rate_short short burn" in port[0]
    assert len(port[4]) == 2 and port[6] and port[8]


# ----------------------------------------------------------------------
# tracer + events
# ----------------------------------------------------------------------

def _trace_script(pkg, _ladder):
    reg = pkg.MetricsRegistry()
    tr = pkg.SpanTracer(enabled=True, clock=_clock(), registry=reg)
    with tr.span("decode.dispatch", track="serve", n_steps=4, n_live=2,
                 uids=(0, 1)):
        with tr.span("admit", track="serve/lane0", uid=0):
            with tr.span("prefill.bucket", track="serve/lane0", bucket=8,
                         plen=5):
                pass
        tr.instant("first_token", track="serve/lane0", uid=0)
    tr.add_span("preempt.evict", 10.0, 10.5, track="serve/lane1", uid=1,
                n_pages=2)
    tr.add_instant("retire", 11.0, track="serve/lane0", uid=0, gen=4)
    off = pkg.SpanTracer(enabled=False, clock=_clock())
    with off.span("admit", uid=9):
        pass
    off.instant("retire", uid=9)
    log = pkg.EventLog(clock=_clock())
    log.emit("degrade.transition", engine="serve", from_level="normal",
             to_level="shed_batch", reason="x")
    log.emit("slo.alert", short_burn=3.0)
    log.emit("degrade.transition", engine="serve", from_level="shed_batch",
             to_level="normal", reason="cooldown")
    return (tr.to_json(), [s.name for s in tr.spans_named("admit")],
            tr.tracks(), tr.check_well_nested(),
            [i.args for i in tr.instants_named("retire")],
            json.dumps(reg.collect(), sort_keys=True),
            (off.spans, off.instants), log.to_json(), log.to_jsonl(),
            [e.name for e in log.records_prefix("degrade")], log.names(),
            len(log))


def test_tracer_and_event_log_match_reference():
    ref, port = _both(_trace_script)
    assert port == ref
    chrome = json.loads(port[0])
    assert {e["ph"] for e in chrome["traceEvents"]} == {"M", "X", "i"}
    assert port[3] is True and port[6] == ([], [])


def test_default_clocks_and_module_emit():
    import time

    assert obs.EventLog().clock is time.perf_counter
    assert obs.SpanTracer(enabled=False).clock is time.perf_counter
    n = len(obs.DEFAULT_LOG)
    ev = obs.emit("slo.clear", short_burn=0.0)
    assert obs.DEFAULT_LOG.records()[-1] is ev and len(obs.DEFAULT_LOG) == \
        n + 1


# ----------------------------------------------------------------------
# request timelines (the reference tests' hand-built lives)
# ----------------------------------------------------------------------

def _clean_life(tr, uid, t0, track="node0"):
    tr.add_span("admit", t0, t0 + 0.2, track=track, uid=uid, n_pages=3)
    tr.add_span("decode.dispatch", t0 + 0.2, t0 + 0.6, track=track,
                n_steps=4, uids=(uid, 99))
    tr.add_instant("first_token", t0 + 0.3, track=track, uid=uid)
    tr.add_span("decode.dispatch", t0 + 0.6, t0 + 1.0, track=track,
                n_steps=4, uids=(uid,))
    tr.add_instant("retire", t0 + 1.0, track=track, uid=uid, gen=8)


def _life_clean(tr):
    _clean_life(tr, uid=7, t0=10.0)
    tr.add_span("admit", 0.0, 0.1, track="node0", uid=3)


def _life_no_first_token(tr):
    tr.add_span("admit", 0.0, 0.1, track="node0", uid=1)


def _life_unmatched_evict(tr):
    _clean_life(tr, uid=1, t0=0.0)
    tr.add_span("preempt.evict", 0.4, 0.5, track="node0", uid=1, n_pages=2)


def _life_migration(tr, second_restore=False):
    tr.add_span("admit", 0.0, 0.2, track="node0", uid=1)
    tr.add_instant("first_token", 0.3, track="node0", uid=1)
    tr.add_span("preempt.restore", 0.5, 0.6, track="node1", uid=1,
                n_pages=2)
    tr.add_span("decode.dispatch", 0.6, 0.8, track="node1", uids=(1,))
    tr.add_instant("retire", 0.8, track="node1", uid=1, gen=4)
    if second_restore:
        tr.add_span("preempt.restore", 0.9, 1.0, track="node1", uid=1)


def _life_decode_before_admit(tr):
    _clean_life(tr, uid=1, t0=5.0)
    tr.add_span("decode.dispatch", 1.0, 1.5, track="node0", uids=(1,))


LIVES = {"clean": _life_clean, "no_first_token": _life_no_first_token,
         "unmatched_evict": _life_unmatched_evict,
         "migration": _life_migration,
         "second_restore": lambda tr: _life_migration(tr, True),
         "decode_before_admit": _life_decode_before_admit}


@pytest.mark.parametrize("life", sorted(LIVES))
def test_request_timelines_match_reference(life):
    def script(pkg, _ladder):
        tr = pkg.SpanTracer(enabled=True, clock=_clock())
        LIVES[life](tr)
        tls = pkg.request_timelines(tr)
        spans, instants = pkg.spans_from_chrome(tr.export_chrome_trace())
        round_trip = pkg.RequestTimeline.from_tracer(
            spans, sorted(tls)[0], instants=instants)
        return ({uid: (tl.as_dict(), tl.gaps(), tl.complete, tl.ttft_s,
                       tl.tpot_series, tl.engines, tl.hops)
                 for uid, tl in tls.items()},
                sorted(pkg.request_ids(tr)),
                json.dumps(pkg.export_request_tracks(tls), sort_keys=True),
                round_trip.as_dict())
    ref, port = _both(script)
    assert port == ref
    for as_dict, *_ in port[0].values():
        assert list(as_dict) == tschema.TIMELINE_KEYS


def test_save_request_tracks_matches_reference(tmp_path):
    def script(pkg, _ladder):
        tr = pkg.SpanTracer(enabled=True, clock=_clock())
        _clean_life(tr, uid=4, t0=2.0)
        _clean_life(tr, uid=5, t0=3.0, track="node1")
        path = tmp_path / f"tracks_{pkg.__name__}.json"
        pkg.save_request_tracks(pkg.request_timelines(tr), str(path))
        return json.loads(path.read_text())
    ref, port = _both(script)
    assert port == ref


# ----------------------------------------------------------------------
# flight recorder
# ----------------------------------------------------------------------

def test_flight_ring_and_dump_match_reference(tmp_path):
    def script(pkg, _ladder):
        fr = pkg.FlightRecorder(name="node0", capacity=4)
        for i in range(10):
            fr.record("span", name=f"s{i}")
        ring = (len(fr), fr.n_seen, fr.n_dropped, fr.records(), fr.tail(2))
        tr = pkg.SpanTracer(enabled=True, clock=_clock())
        log = pkg.EventLog(clock=_clock())
        seen = []
        tr.on_span = lambda s: seen.append(("hook", s.name))
        fr2 = pkg.FlightRecorder(name="t", capacity=8).attach(tracer=tr,
                                                              log=log)
        with tr.span("admit", track="e", uid=1):
            pass
        tr.instant("retire", track="e", uid=1)
        log.emit("slo.alert", short_burn=3.0)
        reg = pkg.MetricsRegistry()
        reg.counter("serve.decode.dispatches").inc(5)
        path = fr2.dump(str(tmp_path / f"flight_{pkg.__name__}.jsonl"),
                        reason="crash at dispatch 10", registry=reg,
                        dispatch=10)
        header, records = pkg.FlightRecorder.load(path)
        return ring, seen, fr2.records(), header, records, fr2.n_dumps
    ref, port = _both(script)
    assert port == ref
    header, records = port[3], port[4]
    assert header["dispatch"] == 10 and records[-1]["kind"] == "metrics"
    assert all(r["kind"] in tschema.FLIGHT_RECORD_KINDS for r in records)


def test_flight_guard_dumps_on_invariant_errors_only(tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    fr = obs.FlightRecorder(name="g")
    fr.record("span", name="admit")
    with pytest.raises(InvariantError):
        with obs.flight_guard(fr, op="admit"):
            raise InvariantError("page leak", page=3)
    assert fr.dump_paths == ["flight_g.jsonl"]
    header, _ = obs.FlightRecorder.load("flight_g.jsonl")
    assert header["op"] == "admit" and "InvariantError" in header["reason"]
    # the sanitizer's error is an InvariantError
    san = PageSanitizer(strict=True)
    san.record("init", n_pages=2, page_size=8, scratch=2)
    with pytest.raises(InvariantError):
        with obs.flight_guard(fr, op="sanitizer.crosscheck"):
            san.record("free", pages=[0], holder=0)
    assert fr.n_dumps == 2
    header, _ = obs.FlightRecorder.load("flight_g.jsonl")
    assert "SanitizerError" in header["reason"]
    # nothing else dumps: not a plain AssertionError, not a ValueError
    for exc in (AssertionError("plain"), ValueError("not lifecycle")):
        with pytest.raises(type(exc)):
            with obs.flight_guard(fr, op="admit"):
                raise exc
    assert fr.n_dumps == 2
    with obs.flight_guard(None, op="x"):
        pass


# ----------------------------------------------------------------------
# SLO burn rates and the controller
# ----------------------------------------------------------------------

def _slo_script(pkg, ladder_cls):
    reg = pkg.MetricsRegistry()
    mon = pkg.BurnRateMonitor(pkg.SLOObjective(tpot_s=0.01,
                                               error_budget=0.25),
                              short_window_s=2.0, long_window_s=10.0,
                              burn_threshold=2.0, clear_threshold=1.0,
                              registry=reg)
    out = []
    for i in range(10):
        mon.observe_tpot(0.02 if i % 2 else 0.005, t=i * 0.2)
    out += [mon.burn_rates(2.0), mon.update(2.0), mon.alerts_fired]
    for i in range(10):
        mon.observe_tpot(0.005, t=2.0 + i * 0.2)
    out += [mon.burn_rates(4.0), mon.update(4.0), mon.alerts_fired]
    drop = pkg.BurnRateMonitor(pkg.SLOObjective(tpot_s=0.01),
                               short_window_s=2.0, long_window_s=10.0)
    out += [[drop.observe_ttft(0.0, t=i * 0.01) for i in range(50)]]
    for i in range(4):
        drop.observe_tpot(0.02, t=1.0 + i * 0.01)
    out += [drop.burn_rates(1.1)]
    ctl_mon = pkg.BurnRateMonitor(pkg.SLOObjective(tpot_s=1e-9,
                                                   error_budget=0.5),
                                  short_window_s=2.0, long_window_s=10.0,
                                  registry=reg)
    ladder = ladder_cls()
    ctl = pkg.SLOController(ctl_mon, ladder, escalate_every_s=1.0,
                            relax_every_s=2.0)
    for i in range(31):
        ctl_mon.observe_tpot(0.01, t=i * 0.1)
    moves = [ctl.step(t) for t in (1.0, 1.5, 2.0, 3.0, 4.0, 14.0, 16.0,
                                   18.0, 20.0)]
    out += [moves, ladder.level, ladder.transitions, ctl.actions,
            ctl.escalated, ctl.deescalated,
            json.dumps(reg.collect(), sort_keys=True)]
    return out


def test_slo_monitor_and_controller_match_reference():
    ref, port = _both(_slo_script)
    assert port == ref
    moves = port[8]
    assert moves[:4] == ["escalate", None, "escalate", "escalate"]
    assert port[9] == 0                  # walked back down
    with pytest.raises(ValueError):
        obs.SLOObjective(error_budget=0.0)


# ----------------------------------------------------------------------
# schema + dump CLI
# ----------------------------------------------------------------------

def test_schema_catalog_is_the_references():
    assert tschema.all_names() == jschema.all_names()
    for cat in ("SPAN_NAMES", "INSTANT_NAMES", "EVENT_NAMES",
                "METRIC_FAMILIES"):
        assert sorted(getattr(tschema, cat)) == sorted(getattr(jschema, cat))
    assert tschema.TIMELINE_KEYS == jschema.TIMELINE_KEYS
    assert tschema.FLIGHT_RECORD_KINDS == jschema.FLIGHT_RECORD_KINDS
    doc = open(os.path.join(ROOT, "docs", "observability.md")).read()
    assert [n for n in tschema.all_names() if n not in doc] == []
    assert len(tschema.all_names()) == len(set(tschema.all_names()))


def test_dump_cli_reads_the_ports_artifacts(tmp_path, capsys):
    tr = obs.SpanTracer(enabled=True, clock=_clock())
    _clean_life(tr, uid=2, t0=1.0)
    trace_path = str(tmp_path / "trace.json")
    tr.save(trace_path)
    fr = obs.FlightRecorder(name="node0")
    fr.attach(tracer=tr)
    with tr.span("admit", track="node0", uid=2):
        pass
    flight_path = fr.dump(str(tmp_path / "flight_node0.jsonl"),
                          reason="sanity")
    log = obs.EventLog(clock=lambda: 0.0)
    san = PageSanitizer(strict=True, log=log)
    san.record("init", n_pages=4, page_size=8, scratch=4)
    san.record("reserve", n=1, ok=True)
    san.record("alloc", pages=[1], holder=0)
    san.record("free", pages=[1], holder=0)
    pages_path = str(tmp_path / "pages.jsonl")
    with open(pages_path, "w") as f:        # the op-stream contract
        for e in log.records_prefix("page"):
            f.write(json.dumps({"op": e.name.split(".", 1)[1],
                                **e.fields}) + "\n")
    bogus = str(tmp_path / "bogus.txt")
    open(bogus, "w").write("not telemetry")

    outs = []
    for mod in (jdump, tdump):
        assert [mod.sniff(p) for p in (trace_path, flight_path, pages_path,
                                       bogus)] == ["trace", "flight",
                                                   "pages", "unknown"]
        assert mod.main([trace_path, flight_path, pages_path]) == 0
        outs.append(capsys.readouterr().out)
        assert mod.main([bogus]) == 1
        capsys.readouterr()
    assert outs[1] == outs[0]
    assert "flight dump of engine 'node0'" in outs[1]
    assert "alloc=1" in outs[1] and "free=1" in outs[1]
