"""The port's online serving layer (``pychemkin_tpu_torch.serve``) on the
CPU: the counterparts of tests/test_serve.py (buckets, batcher,
admission, deadlines, coalescing with zero first dispatches after
warmup, drain, tracing spans, rescue), and parity of the slice with the
JAX package.

- Faults: a Newton-stall fault hits one ignition lane of a batch, the
  rescue thread heals it at rung 1 and its companions equal the clean
  batch within 1e-12 relative (bitwise on the card, where each lane is
  its own block; the CPU twins' batched products round per batch width);
  the equilibrium and PSR engines solve under a ``linalg_unstable``
  fault as the reference's do (tests/test_torch_steady_faults.py heals
  one at its rung).
- Parity: the same seeded payloads through the port's ``ChemServer``
  (served, ``device="cpu"``) and the reference's ``ChemServer.solve_direct``
  for each kind: equal status codes; ignition times within 1e-4 relative
  (tests/test_torch_sweep.py); equilibrium T within 1e-9 relative, X
  within 1e-11 (tests/test_torch_equilibrium.py); PSR T within 1e-8
  relative, Y within 1e-10 (tests/test_torch_psr.py).
- A server built without ``device`` on a host without a card raises; it
  never runs on the CPU unasked.

h2o2 and short horizons keep the CPU solves cheap.
"""

import os
import queue
import signal
import threading
import time

import numpy as np
import pytest
import torch

from pychemkin_tpu import mechanism as jmech
from pychemkin_tpu import serve as jserve
from pychemkin_tpu_torch import mechanism as tmech
from pychemkin_tpu_torch import serve, telemetry
from pychemkin_tpu_torch.ops import equilibrium as teq
from pychemkin_tpu_torch.ops import thermo
from pychemkin_tpu_torch.resilience import faultinject
from pychemkin_tpu_torch.resilience.driver import GracefulStop
from pychemkin_tpu_torch.resilience.faultinject import FaultSpec
from pychemkin_tpu_torch.serve import batcher, buckets
from pychemkin_tpu_torch.serve.errors import ServerClosed, ServerOverloaded
from pychemkin_tpu_torch.serve.futures import Request, ServeFuture

from torch_port_cases import (P_ATM, h2_air, serve_equilibrium_payloads,
                              serve_ignition_payloads, serve_psr_payloads,
                              stoich_h2_air)

IGN_T_END = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mech():
    return tmech.load_embedded("h2o2")


@pytest.fixture(scope="module")
def Y_h2air(mech):
    return stoich_h2_air(mech.species_names, mech.wt)


def _server(mech, **kw):
    return serve.ChemServer(mech, device="cpu", **kw)


def _eq_payload(Y, T=1200.0):
    return dict(T=T, P=P_ATM, Y=Y, option=1)


def _compiles(rec, kinds):
    out = {k: rec.counters.get(f"serve.compiles.{k}", 0) for k in kinds}
    out["total"] = rec.counters.get("serve.compiles", 0)
    return out


def _values_bitmatch(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                              equal_nan=True), k


def _req(kind="a", key=()):
    return Request(kind=kind, key=key, payload={}, future=ServeFuture(),
                   t_submit=time.perf_counter())


# -- bucket ladder ----------------------------------------------------------

def test_buckets():
    assert buckets.normalize_ladder([32, 1, 8, 8]) == (1, 8, 32)
    for bad in ([], [0, 4]):
        with pytest.raises(ValueError):
            buckets.normalize_ladder(bad)
    ladder = (1, 8, 32)
    assert [buckets.bucket_for(n, ladder) for n in (1, 2, 8, 9)] == \
        [1, 8, 8, 32]
    with pytest.raises(ValueError):
        buckets.bucket_for(33, ladder)
    np.testing.assert_array_equal(buckets.pad_indices(3, 8),
                                  [0, 1, 2, 2, 2, 2, 2, 2])
    np.testing.assert_array_equal(buckets.pad_indices(4, 4), [0, 1, 2, 3])
    for n in (0, 5):
        with pytest.raises(ValueError):
            buckets.pad_indices(n, 4)


# -- batching policy (no server, no solves) ---------------------------------

def test_collect_returns_none_on_stopped_empty_queue():
    stop = GracefulStop()
    stop.request()
    assert batcher.collect(queue.Queue(), batcher.BatchPolicy(), stop,
                           poll_s=0.01) is None


def test_collect_caps_at_max_batch_size():
    q = queue.Queue()
    for _ in range(5):
        q.put(_req())
    got = batcher.collect(q, batcher.BatchPolicy(max_batch_size=3),
                          GracefulStop())
    assert len(got) == 3 and q.qsize() == 2


def test_collect_dispatches_lone_request_after_delay():
    q = queue.Queue()
    q.put(_req())
    t0 = time.perf_counter()
    got = batcher.collect(q, batcher.BatchPolicy(max_batch_size=8,
                                                 max_delay_ms=40.0),
                          GracefulStop())
    assert len(got) == 1 and 0.03 <= time.perf_counter() - t0 < 2.0


@pytest.mark.parametrize("stop_after_s", [0.0, 0.1])
def test_stop_cuts_the_delay_window_short(stop_after_s):
    """A drain (stop requested before or during the window) takes what is
    queued and waits for nothing."""
    q = queue.Queue()
    for _ in range(2):
        q.put(_req())
    stop = GracefulStop()
    t = threading.Timer(stop_after_s, stop.request)
    t.start()
    t0 = time.perf_counter()
    got = batcher.collect(q, batcher.BatchPolicy(max_batch_size=8,
                                                 max_delay_ms=30_000.0),
                          stop)
    t.join()
    assert len(got) == 2 and time.perf_counter() - t0 < 5.0


def test_group_splits_by_kind_and_key_in_order():
    reqs = [_req("eq", (1,)), _req("ign"), _req("eq", (2,)),
            _req("eq", (1,)), _req("ign")]
    groups = batcher.group(reqs)
    assert [(k, key, len(rs)) for k, key, rs in groups] == [
        ("eq", (1,), 2), ("ign", (), 2), ("eq", (2,), 1)]
    assert groups[0][2] == [reqs[0], reqs[3]]


# -- admission ----------------------------------------------------------------

def test_unknown_kind_and_malformed_payload_raise_at_submit(mech, Y_h2air):
    server = _server(mech)
    with pytest.raises(ValueError, match="unknown request kind"):
        server.submit("flamethrower", x=1)
    with pytest.raises(ValueError, match="shape"):
        server.submit_equilibrium(T=1200.0, P=P_ATM, Y=Y_h2air[:-1])
    with pytest.raises(ValueError, match="option"):
        server.submit_equilibrium(T=1200.0, P=P_ATM, Y=Y_h2air, option=99)
    with pytest.raises(ValueError, match="h_in or T_in"):
        server.submit_psr(tau=1e-3, P=P_ATM, Y_in=Y_h2air)


def test_overload_is_typed_rejection_with_retry_hint(mech, Y_h2air):
    rec = telemetry.MetricsRecorder()
    server = _server(mech, queue_depth=4, recorder=rec)
    futs = [server.submit_equilibrium(**_eq_payload(Y_h2air))
            for _ in range(4)]
    with pytest.raises(ServerOverloaded) as ei:
        server.submit_equilibrium(**_eq_payload(Y_h2air))
    assert ei.value.queue_depth == 4
    assert ei.value.retry_after_ms is not None and \
        ei.value.retry_after_ms > 0
    assert rec.counters["serve.rejected"] == 1
    assert rec.counters["serve.requests"] == 4
    server.close()
    for f in futs:
        with pytest.raises(ServerClosed):
            f.result(timeout=5)


def test_close_without_drain_and_submit_after_drain(mech, Y_h2air):
    server = _server(mech)
    fut = server.submit_equilibrium(**_eq_payload(Y_h2air))
    server.close(drain=False)
    with pytest.raises(ServerClosed):
        fut.result(timeout=5)
    server = _server(mech)
    server.request_drain()
    assert server.draining
    with pytest.raises(ServerClosed):
        server.submit_equilibrium(**_eq_payload(Y_h2air))


def test_default_device_needs_a_card(mech, monkeypatch):
    """Built without ``device`` on a host without a card, the server
    raises: it never runs on the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ChemServer(mech)


# -- deadlines ---------------------------------------------------------------

def test_expired_request_resolves_without_dispatch(mech, Y_h2air):
    rec = telemetry.MetricsRecorder()
    server = _server(mech, bucket_sizes=(1, 2), max_delay_ms=50.0,
                     recorder=rec)
    server.warmup(["equilibrium"])
    warm = _compiles(rec, ["equilibrium"])
    dead = server.submit_equilibrium(**_eq_payload(Y_h2air),
                                     deadline_ms=0.0)
    live = server.submit_equilibrium(**_eq_payload(Y_h2air, 1500.0),
                                     deadline_ms=60_000.0)
    with server:
        dres, lres = dead.result(timeout=60), live.result(timeout=60)
    assert dres.status_name == "DEADLINE_EXCEEDED" and not dres.ok
    assert dres.value == {} and (dres.occupancy, dres.bucket) == (0, 0)
    assert lres.ok and (lres.occupancy, lres.bucket) == (1, 1)
    assert rec.counters["serve.batches"] == 1
    assert _compiles(rec, ["equilibrium"]) == warm
    assert rec.counters["serve.deadline_expired"] == 1
    assert rec.counters["serve.status.DEADLINE_EXCEEDED"] == 1


def test_rescue_rung_gated_by_deadline(mech, Y_h2air):
    rec = telemetry.MetricsRecorder()
    server = _server(mech, recorder=rec)
    eng = server.engine("equilibrium")
    norm = eng.normalize(_eq_payload(Y_h2air))
    req = Request(kind="equilibrium", key=eng.group_key(norm),
                  payload=norm, future=ServeFuture(),
                  t_submit=time.perf_counter(),
                  deadline=time.perf_counter() - 1.0)
    meta = dict(kind="equilibrium", bucket=1, occupancy=1,
                queue_wait_ms=0.0, solve_ms=0.0)
    server._rescue_one((req, eng.group_key(norm), {"T": 0.0}, 1, 0, meta))
    res = req.future.result(timeout=5)
    assert res.status_name == "TOL_NOT_MET" and res.rescue_rungs == 0
    ev = rec.last_event("serve.rescue")
    assert ev["deadline_cut"] is True and ev["rungs"] == 0
    assert rec.counters["serve.abandoned"] == 1


# -- micro-batching and first dispatches ---------------------------------------

def test_coalesce_bitmatch_and_zero_compiles_after_warmup(mech, Y_h2air):
    rec = telemetry.MetricsRecorder()
    server = _server(mech, bucket_sizes=(1, 4), max_delay_ms=100.0,
                     recorder=rec)
    assert server.warmup(["equilibrium"]) == {"equilibrium": 2}
    assert server.warmup(["equilibrium"]) == {"equilibrium": 0}
    warm = _compiles(rec, ["equilibrium"])
    Ts = [950.0, 1400.0, 1850.0]
    with server:
        futs = [server.submit_equilibrium(**_eq_payload(Y_h2air, T))
                for T in Ts]
        res = [f.result(timeout=60) for f in futs]
        assert [r.occupancy for r in res] == [3, 3, 3]
        assert [r.bucket for r in res] == [4, 4, 4]
        assert all(r.ok and not r.rescued for r in res)
        for T, r in zip(Ts, res):
            direct = server.solve_direct("equilibrium", bucket=4,
                                         **_eq_payload(Y_h2air, T))
            _values_bitmatch(r.value, direct.value)
        solo = server.submit_equilibrium(
            **_eq_payload(Y_h2air, 1200.0)).result(timeout=60)
        assert (solo.occupancy, solo.bucket) == (1, 1)
    assert _compiles(rec, ["equilibrium"]) == warm
    snap = rec.snapshot()
    assert snap["counters"]["serve.batches"] == 2
    assert snap["counters"]["serve.status.OK"] == 4
    assert "serve.queue_depth" in snap["gauges"]
    for h in ("serve.queue_wait_ms", "serve.solve_ms",
              "serve.batch_occupancy"):
        assert snap["histograms"][h]["count"] > 0
        assert {"p50", "p95", "p99"} <= set(snap["histograms"][h])
    # one program per (key, profile flag, bucket) in the registry
    assert rec.counters["program.compiles"] == 2


def test_adaptive_schedule_zero_compiles_and_span_field(mech, Y_h2air):
    rec = telemetry.MetricsRecorder()
    server = _server(mech, bucket_sizes=(1, 4, 8), max_delay_ms=50.0,
                     recorder=rec, schedule="adaptive")
    assert server.schedule_mode == "adaptive"
    server._sched.adjust_every = 2
    server.warmup(["equilibrium"])
    warm = _compiles(rec, ["equilibrium"])
    with server:
        for _ in range(4):
            futs = [server.submit_equilibrium(
                **_eq_payload(Y_h2air, 1000.0 + 50 * i)) for i in range(3)]
            assert all(f.result(timeout=60).ok for f in futs)
    assert rec.counters.get("schedule.ladder_adjust", 0) >= 1
    assert server.policy.max_batch_size in (4, 8)
    assert _compiles(rec, ["equilibrium"]) == warm
    spans = [e for e in rec.events("trace.span")
             if e.get("span") == "serve.dispatch"]
    assert spans and all(e["schedule"] == "adaptive" for e in spans)
    state = server.schedule_state()
    assert state["mode"] == "adaptive" and state["adaptive"]["adjusts"] >= 1
    assert state["bucket_occupancy_p50"] and state["ladder"] == [1, 4, 8]


def test_static_schedule_and_unreachable_buckets(mech, Y_h2air):
    rec = telemetry.MetricsRecorder()
    server = _server(mech, bucket_sizes=(1, 4), max_batch_size=1,
                     recorder=rec)
    assert server.schedule_mode == "static"
    # max_batch_size=1: the 4-bucket is never dispatched, never warmed
    assert server.warmup(["equilibrium"]) == {"equilibrium": 1}
    with server:
        assert server.submit_equilibrium(
            **_eq_payload(Y_h2air)).result(timeout=60).ok
    st = server.schedule_state()
    assert st["mode"] == "static" and "adaptive" not in st
    spans = [e for e in rec.events("trace.span")
             if e.get("span") == "serve.dispatch"]
    assert spans and all(e["schedule"] == "static" for e in spans)


# -- drain -------------------------------------------------------------------

def test_close_drains_in_flight_and_queued(mech, Y_h2air):
    server = _server(mech, bucket_sizes=(1, 2), max_delay_ms=60_000.0)
    server.start()
    futs = [server.submit_equilibrium(**_eq_payload(Y_h2air, T))
            for T in (1000.0, 1300.0, 1600.0)]
    server.close()
    assert all(f.result(timeout=5).ok for f in futs)
    assert not server._worker.is_alive() and not server._rescuer.is_alive()


def test_close_timeout_then_late_close_still_drains(mech, Y_h2air):
    server = _server(mech, bucket_sizes=(1, 2), max_delay_ms=5.0)
    eng = server.engine("equilibrium")
    orig = eng.solve
    release = threading.Event()

    def slow_solve(payloads, bucket, key):
        release.wait(timeout=60)
        return orig(payloads, bucket, key)

    eng.solve = slow_solve
    server.start()
    fut = server.submit_equilibrium(**_eq_payload(Y_h2air))
    t0 = time.perf_counter()
    while server._queue.qsize() and time.perf_counter() - t0 < 10:
        time.sleep(0.01)
    assert server.close(timeout=0.05) is False
    assert not server._closed
    with pytest.raises(ServerClosed):
        server.submit_equilibrium(**_eq_payload(Y_h2air))
    release.set()
    assert server.close() is True
    assert fut.result(timeout=5).ok
    assert not server._worker.is_alive() and not server._rescuer.is_alive()
    assert server._rescue_q.qsize() == 0
    assert server.close() is True


def test_sigterm_drains_in_flight_batch(mech, Y_h2air):
    before = signal.getsignal(signal.SIGTERM)
    server = _server(mech, bucket_sizes=(1, 2), max_delay_ms=60_000.0)
    server.install_signal_handlers()
    server.start()
    futs = [server.submit_equilibrium(**_eq_payload(Y_h2air, T))
            for T in (1100.0, 1500.0)]
    os.kill(os.getpid(), signal.SIGTERM)
    assert all(f.result(timeout=60).ok for f in futs)
    assert server.draining
    with pytest.raises(ServerClosed):
        server.submit_equilibrium(**_eq_payload(Y_h2air))
    server.close()
    assert signal.getsignal(signal.SIGTERM) == before


# -- tracing -------------------------------------------------------------------

def test_request_life_spans_and_sampling(mech, Y_h2air, monkeypatch):
    from pychemkin_tpu_torch.telemetry import trace
    rec = telemetry.MetricsRecorder()
    server = _server(mech, bucket_sizes=(1, 4), max_delay_ms=5.0,
                     recorder=rec)
    server.warmup(["equilibrium"])
    with server:
        res = server.submit("equilibrium", trace_id="tfixed01",
                            **_eq_payload(Y_h2air)).result(timeout=120)
        assert res.ok
        spans = {ev["span"]: ev for ev in rec.events("trace.span")
                 if ev["trace"] == "tfixed01"}
        assert set(spans) == {"serve.admission", "serve.batch_window",
                              "serve.dispatch"}
        disp = spans["serve.dispatch"]
        assert disp["req_kind"] == "equilibrium"
        assert (disp["bucket"], disp["occupancy"]) == (res.bucket,
                                                       res.occupancy)
        assert disp["compile_hit"] is True and disp["status"] == "OK"
        assert disp["program_id"]
        assert disp["dur_ms"] == pytest.approx(res.solve_ms, abs=0.01)
        wait = (spans["serve.admission"]["dur_ms"]
                + spans["serve.batch_window"]["dur_ms"])
        assert wait == pytest.approx(res.queue_wait_ms, abs=1.0)
        n_spans = len(rec.events("trace.span"))
        # sampled out, or an explicit None from upstream: no spans
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "0")
        assert server.submit("equilibrium", **_eq_payload(
            Y_h2air, 1350.0)).result(timeout=120).ok
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "1.0")
        assert server.submit("equilibrium", trace_id=None, **_eq_payload(
            Y_h2air, 1400.0)).result(timeout=120).ok
        assert len(rec.events("trace.span")) == n_spans


def test_rescue_rungs_emit_spans(mech):
    class _FakeEng:
        max_rescue_rungs = 3

        def rescue_one(self, payload, key, level, elem_id):
            out = {"v": np.array([float(level)]),
                   "status": np.array([2 if level < 2 else 0])}
            return out, int(out["status"][0])

        def value_at(self, out, i):
            return {"v": float(out["v"][i])}

    rec = telemetry.MetricsRecorder()
    server = _server(mech, recorder=rec)
    server._engines["fake"] = _FakeEng()
    req = Request(kind="fake", key=(), payload={}, future=ServeFuture(),
                  t_submit=time.perf_counter(), trace_id="tr9")
    server._rescue_one((req, (), {"v": 0.0}, 2, 0,
                        dict(kind="fake", bucket=1, occupancy=1,
                             queue_wait_ms=0.0, solve_ms=0.0)))
    res = req.future.result(timeout=5)
    assert res.rescued and res.rescue_rungs == 2
    rungs = [ev for ev in rec.events("trace.span")
             if ev["span"] == "serve.rescue_rung"]
    assert [r["level"] for r in rungs] == [1, 2]
    assert [r["status"] for r in rungs] == ["NEWTON_STALL", "OK"]
    assert all(r["trace"] == "tr9" for r in rungs)


# -- faults and the rescue thread ------------------------------------------------

def _ignition_batch(mech, rec, payloads, **kw):
    server = _server(mech, bucket_sizes=(len(payloads),), max_delay_ms=50.0,
                     recorder=rec, **kw)
    futs = [server.submit("ignition", **p) for p in payloads]
    with server:
        return [f.result(timeout=300) for f in futs]


@pytest.fixture(scope="module")
def ign_payloads(mech):
    return serve_ignition_payloads(mech.species_names, mech.wt, 4, seed=2,
                                   t_end=IGN_T_END, T0=(1250.0, 1400.0))


@pytest.fixture(scope="module")
def clean_batch(mech, ign_payloads):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _ignition_batch(mech, telemetry.MetricsRecorder(),
                               ign_payloads)
    finally:
        torch.set_num_threads(n)


def test_faulted_request_rescued_companions_unaffected(mech, ign_payloads,
                                                       clean_batch):
    victim = 2
    rec = telemetry.MetricsRecorder()
    with faultinject.inject(FaultSpec("newton_stall", (victim,),
                                      heal_at=1)):
        res = _ignition_batch(mech, rec, ign_payloads)
    assert res[victim].ok and res[victim].rescued
    assert res[victim].rescue_rungs == 1
    assert np.isfinite(res[victim].value["ignition_delay_ms"])
    (ev,) = rec.events("serve.rescue")
    assert ev["rescued"] is True and ev["req_kind"] == "ignition"
    (bev,) = rec.events("serve.batch")
    assert bev["n_rescue_handoff"] == 1
    assert bev["occupancy"] == len(ign_payloads)
    assert rec.counters["serve.status.NEWTON_STALL"] == 1
    # companions: hot path, the clean batch's values. On the card (one
    # block per lane, chip_smoke.py phase 7d) they are bitwise equal; the
    # CPU twins' batched products round per batch width, and the stalled
    # lane leaves the batch after its first attempt, so here they agree
    # to rounding.
    for i, (r, c) in enumerate(zip(res, clean_batch)):
        if i != victim:
            assert r.ok and not r.rescued, i
            assert abs(r.value["ignition_time_s"]
                       / c.value["ignition_time_s"] - 1) <= 1e-12, i


def test_abandoned_fault_reports_status(mech, ign_payloads):
    rec = telemetry.MetricsRecorder()
    with faultinject.inject(FaultSpec("newton_stall", (0,), heal_at=-1)):
        r, = _ignition_batch(mech, rec, ign_payloads[:1],
                             max_rescue_rungs=1)
    assert not r.ok and not r.rescued
    assert r.status_name == "NEWTON_STALL" and r.rescue_rungs == 1
    assert rec.counters["serve.abandoned"] == 1


@pytest.mark.parametrize("kind", ["equilibrium", "psr"])
def test_steady_engines_raise_under_injection(mech, Y_h2air, kind):
    """The equilibrium and PSR engines, which this test once expected to
    raise under injection (K6 and K7 had no fault hooks), now solve with
    the fault: a ``linalg_unstable`` lane that never heals comes back
    LINALG_UNSTABLE from ``solve_direct`` and, served, is abandoned after
    the rescue ladder, with no batch error."""
    rec = telemetry.MetricsRecorder()
    server = _server(mech, bucket_sizes=(1,), max_delay_ms=5.0,
                     recorder=rec)
    payload = (_eq_payload(Y_h2air) if kind == "equilibrium" else
               dict(tau=1e-3, P=P_ATM, Y_in=Y_h2air, T_in=600.0))
    with faultinject.inject(FaultSpec("linalg_unstable", (0,))):
        direct = server.solve_direct(kind, **payload)
        assert direct.status_name == "LINALG_UNSTABLE"
        with server:
            r = server.submit(kind, **payload).result(timeout=300)
    assert not r.ok and not r.rescued and r.rescue_rungs >= 1
    assert r.status_name == "LINALG_UNSTABLE"
    assert rec.counters.get("serve.batch_errors", 0) == 0


def test_demux_error_contained_to_lane(mech, Y_h2air):
    rec = telemetry.MetricsRecorder()
    server = _server(mech, bucket_sizes=(2,), max_delay_ms=150.0,
                     recorder=rec)
    eng = server.engine("equilibrium")
    orig = eng.value_at

    def bad_lane0(out, i):
        if i == 0:
            raise RuntimeError("boom lane 0")
        return orig(out, i)

    eng.value_at = bad_lane0
    f0 = server.submit_equilibrium(**_eq_payload(Y_h2air, 1000.0))
    f1 = server.submit_equilibrium(**_eq_payload(Y_h2air, 1400.0))
    server.start()
    with pytest.raises(RuntimeError, match="boom lane 0"):
        f0.result(timeout=120)
    assert f1.result(timeout=120).ok
    assert rec.counters["serve.batch_errors"] == 1
    assert server.close() is True


# -- the slice against the JAX package --------------------------------------------

def _psr_payloads(mech):
    """Three phi-1 PSR lanes (inlet 600 K; tau 1e-4, 1e-2, 1 s) with the
    port's HP equilibrium of each inlet as the guess."""
    tm = tmech.TorchMechanism(mech, "cpu")
    Y_in = h2_air(mech.species_names, mech.wt, [1.0, 1.0, 1.0])
    T_in = np.full(3, 600.0)
    h_in = thermo.mixture_enthalpy_mass(tm, torch.tensor(T_in),
                                        torch.tensor(Y_in)).numpy()
    g = teq.equilibrate(tm, T_in, P_ATM, Y_in, option=5, device="cpu")
    return serve_psr_payloads(Y_in, h_in, np.array([1e-4, 1e-2, 1.0]),
                              g.T.numpy(), g.Y.numpy())


def _parity_payloads(kind, mech):
    if kind == "ignition":
        return serve_ignition_payloads(mech.species_names, mech.wt, 3,
                                       seed=0, t_end=IGN_T_END,
                                       T0=(1250.0, 1400.0))
    if kind == "equilibrium":
        return serve_equilibrium_payloads(mech.species_names, mech.wt, 3,
                                          seed=1)
    return _psr_payloads(mech)


@pytest.mark.parametrize("kind", ["ignition", "equilibrium", "psr"])
def test_served_values_match_reference(mech, kind):
    payloads = _parity_payloads(kind, mech)
    server = _server(mech, bucket_sizes=(4,), max_delay_ms=100.0)
    futs = [server.submit(kind, **p) for p in payloads]
    with server:
        res = [f.result(timeout=300) for f in futs]
    jserver = jserve.ChemServer(jmech.load_embedded("h2o2"))
    for p, r in zip(payloads, res):
        j = jserver.solve_direct(kind, bucket=1, **p)
        assert r.status == j.status, (r.status_name, j.status_name)
        if not j.ok:
            continue
        v, jv = r.value, j.value
        if kind == "ignition":
            assert np.isfinite(v["ignition_time_s"])
            assert abs(v["ignition_time_s"] / jv["ignition_time_s"]
                       - 1) < 1e-4
        elif kind == "equilibrium":
            assert abs(v["T"] / jv["T"] - 1) <= 1e-9
            assert np.abs(v["X"] - jv["X"]).max() <= 1e-11
            assert abs(v["h"] / jv["h"] - 1) <= 1e-9
        else:
            assert abs(v["T"] / jv["T"] - 1) <= 1e-8
            assert np.abs(v["Y"] - jv["Y"]).max() <= 1e-10
