"""The trace replay, port against reference on the CPU: ``synthetic_trace``
and ``replay_trace`` (``telemetry/trace.py``) at the reference tests' own
settings, each package driving its own ``OptimizationService`` and
``RungBarrier`` on the simulated clock.

Both packages run the same numpy float64 operations in the same order (one
``seed + 999`` generator drawn in event order, one heap with the ``(t, seq)``
tie-break), so the tolerance is exact: makespan, occupancy, the best metric,
the rung log, the timeline, every counter and gauge, every histogram of
simulated seconds, every trial's final state and the journal's bytes are
equal. The service's ``acquire_s`` and ``report_s`` histograms hold real
``perf_counter`` seconds, which differ from run to run in either package:
they are compared by count only.
"""
import dataclasses
import json
import types

import pytest

from repro.core import hypertrick as ref_hypertrick
from repro.core import search_space as ref_space
from repro.core import service as ref_service
from repro.core import simulator as ref_simulator
from repro.distributed import journal as ref_journal
from repro.telemetry import trace as ref_trace
from repro_torch.core import hypertrick, search_space, service, simulator
from repro_torch.core.service import OptimizationService, TrialStatus
from repro_torch.distributed import journal
from repro_torch.telemetry import trace

REF = types.SimpleNamespace(ht=ref_hypertrick, space=ref_space, service=ref_service,
                            sim=ref_simulator, journal=ref_journal, trace=ref_trace)
PORT = types.SimpleNamespace(ht=hypertrick, space=search_space, service=service,
                             sim=simulator, journal=journal, trace=trace)

# histograms of real perf_counter seconds (core/service.py acquire_trial,
# report_verdict): equal in count, not in value
REAL_TIME_HISTOGRAMS = ("service.acquire_s", "service.report_s")


def _uniform(pkg):
    return pkg.space.SearchSpace({"x": pkg.space.Uniform(0.0, 1.0)})


def _log_uniform(pkg):
    return pkg.space.SearchSpace({"x": pkg.space.LogUniform(0.01, 100.0)})


# name -> (policy(pkg), synthetic_trace kwargs, replay_trace kwargs): the
# reference's tests/test_telemetry.py:259, :273, :309, :327,
# tests/test_compaction.py:36-45 and tests/test_spans.py:219-230
CASES = {
    "small_host_deaths": (
        lambda p: p.ht.HyperTrick(_uniform(p), w0=24, n_phases=3, eviction_rate=0.3, seed=0),
        dict(n_hosts=8, seed=1, fail_frac=0.5, fail_horizon=4.0),
        dict(lease_ttl=3.0, seed=0)),
    "hosts_1000_rung_barrier": (
        lambda p: p.ht.HyperTrick(_uniform(p), w0=1000, n_phases=5, eviction_rate=0.3, seed=0),
        dict(n_hosts=1000, seed=7, fail_frac=0.02, fail_horizon=20.0),
        dict(bracket_eta=3, lease_ttl=10.0, seed=0)),
    "schema_random_search": (
        lambda p: p.ht.RandomSearchPolicy(_uniform(p), 12, 3, seed=0),
        dict(n_hosts=4, seed=0, fail_frac=0.25, fail_horizon=5.0),
        dict(lease_ttl=4.0)),
    "dashboard_journal": (
        lambda p: p.ht.HyperTrick(_uniform(p), w0=30, n_phases=4, eviction_rate=0.3, seed=0),
        dict(n_hosts=10, seed=2, fail_frac=0.2, fail_horizon=8.0),
        dict(bracket_eta=3, lease_ttl=5.0, seed=0)),
    "compaction_fixture": (
        lambda p: p.ht.RandomSearchPolicy(_log_uniform(p), 1000, 4, seed=0),
        dict(n_hosts=1000, seed=7, fail_frac=0.02, fail_horizon=40.0),
        dict(bracket_eta=3, lease_ttl=15.0)),
    "spans_200_hosts": (
        lambda p: p.ht.HyperTrick(_uniform(p), w0=200, n_phases=4, eviction_rate=0.3, seed=0),
        dict(n_hosts=200, seed=7, fail_frac=0.02, fail_horizon=20.0),
        dict(bracket_eta=3, lease_ttl=10.0, seed=0)),
}


def _replay(pkg, case, path):
    policy, trace_kw, replay_kw = CASES[case]
    trace_kw = dict(trace_kw)
    hosts = pkg.trace.synthetic_trace(trace_kw.pop("n_hosts"), **trace_kw)
    with pkg.journal.Journal(str(path)) as j:
        return pkg.trace.replay_trace(policy(pkg), pkg.sim.ToyWorkload(seed=0), hosts,
                                      journal=j, **replay_kw)


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """Each case replayed once by each package, journaled to a file."""
    runs = {}
    for case in CASES:
        d = tmp_path_factory.mktemp(case)
        runs[case] = {name: (_replay(pkg, case, d / f"{name}.jsonl"), d / f"{name}.jsonl")
                      for name, pkg in (("ref", REF), ("port", PORT))}
    return runs


def _trials(svc):
    """Every trial's final state: status, reports, best metric and the rest
    of its record."""
    return {tid: (r.status.value, r.hparams, r.node, r.requeued, r.bracket_id,
                  list(r.reports), r.best_metric, r.start_time, r.end_time)
            for tid, r in svc.db.trials.items()}


def _metrics(snap):
    """A metrics snapshot with its wall-clock stamps dropped and its
    real-time histograms cut to their counts."""
    hists = {k: ({"count": v["count"]} if k in REAL_TIME_HISTOGRAMS else v)
             for k, v in snap["histograms"].items()}
    return {"counters": snap["counters"], "gauges": snap["gauges"], "histograms": hists}


@pytest.mark.parametrize("n_hosts,kw", [
    (8, dict(seed=1, fail_frac=0.5, fail_horizon=4.0)),
    (1000, dict(seed=7, fail_frac=0.02, fail_horizon=20.0)),
    (4, dict(seed=0, fail_frac=0.25, fail_horizon=5.0)),
    (10, dict(seed=2, fail_frac=0.2, fail_horizon=8.0)),
    (1000, dict(seed=7, fail_frac=0.02, fail_horizon=40.0)),
    (64, dict(seed=3)),
    (50, dict(seed=11, speed_spread=0.6, fail_frac=1.0, fail_horizon=1.0)),
])
def test_synthetic_trace_gives_the_reference_hosts(n_hosts, kw):
    ours = trace.synthetic_trace(n_hosts, **kw)
    ref = ref_trace.synthetic_trace(n_hosts, **kw)
    assert [dataclasses.astuple(h) for h in ours] == [dataclasses.astuple(h) for h in ref]
    assert len(ours) == n_hosts


@pytest.mark.parametrize("case", list(CASES))
def test_replay_trace_equals_the_reference(replays, case):
    ref, _ = replays[case]["ref"]
    ours, _ = replays[case]["port"]
    assert (ours.n_hosts, ours.makespan, ours.occupancy, ours.best_metric, ours.n_trials) == (
        ref.n_hosts, ref.makespan, ref.occupancy, ref.best_metric, ref.n_trials)
    assert ours.rung_log == ref.rung_log
    assert ours.timeline == ref.timeline
    assert ours.summary() == ref.summary()
    assert _metrics(ours.metrics) == _metrics(ref.metrics)
    assert _trials(ours.service) == _trials(ref.service)
    assert json.dumps(ours.service.state_snapshot(), sort_keys=True) == json.dumps(
        ref.service.state_snapshot(), sort_keys=True)
    assert ours.service.db.summary() == ref.service.db.summary()
    for t in ours.service.db.trials.values():
        assert t.status is not TrialStatus.RUNNING


@pytest.mark.parametrize("case", list(CASES))
def test_replay_trace_journal_is_the_reference_bytes(replays, case):
    _, ref_path = replays[case]["ref"]
    _, our_path = replays[case]["port"]
    ours, ref = our_path.read_bytes(), ref_path.read_bytes()
    assert ours == ref
    assert ours.count(b"\n") > 0


@pytest.mark.parametrize("case", list(CASES))
def test_port_journal_replays_to_the_trace_state(replays, case):
    """The port's journal of a trace, fed to the port's ``replay_journal``
    in a fresh service, rebuilds the trace's final trials (as
    tests/test_compaction.py holds the reference)."""
    res, path = replays[case]["port"]
    policy, _, replay_kw = CASES[case]
    fresh = OptimizationService(policy(PORT), bracket_eta=replay_kw.get("bracket_eta"))
    n = journal.replay_journal(str(path), fresh)
    assert n == sum(1 for _ in journal.read_events(str(path)))
    want = {tid: (r.status, r.reports, r.best_metric) for tid, r in res.service.db.trials.items()}
    got = {tid: (r.status, r.reports, r.best_metric) for tid, r in fresh.db.trials.items()}
    assert got == want
    assert fresh.db.summary() == res.service.db.summary()
    assert json.dumps(fresh.state_snapshot(), sort_keys=True) == json.dumps(
        res.service.state_snapshot(), sort_keys=True)


def test_trace_replay_1000_hosts_drives_real_rung_barrier(replays):
    """tests/test_telemetry.py:273's acceptance checks, on the port."""
    res, _ = replays["hosts_1000_rung_barrier"]["port"]
    assert res.n_hosts == 1000 and res.n_trials >= 1000
    assert res.makespan > 0 and 0 < res.occupancy <= 1.0
    assert res.rung_log and res.rung_log[0]["n"] >= 990
    assert sum(len(r["demoted"]) for r in res.rung_log) > 0
    c, h = res.metrics["counters"], res.metrics["histograms"]
    assert c["server.lease_reaps"] > 0
    assert c["service.requeues"] == c["server.lease_reaps"]
    for verdict in ("park", "demote", "stop"):
        assert c[f"service.verdicts.{verdict}"] > 0, verdict
    assert c["service.env_steps"] > 0
    assert h["service.cohort_wait_s"]["count"] > 0
    assert h["service.cohort_wait_s"]["p99"] >= h["service.cohort_wait_s"]["p50"] > 0
    statuses = {}
    for t in res.service.db.trials.values():
        assert t.status is not TrialStatus.RUNNING
        statuses[t.status.value] = statuses.get(t.status.value, 0) + 1
    assert statuses.get("completed", 0) > 0
    assert statuses.get("crashed", 0) > 0


@pytest.mark.parametrize("case", ["small_host_deaths", "schema_random_search"])
def test_trace_with_host_deaths_reaps_and_requeues(replays, case):
    """tests/test_telemetry.py:259 and :309 on the port: dead hosts' leases
    reaped, their configurations re-issued, every metric in the schema."""
    from repro_torch.telemetry.metrics import METRIC_SCHEMA
    res, _ = replays[case]["port"]
    assert res.metrics["counters"]["server.lease_reaps"] > 0
    assert res.n_trials > sum(1 for t in res.service.db.trials.values() if not t.requeued)
    names = (list(res.metrics["counters"]) + list(res.metrics["gauges"])
             + list(res.metrics["histograms"]))
    for name in names:
        assert name in METRIC_SCHEMA, name


def test_replay_trace_wedge_guard_raises_as_the_reference():
    """``max_sim_s`` stops a trace that runs past it, in both packages."""
    for pkg in (REF, PORT):
        policy = pkg.ht.HyperTrick(_uniform(pkg), w0=8, n_phases=3, eviction_rate=0.3, seed=0)
        with pytest.raises(RuntimeError, match="max_sim_s"):
            pkg.trace.replay_trace(policy, pkg.sim.ToyWorkload(seed=0),
                                   pkg.trace.synthetic_trace(4, seed=0), max_sim_s=0.5)


def test_simulator_reexports_the_trace():
    for name in ("HostSpec", "TraceResult", "replay_trace", "synthetic_trace"):
        assert getattr(simulator, name) is getattr(trace, name), name
    assert trace.ENV_STEPS_PER_UNIT == ref_trace.ENV_STEPS_PER_UNIT
