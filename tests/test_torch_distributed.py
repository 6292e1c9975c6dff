"""The control plane, port against reference: the wire protocol byte for
byte, either package's worker against the other's server, journals
(replay, compaction, spans) of one 1000-host trace, the reference's server
scenarios run against the port, and ``ProcessCluster`` with real worker
processes (synthetic, LM on the CPU, Hyperband's rung barrier).

The reference's control plane is numpy and the standard library only, so
the same seeds give bit-identical frames, journals and decisions. Every
wait here is bounded (short leases, ``communicate`` / ``join`` timeouts):
a hung worker fails its test instead of stalling the suite."""
import dataclasses
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import executor as ref_executor  # noqa: E402
from repro.core import hypertrick as ref_hypertrick  # noqa: E402
from repro.core import scheduler as ref_scheduler  # noqa: E402
from repro.core import search_space as ref_space  # noqa: E402
from repro.core import service as ref_service  # noqa: E402
from repro.core.simulator import ToyWorkload  # noqa: E402
from repro.distributed import client as ref_client  # noqa: E402
from repro.distributed import journal as ref_journal  # noqa: E402
from repro.distributed import protocol as ref_proto  # noqa: E402
from repro.distributed import server as ref_server  # noqa: E402
from repro.distributed import worker as ref_worker  # noqa: E402
from repro.telemetry import spans as ref_spans  # noqa: E402
from repro.telemetry.trace import replay_trace, synthetic_trace  # noqa: E402
from repro_torch.core import executor, hypertrick, scheduler, search_space, service  # noqa: E402
from repro_torch.core.service import OptimizationService, TrialStatus  # noqa: E402
from repro_torch.distributed import journal, worker  # noqa: E402
from repro_torch.distributed import protocol as proto  # noqa: E402
from repro_torch.distributed.client import Pending, ServiceClient  # noqa: E402
from repro_torch.distributed.journal import Journal, read_events, replay_journal  # noqa: E402
from repro_torch.distributed.server import MetaoptServer  # noqa: E402
from repro_torch.distributed.worker import WorkerAgent, make_synthetic_objective  # noqa: E402
from repro_torch.launch import tune  # noqa: E402
from repro_torch.telemetry import spans  # noqa: E402

# LM trials in worker processes against the same trials on a thread: the
# same f32 plain path from the same seed, one thread a process
LM_ATOL = 1e-5


def _space(pkg=search_space):
    return pkg.SearchSpace({"x": pkg.LogUniform(0.01, 100.0)})


def _wait_until(cond, deadline=10.0, step=0.02):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


@pytest.fixture
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one intra-op thread each
    (several run at once), and no card, whatever the host has."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")


# ---------------------------------------------------------------------------
# (a) the protocol: the same registry, the same bytes
# ---------------------------------------------------------------------------
def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else "required",
             f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)]


def test_registries_have_the_same_types_and_fields():
    assert sorted(proto._REGISTRY) == sorted(ref_proto._REGISTRY)
    for name, cls in proto._REGISTRY.items():
        ref = ref_proto._REGISTRY[name]
        assert cls.__name__ == ref.__name__ and cls.TYPE == ref.TYPE == name
        assert _fields(cls) == _fields(ref), name
        assert getattr(cls, "OMIT_IF_NONE", ()) == getattr(ref, "OMIT_IF_NONE", ())
    assert proto.MAX_MESSAGE_BYTES == ref_proto.MAX_MESSAGE_BYTES


# a value for each field, by its annotation: every field set ("full"), or
# only the required ones, the rest at their defaults ("minimal")
_SAMPLE = {
    "int": 7, "float": -1.25, "str": "boom", "bool": False,
    "Optional[int]": 3, "Optional[float]": 0.5, "Optional[str]": "tenant-a",
    "Optional[bool]": True,
    "Optional[Dict[str, Any]]": {"ctx": "w0-abc123", "t": 12.5},
    "Dict[str, Any]": {"n_trials": 4, "by_status": {"completed": 3, "killed": 1}},
    "list": [{"trial_id": 1, "phase": 0, "metric": 1.5, "t_start": 0.1, "t_end": 0.4},
             {"trial_id": 2, "hparams": {"lr": 1e-3, "t_max": 20}, "bracket_id": 1}],
    "Optional[list]": [{"trial_id": 9, "hparams": {"x": 2.0}}],
}


def _sample_kwargs(cls, full: bool) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        required = (f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING)
        if full or required:
            out[f.name] = _SAMPLE[f.type]
    return out


@pytest.mark.parametrize("full", [True, False], ids=["full", "minimal"])
@pytest.mark.parametrize("type_name", sorted(ref_proto._REGISTRY))
def test_encode_gives_the_reference_bytes(type_name, full):
    kwargs = _sample_kwargs(ref_proto._REGISTRY[type_name], full)
    ours = proto._REGISTRY[type_name](**kwargs)
    ref = ref_proto._REGISTRY[type_name](**kwargs)
    frame = proto.encode(ours)
    assert frame == ref_proto.encode(ref)
    # each side decodes the other's frame into its own message
    assert proto.decode(ref_proto.encode(ref)[4:]) == ours
    assert ref_proto.decode(frame[4:]) == ref


_JSON_LEAF = st.one_of(st.none(), st.booleans(), st.integers(-2**40, 2**40),
                       st.floats(allow_nan=False, allow_infinity=False),
                       st.text(max_size=12))
_JSON = st.recursive(_JSON_LEAF, lambda inner: st.one_of(
    st.lists(inner, max_size=3), st.dictionaries(st.text(max_size=6), inner, max_size=3)),
    max_leaves=8)


@settings(max_examples=150, deadline=None)
@given(type_name=st.sampled_from(sorted(ref_proto._REGISTRY)), data=st.data())
def test_encode_gives_the_reference_bytes_for_drawn_values(type_name, data):
    """Any JSON-able field values (numpy scalars too, through
    ``json_default``): the same frame on both sides, and the same
    FrameBuffer split of it fed in drawn pieces."""
    kwargs = {}
    for f in dataclasses.fields(ref_proto._REGISTRY[type_name]):
        v = data.draw(_JSON, label=f.name)
        if isinstance(v, float) and data.draw(st.booleans(), label=f.name + " numpy"):
            v = np.float32(v) if abs(v) < 1e30 else np.float64(v)
        kwargs[f.name] = v
    frame = proto.encode(proto._REGISTRY[type_name](**kwargs))
    assert frame == ref_proto.encode(ref_proto._REGISTRY[type_name](**kwargs))
    cut = data.draw(st.integers(0, len(frame)), label="cut")
    ours, ref = proto.FrameBuffer(), ref_proto.FrameBuffer()
    got = ours.feed(frame[:cut]) + ours.feed(frame[cut:])
    want = ref.feed(frame[:cut]) + ref.feed(frame[cut:])
    assert [proto.encode(m) for m in got] == [ref_proto.encode(m) for m in want] == [frame]
    assert ours.pending() == ref.pending() == 0


def test_protocol_roundtrip_all_messages():
    msgs = [
        proto.AcquireRequest(node=3),
        proto.AcquireResponse(7, {"lr": 1e-3, "t_max": 20}, n_phases=5),
        proto.AcquireResponse(None, None, 5, retry_after=0.5),
        proto.ReportRequest(7, 2, -1.25, t_start=0.1, t_end=0.9, node=3),
        proto.ReportResponse("continue"),
        proto.HeartbeatRequest(7),
        proto.HeartbeatResponse(ok=False),
        proto.CrashRequest(7, reason="boom"),
        proto.CrashResponse(),
        proto.SummaryRequest(),
        proto.SummaryResponse({"n_trials": 4, "by_status": {"running": 4}}),
        proto.ShutdownRequest(),
        proto.ShutdownResponse(),
        proto.ErrorResponse("unknown trial 99"),
    ]
    for msg in msgs:
        assert proto.decode(proto.encode(msg)[4:]) == msg


@pytest.mark.timeout(60)
def test_protocol_framing_over_socketpair():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    sent = [proto.AcquireRequest(node=i) for i in range(5)]
    for m in sent:
        proto.send_message(a, m)
    assert [proto.recv_message(b) for _ in sent] == sent
    a.close()
    assert proto.recv_message(b) is None        # clean EOF
    b.close()


def test_protocol_rejects_what_the_reference_rejects():
    bad = [b"not json", json.dumps({"type": "no_such_verb"}).encode(),
           json.dumps({"no": "type"}).encode(), json.dumps({"type": "report"}).encode(),
           b"\xff\xfe"]
    for payload in bad:
        with pytest.raises(proto.ProtocolError):
            proto.decode(payload)
        with pytest.raises(ref_proto.ProtocolError):
            ref_proto.decode(payload)
    big = ref_proto._HEADER.pack(proto.MAX_MESSAGE_BYTES + 1)
    with pytest.raises(proto.ProtocolError, match="too large"):
        proto.FrameBuffer().feed(big)


# ---------------------------------------------------------------------------
# (b) wire interop: either package's worker against the other's server
# ---------------------------------------------------------------------------
PKGS = {
    "ref": dict(policy=ref_hypertrick.RandomSearchPolicy, service=ref_service,
                server=ref_server.MetaoptServer, client=ref_client.ServiceClient,
                agent=ref_worker.WorkerAgent, objective=ref_worker.make_synthetic_objective,
                space=ref_space, journal=ref_journal.Journal),
    "port": dict(policy=hypertrick.RandomSearchPolicy, service=service,
                 server=MetaoptServer, client=ServiceClient, agent=WorkerAgent,
                 objective=make_synthetic_objective, space=search_space, journal=Journal),
}


def _interop_search(server_pkg, worker_pkg, path):
    """A 4-trial, 2-phase random search on one node: ``worker_pkg``'s
    agent against ``server_pkg``'s journaled server. Returns the server's
    summary and its journal without clocks, trace ids and spans."""
    s, w = PKGS[server_pkg], PKGS[worker_pkg]
    svc = s["service"].OptimizationService(
        s["policy"](_space(s["space"]), n_trials=4, n_phases=2, seed=0))
    jr = s["journal"](path)
    with s["server"](svc, lease_ttl=10.0, journal=jr) as srv:
        c = w["client"](srv.host, srv.port, timeout=30.0)
        t = threading.Thread(target=w["agent"](c, w["objective"](), heartbeat_interval=0.1,
                                               node=0).run)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        c.close()
    jr.close()
    events = [{k: v for k, v in ev.items() if k not in ("t", "ts", "ctx")}
              for ev in ref_journal.read_events(path) if ev["ev"] != "span"]
    return svc.db.summary(), events


@pytest.mark.timeout(120)
@pytest.mark.parametrize("server_pkg,worker_pkg", [("port", "ref"), ("ref", "port"),
                                                   ("port", "port")])
def test_worker_against_the_other_server_gives_the_reference_search(server_pkg, worker_pkg,
                                                                    tmp_path):
    want = _interop_search("ref", "ref", str(tmp_path / "ref.jsonl"))
    got = _interop_search(server_pkg, worker_pkg, str(tmp_path / "got.jsonl"))
    assert got[0] == want[0]
    assert want[0]["n_trials"] == 4 and want[0]["by_status"] == {"completed": 4}
    assert got[1] == want[1]


# ---------------------------------------------------------------------------
# (c) journals of the 1000-host trace
# ---------------------------------------------------------------------------
def _trace_policy(pkg):
    space = search_space if pkg is hypertrick else ref_space
    return pkg.RandomSearchPolicy(_space(space), 1000, 4, seed=0)


@pytest.fixture(scope="module")
def trace_journal(tmp_path_factory):
    """The reference's 1000-host trace replayed into a journal, as
    ``tests/test_compaction.py`` builds it: parks, reaper crashes,
    requeues, spans — every event kind."""
    path = str(tmp_path_factory.mktemp("trace") / "trace.jsonl")
    with ref_journal.Journal(path) as j:
        res = replay_trace(_trace_policy(ref_hypertrick), ToyWorkload(seed=0),
                           synthetic_trace(1000, seed=7, fail_frac=0.02, fail_horizon=40.0),
                           bracket_eta=3, lease_ttl=15.0, journal=j)
    assert res.n_trials >= 1000
    return path


def _snapshot_json(svc):
    return json.dumps(svc.state_snapshot(), sort_keys=True)


def test_replay_of_the_trace_gives_the_reference_state(trace_journal):
    ours = OptimizationService(_trace_policy(hypertrick), bracket_eta=3)
    ref = ref_service.OptimizationService(_trace_policy(ref_hypertrick), bracket_eta=3)
    n = replay_journal(trace_journal, ours)
    assert n == ref_journal.replay_journal(trace_journal, ref) > 9000
    assert _snapshot_json(ours) == _snapshot_json(ref)
    assert ours.db.summary() == ref.db.summary()
    a, b = ours.acquire_trial(), ref.acquire_trial()
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.trial_id, a.hparams) == (b.trial_id, b.hparams)


def _compact_at(pkg_journal, pkg_service, pkg_policy, src, dst, frac):
    """``tests/test_compaction.py``'s live-server compaction: the first
    ``frac`` of the lines, a snapshot of the service they build, the rest
    appended after it."""
    lines = [ln for ln in open(src).read().splitlines(keepends=True) if ln.strip()]
    k = int(len(lines) * frac)
    with open(dst, "w") as f:
        f.writelines(lines[:k])
    mid = pkg_service.OptimizationService(pkg_policy, bracket_eta=3)
    mid.replay([json.loads(ln) for ln in lines[:k]], reclaim_running=False)
    with pkg_journal.Journal(dst) as j:
        j.compact(mid.state_snapshot())
        for ln in lines[k:]:
            j.append(json.loads(ln))


def test_compaction_gives_the_reference_files(trace_journal, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)   # the snapshot line's stamp
    ours, ref = str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")
    _compact_at(journal, service, _trace_policy(hypertrick), trace_journal, ours, 0.6)
    _compact_at(ref_journal, ref_service, _trace_policy(ref_hypertrick), trace_journal, ref,
                0.6)
    for suffix in ("", ".history"):
        assert open(ours + suffix, "rb").read() == open(ref + suffix, "rb").read(), suffix
    # snapshot plus tail replays as the full journal does
    full = OptimizationService(_trace_policy(hypertrick), bracket_eta=3)
    replay_journal(trace_journal, full)
    snap = OptimizationService(_trace_policy(hypertrick), bracket_eta=3)
    replay_journal(ours, snap)
    assert _snapshot_json(snap) == _snapshot_json(full)
    assert full.barrier._parked == snap.barrier._parked
    assert full.barrier.rung_log == snap.barrier.rung_log
    # the archived history and the live tail are the original stream
    assert list(journal.read_full_history(ours)) == list(read_events(trace_journal))


def _span_rows(ss):
    return [(s.name, s.ts, s.dur, s.cat, s.args) for s in ss]


def test_derive_spans_gives_the_reference_spans(trace_journal):
    events = list(read_events(trace_journal))
    ours = spans.derive_spans(events)
    assert _span_rows(ours) == _span_rows(ref_spans.derive_spans(events))
    assert {s.name for s in ours} >= {"trial.lifecycle", "trial.park", "cohort.rung"}
    assert [s.to_event() for s in ours[:50]] == [
        s.to_event() for s in ref_spans.derive_spans(events)[:50]]
    assert spans.SPAN_SCHEMA == ref_spans.SPAN_SCHEMA


def test_span_recorder_writes_what_the_reference_writes():
    ours, ref = [], []
    for sink, mod in ((ours, spans), (ref, ref_spans)):
        rec = mod.SpanRecorder(sink, clock=lambda: 100.0)
        rec.record("rpc.acquire", 12.3456789, 0.25, cat="rpc", trial_id=3, node=None)
        rec.end("trial.phase", 1.5, trial_id=3, phase=0, ctx="w0-a")
        rec.record("negative", 1.0, -1.0)
        assert rec.enabled and not mod.NULL_RECORDER.enabled
    assert ours == ref and len(ours) == 2


# ---------------------------------------------------------------------------
# (d) the reference's server scenarios, against the port
# ---------------------------------------------------------------------------
def _run_agents(srv, n_agents, objective, heartbeat_interval=0.1):
    threads, clients = [], []
    for i in range(n_agents):
        c = ServiceClient(srv.host, srv.port, timeout=30.0)
        clients.append(c)
        t = threading.Thread(target=WorkerAgent(c, objective,
                                                heartbeat_interval=heartbeat_interval,
                                                node=i).run)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=60)
    for c in clients:
        c.close()
    assert not any(t.is_alive() for t in threads)


@pytest.mark.timeout(120)
def test_server_hypertrick_search_matches_thread_schema():
    objective = make_synthetic_objective(sleep=0.001, seed=1)
    svc = OptimizationService(hypertrick.HyperTrick(_space(), w0=10, n_phases=3,
                                                    eviction_rate=0.3, seed=0))
    with MetaoptServer(svc, lease_ttl=10.0) as srv:
        _run_agents(srv, 2, objective)
        with ServiceClient(srv.host, srv.port) as c:
            remote = c.summary()
    assert remote["n_trials"] == 10
    assert sum(remote["by_status"].get(k, 0) for k in ("completed", "killed")) == 10
    assert 0 < remote["alpha"] <= 1.0
    local = executor.ThreadCluster(2, objective).run(
        hypertrick.HyperTrick(_space(), 10, 3, 0.3, seed=0)).summary()
    assert {"n_trials", "by_status", "best_metric", "best_hparams", "alpha"} <= (
        set(remote) & set(local))


@pytest.mark.timeout(120)
def test_lease_expiry_reclaims_and_requeues():
    svc = OptimizationService(hypertrick.RandomSearchPolicy(_space(), n_trials=2, n_phases=1,
                                                            seed=0))
    with MetaoptServer(svc, lease_ttl=0.3) as srv:
        dead = ServiceClient(srv.host, srv.port)
        t_dead = dead.acquire(node=0)           # acquires, then "dies"
        dead.close()
        assert _wait_until(lambda: svc.db.trials[t_dead.trial_id].status
                           is TrialStatus.CRASHED)
        with ServiceClient(srv.host, srv.port) as c:
            first = c.acquire(node=1)
            assert first.hparams == t_dead.hparams
            assert c.report(first.trial_id, 0, 1.0) == "stop"
            second = c.acquire(node=1)
            assert second is not None and not isinstance(second, Pending)
            assert c.report(second.trial_id, 0, 2.0) == "stop"
            assert c.acquire(node=1) is None
            s = c.summary()
    assert s["by_status"] == {"crashed": 1, "completed": 2} and s["n_trials"] == 3
    assert svc.db.best_trial().status is TrialStatus.COMPLETED


@pytest.mark.timeout(120)
def test_heartbeat_keeps_lease_alive_and_late_report_is_stopped():
    svc = OptimizationService(hypertrick.RandomSearchPolicy(_space(), n_trials=1, n_phases=2,
                                                            seed=0))
    with MetaoptServer(svc, lease_ttl=0.4) as srv:
        with ServiceClient(srv.host, srv.port) as c:
            trial = c.acquire(node=0)
            for _ in range(6):                  # outlive several TTLs
                time.sleep(0.15)
                assert c.heartbeat(trial.trial_id)
            assert svc.db.trials[trial.trial_id].status is TrialStatus.RUNNING
            assert _wait_until(lambda: svc.db.trials[trial.trial_id].status
                               is TrialStatus.CRASHED)
            assert not c.heartbeat(trial.trial_id)
            assert c.report(trial.trial_id, 0, 123.0) == "stop"
            assert svc.db.trials[trial.trial_id].reports == []


@pytest.mark.timeout(120)
def test_worker_crash_is_local_effect():
    configs = [{"x": 1.0}, {"x": 50.0}, {"x": 2.0}]
    svc = OptimizationService(hypertrick.RandomSearchPolicy(_space(), 3, 2, configs=configs))
    with MetaoptServer(svc, lease_ttl=10.0) as srv:
        _run_agents(srv, 2, make_synthetic_objective(crash_above=10.0))
    by_x = {t.hparams["x"]: t.status for t in svc.db.trials.values()}
    assert by_x == {1.0: TrialStatus.COMPLETED, 50.0: TrialStatus.CRASHED,
                    2.0: TrialStatus.COMPLETED}


def _records(svc):
    return {tid: (r.status, r.hparams, [m for m, _ in r.reports])
            for tid, r in svc.db.trials.items()}


@pytest.mark.timeout(120)
def test_journal_replay_resumes_mid_search(tmp_path):
    path = str(tmp_path / "journal.jsonl")

    def policy():
        return hypertrick.RandomSearchPolicy(_space(), n_trials=4, n_phases=2, seed=3)

    svc = OptimizationService(policy())
    jr = Journal(path)
    with MetaoptServer(svc, lease_ttl=30.0, journal=jr) as srv:
        with ServiceClient(srv.host, srv.port) as c:
            done = c.acquire(node=0)
            assert c.report(done.trial_id, 0, 1.0) == "continue"
            assert c.report(done.trial_id, 1, 1.5) == "stop"
            partial = c.acquire(node=0)
            assert c.report(partial.trial_id, 0, 9.0) == "continue"
            orphan = c.acquire(node=1)
    jr.close()                                  # the server "crashed" here
    # the reference's replay of the port's journal gives the same records
    ref_svc = ref_service.OptimizationService(
        ref_hypertrick.RandomSearchPolicy(_space(ref_space), n_trials=4, n_phases=2, seed=3))
    ref_journal.replay_journal(path, ref_svc)

    svc2 = OptimizationService(policy())
    jr2 = Journal(path)
    assert replay_journal(path, svc2, journal=jr2) >= 6
    assert _snapshot_json(svc2) == _snapshot_json(ref_svc)
    assert [m for m, _ in svc2.db.trials[done.trial_id].reports] == [1.0, 1.5]
    assert svc2.db.trials[done.trial_id].status is TrialStatus.COMPLETED
    assert [m for m, _ in svc2.db.trials[partial.trial_id].reports] == [9.0]
    assert svc2.db.trials[partial.trial_id].status is TrialStatus.CRASHED
    assert svc2.db.trials[orphan.trial_id].status is TrialStatus.CRASHED
    assert svc2.policy._launched == 3
    with MetaoptServer(svc2, lease_ttl=30.0, journal=jr2) as srv2:
        _run_agents(srv2, 2, make_synthetic_objective())
    jr2.close()
    statuses = [t.status for t in svc2.db.trials.values()]
    assert statuses.count(TrialStatus.COMPLETED) == 4
    assert statuses.count(TrialStatus.CRASHED) == 2
    svc3 = OptimizationService(policy())
    replay_journal(path, svc3)
    assert _records(svc3) == _records(svc2)


def test_journal_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    with Journal(path) as j:
        j.append({"ev": "acquire", "trial_id": 0, "hparams": {"x": 1.0}, "node": 0, "t": 0.0})
    with open(path, "a") as f:
        f.write('{"ev": "report", "trial_id": 0, "pha')   # torn write
    events = list(read_events(path))
    assert len(events) == 1 and events[0]["ev"] == "acquire"
    assert events == list(ref_journal.read_events(path))


@pytest.mark.timeout(120)
def test_batched_report_crash_restart_no_lost_or_double_reports(tmp_path):
    path = str(tmp_path / "journal.jsonl")

    def policy():
        return hypertrick.RandomSearchPolicy(_space(), n_trials=2, n_phases=2, seed=5)

    svc = OptimizationService(policy())
    jr = Journal(path)
    with MetaoptServer(svc, lease_ttl=30.0, journal=jr) as srv:
        with ServiceClient(srv.host, srv.port) as c:
            trials = c.acquire_batch(node=0, slots=2)
            assert len(trials) == 2
            replies = c.report_batch(
                [{"trial_id": t.trial_id, "phase": 0, "metric": 1.0 + i}
                 for i, t in enumerate(trials)], node=0)
            assert replies == ["continue", "continue"]
    jr.close()
    # the server died after journaling entry 0 of the batch, before entry 1
    lines = open(path).read().splitlines(keepends=True)
    last = max(i for i, ln in enumerate(lines) if json.loads(ln).get("ev") == "report")
    assert json.loads(lines[last])["trial_id"] == trials[1].trial_id
    with open(path, "w") as f:
        f.writelines(lines[:last] + lines[last + 1:])

    svc2 = OptimizationService(policy())
    jr2 = Journal(path)
    replay_journal(path, svc2, journal=jr2)
    t0, t1 = trials
    assert [m for m, _ in svc2.db.trials[t0.trial_id].reports] == [1.0]
    assert svc2.db.trials[t1.trial_id].reports == []
    assert svc2.db.trials[t0.trial_id].status is TrialStatus.CRASHED
    assert svc2.db.trials[t1.trial_id].status is TrialStatus.CRASHED
    with MetaoptServer(svc2, lease_ttl=30.0, journal=jr2) as srv2:
        _run_agents(srv2, 2, make_synthetic_objective())
    jr2.close()
    statuses = [t.status for t in svc2.db.trials.values()]
    assert statuses.count(TrialStatus.COMPLETED) == 2
    assert statuses.count(TrialStatus.CRASHED) == 2
    for t in svc2.db.trials.values():
        if t.status is TrialStatus.COMPLETED:
            assert len(t.reports) == 2
    svc3 = OptimizationService(policy())
    replay_journal(path, svc3)
    assert _records(svc3) == _records(svc2)


@pytest.mark.timeout(120)
def test_rung_barrier_parks_and_resolves_over_tcp():
    """Hyperband's cohorts pool at the server: ten of the port's agents on
    threads against the port's server give the cohorts
    ``tests/test_scheduler.py`` asserts."""
    hb = scheduler.HyperbandScheduler(_space(), n_phases=4, eta=2, seed=0)
    svc = OptimizationService(hb)
    with MetaoptServer(svc, lease_ttl=10.0, bracket_capacity=hb.n_trials) as srv:
        threads, clients = [], []
        for i in range(hb.n_trials):
            c = ServiceClient(srv.host, srv.port, timeout=30.0)
            clients.append(c)
            t = threading.Thread(target=WorkerAgent(c, make_synthetic_objective(),
                                                    heartbeat_interval=0.1, node=i,
                                                    bracket=True,
                                                    park_poll_interval=0.02).run)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=60)
        for c in clients:
            c.close()
    assert not any(t.is_alive() for t in threads)
    assert svc.db.summary()["by_status"] == {"killed": 5, "completed": 5}
    assert {(e["bracket"], e["phase"]): (e["n"], len(e["demoted"]))
            for e in svc.barrier.rung_log} == {(0, 0): (4, 2), (0, 1): (2, 1), (1, 1): (3, 2)}


# ---------------------------------------------------------------------------
# (e) ProcessCluster: real worker processes
# ---------------------------------------------------------------------------
@pytest.mark.timeout(300)
def test_process_cluster_end_to_end(one_thread_workers, capfd):
    policy = hypertrick.RandomSearchPolicy(_space(), n_trials=4, n_phases=2, seed=0)
    cluster = executor.ProcessCluster(2, {"kind": "synthetic", "sleep": 0.01,
                                          "device": "cpu"},
                                      lease_ttl=10.0, heartbeat_interval=0.2,
                                      worker_grace=30.0)
    res = cluster.run(policy)
    s = res.summary()
    assert s["n_trials"] == 4 and s["by_status"] == {"completed": 4}
    assert s["alpha"] == pytest.approx(1.0)
    assert len(res.records) == 8                # 4 trials x 2 phases
    assert {"n_trials", "by_status", "best_metric", "best_hparams", "wall_time",
            "occupancy", "alpha"} <= set(s)
    # each worker's closing line: its trial count and its launch counters
    closing = [c for c in map(worker.parse_closing_line, capfd.readouterr().out.splitlines())
               if c is not None]
    assert sorted(c["node"] for c in closing) == [0, 1]
    assert sum(c["trials"] for c in closing) == 4
    for c in closing:
        assert set(c["launches"]) == {"rmsnorm", "flash_attention", "gmm", "selective_scan"}
        assert not any(v for op in c["launches"].values() for v in op.values())


@pytest.mark.timeout(300)
def test_process_cluster_lm_trials_match_the_thread_backend(one_thread_workers):
    """2 LM trials of yi-9b reduced, 1 phase of 2 steps, in 2 worker
    processes on the CPU: each trial's metric as the thread backend's for
    the same trial id (the trial's seed is the search's)."""
    from repro_torch.train.trainer import make_lm_objective

    def policy():
        return hypertrick.RandomSearchPolicy(search_space.lm_space(), 2, 1, seed=0)

    spec = worker.build_spec("lm", arch="yi-9b", steps_per_phase=2, seed=0, device="cpu")
    assert spec == {"kind": "lm", "arch": "yi-9b", "steps_per_phase": 2, "seed": 0,
                    "device": "cpu"}
    res = executor.ProcessCluster(2, spec, lease_ttl=30.0, heartbeat_interval=0.5,
                                  worker_grace=60.0).run(policy())
    local = executor.ThreadCluster(1, make_lm_objective("yi-9b", 2, seed=0, device="cpu")).run(
        policy())
    got = {tid: [m for m, _ in t.reports] for tid, t in res.service.db.trials.items()}
    want = {tid: [m for m, _ in t.reports] for tid, t in local.service.db.trials.items()}
    assert set(got) == set(want) == {0, 1}
    assert {t: res.service.db.trials[t].hparams for t in got} == {
        t: local.service.db.trials[t].hparams for t in want}
    for tid in want:
        assert len(got[tid]) == 1 and np.isfinite(got[tid][0])
        np.testing.assert_allclose(got[tid], want[tid], atol=LM_ATOL, rtol=0, err_msg=str(tid))


@pytest.mark.timeout(300)
def test_hyperband_over_process_workers_gives_the_reference_rungs(one_thread_workers):
    """The reference's acceptance scenario: one Hyperband run, two
    concurrent brackets, OS-process scalar workers; the port's launcher and
    workers against the reference's on the same scheduler."""
    def run(pkg, sched, ex, spec):
        hb = sched.HyperbandScheduler(_space(pkg), n_phases=4, eta=2, seed=0)
        res = ex.ProcessCluster(hb.n_trials, spec, lease_ttl=15.0, heartbeat_interval=0.2,
                                worker_grace=30.0).run(hb)
        s = res.summary()
        return s["by_status"], {(e["bracket"], e["phase"]): (e["n"], sorted(e["demoted"]),
                                                             sorted(e["promoted"]))
                                for e in s["rungs"]}

    ours = run(search_space, scheduler, executor, {"kind": "synthetic", "sleep": 0.01,
                                                   "device": "cpu"})
    ref = run(ref_space, ref_scheduler, ref_executor, {"kind": "synthetic", "sleep": 0.01})
    assert ours == ref
    assert ours[0] == {"killed": 5, "completed": 5}
    assert {k: (n, len(d)) for k, (n, d, _) in ours[1].items()} == {
        (0, 0): (4, 2), (0, 1): (2, 1), (1, 1): (3, 2)}


@pytest.mark.timeout(300)
def test_killed_server_search_resumes_without_a_lost_or_double_report(one_thread_workers,
                                                                      tmp_path):
    """``tune --backend server``: SIGKILL the launcher's process group once
    the journal holds 4 reports, then the same command with ``--resume``.
    No (trial, phase) is journaled twice, the budget's configurations end
    completed or killed, and each metric equals the uninterrupted search's
    for the same configuration and phase."""
    import signal
    import subprocess
    import sys

    def argv(journal_path):
        return ["--backend", "server", "--objective", "synthetic", "--device", "cpu",
                "--synthetic-sleep", "0.2", "--workers", "8", "--nodes", "2", "--phases",
                "3", "--policy", "random", "--lease-ttl", "10", "--journal", journal_path]

    path = str(tmp_path / "j.jsonl")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.tune", *argv(path)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                            start_new_session=True)
    try:
        assert _wait_until(lambda: os.path.exists(path) and sum(
            e["ev"] == "report" for e in read_events(path)) >= 4, deadline=120, step=0.01)
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    killed_at = sum(e["ev"] == "report" for e in read_events(path))
    assert killed_at < 24, "the search ended before the kill"
    resumed = tune.main([*argv(path), "--resume"])
    whole = tune.main(argv(str(tmp_path / "whole.jsonl")))

    reports = [(e["trial_id"], e["phase"]) for e in read_events(path) if e["ev"] == "report"]
    assert len(reports) == len(set(reports))
    trials = resumed.service.db.trials.values()
    done = [t for t in trials if t.status is not TrialStatus.CRASHED]
    assert {t.status for t in done} <= {TrialStatus.COMPLETED, TrialStatus.KILLED}
    assert all(1 <= len(t.reports) <= 3 for t in done)
    # the budget's 8 configurations ran; the policy's stream restarts on
    # resume (the reference's replay restores its count, not its rng), so
    # the fresh draws repeat the first configurations of the whole search
    assert len(done) == 8
    key = lambda hp: json.dumps(hp, sort_keys=True)  # noqa: E731
    assert {key(t.hparams) for t in done} <= {
        key(t.hparams) for t in whole.service.db.trials.values()}
    want = {(key(t.hparams), ph): m for t in whole.service.db.trials.values()
            for ph, (m, _) in enumerate(t.reports)}
    for t in trials:
        for ph, (m, _) in enumerate(t.reports):
            assert m == want[(key(t.hparams), ph)]
    assert 0 < resumed.summary()["alpha"] <= 1


# ---------------------------------------------------------------------------
# (f) no fallback: a worker asked for cuda where there is none
# ---------------------------------------------------------------------------
@pytest.mark.timeout(120)
def test_cuda_worker_without_a_card_exits_before_it_leases(one_thread_workers, tmp_path,
                                                           capfd):
    path = str(tmp_path / "journal.jsonl")
    policy = hypertrick.RandomSearchPolicy(_space(), n_trials=4, n_phases=2, seed=0)
    cluster = executor.ProcessCluster(2, worker.build_spec("lm", device="cuda"),
                                      lease_ttl=10.0, journal_path=path, worker_grace=30.0)
    with pytest.raises(RuntimeError, match="all 2 workers failed"):
        cluster.run(policy)
    events = list(read_events(path))
    assert [e["ev"] for e in events] == ["worker_exit", "worker_exit"]
    assert all(e["exit_code"] == 1 for e in events)
    assert "device 'cuda' requested" in capfd.readouterr().err


@pytest.mark.timeout(240)
def test_socket_launcher_imports_no_torch_and_a_cuda_search_fails_in_its_workers(
        one_thread_workers, tmp_path):
    """On the process and server backends only the workers train: the
    launcher never loads torch, and a search asked for ``cuda`` without a
    card ends in "all workers failed" once every worker refused it."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from repro_torch.launch import tune\n"
            "tune.main(sys.argv[1:])\n"
            "assert 'torch' not in sys.modules, 'the launcher imported torch'\n")
    argv = ["--objective", "synthetic", "--workers", "2", "--nodes", "2", "--phases", "1",
            "--synthetic-sleep", "0.01", "--lease-ttl", "10"]
    for backend in ("process", "server"):
        ran = subprocess.run([sys.executable, "-c", code, "--backend", backend, *argv,
                              "--journal", str(tmp_path / f"{backend}.jsonl"), "--device",
                              "cpu"], capture_output=True, text=True, timeout=100)
        assert ran.returncode == 0, (backend, ran.stderr[-2000:])
    refused = subprocess.run([sys.executable, "-c", code, "--backend", "process", *argv],
                             capture_output=True, text=True, timeout=100)
    assert refused.returncode != 0
    assert "device 'cuda' requested" in refused.stderr
    assert "all 2 workers failed" in refused.stderr


@pytest.mark.timeout(60)
def test_worker_main_refuses_cuda_and_slots_without_connecting(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # no server listens on the port: each refusal comes before any connection
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert worker.main(["--port", str(port), "--objective", "lm"]) == 1
    assert "device 'cuda' requested" in capsys.readouterr().err
    # --slots > 1: a population worker, which checks the device before it
    # connects too; a spec it cannot train is refused
    assert worker.main(["--port", str(port), "--spec", '{"kind": "rl"}', "--slots", "4"]) == 1
    assert "device 'cuda' requested" in capsys.readouterr().err
    assert worker.main(["--port", str(port), "--spec", '{"kind": "synthetic"}', "--slots",
                        "4"]) == 2
    assert "--slots 4 requires an rl or lm spec, got 'synthetic'" in capsys.readouterr().out
    # a CPU worker does connect: no server there
    assert worker.main(["--port", str(port), "--device", "cpu"]) == 1
    assert "cannot reach server" in capsys.readouterr().out


def test_build_spec_and_resolve_objective_as_the_reference():
    for kind in ("rl", "lm", "synthetic"):
        ours = worker.build_spec(kind, device="cpu")
        assert ours.pop("device") == "cpu"
        assert ours == ref_worker.build_spec(kind)
    obj = worker.resolve_objective({"kind": "synthetic", "sleep": 0.0, "device": "cuda"})
    assert obj({"x": 1.0}, 0, None) == ref_worker.make_synthetic_objective()({"x": 1.0}, 0,
                                                                             None)
    with pytest.raises(ValueError):
        worker.resolve_objective({"kind": "no_such"})


def test_closing_line_round_trips():
    obj = make_synthetic_objective()
    obj.trainers = [type("T", (), {"env_steps": 640, "updates": 5})(),
                    type("T", (), {"env_steps": 128, "updates": 1})()]
    line = worker.closing_line(3, 2, obj)
    assert line.startswith("worker node=3 ran 2 trials {")
    parsed = worker.parse_closing_line(line)
    assert parsed["node"] == 3 and parsed["trials"] == 2
    assert parsed["env_steps"] == 768 and parsed["updates"] == 6
    assert parsed["launches"]["rmsnorm"]["launches_block"] >= 0
    assert worker.parse_closing_line("worker node=None ran 0 trials {}") == {
        "node": None, "trials": 0}
    assert worker.parse_closing_line("some other output") is None


def test_closing_line_is_one_write_on_an_unbuffered_stdout(monkeypatch):
    """Workers share their launcher's stdout pipe: on an unbuffered stdout
    (``PYTHONUNBUFFERED``) ``print`` writes the newline apart, and another
    worker's line can land between; ``write_line`` makes one write."""
    import io

    class Raw(io.RawIOBase):
        def __init__(self):
            self.writes = []

        def writable(self):
            return True

        def write(self, b):
            self.writes.append(bytes(b))
            return len(b)

    raw = Raw()
    monkeypatch.setattr("sys.stdout", io.TextIOWrapper(raw, write_through=True))
    print("worker node=1 ran 2 trials {}", flush=True)
    assert len(raw.writes) == 2          # the fault the single write avoids
    raw.writes.clear()
    worker.write_line("worker node=1 ran 2 trials {}")
    assert raw.writes == [b"worker node=1 ran 2 trials {}\n"]
