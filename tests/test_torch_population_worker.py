"""The population worker, port against reference: ``RemoteDriver`` and
``population/worker.py`` (one engine a process leasing a batch of trials
over TCP), the ``engine.*`` spans, the worker CLI's dispatch of
``--slots > 1`` and ``ProcessCluster(slots=...)``.

The reference's remote cases (tests/test_population.py's population
workers, tests/test_bracket_barrier.py's pooled bracket, tests/test_spans.py's
engine spans) run here against the port's server on the CPU. The engine
over ``RemoteDriver`` is held bit-equal to the same engine over
``LocalDriver``, and ``RemoteDriver``'s frames byte-equal to the
reference's ``RemoteDriver``'s for the same calls. Every wait is bounded:
a hung worker fails its test instead of stalling the suite."""
import collections
import json
import math
import socket
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import executor as ref_executor  # noqa: E402
from repro.core import hypertrick as ref_hypertrick  # noqa: E402
from repro.core import search_space as ref_space  # noqa: E402
from repro.core import service as ref_service  # noqa: E402
from repro.distributed import client as ref_client  # noqa: E402
from repro.distributed import protocol as ref_proto  # noqa: E402
from repro.distributed import worker as ref_worker  # noqa: E402
from repro.population import engine as ref_engine  # noqa: E402
from repro.telemetry import spans as ref_spans  # noqa: E402
from repro_torch.core import executor, hypertrick, search_space, service  # noqa: E402
from repro_torch.core.hypertrick import HyperTrick, RandomSearchPolicy  # noqa: E402
from repro_torch.core.scheduler import ReportReply  # noqa: E402
from repro_torch.core.search_space import Categorical, LogUniform, SearchSpace  # noqa: E402
from repro_torch.core.service import OptimizationService, TrialStatus  # noqa: E402
from repro_torch.distributed import client as port_client  # noqa: E402
from repro_torch.distributed import protocol as proto  # noqa: E402
from repro_torch.distributed import worker  # noqa: E402
from repro_torch.distributed.client import RemoteTrial, ServiceClient, ServiceError  # noqa: E402
from repro_torch.distributed.server import MetaoptServer  # noqa: E402
from repro_torch.population import worker as pop_worker  # noqa: E402
from repro_torch.population.engine import (LocalDriver, PopulationEngine,  # noqa: E402
                                           RemoteDriver, TrialLease)
from repro_torch.population.objectives.lm import LMObjective  # noqa: E402
from repro_torch.population.worker import PopulationWorkerAgent  # noqa: E402
from repro_torch.telemetry.spans import SpanRecorder  # noqa: E402

HP = {"learning_rate": 3e-4, "gamma": 0.99, "t_max": 4}


def _tiny_space(s=search_space):
    return s.SearchSpace({"learning_rate": s.LogUniform(1e-4, 1e-3),
                          "t_max": s.Categorical((4,)), "gamma": s.Categorical((0.99,))})


def _lm_space():
    return SearchSpace({"learning_rate": LogUniform(1e-4, 1e-3),
                        "loss_chunk": Categorical((32,)), "grad_clip": Categorical((1.0,)),
                        "warmup_steps": Categorical((1,))})


LM_LEASE_TTL = 120.0


def _server(policy, lease_ttl=10.0):
    svc = OptimizationService(policy)
    return MetaoptServer(svc, lease_ttl=lease_ttl), svc


def _ga3c_engine(slots, **kw):
    kw.setdefault("episodes_per_phase", 2)
    kw.setdefault("max_updates", 10)
    return PopulationEngine("pong", max_slots=slots, n_envs=2, seed=0, device="cpu", **kw)


def _lm_engine(slots, **kw):
    return PopulationEngine(LMObjective(batch=2, seq=16, device="cpu"), max_slots=slots,
                            episodes_per_phase=2, max_updates=10, seed=0, device="cpu", **kw)


@pytest.fixture
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one intra-op thread each
    (several run at once), and no card, whatever the host has."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# (a) the reference's remote cases, against the port's server
# ---------------------------------------------------------------------------
@pytest.mark.timeout(120)
def test_population_worker_drains_search_over_tcp():
    """tests/test_population.py:180: one multi-slot worker leases the
    whole budget through ``slots`` and completes every trial."""
    server, svc = _server(RandomSearchPolicy(_tiny_space(), 3, 2, seed=0))
    with server:
        engine = _ga3c_engine(3)
        with ServiceClient(server.host, server.port) as client:
            n_reports = PopulationWorkerAgent(client, engine, heartbeat_interval=0.5).run()
    assert n_reports == 6                  # 3 trials x 2 phases
    assert {t.status.value for t in svc.db.trials.values()} == {"completed"}


class _LosingClient(ServiceClient):
    """A real client that loses trial ``lose``'s lease right after that
    trial's phase-0 report: the batch carrying it returns only once a
    heartbeat has said the lease is gone and the agent has told the
    driver, so the engine abandons the trial before its next step."""

    def __init__(self, *a, lose, **kw):
        super().__init__(*a, **kw)
        self.lose, self.driver = lose, None
        self.reported, self.told = threading.Event(), threading.Event()

    def heartbeat(self, trial_id):
        if trial_id == self.lose and self.reported.is_set() and not self.told.is_set():
            self.told.set()
            return False
        return super().heartbeat(trial_id)

    def report_batch(self, reports, **kw):
        out = super().report_batch(reports, **kw)
        if any(r["trial_id"] == self.lose and r["phase"] == 0 for r in reports):
            self.reported.set()
            t0 = time.monotonic()
            while self.lose not in self.driver._lost:
                assert time.monotonic() - t0 < 30, "no heartbeat lost the trial"
                time.sleep(0.01)
        return out


@pytest.mark.timeout(120)
@pytest.mark.parametrize("lose", [None, 0], ids=["reference", "lease_lost"])
def test_lm_population_worker_drains_search_over_tcp(lose):
    """tests/test_population.py:265: LM trials end to end over the wire,
    every one completed. ``lease_lost``: trial 0's lease is lost after its
    first report; its slot is abandoned, the server reaps the lease, and
    the requeued configuration is leased again and completed."""
    server, svc = _server(RandomSearchPolicy(_lm_space(), 3, 2, seed=0),
                          lease_ttl=10.0 if lose is None else 2.0)
    with server:
        engine = _lm_engine(3)
        cls = ServiceClient if lose is None else _LosingClient
        kw = {} if lose is None else {"lose": lose}
        with cls(server.host, server.port, **kw) as client:
            agent = PopulationWorkerAgent(client, engine, heartbeat_interval=0.05)
            client.driver = agent.driver
            n_reports = agent.run()
    trials = svc.db.trials
    if lose is None:
        assert n_reports == 6
        assert {t.status.value for t in trials.values()} == {"completed"}
        return
    assert n_reports == 7                  # trial 0's phase 0, then 3 trials x 2 phases
    assert trials[0].status is TrialStatus.CRASHED and len(trials[0].reports) == 1
    done = [t for t in trials.values() if t.status is TrialStatus.COMPLETED]
    assert len(done) == 3 and sum(t.requeued for t in done) == 1
    (again,) = [t for t in done if t.requeued]
    assert again.hparams == trials[0].hparams and len(again.reports) == 2


@pytest.mark.timeout(240)
def test_moe_lm_population_worker_drains_search_as_the_reference():
    """tests/test_population.py:265 with grok-1's reduced config (attention
    and a MoE block of 4 experts, top-2) on both sides: the port's worker
    agent and engine over the port's server, the reference's over the
    reference's, the same random search. Both deliver every phase report
    and complete every trial with the same configurations; each side's
    metrics are finite -losses (their weights are drawn apart)."""
    from repro.distributed.server import MetaoptServer as RefServer
    from repro.population.objectives import get_objective as ref_get_objective
    from repro.population.worker import PopulationWorkerAgent as RefAgent

    def trials(svc):
        return sorted((t.trial_id, t.status.value, tuple(sorted(t.hparams.items())),
                       len(t.reports)) for t in svc.db.trials.values())

    def metrics(svc):       # a report is (metric, time)
        return [r[0] for t in svc.db.trials.values() for r in t.reports]

    space = ref_space.SearchSpace({
        "learning_rate": ref_space.LogUniform(1e-4, 1e-3),
        "loss_chunk": ref_space.Categorical((32,)), "grad_clip": ref_space.Categorical((1.0,)),
        "warmup_steps": ref_space.Categorical((1,))})
    ref_svc = ref_service.OptimizationService(ref_hypertrick.RandomSearchPolicy(space, 3, 2,
                                                                                seed=0))
    # a lease long enough for either engine's first compile or step of the
    # MoE model on a loaded host, so that no trial is reissued
    with RefServer(ref_svc, lease_ttl=LM_LEASE_TTL) as server:
        engine = ref_engine.PopulationEngine(
            ref_get_objective("lm", arch="grok-1-314b", batch=2, seq=16), max_slots=3,
            episodes_per_phase=2, max_updates=10, seed=0)
        with ref_client.ServiceClient(server.host, server.port) as client:
            ref_reports = RefAgent(client, engine, heartbeat_interval=0.5).run()
    server, svc = _server(RandomSearchPolicy(_lm_space(), 3, 2, seed=0), lease_ttl=LM_LEASE_TTL)
    with server:
        engine = PopulationEngine(LMObjective("grok-1-314b", batch=2, seq=16, device="cpu"),
                                  max_slots=3, episodes_per_phase=2, max_updates=10, seed=0,
                                  device="cpu")
        with ServiceClient(server.host, server.port) as client:
            n_reports = PopulationWorkerAgent(client, engine, heartbeat_interval=0.5).run()
    assert n_reports == ref_reports == 6           # 3 trials x 2 phases
    assert trials(svc) == trials(ref_svc)
    assert {t.status.value for t in svc.db.trials.values()} == {"completed"}
    got = metrics(svc)
    assert len(got) == 6 and all(math.isfinite(m) and m < 0 for m in got)
    assert all(math.isfinite(m) and m < 0 for m in metrics(ref_svc))


@pytest.mark.timeout(300)
def test_two_population_workers_share_one_bracket(one_thread_workers):
    """tests/test_bracket_barrier.py:362: 2 population-worker processes x 2
    slots share ONE bracket. eta 3: either host alone (cohort 2 < eta)
    could demote nobody; the pooled cohort of 4 demotes exactly 4 // 3 = 1,
    the bottom metric across both hosts."""
    policy = RandomSearchPolicy(_tiny_space(), 4, 2, seed=0)
    cluster = executor.ProcessCluster(
        2, {"kind": "rl", "game": "pong", "episodes_per_phase": 2, "max_updates": 3, "seed": 0,
            "device": "cpu"},
        lease_ttl=30.0, heartbeat_interval=1.0, slots=2, bracket_eta=3, worker_grace=30.0)
    res = cluster.run(policy)
    s = res.summary()
    assert s["n_trials"] == 4
    rungs = s["rungs"]
    assert rungs and rungs[0]["phase"] == 0
    assert rungs[0]["n"] == 4                   # pooled across both hosts
    assert len(rungs[0]["demoted"]) == 4 // 3   # exactly bottom n // eta
    by_trial = {r.trial_id: r.metric for r in res.records if r.phase == 0}
    assert len(by_trial) == 4                   # every withheld report logged
    assert by_trial[rungs[0]["demoted"][0]] == min(by_trial.values())
    assert {r.node for r in res.records} == {0, 1}
    assert s["by_status"] == {"killed": 1, "completed": 3}
    assert res.n_nodes == 4                     # occupancy counts every slot


# ---------------------------------------------------------------------------
# (b) the engine's spans
# ---------------------------------------------------------------------------
def _span_run(pkg_engine, pkg_driver, pkg_service, pkg_policy, space, spans):
    policy = pkg_policy.RandomSearchPolicy(space, 2, 2, seed=0)
    engine = pkg_engine("pong", max_slots=2, n_envs=2, episodes_per_phase=2, max_updates=10,
                        seed=0, spans=spans)
    engine.run(pkg_driver(pkg_service.OptimizationService(policy)))


def test_engine_emits_compile_and_phase_spans():
    """tests/test_spans.py:281, and the same span names, keys and phase
    attributions as the reference's engine on the same search."""
    sink, ref_sink = [], []
    _span_run(lambda *a, **k: PopulationEngine(*a, device="cpu", **k), LocalDriver, service,
              hypertrick, _tiny_space(), SpanRecorder(sink))
    _span_run(ref_engine.PopulationEngine, ref_engine.LocalDriver, ref_service, ref_hypertrick,
              _tiny_space(ref_space), ref_spans.SpanRecorder(ref_sink))
    names = collections.defaultdict(list)
    for ev in sink:
        names[ev["name"]].append(ev)
    assert "engine.compile" in names
    comp = names["engine.compile"][0]
    assert comp["dur"] > 0 and comp["trials"] == [0, 1] and comp["bucket"] == 4
    phases = names["engine.phase"]
    assert {p["trial_id"] for p in phases} == {0, 1}
    assert all(p["dur"] >= 0 for p in phases)

    def shape(events):
        return sorted({(e["name"], tuple(sorted(e))) for e in events})

    def attribution(events):
        return sorted((e["trial_id"], e["phase"], e["slot"]) for e in events
                      if e["name"] == "engine.phase")

    assert shape(sink) == shape(ref_sink)
    assert attribution(sink) == attribution(ref_sink)
    assert [(e["bucket"], e["trials"]) for e in sink if e["name"] == "engine.compile"] == [
        (e["bucket"], e["trials"]) for e in ref_sink if e["name"] == "engine.compile"]


def test_engine_emits_clone_and_park_stall_spans():
    """The reference's ``engine.clone`` (a slot-to-slot copy) and
    ``engine.park_stall`` (a slot released from the rung barrier) spans,
    with the reference's arguments."""
    sink = []
    engine = _ga3c_engine(2, spans=SpanRecorder(sink), episodes_per_phase=10 ** 9,
                          max_updates=10 ** 9)
    engine._admit_grouped([TrialLease(i, dict(HP)) for i in range(2)], now=0.0)
    bucket = engine.buckets[4]
    engine._exploit(bucket, 1, bucket.meta[1], ReportReply("continue", clone_from=0,
                                                           perturb=dict(HP)))
    (clone,) = [e for e in sink if e["name"] == "engine.clone"]
    assert clone["trial_id"] == 1 and clone["clone_from"] == 0 and clone["dur"] >= 0

    class Resolves:
        def report_many(self, reports):
            return ["continue"] * len(reports)

    meta = bucket.meta[0]
    meta.pending, meta.parked_at = (0.5, 0.0, 1.0, 8), time.perf_counter()
    bucket.park(0)
    engine._poll_parked(Resolves(), time.monotonic())
    (stall,) = [e for e in sink if e["name"] == "engine.park_stall"]
    assert (stall["trial_id"], stall["phase"], stall["slot"]) == (0, 0, meta.slot_id)
    assert stall["cat"] == "engine" and bucket.active[0]


# ---------------------------------------------------------------------------
# (c) RemoteDriver: the same records as LocalDriver, the reference's bytes
# ---------------------------------------------------------------------------
@pytest.mark.timeout(180)
@pytest.mark.parametrize("objective", ["rl", "lm"])
def test_remote_driver_gives_the_local_drivers_records(objective):
    """One engine over a live port server and one over the in-process
    service, on the same policy: the same (trial, slot, phase, metric)
    records, bit for bit."""
    if objective == "rl":
        space, make = _tiny_space(), lambda: _ga3c_engine(4, max_updates=6)
    else:
        space, make = _lm_space(), lambda: _lm_engine(4)

    def policy():
        return HyperTrick(space, 4, 3, 0.5, seed=0)

    def rows(records):
        return sorted((tid, slot, phase, metric) for tid, slot, phase, _, _, metric in records)

    local = make().run(LocalDriver(OptimizationService(policy())))
    server, svc = _server(policy(), lease_ttl=30.0)
    with server:
        with ServiceClient(server.host, server.port) as client:
            remote = make().run(RemoteDriver(client, node=0))
    assert rows(remote) == rows(local)
    assert len(local) > 4 and {r[2] for r in local} == {0, 1, 2}
    if objective == "lm":          # GA3C's scores tie at 0 this short: no eviction
        assert any(t.status is TrialStatus.KILLED for t in svc.db.trials.values())


class _FakeSocket:
    """Records what a client sends and answers from a queue of frames."""

    def __init__(self, replies):
        self.sent = []
        self._in = bytearray(b"".join(replies))

    def sendall(self, data):
        self.sent.append(bytes(data))

    def recv(self, n):
        chunk = bytes(self._in[:n])
        del self._in[:n]
        return chunk

    def settimeout(self, t):
        pass

    def close(self):
        pass


def _fake_client(pkg_client, replies):
    c = pkg_client.ServiceClient.__new__(pkg_client.ServiceClient)
    c._sock, c._lock = _FakeSocket(replies), threading.Lock()
    c.trace_ctx, c.search = "pop3-a1b2c3", None
    return c


def _driver_calls(pkg_proto, pkg_client, pkg_driver):
    """The same calls through one package's RemoteDriver over a fake socket:
    what it returned and the bytes it sent."""
    replies = [
        pkg_proto.encode(pkg_proto.AcquireBatchResponse(
            leases=[{"trial_id": 0, "hparams": dict(HP)},
                    {"trial_id": 1, "hparams": dict(HP, t_max=8)}], n_phases=3)),
        pkg_proto.encode(pkg_proto.ReportBatchResponse(replies=[
            {"decision": "continue"}, {"decision": "parked"}, {"error": "unknown trial"}])),
        pkg_proto.encode(pkg_proto.ErrorResponse(error="stale search")),
        pkg_proto.encode(pkg_proto.ReportResponse(decision="stop")),
        pkg_proto.encode(pkg_proto.AcquireBatchResponse(leases=[], n_phases=3,
                                                        retry_after=0.5)),
        pkg_proto.encode(pkg_proto.AcquireBatchResponse(leases=[], n_phases=3)),
    ]
    client = _fake_client(pkg_client, replies)
    driver = pkg_driver(client, node=3)
    driver.set_timebase(time.monotonic() - 12.5)
    reports = [{"trial_id": 0, "phase": 0, "metric": -1.25, "t_start": 0.5, "t_end": 2.0,
                "env_steps": 640},
               {"trial_id": 1, "phase": 0, "metric": 0.75, "t_start": 0.5, "t_end": 2.25,
                "env_steps": None},
               {"trial_id": 9, "phase": 2, "metric": 3.0, "t_start": 1.0, "t_end": 2.5}]
    got = [[(t.trial_id, t.hparams, t.n_phases) for t in driver.acquire_many(4, rung=0)[0]],
           [str(d) for d in driver.report_many(reports)],
           [str(d) for d in driver.report_many(reports[:2])],
           str(driver.report(0, 1, 0.5, 2.0, 3.0, env_steps=64)),
           driver.acquire_many(2), driver.acquire_many(2)]
    driver.mark_lost(1)
    got.append((driver.poll_lost(), driver.poll_lost()))
    return got, client._sock.sent


def test_remote_driver_sends_the_reference_drivers_bytes(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    ours, our_bytes = _driver_calls(proto, port_client, RemoteDriver)
    ref, ref_bytes = _driver_calls(ref_proto, ref_client, ref_engine.RemoteDriver)
    assert our_bytes == ref_bytes
    assert len(our_bytes) == 6
    assert ours == ref
    assert ours[1] == ["continue", "parked", "stop"] and ours[2] == ["stop", "stop"]
    assert ours[4] == ([], 0.5) and ours[5] == ([], None) and ours[6] == ({1}, set())
    sent = [json.loads(b[4:]) for b in our_bytes]
    assert sent[0]["type"] == "acquire_batch" and sent[0]["slots"] == 4 and sent[0]["rung"] == 0
    assert sent[0]["trace"] == {"ctx": "pop3-a1b2c3", "t": 12.5}
    assert sent[1]["type"] == "report_batch" and "env_steps" not in sent[1]["reports"][1]


# ---------------------------------------------------------------------------
# (d) the agent: lost leases, errors
# ---------------------------------------------------------------------------
class _ScriptedClient:
    """Grants three trials of one bucket; trial 1 parks at its first report
    and its next heartbeat says the lease is gone; trials 0 and 2 train on
    and stop after three more reports each."""
    trace_ctx = None

    def __init__(self):
        self.granted = False
        self.parked, self.lost = threading.Event(), threading.Event()
        self.after_loss = collections.Counter()
        self.heartbeats = collections.Counter()

    def acquire_batch(self, node=None, slots=1, rung=None, trace_t=None):
        if self.granted:
            return None
        self.granted = True
        return [RemoteTrial(i, dict(HP), 50) for i in range(3)]

    def report_batch(self, reports, node=None, trace_t=None):
        out = []
        for r in reports:
            tid = r["trial_id"]
            if tid == 1:
                self.parked.set()
                out.append(ReportReply("parked"))
            elif self.lost.is_set():
                self.after_loss[tid] += 1
                out.append(ReportReply("stop" if self.after_loss[tid] == 3 else "continue"))
            else:
                out.append(ReportReply("continue"))
        return out

    def heartbeat(self, trial_id):
        self.heartbeats[trial_id] += 1
        if trial_id == 1 and self.parked.is_set():
            self.lost.set()
            return False
        return True


@pytest.mark.timeout(120)
def test_lost_lease_abandons_only_its_slot():
    client = _ScriptedClient()
    engine = _ga3c_engine(3, episodes_per_phase=1, max_updates=2)
    n = PopulationWorkerAgent(client, engine, heartbeat_interval=0.02).run()
    assert client.lost.is_set()
    # the parked report of the lost trial was never delivered as a record
    assert all(r[0] != 1 for r in engine.records)
    # the other two slots kept training after the loss
    assert client.after_loss == {0: 3, 2: 3}
    by_trial = collections.Counter(r[0] for r in engine.records)
    assert by_trial[0] >= 4 and by_trial[2] >= 4 and n == len(engine.records)
    assert engine.n_occupied == 0 and engine.active_trial_ids() == []


class _BrokenClient:
    trace_ctx = None

    def __init__(self, exc, grant=False):
        self.exc, self.grant = exc, grant

    def acquire_batch(self, **kw):
        if self.grant:
            self.grant = False
            return [RemoteTrial(0, dict(HP), 2)]
        raise self.exc

    def heartbeat(self, trial_id):
        return True


@pytest.mark.timeout(60)
@pytest.mark.parametrize("exc", [ServiceError("stale search"),
                                 proto.ProtocolError("server closed the connection"),
                                 ConnectionResetError("reset")],
                         ids=["service_error", "protocol_error", "os_error"])
def test_agent_ends_cleanly_when_the_server_goes(exc):
    agent = PopulationWorkerAgent(_BrokenClient(exc), _ga3c_engine(1), heartbeat_interval=0.05)
    assert agent.run() == 0
    assert agent._stop.is_set()


@pytest.mark.timeout(60)
def test_agent_lets_an_engine_error_propagate(monkeypatch):
    """An engine or CUDA error (an OOM) must not end the worker as "server
    gone": it would loop through reap -> requeue -> the same OOM."""
    engine = _ga3c_engine(1)

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(engine, "_poll_phases", oom)
    agent = PopulationWorkerAgent(_BrokenClient(ServiceError("unused"), grant=True), engine,
                                  heartbeat_interval=0.05)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        agent.run()
    assert agent._stop.is_set()


# ---------------------------------------------------------------------------
# (e) the CLIs: the population worker, the worker's dispatch, ProcessCluster
# ---------------------------------------------------------------------------
@pytest.mark.timeout(60)
def test_population_worker_refuses_before_it_connects(monkeypatch, capsys):
    port = _free_port()        # nothing listens: any refusal comes before a connection
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pop_worker.main(["--port", str(port), "--slots", "4"]) == 1
    out = capsys.readouterr()
    assert "device 'cuda' requested" in out.err and "cannot reach" not in out.out
    # a MoE arch builds its engine and connects: no server there
    assert pop_worker.main(["--port", str(port), "--objective", "lm", "--arch", "grok-1-314b",
                            "--device", "cpu"]) == 1
    assert "cannot reach server" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="not owed on one card"):
        pop_worker.main(["--port", str(port), "--devices", "2", "--device", "cpu"])
    # a CPU worker does build its engine and connect: no server there
    assert pop_worker.main(["--port", str(port), "--device", "cpu", "--n-envs", "2"]) == 1
    assert "cannot reach server" in capsys.readouterr().out


def test_population_closing_line_round_trips():
    engine = _ga3c_engine(2)
    engine.total_env_steps, engine.total_updates = 768, 6
    engine.metrics.histogram("engine.step_s").observe(0.1)
    line = pop_worker.closing_line(1, 14, engine)
    assert line.startswith("population worker node=1 delivered 14 phase reports "
                           "(768 env steps) {")
    parsed = worker.parse_closing_line(line)
    assert parsed["node"] == 1 and parsed["reports"] == 14
    assert (parsed["env_steps"], parsed["updates"], parsed["engine_steps"]) == (768, 6, 1)
    assert parsed["launches"]["rmsnorm"]["launches_slots"] >= 0
    assert worker.parse_closing_line(
        "population worker node=None delivered 0 phase reports (0 env steps) {}") == {
        "node": None, "reports": 0}


@pytest.mark.parametrize("spec,extra", [
    ({"kind": "rl", "game": "boxing", "episodes_per_phase": 8, "seed": 3, "device": "cpu"},
     ["--bracket", "--node", "2"]),
    ({"kind": "rl", "game": "pong", "episodes_per_phase": 2, "max_updates": 3, "seed": 0},
     []),
    ({"kind": "lm", "arch": "yi-9b", "steps_per_phase": 25, "seed": 0, "device": "cuda"},
     ["--node", "0"]),
], ids=["rl_bracket", "rl_no_device", "lm"])
def test_worker_slots_dispatch_as_the_reference(monkeypatch, spec, extra):
    """``--slots > 1`` hands the spec to the population worker with the
    reference's arguments, and the spec's device (``--device``'s where it
    has none)."""
    seen = {}
    monkeypatch.setattr(pop_worker, "main", lambda argv: seen.setdefault("port", argv) and 0)
    import repro.population.worker as ref_pop_worker
    monkeypatch.setattr(ref_pop_worker, "main", lambda argv: seen.setdefault("ref", argv) and 0)
    argv = ["--port", "9", "--spec", json.dumps(spec), "--slots", "6",
            "--heartbeat-interval", "0.5", *extra]
    worker.main(argv)
    ref_worker.main(argv)
    ours = list(seen["port"])
    i = ours.index("--device")
    assert ours[i + 1] == spec.get("device", "cuda")
    del ours[i:i + 2]
    assert ours == seen["ref"]


def test_process_cluster_worker_command_as_the_reference():
    for slots, eta in ((1, None), (4, None), (4, 3)):
        spec = {"kind": "rl", "game": "pong", "seed": 0}
        ours = executor.ProcessCluster(2, spec, slots=slots, bracket_eta=eta)
        ref = ref_executor.ProcessCluster(2, spec, slots=slots, bracket_eta=eta)
        cmd, ref_cmd = ours._worker_cmd(5000, 1), ref._worker_cmd(5000, 1)
        assert cmd[2] == "repro_torch.distributed.worker"
        assert ref_cmd[2] == "repro.distributed.worker"
        assert cmd[3:] == ref_cmd[3:]
        assert ("--slots" in cmd) == (slots > 1)
