"""The journal's readers, port against reference, on the CPU: the tailer
(``telemetry/tailer.py``), the Chrome-trace export (``export.py``), the
critical-path attribution (``critical_path.py``), the dashboard
(``dashboard.py``) and the package's re-exports (``telemetry/__init__.py``).

Both packages' tools read the same journals, each written by one package:
the reference's 200-host ``replay_trace`` journal (tests/test_spans.py:219-230)
and the port's (byte-equal), a live-clock journal of each package's
``tune --backend process --objective synthetic --bracket``, and a port
journal whose population worker records its engine's ``engine.compile``,
``engine.phase`` and ``engine.park_stall`` spans beside the server's. On
every journal the two packages' outputs are equal: the trace documents as
dicts and the exported files byte for byte (in one process, since the
server tracks' tids come from the salted ``hash(verb)``), the attribution,
its tables, the dashboard's state, panel and ``--once`` output. Then the
reference's tool tests (tests/test_spans.py:233-430,
tests/test_telemetry.py:99-160 and :338-362) on the port."""
import json
import os
import subprocess
import sys
import threading
import time
import types
from collections import deque

import pytest

from repro import telemetry as ref_telemetry
from repro.core import hypertrick as ref_hypertrick
from repro.core import search_space as ref_space
from repro.core import simulator as ref_simulator
from repro.distributed import journal as ref_journal
from repro.telemetry import critical_path as ref_cp
from repro.telemetry import dashboard as ref_dashboard
from repro.telemetry import export as ref_export
from repro.telemetry import spans as ref_spans
from repro.telemetry import tailer as ref_tailer
from repro.telemetry import trace as ref_trace
from repro_torch import telemetry
from repro_torch.core import hypertrick, search_space, simulator
from repro_torch.distributed import journal
from repro_torch.telemetry import critical_path, dashboard, export, spans, tailer, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "ref": types.SimpleNamespace(
        name="repro", telemetry=ref_telemetry, ht=ref_hypertrick, space=ref_space,
        sim=ref_simulator, journal=ref_journal, cp=ref_cp, dash=ref_dashboard,
        export=ref_export, spans=ref_spans, tailer=ref_tailer, trace=ref_trace),
    "port": types.SimpleNamespace(
        name="repro_torch", telemetry=telemetry, ht=hypertrick, space=search_space,
        sim=simulator, journal=journal, cp=critical_path, dash=dashboard, export=export,
        spans=spans, tailer=tailer, trace=trace),
}
JOURNALS = ("ref_replay", "port_replay", "ref_process", "port_process", "port_engine")
# the live runs' search: 8 trials of 3 phases over 2 worker processes, one
# bracket at eta 3 (tests/test_torch_search.py's socket-backend settings)
TUNE_ARGV = ["--objective", "synthetic", "--synthetic-sleep", "0.01", "--workers", "8",
             "--nodes", "2", "--phases", "3", "--lease-ttl", "10", "--backend", "process",
             "--bracket"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(
                    [os.path.join(ROOT, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _replay(pkg, path):
    """tests/test_spans.py:219-230's simulated 200-host search."""
    p = PKGS[pkg]
    policy = p.ht.HyperTrick(p.space.SearchSpace({"x": p.space.Uniform(0.0, 1.0)}), w0=200,
                             n_phases=4, eviction_rate=0.3, seed=0)
    hosts = p.trace.synthetic_trace(200, seed=7, fail_frac=0.02, fail_horizon=20.0)
    with p.journal.Journal(path) as j:
        p.trace.replay_trace(policy, p.sim.ToyWorkload(seed=0), hosts, bracket_eta=3,
                             lease_ttl=10.0, seed=0, journal=j)


def _tune(pkg, path):
    argv = TUNE_ARGV + ["--journal", path]
    if pkg == "port":
        argv = ["--device", "cpu"] + argv
    proc = subprocess.run([sys.executable, "-m", f"{PKGS[pkg].name}.launch.tune", *argv],
                          env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _engine(path):
    """One population worker of 2 slots (GA3C on pong, on the CPU) against
    the port's server, over a bracket at eta 2; the engine's spans go into
    the server's journal."""
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    from repro_torch.core.service import OptimizationService
    from repro_torch.distributed.client import ServiceClient
    from repro_torch.distributed.server import MetaoptServer
    from repro_torch.population.engine import PopulationEngine
    from repro_torch.population.worker import PopulationWorkerAgent
    space = search_space.SearchSpace({"learning_rate": search_space.LogUniform(1e-4, 1e-3),
                                      "t_max": search_space.Categorical((4,)),
                                      "gamma": search_space.Categorical((0.99,))})
    with journal.Journal(path) as j:
        svc = OptimizationService(hypertrick.RandomSearchPolicy(space, 4, 2, seed=0),
                                  bracket_eta=2)
        with MetaoptServer(svc, lease_ttl=30.0, journal=j, bracket_capacity=2) as server:
            engine = PopulationEngine("pong", max_slots=2, n_envs=2, episodes_per_phase=2,
                                      max_updates=10, seed=0, device="cpu", bracket_eta=2,
                                      spans=spans.SpanRecorder(j))
            with ServiceClient(server.host, server.port) as client:
                assert PopulationWorkerAgent(client, engine, heartbeat_interval=0.5).run() > 0


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    d = tmp_path_factory.mktemp("journals")
    paths = {name: str(d / f"{name}.jsonl") for name in JOURNALS}
    _replay("ref", paths["ref_replay"])
    _replay("port", paths["port_replay"])
    _tune("ref", paths["ref_process"])
    _tune("port", paths["port_process"])
    _engine(paths["port_engine"])
    return paths


def _events(path):
    return list(journal.read_events(path))


def _state(view):
    return {k: (list(v) if isinstance(v, deque) else v) for k, v in vars(view).items()}


# ---------------------------------------------------------------------------
# the journals
# ---------------------------------------------------------------------------
def test_journals_hold_every_event_kind(journals):
    """The journals between them carry every event kind and span name the
    port's server, engine, population worker and trace replay write."""
    with open(journals["ref_replay"], "rb") as a, open(journals["port_replay"], "rb") as b:
        assert a.read() == b.read()
    kinds, names = set(), set()
    for name in JOURNALS:
        for ev in _events(journals[name]):
            kinds.add(ev["ev"])
            if ev["ev"] == "span":
                names.add(ev["name"])
    assert {"acquire", "report", "status", "park", "requeue", "worker_exit", "span"} <= kinds
    assert {"trial.phase", "rpc.acquire", "rpc.acquire_batch", "rpc.report_batch",
            "engine.compile", "engine.phase", "engine.park_stall"} <= names


# ---------------------------------------------------------------------------
# port == reference on every journal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", JOURNALS)
def test_build_trace_matches_reference(journals, name):
    events = _events(journals[name])
    assert list(ref_journal.read_events(journals[name])) == events
    doc = export.build_trace(events)
    assert doc == ref_export.build_trace(events)
    assert export.validate_chrome_trace(doc) == ref_export.validate_chrome_trace(doc)


@pytest.mark.parametrize("name", JOURNALS)
def test_export_journal_matches_reference(journals, name, tmp_path):
    ours, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    counts = export.export_journal(journals[name], ours)
    assert counts == ref_export.export_journal(journals[name], ref)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert counts["trial_tracks"] >= 4 and counts["complete_events"] > 0


@pytest.mark.parametrize("name", JOURNALS)
def test_export_main_exit_codes_match_reference(journals, name, tmp_path, capsys):
    n = len({ev["trial_id"] for ev in _events(journals[name]) if ev["ev"] == "acquire"})
    out = str(tmp_path / "t.json")
    for need, code in ((1, 0), (n, 0), (n + 1, 1)):
        argv = ["--journal", journals[name], "--out", out, "--require-trials", str(need)]
        assert export.main(argv) == code
        ours = capsys.readouterr().out
        assert ref_export.main(argv) == code
        assert ours == capsys.readouterr().out


@pytest.mark.parametrize("name", JOURNALS)
def test_critical_path_matches_reference(journals, name):
    events = _events(journals[name])
    per_trial = critical_path.attribute(events)
    assert per_trial == ref_cp.attribute(events)
    per_bracket = critical_path.aggregate(per_trial)
    assert per_bracket == ref_cp.aggregate(per_trial)
    assert critical_path.format_table(per_bracket) == ref_cp.format_table(per_bracket)
    table = critical_path.critical_path_report(events)
    assert table == ref_cp.critical_path_report(events)
    assert table.startswith("where did time go (per bracket):")
    walls = [r for r in per_trial.values() if r["wall"] > 0]
    assert walls
    for rec in walls:
        # within 1% of the wall (tests/test_spans.py:253); where the
        # engine's spans sit beside the server's, the bucket's first step
        # (``compile``) lies inside its ``trial.phase`` (``step``) too, in
        # either package, so the sum may exceed the wall by that share
        total = sum(rec[b] for b in critical_path.BUCKETS)
        assert rec["wall"] * 0.99 <= total <= rec["wall"] * 1.01 + rec["compile"]


@pytest.mark.parametrize("name", JOURNALS)
def test_search_view_matches_reference(journals, name, monkeypatch):
    """Post-mortem, and fed as a live tail would feed it (bounded polls,
    each batch stamped with an arrival ``mono``), under one pinned
    ``time.monotonic`` for the live rates."""
    events = _events(journals[name])
    views = [pkg.dash.SearchView() for pkg in (PKGS["port"], PKGS["ref"])]
    for v in views:
        v.apply_all(events)
    assert _state(views[0]) == _state(views[1])
    assert views[0].render(name, 0) == views[1].render(name, 0)
    assert len(views[0].trials) >= 4 and views[0].best is not None

    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    live = []
    for pkg in (PKGS["port"], PKGS["ref"]):
        tail, view = pkg.tailer.JournalTailer(journals[name], max_bytes=4096), pkg.dash.SearchView()
        n = 0
        while batch := tail.poll():
            view.apply_all(batch, mono=990.0 + n)
            n += 1
        assert tail.skipped == 0
        live.append((n, view))
    assert live[0][0] == live[1][0] > 1
    assert _state(live[0][1]) == _state(live[1][1])
    assert live[0][1].render(name, 0) == live[1][1].render(name, 0)
    for key in ("trials", "best", "best_trial", "reaps", "cohort_waits", "worker_exits"):
        assert _state(live[0][1])[key] == _state(views[0])[key], key


@pytest.mark.parametrize("name", JOURNALS)
def test_dashboard_once_matches_reference(journals, name, capsys):
    assert dashboard.main(["--journal", journals[name], "--once"]) == 0
    ours = capsys.readouterr().out
    assert ref_dashboard.main(["--journal", journals[name], "--once"]) == 0
    assert ours == capsys.readouterr().out
    assert "where did time go (per bracket):" in ours


def test_telemetry_tools_import_no_torch_or_jax():
    """The package and its four tools, imported in a fresh interpreter,
    pull in neither torch nor jax."""
    code = ("import sys; import repro_torch.telemetry; "
            "from repro_torch.telemetry import tailer, export, critical_path, dashboard; "
            "from repro_torch.telemetry import metrics, spans, trace; "
            "print(sorted(m for m in ('torch', 'jax', 'repro') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_package_reexports_match_reference():
    assert telemetry.__all__ == ref_telemetry.__all__
    assert telemetry.SPAN_SCHEMA == ref_telemetry.SPAN_SCHEMA
    # the same names; the port's ``engine.compile_s`` says what it times
    assert set(telemetry.METRIC_SCHEMA) == set(ref_telemetry.METRIC_SCHEMA)
    assert telemetry.derive_spans is spans.derive_spans
    assert critical_path.BUCKETS == ref_cp.BUCKETS


def test_journal_tools_run_as_modules(journals, tmp_path):
    """The commands the README gives, on a port journal."""
    out = str(tmp_path / "t.json")
    run = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.export", "--journal",
                          journals["port_process"], "--out", out, "--require-trials", "1"],
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "trial tracks" in run.stdout, run.stderr
    run = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.dashboard", "--journal",
                          journals["port_process"], "--once"],
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "where did time go (per bracket):" in run.stdout, run.stderr


# ---------------------------------------------------------------------------
# tests/test_spans.py:233-430, on the port (the reference's own files run
# them on the reference)
# ---------------------------------------------------------------------------
@pytest.fixture
def replay_journal(journals):
    return journals["port_replay"]


def test_replay_journal_exports_valid_chrome_trace(replay_journal, tmp_path):
    out = str(tmp_path / "trace.json")
    counts = export.export_journal(replay_journal, out)
    assert counts["trial_tracks"] >= 200
    assert counts["cohort_tracks"] >= 1
    assert counts["complete_events"] > 400
    with open(out, encoding="utf-8") as f:
        doc = json.load(f)
    assert export.validate_chrome_trace(doc) == counts
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {"trials", "cohorts"} <= {
        e["args"]["name"] for e in meta if e["name"] == "process_name"}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert min(e["ts"] for e in xs) == pytest.approx(0.0)


def test_critical_path_buckets_sum_to_wall_clock(replay_journal):
    events = list(journal.read_events(replay_journal))
    per_trial = critical_path.attribute(events)
    assert len(per_trial) >= 200
    for tid, rec in per_trial.items():
        assert rec["wall"] > 0
        total = sum(rec[b] for b in critical_path.BUCKETS)
        assert total == pytest.approx(rec["wall"], rel=0.01), (tid, total, rec["wall"])
    agg = critical_path.aggregate(per_trial)
    assert sum(a["trials"] for a in agg.values()) == len(per_trial)
    table = critical_path.critical_path_report(events)
    assert table.startswith("where did time go (per bracket):")
    assert "park_wait%" in table


def test_export_cli_require_trials(replay_journal, tmp_path):
    out = str(tmp_path / "t.json")
    assert export.main(["--journal", replay_journal, "--out", out,
                            "--require-trials", "1"]) == 0
    assert export.main(["--journal", replay_journal, "--out", out,
                            "--require-trials", "100000"]) == 1
    assert os.path.exists(out)


def test_tailer_poll_is_bounded_but_complete(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with open(path, "w") as f:
        for i in range(500):
            f.write(json.dumps({"ev": "report", "trial_id": i}) + "\n")
    tail = tailer.JournalTailer(path, max_bytes=1024)
    polls, got = 0, []
    while True:
        batch = tail.poll()
        if not batch:
            break
        assert all("trial_id" in e for e in batch)
        assert len(batch) <= 1024 // 20 + 1
        got.extend(batch)
        polls += 1
    assert [e["trial_id"] for e in got] == list(range(500))
    assert polls > 10
    assert tail.skipped == 0


def test_tailer_oversized_single_line_does_not_wedge(tmp_path):
    path = str(tmp_path / "j.jsonl")
    big = {"ev": "report", "trial_id": 0, "blob": "x" * 5000}
    with open(path, "w") as f:
        f.write(json.dumps(big) + "\n")
        f.write(json.dumps({"ev": "report", "trial_id": 1}) + "\n")
    tail = tailer.JournalTailer(path, max_bytes=256)
    first = tail.poll()
    assert any(e.get("trial_id") == 0 for e in first)
    rest = first + tail.poll()
    assert [e["trial_id"] for e in rest] == [0, 1]


def test_tailer_leaves_torn_line_for_next_poll(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with open(path, "w") as f:
        f.write('{"ev": "report", "trial_id": 0}\n{"ev": "rep')
    tail = tailer.JournalTailer(path, max_bytes=1024)
    assert [e["trial_id"] for e in tail.poll()] == [0]
    with open(path, "a") as f:
        f.write('ort", "trial_id": 1}\n')
    assert [e["trial_id"] for e in tail.poll()] == [1]
    assert tail.skipped == 0


def test_dashboard_warns_on_regressing_timestamps():
    view = dashboard.SearchView()
    view.apply({"ev": "acquire", "trial_id": 0, "ts": 100.0})
    view.apply({"ev": "report", "trial_id": 0, "phase": 0, "metric": 1.0,
                "env_steps": 10, "ts": 101.0})
    view.apply({"ev": "report", "trial_id": 0, "phase": 1, "metric": 2.0,
                "env_steps": 10, "ts": 99.0})      # 2 s backwards: skew
    assert view.ts_regressions == 1
    assert view.max_regression_s == pytest.approx(2.0)
    assert "WARNING: 1 events with regressing ts" in view.render("j")
    assert "undecodable skipped" in view.render("j", skipped=3)
    assert view.t_last == 101.0


def test_dashboard_spans_do_not_count_as_skew():
    view = dashboard.SearchView()
    view.apply({"ev": "report", "trial_id": 0, "phase": 0, "metric": 1.0, "ts": 100.0})
    view.apply({"ev": "span", "name": "trial.phase", "ts": 90.0, "dur": 3.0, "trial_id": 0})
    assert view.ts_regressions == 0
    assert "WARNING" not in view.render("j")


def test_dashboard_small_jitter_is_tolerated():
    view = dashboard.SearchView(skew_tolerance_s=0.05)
    view.apply({"ev": "report", "trial_id": 0, "phase": 0, "metric": 1.0, "ts": 100.0})
    view.apply({"ev": "report", "trial_id": 1, "phase": 0, "metric": 1.0, "ts": 99.99})
    assert view.ts_regressions == 0


def test_dashboard_follow_rates_use_monotonic_arrival():
    view = dashboard.SearchView(window_s=30.0)
    mono = time.monotonic()
    for i in range(5):
        view.apply({"ev": "report", "trial_id": i, "phase": 0, "metric": 1.0,
                    "env_steps": 100, "ts": 1e9 + i}, mono=mono)
    span, rps, eps = view._window_rates()
    assert span <= 30.0 and rps > 0 and eps > 0


def test_metrics_snapshot_has_uptime():
    snap = telemetry.MetricsRegistry().snapshot()
    assert snap["uptime_s"] >= 0.0
    assert telemetry.NULL_REGISTRY.snapshot()["uptime_s"] == 0.0


def test_dashboard_once_appends_critical_path_table(replay_journal, capsys):
    assert dashboard.main(["--journal", replay_journal, "--once"]) == 0
    out = capsys.readouterr().out
    assert "undecodable skipped" in out
    assert "where did time go (per bracket):" in out
    assert "WARNING" not in out


def test_span_schema_covers_recorded_and_derived_names():
    assert {"rpc.<verb>", "trial.phase", "engine.compile", "engine.phase",
            "engine.clone", "engine.park_stall", "trial.lifecycle",
            "trial.park", "cohort.rung"} == set(telemetry.SPAN_SCHEMA)
    assert all(isinstance(v, str) and v for v in telemetry.SPAN_SCHEMA.values())


# ---------------------------------------------------------------------------
# tests/test_telemetry.py:99-160 and :338-362, on the port
# ---------------------------------------------------------------------------
def test_tailer_leaves_torn_line_then_picks_it_up_whole(tmp_path):
    path = str(tmp_path / "j.jsonl")
    tail = tailer.JournalTailer(path)
    assert tail.poll() == []               # not created yet
    with open(path, "w") as f:
        f.write('{"ev": "acquire", "trial_id": 0}\n{"ev": "rep')
        f.flush()
        assert tail.poll() == [{"ev": "acquire", "trial_id": 0}]
        assert tail.poll() == []
        assert tail.skipped == 0
        f.write('ort", "trial_id": 0}\n')
        f.flush()
        assert tail.poll() == [{"ev": "report", "trial_id": 0}]


def test_tailer_skips_complete_undecodable_line(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with open(path, "w") as f:
        f.write('{"ev": "a"}\nnot json\n{"ev": "b"}\n')
    tail = tailer.JournalTailer(path)
    assert tail.poll() == [{"ev": "a"}, {"ev": "b"}]
    assert tail.skipped == 1


def test_tailer_resets_when_journal_is_replaced(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with open(path, "w") as f:
        f.write('{"ev": "a"}\n{"ev": "b"}\n')
    tail = tailer.JournalTailer(path)
    assert len(tail.poll()) == 2
    with open(path, "w") as f:             # a fresh run truncated the journal
        f.write('{"ev": "c"}\n')
    assert tail.poll() == [{"ev": "c"}]


def test_tailer_against_concurrently_appending_writer(tmp_path):
    """A writer thread appends events in torn chunks while the tailer
    polls: every event comes through once, in order, none skipped."""
    path = str(tmp_path / "j.jsonl")
    n_events = 300
    stop = threading.Event()

    def write_all():
        with open(path, "wb", buffering=0) as f:
            for i in range(n_events):
                line = json.dumps({"ev": "report", "i": i}).encode() + b"\n"
                cut = max(1, len(line) // 2) if i % 3 else len(line)
                f.write(line[:cut])
                if cut < len(line):
                    time.sleep(0.0005)
                    f.write(line[cut:])
        stop.set()

    t = threading.Thread(target=write_all)
    t.start()
    got = []
    tail = tailer.JournalTailer(path)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        got.extend(tail.poll())
        if stop.is_set() and len(got) >= n_events:
            break
        time.sleep(0.001)
    t.join()
    got.extend(tail.poll())
    assert [e["i"] for e in got] == list(range(n_events))
    assert tail.skipped == 0


def _trace_journal(tmp_path):
    path = str(tmp_path / "trace_journal.jsonl")
    policy = hypertrick.HyperTrick(search_space.SearchSpace({"x": search_space.Uniform(0.0, 1.0)}),
                               w0=30, n_phases=4, eviction_rate=0.3, seed=0)
    hosts = trace.synthetic_trace(10, seed=2, fail_frac=0.2, fail_horizon=8.0)
    with journal.Journal(path) as j:
        res = trace.replay_trace(policy, simulator.ToyWorkload(seed=0), hosts, bracket_eta=3,
                                     lease_ttl=5.0, seed=0, journal=j)
    return path, res


def test_dashboard_view_reconstructs_search_from_journal(tmp_path):
    path, res = _trace_journal(tmp_path)
    tail = tailer.JournalTailer(path)
    view = dashboard.SearchView(window_s=30.0)
    view.apply_all(tail.poll())
    assert tail.skipped == 0
    assert len(view.trials) == res.n_trials
    assert view.best == pytest.approx(res.best_metric)
    assert view.reaps == res.metrics["counters"]["server.lease_reaps"]
    assert view.parked == {}
    assert len(view.cohort_waits) > 0
    assert view.worker_exits
    _, rps, eps = view._window_rates()
    assert rps > 0 and eps > 0
    panel = view.render(path)
    for needle in ("best score:", "reports/s", "env-steps/s", "cohorts:",
                   "wait p50", "reaps", "workers:"):
        assert needle in panel, needle


def test_dashboard_cli_once(tmp_path, capsys):
    path, _ = _trace_journal(tmp_path)
    assert dashboard.main(["--journal", path, "--once"]) == 0
    out = capsys.readouterr().out
    assert "best score:" in out and "reports/s" in out


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14, on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.timeout(300)
def test_smoke_phase_14_holds_on_the_cpu(journals, monkeypatch, tmp_path):
    """``chip_smoke.py`` phase 14 is host code: its checks hold here over
    port journals of the CLI's kinds (a server-backend search tailed live as
    10a's, Hyperband in worker processes as 10c's, a bracket in worker
    processes as 11a's, the trace's as 13b's), with launch counters that
    read 0."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for key, value in _env().items():
        monkeypatch.setenv(key, value)
    os.mkdir(tmp_path / "kept")
    kept = {"dir": str(tmp_path / "kept"), "journals": {}}
    syn = ["--device", "cpu", "--objective", "synthetic", "--synthetic-sleep", "0.02"]
    for label, argv in (("10a", ["--backend", "server", "--workers", "6", "--nodes", "2",
                                 "--phases", "3"]),
                        ("10c", ["--backend", "process", "--scheduler", "hyperband",
                                 "--phases", "4", "--eta", "2", "--nodes", "10"])):
        proc, out, path = smoke.tune_process([*syn, *argv], str(tmp_path), label)
        tail = smoke.LiveTail(path) if label == "10a" else None
        try:
            smoke.finish(proc, label, timeout=240)
        finally:
            if tail is not None:
                tail.stop()
        if tail is not None:
            tail.drain()
            live = tail
        table, _, _ = smoke.journal_trials(path)
        smoke.keep_journal(kept, label, path, len(table),
                           json.load(open(out))["best_metric"], parks=label == "10c")
    for label, name, parks in (("11a", "port_process", True), ("13b", "port_replay", True)):
        table, _, _ = smoke.journal_trials(journals[name])
        best = max(m for _, _, ms in table.values() for m in ms)
        smoke.keep_journal(kept, label, journals[name], len(table), best, parks)
    done = []
    out = smoke.readers_phase("cpu", done.append, lambda: None,
                              lambda: ({"rmsnorm": 0, "gmm": 0},), kept, live)
    assert [d.split()[0] for d in done] == ["14a", "14b"]
    assert out["13b"]["trials"] == out["13b"]["export"]["trial_tracks"] >= 200
    assert out["10c"]["trials_parked"] > 0 and out["11a"]["trials_parked"] > 0
    assert out["14b"]["skipped"] == 0 and out["14b"]["polls"] > 1
