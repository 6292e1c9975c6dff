"""The load generator, port against reference on the CPU
(``distributed/loadgen.py``).

* ``run_sim_load`` (the 1000-host tier through ``replay_trace``) is numpy on
  a simulated clock: its simulated numbers (reports, trials acquired, the
  simulated span) equal the reference's exactly, and so do the journals it
  writes.
* ``run_load`` drives a live ``MetaoptServer`` over real sockets from one
  thread a host. Which host leases which trial is a race in either package,
  and ``wall_s``, ``reports_per_s``, ``p50_ms`` and ``p99_ms`` are wall-clock
  values, so they are compared by count only and no ratio of them is
  asserted. What no race moves is held, in three pairings (the port's load
  generator against the port's server and against the reference's, and the
  reference's against the port's): no error, the exact report and acquire
  counts, and every trial completed with one report a phase whose metric is
  ``phase + trial_id % 7``.
"""
import dataclasses

import pytest

from repro.core import hypertrick as ref_hypertrick
from repro.core import search_space as ref_space
from repro.core import service as ref_service
from repro.distributed import loadgen as ref_loadgen
from repro.distributed import server as ref_server
from repro_torch.core import hypertrick, search_space, service
from repro_torch.distributed import loadgen, server
from repro_torch.distributed.journal import Journal

PKGS = {
    "ref": (ref_hypertrick, ref_space, ref_service, ref_server, ref_loadgen),
    "port": (hypertrick, search_space, service, server, loadgen),
}
# (load generator's package, server's package)
PAIRINGS = [("port", "port"), ("port", "ref"), ("ref", "port")]
# (hosts, slots, phases, batched): tests/load/test_server_load.py:29-62
SHAPES = [(2, 64, 3, True), (2, 64, 3, False), (200, 1, 2, True)]


def _service(pkg, n_trials, phases):
    ht, space, svc, _, _ = PKGS[pkg]
    policy = ht.RandomSearchPolicy(space.SearchSpace({"x": space.LogUniform(0.01, 100.0)}),
                                   n_trials, phases, seed=0)
    return svc.OptimizationService(policy)


def _socket_run(gen_pkg, server_pkg, hosts, slots, phases, batched):
    svc = _service(server_pkg, hosts * slots, phases)
    with PKGS[server_pkg][3].MetaoptServer(svc, lease_ttl=60.0) as srv:
        stats = PKGS[gen_pkg][4].run_load(srv.host, srv.port, hosts=hosts, slots=slots,
                                          phases=phases, batched=batched)
    return stats, svc


@pytest.mark.timeout(120)
@pytest.mark.parametrize("hosts,slots,phases,batched", SHAPES,
                         ids=[f"{h}x{s}x{p}-{'batched' if b else 'per_trial'}"
                              for h, s, p, b in SHAPES])
@pytest.mark.parametrize("gen_pkg,server_pkg", PAIRINGS,
                         ids=[f"{g}_loadgen-{s}_server" for g, s in PAIRINGS])
def test_run_load_every_report_lands(gen_pkg, server_pkg, hosts, slots, phases, batched):
    stats, svc = _socket_run(gen_pkg, server_pkg, hosts, slots, phases, batched)
    assert stats.errors == 0
    assert stats.reports == hosts * slots * phases
    assert stats.acquired == hosts * slots
    assert (stats.hosts, stats.slots, stats.phases, stats.batched) == (hosts, slots, phases,
                                                                       batched)
    assert stats.wall_s > 0 and stats.reports_per_s > 0
    assert stats.p99_ms is not None and stats.p50_ms is not None
    assert stats.p50_ms <= stats.p99_ms
    trials = svc.db.trials
    assert sorted(trials) == list(range(hosts * slots))
    for tid, rec in trials.items():
        assert rec.status.value == "completed", (tid, rec.status)
        assert [m for m, _ in rec.reports] == [float(ph + tid % 7) for ph in range(phases)]
    # the per-host split is a race; every host leased its slots
    assert sorted({rec.node for rec in trials.values()}) == list(range(hosts))
    assert set(stats.to_row()) == set(ref_loadgen.LoadStats(1, 1, 1, True).to_row())


@pytest.mark.parametrize("n_hosts,n_trials,n_phases,seed",
                         [(200, 400, 4, 0), (1000, 2000, 4, 0), (64, 100, 3, 5)])
def test_run_sim_load_equals_the_reference(n_hosts, n_trials, n_phases, seed, tmp_path):
    paths = {name: str(tmp_path / f"{name}.jsonl") for name in PKGS}
    out = {}
    for name, pkg in PKGS.items():
        with Journal(paths[name]) as j:
            out[name] = pkg[4].run_sim_load(n_hosts, n_trials, n_phases, seed=seed, journal=j)
    ours, ref = out["port"], out["ref"]
    keys = ("hosts", "slots", "phases", "batched", "reports", "acquired", "errors")
    assert {k: getattr(ours, k) for k in keys} == {k: getattr(ref, k) for k in keys}
    assert ours.extra == ref.extra
    assert ours.extra["tier"] == "sim" and ours.extra["sim_span_s"] > 0
    # no failures configured: every trial runs every phase
    assert ours.reports == n_trials * n_phases and ours.acquired == n_trials
    assert ours.wall_s > 0 and ours.p99_ms is not None
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()


def test_load_stats_rows_and_quantiles_equal_the_reference():
    lat = [0.003, 0.0001, 0.25, 0.0042, 0.0042, 0.017, 0.0009]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert loadgen._quantile_ms(lat, q) == ref_loadgen._quantile_ms(lat, q)
    assert loadgen._quantile_ms([], 0.5) is None
    kw = dict(hosts=3, slots=7, phases=2, batched=False, reports=42, acquired=21,
              wall_s=1.234567, reports_per_s=34.0197, p50_ms=1.23456, p99_ms=None, errors=1,
              extra={"tier": "smoke"})
    assert loadgen.LoadStats(**kw).to_row() == ref_loadgen.LoadStats(**kw).to_row()
    assert [f.name for f in dataclasses.fields(loadgen.LoadStats)] == [
        f.name for f in dataclasses.fields(ref_loadgen.LoadStats)]


@pytest.mark.timeout(120)
def test_smoke_phase_13_holds_on_the_cpu(tmp_path):
    """``chip_smoke.py`` phase 13 is host code: its checks hold here, with
    launch counters that read 0 throughout, and it keeps 13b's journal for
    phase 14."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    done, kept = [], {"dir": str(tmp_path), "journals": {}}
    out = smoke.simulator_phase("cpu", done.append, lambda: None,
                                lambda: ({"rmsnorm": 0, "gmm": 0},), kept)
    assert [d.split()[0] for d in done] == ["13a", "13b", "13c"]
    assert out["13a"]["toy"]["grid"]["alpha"] == 1.0
    assert out["13b"]["rung0_n"] >= 990
    assert out["13c"]["sim"]["reports"] == 8000
    assert [r["reports"] for r in out["13c"]["run_load"]] == [400, 384, 384]
    assert list(kept["journals"]) == ["13b"]
    assert pathlib.Path(kept["journals"]["13b"]["path"]).is_file()
