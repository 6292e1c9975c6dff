"""Repeated checks of the population engine over seeds, one JSON line each.

  # a bucket of 4 LM slots against the same 4 trials each alone, 3 updates,
  # for engine seeds 0-19 (chip_smoke.py phase 9c's comparison)
  PYTHONPATH=src python -m repro_torch.launch.population_checks slots --seeds 20
  # the same with the slots coupled on purpose: what a fault reads
  PYTHONPATH=src python -m repro_torch.launch.population_checks slots --seeds 5 \\
      --control global_clip
  # the same comparison over another model's reduced config (default yi-9b):
  # a mamba block's scan or a MoE block's grouped matmuls on the slot axis
  PYTHONPATH=src python -m repro_torch.launch.population_checks slots --seeds 3 \\
      --arch jamba-v0.1-52b

  # PBT runs of the vectorized CLI at seeds 0-11: how many CLONE verdicts
  # each issued and how many it copied slot to slot on the device
  PYTHONPATH=src python -m repro_torch.launch.population_checks pbt --objective rl \\
      --seeds 12 --device cpu

``slots`` prints, for every seed and slot, the largest |bucket - alone|
over the slot's learning rate, how many of the slot's weights lie outside
``ATOL + RTOL |alone|``, the relative distance of its summed AdamW second
moments and of its summed -loss; a last line holds each reading's largest
value, its least over the seeds of each seed's largest, how many seeds
break a limit of 9c (``slot_faults``) and which. ``pbt`` prints each run's
``clones`` and ``clones_on_device`` and a last line with the runs that
copied none. Each engine seeds its trials with ``trial_seed``, which
Python's salted ``str`` hash makes differ from process to process.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json

# chip_smoke.py phase 9c: SLOT_HPARAMS trials (each its own lr, clip and
# warmup) in one bucket against each alone in a bucket of one, UPDATES
# updates on the same draws. The gradients are held through each slot's
# AdamW second moments summed over its weights (a clip or a loss that
# coupled the slots would scale them), within V_RTOL. The weights: AdamW
# moves a weight by lr m / (sqrt(v) + 1e-8), so a gradient within a few
# 1e-8 of 0 carries its rounding (cuBLAS picks its kernels by the batch of
# slots) into a step of up to about lr. So at most OUTLIERS of a slot's
# weights (852,736 in yi-9b's reduced config, 1,663,744 in jamba's) may lie
# outside ATOL + RTOL |alone| (the smoke's training limits) and none
# farther than MAX_OVER_LR x its lr; each slot's summed -loss within RTOL
# |alone| + UPDATES x ATOL (UPDATES steps' limits).
# ``slots --control`` couples the bucket's slots on purpose, to read what a
# fault shows beside the limits (PERF.md)
SLOT_HPARAMS = [dict(learning_rate=lr, loss_chunk=1024, grad_clip=c, warmup_steps=w)
                for lr, c, w in ((1e-3, 1.0, 1), (3e-4, 0.5, 4), (2e-3, 2.0, 2),
                                 (5e-4, 0.05, 1))]
UPDATES, ATOL, RTOL = 3, 1e-5, 1e-5
V_RTOL, OUTLIERS, MAX_OVER_LR = 1e-4, 100, 1.0
PBT_ARGV = {"rl": ["--backend", "vectorized", "--scheduler", "pbt", "--workers", "4",
                   "--phases", "3", "--episodes-per-phase", "2", "--n-envs", "2"],
            "lm": ["--backend", "vectorized", "--objective", "lm", "--scheduler", "pbt",
                   "--workers", "4", "--phases", "3", "--steps-per-phase", "4"]}


@contextlib.contextmanager
def coupled(control):
    """Within it, every LM bucket's AdamW update ties its slots together as
    ``control`` says: ``global_clip`` clips each slot by the norm of the
    whole stack's gradients, ``slot_mean`` takes the mean of the slots'
    losses in place of their sum. A bucket of one slot is unchanged."""
    if control is None:
        yield
        return
    import torch
    from repro_torch.population.objectives import lm
    update = lm.apply_updates_slots

    def coupled_update(tc, params, grads, state, lr, grad_clip=None, warmup_steps=None):
        s = lr.shape[0]
        if control == "slot_mean":
            grads = {n: g / s for n, g in grads.items()}
        else:
            norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
            scale = torch.clamp(grad_clip / torch.clamp(norm, min=1e-9), max=1.0)
            grads = {n: g * scale.view((s,) + (1,) * (g.dim() - 1)) for n, g in grads.items()}
            grad_clip = torch.full_like(grad_clip, float("inf"))
        return update(tc, params, grads, state, lr, grad_clip=grad_clip,
                      warmup_steps=warmup_steps)

    lm.apply_updates_slots = coupled_update
    try:
        yield
    finally:
        lm.apply_updates_slots = update


def slot_rows(seed: int, device, control=None, arch: str = "yi-9b") -> list:
    """Engine seed ``seed``: the SLOT_HPARAMS trials of ``arch``'s reduced
    LM in one bucket and each alone, UPDATES updates; a row a slot with its
    readings beside 9c's limits."""
    import torch
    from repro_torch.population.engine import PopulationEngine, TrialLease
    from repro_torch.population.objectives.lm import LMObjective

    def bucket(hps):
        engine = PopulationEngine(LMObjective(arch, device=device), max_slots=len(hps),
                                  episodes_per_phase=10 ** 9, max_updates=10 ** 9, seed=seed,
                                  device=device)
        engine._admit_grouped([TrialLease(i, hp) for i, hp in hps], now=0.0)
        (b,) = engine.buckets.values()
        assert b.capacity == len(hps), b.capacity
        return b

    together = bucket(list(enumerate(SLOT_HPARAMS)))
    alone = [bucket([(i, hp)]) for i, hp in enumerate(SLOT_HPARAMS)]
    with coupled(control):
        for _ in range(UPDATES):
            together.step()
            for b in alone:
                b.step()
    params, opt = together.learner
    rows = []
    for i, b in enumerate(alone):
        diff = torch.cat([(params[n][i] - p[0]).abs().flatten() for n, p in b.learner[0].items()])
        mag = torch.cat([p[0].abs().flatten() for p in b.learner[0].values()])
        v = sum(float(opt.acc2[n][i].double().sum()) for n in params)
        v_alone = sum(float(a.double().sum()) for a in b.learner[1].acc2.values())
        x, y = float(together.carry[1][i]), float(b.carry[1][0])
        lr = SLOT_HPARAMS[i]["learning_rate"]
        rows.append({"seed": seed, "slot": i, "arch": arch, "control": control, "lr": lr,
                     "weights": diff.numel(), "over_lr": float(diff.max()) / lr,
                     "outside_limit": int((diff > ATOL + RTOL * mag).sum()),
                     "v_sum_rel_diff": abs(v - v_alone) / v_alone,
                     "loss_sum_abs_diff": abs(x - y), "loss_sum_alone": y})
    return rows


READINGS = ("over_lr", "outside_limit", "v_sum_rel_diff", "loss_sum_abs_diff")


def slot_faults(row: dict) -> list:
    """The 9c limits that ``row`` (of ``slot_rows``) breaks."""
    return [name for name, broken in (
        ("moments", row["v_sum_rel_diff"] > V_RTOL),
        ("outliers", row["outside_limit"] > OUTLIERS),
        ("max_over_lr", row["over_lr"] > MAX_OVER_LR),
        ("loss_sum", row["loss_sum_abs_diff"] - RTOL * abs(row["loss_sum_alone"])
         > UPDATES * ATOL)) if broken]


def pbt_row(objective: str, seed: int, device: str) -> dict:
    from repro_torch.launch import tune
    with contextlib.redirect_stdout(io.StringIO()):
        summary = tune.main([*PBT_ARGV[objective], "--seed", str(seed),
                             "--device", device]).summary()
    return {"objective": objective, "seed": seed, "clones": summary.get("clones", 0),
            "clones_on_device": summary.get("clones_on_device", 0),
            "by_status": summary["by_status"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("check", choices=["slots", "pbt"])
    ap.add_argument("--objective", choices=["rl", "lm"], default="rl")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="yi-9b",
                    help="slots: the reduced LM whose trials the bucket trains")
    ap.add_argument("--control", choices=["global_clip", "slot_mean"], default=None,
                    help="slots: couple the bucket's slots on purpose")
    args = ap.parse_args(argv)
    rows = []
    for seed in range(args.seeds):
        new = (slot_rows(seed, args.device, args.control, args.arch) if args.check == "slots"
               else [pbt_row(args.objective, seed, args.device)])
        for row in new:
            print(json.dumps(row), flush=True)
        rows += new
    if args.check == "slots":
        by_seed = [[r for r in rows if r["seed"] == seed] for seed in range(args.seeds)]
        worst = [{k: max(r[k] for r in seed_rows) for k in READINGS} for seed_rows in by_seed]
        last = {"arch": args.arch, "control": args.control,
                "max": {k: max(w[k] for w in worst) for k in READINGS},
                "least_seed_max": {k: min(w[k] for w in worst) for k in READINGS},
                "seeds_failing": sum(any(map(slot_faults, seed_rows)) for seed_rows in by_seed),
                "faults": sorted({f for r in rows for f in slot_faults(r)})}
    else:
        last = {"runs": len(rows),
                "runs_without_a_clone_on_device": sum(not r["clones_on_device"] for r in rows)}
    print(json.dumps(last))
    return rows


if __name__ == "__main__":
    main()
