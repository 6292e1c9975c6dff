"""Population objectives: the workload plugged into the population engine
(port of ``repro/population/objectives/__init__.py``). Two are ported:
GA3C (``ga3c.py``, alias ``rl``) and LM training (``lm.py``).

The engine (``repro_torch.population.engine``) is pure mechanism — slot
stacking, bucketing, eviction masks, hot-swap, park/poll. Everything
workload-specific lives behind the ``PopulationObjective`` protocol
defined here:

* ``hparam_spec()``       — which hyperparameters are *traced* (enter the
  step as per-slot values, so one step serves every configuration in a
  bucket) vs *structural* (change the step's shapes or program; they key
  the engine's buckets and are frozen under PBT perturbation);
* ``bucket_key(hparams)`` — the hashable bucket key derived from the
  structural hyperparameters (trials sharing a key share one step);
* ``init_slot_state(seed, hparams)`` — one trial's device state as a
  ``(learner, carry)`` pair of tensor trees: ``learner`` is what a PBT
  CLONE copies (typically ``(params, opt_state)``), ``carry`` is what it
  does not (env/data state, metric accumulators, the trial's generator);
* ``make_step(structural, capacity)`` — the step of a bucket of
  ``capacity`` slots, ``(learner, carry, *traced) -> (learner, carry)``:
  every tensor carries a leading slot axis, each traced value is an
  ``(S,)`` tensor, and the step advances every slot it is given (the
  engine hands it only the active ones);
* ``progress(carry)``     — two ``(capacity,)`` tensors ``(counts, sums)``
  the host polls to detect phase boundaries (one copy a bucket an
  iteration); the phase metric is ``delta_sum / max(delta_n, 1)``;
* ``update_cost(structural)`` — work units (env transitions, tokens) one
  update of one slot performs, for throughput accounting.

``hparam_spec`` is a classmethod so launchers can ask "which keys are
structural?" (PBT ``frozen=``, perturb rules) without instantiating the
workload — ``spec_for(name)`` below does exactly that.

The invariant that makes the engine generic: *nothing in the step may
depend on which trial occupies the slot except through traced inputs.*
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, Mapping, Optional, Tuple


@dataclass(frozen=True)
class HparamSpec:
    """The objective's hyperparameter contract.

    ``traced`` names enter the step as per-slot values (in this order).
    ``structural`` names change the step — they form the bucket key and
    are frozen under PBT/evolution perturbation
    (``search_space.perturb_hparams(frozen=...)``). ``defaults`` supplies
    values for traced names absent from a trial's hparams.
    """
    traced: Tuple[str, ...]
    structural: Tuple[str, ...] = ()
    defaults: Mapping[str, float] = field(default_factory=dict)


class PopulationObjective:
    """Base class / protocol for engine workloads. Subclasses implement
    the six methods documented in the module docstring; ``traced_values``
    is a shared helper."""

    name: str = "?"

    @classmethod
    def hparam_spec(cls) -> HparamSpec:
        raise NotImplementedError

    def bucket_key(self, hparams: Dict[str, Any]) -> Hashable:
        raise NotImplementedError

    def cache_key(self) -> Hashable:
        """Identity of the step's program: two objective instances with
        equal cache keys build identical steps."""
        raise NotImplementedError

    def init_slot_state(self, seed: int, hparams: Dict[str, Any]):
        raise NotImplementedError

    def make_step(self, structural: Hashable, capacity: int) -> Callable:
        raise NotImplementedError

    def progress(self, carry) -> Tuple[Any, Any]:
        raise NotImplementedError

    def update_cost(self, structural: Hashable) -> int:
        raise NotImplementedError

    def traced_values(self, hparams: Dict[str, Any],
                      fallback: Optional[Dict[str, Any]] = None
                      ) -> Tuple[float, ...]:
        """The per-slot traced scalars, in ``hparam_spec().traced`` order:
        trial hparams first, then ``fallback`` (e.g. the pre-perturb
        hparams), then the spec defaults."""
        spec = self.hparam_spec()
        out = []
        for n in spec.traced:
            v = hparams.get(n)
            if v is None and fallback is not None:
                v = fallback.get(n)
            if v is None:
                v = spec.defaults[n]
            out.append(float(v))
        return tuple(out)


# ---------------------------------------------------------------------------
# registry (lazy: importing this package builds nothing)
# ---------------------------------------------------------------------------
def get_objective(name: str, **kwargs) -> PopulationObjective:
    """Build an objective by name. ``"rl"`` is an alias for ``"ga3c"``
    (the launcher vocabulary)."""
    cls = _objective_class(name)
    return cls(**kwargs)


def objective_from_spec(spec: Dict[str, Any]) -> PopulationObjective:
    """Build an objective from a JSON-able spec ``{"kind": ..., **kwargs}``
    — the cross-process twin of ``distributed.worker.resolve_objective``.
    Keys the objective's constructor does not take are dropped (specs are
    shared with the scalar-worker path, which has extra knobs like
    ``episodes_per_phase``)."""
    import inspect
    kind = spec.get("kind", "ga3c")
    cls = _objective_class(kind)
    accepted = set(inspect.signature(cls.__init__).parameters)
    kwargs = {k: v for k, v in spec.items()
              if k != "kind" and k in accepted}
    return cls(**kwargs)


# the specs live HERE, not on the classes, so launchers can ask "which keys
# are structural?" (PBT frozen=, perturb rules) without importing the
# objective modules; each class's hparam_spec() returns its constant,
# keeping one source of truth
GA3C_SPEC = HparamSpec(traced=("learning_rate", "gamma", "beta"),
                       structural=("t_max",),
                       defaults={"beta": 0.01})
LM_SPEC = HparamSpec(traced=("learning_rate", "grad_clip", "warmup_steps"),
                     structural=("loss_chunk",),
                     defaults={"grad_clip": 1.0, "warmup_steps": 1.0})
_SPECS = {
    "ga3c": GA3C_SPEC,
    "rl": GA3C_SPEC,
    "lm": LM_SPEC,
    # the scalar-worker-only toy objective, so launchers can treat every
    # objective name uniformly
    "synthetic": HparamSpec(traced=("x",)),
}


def spec_for(name: str) -> HparamSpec:
    """The ``HparamSpec`` of a named objective WITHOUT instantiating it."""
    try:
        return _SPECS[name]
    except KeyError:
        raise ValueError(f"unknown population objective {name!r}; "
                         f"known: {sorted(_SPECS)}") from None


def _objective_class(name: str):
    if name in ("ga3c", "rl"):
        from repro_torch.population.objectives.ga3c import GA3CObjective
        return GA3CObjective
    if name == "lm":
        from repro_torch.population.objectives.lm import LMObjective
        return LMObjective
    raise ValueError(f"unknown population objective {name!r}; "
                     "known: ga3c (alias rl), lm")
