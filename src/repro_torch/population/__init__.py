"""The population engine (port of ``repro/population``): a whole search's
live trials trained together on one device, generic over a
``PopulationObjective`` (see engine.py and objectives/).

The engine re-exports are lazy (PEP 562), as the reference's:
``population.objectives``' spec metadata stays importable without
building anything on a device.
"""
__all__ = ["PopulationEngine", "LocalDriver", "TrialLease"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.population import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
