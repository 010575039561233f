"""The traffic generators, frozen, one module a generator.

A traffic file (``portbench/traffic/<mix>.json``) names its generator
under ``"generator"``; ``portbench/sources/<generator>.py`` holds
``make_source(config, traffic, seed)``, which returns an object whose
``get_batch(i)`` gives the ring's ``i``-th raw batch (a dict of numpy
arrays) at the configuration's sizes, seeded by the run's ``--seed``.
A generator is a frozen copy of one of the port's, numpy only and
deterministic in its seed, so that a change to the program cannot move
the benchmark's inputs; it imports nothing of the program.
"""

from __future__ import annotations

import importlib


def make_source(config: dict, traffic: dict, seed: int):
    """The generator the traffic file names, at the configuration's
    sizes, seeded by ``seed``."""
    module = importlib.import_module(
        f"portbench.sources.{traffic['generator']}")
    return module.make_source(config, traffic, seed)
