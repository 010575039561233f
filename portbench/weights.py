"""The initial weights, made by the benchmark from ``--seed``.

In float32 on the run's device, by one ``torch.Generator`` seeded with
the run's seed, one call per leaf, in the order :func:`leaves` gives,
each leaf N(0, std²) (zeros where std is 0).  The std is the model's
reference module's ``init_std(config, key, shape)`` where it defines
one, else :func:`_std`: tables and the wide continuous weights
``init_std``; MLP weights sqrt(2 / fan_in) (He et al., 2015: a ReLU
layer keeps the variance of its input, so every layer of the MLP
carries each row's signal); MLP biases and the wide bias zero.  Tables
are logical ``[vocab, dim]``.  The
program is handed these values in its own storage layout
(``portbench/program.py``); the reference draws them again from the same
seed, so it takes nothing the program made.
"""

from __future__ import annotations

import importlib

import torch


def model_module(config: dict):
    """The plain reference of the configuration's model,
    ``portbench/reference/<model>.py``: its ``leaves``, ``TABLES`` and
    ``Reference``, and optionally ``init_std`` and
    ``matmul_flops_per_step``."""
    return importlib.import_module(f"portbench.reference.{config['model']}")


def leaves(config: dict) -> list[tuple[str, tuple]]:
    """(key, shape) of every parameter leaf of a configuration."""
    return model_module(config).leaves(config)


def table_keys(config: dict) -> list[str]:
    """The keys of a configuration's embedding tables."""
    return list(model_module(config).TABLES)


def _std(config: dict, key: str, shape: tuple) -> float:
    """The std of a leaf of a model whose reference defines none."""
    if key.endswith("/b") or key == "wide/bias":
        return 0.0
    if "/mlp/" in key:
        return (2.0 / shape[0]) ** 0.5
    return float(config["init_std"])


def make_weights(config: dict, seed: int, device) -> dict:
    """{key: float32 tensor} on ``device``, drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    std_of = getattr(model_module(config), "init_std", _std)
    out = {}
    for k, shape in leaves(config):
        std = std_of(config, k, shape)
        out[k] = (std * torch.randn(shape, generator=gen, dtype=torch.float32,
                                    device=device) if std
                  else torch.zeros(shape, dtype=torch.float32, device=device))
    return out
