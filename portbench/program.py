"""The system under test: the port's model, optimizers, entry point and
input pipeline, built from a configuration file.

This file and the optimizers' ``build`` (``portbench/optimizers/``) are
the only code of the benchmark that imports ``mindrec_tpu_torch`` (a
configuration names the port's model classes it runs).
It builds what a user of the port builds for the recipe (the model
config, the two optimizers by ``portbench/optimizers/<kind>.py``,
``RecModel(jit=True)``), hands the program the benchmark's weights in
the program's own storage layout, stages batches through the program's
``SparseInputPipeline`` (host prep, then staging on a side stream), and
reads the program's spans (``utils/profiling.py``) in a traced run.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from mindrec_tpu_torch import RecModel
from mindrec_tpu_torch.data.criteo import to_device
from mindrec_tpu_torch.data.pipeline import AdaptiveBucket, SparseInputPipeline
from mindrec_tpu_torch.ops.embedding import from_storage, to_storage
from mindrec_tpu_torch.train.callbacks import Callback  # noqa: F401  (the harness subclasses it)
from mindrec_tpu_torch.train.step import flatten_params, prep_groups
from mindrec_tpu_torch.utils import profiling
from portbench.optimizers import optimizer


def _config(cls, config: dict):
    """The model config dataclass from the file's keys of the same name."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in config.items() if k in names})


def _program_class(path: str):
    """A class of the port named ``module:Class`` in a configuration."""
    module, name = path.split(":")
    if module.split(".")[0] != "mindrec_tpu_torch":
        raise ValueError(f"{path!r} is not a class of the port")
    return getattr(importlib.import_module(module), name)


def build_model(config: dict):
    """(model, opt_w, opt_d) of a configuration file: its ``program``
    entry names the port's model and model-config classes."""
    names = config["program"]
    model = _program_class(names["model"])(
        _config(_program_class(names["config"]), config))
    scale = float(config["loss_scale"])
    opts = config["optimizers"]
    return (model, optimizer(opts["wide"]).build(opts["wide"], scale),
            optimizer(opts["deep"]).build(opts["deep"], scale))


def table_specs(model) -> dict:
    """{parameter key: table spec} of the model's embedding tables."""
    return {"/".join(path): spec
            for _name, (path, spec) in model.table_specs.items()}


def logical(model, key: str, storage: torch.Tensor) -> torch.Tensor:
    """A table (or its optimizer state) in storage layout -> logical
    ``[padded_vocab, dim]``, by the program's own layout."""
    return from_storage(table_specs(model)[key], storage)


class Program:
    """``RecModel`` of a configuration with the benchmark's weights;
    ``spans`` turns the program's spans on (before the step's first
    capture, which keeps the marks it was captured with)."""

    def __init__(self, config: dict, weights: dict, device,
                 spans: bool = False):
        self.config = config
        self.device = torch.device(device)
        if spans:
            profiling.enable_spans(True)
        self.model, self.opt_w, self.opt_d = build_model(config)
        self.rec = RecModel(self.model, self.opt_w, self.opt_d, seed=0,
                            jit=True, device=self.device)
        specs = table_specs(self.model)
        with torch.no_grad():
            for key, leaf in flatten_params(self.rec.state.params):
                w = weights[key]
                if key in specs:
                    spec = specs[key]
                    pad = w.new_zeros((spec.padded_vocab - w.shape[0],
                                       w.shape[1]))
                    w = to_storage(spec, torch.cat([w, pad]))
                leaf.copy_(w.to(leaf.dtype).reshape(leaf.shape))

    def logical(self, key: str, storage: torch.Tensor) -> torch.Tensor:
        return logical(self.model, key, storage)

    @property
    def step(self):
        return self.rec.train_step

    def leaves(self) -> dict:
        """{key: parameter leaf}."""
        return dict(flatten_params(self.rec.state.params))

    def opt_state(self, key: str) -> dict:
        """{state: tensor} of a leaf's optimizer (SGD's ``()``: empty)."""
        st = self.rec.state
        return dict((st.opt_w if key.split("/")[0] == "wide"
                     else st.opt_d)[key])

    def opt_hyper(self, key: str) -> dict:
        opt = self.opt_w if key.split("/")[0] == "wide" else self.opt_d
        return {"kind": opt.kind, **opt.hyper}

    def stage(self, raw: list, bucket) -> list:
        """Host prep and staging of ``raw`` host batches through the
        program's input pipeline; -> the staged batches.  A single id
        group is trimmed to the fixed ``bucket``; multi-group models take
        lossless per-group prep (``RecModel``'s default)."""
        on_card = self.device.type == "cuda"
        groups = prep_groups(self.model)
        policy = None
        if groups is None:
            policy = AdaptiveBucket(int(bucket), log=lambda *a, **k: None)
        pipe = SparseInputPipeline(
            raw, field_size=int(self.config.get("field_size", 0)),
            policy=policy, groups=groups, workers=2, device=on_card)
        staged = [b if on_card else to_device(b, self.device) for b in pipe]
        if policy is not None and policy.bucket != int(bucket):
            raise RuntimeError(
                f"a batch overflowed the traffic's unique bucket {bucket} "
                f"(grown to {policy.bucket}): the traffic file is wrong")
        return staged

    def train(self, batches, callbacks) -> None:
        """The program's entry point over staged batches."""
        self.rec.train(1, batches, callbacks=callbacks,
                       dataset_sink_mode=False)

    def span_totals(self) -> dict:
        """``{span: (device ms, count)}`` since the process started
        (empty off the card or with spans off)."""
        return profiling.span_totals(self.device)


def span_ms_per_step(after: dict, before: dict, steps: int) -> dict:
    """``{span: device ms per step}`` between two :meth:`Program.span_totals`
    readings over ``steps`` steps."""
    return profiling.per_step(after, before, steps)
