"""The optimizers, one module a kind.

A configuration's ``optimizers`` entry gives each side (``wide``,
``deep``) a spec, ``{"kind": <kind>, <hyperparameter>: <value>, ...}``;
``portbench/optimizers/<kind>.py`` holds for that kind:

* ``build(spec, loss_scale)``: the port's optimizer of the spec, from
  ``mindrec_tpu_torch.train.optim`` (imported there, so that the
  reference, which uses the rest of the module, loads nothing of the
  program);
* ``init_state(w, hyper)`` and ``update(w, state, g, t, hyper)`` ->
  ``(w', state')``: the rule in plain float32 torch for the reference,
  on whole tensors (a table's present rows, ``t`` the leaf's own step
  count, 1-based);
* ``state_inits(hyper)``: ``{state: initial value}`` of each state the
  rule keeps per element (a row whose state differs from it has moved);
* ``grad_from_state(hyper, w0, w1, state)``: the first gradient the
  optimizer took, from the weight before (``w0``) and after (``w1``)
  step 1 and the state after it; the program's readings and the
  reference's are worked out alike.

``hyper`` is the spec, or on the program's side the port optimizer's
``hyper`` with its ``kind``; both name the hyperparameters alike.
"""

from __future__ import annotations

import importlib


def optimizer(hyper: dict):
    """The module of the optimizer kind ``hyper["kind"]``."""
    return importlib.import_module(f"portbench.optimizers.{hyper['kind']}")
