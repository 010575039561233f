"""The comparison that decides ``correct``.

The program's training step is built once in set-up and driven through
its first three steps by ``RecModel.train`` on three distinct staged
batches of the ring; the window then goes on with the same object.  Its
readings, taken in set-up (step 1's state, step 3's state), are held
against the plain reference (``portbench/reference/``), which runs the
same three steps on the same raw batches from the same initial weights
once the window has closed and the program's state is freed:

* ``loss``: each step's loss; the number is the largest relative gap;
* ``grad``: the norm of the first gradient as each optimizer got it,
  worked out from its state and weight after one step by the
  optimizer's own module (``portbench/optimizers/<kind>.py``:
  Adam ``m / (1 - b1)``; FTRL ``linear + (sqrt(accum) - sqrt(accum0)) /
  lr * w0``, the gradient exactly; SGD ``(w0 - w1) / lr``), per
  parameter leaf;
* ``change``: the norm of each parameter leaf's change after the three
  steps;
* ``moved``: per table, the rows whose weight or optimizer state
  (each state the optimizer's ``state_inits`` names) changed in the
  three steps (logical rows; the reference's touched rows are the
  ids the three batches hold).

The numbers (:func:`compare`): ``loss_gap``; ``grad_gap`` and
``change_gap``, the worst leaf's gap between the two norms (not the
norm of the difference) over the larger of the reference's norm of that
leaf and of the median leaf; ``grad_gap_median`` and
``change_gap_median``, the median leaf's gap, steadier from seed to seed
where one small leaf swings; ``table_grad_gap``, the worst gap of the
first gradient of the deep tables of more than 2,048 rows against each
one's own norm (their gradients are sums over each id's few positions,
far from zero, where the MLP's deeper leaves carry the cancelling
``mean(p - y)`` that bfloat16 rounds at some seeds); ``table_grad_err``,
the worst relative error of those tables' first gradients element by
element, ``||g - g_ref|| / ||g_ref||`` (a rounding that scales every row
alike moves it as much as the norm gap; one that is random per element
moves it at first order, where the norm gap moves at second);
``untouched_moved``, the count of rows
outside the reference's touched rows that the program moved (exact:
limit 0).  A leaf whose reference gradient is under a thousandth of the
median leaf's is left out of the change numbers (it moves by rounding
alone).  The limits live in ``portbench/limits/<workload>.json``; a
number whose limit is null is printed and not compared there.
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench.optimizers import optimizer

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
           "change_gap_median", "table_grad_gap", "table_grad_err",
           "untouched_moved")
TINY_ROWS = 2048  # a table this small has every id at many positions


def norm(x: torch.Tensor) -> float:
    """The float64 2-norm of a tensor, as a Python number."""
    return float(torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64))


def grad_from_state(hyper: dict, w0, w1, state: dict) -> torch.Tensor:
    """The first gradient an optimizer took, from the weight before and
    after step 1 and its state after it, by the optimizer's module (both
    sides use this, so the two are read alike)."""
    return optimizer(hyper).grad_from_state(hyper, w0, w1, state)


def moved_rows(new, old, states: dict, inits: dict) -> torch.Tensor:
    """[rows] bool: the weight, or any optimizer state that ``inits``
    names, of a logical row differs from its start."""
    moved = (new != old).reshape(new.shape[0], -1).any(1)
    for k, init in inits.items():
        moved |= (states[k] != init).reshape(states[k].shape[0], -1).any(1)
    return moved


def reference_readings(trainer, weights: dict, batches: list) -> dict:
    """Three steps of a reference trainer and its readings."""
    out = {"loss": [], "grad": {}, "change": {}, "moved": {},
           "table_grads": {}}
    for i, batch in enumerate(batches[:3]):
        out["loss"].append(trainer.step(batch))
        if i == 0:
            for k, w in weights.items():
                g = grad_from_state(trainer.side(k), w, trainer.params[k],
                                    trainer.state[k])
                out["grad"][k] = norm(g)
                if k in deep_tables(trainer.touched):
                    out["table_grads"][k] = g
    for k, w in weights.items():
        out["change"][k] = norm(trainer.params[k] - w)
    for k in trainer.tables:
        inits = trainer.optimizer(k).state_inits(trainer.side(k))
        out["moved"][k] = moved_rows(trainer.params[k], weights[k],
                                     trainer.state[k], inits)
    out["touched"] = {k: t.clone() for k, t in trainer.touched.items()}
    return out


def deep_tables(tables: dict) -> list[str]:
    """Of ``{key: [rows, ...] tensor}``, the deep tables of more than
    :data:`TINY_ROWS` rows: their first gradient is a sum over each id's
    few positions of what the MLP's backward hands the rows."""
    return [k for k, t in tables.items()
            if k.split("/")[0] == "deep" and t.shape[0] > TINY_ROWS]


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over ``want``'s rows (``got`` may hold
    more: padding rows)."""
    got = got[: want.shape[0]].to(want.device, torch.float32)
    return norm(got - want) / max(norm(want), 1e-300)


def _gap(p: float, r: float, scale: float) -> float:
    """|p - r| / scale; a missing or non-finite reading is an infinite
    gap."""
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's grad and change gap: the gap of the two norms over the
    larger of the reference's norm of the leaf and of the median leaf; a
    leaf whose reference gradient is under a thousandth of the median
    leaf's is left out of the change."""
    g_med = statistics.median(ref["grad"].values())
    kept = [k for k in ref["change"] if ref["grad"][k] >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][k] for k in kept)
    return {
        "grad": {k: _gap(prog["grad"].get(k, math.nan), r, max(r, g_med))
                 for k, r in ref["grad"].items()},
        "change": {k: _gap(prog["change"].get(k, math.nan), ref["change"][k],
                           max(ref["change"][k], c_med)) for k in kept},
    }


def compare(prog: dict, ref: dict) -> dict:
    """{number: (value, worst leaf or step)} of the program's readings
    against the reference's."""
    out = {}
    losses = [(_gap(p, r, abs(r)), i + 1) for i, (p, r)
              in enumerate(zip(prog["loss"], ref["loss"]))]
    if len(losses) != 3:
        losses.append((math.inf, "missing"))
    out["loss_gap"] = max(losses)
    tables = deep_tables(ref["touched"])
    out["table_grad_gap"] = max(
        [(_gap(prog["grad"].get(k, math.nan), ref["grad"][k],
               ref["grad"][k]), k) for k in tables] or [(0.0, "no table")])
    errs = []
    for k in tables:
        got = prog.get("table_grads", {}).get(k)
        err = (math.inf if got is None
               else relative_error(got, ref["table_grads"][k]))
        errs.append((err if math.isfinite(err) else math.inf, k))
    out["table_grad_err"] = max(errs or [(0.0, "no table")])
    gaps = leaf_gaps(prog, ref)
    for kind in ("grad", "change"):
        by_leaf = sorted((v, k) for k, v in gaps[kind].items())
        out[f"{kind}_gap"] = by_leaf[-1]
        out[f"{kind}_gap_median"] = (
            statistics.median(v for v, _k in by_leaf), "median leaf")
    moved = 0
    worst = ""
    for k, mask in prog["moved"].items():
        touched = ref["touched"][k]
        pad = mask.shape[0] - touched.shape[0]
        if pad > 0:
            touched = torch.cat([touched, touched.new_zeros(pad)])
        n = int((mask.to(touched.device) & ~touched).sum())
        if n:
            worst = k
        moved += n
    out["untouched_moved"] = (moved, worst)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number that has a limit is within it
    (``untouched_moved`` exactly at it); a number whose limit is None is
    printed and not compared."""
    return all(numbers[k][0] <= limits[k] for k in NUMBERS
               if limits.get(k) is not None)
