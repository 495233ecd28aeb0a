"""The comparison that decides `correct` for a training cell.

Both sides report the same readings of their first train steps: each
step's loss, the norm of each leaf's first minibatch gradient as the
optimizer got it, the norm of each leaf's change over the steps, and the
envs' states after the first step. Four numbers are compared, each against
a limit of its own:

* ``loss_gap``: the largest |program - reference| over the steps' losses,
  over the mean of the reference's |loss| (a step's loss can come near 0);
* ``grad_gap``: the worst leaf's |norm(program) - norm(reference)| of the
  first gradient, over the larger of the reference's norm of that leaf and
  of the median leaf;
* ``change_gap``: the same for each leaf's change, over the leaves whose
  first gradient in the reference is at least a thousandth of the median
  leaf's (a leaf whose gradient is nought to rounding moves under Adam by
  round-off alone);
* ``state_gap``: the median over the envs of |program - reference| / (1 +
  |reference|) of each env's 13 physics state values after the first
  step's rollout, which both sides run from the same weights. A done flag
  that flips on rounding sends one env down another path, which moves the
  three numbers above on some seeds by as much as a product in a lower
  precision does; the median over the envs is not moved by a few such
  envs, and a lower precision moves every env. (After the first update the
  sides' weights differ where Adam's first, sign-like steps follow a
  gradient entry that is nought to rounding, so later states are not
  compared.)

A driver may add numbers of its own in its ``gaps(run, readings, ref)``;
the hover and landing drivers add ``update_gap`` (`update_gap`): the
program's first minibatch gradient against the reference's gradient on the
same rows, which sees the update's precision without the rollout's done
flips. The numbers judged are those the traffic file gives limits for.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap", "state_gap")
MOVING = 1e-3  # a leaf moves when its first gradient is over this share of the median leaf's


def _leaf_gap(prog: list, ref: list, keep: list) -> float:
    med = statistics.median(ref)
    gaps = [abs(p - r) / max(r, med, 1e-30) for p, r, k in zip(prog, ref, keep) if k]
    return max(gaps) if gaps else math.inf


def state_gap(prog, ref) -> float:
    """Median over the envs of |program - reference| / (1 + |reference|),
    the norms over each env's state values."""
    import torch

    if prog.shape != ref.shape or not bool(torch.isfinite(prog).all()):
        return math.inf
    d = torch.linalg.vector_norm((prog - ref).double(), dim=-1)
    return float((d / (1.0 + torch.linalg.vector_norm(ref.double(), dim=-1))).median())


def gaps(prog: dict, ref: dict) -> dict:
    if prog["names"] != ref["names"]:
        raise ValueError(f"the leaves differ: {prog['names']} against {ref['names']}")
    nonfinite = [v for side in (prog, ref) for key in ("losses", "first_grad", "change")
                 for v in side[key] if not math.isfinite(v)]
    if nonfinite or len(prog["losses"]) != len(ref["losses"]):
        return {k: math.inf for k in NAMES}
    scale = max(sum(abs(r) for r in ref["losses"]) / len(ref["losses"]), 1e-30)
    loss = max(abs(p - r) for p, r in zip(prog["losses"], ref["losses"])) / scale
    med = statistics.median(ref["first_grad"])
    moving = [g >= MOVING * med for g in ref["first_grad"]]
    return {
        "loss_gap": loss,
        "grad_gap": _leaf_gap(prog["first_grad"], ref["first_grad"], [True] * len(moving)),
        "change_gap": _leaf_gap(prog["change"], ref["change"], moving),
        "state_gap": state_gap(prog["state"], ref["state"]),
    }


def grad_diff(prog: list, ref: list) -> float:
    """The worst leaf's |program - reference| of two gradients taken on the
    same rows from the same leaves, over the larger of the reference's norm
    of that leaf and of the median leaf."""
    import torch

    if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return math.inf
    norms = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = statistics.median(norms)
    gaps = [float(torch.linalg.vector_norm(p.double() - r.double())) / max(n, med, 1e-30)
            for p, r, n in zip(prog, ref, norms)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def update_gap(readings: dict, first_grad) -> float:
    """`grad_diff` of a side's first minibatch gradient (``first_grad_t``)
    against ``first_grad(rows)``, the reference's gradient on the rows that
    side took it on (``first_rows``)."""
    rows = readings.get("first_rows")
    if rows is None:
        return math.inf
    return grad_diff(readings["first_grad_t"], [g.cpu() for g in first_grad(rows)])


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number that ``limits`` names at or under its
    limit (one not found reads as infinite); the checks name each number
    beside its limit."""
    values = {k: found.get(k, math.inf) for k in limits}
    checks = {k: {"value": v if math.isfinite(v) else 1e300, "limit": limits[k]}
              for k, v in values.items()}
    return all(values[k] <= limits[k] for k in limits), checks


def check_lines(checks: dict) -> list:
    return [f"{k} {c['value']:.6g} limit {c['limit']:.6g}" for k, c in checks.items()]
