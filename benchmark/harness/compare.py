"""The numbers a training cell compares, program against reference.

- ``loss_gap``: the worst step's |loss - reference loss| / |reference loss|
  (over several losses, the worst of them);
- ``grad_gap``: over the leaves, the worst gap between the norms of the
  first gradient (as the optimizer gets it), |norm - reference norm| over
  the larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same of each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by round-off alone).
"""

from __future__ import annotations

import statistics


def norm(t) -> float:
    """The L2 norm of a tensor; 0 for None (an optimizer that kept no state
    for a leaf got no gradient for it)."""
    return 0.0 if t is None else float(t.norm())


def loss_gap(losses, ref_losses) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(losses, ref_losses))


def leaf_gaps(norms: dict, ref: dict, keep=None) -> dict:
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(norms[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def norm_gap(norms: dict, ref: dict, keep=None) -> float:
    return max(leaf_gaps(norms, ref, keep).values())


def moving(ref_grad: dict) -> set:
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= 1e-3 * med}


def step_loss_gap(prog: dict, ref: dict, k: int) -> float:
    """The worst loss's gap at step ``k`` alone (0 the first)."""
    p, r = prog["losses"], ref["losses"]
    if not isinstance(r, dict):
        p, r = {"loss": p}, {"loss": r}
    return max(loss_gap(p[n][k:k + 1], r[n][k:k + 1]) for n in r)


def training(prog: dict, ref: dict, loss_steps=None) -> dict:
    """{number: value} of ``prog`` against ``ref`` (each {"losses",
    "grad", "change"}, the losses a list, or {name: list} of which the
    worst counts), the losses over the first ``loss_steps`` steps (all
    without)."""
    p, r = prog["losses"], ref["losses"]
    if not isinstance(r, dict):
        p, r = {"loss": p}, {"loss": r}
    return {"loss_gap": max(loss_gap(p[k][:loss_steps], r[k][:loss_steps])
                            for k in r),
            "grad_gap": norm_gap(prog["grad"], ref["grad"]),
            "change_gap": norm_gap(prog["change"], ref["change"],
                                   moving(ref["grad"]))}


def details(prog: dict, ref: dict) -> list:
    """Lines that show where the numbers come from: each step's losses on
    both sides and the worst leaves."""
    out = [f"losses: program {prog['losses']} reference {ref['losses']}"]
    for what, keep in (("grad", None), ("change", moving(ref["grad"]))):
        gaps = leaf_gaps(prog[what], ref[what], keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        out.append(f"{what}: worst leaves " + ", ".join(
            f"{k} {gaps[k]:.3g} ({prog[what][k]:.6g} vs {ref[what][k]:.6g})"
            for k in worst))
    return out
