"""The comparison that decides ``correct``: the numbers the program's
timed path produced in its first rounds against the plain reference's,
each against the cell's limit (``portbench/limits/<cell>.json``).

A readout (of the program, of the reference, or of the control) holds:

* ``loss``: each checked round's loss;
* ``m`` and ``h``: after the first round, the norm of every leaf of
  every client's Sophia m (its gradients as the optimiser holds them)
  and h (its GNB estimate), keyed ``"<client>/<leaf>"``;
* ``change``: the norm of every leaf's change of the server model over
  the checked rounds;
* ``dist``: client 0's leaf by leaf distances ||x - x_ref|| from the
  reference's, for ``m``, ``h`` and ``change`` (the reference works them
  out from the vectors the readout kept, `harness.reference_readout`).

The numbers, each the worst over its parts:

* ``loss_gap``: |loss - ref| / |ref| over the checked rounds;
* ``grad_gap``, ``gnb_gap``: |norm - ref norm| over the larger of the
  reference's norm of that leaf and its median leaf's (of that client);
* ``change_gap``: the same for the change, leaving out the leaves whose
  reference gradient (its m norm, the largest over clients) is under a
  thousandth of the median leaf's: those move by round-off alone;
* ``grad_dist``, ``gnb_dist``, ``change_dist``: the distance of client
  0's leaf from the reference's over the larger of the reference's norm
  of that leaf and its median leaf's (the change over the same leaves as
  ``change_gap``).  A gap of norms cannot see an error that turns a
  vector without changing its length, as a lower precision's rounding
  does; a distance can.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

NUMBERS = ("loss_gap", "grad_gap", "gnb_gap", "change_gap", "grad_dist",
           "gnb_dist", "change_dist")
#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of ``change_gap``
STILL = 1e-3


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _gap(p: float, r: float, base: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), base, 1e-30)


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> float:
    """Worst gap of ``prog`` against ``ref`` over ``keys`` (grouped by the
    part before the first ``/`` when it is a client index)."""
    groups: Dict[str, List[str]] = {}
    for k in keys:
        head = k.split("/", 1)[0]
        groups.setdefault(head if head.isdigit() else "", []).append(k)
    worst = 0.0
    for ks in groups.values():
        med = _median([ref[k] for k in ks])
        for k in ks:
            if k not in prog:
                return math.inf
            worst = max(worst, _gap(prog[k], ref[k], med))
    return worst


def _ratios(dist: Dict[str, float], ref: Dict[str, float],
            keys: List[str]) -> Dict[str, float]:
    """``dist[k]`` over the larger of ``ref[k]`` and the median of ``ref``
    over ``keys``, for each of ``keys`` (inf where a distance is
    missing)."""
    med = _median([ref[k] for k in keys])
    return {k: dist.get(k, math.inf) / max(ref[k], med, 1e-30)
            for k in keys}


def moving_leaves(ref: dict) -> List[str]:
    """The leaves the reference's gradient moves: its m norm (the
    largest over clients) at least `STILL` of the median leaf's."""
    grad: Dict[str, float] = {}
    for k, v in ref["m"].items():
        leaf = k.split("/", 1)[1]
        grad[leaf] = max(grad.get(leaf, 0.0), v)
    med = _median(list(grad.values()))
    return sorted(k for k, v in grad.items() if v >= STILL * med)


def leaf_distances(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Client 0's distance of each leaf from the reference's, as a share
    (`_ratios`), for m, h and the change (its moving leaves)."""
    dist = prog.get("dist", {})
    out = {}
    for part in ("m", "h"):
        norms = {k.split("/", 1)[1]: v for k, v in ref[part].items()
                 if k.startswith("0/")}
        out[part] = _ratios(dist.get(part, {}), norms, sorted(norms))
    out["change"] = _ratios(dist.get("change", {}), ref["change"],
                            moving_leaves(ref))
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of `NUMBERS` for ``prog`` against ``ref``."""
    losses = [_gap(p, r, 0.0) for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses.append(math.inf)
    leaves = leaf_distances(prog, ref)
    return {
        "loss_gap": max(losses),
        "grad_gap": _norm_gap(prog["m"], ref["m"], sorted(ref["m"])),
        "gnb_gap": _norm_gap(prog["h"], ref["h"], sorted(ref["h"])),
        "change_gap": _norm_gap(prog["change"], ref["change"],
                                moving_leaves(ref)),
        "grad_dist": max(leaves["m"].values()),
        "gnb_dist": max(leaves["h"].values()),
        "change_dist": max(leaves["change"].values()),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` (every number the cell limits within its limit; a cell
    with no limit is never correct) and each number beside its limit
    (None: not compared in this cell)."""
    shown = {}
    ok = bool(limits)
    for name in NUMBERS:
        value = numbers.get(name, math.inf)
        limit = limits.get(name)
        if limit is not None:
            ok = ok and math.isfinite(value) and value <= limit
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
