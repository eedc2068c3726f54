"""Robust server-side aggregation over a packed ``(K, rows, cols)``
stack of client contributions: the engine rounds reduce the cohort, the
scheduler its arrival buffer with staleness weights.

* ``trimmed_mean`` — per coordinate, drop the ``trim_count`` largest and
  smallest values, then the weighted mean of the survivors (normalised
  by the surviving weight of that coordinate);
* ``coordinate_median`` — the maximal trim ``(K-1)//2``: one survivor
  for odd K, the two middle values for even K;
* ``norm_clip`` — each arrival rescaled to L2 norm at most
  ``clip_norm``, then the weighted mean.

Degenerate settings `resolve` to ``"mean"``: the callers then keep their
own mean path, bitwise as without a `RobustConfig`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AGGREGATORS
from repro_torch.kernels.robust_agg import robust_agg_flat
from repro_torch.kernels.stale_accum import vector_of


def trim_count(robust, K: int) -> int:
    """Per-side trim count for a K-arrival stack: ``floor(trim_fraction
    * K)`` for ``trimmed_mean`` (capped so one value survives), the
    maximal ``(K-1)//2`` for ``coordinate_median``, else 0."""
    if robust.aggregator == "trimmed_mean":
        return min(int(robust.trim_fraction * K), max(0, (K - 1) // 2))
    if robust.aggregator == "coordinate_median":
        return (K - 1) // 2
    return 0


def resolve(robust, K: int) -> str:
    """The aggregator that acts on a K-arrival stack: ``"mean"`` for a
    ``trimmed_mean`` whose trim rounds to 0, a ``coordinate_median`` of
    one arrival and a ``norm_clip`` with the clip off."""
    agg = robust.aggregator
    if agg not in AGGREGATORS:
        raise ValueError(
            f"unknown aggregator {agg!r} (want one of {AGGREGATORS})")
    if agg == "trimmed_mean" and trim_count(robust, K) == 0:
        return "mean"
    if agg == "coordinate_median" and K <= 1:
        return "mean"
    if agg == "norm_clip" and robust.clip_norm <= 0.0:
        return "mean"
    return agg


def clip_scales(wires, clip_norm) -> torch.Tensor:
    """``(K,)`` fp32 factors ``min(1, clip_norm / ||x_k||_2)``, exactly
    1.0 for an arrival already inside the ball (the ``where`` form, so
    clipping an in-ball stack changes nothing)."""
    x = wires.to(torch.float32)
    nrm = torch.sqrt(torch.sum(x * x, dim=(1, 2)))
    return torch.where(nrm <= clip_norm, 1.0,
                       clip_norm / torch.clamp(nrm, min=1e-30))


def aggregate_stack(robust, wires, weights, *, normalize: bool = True):
    """Robust combine of a ``(K, rows, cols)`` stack into ``(rows,
    cols)`` fp32.

    ``weights``: the caller's per-arrival weights (ones for an engine
    cohort, staleness weights in the scheduler), a ``(K,)`` fp32 tensor
    on the wires' device or a host sequence.  With ``normalize`` the
    result is the weighted mean of each coordinate's survivors; without
    it (the scheduler's async apply) the surviving ``sum_k w_k x_k``.
    Every non-degenerate aggregator runs the robust-combine kernel
    (`repro_torch.kernels.robust_agg`); a degenerate call takes the
    plain weighted mean, ``sum_k w_k x_k / sum_k w_k``, as the JAX
    package's does."""
    K = wires.shape[0]
    eff = resolve(robust, K)
    w = vector_of(weights, wires.device, "aggregate_stack", "weights", K)
    if eff == "mean":
        num = torch.sum(wires.to(torch.float32) * w.reshape(K, 1, 1), dim=0)
        return num / torch.sum(w) if normalize else num
    if eff == "norm_clip":
        scales, trim = clip_scales(wires, robust.clip_norm), 0
    else:
        scales = torch.ones((K,), dtype=torch.float32, device=wires.device)
        trim = trim_count(robust, K)
    return robust_agg_flat(wires, w, scales, trim=trim, normalize=normalize)
