"""Sophia health probes (the port of the JAX package's
``repro/obs/probes.py``).

`sophia_health` turns the persistent per-client Sophia state into the
scalars the paper's claims ride on: how often the Eq. 11 clip binds, how
large the m/h EMAs run, and how fresh the GNB curvature estimate is.
They are reductions over buffers the round already produced, read and
never written, so a probed round's state is bitwise the unprobed one's;
the scalars stay on the device until the caller reads them.

The clip fraction replays the Eq. 11 decision from the final EMAs: a
coordinate was clipped iff ``|m / max(h, eps)| >= rho``.  The packed
buffers' zero pad tail gives ``|0 / eps| < rho``, so pad coordinates
never count, and the fraction divides by the true coordinate count.
"""
from __future__ import annotations

from typing import Dict

import torch

#: the metric names `sophia_health` emits (the JAX package's
#: ``PROBE_METRICS``); event records carry them under these keys
PROBE_METRICS = ("clip_fraction", "m_norm", "h_norm", "h_staleness",
                 "gnb_refreshes")


def sophia_health(opt, round_idx: int, fed,
                  total: int) -> Dict[str, torch.Tensor]:
    """Health scalars (0-dim fp32 tensors on the state's device) of a
    `SophiaState` of ``(rows, cols)`` buffers or ``(C, rows, cols)``
    stacks in any state dtype (upcast to fp32 for the reductions).
    ``round_idx``: the 0-based round the EMAs were last updated in;
    ``total``: the layout's true coordinate count (pad excluded)."""
    m = opt.m.to(torch.float32)
    h = opt.h.to(torch.float32)
    C = m.shape[0] if m.ndim == 3 else 1
    n = C * total
    # Eq. 11 replay; the count is an exact integer, then one fp32 divide
    at_bound = torch.abs(m / torch.clamp(h, min=fed.eps)) >= fed.rho
    clip_fraction = (torch.sum(at_bound).to(torch.float32)
                     / torch.tensor(n, dtype=torch.float32))
    # RMS over clients of the per-client L2 norms: sqrt(mean_c |x_c|^2)
    m_norm = torch.sqrt(torch.sum(m * m) / C)
    h_norm = torch.sqrt(torch.sum(h * h) / C)
    # curvature freshness: the GNB estimator refreshes every tau units
    # (rounds, or local steps: `FedConfig.hessian_every_unit`)
    r = int(round_idx)
    last = r if fed.hessian_every_unit == "round" else \
        (r + 1) * fed.local_iters - 1
    dev = m.device
    return {"clip_fraction": clip_fraction, "m_norm": m_norm,
            "h_norm": h_norm,
            "h_staleness": torch.tensor(float(last % fed.tau),
                                        device=dev),
            "gnb_refreshes": torch.tensor(float(last // fed.tau + 1),
                                          device=dev)}
