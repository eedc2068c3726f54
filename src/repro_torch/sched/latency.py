"""Deterministic per-client latency model for the virtual clock: a copy
of the JAX package's ``repro/sched/latency.py`` on the port's byte
accounting, equal to it in every float64 host number.

Every client gets a speed multiplier drawn once, deterministically,
from ``SchedConfig.seed`` (a numpy Generator: the clock is pure host
math).  One dispatch for client ``i`` then takes

    T_i = bytes_down / B_i  +  J * compute_s * m_i  +  bytes_up / B_i

virtual seconds, where ``m_i`` is the multiplier, ``B_i =
bandwidth_bps / 8 / m_i`` (slow clients are slow on both legs), ``J``
is ``FedConfig.local_iters`` and the per-stream byte counts are the
comm layer's exact wire totals
(`repro_torch.comm.accounting.stream_bytes`)
— compression does not just shrink the reported bytes, it shortens the
simulated round.

Profiles (`repro_torch.configs.base.LATENCY_PROFILES`):

* ``uniform``   — every client identical (multiplier 1).
* ``straggler`` — a seeded ``straggler_frac`` of clients are
  ``straggler_slowdown`` x slower; everyone else is 1.
* ``lognormal`` — multipliers ~ LogNormal(0, ``lognormal_sigma``),
  the classic heavy-tailed device-heterogeneity model.
"""
from __future__ import annotations

import numpy as np

from repro_torch.comm import accounting
from repro_torch.configs.base import (LATENCY_PROFILES, CommConfig,
                                      FedConfig, SchedConfig)


def client_multipliers(sched: SchedConfig, num_clients: int) -> np.ndarray:
    """(C,) per-client slowdown multipliers, deterministic in
    ``sched.seed`` (the virtual clock must replay bit-for-bit)."""
    if sched.latency_profile not in LATENCY_PROFILES:
        raise ValueError(
            f"unknown latency profile {sched.latency_profile!r} "
            f"(want one of {LATENCY_PROFILES})")
    rng = np.random.default_rng(sched.seed)
    mult = np.ones(num_clients, np.float64)
    if sched.latency_profile == "straggler":
        k = max(1, int(round(sched.straggler_frac * num_clients)))
        slow = rng.permutation(num_clients)[:k]
        mult[slow] = sched.straggler_slowdown
    elif sched.latency_profile == "lognormal":
        mult = rng.lognormal(mean=0.0, sigma=sched.lognormal_sigma,
                             size=num_clients)
    return mult


def stragglers(sched: SchedConfig, num_clients: int) -> np.ndarray:
    """Client ids with an above-median multiplier (empty for uniform)."""
    mult = client_multipliers(sched, num_clients)
    return np.where(mult > np.median(mult))[0]


def leg_bytes(comm: CommConfig, n_params: int):
    """(downlink, uplink) wire bytes of ONE dispatch for one client.

    The hessian stream rides both legs when enabled: its uplink
    payload travels with the model delta, and the common averaged-
    curvature broadcast still crosses this client's link once.
    """
    down = accounting.stream_bytes(comm, "downlink", n_params) \
        + accounting.stream_bytes(comm, "hessian", n_params)
    up = accounting.stream_bytes(comm, "uplink", n_params) \
        + accounting.stream_bytes(comm, "hessian", n_params)
    return down, up


def dispatch_seconds(fed: FedConfig, n_params: int,
                     num_clients: int) -> np.ndarray:
    """(C,) virtual seconds from dispatch to arrival, per client."""
    sched = fed.sched
    mult = client_multipliers(sched, num_clients)
    down, up = leg_bytes(fed.comm, n_params)
    bytes_per_s = sched.bandwidth_bps / 8.0 / mult
    compute = fed.local_iters * sched.compute_s * mult
    return (down + up) / bytes_per_s + compute


def dispatch_legs(fed: FedConfig, n_params: int, num_clients: int):
    """Per-leg durations of one dispatch: ``(downlink_s, compute_s,
    uplink_s)``, each (C,).

    Trace-context decomposition of `dispatch_seconds` for the
    scheduler's dispatch records.  The virtual clock
    stays on `dispatch_seconds`' lumped arithmetic — its float
    evaluation order is pinned by committed trajectories — so the leg
    sum may differ from it in the last ulps; the arrival timestamp is
    always authoritative.
    """
    sched = fed.sched
    mult = client_multipliers(sched, num_clients)
    down, up = leg_bytes(fed.comm, n_params)
    bytes_per_s = sched.bandwidth_bps / 8.0 / mult
    compute = fed.local_iters * sched.compute_s * mult
    return down / bytes_per_s, compute, up / bytes_per_s
