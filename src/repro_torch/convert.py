"""Weights and engine state carried between the JAX package and the
port, as numpy arrays.

The JAX side hands over ``jax.tree.map(np.asarray, state)``; the port
hands back plain numpy.  Both directions are exact.  A state is a dict
with ``params`` (a dict of leaves, or the packed ``(rows, cols)``
buffer), ``round``, and, for persistent Fed-Sophia, ``client_opt``:
the m/h stacks ``(C, rows, cols)`` as a pair or a ``{"m", "h"}``
mapping.  The comm path's resident stacks — the uplink EF residuals
``comm_ef`` and the downlink replicas and residuals ``comm_dn_model``,
``comm_dn_ef`` — are carried as they are, where present.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.sophia import SophiaState

#: the comm path's ``(C, rows, cols)`` state stacks
COMM_KEYS = ("comm_ef", "comm_dn_model", "comm_dn_ef")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":
        raise TypeError(f"cannot carry dtype {a.dtype} over (the port's "
                        "resident state is fp32)")
    # a copy: the engine updates resident state in place, and must never
    # write through into the caller's (possibly read-only) arrays
    return torch.tensor(a, device=device)


def params_from_numpy(params: Dict[str, Any],
                      device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def state_from_numpy(state: Dict[str, Any], device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    params = state["params"]
    out: Dict[str, Any] = {
        "params": (params_from_numpy(params, dev)
                   if isinstance(params, dict) else _tensor(params, dev)),
        "round": int(np.asarray(state["round"])),
    }
    if state.get("client_opt") is not None:
        opt = state["client_opt"]
        m, h = (opt["m"], opt["h"]) if isinstance(opt, dict) else opt
        out["client_opt"] = SophiaState(m=_tensor(m, dev),
                                        h=_tensor(h, dev))
    for key in COMM_KEYS:
        if state.get(key) is not None:
            out[key] = _tensor(state[key], dev)
    return out


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    params = state["params"]
    out: Dict[str, Any] = {
        "params": (params_to_numpy(params) if isinstance(params, dict)
                   else params.detach().cpu().numpy()),
        "round": np.asarray(state["round"], np.int32),
    }
    if state.get("client_opt") is not None:
        opt = state["client_opt"]
        out["client_opt"] = {"m": opt.m.detach().cpu().numpy(),
                             "h": opt.h.detach().cpu().numpy()}
    for key in COMM_KEYS:
        if state.get(key) is not None:
            out[key] = state[key].detach().cpu().numpy()
    return out
