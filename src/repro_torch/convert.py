"""Weights and engine state carried between the JAX package and the
port, as numpy arrays.

The JAX side hands over ``jax.tree.map(np.asarray, state)``; the port
hands back plain numpy.  Both directions are exact.  A state is a dict
with ``params`` (a dict of leaves, or the packed ``(rows, cols)``
buffer), ``round``, and, for persistent Fed-Sophia, ``client_opt``:
the m/h stacks ``(C, rows, cols)`` as a pair or a ``{"m", "h"}``
mapping.  FedAdam / FedYogi carry ``server_opt``, ``{"m", "v"}`` in the
params' form (dicts of leaves, or packed buffers).  The comm path's
resident stacks — the uplink EF residuals ``comm_ef`` and the downlink
replicas and residuals ``comm_dn_model``, ``comm_dn_ef`` — are carried
as they are, where present.

Parameter trees cross in both shapes: the JAX package's nested dicts
(the LM zoo's ``{"blocks_0": {"mixer": {"wq": ...}}}``) come in as the
port's flat dict keyed by ``/``-joined paths (``"blocks_0/mixer/wq"``,
the keys of the JAX package's checkpoints), and go back out nested
(`nest`).  Sorted, the joined keys are the order
`jax.tree_util.tree_flatten` gives the nested dicts, since ``/`` sorts
below every character of a key, so both packages pack the same buffer.

Narrow resident state (bf16, e4m3, e5m2: `CommConfig.state_dtype` and
its per-buffer overrides) crosses as numpy arrays of the ``ml_dtypes``
types the JAX package uses, bit for bit through a same-width integer
view.  This module does not import ``ml_dtypes``: it reads the dtype's
name on the way in, and on the way out finds the numpy dtype by name,
which exists once the caller has loaded ``ml_dtypes`` (as JAX does).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.sophia import SophiaState

#: the comm path's ``(C, rows, cols)`` state stacks
COMM_KEYS = ("comm_ef", "comm_dn_model", "comm_dn_ef")

#: narrow dtype name -> (torch dtype, the integer type of its bits)
NARROW = {"bfloat16": (torch.bfloat16, np.int16),
          "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
          "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_NARROW_NAMES = {dt: name for name, (dt, _) in NARROW.items()}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    narrow = NARROW.get(a.dtype.name)
    if narrow is not None:
        dt, bits = narrow
        # np.array: a private, writable copy, as below
        return torch.from_numpy(np.array(a).view(bits)).view(dt).to(device)
    if a.dtype.kind not in "fiub":
        raise TypeError(f"cannot carry dtype {a.dtype} over (want a "
                        "numpy number type, or one of "
                        f"{tuple(NARROW)})")
    # a copy: the engine updates resident state in place, and must never
    # write through into the caller's (possibly read-only) arrays
    return torch.tensor(a, device=device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    name = _NARROW_NAMES.get(t.dtype)
    if name is None:
        return t.numpy()
    try:
        dt = np.dtype(name)
    except TypeError:
        raise TypeError(f"numpy knows no {name} dtype until ml_dtypes is "
                        "loaded; import ml_dtypes first, or upcast the "
                        "state") from None
    return t.view(torch.int16 if t.element_size() == 2
                  else torch.uint8).numpy().view(dt)


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict of leaves as one flat dict keyed by ``/``-joined
    paths; a flat dict comes back as it is."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `flatten`: ``/``-joined keys as nested dicts."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _tree_from(tree, dev):
    return ({k: _tensor(v, dev) for k, v in flatten(tree).items()}
            if isinstance(tree, dict) else _tensor(tree, dev))


def _tree_to(tree):
    return (nest({k: _array(v) for k, v in tree.items()})
            if isinstance(tree, dict) else _array(tree))


def params_from_numpy(params: Dict[str, Any],
                      device=None) -> Dict[str, torch.Tensor]:
    """Numpy leaves (a flat or nested dict) -> the port's flat dict."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in flatten(params).items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat dict -> numpy leaves, nested as the JAX package
    nests them."""
    return _tree_to(params)


def state_from_numpy(state: Dict[str, Any], device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    out: Dict[str, Any] = {
        "params": _tree_from(state["params"], dev),
        "round": int(np.asarray(state["round"])),
    }
    if state.get("client_opt") is not None:
        opt = state["client_opt"]
        m, h = (opt["m"], opt["h"]) if isinstance(opt, dict) else opt
        out["client_opt"] = SophiaState(m=_tensor(m, dev),
                                        h=_tensor(h, dev))
    if state.get("server_opt") is not None:
        out["server_opt"] = {k: _tree_from(state["server_opt"][k], dev)
                             for k in ("m", "v")}
    for key in COMM_KEYS:
        if state.get(key) is not None:
            out[key] = _tensor(state[key], dev)
    return out


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "params": _tree_to(state["params"]),
        "round": np.asarray(state["round"], np.int32),
    }
    if state.get("client_opt") is not None:
        opt = state["client_opt"]
        out["client_opt"] = {"m": _array(opt.m), "h": _array(opt.h)}
    if state.get("server_opt") is not None:
        out["server_opt"] = {k: _tree_to(state["server_opt"][k])
                             for k in ("m", "v")}
    for key in COMM_KEYS:
        if state.get(key) is not None:
            out[key] = _array(state[key])
    return out
