"""Flat wire-buffer layout: the canonical in-round representation of
every piece of client-visible state (params, Sophia m/h).

Every leaf of the parameter dict is flattened to fp32, concatenated,
zero-padded and reshaped to a ``(rows, cols)`` buffer.  Leaves go in
**sorted-key order**, the order `jax.tree_util.tree_flatten` gives a
dict, so a buffer packed here holds the same coordinates at the same
offsets as the JAX package's (`MLPTask`: ``b1,b2,b3,w1,w2,w3``).

Buffers may carry leading (per-client) axes: `pack` / `unpack` treat
every axis in front of a leaf's own shape as a lead axis, so one spec
serves the ``(rows, cols)`` server model and the ``(C, rows, cols)``
client stacks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

#: bytes of the versioned wire header every payload carries
#: (``<magic 4s><version u16><compressor u8><flags u8><total u64>
#: <quant_block u32><aux u32>``); the header itself waits for the comm
#: slice, byte accounting needs only its size
HEADER_BYTES = 24

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float8_e4m3fn": torch.float8_e4m3fn,
                 "float8_e5m2": torch.float8_e5m2}


def as_dtype(state_dtype: str) -> torch.dtype:
    """`CommConfig.state_dtype` name -> torch dtype."""
    try:
        return _STATE_DTYPES[state_dtype]
    except KeyError:
        raise ValueError(
            f"unknown state_dtype {state_dtype!r} "
            f"(want one of {tuple(_STATE_DTYPES)})") from None


@dataclass(frozen=True)
class FlatSpec:
    """Static description of the packed layout."""
    keys: Tuple[str, ...]
    sizes: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    total: int                 # true element count (pre-padding)
    rows: int
    cols: int

    @property
    def padded(self) -> int:
        return self.rows * self.cols


def _check_tree(tree) -> None:
    if not isinstance(tree, dict) or not all(
            isinstance(v, torch.Tensor) for v in tree.values()):
        raise TypeError("the port packs flat dict[str, Tensor] parameter "
                        f"trees, got {type(tree).__name__}")


def flat_spec(tree: Dict[str, torch.Tensor], cols: int = 1024) -> FlatSpec:
    """Build the layout spec from an unbatched parameter dict."""
    _check_tree(tree)
    keys = tuple(sorted(tree))
    shapes = tuple(tuple(tree[k].shape) for k in keys)
    sizes = tuple(int(tree[k].numel()) for k in keys)
    dtypes = tuple(tree[k].dtype for k in keys)
    total = sum(sizes)
    rows = -(-total // cols)
    return FlatSpec(keys, sizes, shapes, dtypes, total, rows, cols)


def zeros(spec: FlatSpec, lead: Tuple[int, ...] = (),
          dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """A zeroed flat state buffer in ``spec``'s layout, with optional
    leading (per-client) axes."""
    return torch.zeros(tuple(lead) + (spec.rows, spec.cols), dtype=dtype,
                       device=device)


def pack(tree: Dict[str, torch.Tensor], spec: FlatSpec,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Parameter dict -> ``(*lead, rows, cols)`` wire buffer (zero pad at
    the tail), stored as ``dtype``."""
    _check_tree(tree)
    first = tree[spec.keys[0]]
    lead = tuple(first.shape[:first.ndim - len(spec.shapes[0])])
    parts = [tree[k].reshape(lead + (-1,)).to(torch.float32)
             for k in spec.keys]
    v = F.pad(torch.cat(parts, dim=-1), (0, spec.padded - spec.total))
    return v.reshape(lead + (spec.rows, spec.cols)).to(dtype)


def unpack(flat: torch.Tensor, spec: FlatSpec) -> Dict[str, torch.Tensor]:
    """``(*lead, rows, cols)`` buffer -> parameter dict with the spec's
    shapes and dtypes.  For fp32 buffers the leaves are views of
    ``flat``."""
    lead = tuple(flat.shape[:-2])
    v = flat.reshape(lead + (-1,))
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, sz, shp, dt in zip(spec.keys, spec.sizes, spec.shapes,
                              spec.dtypes):
        out[k] = v[..., off:off + sz].reshape(lead + shp).to(dt)
        off += sz
    return out
