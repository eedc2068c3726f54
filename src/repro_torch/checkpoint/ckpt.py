"""Checkpoints in the JAX package's on-disk format (its
``repro/checkpoint/ckpt.py``): a directory holding ``arrays.npz``, one
array per leaf keyed by its ``/``-joined path, and ``manifest.json``
(``step``, sorted ``keys``, ``shapes``, logical ``dtypes`` and free-form
``extra``).  bf16 leaves are stored as fp32 — numpy's savez cannot hold
bf16 — and cast back on restore, exactly (every bf16 value is an fp32
value).  Either package reads the other's checkpoints.

Checkpoints always store the params TREE, whatever the between-round
residency: `save_packed` / `restore_packed` carry a packed ``(rows,
cols)`` wire buffer across through its `FlatSpec`.  The wire headers of
the run ride in ``extra["wire"]`` (`FedEngine.wire_headers`), so a
resume can refuse a checkpoint written under another layout
(`repro_torch.comm.flat.check_headers`).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.comm import flat as cflat
from repro_torch.convert import flatten

#: logical dtypes a checkpoint holds, by the JAX package's names
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _to_np(v: torch.Tensor) -> np.ndarray:
    if v.dtype not in _NAMES:
        raise TypeError(f"checkpoints hold float32 and bfloat16 leaves, "
                        f"not {v.dtype}")
    # bf16 -> fp32 is exact; the manifest keeps the logical dtype
    return v.detach().to("cpu", torch.float32).numpy()


def save(path: str, tree: Dict[str, Any], step: int = 0,
         extra: Optional[dict] = None) -> None:
    """Write ``tree`` (the port's flat ``/``-keyed dict, or nested
    dicts) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = flatten(tree)
    arrays = {k: _to_np(v) for k, v in flat.items()}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _NAMES[v.dtype] for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def restore(path: str, like: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Restore the leaves of ``like`` (the port's flat dict): each gets
    ``like``'s shape, dtype and device."""
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = {}
        for key, ref in like.items():
            arr = data[key]
            assert tuple(arr.shape) == tuple(ref.shape), \
                f"shape mismatch for {key}: {arr.shape} vs {tuple(ref.shape)}"
            leaves[key] = torch.from_numpy(np.array(arr)).to(
                device=ref.device, dtype=ref.dtype)
    return leaves


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------ packed-resident state shims
def save_packed(path: str, packed: torch.Tensor, spec: cflat.FlatSpec,
                step: int = 0, extra: Optional[dict] = None) -> None:
    """`save` for a packed ``(rows, cols)`` wire buffer: unpacked through
    ``spec`` (the leaves in their logical dtypes), so the checkpoint is
    the one a dict-resident run writes."""
    save(path, cflat.unpack(packed, spec), step=step, extra=extra)


def restore_packed(path: str, spec: cflat.FlatSpec,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """Restore a checkpoint straight into wire layout: the tree rebuilt
    from ``spec``'s shapes and dtypes, packed as one ``(rows, cols)``
    buffer stored in ``dtype``.  The inverse of `save_packed`."""
    like = cflat.unpack(cflat.zeros(spec, device=device), spec)
    return cflat.pack(restore(path, like), spec, dtype=dtype)
