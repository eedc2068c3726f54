"""The pytree form of the fused Sophia update (the port of the JAX
package's ``kernels/ops.py:sophia_fused_step``).  The round engine never
takes this route: it holds its state packed and calls the flat kernel
directly.

For CUDA trees: one launch of the kernel's pytree form
(``csrc/sophia_update.cu: sophia_leaves_kernel``) per `MAX_LEAVES`
leaves, reading the leaves of the five trees where they lie and writing
three fresh trees (the step is functional, as in the JAX package);
`leaf_table` builds each launch's table on the host.  For CPU trees the
plain version, as the JAX package computes it: every tree packed into
one ``(R, 1024)`` buffer (sorted-key order, `repro_torch.comm.flat`),
`ref.sophia_update_ref`, the results unpacked.  Either way the results
are in the params leaves' dtypes (the JAX package unpacks all three with
the params' layout).  Storage-less trees take the shape-only path
(`cost`).  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.comm.flat import flat_spec, pack, unpack
from repro_torch.kernels import build, cost
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.ref import sophia_update_ref

#: packed columns of the plain version (the JAX package's ``BLOCK_C``)
BLOCK_C = 1024

#: leaves per launch: the kernel's ``kMaxLeaves``, which keeps its leaf
#: table inside the classic 4 KB of kernel parameters
MAX_LEAVES = 32

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {"sophia_fused_step": 0}

#: the trees of a step, in the kernel's operand order
_TREES = ("params", "m", "h", "grads", "h_hat")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class LeafLaunch:
    """One launch's leaf table, one entry per leaf of the launch."""
    keys: Tuple[str, ...]
    #: 8 a leaf: theta_out, m_out, h_out, theta, m, h, g, h_hat
    ptrs: Tuple[int, ...]
    ns: Tuple[int, ...]
    #: 6 a leaf: the outputs' dtype code, then the five inputs'
    codes: Tuple[int, ...]
    #: the leaf takes the fp32 form: all eight fp32 and 16-byte aligned
    f32x4: Tuple[bool, ...]
    #: each leaf's first block, then the grid's size
    first_block: Tuple[int, ...]


def leaf_table(leaves: Sequence[Tuple[str, Sequence[torch.Tensor]]],
               coords_per_block: int) -> List[LeafLaunch]:
    """The launches over ``leaves``, each ``(key, (theta_out, m_out,
    h_out, theta, m, h, g, h_hat))`` with the outputs in the params
    leaf's dtype: at most `MAX_LEAVES` leaves a launch, in order; each
    leaf owns ``ceil(n / coords_per_block)`` blocks of its launch's grid.
    Leaves of no coordinates are left out."""
    leaves = [(k, ts) for k, ts in leaves if ts[3].numel() > 0]
    launches = []
    for s in range(0, len(leaves), MAX_LEAVES):
        part = leaves[s:s + MAX_LEAVES]
        first = [0]
        for _, ts in part:
            first.append(first[-1] + -(-ts[3].numel() // coords_per_block))
        launches.append(LeafLaunch(
            keys=tuple(k for k, _ in part),
            ptrs=tuple(t.data_ptr() for _, ts in part for t in ts),
            ns=tuple(ts[3].numel() for _, ts in part),
            codes=tuple(DTYPE_CODES[t.dtype] for _, ts in part
                        for t in ts[2:]),
            f32x4=tuple(all(t.dtype == torch.float32
                            and t.data_ptr() % 16 == 0 for t in ts)
                        for _, ts in part),
            first_block=tuple(first)))
    return launches


def _validate(trees) -> str:
    """Keys, shapes, dtypes and devices of the five trees; returns the
    device type they share.  CUDA leaves must be contiguous."""
    params = trees[0]
    keys = sorted(params)
    for label, tree in zip(_TREES, trees):
        if not isinstance(tree, dict) or sorted(tree) != keys:
            raise ValueError(f"sophia_fused_step: {label} must be a dict "
                             f"with the params' keys {keys}")
        for k in keys:
            t = tree[k]
            if t.shape != params[k].shape:
                raise ValueError(f"sophia_fused_step: {label}[{k!r}] has "
                                 f"shape {tuple(t.shape)}, params "
                                 f"{tuple(params[k].shape)}")
            if t.dtype not in DTYPE_CODES:
                raise TypeError(f"sophia_fused_step: {label}[{k!r}] has "
                                f"unsupported dtype {t.dtype} (want one of "
                                f"{tuple(DTYPE_CODES)})")
    devices = {t.device for tree in trees for t in tree.values()}
    if len(devices) != 1:
        raise ValueError(f"sophia_fused_step: leaves on several devices "
                         f"{devices}")
    dev = next(iter(devices))
    if dev.type == "cuda":
        for label, tree in zip(_TREES, trees):
            for k, t in tree.items():
                if not t.is_contiguous():
                    raise ValueError(f"sophia_fused_step: {label}[{k!r}] "
                                     "is not contiguous; materialise it "
                                     "first (.contiguous())")
    elif dev.type != "cpu":
        raise ValueError(f"sophia_fused_step: unsupported device {dev}")
    return dev.type


def _lib():
    lib = build.load("sophia_update")
    fn = lib.sophia_leaves_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.sophia_update_threads.restype = ctypes.c_int
    return lib


def _launch(trees, do_h, lr, hp):
    params = trees[0]
    keys = sorted(params)
    outs = {k: tuple(torch.empty_like(params[k]) for _ in range(3))
            for k in keys}
    lib = _lib()
    scalars = (float(do_h), float(lr), hp["beta1"], 1.0 - hp["beta1"],
               hp["beta2"], 1.0 - hp["beta2"], hp["rho"], hp["eps"],
               hp["weight_decay"])
    stream = torch.cuda.current_stream(params[keys[0]].device).cuda_stream
    leaves = [(k, outs[k] + tuple(tree[k] for tree in trees)) for k in keys]
    for t in leaf_table(leaves, 4 * int(lib.sophia_update_threads())):
        n = len(t.ns)
        err = lib.sophia_leaves_launch(
            (ctypes.c_void_p * (8 * n))(*t.ptrs),
            (ctypes.c_int64 * n)(*t.ns),
            (ctypes.c_int * (6 * n))(*t.codes),
            (ctypes.c_int * n)(*t.f32x4),
            (ctypes.c_int * (n + 1))(*t.first_block), n, *scalars, stream)
        if err != 0:
            raise RuntimeError(f"sophia_fused_step: kernel launch failed "
                               f"with CUDA error {err}")
        LAUNCHES["sophia_fused_step"] += 1
    return tuple({k: outs[k][j] for k in keys} for j in range(3))


def _shape_only(trees):
    """The shape-only launches (`cost`) of a step over storage-less
    trees: the real route's launches, one per `MAX_LEAVES` leaves of
    coordinates, each recorded with its leaves' bytes."""
    params = trees[0]
    keys = sorted(params)
    outs = {k: tuple(torch.empty_like(params[k]) for _ in range(3))
            for k in keys}
    live = [k for k in keys if params[k].numel() > 0]
    for s in range(0, len(live), MAX_LEAVES):
        part = live[s:s + MAX_LEAVES]
        cost.shape_only_launch(
            "sophia_fused_step",
            [tree[k] for tree in trees for k in part],
            [o for k in part for o in outs[k]],
            cost.SOPHIA_OPS * sum(params[k].numel() for k in part))
    return tuple({k: outs[k][j] for k in keys} for j in range(3))


def sophia_fused_step(params, m, h, grads, h_hat, do_h, *, lr, beta1,
                      beta2, rho, eps, weight_decay):
    """Fused m-EMA + gated h-EMA + decay + clip + update over parameter
    dicts of one set of keys and shapes (one kernel launch on the card
    for up to `MAX_LEAVES` leaves).  ``do_h`` and ``lr`` are host
    scalars.  Returns ``(new_params, new_m, new_h)``, every leaf in the
    params leaf's dtype."""
    trees = (params, m, h, grads, h_hat)
    hp = dict(beta1=beta1, beta2=beta2, rho=rho, eps=eps,
              weight_decay=weight_decay)
    kind = _validate(trees)
    if cost.shape_only(next(iter(params.values()))):
        return _shape_only(trees)
    if kind == "cuda":
        return _launch(trees, do_h, lr, hp)
    spec = flat_spec(params, cols=BLOCK_C)
    outs = sophia_update_ref(*(pack(t, spec) for t in trees), float(do_h),
                             lr=float(lr), **hp)
    return tuple(unpack(o, spec) for o in outs)
