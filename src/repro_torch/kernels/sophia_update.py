"""The fused Sophia update: wrappers around the CUDA kernel
``csrc/sophia_update.cu`` (the port of the JAX package's Pallas
``kernels/sophia_update.py``).

For CUDA tensors each entry point validates its inputs and launches the
kernel on PyTorch's current stream, or raises: its fp32 form when all
five operands are fp32 and all eight pointers 16-byte aligned
(`takes_f32x4`), else its runtime-dtype form.  For CPU tensors it runs
the plain version `ref.sophia_update_ref`; that is the only case in
which the plain version runs.  A tensor without storage takes the
shape-only path (`cost`).  ``LAUNCHES`` counts kernel launches per
entry point, ``F32X4_LAUNCHES`` those of them that took the fp32 form
(CPU calls count nothing).

`sophia_update_leaves` is the round engine's step at the loss/grad
boundary (the leaf route, `takes_leaves`): the kernel's leaf-boundary
form reads the grads and h_hat as the leaves autograd and the GNB
estimate return, updates the fp32 resident theta, m and h in place, and
stores the new theta into the leaves the next forward reads.  Its
``F32X4_LAUNCHES`` count the launches whose every leaf took the vector
accesses; ``STEPS`` counts its steps on the card (a step of more than
`BOUNDARY_MAX_LEAVES` leaves takes several launches), which
`repro_torch.obs.counters.sophia_leaf_route_share` reads.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.ref import (sophia_update_leaves_ref,
                                     sophia_update_ref)

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {"sophia_update_flat": 0,
                            "sophia_update_batched": 0,
                            "sophia_update_leaves": 0}
#: of those, the launches that took the fp32 form (the leaf-boundary
#: form: whose every leaf took the vector accesses)
F32X4_LAUNCHES: Dict[str, int] = dict(LAUNCHES)
#: steps of the leaf-boundary form on the card (one or more launches each)
STEPS: Dict[str, int] = {"sophia_update_leaves": 0}

#: leaves per launch of the leaf-boundary form: the kernel's
#: ``kBoundaryLeaves`` (its table rides in the 32 KB of kernel parameters;
#: the zoo's models have at most 113 leaves, so a step is one launch)
BOUNDARY_MAX_LEAVES = 128
#: coordinates a block of the leaf-boundary form owns, and the tile body's
#: (rows, columns): the kernel's ``kBlockCoords``, ``kTileR``, ``kTileK``
BOUNDARY_BLOCK = 2048
BOUNDARY_TILE = (64, 32)


def reset_launches() -> None:
    for counts in (LAUNCHES, F32X4_LAUNCHES, STEPS):
        for k in counts:
            counts[k] = 0


#: blocks per SM at most in the fp32 form's grid (fewer when every float4
#: group of the launch has its own thread); chosen from the card's times in
#: `chip_smoke.py: sweep_sophia_grid`
F32X4_BLOCKS_PER_SM = 32


def _lib():
    lib = build.load("sophia_update")
    if lib.sophia_update_launch.argtypes is None:
        lib.sophia_update_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_int64]
            + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p])
        lib.sophia_update_launch.restype = ctypes.c_int
        lib.sophia_update_f32x4_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int64] + [ctypes.c_float] * 9
            + [ctypes.c_int, ctypes.c_void_p])
        lib.sophia_update_f32x4_launch.restype = ctypes.c_int
        lib.sophia_update_threads.restype = ctypes.c_int
        lib.sophia_boundary_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
            + [ctypes.c_void_p] * 5 + [ctypes.c_int]
            + [ctypes.c_float] * 9 + [ctypes.c_void_p])
        lib.sophia_boundary_launch.restype = ctypes.c_int
        for fn in ("sophia_boundary_block_coords",
                   "sophia_boundary_tile_rows", "sophia_boundary_tile_cols"):
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def f32x4_blocks(n: int, device: torch.device) -> int:
    """The fp32 form's grid over ``n`` coordinates: a thread per float4
    group, but at most `F32X4_BLOCKS_PER_SM` blocks per SM (then each
    thread walks several groups)."""
    threads = int(_lib().sophia_update_threads())
    return max(1, min(-(-(n // 4) // threads),
                      build.sm_count(device.index) * F32X4_BLOCKS_PER_SM))


def takes_f32x4(*tensors) -> bool:
    """Whether a launch on ``tensors`` (the outputs and the five inputs)
    takes the kernel's fp32 form: every one fp32 and 16-byte aligned."""
    return all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0
               for t in tensors)


def _validate(name: str, ndim: int, tensors) -> str:
    """Shapes, dtypes, contiguity and devices of ``(theta, m, h, g,
    h_hat)``; returns the device type all five share."""
    shape = tensors[0].shape
    if tensors[0].ndim != ndim:
        raise ValueError(f"{name}: theta must be {ndim}D, got shape "
                         f"{tuple(shape)}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    for label, t in zip(("theta", "m", "h", "g", "h_hat"), tensors):
        if t.shape != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"theta {tuple(shape)}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: {label} has unsupported dtype "
                            f"{t.dtype} (want one of "
                            f"{tuple(DTYPE_CODES)})")
        if not t.is_contiguous():
            # an expanded (stride-0) or sliced view cannot be walked as
            # N*R*C contiguous elements, nor written in place
            raise ValueError(f"{name}: {label} is not contiguous; "
                             "materialise it first (.contiguous())")
    dev = next(iter(devices))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _launch(name, theta, m, h, g, h_hat, do_h, lr, hp, inplace):
    if inplace:
        outs: Tuple[torch.Tensor, ...] = (theta, m, h)
    else:
        outs = tuple(torch.empty_like(x) for x in (theta, m, h))
    lib = _lib()
    ins = (theta, m, h, g, h_hat)
    n = theta.numel()
    scalars = (float(do_h), float(lr), hp["beta1"], 1.0 - hp["beta1"],
               hp["beta2"], 1.0 - hp["beta2"], hp["rho"], hp["eps"],
               hp["weight_decay"])
    ptrs = [t.data_ptr() for t in outs + ins]
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    f32x4 = takes_f32x4(*outs, *ins)
    if f32x4:
        err = lib.sophia_update_f32x4_launch(
            *ptrs, n, *scalars, f32x4_blocks(n, theta.device), stream)
    else:
        threads = int(lib.sophia_update_threads())
        blocks = build.grid_blocks(-(-n // threads), theta.device)
        err = lib.sophia_update_launch(
            *ptrs, *(DTYPE_CODES[t.dtype] for t in ins), n, *scalars,
            blocks, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    F32X4_LAUNCHES[name] += f32x4
    return outs


def _update(name, ndim, theta, m, h, g, h_hat, do_h, lr, hp, inplace):
    kind = _validate(name, ndim, (theta, m, h, g, h_hat))
    if cost.shape_only(theta):
        outs = ((theta, m, h) if inplace else
                tuple(torch.empty_like(x) for x in (theta, m, h)))
        return cost.shape_only_launch(name, (theta, m, h, g, h_hat),
                                      outs, cost.SOPHIA_OPS * theta.numel())
    if kind == "cuda":
        return _launch(name, theta, m, h, g, h_hat, do_h, lr, hp, inplace)
    outs = sophia_update_ref(theta, m, h, g, h_hat, float(do_h),
                             lr=float(lr), **hp)
    if inplace:
        for dst, src in zip((theta, m, h), outs):
            dst.copy_(src)
        return theta, m, h
    return outs


def sophia_update_flat(theta, m, h, g, h_hat, do_h, lr, *, beta1, beta2,
                       rho, eps, weight_decay, inplace: bool = False):
    """Fused update over one ``(R, C)`` buffer.  Returns ``(theta, m,
    h)``, each in its input's dtype (fp32, bf16, e4m3 or e5m2; compute
    is fp32).  ``do_h`` (0/1) and ``lr`` are host scalars, passed to the
    kernel by value.  ``inplace=True`` writes the results into
    ``theta``, ``m`` and ``h`` themselves."""
    hp = dict(beta1=beta1, beta2=beta2, rho=rho, eps=eps,
              weight_decay=weight_decay)
    return _update("sophia_update_flat", 2, theta, m, h, g, h_hat, do_h,
                   lr, hp, inplace)


def sophia_update_batched(theta, m, h, g, h_hat, do_h, lr, *, beta1,
                          beta2, rho, eps, weight_decay,
                          inplace: bool = False):
    """`sophia_update_flat` over ``(N, R, C)`` client stacks in one
    launch; ``do_h`` and ``lr`` are shared by every client."""
    hp = dict(beta1=beta1, beta2=beta2, rho=rho, eps=eps,
              weight_decay=weight_decay)
    return _update("sophia_update_batched", 3, theta, m, h, g, h_hat, do_h,
                   lr, hp, inplace)


def takes_leaves(theta, m, h) -> bool:
    """Whether the engine's Sophia step over the resident ``theta``,
    ``m`` and ``h`` takes the leaf route (`sophia_update_leaves`): all
    three fp32, ``(rows, cols)`` or ``(N, rows, cols)``.  Narrow m or h
    (a ``state_dtype`` below fp32) keep the packed route."""
    return theta.ndim in (2, 3) and all(t.dtype == torch.float32
                                        for t in (theta, m, h))


def swapped(x: torch.Tensor, lead: int) -> bool:
    """Whether leaf ``x`` (``lead`` leading client axes) holds its own
    last two axes swapped: the transpose of a contiguous tensor, as a
    tied embedding's grad comes back from its head's GEMM."""
    return (x.ndim - lead >= 2 and not x.is_contiguous()
            and x.transpose(-1, -2).is_contiguous())


def _readable(tree, lead: int):
    """``tree`` (a dict of grads or h_hat leaves with ``lead`` leading
    client axes, or one buffer) as the kernel reads it: a leaf that is
    neither contiguous nor `swapped` is copied contiguous."""
    if torch.is_tensor(tree):
        return tree
    return {k: v if v.is_contiguous() or swapped(v, lead)
            else v.contiguous() for k, v in tree.items()}


def _validate_leaves(theta, m, h, grads, h_hat, out, spec) -> str:
    """Shapes, dtypes, layouts and devices of a leaf-boundary step;
    returns the device type every operand shares."""
    name = "sophia_update_leaves"
    if not takes_leaves(theta, m, h):
        raise ValueError(f"{name}: theta, m and h must be fp32 (rows, cols) "
                         "or (N, rows, cols) buffers")
    shape = theta.shape
    if tuple(shape[-2:]) != (spec.rows, spec.cols):
        raise ValueError(f"{name}: theta has shape {tuple(shape)}, the "
                         f"layout ({spec.rows}, {spec.cols})")
    for label, t in (("m", m), ("h", h)):
        if t.shape != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"theta {tuple(shape)}")
    for label, t in (("theta", theta), ("m", m), ("h", h)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
    lead = tuple(shape[:-2])
    tensors = [theta, m, h]
    trees = [("grads", grads, True)]
    if torch.is_tensor(h_hat):
        if h_hat.shape != shape or not h_hat.is_contiguous():
            raise ValueError(f"{name}: an h_hat buffer must be contiguous "
                             f"of theta's shape {tuple(shape)}")
        tensors.append(h_hat)
    else:
        trees.append(("h_hat", h_hat, True))
    trees.append(("out", out or {}, False))
    want = dict(zip(spec.keys, spec.shapes))
    for label, tree, whole in trees:
        if not isinstance(tree, dict) or (sorted(tree) != sorted(want)
                                          if whole else
                                          not set(tree) <= set(want)):
            raise ValueError(f"{name}: {label} must be a dict over the "
                             f"layout's keys")
        for k, t in tree.items():
            if tuple(t.shape) != lead + tuple(want[k]):
                raise ValueError(f"{name}: {label}[{k!r}] has shape "
                                 f"{tuple(t.shape)}, want "
                                 f"{lead + tuple(want[k])}")
            tensors.append(t)
    for t in tensors:
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: unsupported dtype {t.dtype} (want one "
                            f"of {tuple(DTYPE_CODES)})")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    dev = next(iter(devices))
    if dev.type == "cuda":
        for k, t in trees[-1][1].items():
            if not t.is_contiguous():
                raise ValueError(f"{name}: out[{k!r}] is not contiguous")
    elif dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _boundary_rows(theta, m, h, grads, h_hat, out, spec):
    """One table row a leaf of coordinates: ``(dims, ptrs, cs, flags,
    blocks)`` as `csrc/sophia_update.cu: sophia_boundary_launch` reads
    them."""
    block, tile = BOUNDARY_BLOCK, BOUNDARY_TILE
    lead = theta.ndim - 2
    state_vec = (spec.padded % 4 == 0
                 and all(t.data_ptr() % 16 == 0 for t in (theta, m, h)))
    rows = []
    off = 0
    for k, sz, shp in zip(spec.keys, spec.sizes, spec.shapes):
        if sz == 0:
            continue
        ptrs, cs, codes, sw = [], [], [], []
        vec = state_vec and off % 4 == 0
        for src in (grads, h_hat):
            if torch.is_tensor(src):          # one resident-shaped buffer
                x, stride, s = src, spec.padded, False
                ptr = src.data_ptr() + off * src.element_size()
            else:
                x = src[k]
                ptr, stride, s = x.data_ptr(), sz, swapped(x, lead)
            ptrs.append(ptr)
            cs.append(stride)
            codes.append(DTYPE_CODES[x.dtype])
            sw.append(s)
            # four elements a load: along the leaf, or down a swapped
            # operand's rows
            vec = vec and (codes[-1] <= 1 and stride % 4 == 0
                           and ptr % (4 * x.element_size()) == 0
                           and (not s or shp[-2] % 4 == 0))
        o = (out or {}).get(k)
        ptrs.append(0 if o is None else o.data_ptr())
        codes.append(0 if o is None else DTYPE_CODES[o.dtype])
        if o is not None:
            vec = vec and (codes[-1] <= 1 and sz % 4 == 0
                           and o.data_ptr() % (4 * o.element_size()) == 0)
        tiled = any(sw)
        r, c = (shp[-2], shp[-1]) if tiled else (1, sz)
        mats = sz // (r * c)
        if tiled:
            vec = vec and c % 4 == 0
            blocks = mats * -(-r // tile[0]) * -(-c // tile[1])
        else:
            blocks = -(-sz // block)
        rows.append(((off, sz, mats, r, c), ptrs, cs,
                     codes + [int(x) for x in sw] + [int(vec), int(tiled)],
                     blocks))
        off += sz
    return rows


def _boundary_launch(theta, m, h, grads, h_hat, out, do_h, lr, hp, spec):
    name = "sophia_update_leaves"
    lib = _lib()
    built = (int(lib.sophia_boundary_block_coords()),
             (int(lib.sophia_boundary_tile_rows()),
              int(lib.sophia_boundary_tile_cols())))
    if built != (BOUNDARY_BLOCK, BOUNDARY_TILE):
        raise RuntimeError(f"{name}: the kernel's block and tile {built} "
                           "are not the wrapper's")
    lead = theta.ndim - 2
    rows = _boundary_rows(theta, m, h, _readable(grads, lead),
                          _readable(h_hat, lead), out, spec)
    clients = math.prod(theta.shape[:-2])
    scalars = (float(do_h), float(lr), hp["beta1"], 1.0 - hp["beta1"],
               hp["beta2"], 1.0 - hp["beta2"], hp["rho"], hp["eps"],
               hp["weight_decay"])
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    for s in range(0, len(rows), BOUNDARY_MAX_LEAVES):
        part = rows[s:s + BOUNDARY_MAX_LEAVES]
        n = len(part)
        first = [0]
        for row in part:
            first.append(first[-1] + row[4])
        if first[-1] >= 2 ** 31:
            raise ValueError(f"{name}: {first[-1]} blocks a client exceed "
                             "the grid's width")
        err = lib.sophia_boundary_launch(
            theta.data_ptr(), m.data_ptr(), h.data_ptr(), spec.padded,
            clients,
            (ctypes.c_int64 * (5 * n))(*(x for r in part for x in r[0])),
            (ctypes.c_void_p * (3 * n))(*(x or None for r in part
                                          for x in r[1])),
            (ctypes.c_int64 * (2 * n))(*(x for r in part for x in r[2])),
            (ctypes.c_int * (7 * n))(*(x for r in part for x in r[3])),
            (ctypes.c_int * (n + 1))(*first), n,
            *scalars, stream)
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {err}")
        LAUNCHES[name] += 1
        F32X4_LAUNCHES[name] += all(r[3][5] for r in part)
    STEPS[name] += 1


def _boundary_shape_only(theta, m, h, grads, h_hat, out, spec):
    """The shape-only launches (`cost`) of a leaf-boundary step: one per
    `BOUNDARY_MAX_LEAVES` leaves of coordinates, each recorded with the
    bytes of its leaves' runs of every operand."""
    lead = tuple(theta.shape[:-2])
    flat = [t.reshape(lead + (spec.padded,)) for t in (theta, m, h)]
    hh = (h_hat.reshape(lead + (spec.padded,)) if torch.is_tensor(h_hat)
          else None)
    runs, off = [], 0
    for k, sz in zip(spec.keys, spec.sizes):
        if sz:
            runs.append((k, off, sz))
        off += sz
    for s in range(0, len(runs), BOUNDARY_MAX_LEAVES):
        ins, outs, coords = [], [], 0
        for k, off, sz in runs[s:s + BOUNDARY_MAX_LEAVES]:
            state = [t[..., off:off + sz] for t in flat]
            ins += state + [grads[k], h_hat[k] if hh is None
                            else hh[..., off:off + sz]]
            outs += state + ([out[k]] if out and k in out else [])
            coords += sz
        cost.shape_only_launch("sophia_update_leaves", ins, outs,
                               cost.SOPHIA_OPS * math.prod(lead) * coords)


def sophia_update_leaves(theta, m, h, grads, h_hat, do_h, lr, *, spec,
                         out=None, beta1, beta2, rho, eps, weight_decay):
    """The Sophia step at the loss/grad boundary, in place: ``theta``,
    ``m``, ``h`` are the fp32 ``(rows, cols)`` or ``(N, rows, cols)``
    resident buffers of layout ``spec`` (`repro_torch.comm.flat`);
    ``grads`` a dict over ``spec``'s keys of ``(*lead, *shape)`` leaves
    in any kernel dtype and layout (on the card read where they lie when
    contiguous or `swapped`, else copied contiguous first); ``h_hat``
    such a dict, or one buffer of theta's shape; ``out`` a
    dict over some of the keys of contiguous ``(*lead, *shape)`` leaves
    into which the new theta is stored in each leaf's dtype, or None.
    ``do_h`` and ``lr`` are host scalars.  Returns ``(theta, m, h,
    out)``.  The values are those of the grads (and h_hat) packed to
    fp32, `sophia_update_flat` / `sophia_update_batched`, and the
    ``out`` leaves unpacked from the new theta (`ref.
    sophia_update_leaves_ref`, the CPU route)."""
    hp = dict(beta1=beta1, beta2=beta2, rho=rho, eps=eps,
              weight_decay=weight_decay)
    kind = _validate_leaves(theta, m, h, grads, h_hat, out, spec)
    if cost.shape_only(theta):
        _boundary_shape_only(theta, m, h, grads, h_hat, out, spec)
    elif kind == "cuda":
        _boundary_launch(theta, m, h, grads, h_hat, out, do_h, lr, hp, spec)
    else:
        res = sophia_update_leaves_ref(
            theta, m, h, grads, h_hat, float(do_h), spec=spec,
            out_dtypes={k: v.dtype for k, v in (out or {}).items()},
            lr=float(lr), **hp)
        for dst, src in zip((theta, m, h), res[:3]):
            dst.copy_(src)
        for k, v in res[3].items():
            out[k].copy_(v)
    return theta, m, h, out
