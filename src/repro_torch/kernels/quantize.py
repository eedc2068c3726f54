"""The compressors' round-trips: wrappers around the CUDA kernels of
``csrc/quantize.cu`` (the port of the JAX package's Pallas
``kernels/quantize.py``: ``_quant_kernel``, ``_uplink_kernel``,
``_broadcast_kernel``, ``_sign_kernel``, ``_thresh_kernel`` and their
batched forms).

The stochastic quantizers take one scale per packed row; noise ``u`` ~
U[0, 1) and the scales are fp32 and computed by the caller (as the JAX
package computes them outside its kernels).  The biased compressors'
entries (sign, top-k threshold) take one fp32 scalar per client, also
computed by the caller.  State operands may be fp32, bf16, e4m3 or e5m2;
compute is fp32.  Each ``*_batched`` entry takes ``(N, R, C)`` stacks
with ``(N, R, 1)`` row scales or ``(N,)`` client scalars, and is bitwise
the looped ``*_flat`` entry.

For CUDA tensors each entry point validates its inputs and launches its
kernel on PyTorch's current stream, or raises.  For CPU tensors it runs
the plain version from `ref`; that is the only case in which the plain
version runs.  ``LAUNCHES`` counts kernel launches per entry point (CPU
calls count nothing).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.ref import (broadcast_roundtrip_ref,
                                     quant_roundtrip_ref,
                                     sign_roundtrip_ref,
                                     topk_threshold_ref,
                                     uplink_roundtrip_ref)

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {
    "quant_roundtrip_flat": 0, "quant_roundtrip_batched": 0,
    "uplink_roundtrip_flat": 0, "uplink_roundtrip_batched": 0,
    "broadcast_roundtrip_flat": 0, "broadcast_roundtrip_batched": 0,
    "sign_roundtrip_flat": 0, "sign_roundtrip_batched": 0,
    "topk_threshold_flat": 0, "topk_threshold_batched": 0}

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
#: argtypes of each C launcher (csrc/quantize.cu)
_ARGTYPES = {
    "quant_roundtrip_launch": [_P] * 4 + [_I, _I64, _I, _F, _I, _P],
    "uplink_roundtrip_launch": [_P] * 7 + [_I] * 3
                               + [_I64, _I, _I64, _F, _I, _P],
    "broadcast_roundtrip_launch": [_P] * 7 + [_I] * 3
                                  + [_I64, _I, _I64, _F, _I, _P],
    "sign_roundtrip_launch": [_P] * 3 + [_I, _I64, _I64, _I, _P],
    "topk_threshold_launch": [_P] * 3 + [_I, _I64, _I64, _I, _P],
}
#: elements per work item of the per-client kernels (one block's threads)
CHUNK = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel_fn(launcher: str):
    lib = build.load("quantize")
    fn = getattr(lib, launcher)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[launcher]
        fn.restype = ctypes.c_int
    return fn


def _validate(name: str, ndim: int, state: Sequence[Tuple[str, torch.Tensor]],
              noise: torch.Tensor, scale: torch.Tensor,
              shared: Tuple[str, torch.Tensor] = None) -> str:
    """Checks of one call: every ``state`` operand ``ndim``-D of one
    shape, in a kernel dtype; ``noise`` fp32 of that shape; ``scale``
    fp32 ``(*lead, R, 1)``; the optional ``shared`` operand of that shape
    or its last two axes; all contiguous, on one device.  Returns the
    device type."""
    shape = state[0][1].shape
    if state[0][1].ndim != ndim:
        raise ValueError(f"{name}: {state[0][0]} must be {ndim}D, got "
                         f"shape {tuple(shape)}")
    operands = list(state) + [("noise", noise), ("scale", scale)]
    if shared is not None:
        operands.append(shared)
        if shared[1].shape not in (shape, shape[-2:]):
            raise ValueError(f"{name}: {shared[0]} has shape "
                             f"{tuple(shared[1].shape)}, want "
                             f"{tuple(shape)} or {tuple(shape[-2:])}")
    for label, t in state:
        if t.shape != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"{state[0][0]} {tuple(shape)}")
    if noise.shape != shape:
        raise ValueError(f"{name}: noise has shape {tuple(noise.shape)}, "
                         f"want {tuple(shape)}")
    if scale.shape != shape[:-1] + (1,):
        raise ValueError(f"{name}: scale has shape {tuple(scale.shape)}, "
                         f"want {tuple(shape[:-1]) + (1,)}")
    for label, t in operands:
        want = (torch.float32,) if label in ("noise", "scale") \
            else tuple(DTYPE_CODES)
        if t.dtype not in want:
            raise TypeError(f"{name}: {label} has unsupported dtype "
                            f"{t.dtype} (want one of {want})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous; "
                             "materialise it first (.contiguous())")
    devices = {t.device for _, t in operands}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = next(iter(devices))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _geometry(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """``(rows, cols, blocks, stream)`` of a launch over ``x``."""
    cols = x.shape[-1]
    rows = x.numel() // cols if cols else 0
    return (rows, cols, build.grid_blocks(rows, x.device),
            torch.cuda.current_stream(x.device).cuda_stream)


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def _quant(name, ndim, x, noise, scale, qmax):
    kind = _validate(name, ndim, [("x", x)], noise, scale)
    if kind == "cpu":
        return quant_roundtrip_ref(x, noise, scale, qmax=qmax)
    out = torch.empty_like(x)
    rows, cols, blocks, stream = _geometry(x)
    _check(name, _kernel_fn("quant_roundtrip_launch")(
        out.data_ptr(), x.data_ptr(), noise.data_ptr(), scale.data_ptr(),
        DTYPE_CODES[x.dtype], rows, cols, float(qmax), blocks, stream))
    return out


def _fused(name, launcher, ref_fn, ndim, theta, other, ef, noise, scale,
           qmax, shared_label):
    """The uplink / broadcast round-trips: ``other`` is uplink's start or
    broadcast's ref; the operand named ``shared_label`` (start, or
    broadcast's theta) may be one ``(R, C)`` buffer shared by the stack.
    """
    if shared_label == "start":
        lead, lead_label, shared = theta, "theta", other
    else:
        lead, lead_label, shared = other, "ref", theta
    kind = _validate(name, ndim, [(lead_label, lead), ("ef", ef)], noise,
                     scale, shared=(shared_label, shared))
    if kind == "cpu":
        return ref_fn(theta, other, ef, noise, scale, qmax=qmax)
    outs = (torch.empty(lead.shape, dtype=theta.dtype, device=lead.device),
            torch.empty(lead.shape, dtype=theta.dtype, device=lead.device))
    rows, cols, blocks, stream = _geometry(lead)
    shared_rows = shared.numel() // cols
    _check(name, _kernel_fn(launcher)(
        outs[0].data_ptr(), outs[1].data_ptr(), theta.data_ptr(),
        other.data_ptr(), ef.data_ptr(), noise.data_ptr(), scale.data_ptr(),
        DTYPE_CODES[theta.dtype], DTYPE_CODES[other.dtype],
        DTYPE_CODES[ef.dtype], rows, cols, shared_rows, float(qmax), blocks,
        stream))
    return outs


def quant_roundtrip_flat(x, noise, scale, *, qmax: int):
    """Stochastic quantize -> dequantize of one ``(R, C)`` buffer.
    noise: U[0,1) fp32 of x's shape; scale: ``(R, 1)`` fp32 row scales.
    Returns the reconstruction in x's dtype."""
    return _quant("quant_roundtrip_flat", 2, x, noise, scale, qmax)


def quant_roundtrip_batched(x, noise, scale, *, qmax: int):
    """`quant_roundtrip_flat` over an ``(N, R, C)`` stack in one launch;
    scale: ``(N, R, 1)``."""
    return _quant("quant_roundtrip_batched", 3, x, noise, scale, qmax)


def uplink_roundtrip_flat(theta, start, ef, noise, scale, *, qmax: int):
    """Fused uplink encode over ``(R, C)`` buffers: ``d = (theta -
    start) + ef`` is quantized with the ``(R, 1)`` scales of d.  Returns
    ``(xhat, d - xhat)``, both in theta's dtype."""
    return _fused("uplink_roundtrip_flat", "uplink_roundtrip_launch",
                  uplink_roundtrip_ref, 2, theta, start, ef, noise, scale,
                  qmax, "start")


def uplink_roundtrip_batched(theta, start, ef, noise, scale, *, qmax: int):
    """`uplink_roundtrip_flat` over ``(N, R, C)`` stacks in one launch.
    ``start`` may stay ``(R, C)``: every client trained from one model;
    scale: ``(N, R, 1)``."""
    return _fused("uplink_roundtrip_batched", "uplink_roundtrip_launch",
                  uplink_roundtrip_ref, 3, theta, start, ef, noise, scale,
                  qmax, "start")


def broadcast_roundtrip_flat(theta, ref, ef, noise, scale, *, qmax: int):
    """Fused downlink step over ``(R, C)`` buffers: ``d = (theta - ref)
    + ef`` is quantized with the ``(R, 1)`` scales of d.  Returns ``(ref
    + xhat, d - xhat)`` (the client's new replica and the new residual),
    both in theta's dtype."""
    return _fused("broadcast_roundtrip_flat", "broadcast_roundtrip_launch",
                  broadcast_roundtrip_ref, 2, theta, ref, ef, noise, scale,
                  qmax, "theta")


def broadcast_roundtrip_batched(theta, ref, ef, noise, scale, *,
                                qmax: int):
    """`broadcast_roundtrip_flat` over ``(N, R, C)`` replica / residual
    stacks in one launch.  ``theta`` may stay the one ``(R, C)`` server
    model; scale: ``(N, R, 1)``."""
    return _fused("broadcast_roundtrip_batched",
                  "broadcast_roundtrip_launch", broadcast_roundtrip_ref, 3,
                  theta, ref, ef, noise, scale, qmax, "theta")


def _per_client(name, launcher, ref_fn, ndim, x, v, label):
    """The biased compressors' entries: ``x`` ``ndim``-D in a kernel
    dtype, ``v`` its fp32 per-client scalar tensor (``()`` for a flat
    ``x``, ``(N,)`` for a stack), both contiguous, on one device."""
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{name}: {label} must be a tensor, got "
                        f"{type(v).__name__}")
    if x.ndim != ndim:
        raise ValueError(f"{name}: x must be {ndim}D, got shape "
                         f"{tuple(x.shape)}")
    want = tuple(x.shape[:1]) if ndim == 3 else ()
    if tuple(v.shape) != want:
        raise ValueError(f"{name}: {label} has shape {tuple(v.shape)}, "
                         f"want {want}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: x has unsupported dtype {x.dtype} (want "
                        f"one of {tuple(DTYPE_CODES)})")
    if v.dtype != torch.float32:
        raise TypeError(f"{name}: {label} has dtype {v.dtype}, want "
                        "torch.float32")
    for lab, t in (("x", x), (label, v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {lab} is not contiguous; "
                             "materialise it first (.contiguous())")
    if x.device != v.device:
        raise ValueError(f"{name}: inputs on several devices, {x.device} "
                         f"and {v.device}")
    if x.device.type == "cpu":
        return ref_fn(x, v)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = torch.empty_like(x)
    clients = x.shape[0] if ndim == 3 else 1
    per_client = x.numel() // clients if clients else 0
    chunks = clients * -(-per_client // CHUNK)
    _check(name, _kernel_fn(launcher)(
        out.data_ptr(), x.data_ptr(), v.data_ptr(), DTYPE_CODES[x.dtype],
        clients, per_client, build.grid_blocks(chunks, x.device),
        torch.cuda.current_stream(x.device).cuda_stream))
    return out


def sign_roundtrip_flat(x, scale):
    """SignSGD's round-trip of one ``(R, C)`` buffer: ``scale * sign(x)``
    (``jnp.sign``: NaN and +-0 pass through) in x's dtype; ``scale``: the
    0-dim fp32 scale."""
    return _per_client("sign_roundtrip_flat", "sign_roundtrip_launch",
                       sign_roundtrip_ref, 2, x, scale, "scale")


def sign_roundtrip_batched(x, scale):
    """`sign_roundtrip_flat` over an ``(N, R, C)`` stack in one launch;
    scale: ``(N,)``."""
    return _per_client("sign_roundtrip_batched", "sign_roundtrip_launch",
                       sign_roundtrip_ref, 3, x, scale, "scale")


def topk_threshold_flat(x, thr):
    """Top-k's magnitude sparsifier of one ``(R, C)`` buffer: x where
    ``|x| >= thr`` (thr: the 0-dim fp32 k-th largest magnitude), 0
    elsewhere, in x's dtype."""
    return _per_client("topk_threshold_flat", "topk_threshold_launch",
                       topk_threshold_ref, 2, x, thr, "thr")


def topk_threshold_batched(x, thr):
    """`topk_threshold_flat` over an ``(N, R, C)`` stack in one launch;
    thr: ``(N,)``."""
    return _per_client("topk_threshold_batched", "topk_threshold_launch",
                       topk_threshold_ref, 3, x, thr, "thr")
