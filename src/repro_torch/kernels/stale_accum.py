"""The staleness-weighted accumulate of the virtual-time scheduler: a
wrapper around the CUDA kernel ``csrc/stale_accum.cu`` (the port of the
JAX package's Pallas ``kernels/stale_accum.py``).

For CUDA tensors `stale_accum_flat` validates its inputs and launches
the kernel on PyTorch's current stream, or raises: its fp32 form where
`takes_f32x4` allows, else its one-coordinate form.  For CPU tensors it
runs the plain version `ref.stale_accum_ref`; that is the only case in
which the plain version runs.  A tensor without storage takes the
shape-only path (`cost`).  ``LAUNCHES`` counts kernel launches (CPU
calls count nothing).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.ref import stale_accum_ref

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {"stale_accum_flat": 0}

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)

#: threads a block (32 to 256), a thread per output item.  From the
#: card's times in `chip_smoke.py: sweep_stale_grid` (H100, 700 W): 64 the
#: fastest at K=16 (by 1-4% over 128 and 256) and at K=1 (by 3-4%)
THREADS = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel_fn():
    lib = build.load("stale_accum")
    fn = lib.stale_accum_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_F, _I, _I, _I64, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def takes_f32x4(out, wires) -> bool:
    """Whether a launch takes the kernel's fp32 form: fp32 wires, both
    16-byte aligned, and a multiple of 4 coordinates a wire."""
    return (wires.dtype == torch.float32 and out.numel() % 4 == 0
            and wires.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)


def vector_of(values, device, name: str, label: str,
              length: int) -> torch.Tensor:
    """``values`` (a tensor, or a host sequence of floats copied to
    ``device``) as a contiguous fp32 ``(length,)`` tensor on ``device``;
    raises on anything else."""
    if not isinstance(values, torch.Tensor):
        values = torch.tensor([float(v) for v in values],
                              dtype=torch.float32, device=device)
    if values.dtype != torch.float32:
        raise TypeError(f"{name}: {label} has dtype {values.dtype}, want "
                        "torch.float32")
    if tuple(values.shape) != (length,):
        raise ValueError(f"{name}: {label} has shape "
                         f"{tuple(values.shape)}, want ({length},)")
    if values.device != device:
        raise ValueError(f"{name}: {label} on {values.device}, wires on "
                         f"{device}")
    if not values.is_contiguous():
        raise ValueError(f"{name}: {label} is not contiguous")
    return values


def check_wires(name: str, wires: torch.Tensor) -> None:
    if not isinstance(wires, torch.Tensor) or wires.ndim != 3:
        raise ValueError(f"{name}: wires must be a (K, R, C) tensor")
    if wires.shape[0] < 1:
        raise ValueError(f"{name}: wires hold no arrival (K=0)")
    if wires.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: wires have unsupported dtype "
                        f"{wires.dtype} (want one of {tuple(DTYPE_CODES)})")
    if not wires.is_contiguous():
        raise ValueError(f"{name}: wires are not contiguous; materialise "
                         "them first (.contiguous())")
    if wires.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {wires.device}")


def stale_accum_flat(wires, weights, inv_norm):
    """``inv_norm * sum_k weights[k] * wires[k]``, summed in ascending
    k, as one ``(R, C)`` fp32 tensor.

    wires: ``(K, R, C)`` in fp32, bf16, e4m3 or e5m2 (upcast to fp32 in
    the kernel); weights: ``(K,)`` fp32 on the wires' device, or a host
    sequence of floats; inv_norm: a Python float, or a one-element fp32
    tensor on the wires' device (read by the kernel, never by the
    host)."""
    name = "stale_accum_flat"
    check_wires(name, wires)
    K = wires.shape[0]
    w = vector_of(weights, wires.device, name, "weights", K)
    s_ptr = None
    if isinstance(inv_norm, torch.Tensor):
        if inv_norm.numel() != 1 or inv_norm.dtype != torch.float32:
            raise ValueError(f"{name}: inv_norm must be one fp32 element, "
                             f"got {inv_norm.dtype}{tuple(inv_norm.shape)}")
        if inv_norm.device != wires.device:
            raise ValueError(f"{name}: inv_norm on {inv_norm.device}, "
                             f"wires on {wires.device}")
        s_ptr = inv_norm
    if cost.shape_only(wires):
        out = torch.empty(wires.shape[1:], dtype=torch.float32,
                          device=wires.device)
        return cost.shape_only_launch(name, (wires, w), (out,),
                                      cost.stale_ops(K) * out.numel())[0]
    if wires.device.type == "cpu":
        return stale_accum_ref(wires, w, inv_norm)
    out = torch.empty(wires.shape[1:], dtype=torch.float32,
                      device=wires.device)
    err = _kernel_fn()(
        out.data_ptr(), wires.data_ptr(), w.data_ptr(),
        None if s_ptr is None else s_ptr.data_ptr(),
        0.0 if s_ptr is not None else float(inv_norm),
        DTYPE_CODES[wires.dtype], K, out.numel(),
        int(takes_f32x4(out, wires)), THREADS,
        torch.cuda.current_stream(wires.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return out
