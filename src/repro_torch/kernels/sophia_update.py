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
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.ref import sophia_update_ref

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {"sophia_update_flat": 0,
                            "sophia_update_batched": 0}
#: of those, the launches that took the fp32 form
F32X4_LAUNCHES: Dict[str, int] = dict(LAUNCHES)


def reset_launches() -> None:
    for counts in (LAUNCHES, F32X4_LAUNCHES):
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
