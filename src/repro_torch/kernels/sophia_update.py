"""The fused Sophia update: wrappers around the CUDA kernel
``csrc/sophia_update.cu`` (the port of the JAX package's Pallas
``kernels/sophia_update.py``).

For CUDA tensors each entry point validates its inputs and launches the
kernel on PyTorch's current stream, or raises.  For CPU tensors it runs
the plain version `ref.sophia_update_ref`; that is the only case in
which the plain version runs.  ``LAUNCHES`` counts kernel launches per
entry point (CPU calls count nothing).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sophia_update_ref

#: runtime dtype codes of the kernel's load/store helpers
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1,
               torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {"sophia_update_flat": 0,
                            "sophia_update_batched": 0}

#: blocks per SM of the grid-stride launch
BLOCKS_PER_SM = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device()
    ).multi_processor_count


def _kernel_fn():
    lib = build.load("sophia_update")
    fn = lib.sophia_update_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_int64] + [ctypes.c_float] * 9
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.sophia_update_threads.restype = ctypes.c_int
    return fn, int(lib.sophia_update_threads())


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
    fn, threads = _kernel_fn()
    n = theta.numel()
    blocks = max(1, min(-(-n // threads),
                        _sm_count(theta.device.index) * BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = fn(*(t.data_ptr() for t in outs),
             *(t.data_ptr() for t in (theta, m, h, g, h_hat)),
             *(DTYPE_CODES[t.dtype] for t in (theta, m, h, g, h_hat)),
             n, float(do_h), float(lr), hp["beta1"], 1.0 - hp["beta1"],
             hp["beta2"], 1.0 - hp["beta2"], hp["rho"], hp["eps"],
             hp["weight_decay"], blocks, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return outs


def _update(name, ndim, theta, m, h, g, h_hat, do_h, lr, hp, inplace):
    kind = _validate(name, ndim, (theta, m, h, g, h_hat))
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
