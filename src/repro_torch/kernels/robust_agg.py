"""The sort-free robust combine (trimmed mean, coordinate median,
norm-clip): a wrapper around the CUDA kernel ``csrc/robust_agg.cu`` (the
port of the JAX package's Pallas ``kernels/robust_agg.py``).

For CUDA tensors `robust_agg_flat` validates its inputs and launches the
kernel on PyTorch's current stream, or raises.  For CPU tensors it runs
the plain version `ref.robust_agg_ref`; that is the only case in which
the plain version runs.  ``LAUNCHES`` counts kernel launches (CPU calls
count nothing).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.ref import robust_agg_ref
from repro_torch.kernels.stale_accum import check_wires, vector_of

#: kernel launches per entry point since the last `reset_launches`
LAUNCHES: Dict[str, int] = {"robust_agg_flat": 0}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = build.load("robust_agg")
    fn = lib.robust_agg_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_I64, _I, _P]
        fn.restype = ctypes.c_int
        lib.robust_agg_bucket.argtypes = [_I]
        lib.robust_agg_bucket.restype = ctypes.c_int
        lib.robust_agg_threads.restype = ctypes.c_int
    return lib


def robust_agg_flat(wires, weights, scales, *, trim: int,
                    normalize: bool = True):
    """Robust combine of a ``(K, R, C)`` arrival stack into one ``(R,
    C)`` fp32 tensor: ``xs_k = scales[k] * wires[k]``; per coordinate
    the ``trim`` largest and ``trim`` smallest xs are dropped (one per
    pass, the lowest arrival index first among ties, a NaN first of
    all); ``num = sum_k xs_k * wm_k`` over all k with ``wm_k =
    weights[k]`` for a survivor and 0 otherwise, divided by ``sum_k
    wm_k`` when ``normalize``.  Requires ``2 * trim < K``.

    wires: fp32, bf16, e4m3 or e5m2 (upcast to fp32 in the kernel);
    weights and scales: ``(K,)`` fp32 on the wires' device, or host
    sequences of floats."""
    name = "robust_agg_flat"
    check_wires(name, wires)
    K = wires.shape[0]
    trim = int(trim)
    if trim < 0 or not 2 * trim < K:
        raise ValueError(f"{name}: trim={trim} must satisfy "
                         f"0 <= 2*trim < K={K}")
    w = vector_of(weights, wires.device, name, "weights", K)
    s = vector_of(scales, wires.device, name, "scales", K)
    if wires.device.type == "cpu":
        return robust_agg_ref(wires, w, s, trim=trim, normalize=normalize)
    lib = _lib()
    out = torch.empty(wires.shape[1:], dtype=torch.float32,
                      device=wires.device)
    n = out.numel()
    mask = None
    if lib.robust_agg_bucket(K) == 0:
        # past the register buckets: the survivor bits of each
        # coordinate, (K + 31) // 32 words, in scratch
        mask = torch.empty(((K + 31) // 32, n), dtype=torch.int32,
                           device=wires.device)
    threads = int(lib.robust_agg_threads())
    err = lib.robust_agg_launch(
        out.data_ptr(), wires.data_ptr(), w.data_ptr(), s.data_ptr(),
        None if mask is None else mask.data_ptr(), DTYPE_CODES[wires.dtype],
        K, trim, int(bool(normalize)), n,
        build.grid_blocks(-(-n // threads), wires.device),
        torch.cuda.current_stream(wires.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return out
