"""Hand-written Hopper kernels of the port, one per Pallas kernel family
of the JAX package's ``kernels/``.

Beside each kernel sits its plain PyTorch version (`ref`): a wrapper
runs the plain version for CPU tensors only, and launches the kernel —
or raises — for CUDA tensors; a tensor without storage takes the
shape-only path of a cost trace (`cost`).  Sources live in ``csrc/`` and
are built at first use (`build`).

``KERNELS`` is the JAX package's registry of the eight kernel families,
each with whether the port has it (all eight since the scheduler's and
the fleet's kernels landed).
"""
KERNELS = {
    "quant_roundtrip": True,
    "broadcast_roundtrip": True,
    "uplink_roundtrip": True,
    "sign_roundtrip": True,
    "topk_threshold": True,
    "sophia_update": True,
    "stale_accum": True,
    "robust_agg": True,
}
