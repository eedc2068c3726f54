"""The kernels' shape-only path and the cost of one launch.

A tensor without storage, a fake tensor (`torch._subclasses.fake_tensor`)
or a meta tensor, whatever its device, that reaches one of the sixteen
kernel entry points takes the shape-only path: the wrapper validates its
inputs as ever, records the launch in every active cost trace
(`repro_torch.launch.op_cost.OpCost`, which counts it) with the bytes it
moves and its fp32 operations, and returns outputs of the real path's
shapes and dtypes (or its in-place operands), computing nothing.  The
wrapper's ``LAUNCHES`` counts kernels that ran and is not touched.  A
tensor with storage never takes the path: a CPU tensor runs the plain
version, a CUDA tensor the kernel.

`launch_bytes` is the byte count of a launch, each operand read once at
its width and each output written once; `chip_smoke.py: bound` counts
with it too.  The operation counts per coordinate are those of the
kernels' bounds in `chip_smoke.py`.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: fp32 operations per coordinate of the Sophia update (m: 3, h EMA: 3,
#: h select: 3, decay: 2, max: 1, divide: 1, clip: 2, step: 2)
SOPHIA_OPS = 17
#: fp32 operations per coordinate of the quantize round-trips (quant:
#: divide, add, floor, 2 compares, multiply; uplink adds the delta's
#: subtract and add and the residual's subtract; broadcast also the
#: replica's add)
QUANT_OPS = {"quant": 6, "uplink": 9, "broadcast": 10}
#: fp32 operations per coordinate of the biased compressors' kernels
#: (sign: two compares, copysign, multiply; threshold: abs, compare,
#: select)
BIASED_OPS = {"sign": 4, "topk": 3}

#: the active cost traces: each has ``kernel(name, nbytes, ops, shape)``
SINKS: List = []


def stale_ops(K: int) -> int:
    """fp32 operations per output coordinate of the stale accumulate: a
    multiply and an add per arrival, the final scale."""
    return 2 * K + 1


def bitonic_pairs(n: int) -> int:
    """Compare-exchanges of the bitonic sorting network over n = 2^p."""
    p = n.bit_length() - 1
    return n // 2 * p * (p + 1) // 2


def robust_ops(K: int, trim: int, sort_share: float) -> float:
    """fp32 operations per output coordinate of the robust combine, on
    average over coordinates of which ``sort_share`` take its sort form:
    the scale multiply per arrival, the survivor-weight select, the
    multiply and the two adds of the sums per arrival, the divide; with
    trim > 0 also the magnitude test per arrival (abs, compare) and then
    either the sort form's selection (a min and a max per
    compare-exchange of the bucket's network, the four compares against
    its bounds per arrival) or the pass form's (a select and a compare
    per arrival in each of the 2*trim passes).  The register buckets
    only (K <= 64)."""
    ops = K + 4 * K + 1
    if trim == 0:
        return ops
    bucket = 16 if K <= 16 else 32 if K <= 32 else 64
    sort_ops = 2 * bitonic_pairs(bucket) + 4 * K
    pass_ops = 2 * trim * K * 2
    return (ops + 2 * K + sort_share * sort_ops
            + (1.0 - sort_share) * pass_ops)


def shape_only(t: torch.Tensor) -> bool:
    """Whether a launch whose lead operand is ``t`` takes the shape-only
    path: ``t`` has no storage (a fake or meta tensor).  One operand
    tells: the wrapper's checks have put every operand on ``t``'s device,
    and under `FakeTensorMode` every tensor is fake.  Two attribute
    tests, as this runs before every launch."""
    return t.is_meta or isinstance(t, FakeTensor)


def launch_bytes(ins: Sequence[torch.Tensor],
                 outs: Sequence[torch.Tensor]) -> int:
    """Bytes of one launch: each input read once and each output written
    once, at its width (a shared operand is passed once)."""
    return (sum(t.numel() * t.element_size() for t in ins)
            + sum(t.numel() * t.element_size() for t in outs))


def shape_only_launch(name: str, ins: Sequence[torch.Tensor],
                      outs: Sequence[torch.Tensor], ops: float):
    """The shape-only launch of entry point ``name`` over ``ins`` into
    ``outs`` (allocated by the caller, never written), recorded in every
    active trace with `launch_bytes`, ``ops`` fp32 operations and the
    first output's shape.  Returns ``outs``."""
    nbytes = launch_bytes(ins, outs)
    for sink in SINKS:
        sink.kernel(name, nbytes, float(ops), tuple(outs[0].shape))
    return outs
