"""Device-side metrics buffer: the torch twin of the JAX package's
``repro/obs/buffer.py``.

The round metrics dict (`FedEngine.round`) holds device scalars (the
loss, the probes) beside host numbers (lr, byte counts).  Calling
``float(...)`` on a device scalar every round syncs the host with the
card every round; `MetricsAccumulator` instead stores each round's
scalars into one preallocated ``(capacity, N)`` fp32 buffer on the
metrics' device — enqueued device work, nothing read — and copies the
whole window to the host ONCE, at `flush`.  The trainer's obs loop
therefore syncs the host once per flush window, not once per round.
"""
from __future__ import annotations

from typing import Dict, List

import torch


class MetricsAccumulator:
    """Accumulates scalar-metric dicts on the device; flushes as floats.

    The metric name set is frozen by the first `add` (every round emits
    the same dict shape); rows beyond ``capacity`` without a flush are a
    caller bug and raise."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._names: tuple = ()
        self._buf = None
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def add(self, metrics: Dict[str, object]) -> None:
        """Store one round's scalar metrics (device tensors or host
        numbers) — no host sync: a scalar on the buffer's device is
        copied within the device, a host number is written to it."""
        if self._buf is None:
            self._names = tuple(sorted(metrics))
            # the buffer lives where the round's device scalars do
            dev = next((v.device for v in metrics.values()
                        if isinstance(v, torch.Tensor) and v.ndim == 0
                        and v.device.type != "cpu"), torch.device("cpu"))
            self._buf = torch.zeros((self.capacity, len(self._names)),
                                    dtype=torch.float32, device=dev)
        elif tuple(sorted(metrics)) != self._names:
            raise ValueError(
                f"metric names changed mid-run: "
                f"{sorted(metrics)} != {list(self._names)}")
        if self._n >= self.capacity:
            raise ValueError(
                f"metrics buffer full ({self.capacity} rows) — flush() "
                f"at the eval/checkpoint boundary first")
        row = self._buf[self._n]
        for i, k in enumerate(self._names):
            v = metrics[k]
            if isinstance(v, torch.Tensor) and v.device == row.device:
                row[i].copy_(v.detach().reshape(()))
            else:
                # a host number (or a host tensor: read here, no sync)
                row[i] = float(v)
        self._n += 1

    def flush(self) -> List[Dict[str, float]]:
        """ONE device->host copy: the buffered rows as plain-float dicts,
        in insertion order.  Resets the buffer."""
        if not self._n:
            return []
        host = self._buf[:self._n].cpu().tolist()
        self._n = 0
        return [dict(zip(self._names, row)) for row in host]
