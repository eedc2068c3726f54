"""Exact bytes on the wire of a federated round.

What each of the round's named streams (``uplink`` / ``downlink`` /
``hessian``, `repro_torch.configs.base.COMM_STREAMS`) would transmit:
payload bits, not the simulation's container sizes, so int4 codes count
4 bits though they are held in int8.  `wire_bits` prices one payload;
`round_bytes` composes per-round, per-stream totals (the uplink and
downlink payloads are per participant, the averaged-curvature broadcast
is one common payload).  Pure Python over static config; the numbers are
the JAX package's, as exact ints.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.comm.flat import HEADER_BYTES
from repro_torch.configs.base import COMM_STREAMS, CommConfig

FP32_BITS = 32


def _num_groups(comm: CommConfig, n_params: int) -> int:
    return -(-n_params // comm.quant_block)


def topk_k(comm: CommConfig, n_params: int) -> int:
    return min(n_params, max(1, math.ceil(comm.topk_ratio * n_params)))


def wire_bits(comm: CommConfig, n_params: int) -> int:
    """Payload bits of ONE compressed wire buffer under
    ``comm.compressor`` (pass a `CommConfig.stream(name)` view to price a
    stream), the 24-byte header included."""
    header = 8 * HEADER_BYTES
    c = comm.compressor
    if c == "identity":
        return header + FP32_BITS * n_params
    if c == "int8":
        return header + 8 * n_params + FP32_BITS * _num_groups(comm,
                                                               n_params)
    if c == "int4":
        return header + 4 * n_params + FP32_BITS * _num_groups(comm,
                                                               n_params)
    if c == "topk":
        # (int32 index, fp32 value) per surviving coordinate
        return header + topk_k(comm, n_params) * (32 + FP32_BITS)
    if c == "signsgd":
        return header + n_params + FP32_BITS   # 1 bit/coord + one scale
    raise ValueError(f"unknown compressor {c!r}")


def wire_bytes(comm: CommConfig, n_params: int) -> int:
    return -(-wire_bits(comm, n_params) // 8)


def stream_bytes(comm: CommConfig, stream: str, n_params: int) -> int:
    """Bytes of ONE payload on the named stream (0 when disabled)."""
    if stream not in COMM_STREAMS:
        raise ValueError(f"unknown stream {stream!r} (want {COMM_STREAMS})")
    if stream == "hessian" and not comm.hessian_enabled:
        return 0
    return wire_bytes(comm.stream(stream), n_params)


def round_bytes(comm: CommConfig, n_params: int,
                num_clients: int) -> Dict[str, int]:
    """Per-round, per-stream totals: S participants each upload a model
    delta and receive a broadcast (exact fp32 when the downlink is off);
    with the hessian stream on, each also uploads its h-EMA and the
    server broadcasts ONE common curvature payload, charged once."""
    s = comm.num_participants(num_clients)
    up = s * stream_bytes(comm, "uplink", n_params)
    down = s * stream_bytes(comm, "downlink", n_params)
    h_up = s * stream_bytes(comm, "hessian", n_params)
    h_down = stream_bytes(comm, "hessian", n_params)
    return {"participants": s, "uplink_bytes": up, "downlink_bytes": down,
            "hessian_uplink_bytes": h_up, "hessian_downlink_bytes": h_down,
            "total_bytes": up + down + h_up + h_down}
