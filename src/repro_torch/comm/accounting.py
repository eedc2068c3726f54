"""Bytes-on-the-wire of the direct path's round.

This slice ports only the identity (lossless fp32) case that the direct
path reports: each participant uploads one fp32 model and receives one
fp32 broadcast, every payload behind the 24-byte wire header.  The
compressed payload formulas come with the comm path.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.comm.flat import HEADER_BYTES
from repro_torch.configs.base import CommConfig

FP32_BITS = 32


def round_bytes(comm: CommConfig, n_params: int,
                num_clients: int) -> Dict[str, int]:
    """Per-round, per-stream byte totals for the lossless direct path
    (exact ints, the same numbers the JAX package reports)."""
    if not comm.lossless or comm.multi_stream:
        raise NotImplementedError(
            "compressed streams are priced by the comm path (ROADMAP "
            "queue 1 item 6), not ported yet")
    s = comm.num_participants(num_clients)
    payload = HEADER_BYTES + -(-FP32_BITS * n_params // 8)
    up = s * payload
    down = s * payload
    return {"participants": s, "uplink_bytes": up, "downlink_bytes": down,
            "hessian_uplink_bytes": 0, "hessian_downlink_bytes": 0,
            "total_bytes": up + down}
