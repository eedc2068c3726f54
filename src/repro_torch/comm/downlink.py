"""Compressed server -> client broadcast (the ``downlink`` stream).

The server keeps, per client, the model that client last received (the
``comm_dn_model`` replicas, in the downlink stream's wire layout) and
sends the compressed delta ``theta_server - theta_i^rx``, with
server-side per-client error feedback when the policy asks for it
(``downlink_error_feedback``; "auto" keeps residuals for the biased
compressors only, as the uplink does).  With an unbiased quantizer the
reconstruction error lands in the client's replica and the next round's
delta cancels it.  Non-participants keep their replicas until they are
next sampled.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.comm.compressors import (Compressor, StochasticQuant,
                                          wants_error_feedback)
from repro_torch.comm.flat import FlatSpec
from repro_torch.configs.base import CommConfig
from repro_torch.kernels import quantize as kq

#: engine state keys owned by this module
MODEL_KEY = "comm_dn_model"
EF_KEY = "comm_dn_ef"


def wants_downlink_ef(comm: CommConfig) -> bool:
    """Server-side per-client EF residuals, under the uplink's "auto"
    policy."""
    return comm.downlink_enabled and wants_error_feedback(
        comm.stream("downlink"))


def init_state(comm: CommConfig, spec: FlatSpec, packed_params: torch.Tensor,
               num_clients: int) -> dict:
    """Server-side downlink state: every client starts in sync (the
    initial model is assumed distributed out of band), with a zero EF
    residual.  ``packed_params`` is the model in the downlink layout."""
    if not comm.downlink_enabled:
        return {}
    state = {MODEL_KEY: packed_params.expand(
        (num_clients,) + tuple(packed_params.shape)).clone()}
    if wants_downlink_ef(comm):
        state[EF_KEY] = torch.zeros(
            (num_clients, spec.rows, spec.cols), dtype=packed_params.dtype,
            device=packed_params.device)
    return state


def broadcast(comp: Compressor, u: Optional[torch.Tensor],
              packed_theta: torch.Tensor, model_row: torch.Tensor,
              ef_row: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One client's broadcast: encodes ``theta - theta_i^rx`` (+ EF),
    applies the reconstruction to the client's replica, and returns
    ``(new_model_row, new_ef_row)`` (``new_ef_row`` None when EF is off).
    A `StochasticQuant` stream is one fused kernel pass after the
    row-scale reduction; any other compressor encodes the delta as the
    uplink does (`Compressor.encode_delta`; ``u`` None: only the
    quantizers read noise)."""
    if isinstance(comp, StochasticQuant):
        ef = torch.zeros_like(model_row) if ef_row is None else ef_row
        new_model, resid = kq.broadcast_roundtrip_flat(
            packed_theta, model_row, ef, u,
            comp.scales(packed_theta - model_row + ef), qmax=comp.qmax)
        return new_model, (None if ef_row is None else resid)
    xhat, _, new_ef = comp.encode_delta(u, packed_theta, model_row, ef_row)
    return model_row + xhat, new_ef


def broadcast_batched(comp: Compressor, u: Optional[torch.Tensor],
                      packed_theta: torch.Tensor, model_rows: torch.Tensor,
                      ef_rows: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`broadcast` for the whole cohort in one launch: ``model_rows`` /
    ``ef_rows`` are ``(N, rows, cols)`` stacks, ``u`` carries the client
    axis, and ``packed_theta`` stays the one ``(rows, cols)`` server
    model, read by every client without being copied.  Any other
    compressor than `StochasticQuant` runs `encode_delta_batched` (one
    ``roundtrip_batched`` launch over the delta stack)."""
    if isinstance(comp, StochasticQuant):
        ef = torch.zeros_like(model_rows) if ef_rows is None else ef_rows
        new_models, resid = kq.broadcast_roundtrip_batched(
            packed_theta, model_rows, ef, u,
            comp.scales(packed_theta - model_rows + ef), qmax=comp.qmax)
        return new_models, (None if ef_rows is None else resid)
    xhat, _, new_efs = comp.encode_delta_batched(u, packed_theta,
                                                 model_rows, ef_rows)
    return model_rows + xhat, new_efs
