"""Federated runtime of the port: one `FedEngine.round` call is one
communication round of Alg. 1 on the direct path (lossless identity
uplink, full participation, no extra streams), for fed_sophia and
fedavg.

Two execution strategies, as in the JAX package:
  * parallel   — the whole cohort steps together: the client axis is a
                 batch dimension written out, and each local iteration
                 is ONE client-batched Sophia kernel launch over the
                 ``(C, rows, cols)`` stacks;
  * sequential — a Python loop over clients, one flat launch per client
                 per local iteration; the aggregate is ``Σ_i t_i / C``
                 in client order.

The engine is flat-resident: the packed ``(rows, cols)`` fp32 wire
buffer of `repro_torch.comm.flat` holds the round-start model, each
client's evolving theta, the Sophia m/h EMAs (``(C, rows, cols)``
across rounds) and the GNB estimates.  Parameter dicts exist only at
the loss/grad boundary (one unpack view in, one pack of the grads out).

Host-side scalars: the round index, the local step and ``do_h`` are
Python ints/bools, and lr is a 0-dim float32 CPU tensor, so no step
reads the device.

Randomness (the RNG seam): the GNB's sampled labels are
``argmax(logits + gumbel)``.  `round` takes a `torch.Generator`, from
which it draws the gumbel noise on the device, or an injected noise
tensor (the tests inject the JAX package's own draws).

Settings outside this slice raise `NotImplementedError`, naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.comm import accounting
from repro_torch.comm.flat import (FlatSpec, as_dtype, flat_spec, pack,
                                   unpack, zeros)
from repro_torch.configs.base import FedConfig, RobustConfig
from repro_torch.core.gnb import gnb_estimate
from repro_torch.core.schedules import lr_at_round
from repro_torch.core.sophia import SophiaState, sophia_step_flat
from repro_torch.models.small import gumbel_noise

_ROADMAP = "not ported yet (ROADMAP.md, queue 1: {})"


def _check_slice(fed: FedConfig) -> None:
    """Reject every setting this slice does not run."""
    if fed.optimizer in ("done", "fedadam", "fedyogi"):
        raise NotImplementedError(
            f"optimizer {fed.optimizer!r} "
            + _ROADMAP.format("'engine: fedadam/fedyogi and DONE'"))
    if fed.optimizer not in ("fed_sophia", "fedavg"):
        raise ValueError(f"unknown optimizer {fed.optimizer!r}")
    if fed.strategy not in ("parallel", "sequential"):
        raise ValueError(f"unknown strategy {fed.strategy!r}")
    if fed.hessian_every_unit not in ("step", "round"):
        raise ValueError(
            f"unknown hessian_every_unit {fed.hessian_every_unit!r}")
    comm = fed.comm
    C = fed.num_clients
    if not (comm.lossless and comm.num_participants(C) == C
            and not comm.multi_stream):
        raise NotImplementedError(
            "a non-default CommConfig (compression, partial "
            "participation or extra streams) takes the comm path, "
            + _ROADMAP.format("'the comm path'"))
    if fed.robust != RobustConfig():
        raise NotImplementedError(
            "robust aggregation and attacks are "
            + _ROADMAP.format("'the adversarial fleet'"))
    if fed.obs.probes:
        raise NotImplementedError(
            "ObsConfig.probes is " + _ROADMAP.format("'obs/'"))
    if fed.grad_microbatches > 1:
        raise NotImplementedError(
            "grad_microbatches > 1 is "
            + _ROADMAP.format("'engine: grad_microbatches'"))
    for name in ("state_dtype", "moment_dtype", "hessian_dtype"):
        dt = getattr(comm, name) or comm.state_dtype
        if as_dtype(dt) != torch.float32:
            raise NotImplementedError(
                f"CommConfig.{name}={dt!r}: the resident dtype policy is "
                + _ROADMAP.format("'resident dtype policy'"))


class FedEngine:
    def __init__(self, task, fed: FedConfig, device=None):
        _check_slice(fed)
        self.task = task
        self.fed = fed
        self.device = resolve_device(device)
        # the layout of packed-resident params (set by init / pack_state):
        # a packed buffer carries no keys, so rounds over it read this
        self._spec: Optional[FlatSpec] = None

    # ------------------------------------------------- residency helpers
    @staticmethod
    def params_packed(params) -> bool:
        """Whether ``state["params"]`` is a packed ``(rows, cols)`` wire
        buffer rather than a parameter dict."""
        return isinstance(params, torch.Tensor) and params.ndim == 2

    def _stateful(self) -> bool:
        return (self.fed.optimizer == "fed_sophia"
                and self.fed.persistent_client_state)

    def _require_spec(self) -> FlatSpec:
        if self._spec is None:
            raise ValueError(
                "packed-resident state reached the engine before its "
                "layout was established: create the state with this "
                "engine's init() + pack_state()")
        return self._spec

    def spec_for(self, params) -> FlatSpec:
        """The wire layout of ``params`` under either residency."""
        if self.params_packed(params):
            return self._require_spec()
        return flat_spec(params, cols=self.fed.comm.quant_block)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        params = self.task.init(generator, self.device)
        return self.init_from_params(params)

    def init_from_params(self, params) -> Dict[str, Any]:
        """A round-0 state around given initial params (weights carried
        over from elsewhere, e.g. `repro_torch.convert`)."""
        spec = self.spec_for(params)
        self._spec = spec
        state: Dict[str, Any] = {"params": params, "round": 0}
        if self._stateful():
            C = self.fed.num_clients
            state["client_opt"] = SophiaState(
                m=zeros(spec, (C,), device=self.device),
                h=zeros(spec, (C,), device=self.device))
        return state

    # ------------------------------------------- packed-resident boundary
    def pack_state(self, state) -> Dict[str, Any]:
        """Keep ``state["params"]`` packed between rounds too.
        Idempotent."""
        params = state["params"]
        if self.params_packed(params):
            return state
        spec = self.spec_for(params)
        self._spec = spec
        return {**state, "params": pack(params, spec)}

    def unpack_state(self, state) -> Dict[str, Any]:
        """Inverse of `pack_state`.  Idempotent on dict-resident state."""
        params = state["params"]
        if not self.params_packed(params):
            return state
        return {**state, "params": unpack(params, self._require_spec())}

    def unpack_params(self, state):
        """The params dict view of ``state`` under either residency."""
        return self.unpack_state(state)["params"]

    def num_params(self, state) -> int:
        """True model coordinate count (the pad tail never counts)."""
        return self.spec_for(state["params"]).total

    # ------------------------------------------------------------- the round
    def round(self, state, batches, *, generator: torch.Generator = None,
              gumbel: torch.Tensor = None):
        """batches: dict of leaves with leading client axis C.  Returns
        ``(state, metrics)``.

        GNB noise comes from ``generator`` (drawn on the device) or from
        ``gumbel``: ``(C, J, B, K)`` for ``hessian_every_unit="step"``
        (index j is local step j), ``(C, 1, B, K)`` for ``"round"``.

        Resident state is updated in place — the Sophia m/h stacks of
        ``state["client_opt"]`` included — the counterpart of the JAX
        round's buffer donation: do not reuse the state passed in;
        rebind the returned one."""
        fed = self.fed
        round_idx = int(state["round"])
        lr = lr_at_round(fed, round_idx)
        C = fed.num_clients
        if batches["y"].shape[0] != C:
            raise ValueError(f"batches carry {batches['y'].shape[0]} "
                             f"clients, the config {C}")
        spec = self.spec_for(state["params"])
        noise = self._gumbel_source(batches, generator, gumbel)
        state, loss = self._round_direct(state, batches, noise, round_idx,
                                         lr, spec)
        state = {**state, "round": round_idx + 1}
        wire = accounting.round_bytes(fed.comm, spec.total, C)
        metrics = {"loss": loss, "lr": lr, "participants": C}
        for k in ("uplink_bytes", "downlink_bytes", "hessian_uplink_bytes",
                  "hessian_downlink_bytes", "total_bytes"):
            metrics[k] = wire[k]
        return state, metrics

    def _gumbel_source(self, batches, generator, gumbel):
        """``noise(clients, j)`` -> the gumbel noise of GNB draw ``j`` for
        ``clients`` (a slice of the cohort, or one client index)."""
        fed = self.fed
        C = fed.num_clients
        B = int(batches["y"].shape[1])
        K = self.task.num_classes
        if gumbel is not None:
            draws = 1 if fed.hessian_every_unit == "round" else fed.local_iters
            want = (C, draws, B, K)
            if tuple(gumbel.shape) != want:
                raise ValueError(f"gumbel noise has shape "
                                 f"{tuple(gumbel.shape)}, want {want}")
            noise = gumbel.to(self.device, torch.float32)
            return lambda clients, j: noise[clients, j]
        if generator is None:
            raise ValueError("round() needs a generator or injected gumbel "
                             "noise for the GNB estimate")

        def draw(clients, j):
            lead = (C,) if isinstance(clients, slice) else ()
            return gumbel_noise(generator, lead + (B, K), self.device)
        return draw

    def _round_direct(self, state, batches, noise, round_idx, lr, spec):
        """Server model <- mean of client params, in wire layout."""
        fed = self.fed
        C = fed.num_clients
        params = state["params"]
        packed = self.params_packed(params)
        theta = (params.to(torch.float32) if packed
                 else pack(params, spec))
        opts = state.get("client_opt") if self._stateful() else None

        if fed.strategy == "parallel":
            new_t, new_opt, losses = self._local_update_flat_batched(
                spec, theta, opts, batches, noise, round_idx, lr)
            agg_flat = torch.mean(new_t, dim=0)
        else:
            agg_flat = torch.zeros_like(theta)
            losses = []
            for i in range(C):
                opt_i = (None if opts is None
                         else SophiaState(m=opts.m[i], h=opts.h[i]))
                t_i, _, loss = self._local_update_flat(
                    spec, theta, opt_i, {k: v[i] for k, v in batches.items()},
                    functools.partial(noise, i), round_idx, lr)
                agg_flat = agg_flat + t_i / C
                losses.append(loss)
            losses = torch.stack(losses)
            # each client's m/h rows were updated in place in the stack
            new_opt = opts

        if packed:
            state = {**state, "params": agg_flat.to(params.dtype)}
        else:
            state = {**state, "params": unpack(agg_flat, spec)}
        if self._stateful():
            state = {**state, "client_opt": new_opt}
        return state, torch.mean(losses)

    # ------------------------------------------------- one client, dispatch
    def _local_update_flat(self, spec, theta, opt, batch, noise, round_idx,
                           lr):
        """One client's local training.  ``theta``: the shared
        ``(rows, cols)`` start model (not written); ``opt``: a
        `SophiaState` of ``(rows, cols)`` buffers, updated in place, or
        None.  ``noise(j)`` gives GNB draw j.  Returns ``(new_theta,
        new_opt_or_None, mean_loss)``."""
        fed = self.fed
        if fed.optimizer == "fed_sophia":
            if opt is None:   # stateless: fresh EMAs each round
                opt = SophiaState(m=zeros(spec, device=theta.device),
                                  h=zeros(spec, device=theta.device))
            t, m, h, loss = self._local_sophia_flat(
                spec, theta, opt.m, opt.h, batch, round_idx, noise, lr)
            opt = SophiaState(m=m, h=h)
            return t, (opt if fed.persistent_client_state else None), loss
        t, loss = self._local_sgd_flat(spec, theta, batch, lr)
        return t, None, loss

    def _local_update_flat_batched(self, spec, theta, opts, batches, noise,
                                   round_idx, lr):
        """`_local_update_flat` for the whole cohort: per-client state
        carries a leading client axis N; ``noise(clients, j)``."""
        fed = self.fed
        N = fed.num_clients
        if fed.optimizer == "fed_sophia":
            if opts is None:   # stateless: fresh EMAs each round
                opts = SophiaState(
                    m=zeros(spec, (N,), device=theta.device),
                    h=zeros(spec, (N,), device=theta.device))
            t, m, h, loss = self._local_sophia_flat_batched(
                spec, theta, opts.m, opts.h, batches, round_idx, noise, lr)
            opt = SophiaState(m=m, h=h)
            return t, (opt if fed.persistent_client_state else None), loss
        t, loss = self._local_sgd_flat_batched(spec, theta, batches, lr)
        return t, None, loss

    # ------------------------------------------- local client training (flat)
    def _flat_value_and_grad(self, theta, batch, spec):
        """The loss/grad boundary: ONE unpack view feeds autograd, ONE
        pack lays the grads back.  ``theta`` may carry a leading client
        axis; each client's grads then come from its own loss.  Also
        returns the params view for the GNB refresh."""
        pg = {k: v.detach().requires_grad_(True)
              for k, v in unpack(theta, spec).items()}
        loss = self.task.loss(pg, batch)
        grads = torch.autograd.grad(loss.sum(), [pg[k] for k in spec.keys])
        return loss.detach(), pack(dict(zip(spec.keys, grads)), spec), pg

    def _sophia_loop(self, spec, t, m, h, batch, round_idx, noise, lr):
        """The J local Sophia iterations over the buffers ``t``, ``m``,
        ``h`` (one client ``(rows, cols)``, or a cohort ``(N, rows,
        cols)``), updated in place.  Returns the per-step losses."""
        fed = self.fed
        task = self.task
        no_hh = torch.zeros_like(t)
        # round mode (Alg. 1 line 9 literal): the GNB estimate uses the
        # round-start params, once per refresh round
        round_mode = fed.hessian_every_unit == "round"
        if round_mode:
            do_h_round = round_idx % fed.tau == 0
            hh_round = (pack(gnb_estimate(task, unpack(t, spec), batch,
                                          noise(0)), spec)
                        if do_h_round else no_hh)
        losses = []
        for j in range(fed.local_iters):
            loss, g, pg = self._flat_value_and_grad(t, batch, spec)
            if round_mode:
                do_h = do_h_round and j == 0   # EMA applied once per refresh
                hh = hh_round
            else:
                do_h = (round_idx * fed.local_iters + j) % fed.tau == 0
                hh = (pack(gnb_estimate(task, pg, batch, noise(j)), spec)
                      if do_h else no_hh)
            # in place: the engine owns t, and m/h are the resident EMAs
            # (the counterpart of the JAX round's buffer donation)
            sophia_step_flat(
                t, m, h, g, hh, do_h, lr=lr, beta1=fed.beta1,
                beta2=fed.beta2, rho=fed.rho, eps=fed.eps,
                weight_decay=fed.weight_decay, inplace=True)
            losses.append(loss)
        return torch.stack(losses)

    def _local_sophia_flat(self, spec, theta, m, h, batch, round_idx, noise,
                           lr):
        """Flat-resident Sophia local loop of one client."""
        t = theta.clone()          # theta is every client's start model
        losses = self._sophia_loop(spec, t, m, h, batch, round_idx, noise,
                                   lr)
        return t, m, h, torch.mean(losses)

    def _local_sophia_flat_batched(self, spec, theta, m, h, batches,
                                   round_idx, noise, lr):
        """`_local_sophia_flat` for N clients at once: one batched kernel
        launch per local iteration over the ``(N, rows, cols)``
        stacks."""
        N = m.shape[0]
        # materialise the shared start model per client: an expand() view
        # has stride 0 and the kernel writes the stack in place
        t = theta.expand((N,) + tuple(theta.shape)).contiguous()
        cohort = slice(None)
        losses = self._sophia_loop(spec, t, m, h, batches, round_idx,
                                   lambda j: noise(cohort, j), lr)
        return t, m, h, torch.mean(losses, dim=0)

    def _local_sgd_flat(self, spec, theta, batch, lr):
        """Flat-resident local SGD: the update is one flat axpy."""
        t = theta
        losses = []
        for _ in range(self.fed.local_iters):
            loss, g, _ = self._flat_value_and_grad(t, batch, spec)
            t = t - lr * g
            losses.append(loss)
        return t, torch.mean(torch.stack(losses), dim=0)

    def _local_sgd_flat_batched(self, spec, theta, batches, lr):
        """`_local_sgd_flat` for N clients at once."""
        N = self.fed.num_clients
        t = theta.expand((N,) + tuple(theta.shape)).contiguous()
        return self._local_sgd_flat(spec, t, batches, lr)
