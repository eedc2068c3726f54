"""Federated runtime of the port: one `FedEngine.round` call is one
communication round of Alg. 1.  Optimizers: fed_sophia (the paper),
fedavg, the FedOpt baselines fedadam / fedyogi (local SGD, then Adam or
Yogi on the server over the pseudo-gradient ``params - aggregate``) and
DONE (one damped-Richardson Newton step per round on Hessian-vector
products).

Two round paths, as in the JAX package:
  * direct — lossless identity uplink, full participation, no extra
             streams: the server model is the mean of the client models;
  * comm   — any compression, partial participation or extra stream:
             the multi-stream delta-space pipeline (`_round_comm`)

                 [downlink] broadcast delta theta - theta_i^rx (+ server
                            EF) -> round-trip -> client replica updated
                 local training from theta_i^rx
                 [uplink]   delta theta_i - theta_i^rx (+ client EF)
                            -> round-trip
                 [hessian]  (optional) the Sophia h-EMA -> round-trip
                 server: mean of the participants' reconstructions;
                 one averaged-curvature payload back to them.

             Only the S sampled participants train: their rows are
             gathered up front and scattered back after.

Two execution strategies:
  * parallel   — the cohort steps together: the client axis is a batch
                 dimension written out; each stage (downlink, each local
                 iteration's Sophia update, uplink, hessian) is ONE
                 client-batched kernel launch over ``(N, rows, cols)``;
  * sequential — a Python loop over clients, one flat launch per client
                 per stage; sums accumulate in client order.

The engine is flat-resident: the packed ``(rows, cols)`` wire buffer
of `repro_torch.comm.flat` holds the server model, each client's
evolving theta, the Sophia m/h EMAs (``(C, rows, cols)`` across rounds),
the uplink EF residuals and the downlink replicas.  Parameter dicts
exist only at the loss/grad boundary (and for DONE's Hessian-vector
products).

Resident dtypes (`CommConfig.state_dtype`, ``moment_dtype``,
``hessian_dtype``; as in the JAX package): m and h are stored in their
own dtypes, the EF residuals, replicas, packed params and packed
server m/v in ``state_dtype``.  Compute is fp32: the round upcasts the
server model at its start; gathered resident rows reach the kernels in
their storage dtype and each kernel stores its outputs in its inputs'
dtypes, so m and h are rounded at every local step; every other buffer
is stored back (`store_as`) when it is scattered.

Micro-batched gradients (``FedConfig.grad_microbatches`` n > 1): each
loss/grad step, and each GNB estimate, sums ``loss / n`` and ``grads /
n`` over n consecutive slices of the batch in order (DONE takes whole
batches, as in the JAX package).

Host-side scalars: the round index, the local step and ``do_h`` are
Python ints/bools, and lr is a 0-dim float32 CPU tensor, so no step
reads the device.

Randomness (the RNG seam).  The round's random inputs are the GNB's
gumbel label noise, the participation sample, the U[0, 1) noise of
each quantized stream and the gaussian of the ``random_wire`` attack.
`round` draws each from a `torch.Generator` on the device, or takes it
injected (the tests inject the JAX package's own draws): ``gumbel`` as
``(C, draws, B, K)`` and ``comm_noise`` as a dict (see `round`).
Participant k gets client ``ids[k]``'s draws.

The adversarial fleet (`repro_torch.robust`): with a byzantine subset
its rows of the aggregated stack are attacked, and a non-degenerate
aggregator combines the stack through the robust-combine kernel; on the
direct path both act on the contribution deltas (client model minus
the round-start model).  A degenerate `RobustConfig` leaves the round on
its mean path, bitwise.

With ``ObsConfig.probes`` the round's metrics also carry the Sophia
health scalars of `repro_torch.obs.probes`, read from the state the
round produced (which stays bitwise the unprobed round's).

Profiler ranges: a round runs inside `repro_torch.obs.spans.ROUND_SPAN`
and each piece of its work inside one of the disjoint phase ranges of
`repro_torch.obs.spans.PHASES` (loss/grad, GNB, pack, optimizer, comm,
aggregate), the backwards included (`spans.spanned`); the client steps
and the server step open theirs also when the virtual-time scheduler
calls them.  They move no value.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.comm import accounting, downlink
from repro_torch.comm.compressors import (BIASED, StochasticQuant,
                                          make_compressor,
                                          make_stream_compressor,
                                          participation_sample,
                                          wants_error_feedback)
from repro_torch.comm.flat import (FlatSpec, Header, as_dtype, cat_rows,
                                   flat_spec, leaves_of, pack, put_rows_,
                                   repack, take_rows, unpack, with_cols,
                                   zeros)
from repro_torch.configs.base import COMM_STREAMS, FedConfig
from repro_torch.core.gnb import (gnb_estimate, labels_of,
                                  value_and_grads)
from repro_torch.core.schedules import lr_at_round
from repro_torch.core.sophia import SophiaState, sophia_step_flat
from repro_torch.kernels.ref import sign, store_as, store_into
from repro_torch.kernels.sophia_update import takes_leaves
from repro_torch.models.small import gumbel_noise
from repro_torch.obs import probes as obs_probes
from repro_torch.obs import spans
from repro_torch.obs.spans import (AGGREGATE, COMM, GNB, LOSS_GRAD,
                                   OPTIMIZER, PACK, annotate)
from repro_torch.robust.aggregators import aggregate_stack, resolve
from repro_torch.robust.attacks import (attack_wires, byzantine_mask,
                                        wire_attack_active)
from repro_torch.utils.tree import tree_zeros_like

_COMPRESSORS = ("identity", "int8", "int4") + tuple(sorted(BIASED))
OPTIMIZERS = ("fed_sophia", "fedavg", "done", "fedadam", "fedyogi")
#: the FedOpt baselines: local SGD, then Adam / Yogi on the server
FEDOPT = ("fedadam", "fedyogi")


def _check_config(fed: FedConfig) -> None:
    """Reject unknown and inconsistent settings (`ValueError`)."""
    if fed.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {fed.optimizer!r}")
    if fed.strategy not in ("parallel", "sequential"):
        raise ValueError(f"unknown strategy {fed.strategy!r}")
    if fed.hessian_every_unit not in ("step", "round"):
        raise ValueError(
            f"unknown hessian_every_unit {fed.hessian_every_unit!r}")
    comm = fed.comm
    for stream in COMM_STREAMS:
        c = comm.stream(stream).compressor
        if c not in _COMPRESSORS:
            raise ValueError(f"unknown {stream} compressor {c!r}")
    if not 0.0 < comm.participation <= 1.0:
        raise ValueError(f"participation={comm.participation} must be in "
                         "(0, 1]")
    stateful = fed.optimizer == "fed_sophia" and fed.persistent_client_state
    if comm.hessian_enabled and not stateful:
        raise ValueError(
            "the hessian comm stream aggregates the Sophia h-EMA: it "
            "requires optimizer='fed_sophia' with "
            "persistent_client_state=True")
    if fed.obs.probes and not stateful:
        raise ValueError(
            "ObsConfig.probes reads the persistent Sophia m/h EMAs: it "
            "requires optimizer='fed_sophia' with "
            "persistent_client_state=True")
    if fed.sched.dispatch_chunk < 0:
        raise ValueError(f"dispatch_chunk={fed.sched.dispatch_chunk} must "
                         "be >= 0 (0: unchunked)")
    # unknown aggregators and attacks raise ValueError here, not mid-round
    resolve(fed.robust, fed.num_clients)
    byzantine_mask(fed.robust, fed.num_clients)
    for name in ("state_dtype", "moment_dtype", "hessian_dtype"):
        as_dtype(getattr(comm, name) or comm.state_dtype)


class CommRuntime(NamedTuple):
    """The comm path's (spec, compressor) per active stream.  ``spec``
    (the uplink layout) is also the layout of all flat-resident engine
    state; the downlink and hessian streams may pack the same flattened
    coordinates with their own ``quant_block`` (`repack` moves buffers
    between the geometries)."""
    spec: FlatSpec
    comp: Any
    spec_dn: Optional[FlatSpec] = None
    comp_dn: Any = None
    spec_h: Optional[FlatSpec] = None
    comp_h: Any = None

    @property
    def dn_on(self) -> bool:
        return self.comp_dn is not None

    @property
    def h_on(self) -> bool:
        return self.comp_h is not None


class ClientNoise(NamedTuple):
    """The random inputs of one client step (or of the cohort's, each
    with a leading participant axis): ``gumbel(j)`` is GNB draw j,
    ``uniform(stream)`` the U[0, 1) noise of a quantized stream
    ("uplink", "downlink", "hessian"), None where the stream needs
    none."""
    gumbel: Callable[[int], torch.Tensor]
    uniform: Callable[[str], Optional[torch.Tensor]]


class FedEngine:
    def __init__(self, task, fed: FedConfig, device=None):
        _check_config(fed)
        self.task = task
        self.fed = fed
        self.device = resolve_device(device)
        # the runtime of the packed-resident state (set by init /
        # pack_state): a packed buffer carries no keys, so rounds over it
        # read the layout from here
        self._rt: Optional[CommRuntime] = None

    # ------------------------------------------------- residency helpers
    @property
    def state_dtype(self) -> torch.dtype:
        """Storage dtype of resident wire-layout state (EF residuals,
        replicas, packed params and server m/v)."""
        return as_dtype(self.fed.comm.state_dtype)

    @property
    def moment_dtype(self) -> torch.dtype:
        """Storage dtype of the ``(C, rows, cols)`` Sophia m stack
        (``CommConfig.moment_dtype``, "" -> ``state_dtype``)."""
        return as_dtype(self.fed.comm.moment_dtype
                        or self.fed.comm.state_dtype)

    @property
    def hessian_dtype(self) -> torch.dtype:
        """Storage dtype of the ``(C, rows, cols)`` Sophia h stack
        (``CommConfig.hessian_dtype``, "" -> ``state_dtype``)."""
        return as_dtype(self.fed.comm.hessian_dtype
                        or self.fed.comm.state_dtype)

    @staticmethod
    def params_packed(params) -> bool:
        """Whether ``state["params"]`` is a packed ``(rows, cols)`` wire
        buffer rather than a parameter dict."""
        return isinstance(params, torch.Tensor) and params.ndim == 2

    def _stateful(self) -> bool:
        return (self.fed.optimizer == "fed_sophia"
                and self.fed.persistent_client_state)

    def _require_rt(self) -> CommRuntime:
        if self._rt is None:
            raise ValueError(
                "packed-resident state reached the engine before its "
                "layout was established: create the state with this "
                "engine's init() + pack_state()")
        return self._rt

    def comm_runtime(self, spec: FlatSpec) -> CommRuntime:
        """The per-stream (spec, compressor) handles over ``spec``."""
        comm = self.fed.comm
        kw: Dict[str, Any] = {}
        if comm.downlink_enabled:
            s = with_cols(spec, comm.stream("downlink").quant_block)
            kw.update(spec_dn=s,
                      comp_dn=make_stream_compressor(comm, "downlink", s))
        if comm.hessian_enabled:
            s = with_cols(spec, comm.stream("hessian").quant_block)
            kw.update(spec_h=s,
                      comp_h=make_stream_compressor(comm, "hessian", s))
        return CommRuntime(spec=spec, comp=make_compressor(comm, spec),
                           **kw)

    def runtime_for(self, params) -> CommRuntime:
        """`comm_runtime` of ``params`` under either residency."""
        if self.params_packed(params):
            return self._require_rt()
        spec = flat_spec(params, cols=self.fed.comm.quant_block)
        if self._rt is None or self._rt.spec != spec:
            self._rt = self.comm_runtime(spec)
        return self._rt

    def spec_for(self, params) -> FlatSpec:
        """The wire layout of ``params`` under either residency."""
        return self.runtime_for(params).spec

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        params = self.task.init(generator, self.device)
        return self.init_from_params(params)

    def init_from_params(self, params) -> Dict[str, Any]:
        """A round-0 state around given initial params (weights carried
        over from elsewhere, e.g. `repro_torch.convert`): zero Sophia
        EMAs and EF residuals, and downlink replicas in sync with the
        model."""
        rt = self.runtime_for(params)
        spec = rt.spec
        C = self.fed.num_clients
        comm = self.fed.comm
        dev, dt = self.device, self.state_dtype
        state: Dict[str, Any] = {"params": params, "round": 0}
        if self._stateful():
            state["client_opt"] = SophiaState(
                m=zeros(spec, (C,), self.moment_dtype, device=dev),
                h=zeros(spec, (C,), self.hessian_dtype, device=dev))
        if self.fed.optimizer in FEDOPT:
            state["server_opt"] = {"m": tree_zeros_like(params),
                                   "v": tree_zeros_like(params)}
        if wants_error_feedback(comm):
            state["comm_ef"] = zeros(spec, (C,), dt, device=dev)
        if comm.downlink_enabled:
            theta = store_as(params.to(torch.float32), dt) \
                if self.params_packed(params) else pack(params, spec, dt)
            state.update(downlink.init_state(
                comm, rt.spec_dn, repack(theta, spec, rt.spec_dn), C, dt))
        return state

    def restore_params(self, state, params) -> Dict[str, Any]:
        """Swap restored params into ``state`` (the JAX package's
        ``FedEngine.restore_params``): the EF residuals restart at zero
        and the downlink replicas (and their residuals) re-sync to the
        restored model, since deltas against the old model would be
        garbage.  ``params``: a params dict (packed in ``state_dtype``
        when the state keeps its params packed), or a packed ``(rows,
        cols)`` buffer of the state's layout.  The Sophia EMAs are
        kept."""
        if (self.params_packed(state["params"])
                and not self.params_packed(params)):
            params = pack(params, self.spec_for(params), self.state_dtype)
        state = {**state, "params": params}
        rt = self.runtime_for(params)
        if "comm_ef" in state:
            ef = state["comm_ef"]
            state["comm_ef"] = zeros(rt.spec, ef.shape[:1], ef.dtype,
                                     device=ef.device)
        comm = self.fed.comm
        if comm.downlink_enabled:
            dt = self.state_dtype
            theta = (store_as(params.to(torch.float32), dt)
                     if self.params_packed(params)
                     else pack(params, rt.spec, dt))
            state.update(downlink.init_state(
                comm, rt.spec_dn, repack(theta, rt.spec, rt.spec_dn),
                self.fed.num_clients, dt))
        return state

    # ------------------------------------------- packed-resident boundary
    def pack_state(self, state) -> Dict[str, Any]:
        """Keep ``state["params"]`` (and the FedOpt server m/v) packed
        between rounds too, stored in ``state_dtype``.  Idempotent."""
        params = state["params"]
        if self.params_packed(params):
            return state
        spec, dt = self.spec_for(params), self.state_dtype
        out = {**state, "params": pack(params, spec, dt)}
        if "server_opt" in state:
            out["server_opt"] = {k: pack(v, spec, dt)
                                 for k, v in state["server_opt"].items()}
        return out

    def unpack_state(self, state) -> Dict[str, Any]:
        """Inverse of `pack_state`.  Idempotent on dict-resident state."""
        params = state["params"]
        if not self.params_packed(params):
            return state
        spec = self._require_rt().spec
        out = {**state, "params": unpack(params, spec)}
        if "server_opt" in state:
            out["server_opt"] = {k: unpack(v, spec)
                                 for k, v in state["server_opt"].items()}
        return out

    def unpack_params(self, state):
        """The params dict view of ``state`` under either residency."""
        return self.unpack_state(state)["params"]

    def num_params(self, state) -> int:
        """True model coordinate count (the pad tail never counts)."""
        return self.spec_for(state["params"]).total

    # ------------------------------------------------------ comm plumbing
    def uses_direct_path(self) -> bool:
        """Whether `round` takes the direct client-mean path (lossless
        identity, full participation, no extra streams)."""
        comm = self.fed.comm
        C = self.fed.num_clients
        return (comm.lossless and comm.num_participants(C) == C
                and not comm.multi_stream)

    def round_participants(self, generator: torch.Generator
                           ) -> torch.Tensor:
        """The sorted client ids ``round(state, batches,
        generator=generator)`` trains, without advancing ``generator``."""
        C = self.fed.num_clients
        S = self.fed.comm.num_participants(C)
        if S == C:
            return torch.arange(C, device=self.device)
        saved = generator.get_state()
        ids = participation_sample(generator, C, S)
        generator.set_state(saved)
        return ids.to(self.device)

    def wire_headers(self, params) -> Dict[str, Dict[str, Any]]:
        """Versioned wire headers of every active stream, plus the
        ``client_state`` layout of the flat-resident Sophia state, as
        plain dicts (`repro_torch.comm.flat.check_headers` compares
        them)."""
        rt = self.runtime_for(params)
        out = {"uplink": rt.comp.header().to_dict()}
        if rt.dn_on:
            out["downlink"] = rt.comp_dn.header().to_dict()
        if rt.h_on:
            out["hessian"] = rt.comp_h.header().to_dict()
        if self._stateful():
            out["client_state"] = Header(
                compressor="identity", total=rt.spec.total,
                quant_block=rt.spec.cols,
                state_dtype=self.fed.comm.state_dtype).to_dict()
        return out

    # ------------------------------------------------------------- the round
    def round(self, state, batches, *, generator: torch.Generator = None,
              gumbel: torch.Tensor = None,
              comm_noise: Dict[str, Any] = None):
        """batches: dict of leaves with leading client axis C.  Returns
        ``(state, metrics)``.

        Random inputs come from ``generator`` (drawn on the device) or are
        injected:
          * ``gumbel``: the GNB noise, ``(C, J) + shape`` for
            ``hessian_every_unit="step"`` (index j is local step j),
            ``(C, 1) + shape`` for ``"round"``, where ``shape`` is one
            client's ``task.gumbel_shape`` (``(B, K)`` for the image
            tasks, ``(B, S, Vp)`` for an LM);
          * ``comm_noise``: ``"participants"``, the S sorted client ids
            (needed when S < C); per quantized stream its U[0, 1) noise
            by client id, ``"uplink"`` ``(C, rows, cols)``,
            ``"downlink"`` and ``"hessian"`` in their streams' geometry;
            with the hessian stream, ``"server_hessian"`` ``(rows,
            cols)``, the server's curvature broadcast; under the
            ``random_wire`` attack, ``"attack"``, the gaussian of the
            attacked stack by position, ``(C, rows, cols)`` on the
            direct path and ``(S, rows, cols)`` on the comm path.  The
            direct path reads only ``"attack"``.

        Resident state is updated in place — the Sophia m/h stacks, EF
        residuals and replicas included — the counterpart of the JAX
        round's buffer donation: do not reuse the state passed in;
        rebind the returned one."""
        with annotate(spans.ROUND_SPAN):
            return self._round(state, batches, generator, gumbel,
                               comm_noise)

    def _round(self, state, batches, generator, gumbel, comm_noise):
        fed = self.fed
        round_idx = int(state["round"])
        lr = lr_at_round(fed, round_idx)
        C = fed.num_clients
        n_batch = int(labels_of(batches).shape[0])
        if n_batch != C:
            raise ValueError(f"batches carry {n_batch} clients, the "
                             f"config {C}")
        rt = self.runtime_for(state["params"])
        if self.uses_direct_path():
            noise = self._gumbel_source(batches, generator, gumbel, None)
            state, loss = self._round_direct(
                state, batches, noise, self._attack_source(generator,
                                                           comm_noise),
                round_idx, lr, rt.spec)
        else:
            state, loss = self._round_comm(state, batches, generator,
                                           gumbel, comm_noise, round_idx,
                                           lr, rt)
        state = {**state, "round": round_idx + 1}
        wire = accounting.round_bytes(fed.comm, rt.spec.total, C)
        metrics = {"loss": loss, "lr": lr,
                   "participants": wire["participants"]}
        for k in ("uplink_bytes", "downlink_bytes", "hessian_uplink_bytes",
                  "hessian_downlink_bytes", "total_bytes"):
            metrics[k] = wire[k]
        if fed.obs.probes:
            # reads of the state the round produced, nothing written
            metrics.update(obs_probes.sophia_health(
                state["client_opt"], round_idx, fed, rt.spec.total))
        return state, metrics

    def probe_metrics(self, state) -> Dict[str, torch.Tensor]:
        """The Sophia health probes (`repro_torch.obs.probes`) of a state
        outside `round`, for its last round: the virtual-time scheduler
        applies aggregates itself and probes the state after each."""
        if not self._stateful():
            raise ValueError(
                "probe_metrics reads the persistent Sophia m/h EMAs: it "
                "requires optimizer='fed_sophia' with "
                "persistent_client_state=True")
        rt = self.runtime_for(state["params"])
        return obs_probes.sophia_health(state["client_opt"],
                                        int(state["round"]) - 1, self.fed,
                                        rt.spec.total)

    def _gumbel_source(self, batches, generator, gumbel, ids):
        """``noise(clients, j)`` -> the gumbel noise of GNB draw ``j`` for
        ``clients`` (``slice(None)`` for the cohort, or one position).
        ``ids``: the participants' client ids, None for all C."""
        fed = self.fed
        C = fed.num_clients
        shape = tuple(self.task.gumbel_shape(batches))
        if gumbel is not None:
            draws = 1 if fed.hessian_every_unit == "round" else fed.local_iters
            want = (C, draws) + shape
            if tuple(gumbel.shape) != want:
                raise ValueError(f"gumbel noise has shape "
                                 f"{tuple(gumbel.shape)}, want {want}")
            noise = gumbel.to(self.device, torch.float32)
            if ids is not None:
                noise = noise.index_select(0, ids)
            return lambda clients, j: noise[clients, j]
        if generator is None:
            raise ValueError("round() needs a generator or injected gumbel "
                             "noise for the GNB estimate")
        n = C if ids is None else int(ids.shape[0])

        def draw(clients, j):
            lead = (n,) if isinstance(clients, slice) else ()
            return gumbel_noise(generator, lead + shape, self.device)
        return draw

    def _participants(self, generator, comm_noise) -> Optional[torch.Tensor]:
        """The round's sorted participant ids on the device, or None when
        every client takes part."""
        C = self.fed.num_clients
        S = self.fed.comm.num_participants(C)
        if S == C:
            return None
        if comm_noise is not None and "participants" in comm_noise:
            ids = torch.as_tensor(comm_noise["participants"],
                                  dtype=torch.int64).to(self.device)
            if tuple(ids.shape) != (S,):
                raise ValueError(f"participants has shape "
                                 f"{tuple(ids.shape)}, want ({S},)")
            return ids
        if generator is None:
            raise ValueError("round() needs a generator or injected "
                             "comm_noise['participants']")
        return participation_sample(generator, C, S).to(self.device)

    def _attack_source(self, generator, comm_noise):
        """``noise(shape)`` -> the ``random_wire`` gaussian of an
        attacked stack: ``comm_noise["attack"]`` when injected (its
        shape checked), else a draw from ``generator``."""
        def take(shape):
            if comm_noise is not None and "attack" in comm_noise:
                u = torch.as_tensor(comm_noise["attack"]).to(self.device,
                                                             torch.float32)
                if tuple(u.shape) != tuple(shape):
                    raise ValueError(f"comm_noise['attack'] has shape "
                                     f"{tuple(u.shape)}, want "
                                     f"{tuple(shape)}")
                return u
            if generator is None:
                raise ValueError("the random_wire attack needs a generator "
                                 "or injected comm_noise['attack']")
            return torch.randn(tuple(shape), generator=generator,
                               device=generator.device).to(self.device)
        return take

    def _combine_robust(self, wires, mask, attack_noise):
        """The adversarial combine of a ``(K, rows, cols)`` stack: the
        byzantine rows (``mask``) attacked, then the robust aggregate
        (the plain mean when the aggregator resolves to it)."""
        rb = self.fed.robust
        K = int(wires.shape[0])
        if wire_attack_active(rb, self.fed.num_clients):
            noise = (attack_noise(wires.shape)
                     if rb.attack == "random_wire" else None)
            wires = attack_wires(rb, wires, mask, noise=noise)
        return aggregate_stack(
            rb, wires, torch.ones((K,), dtype=torch.float32,
                                  device=wires.device), normalize=True)

    def _uniform_source(self, rt, generator, comm_noise, ids):
        """``noise(stream, clients)`` -> U[0, 1) noise of ``stream`` for
        ``clients`` (``slice(None)`` for the cohort, or one position);
        ``noise("server_hessian", None)`` is the server's draw.  None for
        a stream that needs no noise: only a `StochasticQuant` stream
        draws (or requires injected) noise, as in the JAX package."""
        C = self.fed.num_clients
        S = C if ids is None else int(ids.shape[0])
        shapes = {}
        for stream, comp, spec in (("uplink", rt.comp, rt.spec),
                                   ("downlink", rt.comp_dn, rt.spec_dn),
                                   ("hessian", rt.comp_h, rt.spec_h)):
            if isinstance(comp, StochasticQuant):
                shapes[stream] = (spec.rows, spec.cols)
        if "hessian" in shapes:
            shapes["server_hessian"] = shapes["hessian"]
        if comm_noise is not None:
            given = {}
            for stream, shape in shapes.items():
                if stream not in comm_noise:
                    raise ValueError(f"comm_noise lacks {stream!r}")
                u = torch.as_tensor(comm_noise[stream]).to(self.device,
                                                           torch.float32)
                lead = () if stream == "server_hessian" else (C,)
                if tuple(u.shape) != lead + shape:
                    raise ValueError(
                        f"comm_noise[{stream!r}] has shape "
                        f"{tuple(u.shape)}, want {lead + shape}")
                if lead and ids is not None:
                    u = u.index_select(0, ids)
                given[stream] = u

            def take(stream, clients):
                if stream not in given:
                    return None
                u = given[stream]
                return u if clients is None else u[clients]
            return take
        if generator is None and shapes:
            raise ValueError("round() needs a generator or injected "
                             "comm_noise for the quantized streams")

        def draw(stream, clients):
            if stream not in shapes:
                return None
            lead = (S,) if isinstance(clients, slice) else ()
            u = torch.rand(lead + shapes[stream], generator=generator,
                           device=generator.device)
            return u.to(self.device)
        return draw

    def _round_direct(self, state, batches, noise, attack_noise, round_idx,
                      lr, spec):
        """Server model <- mean of client params, in wire layout; the
        adversarial fleet (module docstring) acts on the deltas."""
        fed = self.fed
        C = fed.num_clients
        params = state["params"]
        packed = self.params_packed(params)
        with annotate(PACK):
            theta = (params.to(torch.float32) if packed
                     else pack(params, spec))
        opts = state.get("client_opt") if self._stateful() else None
        rb = fed.robust
        adversarial = (wire_attack_active(rb, C)
                       or resolve(rb, C) != "mean")
        out = self._model_out(state)

        if fed.strategy == "parallel":
            new_t, new_opt, losses = self._local_update_flat_batched(
                spec, theta, opts, batches, noise, round_idx, lr)
            if not adversarial:
                with annotate(AGGREGATE):
                    agg_flat = torch.mean(new_t, dim=0, out=out)
        else:
            with annotate(AGGREGATE):
                agg_flat = torch.zeros_like(theta)
            losses, stack = [], []
            for i in range(C):
                opt_i = (None if opts is None
                         else SophiaState(m=opts.m[i], h=opts.h[i]))
                t_i, _, loss = self._local_update_flat(
                    spec, theta, opt_i, {k: v[i] for k, v in batches.items()},
                    lambda j, i=i: noise(i, j), round_idx, lr)
                if adversarial:
                    # trimming needs the whole cohort at once
                    stack.append(t_i)
                else:
                    # the last add, after the last read of theta, into
                    # the resident buffer
                    with annotate(AGGREGATE):
                        agg_flat = torch.add(
                            agg_flat, t_i / C,
                            out=out if i == C - 1 else None)
                losses.append(loss)
                del t_i      # before client i+1 trains
            with annotate(AGGREGATE):
                losses = torch.stack(losses)
                if adversarial:
                    new_t = torch.stack(stack)
            # each client's m/h rows were updated in place in the stack
            new_opt = opts

        if adversarial:
            with annotate(AGGREGATE):
                agg_flat = torch.add(theta, self._combine_robust(
                    new_t - theta, byzantine_mask(rb, C), attack_noise),
                    out=out)
        state = self._server_apply(state, agg_flat, spec, packed)
        if self._stateful():
            # the kernel stored the m/h rows in their own dtypes
            state = {**state, "client_opt": new_opt}
        with annotate(AGGREGATE):
            return state, torch.mean(losses)

    def _round_comm(self, state, batches, generator, gumbel, comm_noise,
                    round_idx, lr, rt):
        """The multi-stream delta-space round (module docstring): with
        the downlink and hessian streams off it is the uplink pipeline
        alone.  Participants' rows are gathered (copies) before training
        and scattered back with ``index_copy_``; at full participation
        the resident stacks are used as they are."""
        fed = self.fed
        C = fed.num_clients
        S = fed.comm.num_participants(C)
        spec = rt.spec
        params = state["params"]
        packed = self.params_packed(params)
        with annotate(PACK):
            theta = (params.to(torch.float32) if packed
                     else pack(params, spec))
            theta_dn = repack(theta, spec, rt.spec_dn) if rt.dn_on else None
        with annotate(COMM):
            ids = self._participants(generator, comm_noise)
        gnb = self._gumbel_source(batches, generator, gumbel, ids)
        uniform = self._uniform_source(rt, generator, comm_noise, ids)
        opts = state.get("client_opt") if self._stateful() else None
        ef = state.get("comm_ef")
        dn_model = state.get(downlink.MODEL_KEY)
        dn_ef = state.get(downlink.EF_KEY)

        def take(x):
            # gathered rows keep their storage dtype
            return x if x is None or ids is None else take_rows(x, ids)

        with annotate(COMM):
            opts_g = (None if opts is None
                      else SophiaState(m=take(opts.m), h=take(opts.h)))
            ef_g, dnm_g, dnef_g = take(ef), take(dn_model), take(dn_ef)
            batches_g = {k: take(v) for k, v in batches.items()}

        # adversarial fleet: attacks act on the participants' uplink
        # wires only; the replica correction and the hessian stream keep
        # their participation means
        rb = fed.robust
        collect = wire_attack_active(rb, C) or resolve(rb, S) != "mean"
        attack_noise = self._attack_source(generator, comm_noise)

        def combine(wires):
            if not collect:
                return torch.sum(wires, dim=0) / S
            # the participants' rows of the byzantine mask, gathered on
            # the device (the host never reads the sampled ids)
            byz = torch.as_tensor(byzantine_mask(rb, C), device=self.device)
            return self._combine_robust(
                wires, byz if ids is None else byz.index_select(0, ids),
                attack_noise)

        if fed.strategy == "parallel":
            cohort = slice(None)
            (wires, stats, ef_new, opt_new, losses, dnm_new, dnef_new,
             h_hat, h_stats) = self.comm_client_step_batched(
                rt, theta, theta_dn, round_idx, lr, opts_g, ef_g, dnm_g,
                dnef_g, batches_g,
                ClientNoise(lambda j: gnb(cohort, j),
                            lambda stream: uniform(stream, cohort)))
            with annotate(AGGREGATE):
                agg = combine(wires)
                wstat = torch.sum(stats) / S
                if rt.dn_on:
                    dn_mean = torch.sum(dnm_new, dim=0) / S
                if rt.h_on:
                    h_agg = torch.sum(h_hat, dim=0) / S
                    h_wstat = torch.sum(h_stats) / S
        else:
            with annotate(AGGREGATE):
                agg = zeros(spec, device=self.device)
                wstat = torch.zeros((), device=self.device)
                dn_mean = (zeros(rt.spec_dn, device=self.device)
                           if rt.dn_on else None)
                if rt.h_on:
                    h_agg = zeros(rt.spec_h, device=self.device)
                    h_wstat = torch.zeros((), device=self.device)
            losses, stack = [], []
            for k in range(S):
                opt_k = (None if opts_g is None
                         else SophiaState(m=opts_g.m[k], h=opts_g.h[k]))
                (wire, stat, ef_k, _, loss, dnm_k, dnef_k, h_hat_k,
                 h_stat_k) = self.comm_client_step(
                    rt, theta, theta_dn, round_idx, lr, opt_k,
                    None if ef_g is None else ef_g[k],
                    None if dnm_g is None else dnm_g[k],
                    None if dnef_g is None else dnef_g[k],
                    {n: v[k] for n, v in batches_g.items()},
                    ClientNoise(lambda j, k=k: gnb(k, j),
                                lambda stream, k=k: uniform(stream, k)))
                with annotate(AGGREGATE):
                    if collect:
                        # robust or attacked: trimming needs the whole
                        # cohort
                        stack.append(wire)
                    else:
                        agg = agg + wire / S
                    wstat = wstat + stat / S
                    # client k's rows are read only by its own step: its
                    # new rows go straight back into the (gathered) stacks
                    for rows, new in ((ef_g, ef_k), (dnm_g, dnm_k),
                                      (dnef_g, dnef_k)):
                        if rows is not None:
                            rows[k].copy_(store_as(new, rows.dtype))
                    if rt.dn_on:
                        dn_mean = dn_mean + dnm_k / S
                    if rt.h_on:
                        h_agg = h_agg + h_hat_k / S
                        h_wstat = h_wstat + h_stat_k / S
                losses.append(loss)
                # client k's outputs go before client k+1 trains
                del wire, ef_k, dnm_k, dnef_k, h_hat_k
            with annotate(AGGREGATE):
                losses = torch.stack(losses)
                if collect:
                    agg = combine(torch.stack(stack))
            # the m/h rows were updated in place in the (gathered) stacks
            ef_new, opt_new, dnm_new, dnef_new = ef_g, opts_g, dnm_g, dnef_g

        with annotate(COMM):
            agg = rt.comp.server_combine(agg, wstat)
        with annotate(AGGREGATE):
            if rt.dn_on:
                # clients trained from their OWN replicas: the aggregate
                # is mean_S(replica + decoded delta), written as a
                # correction against the true server model
                agg = agg + repack(dn_mean - theta_dn, rt.spec_dn, spec)
            # theta's last read: the new model goes into the resident
            # buffer
            new_theta = torch.add(theta, agg, out=self._model_out(state))
        state = self._server_apply(state, new_theta, spec, packed)

        def scatter(full, rows):
            # rows stored back in the resident dtype
            if ids is None:
                return store_as(rows, full.dtype)
            return put_rows_(full, ids, rows)

        if opts is not None:
            with annotate(AGGREGATE):
                h = scatter(opts.h, opt_new.h)
            if rt.h_on:
                # curvature averaging: every participant's h re-synced to
                # the re-quantized common broadcast
                with annotate(COMM):
                    h_down, _ = rt.comp_h.roundtrip(
                        uniform("server_hessian", None),
                        rt.comp_h.server_combine(h_agg, h_wstat))
                    h_common = store_as(repack(h_down, rt.spec_h, spec),
                                        h.dtype)
                    h_common = h_common.expand((S,) + tuple(h_common.shape))
                    if ids is None:
                        h.copy_(h_common)
                    else:
                        put_rows_(h, ids, h_common)
            with annotate(AGGREGATE):
                state = {**state, "client_opt": SophiaState(
                    m=scatter(opts.m, opt_new.m), h=h)}
        with annotate(AGGREGATE):
            for key, full, rows in (("comm_ef", ef, ef_new),
                                    (downlink.MODEL_KEY, dn_model, dnm_new),
                                    (downlink.EF_KEY, dn_ef, dnef_new)):
                if full is not None:
                    state = {**state, key: scatter(full, rows)}
            return state, torch.mean(losses)

    # ----------------------------------------------- comm-path client step
    def comm_client_step(self, rt: CommRuntime, theta, theta_dn, round_idx,
                         lr, opt, ef_i, dnm_i, dnef_i, batch,
                         noise: ClientNoise):
        """One participant's comm-path step: downlink broadcast (replica
        update) -> local training from the received model -> uplink
        encode [-> hessian-EMA round-trip].

        ``theta``: the packed server model (``rt.spec``); ``theta_dn``:
        the same coordinates in the downlink geometry (None when that
        stream is off).  ``opt`` (m/h) is updated in place; ``ef_i``,
        ``dnm_i``, ``dnef_i`` are read, not written.  Returns ``(xhat,
        stat, ef_new, opt_new, loss, dnm_new, dnef_new, h_hat, h_stat)``
        with None for inactive pieces."""
        if rt.dn_on:
            with annotate(COMM):
                dnm_i, dnef_i = downlink.broadcast(
                    rt.comp_dn, noise.uniform("downlink"), theta_dn, dnm_i,
                    dnef_i)
            with annotate(PACK):
                start = repack(dnm_i, rt.spec_dn, rt.spec)
        else:
            start = theta
        t_i, opt_i, loss = self._local_update_flat(
            rt.spec, start, opt, batch, noise.gumbel, round_idx, lr)
        with annotate(COMM):
            xhat, stat, ef_new = rt.comp.encode_delta(
                noise.uniform("uplink"), t_i, start, ef_i)
        h_hat = h_stat = None
        if rt.h_on:
            with annotate(PACK):
                h32 = repack(opt_i.h, rt.spec, rt.spec_h).to(torch.float32)
            with annotate(COMM):
                h_hat, h_stat = rt.comp_h.roundtrip(noise.uniform("hessian"),
                                                    h32)
        return (xhat, stat, ef_new, opt_i, loss,
                dnm_i if rt.dn_on else None, dnef_i, h_hat, h_stat)

    def comm_client_step_batched(self, rt: CommRuntime, theta, theta_dn,
                                 round_idx, lr, opts, efs, dnms, dnefs,
                                 batches, noise: ClientNoise):
        """`comm_client_step` for the whole cohort: every per-client
        argument carries a leading client axis N (None when off), and
        ``theta`` / ``theta_dn`` stay the one shared server model.  Each
        stage — downlink broadcast, each local Sophia iteration, uplink
        encode, the hessian round-trip — is ONE client-batched kernel
        launch.  Returns the 9-tuple of `comm_client_step`, stacked
        along clients.

        With ``SchedConfig.dispatch_chunk`` set below N the cohort runs
        as chunks of that many clients, then one tail
        (`_comm_client_step_chunked`)."""
        chunk = self.fed.sched.dispatch_chunk
        if 0 < chunk < int(labels_of(batches).shape[0]):
            return self._comm_client_step_chunked(
                rt, theta, theta_dn, round_idx, lr, opts, efs, dnms, dnefs,
                batches, noise, chunk)
        if rt.dn_on:
            with annotate(COMM):
                dnms, dnefs = downlink.broadcast_batched(
                    rt.comp_dn, noise.uniform("downlink"), theta_dn, dnms,
                    dnefs)
            with annotate(PACK):
                starts = repack(dnms, rt.spec_dn, rt.spec)
        else:
            starts = theta
        t, opt, losses = self._local_update_flat_batched(
            rt.spec, starts, opts, batches, lambda _, j: noise.gumbel(j),
            round_idx, lr)
        with annotate(COMM):
            xhat, stats, ef_new = rt.comp.encode_delta_batched(
                noise.uniform("uplink"), t, starts, efs)
        h_hat = h_stats = None
        if rt.h_on:
            with annotate(PACK):
                h32 = repack(opt.h, rt.spec, rt.spec_h).to(torch.float32)
            with annotate(COMM):
                h_hat, h_stats = rt.comp_h.roundtrip_batched(
                    noise.uniform("hessian"), h32)
        return (xhat, stats, ef_new, opt, losses,
                dnms if rt.dn_on else None, dnefs, h_hat, h_stats)

    def _comm_client_step_chunked(self, rt: CommRuntime, theta, theta_dn,
                                  round_idx, lr, opts, efs, dnms, dnefs,
                                  batches, noise: ClientNoise, chunk: int):
        """`comm_client_step_batched` over an N-client cohort as chunks
        of ``chunk`` clients (full chunks, then one tail), each one
        batched step over its rows; the outputs are concatenated along
        clients.  Every stage is elementwise per client row, so the
        result is the unchunked step's.  The cohort's noise is drawn
        whole, in the unchunked step's order, at its first use (a
        generator's stream is consumed as without chunking), and each
        chunk reads its rows.  ``opts`` is updated in place through
        views of its rows."""
        n = int(labels_of(batches).shape[0])
        gumbel: Dict[int, torch.Tensor] = {}
        uniform: Dict[str, Optional[torch.Tensor]] = {}

        def whole_gumbel(j):
            if j not in gumbel:
                gumbel[j] = noise.gumbel(j)
            return gumbel[j]

        def whole_uniform(stream):
            if stream not in uniform:
                uniform[stream] = noise.uniform(stream)
            return uniform[stream]

        outs = []
        for lo in range(0, n, chunk):
            rows = slice(lo, min(lo + chunk, n))

            def take(x, rows=rows):
                return None if x is None else x[rows]

            opts_c = (None if opts is None
                      else SophiaState(m=opts.m[rows], h=opts.h[rows]))
            outs.append(self.comm_client_step_batched(
                rt, theta, theta_dn, round_idx, lr, opts_c, take(efs),
                take(dnms), take(dnefs),
                {k: v[rows] for k, v in batches.items()},
                ClientNoise(lambda j, rows=rows: whole_gumbel(j)[rows],
                            lambda st, take=take: take(whole_uniform(st)))))

        def cat(parts):
            if parts[0] is None:
                return None
            if isinstance(parts[0], SophiaState):
                return SophiaState(m=cat_rows([p.m for p in parts]),
                                   h=cat_rows([p.h for p in parts]))
            return cat_rows(parts)
        with annotate(PACK):
            return tuple(cat(list(p)) for p in zip(*outs))

    # ------------------------------------------------- one client, dispatch
    def _local_update_flat(self, spec, theta, opt, batch, noise, round_idx,
                           lr):
        """One client's local training.  ``theta``: the ``(rows, cols)``
        start model (not written); ``opt``: a `SophiaState` of ``(rows,
        cols)`` buffers, updated in place, or None.  ``noise(j)`` gives
        GNB draw j.  Returns ``(new_theta, new_opt_or_None,
        mean_loss)``."""
        fed = self.fed
        if fed.optimizer == "fed_sophia":
            if opt is None:   # stateless: fresh EMAs each round
                with annotate(OPTIMIZER):
                    opt = SophiaState(m=zeros(spec, device=theta.device),
                                      h=zeros(spec, device=theta.device))
            t, m, h, loss = self._local_sophia_flat(
                spec, theta, opt.m, opt.h, batch, round_idx, noise, lr)
            opt = SophiaState(m=m, h=h)
            return t, (opt if fed.persistent_client_state else None), loss
        if fed.optimizer == "done":
            t, loss = self._local_done_flat(spec, theta, batch, lr)
            return t, None, loss
        # fedavg and the FedOpt baselines train local SGD
        t, loss = self._local_sgd_flat(spec, theta, batch, lr)
        return t, None, loss

    def _local_update_flat_batched(self, spec, theta, opts, batches, noise,
                                   round_idx, lr):
        """`_local_update_flat` for a cohort of N clients: per-client
        state carries a leading client axis N; ``theta`` is the shared
        ``(rows, cols)`` start model or a per-client ``(N, rows, cols)``
        stack (downlink replicas), never written; ``noise(clients,
        j)``."""
        fed = self.fed
        N = int(labels_of(batches).shape[0])
        if fed.optimizer == "fed_sophia":
            if opts is None:   # stateless: fresh EMAs each round
                with annotate(OPTIMIZER):
                    opts = SophiaState(
                        m=zeros(spec, (N,), device=theta.device),
                        h=zeros(spec, (N,), device=theta.device))
            t, m, h, loss = self._local_sophia_flat_batched(
                spec, theta, opts.m, opts.h, batches, round_idx, noise, lr)
            opt = SophiaState(m=m, h=h)
            return t, (opt if fed.persistent_client_state else None), loss
        if fed.optimizer == "done":
            with annotate(PACK):
                start = self._cohort_start(theta, N)
            t, loss = self._local_done_flat(spec, start, batches, lr)
            return t, None, loss
        t, loss = self._local_sgd_flat_batched(spec, theta, batches, lr)
        return t, None, loss

    # ------------------------------------------- local client training (flat)
    def _flat_value_and_grad(self, theta, batch, spec):
        """The loss/grad boundary: ONE unpack view feeds autograd, ONE
        pack lays the grads back.  ``theta`` may carry a leading client
        axis; each client's grads then come from its own loss.  With
        ``grad_microbatches`` n > 1, ``loss / n`` and ``grads / n`` are
        summed over the batch's n slices in order (the JAX engine's
        ``_value_and_grad``).  Also returns the params view for the GNB
        refresh."""
        with annotate(PACK):
            pg = {k: v.detach().requires_grad_(True)
                  for k, v in unpack(theta, spec).items()}
        loss, grads = value_and_grads(self.task.loss, pg, batch,
                                      self.fed.grad_microbatches, LOSS_GRAD)
        with annotate(PACK):
            return loss, pack(dict(zip(spec.keys, grads)), spec), pg

    def _leaf_value_and_grad(self, params, batch):
        """The loss/grad boundary on the leaf route: the forward reads
        the leaves ``params`` (the Sophia step keeps them), and the grads
        stay autograd's leaves, as the step reads them.  Returns
        ``(loss, grads, params view for the GNB refresh)``."""
        pg = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, grads = value_and_grads(self.task.loss, pg, batch,
                                      self.fed.grad_microbatches, LOSS_GRAD)
        return loss, dict(zip(pg, grads)), pg

    def _gnb(self, params, batch, noise, j):
        """The GNB estimate of ``params`` from gumbel draw ``j``
        (micro-batched as the loss/grad boundary is); the draw is freed
        when it returns."""
        with annotate(GNB):
            gumbel = noise(j)
        return gnb_estimate(self.task, params, batch, gumbel,
                            self.fed.grad_microbatches)

    def _sophia_loop(self, spec, t, m, h, batch, round_idx, noise, lr):
        """The J local Sophia iterations over the buffers ``t``, ``m``,
        ``h`` (one client ``(rows, cols)``, or a cohort ``(N, rows,
        cols)``), updated in place.  Returns the per-step losses.

        On the leaf route (`takes_leaves`: fp32 m and h) the params
        leaves are cast from ``t`` once, and each step's kernel reads
        the grads and h_hat as autograd's leaves and stores the next
        step's params leaves (not after the last step: no forward reads
        them); fp32 leaves are views of ``t``, which the step writes.
        Otherwise each step unpacks ``t`` and packs the grads and
        h_hat."""
        fed = self.fed
        with annotate(GNB):
            no_hh = torch.zeros_like(t)
        leafy = takes_leaves(t, m, h)
        stores = None
        if leafy:
            with annotate(PACK):
                params = leaves_of(t, spec)
            stores = {k: v for k, v in params.items()
                      if v.dtype != t.dtype}
        # round mode (Alg. 1 line 9 literal): the GNB estimate uses the
        # round-start params, once per refresh round
        round_mode = fed.hessian_every_unit == "round"
        if round_mode:
            do_h_round = round_idx % fed.tau == 0
            hh_round = no_hh
            if do_h_round:
                if leafy:
                    hh_round = self._gnb(params, batch, noise, 0)
                else:
                    with annotate(PACK):
                        p0 = unpack(t, spec)
                    h0 = self._gnb(p0, batch, noise, 0)
                    del p0               # before the pack, as it was
                    with annotate(PACK):
                        hh_round = pack(h0, spec)
                    del h0
        losses = []
        for j in range(fed.local_iters):
            if leafy:
                loss, g, pg = self._leaf_value_and_grad(params, batch)
            else:
                loss, g, pg = self._flat_value_and_grad(t, batch, spec)
            if round_mode:
                do_h = do_h_round and j == 0   # EMA applied once per refresh
                hh = hh_round
            else:
                do_h = (round_idx * fed.local_iters + j) % fed.tau == 0
                hh = no_hh
                if do_h:
                    hh = self._gnb(pg, batch, noise, j)
                    if not leafy:
                        with annotate(PACK):
                            hh = pack(hh, spec)
            # in place: the engine owns t, and m/h are the resident EMAs
            # (the counterpart of the JAX round's buffer donation)
            last = j == fed.local_iters - 1
            with annotate(OPTIMIZER):
                sophia_step_flat(
                    t, m, h, g, hh, do_h, lr=lr, beta1=fed.beta1,
                    beta2=fed.beta2, rho=fed.rho, eps=fed.eps,
                    weight_decay=fed.weight_decay, inplace=True, spec=spec,
                    leaves=None if last else stores)
            losses.append(loss)
            # this step's grads and params view go before the next
            # step's are made (two of each would coexist: gigabytes at
            # an LM's size)
            del g, pg, hh
        with annotate(AGGREGATE):
            return torch.stack(losses)

    def _local_sophia_flat(self, spec, theta, m, h, batch, round_idx, noise,
                           lr):
        """Flat-resident Sophia local loop of one client."""
        with annotate(PACK):
            t = theta.clone()      # theta is not the engine's to write
        losses = self._sophia_loop(spec, t, m, h, batch, round_idx, noise,
                                   lr)
        with annotate(AGGREGATE):
            return t, m, h, torch.mean(losses)

    @staticmethod
    def _cohort_start(theta, n: int) -> torch.Tensor:
        """A writable ``(n, rows, cols)`` copy of the start model(s): the
        kernel writes the stack in place, and neither the shared model
        nor a per-client stack (the replicas) is the loop's to write.  A
        new tensor in every case: ``expand(...).contiguous()`` of one
        client (n=1) would be a view of ``theta`` itself, as a size-1
        axis counts as contiguous whatever its stride."""
        if theta.ndim == 3:
            return theta.clone()
        return theta.unsqueeze(0).repeat(n, 1, 1)

    def _local_sophia_flat_batched(self, spec, theta, m, h, batches,
                                   round_idx, noise, lr):
        """`_local_sophia_flat` for N clients at once: one batched kernel
        launch per local iteration over the ``(N, rows, cols)``
        stacks."""
        with annotate(PACK):
            t = self._cohort_start(theta, m.shape[0])
        cohort = slice(None)
        losses = self._sophia_loop(spec, t, m, h, batches, round_idx,
                                   lambda j: noise(cohort, j), lr)
        with annotate(AGGREGATE):
            return t, m, h, torch.mean(losses, dim=0)

    def _local_sgd_flat(self, spec, theta, batch, lr):
        """Flat-resident local SGD: the update is one flat axpy."""
        t = theta
        losses = []
        for _ in range(self.fed.local_iters):
            loss, g, _ = self._flat_value_and_grad(t, batch, spec)
            with annotate(OPTIMIZER):
                t = t - lr * g
            losses.append(loss)
        with annotate(AGGREGATE):
            return t, torch.mean(torch.stack(losses), dim=0)

    def _local_sgd_flat_batched(self, spec, theta, batches, lr):
        """`_local_sgd_flat` for N clients at once."""
        with annotate(PACK):
            t = self._cohort_start(theta, int(labels_of(batches).shape[0]))
        return self._local_sgd_flat(spec, t, batches, lr)

    # ------------------------------------------------------- DONE (local)
    def _local_done_flat(self, spec, theta, batch, lr):
        """DONE: one approximate Newton step ``theta - lr * cap * d`` with
        ``d ~= (H + damping I)^-1 g`` by damped Richardson iteration on
        Hessian-vector products (the JAX package's ``_local_done``).
        ``theta``: one client's ``(rows, cols)`` model, or a cohort's
        ``(N, rows, cols)`` stack (not written).  Every norm, ``lmax``,
        the step size ``alpha`` and the trust-region cap are per client.

        Per client: ``alpha = 0.9 / (lmax + damping)`` with ``lmax`` the
        last of 5 power iterations from ``g / |g|`` (Richardson needs
        ``alpha (lmax + damping) < 2``, and non-IID clients differ
        wildly in curvature); ``done_richardson_iters`` steps ``d += alpha
        (g - H d - damping d)`` from ``d = 0``; the step capped at
        ``min(1, 10 |g| / |d|)`` (indefinite local Hessians can blow the
        solve up).  HVPs by double backward through the loss's gradient;
        whole batches (the JAX engine calls ``jax.value_and_grad`` here,
        not its micro-batched form).  Returns ``(new_theta,
        loss)``."""
        fed = self.fed
        lead = theta.ndim - 2
        with annotate(PACK):
            params = {k: v.detach().requires_grad_(True)
                      for k, v in unpack(theta, spec).items()}
        keys = list(spec.keys)           # sorted: the JAX leaf order
        leaves = [params[k] for k in keys]
        loss, g = value_and_grads(self.task.loss, params, batch, 1,
                                  LOSS_GRAD, create_graph=True)
        g0 = [x.detach() for x in g]
        # the grads with a graph: an unreached leaf's zeros have none,
        # and add nothing to a product
        live = [i for i, x in enumerate(g) if x.requires_grad]

        def hvp(d):
            hd = torch.autograd.grad([g[i] for i in live], leaves,
                                     grad_outputs=[d[i] for i in live],
                                     retain_graph=True, allow_unused=True)
            return [torch.zeros_like(x) if y is None else y.detach()
                    for x, y in zip(d, hd)]

        def norm(tree):
            # sqrt(sum over leaves, in order, of each client's vdot)
            sq = 0
            for x in tree:
                sq = sq + torch.sum(x * x, dim=tuple(range(lead, x.ndim)))
            return torch.sqrt(sq)

        def per_client(s, x):
            return s.reshape(s.shape + (1,) * (x.ndim - lead))

        # the products' backwards run on the autograd engine's thread:
        # this range's device extent, from its first kernel launched here
        # to its last, holds them
        with annotate(LOSS_GRAD):
            gn = norm(g0)
            v = [x / per_client(gn + 1e-12, x) for x in g0]
            for _ in range(5):
                hv = hvp(v)
                nrm = norm(hv) + 1e-12
                v = [x / per_client(nrm, x) for x in hv]
            alpha = 0.9 / (nrm + fed.done_damping)
            d = [torch.zeros_like(x) for x in g0]
            for _ in range(fed.done_richardson_iters):
                hd = hvp(d)
                d = [dd + per_client(alpha, dd) * ((gg - hh)
                                                   - fed.done_damping * dd)
                     for dd, gg, hh in zip(d, g0, hd)]
            cap = torch.clamp(10.0 * gn / (norm(d) + 1e-12), max=1.0)
        with annotate(OPTIMIZER):
            step = lr * cap
            new = {k: (params[k].detach() - per_client(step, dd) * dd)
                   for k, dd in zip(keys, d)}
        with annotate(PACK):
            return pack(new, spec), loss

    # ----------------------------------------------------- the server step
    def _server_apply(self, state, agg_flat, spec, packed):
        """A round's server step on its fp32 aggregate ``agg_flat``: into
        the resident buffers of packed state, else on the params dict."""
        if packed:
            return self._apply_aggregate_flat(state, agg_flat, in_place=True)
        with annotate(PACK):
            agg = unpack(agg_flat, spec)
        return self._apply_aggregate(state, agg)

    def _apply_aggregate(self, state, agg):
        """The server step on the aggregated params dict ``agg``: FedOpt
        applies Adam / Yogi to the pseudo-gradient, everything else
        takes ``agg`` as the new model."""
        if self.fed.optimizer in FEDOPT:
            with annotate(AGGREGATE):
                return self._server_opt_update(state, agg)
        return {**state, "params": agg}

    def _model_out(self, state):
        """Where a round computes its new model: the packed-resident
        params buffer when the aggregate is the model in its dtype (fp32,
        no FedOpt), so the round adds no pass to store it (the JAX
        round's donation); else None, a new buffer."""
        params = state["params"]
        if (self.params_packed(params) and params.dtype == torch.float32
                and self.fed.optimizer not in FEDOPT):
            return params
        return None

    def _apply_aggregate_flat(self, state, agg_flat, in_place=False):
        """`_apply_aggregate` for packed-resident state: ``agg_flat`` the
        fp32 aggregate in wire layout, the new model stored in the
        resident dtype.  ``in_place`` (the engine's rounds, whose state
        is not reused): into the resident buffers themselves, ``agg_flat``
        already the params buffer where `_model_out` gave it; else (the
        scheduler's apply, whose in-flight clients read the old model)
        into new buffers."""
        with annotate(AGGREGATE):
            if self.fed.optimizer in FEDOPT:
                return self._server_opt_update_flat(state, agg_flat,
                                                    in_place)
            if in_place:
                store_into(state["params"], agg_flat)
                return state
            return {**state,
                    "params": store_as(agg_flat, state["params"].dtype)}

    def _server_step(self, p, m0, v0, agg, out=(None, None, None)):
        """Adam / Yogi over one fp32 buffer, the JAX operation order:
        ``delta = p - agg``; ``m = b1 m + (1 - b1) delta``; Adam ``v = b2
        v + (1 - b2) delta^2``, Yogi ``v = v - (1 - b2) delta^2
        sign(v - delta^2)``; ``p - lr m / (sqrt(v) + eps)``.  ``out``:
        the buffers (or None) that the new p, m and v are written into
        by each one's last op, after its old value's last read."""
        fed = self.fed
        p_out, m_out, v_out = out
        delta = p - agg
        m = torch.add(fed.server_beta1 * m0, (1 - fed.server_beta1) * delta,
                      out=m_out)
        if fed.optimizer == "fedadam":
            v = torch.add(fed.server_beta2 * v0,
                          (1 - fed.server_beta2) * delta * delta, out=v_out)
        else:
            v = torch.sub(v0, ((1 - fed.server_beta2) * delta * delta
                               * sign(v0 - delta * delta)), out=v_out)
        return torch.sub(p, fed.server_lr * m / (torch.sqrt(v)
                                                 + fed.server_eps),
                         out=p_out), m, v

    def _server_opt_update(self, state, agg):
        """FedOpt over parameter dicts (server m/v in the params' form);
        the new params stored in their own dtypes."""
        so, params = state["server_opt"], state["params"]
        out = {k: self._server_step(p, so["m"][k], so["v"][k], agg[k])
               for k, p in params.items()}
        return {**state,
                "params": {k: store_as(o[0], params[k].dtype)
                           for k, o in out.items()},
                "server_opt": {"m": {k: o[1] for k, o in out.items()},
                               "v": {k: o[2] for k, o in out.items()}}}

    def _server_opt_update_flat(self, state, agg, in_place=False):
        """FedOpt over packed buffers: fp32 compute, each buffer stored
        back in its resident dtype; ``in_place``: into the resident
        buffers (an fp32 one written by its last op)."""
        so = state["server_opt"]
        bufs = (state["params"], so["m"], so["v"])
        out = [b if in_place and b.dtype == torch.float32 else None
               for b in bufs]
        new = self._server_step(*[x.to(torch.float32) for x in bufs], agg,
                                out=out)
        if in_place:
            for b, x in zip(bufs, new):
                store_into(b, x)
            return state
        p, m, v = new
        return {**state, "params": store_as(p, state["params"].dtype),
                "server_opt": {"m": store_as(m, so["m"].dtype),
                               "v": store_as(v, so["v"].dtype)}}
