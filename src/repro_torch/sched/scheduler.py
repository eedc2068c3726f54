"""Virtual-time event scheduler over `FedEngine` (the port of the JAX
package's ``repro/sched/scheduler.py``).

A deterministic discrete-event simulator: the virtual clock is host
arithmetic over the latency model (`repro_torch.sched.latency`), while
the model math runs through the engine's own comm-path client step
(`FedEngine.comm_client_step_batched`), one dispatch group at a time
through the client-batched kernels.

Disciplines (``SchedConfig.discipline``):

* ``sync``     — each event is one `FedEngine.round`; the event takes as
  long as the round's slowest participant.
* ``semisync`` — FedBuff-style buffered aggregation: the first
  ``buffer_size`` arrivals form the round; the server applies their
  staleness-weighted mean and re-dispatches them, while stragglers
  deliver stale deltas into a later buffer.
* ``async``    — every arrival is applied at once with the unnormalised
  weight ``(1 + staleness)^-staleness_power``.

Staleness of an arrival is the number of server versions applied
between its dispatch and its arrival.  A client dispatched at version
``v`` trains with ``round_idx = v``.

The apply step combines the ``(K, rows, cols)`` arrival stack with the
stale-accumulate kernel (`repro_torch.kernels.stale_accum`):
``(1/wsum) * sum_k w_k x_k`` for semisync, the weighted sum for async
(the JAX package's kernel route; its plain route computes
``sum_k w_k x_k / wsum``, equal only where the reciprocal is exact), or,
with a non-degenerate `RobustConfig` aggregator, with the robust-combine
kernel.  ``wsum`` is summed on the host in ascending order.

Randomness (the RNG seam): the participants of version 0 and of each
sync round, and per dispatch group its GNB gumbel noise, the U[0, 1)
noise of its quantized streams and the ``random_wire`` gaussian, come
from a `torch.Generator`, or from an injected ``draws(version,
client_ids)`` source (`VirtualScheduler.run`).  Everything the clock
decides (latencies, arrival order, buffers, staleness, churn) is host
arithmetic on the configured seeds, equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import accounting
from repro_torch.comm import downlink as cdown
from repro_torch.comm.compressors import (StochasticQuant,
                                          participation_sample)
from repro_torch.comm.flat import pack, repack, unpack
from repro_torch.configs.base import SCHED_DISCIPLINES
from repro_torch.core.fed import ClientNoise
from repro_torch.core.schedules import lr_at_round
from repro_torch.core.sophia import SophiaState
from repro_torch.kernels.stale_accum import stale_accum_flat
from repro_torch.metrics import energy
from repro_torch.models.small import gumbel_noise
from repro_torch.obs.spans import PROBE_METRICS, SpanLog
from repro_torch.robust import aggregators as robust_agg
from repro_torch.robust import attacks as robust_attacks
from repro_torch.sched import latency

#: ``draws(version, client_ids) -> dict``, the injected randomness of a
#: run (`VirtualScheduler.run`)
Draws = Callable[[int, Optional[List[int]]], Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class SchedEvent:
    """One aggregation event of the virtual clock.

    Byte counters are EXACT Python ints from the accounting model
    (`repro_torch.comm.accounting.stream_bytes`) — ``cum_bytes`` is the
    all-streams total and always equals the sum of the four per-stream
    counters; ``probes`` holds the Sophia health scalars of a record
    that carries them (the port does not compute them yet)."""
    time: float               # virtual seconds at which it was applied
    version: int              # server model version it produced
    kind: str                 # "round" (sync) | "aggregate"
    clients: Tuple[int, ...]  # arrivals folded into this event
    staleness: Tuple[int, ...]
    weights: Tuple[float, ...]
    loss: float               # mean local-training loss of the arrivals
    cum_bytes: int            # cumulative wire bytes, all streams
    eval_loss: Optional[float] = None
    # exact cumulative per-stream wire bytes (all = 0 only before the
    # first dispatch)
    cum_uplink_bytes: int = 0
    cum_downlink_bytes: int = 0
    cum_hessian_uplink_bytes: int = 0
    cum_hessian_downlink_bytes: int = 0
    probes: Optional[Dict[str, float]] = None
    # trace ids of the arrivals folded into this event, aligned with
    # ``clients`` — populated only under ``ObsConfig.trace``
    trace_ids: Tuple[int, ...] = ()
    # adversarial-fleet context (repro_torch.robust): the *effective*
    # aggregator that combined this event's arrivals, the wire attack
    # in play, the byzantine arrivals among ``clients``, and the
    # arrivals that were dropout/rejoin deliveries — all defaults
    # (hence absent from records) for non-adversarial runs
    aggregator: str = "mean"
    attack: str = "none"
    byzantine: Tuple[int, ...] = ()
    dropped: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class SchedDispatch:
    """One dispatch's trace context (``ObsConfig.trace``): the
    compute -> transfer -> arrival chain of a single client on the
    virtual clock, with its exact per-leg byte prices.

    Leg durations come from `latency.dispatch_legs` — a decomposition
    of the lumped `latency.dispatch_seconds` the clock runs on, so
    their sum may differ from ``arrival - time`` in the last ulps;
    ``arrival`` is authoritative."""
    trace_id: int             # unique per run, 1-based, dispatch order
    client: int
    version: int              # server version it trained against
    time: float               # virtual seconds at dispatch
    arrival: float            # virtual seconds at delivery
    compute_s: float
    downlink_s: float
    uplink_s: float
    downlink_bytes: int = 0
    uplink_bytes: int = 0
    hessian_uplink_bytes: int = 0
    hessian_downlink_bytes: int = 0

    def to_record(self) -> Dict[str, Any]:
        return {
            "record": "sched_dispatch", "trace_id": self.trace_id,
            "client": self.client, "version": self.version,
            "time_s": self.time, "arrival_s": self.arrival,
            "compute_s": self.compute_s,
            "downlink_s": self.downlink_s, "uplink_s": self.uplink_s,
            "downlink_bytes": self.downlink_bytes,
            "uplink_bytes": self.uplink_bytes,
            "hessian_uplink_bytes": self.hessian_uplink_bytes,
            "hessian_downlink_bytes": self.hessian_downlink_bytes}

    @staticmethod
    def from_record(r: Dict[str, Any]) -> "SchedDispatch":
        return SchedDispatch(
            trace_id=r["trace_id"], client=r["client"],
            version=r["version"], time=r["time_s"],
            arrival=r["arrival_s"], compute_s=r["compute_s"],
            downlink_s=r["downlink_s"], uplink_s=r["uplink_s"],
            downlink_bytes=r.get("downlink_bytes", 0),
            uplink_bytes=r.get("uplink_bytes", 0),
            hessian_uplink_bytes=r.get("hessian_uplink_bytes", 0),
            hessian_downlink_bytes=r.get("hessian_downlink_bytes", 0))


@dataclasses.dataclass
class SchedTrace:
    """The full event log of one scheduler run."""
    discipline: str
    events: List[SchedEvent] = dataclasses.field(default_factory=list)
    # per-dispatch trace contexts (empty unless ``ObsConfig.trace``)
    dispatches: List[SchedDispatch] = dataclasses.field(
        default_factory=list)

    @property
    def final_time(self) -> float:
        return self.events[-1].time if self.events else 0.0

    @property
    def total_bytes(self) -> int:
        return self.events[-1].cum_bytes if self.events else 0

    def _target_event(self, target_loss: float) -> Optional[SchedEvent]:
        for ev in self.events:
            loss = ev.eval_loss if ev.eval_loss is not None else ev.loss
            if loss <= target_loss:
                return ev
        return None

    def time_to_target(self, target_loss: float) -> Optional[float]:
        """Virtual seconds until the (eval) loss first reached target."""
        ev = self._target_event(target_loss)
        return None if ev is None else ev.time

    def bytes_to_target(self, target_loss: float) -> Optional[int]:
        ev = self._target_event(target_loss)
        return None if ev is None else ev.cum_bytes

    def staleness_hist(self) -> Dict[int, int]:
        """staleness value -> arrival count, over the whole run (the
        per-discipline staleness histogram)."""
        hist: Dict[int, int] = {}
        for ev in self.events:
            for t in ev.staleness:
                hist[t] = hist.get(t, 0) + 1
        return hist

    def to_records(self, channel=None) -> List[Dict[str, Any]]:
        """The trace as obs schema records: one ``sched_event`` per
        event (plus its probe scalars, when present) and one final
        ``sched_summary`` with the staleness histogram.  With a
        `repro_torch.metrics.energy.ChannelModel`, each event also carries
        the transmission energy/carbon of its byte DELTA at the
        Shannon rate.  `from_records` inverts this exactly."""
        recs: List[Dict[str, Any]] = []
        prev_bytes = 0
        for ev in self.events:
            r: Dict[str, Any] = {
                "record": "sched_event", "time_s": ev.time,
                "version": ev.version, "kind": ev.kind,
                "clients": list(ev.clients),
                "staleness": list(ev.staleness),
                "weights": list(ev.weights), "loss": ev.loss,
                "cum_uplink_bytes": ev.cum_uplink_bytes,
                "cum_downlink_bytes": ev.cum_downlink_bytes,
                "cum_hessian_uplink_bytes": ev.cum_hessian_uplink_bytes,
                "cum_hessian_downlink_bytes":
                    ev.cum_hessian_downlink_bytes,
                "cum_total_bytes": ev.cum_bytes}
            if ev.eval_loss is not None:
                r["eval_loss"] = ev.eval_loss
            if channel is not None:
                r["energy_J"] = energy.tx_energy_joules(
                    ev.cum_bytes - prev_bytes, channel)
                r["carbon_kg"] = energy.footprint_kg_co2(r["energy_J"])
            prev_bytes = ev.cum_bytes
            if ev.probes:
                r.update(ev.probes)
            if ev.trace_ids:
                r["trace_ids"] = list(ev.trace_ids)
            if ev.aggregator != "mean":
                r["aggregator"] = ev.aggregator
            if ev.attack != "none":
                r["attack"] = ev.attack
            if ev.byzantine:
                r["byzantine_clients"] = list(ev.byzantine)
            if ev.dropped:
                r["dropped_clients"] = list(ev.dropped)
            recs.append(r)
        recs.extend(d.to_record() for d in self.dispatches)
        recs.append({
            "record": "sched_summary", "discipline": self.discipline,
            "events": len(self.events), "final_time_s": self.final_time,
            "cum_total_bytes": self.total_bytes,
            "staleness_hist": [[k, v] for k, v in
                               sorted(self.staleness_hist().items())]})
        return recs

    @staticmethod
    def from_records(records) -> "SchedTrace":
        """Rebuild a trace from `to_records` output (e.g. a parsed
        JSONL log).  Derived fields (energy/carbon) are recomputable,
        so the round trip ``to_records(from_records(to_records(t)))``
        is exact (tests/test_torch_sched.py)."""
        events: List[SchedEvent] = []
        dispatches: List[SchedDispatch] = []
        discipline = None
        for r in records:
            if r.get("record") == "sched_summary":
                discipline = r["discipline"]
            elif r.get("record") == "sched_dispatch":
                dispatches.append(SchedDispatch.from_record(r))
            elif r.get("record") == "sched_event":
                probes = {k: r[k] for k in PROBE_METRICS if k in r}
                events.append(SchedEvent(
                    time=r["time_s"], version=r["version"],
                    kind=r["kind"], clients=tuple(r["clients"]),
                    staleness=tuple(r["staleness"]),
                    weights=tuple(r["weights"]), loss=r["loss"],
                    cum_bytes=r["cum_total_bytes"],
                    eval_loss=r.get("eval_loss"),
                    cum_uplink_bytes=r["cum_uplink_bytes"],
                    cum_downlink_bytes=r["cum_downlink_bytes"],
                    cum_hessian_uplink_bytes=r["cum_hessian_uplink_bytes"],
                    cum_hessian_downlink_bytes=r[
                        "cum_hessian_downlink_bytes"],
                    probes=probes or None,
                    trace_ids=tuple(r.get("trace_ids", ())),
                    aggregator=r.get("aggregator", "mean"),
                    attack=r.get("attack", "none"),
                    byzantine=tuple(r.get("byzantine_clients", ())),
                    dropped=tuple(r.get("dropped_clients", ()))))
        if discipline is None:
            raise ValueError(
                "no sched_summary record — not a to_records() trace")
        return SchedTrace(discipline=discipline, events=events,
                          dispatches=dispatches)


@dataclasses.dataclass
class _InFlight:
    """One dispatched client's precomputed results awaiting delivery."""
    arrival: float
    version: int
    wire: torch.Tensor
    stat: torch.Tensor
    loss: float
    ef: Optional[torch.Tensor] = None
    opt: Optional[SophiaState] = None
    dnm: Optional[torch.Tensor] = None
    dnef: Optional[torch.Tensor] = None
    trace_id: int = 0         # 0 when tracing is off
    dropped: bool = False     # delivery delayed by a dropout/rejoin


def _clone_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of every tensor of an engine state (the run then updates
    the copy in place)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, SophiaState):
            return SophiaState(m=x.m.clone(), h=x.h.clone())
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        return x
    return copy(state)


class VirtualScheduler:
    """Drives `FedEngine` rounds on a virtual clock.

    ``batch_fn(version) -> dict`` returns the batch dict with leading
    client axis ``C`` for a server version (clients dispatched at version
    ``v`` train on their row of ``batch_fn(v)``); ``eval_fn(params) ->
    loss`` is optional and sampled every ``eval_every`` aggregations (it
    receives the params dict; packed-resident state is unpacked there).

    ``donate=True`` hands the state passed to `run` over to the run: it
    is updated in place (the counterpart of the JAX scheduler's buffer
    donation) and must not be reused; keep the returned state.  With the
    default ``donate=False`` the run works on a copy and the state
    passed in survives.  Tree- and packed-resident state both work."""

    def __init__(self, engine, batch_fn: Callable[[int], Any],
                 eval_fn: Optional[Callable[[Any], Any]] = None,
                 eval_every: int = 1, donate: bool = False):
        fed = engine.fed
        sched = fed.sched
        comm = fed.comm
        if sched.discipline not in SCHED_DISCIPLINES:
            raise ValueError(
                f"unknown schedule discipline {sched.discipline!r} "
                f"(want one of {SCHED_DISCIPLINES})")
        if comm.hessian_enabled and sched.discipline != "sync":
            raise ValueError(
                "the hessian stream's curvature averaging is a round-"
                "synchronous collective (one common broadcast per "
                "round); use discipline='sync' or disable "
                "hessian_compressor")
        self.engine = engine
        self.fed = fed
        self.sched = sched
        self.comm = comm
        self.batch_fn = batch_fn
        self.eval_fn = eval_fn
        self.eval_every = max(1, eval_every)
        C = fed.num_clients
        self.num_clients = C
        self.cohort = comm.num_participants(C)
        if sched.discipline == "semisync":
            k = sched.buffer_size or self.cohort
            if not 1 <= k <= self.cohort:
                raise ValueError(
                    f"buffer_size={sched.buffer_size} must be in "
                    f"[1, {self.cohort}] (the in-flight cohort)")
            self.buffer_size = k
        else:
            self.buffer_size = 1           # async applies every arrival
        self._stateful = (fed.optimizer == "fed_sophia"
                          and fed.persistent_client_state)
        # adversarial fleet: the byzantine mask is a host constant;
        # churn draws come from their own host rng stream, consumed per
        # dispatched client in group order, and only when churn is on
        rb = fed.robust
        self.robust = rb
        self._byz_mask = robust_attacks.byzantine_mask(rb, C)
        self._attack_on = robust_attacks.wire_attack_active(rb, C)
        self._churn_on = rb.dropout_prob > 0.0
        self._churn_rng = np.random.default_rng([rb.seed, 3])
        self._donate = donate
        self._batch_cache: Tuple[int, Any] = (-1, None)
        # host-side span timers of every dispatch / apply / round,
        # correlated with the virtual clock
        self.spans = SpanLog()
        # per-dispatch trace contexts (`ObsConfig.trace`): host
        # bookkeeping only, the traced run's state is the untraced one's
        self._trace_on = fed.obs.trace

    # ------------------------------------------------------------ randomness
    def _group_noise(self, rt, n: int, batch_size: int, drawn,
                     generator) -> Tuple[ClientNoise, Any]:
        """The random inputs of one dispatch group of ``n`` clients:
        ``(ClientNoise, attack(shape))``, from the injected dict
        ``drawn`` (``"gumbel"`` ``(n, draws, B, K)``; per quantized
        stream ``(n, rows, cols)``; ``"attack"`` ``(n, rows, cols)``) or
        from ``generator``."""
        dev = self.engine.device
        K = self.engine.task.num_classes
        shapes = {}
        for stream, comp, spec in (("uplink", rt.comp, rt.spec),
                                   ("downlink", rt.comp_dn, rt.spec_dn)):
            if isinstance(comp, StochasticQuant):
                shapes[stream] = (n, spec.rows, spec.cols)

        def given(key, shape=None):
            if key not in drawn:
                raise ValueError(f"draws lack {key!r}")
            x = drawn[key]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x, dtype=np.float32))
            x = x.to(dev, torch.float32)
            if shape is not None and tuple(x.shape) != tuple(shape):
                raise ValueError(f"draws[{key!r}] has shape "
                                 f"{tuple(x.shape)}, want {tuple(shape)}")
            return x

        if drawn is not None:
            gum = given("gumbel") if "gumbel" in drawn else None
            if gum is not None and (gum.shape[0] != n
                                    or gum.shape[2:] != (batch_size, K)):
                raise ValueError(f"draws['gumbel'] has shape "
                                 f"{tuple(gum.shape)}, want ({n}, draws, "
                                 f"{batch_size}, {K})")
            uniform = {s: given(s, shp) for s, shp in shapes.items()}
            return (ClientNoise(lambda j: gum[:, j], uniform.get),
                    lambda shape: given("attack", shape))
        if generator is None:
            raise ValueError("run() needs a generator or injected draws")

        def draw_uniform(stream):
            if stream not in shapes:
                return None
            return torch.rand(shapes[stream], generator=generator,
                              device=generator.device).to(dev)
        return (ClientNoise(
            lambda j: gumbel_noise(generator, (n, batch_size, K), dev),
            draw_uniform),
            lambda shape: torch.randn(tuple(shape), generator=generator,
                                      device=generator.device).to(dev))

    def _first_cohort(self, generator, draws) -> List[int]:
        """The participants of version 0: the clients in flight for the
        whole event-loop run."""
        C, S = self.num_clients, self.cohort
        if S == C:
            return list(range(C))
        if draws is not None:
            return [int(i) for i in np.sort(np.asarray(
                draws(0, None)["participants"]))]
        if generator is None:
            raise ValueError("run() needs a generator or injected draws")
        return participation_sample(generator, C, S).cpu().tolist()

    # ------------------------------------------------------ dispatch, apply
    def _dispatch(self, state, batches, group: List[int], version: int,
                  drawn, generator):
        """The comm-path client step of the dispatch group against the
        current server model: ONE client-batched step
        (`FedEngine.comm_client_step_batched`) over the group's gathered
        rows (copies; the state is only read)."""
        engine = self.engine
        params = state["params"]
        rt = engine.runtime_for(params)
        lr = lr_at_round(self.fed, version)
        theta = (params.to(torch.float32) if engine.params_packed(params)
                 else pack(params, rt.spec))
        theta_dn = repack(theta, rt.spec, rt.spec_dn) if rt.dn_on else None
        idx = torch.tensor(group, dtype=torch.int64, device=engine.device)

        def take(x):
            return None if x is None else x.index_select(0, idx)

        opts = state.get("client_opt") if self._stateful else None
        opts_g = (None if opts is None
                  else SophiaState(m=take(opts.m), h=take(opts.h)))
        batches_g = {k: take(v) for k, v in batches.items()}
        noise, attack_noise = self._group_noise(
            rt, len(group), int(batches_g["y"].shape[1]), drawn, generator)
        out = engine.comm_client_step_batched(
            rt, theta, theta_dn, version, lr, opts_g,
            take(state.get("comm_ef")), take(state.get(cdown.MODEL_KEY)),
            take(state.get(cdown.EF_KEY)), batches_g, noise)
        if self._attack_on:
            # the group's byzantine rows transform their uplink wires
            wires = robust_attacks.attack_wires(
                self.robust, out[0], self._byz_mask[group],
                noise=(attack_noise(out[0].shape)
                       if self.robust.attack == "random_wire" else None))
            out = (wires,) + tuple(out[1:])
        return out

    def _apply(self, state, wires, stats, weights: List[float],
               ids: List[int], ef_rows, opt_rows, dnm_rows, dnef_rows):
        """Apply one staleness-weighted aggregate of K arrivals, in
        place: semisync normalises (FedBuff), async applies the raw
        ``(1+tau)^-p``-weighted sum (FedAsync); the arrivals' client-
        state rows are scattered back."""
        engine = self.engine
        dev = engine.device
        params = state["params"]
        rt = engine.runtime_for(params)
        packed = engine.params_packed(params)
        normalize = self.sched.discipline == "semisync"
        w32 = np.asarray(weights, dtype=np.float32)
        wsum = np.float32(0.0)
        for w in w32:                      # ascending, on the host
            wsum = np.float32(wsum + w)
        w_dev = torch.tensor(w32, device=dev)
        K = int(wires.shape[0])
        if robust_agg.resolve(self.robust, K) != "mean":
            agg = robust_agg.aggregate_stack(self.robust, wires, w_dev,
                                             normalize=normalize)
        else:
            inv_norm = float(np.float32(1.0) / wsum) if normalize else 1.0
            agg = stale_accum_flat(wires, w_dev, inv_norm)
        wstat = torch.sum(stats * w_dev)
        if normalize:
            wstat = wstat / float(wsum)
        agg = rt.comp.server_combine(agg, wstat)
        theta = params.to(torch.float32) if packed else pack(params, rt.spec)
        if rt.dn_on:
            # arrivals trained from their OWN replicas: fold in each
            # arrival's (replica - current model) shift, weighted like
            # its delta
            packed_now = repack(theta, rt.spec, rt.spec_dn)
            dn_acc = torch.sum(dnm_rows * w_dev.reshape(K, 1, 1), dim=0)
            if normalize:
                corr = dn_acc / float(wsum) - packed_now
            else:
                corr = dn_acc - float(wsum) * packed_now
            agg = agg + repack(corr, rt.spec_dn, rt.spec)
        new_theta = theta + agg
        state["params"] = (new_theta.to(params.dtype) if packed
                           else unpack(new_theta, rt.spec))
        state["round"] = int(state["round"]) + 1
        idx = torch.tensor(ids, dtype=torch.int64, device=dev)
        if self._stateful and opt_rows is not None:
            state["client_opt"].m.index_copy_(0, idx, opt_rows.m)
            state["client_opt"].h.index_copy_(0, idx, opt_rows.h)
        for key, rows in (("comm_ef", ef_rows), (cdown.MODEL_KEY, dnm_rows),
                          (cdown.EF_KEY, dnef_rows)):
            if rows is not None:
                state[key].index_copy_(0, idx, rows)
        return state

    # ------------------------------------------------------------- helpers
    def _batches(self, version: int):
        # dispatches only ever read the CURRENT version's batches
        if self._batch_cache[0] != version:
            self._batch_cache = (version, self.batch_fn(version))
        return self._batch_cache[1]

    def _maybe_eval(self, state, version: int,
                    final: bool) -> Optional[float]:
        if self.eval_fn is None:
            return None
        if final or (version % self.eval_every) == 0:
            return float(self.eval_fn(self.engine.unpack_params(state)))
        return None

    def _weight(self, staleness: int) -> float:
        return float((1.0 + staleness) ** (-self.sched.staleness_power))

    def _event_ctx(self, ids, dropped=()) -> Dict[str, Any]:
        """Adversarial-fleet fields of one event: the aggregator that
        acts on this many arrivals, the wire attack in play, the
        byzantine arrivals among ``ids`` and the churned deliveries."""
        return {
            "aggregator": robust_agg.resolve(self.robust, len(ids)),
            "attack": self.robust.attack if self._attack_on else "none",
            "byzantine": tuple(i for i in ids if self._byz_mask[i]),
            "dropped": tuple(dropped)}

    # ----------------------------------------------------------------- run
    def run(self, state, num_events: int,
            generator: Optional[torch.Generator] = None, *,
            draws: Optional[Draws] = None,
            target_loss: Optional[float] = None,
            stop_at_target: bool = False):
        """Advance the virtual clock through ``num_events`` aggregation
        events (sync: rounds).  Returns ``(state, SchedTrace)``; with
        ``stop_at_target`` the run ends at the first event whose (eval)
        loss reaches ``target_loss``.

        Random inputs come from ``generator`` or from ``draws(version,
        client_ids)``: with ``client_ids`` None, the draws of
        ``version`` as a whole — ``"participants"`` (the sorted ids of
        version 0 and of each sync round, needed when S < C) and, for a
        sync round, ``"gumbel"`` and the engine's ``comm_noise`` keys
        (`FedEngine.round`); with a dispatch group's ids, that group's
        draws by position: ``"gumbel"`` ``(N, draws, B, K)``, each
        quantized stream's noise ``(N, rows, cols)`` and, under the
        ``random_wire`` attack, ``"attack"`` ``(N, rows, cols)``."""
        if not self._donate:
            state = _clone_state(state)
        else:
            state = dict(state)
        if self.sched.discipline == "sync":
            return self._run_sync(state, num_events, generator, draws,
                                  target_loss, stop_at_target)
        return self._run_event_loop(state, num_events, generator, draws,
                                    target_loss, stop_at_target)

    def _run_sync(self, state, num_events, generator, draws, target_loss,
                  stop_at_target):
        fed, comm = self.fed, self.comm
        C = self.num_clients
        n_params = self.engine.num_params(state)
        durations = latency.dispatch_seconds(fed, n_params, C)
        per_round = accounting.round_bytes(comm, n_params, C)
        legs = (latency.dispatch_legs(fed, n_params, C)
                if self._trace_on else None)
        stream_dn = accounting.stream_bytes(comm, "downlink", n_params)
        stream_up = accounting.stream_bytes(comm, "uplink", n_params)
        stream_h = accounting.stream_bytes(comm, "hessian", n_params)
        trace = SchedTrace(discipline="sync")
        now, cum_bytes, next_tid = 0.0, 0, 1
        cum = {"uplink_bytes": 0, "downlink_bytes": 0,
               "hessian_uplink_bytes": 0, "hessian_downlink_bytes": 0}
        for v in range(num_events):
            if draws is not None:
                drawn = draws(v, None)
                part = (list(range(C)) if self.cohort == C else
                        [int(i) for i in np.sort(np.asarray(
                            drawn["participants"]))])
                kw = dict(generator=generator, comm_noise=drawn,
                          gumbel=(None if drawn.get("gumbel") is None else
                                  torch.as_tensor(drawn["gumbel"])))
            else:
                # round_participants peeks: the round draws the same ids
                part = self.engine.round_participants(generator).cpu().tolist()
                kw = dict(generator=generator)
            tids: Tuple[int, ...] = ()
            if self._trace_on:
                tids = tuple(range(next_tid, next_tid + len(part)))
                next_tid += len(part)
                for tid, i in zip(tids, part):
                    trace.dispatches.append(SchedDispatch(
                        trace_id=tid, client=int(i), version=v,
                        time=now, arrival=now + float(durations[i]),
                        downlink_s=float(legs[0][i]),
                        compute_s=float(legs[1][i]),
                        uplink_s=float(legs[2][i]),
                        downlink_bytes=stream_dn,
                        uplink_bytes=stream_up,
                        hessian_uplink_bytes=stream_h,
                        hessian_downlink_bytes=stream_h))
            with self.spans.span("round", virtual_s=now,
                                 trace_id=tids[0] if tids else None):
                state, metrics = self.engine.round(state, self._batches(v),
                                                   **kw)
            now += float(np.max(durations[part]))
            cum_bytes += per_round["total_bytes"]
            for k in cum:
                cum[k] += per_round[k]
            final = v == num_events - 1
            ev = SchedEvent(
                time=now, version=v + 1, kind="round",
                clients=tuple(int(i) for i in part),
                staleness=(0,) * len(part),
                weights=(1.0,) * len(part),
                loss=float(metrics["loss"]), cum_bytes=cum_bytes,
                eval_loss=self._maybe_eval(state, v + 1, final),
                cum_uplink_bytes=cum["uplink_bytes"],
                cum_downlink_bytes=cum["downlink_bytes"],
                cum_hessian_uplink_bytes=cum["hessian_uplink_bytes"],
                cum_hessian_downlink_bytes=cum["hessian_downlink_bytes"],
                trace_ids=tids,
                **self._event_ctx([int(i) for i in part]))
            trace.events.append(ev)
            if self._hit_target(ev, target_loss, stop_at_target):
                break
        return state, trace

    def _run_event_loop(self, state, num_events, generator, draws,
                        target_loss, stop_at_target):
        fed, comm = self.fed, self.comm
        C = self.num_clients
        n_params = self.engine.num_params(state)
        durations = latency.dispatch_seconds(fed, n_params, C)
        down_bytes, up_bytes = latency.leg_bytes(comm, n_params)
        # per-stream pricing of one leg: down = dn + h, up = up + h
        stream_dn = accounting.stream_bytes(comm, "downlink", n_params)
        stream_up = accounting.stream_bytes(comm, "uplink", n_params)
        stream_h = accounting.stream_bytes(comm, "hessian", n_params)
        legs = (latency.dispatch_legs(fed, n_params, C)
                if self._trace_on else None)
        trace = SchedTrace(discipline=self.sched.discipline)
        inflight: Dict[int, _InFlight] = {}
        buffer: List[Tuple[int, _InFlight]] = []
        now, version, cum_bytes = 0.0, 0, 0
        next_tid = 1
        cum = {"uplink_bytes": 0, "downlink_bytes": 0,
               "hessian_uplink_bytes": 0, "hessian_downlink_bytes": 0}

        def dispatch(group, at_time):
            nonlocal cum_bytes, next_tid
            group = sorted(group)
            drawn = draws(version, group) if draws is not None else None
            with self.spans.span("dispatch", virtual_s=at_time,
                                 trace_id=(next_tid if self._trace_on
                                           else None)):
                (wires, stats, ef_new, opt_new, losses, dnm_new,
                 dnef_new, _h, _hs) = self._dispatch(
                    state, self._batches(version), group, version, drawn,
                    generator)
                host_losses = losses.tolist()   # one read per dispatch

                def row(x, pos):
                    if x is None:
                        return None
                    if isinstance(x, SophiaState):
                        return SophiaState(m=x.m[pos], h=x.h[pos])
                    return x[pos]

                for pos, i in enumerate(group):
                    # dropout/rejoin on the virtual clock: one host rng
                    # draw per dispatched client, in group order
                    extra, was_dropped = 0.0, False
                    if self._churn_on and (self._churn_rng.random()
                                           < self.robust.dropout_prob):
                        extra = float(self.robust.rejoin_delay_s)
                        was_dropped = True
                    arrival = at_time + float(durations[i]) + extra
                    tid = 0
                    if self._trace_on:
                        tid, next_tid = next_tid, next_tid + 1
                        trace.dispatches.append(SchedDispatch(
                            trace_id=tid, client=i, version=version,
                            time=at_time,
                            arrival=arrival,
                            downlink_s=float(legs[0][i]),
                            compute_s=float(legs[1][i]),
                            uplink_s=float(legs[2][i]),
                            downlink_bytes=stream_dn,
                            uplink_bytes=stream_up,
                            hessian_uplink_bytes=stream_h,
                            hessian_downlink_bytes=stream_h))
                    inflight[i] = _InFlight(
                        arrival=arrival, version=version,
                        wire=wires[pos], stat=stats[pos],
                        loss=float(host_losses[pos]),
                        ef=row(ef_new, pos), opt=row(opt_new, pos),
                        dnm=row(dnm_new, pos), dnef=row(dnef_new, pos),
                        trace_id=tid, dropped=was_dropped)
                    cum_bytes += down_bytes
                    cum["downlink_bytes"] += stream_dn
                    cum["hessian_downlink_bytes"] += stream_h

        # the participants of version 0 stay in flight for the whole run
        # (delivering re-dispatches them): participation is concurrency
        dispatch(self._first_cohort(generator, draws), now)

        def stack(rows):
            if rows[0] is None:
                return None
            if isinstance(rows[0], SophiaState):
                return SophiaState(m=torch.stack([r.m for r in rows]),
                                   h=torch.stack([r.h for r in rows]))
            return torch.stack(rows)

        while version < num_events and inflight:
            i = min(inflight, key=lambda j: (inflight[j].arrival, j))
            rec = inflight.pop(i)
            now = rec.arrival
            cum_bytes += up_bytes
            cum["uplink_bytes"] += stream_up
            cum["hessian_uplink_bytes"] += stream_h
            buffer.append((i, rec))
            if len(buffer) < self.buffer_size:
                continue
            ids = [i for i, _ in buffer]
            recs = [r for _, r in buffer]
            stale = [version - r.version for r in recs]
            weights = [self._weight(t) for t in stale]
            tids = (tuple(r.trace_id for r in recs)
                    if self._trace_on else ())
            with self.spans.span("apply", virtual_s=now,
                                 trace_id=(min(tids) if tids
                                           else None)):
                state = self._apply(
                    state, torch.stack([r.wire for r in recs]),
                    torch.stack([r.stat for r in recs]), weights, ids,
                    stack([r.ef for r in recs]),
                    stack([r.opt for r in recs]),
                    stack([r.dnm for r in recs]),
                    stack([r.dnef for r in recs]))
            version += 1
            final = version == num_events
            ev = SchedEvent(
                time=now, version=version, kind="aggregate",
                clients=tuple(ids), staleness=tuple(stale),
                weights=tuple(weights),
                loss=float(np.mean([r.loss for r in recs])),
                cum_bytes=cum_bytes,
                eval_loss=self._maybe_eval(state, version, final),
                cum_uplink_bytes=cum["uplink_bytes"],
                cum_downlink_bytes=cum["downlink_bytes"],
                cum_hessian_uplink_bytes=cum["hessian_uplink_bytes"],
                cum_hessian_downlink_bytes=cum["hessian_downlink_bytes"],
                trace_ids=tids,
                **self._event_ctx(ids, dropped=[
                    i for i, r in zip(ids, recs) if r.dropped]))
            trace.events.append(ev)
            buffer = []
            if self._hit_target(ev, target_loss, stop_at_target):
                break
            if not final:
                dispatch(ids, now)        # delivered clients go again
        return state, trace

    @staticmethod
    def _hit_target(ev: SchedEvent, target_loss, stop_at_target) -> bool:
        if target_loss is None or not stop_at_target:
            return False
        loss = ev.eval_loss if ev.eval_loss is not None else ev.loss
        return loss <= target_loss
