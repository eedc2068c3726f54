"""The versioned obs record schema: the port's copy of the JAX
package's ``repro/obs/schema.py``, metric for metric and field for
field, so `fingerprint()` equals the JAX package's and its tools
(``tools/obs_report.py``, ``obs_trace.py``, ``obs_diff.py``) read the
port's logs.  ``tests/test_torch_obs.py`` pins the equality; change
the two together.

Every telemetry record is one flat JSON object with a ``record`` type
tag: the metric registry (name -> dtype/unit/description) and the
per-record-type field sets are declared here, and `validate_record`
enforces both, plus the dtype contracts — byte counters are EXACT int64
values (Python ints, never floats).
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, NamedTuple, Tuple

SCHEMA_VERSION = 2

#: schema versions this checkout can still LOAD.  v1 logs lack the
#: trace context (``trace_id`` / ``sched_dispatch``) and the
#: ``serve`` record type but every v1 field survives unchanged, so
#: readers (tools/obs_report.py, tools/obs_diff.py) accept them; the
#: manifest fingerprint is only enforced on current-version logs.
SUPPORTED_SCHEMA_VERSIONS = (1, 2)

#: int64 range of the exact byte/count columns
_I64_MIN, _I64_MAX = -(2 ** 63), 2 ** 63 - 1


class ObsSchemaError(ValueError):
    """A record violated the obs schema."""


class Metric(NamedTuple):
    name: str
    dtype: str        # int64 | float64 | str | list[int] | list[float]
    #                   | hist | obj
    unit: str
    description: str


def _registry(*metrics: Metric) -> Dict[str, Metric]:
    out: Dict[str, Metric] = {}
    for m in metrics:
        if m.name in out:
            raise ValueError(f"duplicate metric {m.name!r}")
        out[m.name] = m
    return out


METRICS: Dict[str, Metric] = _registry(
    # ---- record framing
    Metric("record", "str", "", "record type tag"),
    Metric("schema_version", "int64", "",
           "obs schema version the log was written under"),
    Metric("schema_sha256", "str", "",
           "fingerprint() of the writing schema (drift detector)"),
    Metric("meta", "obj", "",
           "free-form run metadata (arch, config, host)"),
    # ---- training round
    Metric("round", "int64", "rounds", "0-based communication round"),
    Metric("loss", "float64", "nats",
           "mean local-training loss of the round's participants"),
    Metric("eval_loss", "float64", "nats",
           "held-out eval loss (sampled at the eval cadence)"),
    Metric("lr", "float64", "",
           "server learning rate at this round"),
    Metric("participants", "int64", "clients",
           "participants trained this round/event"),
    Metric("wall_s", "float64", "s",
           "host wall-clock per round (averaged within a flush window)"),
    # ---- exact per-stream wire bytes (accounting model, never the
    # ---- in-jit float32 mirrors)
    Metric("uplink_bytes", "int64", "bytes",
           "model-delta uplink payloads, all participants, this round"),
    Metric("downlink_bytes", "int64", "bytes",
           "per-client broadcast payloads, this round"),
    Metric("hessian_uplink_bytes", "int64", "bytes",
           "Sophia h-EMA uplink payloads, this round"),
    Metric("hessian_downlink_bytes", "int64", "bytes",
           "common averaged-curvature broadcast, this round"),
    Metric("total_bytes", "int64", "bytes",
           "all streams, this round"),
    Metric("cum_total_bytes", "int64", "bytes",
           "all streams, cumulative since round 0"),
    Metric("cum_uplink_bytes", "int64", "bytes",
           "cumulative uplink payload bytes"),
    Metric("cum_downlink_bytes", "int64", "bytes",
           "cumulative downlink payload bytes"),
    Metric("cum_hessian_uplink_bytes", "int64", "bytes",
           "cumulative hessian uplink payload bytes"),
    Metric("cum_hessian_downlink_bytes", "int64", "bytes",
           "cumulative hessian broadcast payload bytes"),
    # ---- energy / carbon (paper Eq. 13-14 channel model over the
    # ---- exact byte counts; repro.metrics.energy)
    Metric("energy_J", "float64", "J",
           "total (compute + transmission) energy of this round/event"),
    Metric("comm_J", "float64", "J",
           "transmission energy at the Shannon rate, exact wire bytes"),
    Metric("compute_J", "float64", "J",
           "local-training compute energy"),
    Metric("carbon_kg", "float64", "kg",
           "CO2 footprint of energy_J at the grid intensity"),
    # ---- Sophia health probes (repro.obs.probes; computed in-jit)
    Metric("clip_fraction", "float64", "",
           "fraction of coordinates at the +-rho bound of the Eq. 11 "
           "clipped preconditioned step, mean over participants"),
    Metric("m_norm", "float64", "",
           "RMS-over-clients L2 norm of the Sophia first-moment EMA"),
    Metric("h_norm", "float64", "",
           "RMS-over-clients L2 norm of the Sophia h-EMA diagonal"),
    Metric("h_staleness", "float64", "steps",
           "age of the curvature estimate: refresh-units since the "
           "last GNB refresh (tau-periodic sawtooth)"),
    Metric("gnb_refreshes", "float64", "count",
           "cumulative GNB Hessian-estimator refreshes per client"),
    # ---- virtual-time scheduler events (repro.sched)
    Metric("time_s", "float64", "s",
           "virtual seconds at which the event applied"),
    Metric("version", "int64", "versions",
           "server model version the event produced"),
    Metric("kind", "str", "", "event kind: round | aggregate"),
    Metric("clients", "list[int]", "",
           "client ids folded into the event"),
    Metric("staleness", "list[int]", "versions",
           "per-arrival staleness (versions applied since dispatch)"),
    Metric("weights", "list[float]", "",
           "per-arrival aggregation weights (1+staleness)^-p"),
    Metric("discipline", "str", "",
           "scheduler discipline: sync | semisync | async"),
    # ---- adversarial fleet (repro.robust): emitted only when the
    # ---- run departs from the default mean/no-attack path
    Metric("aggregator", "str", "",
           "effective robust aggregator of the event: mean | "
           "trimmed_mean | coordinate_median | norm_clip"),
    Metric("attack", "str", "",
           "active byzantine wire attack: sign_flip | scale | "
           "random_wire"),
    Metric("byzantine_clients", "list[int]", "",
           "ids of the event's participants marked byzantine"),
    Metric("dropped_clients", "list[int]", "",
           "ids of the event's participants that dropped out and "
           "rejoined (delayed arrivals)"),
    Metric("events", "int64", "count", "aggregation events in the run"),
    Metric("final_time_s", "float64", "s",
           "virtual clock at the last event"),
    Metric("staleness_hist", "hist", "",
           "[staleness, arrival-count] pairs over the whole run"),
    # ---- trace contexts (repro.obs.trace): one id per scheduler
    # ---- dispatch, threading compute -> transfer -> arrival -> apply
    Metric("trace_id", "int64", "",
           "per-dispatch trace context id on the virtual clock"),
    Metric("trace_ids", "list[int]", "",
           "trace ids of the arrivals folded into the event, aligned "
           "with clients"),
    Metric("client", "int64", "", "client id of the dispatch"),
    Metric("arrival_s", "float64", "s",
           "virtual seconds at which the uplink payload reaches the "
           "server"),
    Metric("compute_s", "float64", "s",
           "local-training compute leg of the dispatch, virtual "
           "seconds"),
    Metric("downlink_s", "float64", "s",
           "downlink transfer leg of the dispatch, virtual seconds"),
    Metric("uplink_s", "float64", "s",
           "uplink transfer leg of the dispatch, virtual seconds"),
    # ---- host-side span timers (repro.obs.spans)
    Metric("name", "str", "", "span / benchmark regime name"),
    Metric("t_wall_s", "float64", "s",
           "span start, host wall-clock relative to the span log"),
    Metric("virtual_s", "float64", "s",
           "scheduler virtual clock when the span opened"),
    # ---- serving loop (repro.launch.serve)
    Metric("tokens_per_s", "float64", "tok/s",
           "decode throughput over the whole generation loop"),
    Metric("prefill_s", "float64", "s",
           "wall-clock of the batched prefill (including cache build)"),
    Metric("decode_steps", "int64", "steps",
           "timed decode steps in the generation loop"),
    Metric("batch", "int64", "seqs", "concurrent sequences served"),
    Metric("decode_p50_ms", "float64", "ms",
           "median per-step decode latency"),
    Metric("decode_p95_ms", "float64", "ms",
           "95th-percentile per-step decode latency"),
    Metric("decode_p99_ms", "float64", "ms",
           "99th-percentile per-step decode latency"),
    # ---- engine benchmark rows (benchmarks/run.py --only engine)
    Metric("layout_ops", "int64", "ops",
           "layout-conversion primitives in the round jaxpr"),
    Metric("us_per_round", "float64", "us",
           "wall-clock per jitted round, block_until_ready"),
    Metric("state_copy_bytes", "int64", "bytes",
           "resident state not aliased in place under donation"),
    Metric("resident_state_bytes", "int64", "bytes",
           "device-resident engine state"),
    # ---- comm / sched benchmark rows (benchmarks/run.py --only
    # ---- comm|sched; committed under experiments/bench_*.json)
    Metric("hessian_bytes", "int64", "bytes",
           "hessian stream bytes, both legs, per round"),
    Metric("reduction_x", "float64", "x",
           "total wire-byte reduction vs the uncompressed baseline"),
    Metric("bytes_to_target", "int64", "bytes",
           "cumulative wire bytes when the target metric was reached"),
    Metric("target_loss", "float64", "nats",
           "loss target of the scheduled benchmark comparison"),
    Metric("sim_s_to_target", "float64", "s",
           "virtual seconds until the target loss was reached"),
    Metric("speedup_x", "float64", "x",
           "simulated wall-clock speedup vs the sync discipline"),
    Metric("max_staleness", "int64", "versions",
           "largest per-arrival staleness seen in the run"),
    Metric("accs", "list[float]", "",
           "per-eval test accuracies of the benchmark run"),
    Metric("event_times_s", "list[float]", "s",
           "per-event virtual timestamps of the benchmark trace"),
    Metric("event_eval_losses", "list[float]", "nats",
           "per-event eval losses of the benchmark trace"),
    Metric("event_cum_bytes", "list[int]", "bytes",
           "per-event cumulative wire bytes of the benchmark trace"),
)


class RecordType(NamedTuple):
    required: Tuple[str, ...]
    optional: Tuple[str, ...]


_PROBE_FIELDS = ("clip_fraction", "m_norm", "h_norm", "h_staleness",
                 "gnb_refreshes")

RECORDS: Dict[str, RecordType] = {
    # first line of every JSONL log
    "manifest": RecordType(
        required=("record", "schema_version", "schema_sha256"),
        optional=("meta",)),
    # one synchronous training round (launch/train.py)
    "round": RecordType(
        required=("record", "round", "loss", "lr", "participants",
                  "uplink_bytes", "downlink_bytes",
                  "hessian_uplink_bytes", "hessian_downlink_bytes",
                  "total_bytes", "cum_total_bytes", "energy_J",
                  "carbon_kg"),
        optional=("eval_loss", "wall_s", "comm_J", "compute_J",
                  "aggregator", "attack")
        + _PROBE_FIELDS),
    # one virtual-clock aggregation event (repro.sched.SchedEvent)
    "sched_event": RecordType(
        required=("record", "time_s", "version", "kind", "clients",
                  "staleness", "weights", "loss", "cum_uplink_bytes",
                  "cum_downlink_bytes", "cum_hessian_uplink_bytes",
                  "cum_hessian_downlink_bytes", "cum_total_bytes"),
        optional=("eval_loss", "energy_J", "carbon_kg", "trace_ids",
                  "aggregator", "attack", "byzantine_clients",
                  "dropped_clients")
        + _PROBE_FIELDS),
    # one scheduler dispatch: trace context for the compute ->
    # transfer -> arrival -> apply chain (repro.sched.SchedDispatch)
    "sched_dispatch": RecordType(
        required=("record", "trace_id", "client", "version", "time_s",
                  "arrival_s", "compute_s", "downlink_s", "uplink_s"),
        optional=("downlink_bytes", "uplink_bytes",
                  "hessian_uplink_bytes", "hessian_downlink_bytes")),
    # one per scheduler run, after its events
    "sched_summary": RecordType(
        required=("record", "discipline", "events", "final_time_s",
                  "cum_total_bytes", "staleness_hist"),
        optional=()),
    # host-side span timer (repro.obs.spans.SpanLog)
    "span": RecordType(
        required=("record", "name", "t_wall_s", "wall_s"),
        optional=("virtual_s", "trace_id")),
    # benchmark regime row (benchmarks/run.py): engine rows carry the
    # layout/us/copy gates, comm rows the per-stream byte columns,
    # sched rows the time-to-target trajectory
    "bench": RecordType(
        required=("record", "name"),
        optional=("layout_ops", "us_per_round", "state_copy_bytes",
                  "resident_state_bytes",
                  "uplink_bytes", "downlink_bytes", "hessian_bytes",
                  "total_bytes", "reduction_x", "bytes_to_target",
                  "accs", "target_loss", "sim_s_to_target",
                  "speedup_x", "events", "max_staleness",
                  "event_times_s", "event_eval_losses",
                  "event_cum_bytes")),
    # serving-loop throughput sample (repro.launch.serve)
    "serve": RecordType(
        required=("record", "tokens_per_s", "prefill_s",
                  "decode_steps", "batch"),
        optional=("decode_p50_ms", "decode_p95_ms", "decode_p99_ms")),
}


def _check_int64(name: str, v: Any) -> None:
    if isinstance(v, bool) or not isinstance(v, int):
        raise ObsSchemaError(
            f"{name}: expected an exact int64, got {type(v).__name__} "
            f"{v!r} (byte counters must never pass through floats)")
    if not _I64_MIN <= v <= _I64_MAX:
        raise ObsSchemaError(f"{name}: {v} outside the int64 range")


def _check_value(metric: Metric, v: Any) -> None:
    name, dtype = metric.name, metric.dtype
    if dtype == "int64":
        _check_int64(name, v)
    elif dtype == "float64":
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ObsSchemaError(
                f"{name}: expected a number, got {type(v).__name__}")
    elif dtype == "str":
        if not isinstance(v, str):
            raise ObsSchemaError(
                f"{name}: expected a string, got {type(v).__name__}")
    elif dtype == "list[int]":
        if not isinstance(v, (list, tuple)):
            raise ObsSchemaError(f"{name}: expected a list")
        for x in v:
            _check_int64(f"{name}[]", x)
    elif dtype == "list[float]":
        if not isinstance(v, (list, tuple)):
            raise ObsSchemaError(f"{name}: expected a list")
        for x in v:
            if isinstance(x, bool) or not isinstance(x, (int, float)):
                raise ObsSchemaError(f"{name}[]: expected numbers")
    elif dtype == "hist":
        if not isinstance(v, (list, tuple)):
            raise ObsSchemaError(f"{name}: expected [bin, count] pairs")
        for pair in v:
            if not (isinstance(pair, (list, tuple)) and len(pair) == 2):
                raise ObsSchemaError(
                    f"{name}: expected [bin, count] pairs")
            _check_int64(f"{name}.bin", pair[0])
            _check_int64(f"{name}.count", pair[1])
    elif dtype == "obj":
        if not isinstance(v, dict):
            raise ObsSchemaError(f"{name}: expected an object")
    else:                                            # pragma: no cover
        raise ObsSchemaError(f"{name}: unknown dtype {dtype!r}")


def validate_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Validate one record against the schema; returns it unchanged.

    Raises `ObsSchemaError` on an unknown record type, a missing
    required field, an unregistered field, or a dtype violation.
    """
    if not isinstance(rec, dict):
        raise ObsSchemaError(f"record must be a dict, got "
                             f"{type(rec).__name__}")
    rtype = rec.get("record")
    if rtype not in RECORDS:
        raise ObsSchemaError(
            f"unknown record type {rtype!r} (want one of "
            f"{sorted(RECORDS)})")
    rt = RECORDS[rtype]
    allowed = set(rt.required) | set(rt.optional)
    missing = [f for f in rt.required if f not in rec]
    if missing:
        raise ObsSchemaError(f"{rtype}: missing required {missing}")
    unknown = [f for f in rec if f not in allowed]
    if unknown:
        raise ObsSchemaError(
            f"{rtype}: fields {unknown} are not in the schema "
            f"(register them in repro.obs.schema first)")
    for f, v in rec.items():
        _check_value(METRICS[f], v)
    return rec


def describe() -> Dict[str, Any]:
    """The full schema as one canonical plain dict — what the golden
    test freezes and `fingerprint()` hashes."""
    return {
        "schema_version": SCHEMA_VERSION,
        "metrics": {m.name: {"dtype": m.dtype, "unit": m.unit,
                             "description": m.description}
                    for m in METRICS.values()},
        "records": {name: {"required": list(rt.required),
                           "optional": list(rt.optional)}
                    for name, rt in RECORDS.items()},
    }


def canonical_json() -> str:
    return json.dumps(describe(), sort_keys=True, indent=1) + "\n"


def fingerprint() -> str:
    """sha256 of the canonical schema dump; rides in every manifest so
    a reader can detect schema drift without parsing the registry."""
    return hashlib.sha256(canonical_json().encode()).hexdigest()
