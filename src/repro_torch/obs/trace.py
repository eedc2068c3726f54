"""The port's copy of the JAX package's ``repro/obs/trace.py``.

Chrome Trace Event / Perfetto export of an obs record stream.

Renders a scheduler run — ``sched_dispatch`` trace contexts
(``ObsConfig.trace``), ``sched_event`` aggregations, ``span`` timers
and probe scalars — as one Chrome Trace Event JSON object
(``chrome://tracing`` legacy format, loadable in Perfetto's UI):

* **pid 1 — clients**: one thread lane per client; each dispatch's
  trace context becomes three ``X`` slices (``downlink`` ->
  ``compute`` -> ``uplink``) sized by `repro.sched.latency
  .dispatch_legs` and carrying the exact per-stream byte counters in
  ``args``.  The uplink slice is anchored to end at the authoritative
  ``arrival_s`` (the leg decomposition may differ from the lumped
  clock arithmetic in the last ulps).
* **pid 2 — server**: one ``apply`` slice per aggregation event,
  spanning from the earliest folded arrival (via ``trace_ids``) to
  the event's apply time — buffering/staleness pathologies are the
  visible gap.  Without trace contexts the event degrades to an
  instant marker.
* **pid 3 — counters**: ``C`` tracks for loss and the Sophia health
  probes (``clip_fraction``, ``h_staleness``) per event.
* **pid 4 — host**: ``span`` records on the *wall* clock (their own
  process, so the virtual-time lanes stay uncontaminated).

Timestamps are virtual seconds scaled to microseconds and rounded to
1e-3 us, so the export is byte-deterministic (golden-pinned by
tests/test_obs_tools.py).  Pure stdlib — no jax imports — so the
tools (tools/obs_trace.py) stay fast to start.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

#: displayed process lanes, in pid order
PROCESS_NAMES = {1: "clients", 2: "server", 3: "counters", 4: "host"}

#: probe scalars rendered as counter tracks (subset of
#: repro.obs.probes.PROBE_METRICS, chosen for at-a-glance pathology:
#: Eq. 11 clip saturation and curvature staleness)
COUNTER_PROBES = ("clip_fraction", "h_staleness")


def _us(seconds: float) -> float:
    """Virtual seconds -> trace microseconds, quantized to 1e-3 us so
    float formatting is stable across platforms."""
    return round(seconds * 1e6, 3)


def _meta(pid: int, name: str, tid: int = 0,
          thread: str = "") -> List[Dict[str, Any]]:
    evs = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": name}}]
    if thread:
        evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "ts": 0, "args": {"name": thread}})
    return evs


def chrome_trace(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Export obs records as a Chrome Trace Event JSON object.

    Accepts any record mix (a whole run log); non-scheduler records
    are ignored.  Deterministic: equal record streams produce
    byte-equal ``json.dumps(..., sort_keys=True)`` output.
    """
    records = list(records)
    dispatches = [r for r in records
                  if r.get("record") == "sched_dispatch"]
    events = [r for r in records if r.get("record") == "sched_event"]
    spans = [r for r in records if r.get("record") == "span"]
    arrival_by_tid = {d["trace_id"]: d["arrival_s"] for d in dispatches}

    out: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    used_pids = set()

    # ---- client lanes: downlink -> compute -> uplink per dispatch
    for d in dispatches:
        used_pids.add(1)
        tid = d["client"]
        t0 = d["time_s"]
        legs = (
            ("downlink", t0, d["downlink_s"],
             {"bytes": d.get("downlink_bytes", 0)
              + d.get("hessian_downlink_bytes", 0)}),
            ("compute", t0 + d["downlink_s"], d["compute_s"], {}),
            ("uplink", d["arrival_s"] - d["uplink_s"], d["uplink_s"],
             {"bytes": d.get("uplink_bytes", 0)
              + d.get("hessian_uplink_bytes", 0)}),
        )
        for name, start, dur, extra in legs:
            out.append({
                "name": name, "ph": "X", "pid": 1, "tid": tid,
                "ts": _us(start), "dur": max(_us(dur), 0.0),
                "args": {"trace_id": d["trace_id"],
                         "version": d["version"], **extra}})
    for tid in sorted({d["client"] for d in dispatches}):
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": tid, "ts": 0,
                     "args": {"name": f"client {tid}"}})

    # ---- server lane: one apply slice (or instant) per event
    for ev in events:
        used_pids.add(2)
        args = {"version": ev["version"], "kind": ev["kind"],
                "clients": list(ev["clients"]),
                "staleness": list(ev["staleness"]),
                "loss": ev["loss"],
                "cum_total_bytes": ev["cum_total_bytes"]}
        tids = ev.get("trace_ids") or ()
        arrivals = [arrival_by_tid[t] for t in tids
                    if t in arrival_by_tid]
        if arrivals:
            start = min(arrivals)
            out.append({"name": "apply", "ph": "X", "pid": 2, "tid": 0,
                        "ts": _us(start),
                        "dur": max(_us(ev["time_s"] - start), 0.0),
                        "args": {**args, "trace_ids": list(tids)}})
        else:
            out.append({"name": "apply", "ph": "i", "pid": 2, "tid": 0,
                        "ts": _us(ev["time_s"]), "s": "t",
                        "args": args})

    # ---- counter tracks: loss + selected probes per event
    for ev in events:
        series = [("loss", ev["loss"])]
        series += [(k, ev[k]) for k in COUNTER_PROBES if k in ev]
        for name, value in series:
            used_pids.add(3)
            out.append({"name": name, "ph": "C", "pid": 3, "tid": 0,
                        "ts": _us(ev["time_s"]),
                        "args": {"value": value}})

    # ---- host spans (wall clock, own process)
    for s in spans:
        used_pids.add(4)
        args = {}
        if "virtual_s" in s:
            args["virtual_s"] = s["virtual_s"]
        if "trace_id" in s:
            args["trace_id"] = s["trace_id"]
        out.append({"name": s["name"], "ph": "X", "pid": 4, "tid": 0,
                    "ts": _us(s["t_wall_s"]),
                    "dur": max(_us(s["wall_s"]), 0.0), "args": args})

    for pid in sorted(used_pids):
        meta += _meta(pid, PROCESS_NAMES[pid])

    # metadata first, then a total order on (ts, pid, tid, name) so
    # equal inputs serialize byte-identically AND every lane's slices
    # appear in non-decreasing ts order (what the validator checks)
    meta.sort(key=lambda e: (e["pid"], e["tid"], e["name"]))
    out.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"]))
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


_REQUIRED = ("name", "ph", "pid", "tid", "ts")


def validate_chrome_trace(trace: Any) -> List[str]:
    """Structural validation of a `chrome_trace` export; returns a
    list of human-readable errors (empty = valid).  Checked: the
    top-level shape, per-event required keys, non-negative ``dur`` on
    complete slices, and non-decreasing ``ts`` within every
    ``(pid, tid)`` lane — the contract `make obs-trace-smoke` gates.
    """
    errors: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["not a Chrome trace: missing top-level 'traceEvents'"]
    evs = trace["traceEvents"]
    if not isinstance(evs, list) or not evs:
        return ["'traceEvents' must be a non-empty list"]
    last_ts: Dict[Tuple[int, int], float] = {}
    for n, e in enumerate(evs):
        if not isinstance(e, dict):
            errors.append(f"event {n}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in e]
        if missing:
            errors.append(f"event {n}: missing keys {missing}")
            continue
        ph = e["ph"]
        if ph == "X":
            if "dur" not in e:
                errors.append(f"event {n}: 'X' slice without dur")
            elif e["dur"] < 0:
                errors.append(f"event {n}: negative dur {e['dur']}")
        if ph == "M":
            continue                       # metadata carries ts=0
        lane = (e["pid"], e["tid"])
        if e["ts"] < last_ts.get(lane, float("-inf")):
            errors.append(
                f"event {n}: ts {e['ts']} goes backwards in lane "
                f"pid={lane[0]} tid={lane[1]}")
        last_ts[lane] = e["ts"]
    return errors
