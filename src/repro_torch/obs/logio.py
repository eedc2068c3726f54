"""The port's copy of the JAX package's ``repro/obs/logio.py``.

Tolerant obs-log readers shared by the tools (tools/obs_*.py).

A "log" is any file carrying schema records:

* a JSONL run log (`repro.obs.sinks.RunRecorder`) — one record per
  line, manifest first;
* a JSON array of records (the regenerated ``experiments/
  bench_*.json`` format — manifest first, then ``bench`` rows);
* a legacy mapping of named rows (pre-v2 ``BENCH_engine.json`` /
  ``bench_*.json``): ``{name: {field: value}}`` or ``{"baseline":
  {...}, "current": {...}}`` — converted to unvalidated ``bench``
  records so old files still feed the tools.

Robustness contract (tested in tests/test_obs_tools.py): a missing,
empty or unparseable file raises `ObsLogError` with a one-line
diagnosis — never a traceback — and a TRUNCATED FINAL JSONL line
(the tail of a live or killed run) is dropped with a warning instead
of failing the whole log.  A bad line in the *middle* of a log is
still an error: that's corruption, not an in-progress write.

Pure stdlib — no jax — so tools start fast.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict, List


class ObsLogError(Exception):
    """A log file the tools cannot read, with a one-line diagnosis."""


def _legacy_bench_records(name: str, row: Dict[str, Any],
                          prefix: str = "") -> Dict[str, Any]:
    """One legacy ``{name: {field: value}}`` row as a bench-shaped
    record (NOT schema-validated: legacy files predate the v2 field
    names and may carry retired fields)."""
    rec = {"record": "bench",
           "name": f"{prefix}{name}" if prefix else name}
    rec.update(row)
    return rec


def read_records(path: str) -> List[Dict[str, Any]]:
    """All records of an obs log, tolerant of the formats above.

    Raises `ObsLogError` (never a bare traceback) when the file is
    missing, empty, or not one of the known shapes.
    """
    p = Path(path)
    if not p.exists():
        raise ObsLogError(f"{path}: no such file")
    try:
        text = p.read_text()
    except OSError as e:
        raise ObsLogError(f"{path}: unreadable ({e})")
    if not text.strip():
        raise ObsLogError(f"{path}: empty log (the run wrote nothing)")
    # JSONL iff the first non-empty line is complete JSON on its own;
    # pretty-printed JSON files (arrays, legacy bench dicts) have an
    # unparseable first line and take the whole-document path
    first = next(l for l in text.splitlines() if l.strip())
    try:
        json.loads(first)
    except ValueError:
        return _read_json(path, text)
    if first.strip() != text.strip():
        return _read_jsonl(path, text)
    return _read_json(path, text)


def _read_jsonl(path: str, text: str) -> List[Dict[str, Any]]:
    lines = text.splitlines()
    records: List[Dict[str, Any]] = []
    for n, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if n == len(lines) - 1:
                # the tail of a live/killed run — drop it, keep going
                print(f"{path}: dropping truncated final line "
                      f"{n + 1}", file=sys.stderr)
                continue
            raise ObsLogError(
                f"{path}: line {n + 1} is not valid JSON (corrupt "
                f"log — only the FINAL line may be truncated)")
    if not records:
        raise ObsLogError(f"{path}: no parseable records")
    return records


def _read_json(path: str, text: str) -> List[Dict[str, Any]]:
    try:
        data = json.loads(text)
    except ValueError as e:
        raise ObsLogError(f"{path}: not valid JSON ({e})")
    if isinstance(data, list):
        if not all(isinstance(r, dict) and "record" in r for r in data):
            raise ObsLogError(
                f"{path}: JSON array entries must all be records "
                f"(objects with a 'record' field)")
        return data
    if isinstance(data, dict):
        # {"record": ...} — a single record
        if "record" in data:
            return [data]
        # legacy two-level {"baseline": {name: row}, "current": ...}
        if set(data) and all(
                isinstance(v, dict) and v
                and all(isinstance(r, dict) for r in v.values())
                for v in data.values()):
            return [_legacy_bench_records(n, r, f"{group}/")
                    for group, rows in data.items()
                    for n, r in rows.items()]
        # legacy one-level {name: row}
        if set(data) and all(isinstance(v, dict)
                             for v in data.values()):
            return [_legacy_bench_records(n, r)
                    for n, r in data.items()]
    raise ObsLogError(f"{path}: unrecognized log shape "
                      f"({type(data).__name__})")


def manifest_of(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The manifest record of a log, or ``{}`` when absent (legacy
    files) — callers decide whether that is an error."""
    for r in records:
        if r.get("record") == "manifest":
            return r
    return {}
