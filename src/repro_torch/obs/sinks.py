"""The port's copy of the JAX package's ``repro/obs/sinks.py``.

Obs sinks: JSONL file, bounded in-memory ring, run recorder.

`RunRecorder` is the one object launchers talk to: it validates every
record against the schema (`repro.obs.schema.validate_record` — a bad
record fails at emit time, next to the bug), writes it to the JSONL
log and the ring, and on `close` writes a CI-consumable run manifest
(``<log>.manifest.json``) with the schema fingerprint and per-type
record counts — what `tools/obs_report.py --validate` and the
``make obs-smoke`` CI step consume.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.obs import schema


class JsonlSink:
    """Append-only JSONL file; one record per line, sorted keys (the
    byte stream is deterministic in the record sequence)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")
        self.count = 0

    def write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self.count += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class RingSink:
    """Bounded in-memory record ring (most recent ``capacity``)."""

    def __init__(self, capacity: int = 1024):
        self._ring: deque = deque(maxlen=int(capacity))

    def write(self, rec: Dict[str, Any]) -> None:
        self._ring.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


class RunRecorder:
    """Validating fan-out recorder for one run.

    Emits the ``manifest`` record as the log's first line (schema
    version + fingerprint, so a reader can reject a drifted log before
    parsing anything else), then every record the run produces.
    """

    def __init__(self, path: Optional[str] = None,
                 ring_capacity: int = 1024,
                 meta: Optional[Dict[str, Any]] = None,
                 validate: bool = True):
        self.jsonl = JsonlSink(path) if path else None
        self.ring = RingSink(ring_capacity)
        self.validate = validate
        self.meta = dict(meta or {})
        self.counts: Dict[str, int] = {}
        self._closed = False
        head = {"record": "manifest",
                "schema_version": schema.SCHEMA_VERSION,
                "schema_sha256": schema.fingerprint()}
        if self.meta:
            head["meta"] = self.meta
        self.emit(head)

    def emit(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        if self._closed:
            raise ValueError("recorder is closed")
        if self.validate:
            schema.validate_record(rec)
        self.counts[rec["record"]] = self.counts.get(rec["record"], 0) + 1
        self.ring.write(rec)
        if self.jsonl:
            self.jsonl.write(rec)
        return rec

    def emit_all(self, recs) -> None:
        for r in recs:
            self.emit(r)

    @property
    def manifest_path(self) -> Optional[str]:
        return self.jsonl.path + ".manifest.json" if self.jsonl else None

    def close(self) -> Optional[str]:
        """Close the log and write the run manifest; returns its path
        (None for ring-only recorders)."""
        if self._closed:
            return self.manifest_path
        self._closed = True
        if self.jsonl is None:
            return None
        self.jsonl.close()
        manifest = {"schema_version": schema.SCHEMA_VERSION,
                    "schema_sha256": schema.fingerprint(),
                    "log": os.path.basename(self.jsonl.path),
                    "records": dict(sorted(self.counts.items())),
                    "meta": self.meta}
        with open(self.manifest_path, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
        return self.manifest_path
