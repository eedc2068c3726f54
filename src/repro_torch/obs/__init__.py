"""Structured telemetry of the port: the twin of the JAX package's
``repro/obs``.

* `repro_torch.obs.schema` — the versioned record schema (the JAX
  package's, field for field: `fingerprint()` is equal);
* `repro_torch.obs.sinks`  — JSONL file sink, bounded in-memory ring
  and `RunRecorder` (validates every record, writes the run manifest);
* `repro_torch.obs.buffer` — `MetricsAccumulator`, the device-side
  metrics buffer that holds the host sync back to the flush boundary;
* `repro_torch.obs.probes` — the Sophia health scalars;
* `repro_torch.obs.spans`  — host span timers (each span is also a
  `torch.profiler.record_function` range), `annotate` (such a range
  alone) and `profile_trace`, a `torch.profiler` capture of a run;
* `repro_torch.obs.trace`  — Chrome Trace Event export and validator;
* `repro_torch.obs.logio`  — tolerant record readers.
"""
from repro_torch.obs.buffer import MetricsAccumulator
from repro_torch.obs.logio import ObsLogError, read_records
from repro_torch.obs.probes import PROBE_METRICS, sophia_health
from repro_torch.obs.schema import (SCHEMA_VERSION,
                                    SUPPORTED_SCHEMA_VERSIONS,
                                    ObsSchemaError, describe, fingerprint,
                                    validate_record)
from repro_torch.obs.sinks import JsonlSink, RingSink, RunRecorder
from repro_torch.obs.spans import SpanLog, annotate, profile_trace
from repro_torch.obs.trace import chrome_trace, validate_chrome_trace

__all__ = [
    "SCHEMA_VERSION", "SUPPORTED_SCHEMA_VERSIONS", "ObsSchemaError",
    "describe", "fingerprint", "validate_record",
    "JsonlSink", "RingSink", "RunRecorder",
    "MetricsAccumulator", "PROBE_METRICS", "sophia_health",
    "SpanLog", "annotate", "profile_trace",
    "ObsLogError", "read_records",
    "chrome_trace", "validate_chrome_trace",
]
