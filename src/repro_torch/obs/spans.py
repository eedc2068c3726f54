"""Host-side span timers and the profiler hooks (the port of the JAX
package's ``repro/obs/spans.py``: `annotate`, `SpanLog` and
`profile_trace`).

`SpanLog` times named host-side phases (dispatch, apply, round) and
keeps them as ``span`` records; a span opened by the virtual-time
scheduler carries the scheduler's clock in ``virtual_s``.  Every span
also enters a `torch.profiler.record_function` range, so under
`torch.profiler` the same phases appear as named ranges of the trace.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import List, Optional

import torch

from repro_torch.obs.probes import PROBE_METRICS  # noqa: F401 (re-export)


def annotate(name: str):
    """A named range of the profiler timeline around a host-side region
    (context manager; the JAX package's ``TraceAnnotation``): a
    `torch.profiler.record_function`, near free outside a profile."""
    return torch.profiler.record_function(name)


class SpanLog:
    """Collects ``span`` records; wall-clock zero is construction."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._spans: List[dict] = []

    @contextmanager
    def span(self, name: str, virtual_s: Optional[float] = None,
             trace_id: Optional[int] = None):
        start = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            rec = {"record": "span", "name": name,
                   "t_wall_s": start - self._t0,
                   "wall_s": time.perf_counter() - start}
            if virtual_s is not None:
                rec["virtual_s"] = float(virtual_s)
            if trace_id is not None:
                rec["trace_id"] = int(trace_id)
            self._spans.append(rec)

    def records(self) -> List[dict]:
        return list(self._spans)


class profile_trace:
    """``with profile_trace(dir):`` captures a `torch.profiler` trace of
    the host and the card into ``dir/trace.json`` (Chrome Trace Event
    format; view with Perfetto); a no-op when ``dir`` is empty.  The
    counterpart of the JAX package's ``jax.profiler`` hook."""

    def __init__(self, directory: str):
        self.directory = directory
        self._prof = None

    def __enter__(self):
        if self.directory:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(self.directory, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            print(f"wrote profiler trace to {path}", flush=True)
        return False
