"""Host-side span timers (the port of the JAX package's
``repro/obs/spans.py``, `SpanLog` only).

`SpanLog` times named host-side phases (dispatch, apply, round) and
keeps them as ``span`` records; a span opened by the virtual-time
scheduler carries the scheduler's clock in ``virtual_s``.  Every span
also enters a `torch.profiler.record_function` range, so under
`torch.profiler` the same phases appear as named ranges of the trace.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Optional

import torch

#: the Sophia health scalars an event record may carry (the JAX
#: package's ``repro.obs.probes.PROBE_METRICS``); `SchedTrace.
#: from_records` reads them back
PROBE_METRICS = ("clip_fraction", "m_norm", "h_norm", "h_staleness",
                 "gnb_refreshes")


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
            with torch.profiler.record_function(name):
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
