"""Host-side span timers and the profiler hooks (the port of the JAX
package's ``repro/obs/spans.py``: `annotate`, `SpanLog` and
`profile_trace`).

`SpanLog` times named host-side phases (dispatch, apply, round) and
keeps them as ``span`` records; a span opened by the virtual-time
scheduler carries the scheduler's clock in ``virtual_s``.  Every span
also enters a `torch.profiler.record_function` range, so under
`torch.profiler` the same phases appear as named ranges of the trace.

The federated round's phases (`PHASES`, opened by
`repro_torch.core.fed.FedEngine`) and the whole round (`ROUND_SPAN`)
are named here once; the benchmark's per-layer readers name the same
strings.  The phases never nest in one another, so a profile splits a
round's device time among them.  `spanned` is the one range helper
that also covers the backward a region's outputs start: the backward's
kernels are launched from the autograd engine's own thread, which a
range entered on the calling thread does not cover.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.obs.probes import PROBE_METRICS  # noqa: F401 (re-export)

#: the phases of a federated round, disjoint profiler ranges:
#:   fed.loss_grad  the local step's loss forward and the backward it
#:                  starts (remat's recompute included); local SGD's;
#:                  DONE's Hessian-vector-product solve
#:   fed.gnb        the GNB estimate: its gumbel draw, sampled forward
#:                  and backward and B g g; the zero h_hat of steps
#:                  without a refresh
#:   fed.pack       the loss/grad boundary's layout moves: on the
#:                  Sophia step's leaf route the one cast of the start
#:                  model into the params leaves (and a contiguous copy
#:                  of a grad or h_hat leaf the step cannot read where
#:                  it lies); on the packed route and for local SGD,
#:                  unpack of theta into leaves, pack of the grads and
#:                  of h_hat; repack between stream geometries, theta's
#:                  fp32 cast, the clients' working copies of the start
#:                  model
#:   fed.optimizer  the local update: the Sophia step (on the leaf
#:                  route it also reads the grads and h_hat leaves and
#:                  stores the next step's params leaves), or SGD's
#:                  axpy, DONE's step; fresh EMAs of a stateless client
#:   fed.comm       participation (the draw and the gather of the
#:                  participants' rows), the downlink broadcast, the
#:                  uplink encode, the hessian round trip,
#:                  `server_combine` and the h re-sync
#:   fed.aggregate  the cohort's mean or sum (and the robust combine),
#:                  the server step, the scatter of rows back into the
#:                  resident stacks, the round's loss mean
PHASES = ("fed.loss_grad", "fed.gnb", "fed.pack", "fed.optimizer",
          "fed.comm", "fed.aggregate")
LOSS_GRAD, GNB, PACK, OPTIMIZER, COMM, AGGREGATE = PHASES
#: the whole of `FedEngine.round`, host side (the phases lie inside it)
ROUND_SPAN = "fed.round"


def annotate(name: str):
    """A named range of the profiler timeline around a host-side region
    (context manager; the JAX package's ``TraceAnnotation``): a
    `torch.profiler.record_function`, near free outside a profile."""
    return torch.profiler.record_function(name)


def spanned(name: str, fn: Callable, inputs: Sequence[torch.Tensor]):
    """``fn(*inputs)`` inside the profiler range ``name``, and, while a
    profiler runs (`torch.profiler.profile` or the autograd profiler),
    the backward through it inside a range of that name too.

    The backward's range is opened by a hook on the grad of ``fn``'s
    outputs and closed by a multi-grad hook (mode "all") once the grads
    of every one of ``inputs`` that the pass reaches are made; an input
    outside the graph (a leaf that `repro_torch.core.gnb.leaf_grads`
    zero-fills) is not waited for.  Both hooks run on the thread that
    runs the backward (the autograd engine's thread of the tensors'
    device), so the range is entered and exited there, and its kernels
    fall inside it.  A leaf input reaches ``fn`` as a view of itself
    (torch refuses a multi-grad hook on a leaf under
    `torch.autograd.grad`), which moves no value.  The hooks return
    None and hold no tensor, so they change no grad and no byte of
    memory, and are removed after the pass.  None are registered
    outside a profile, without grad, or inside a backward (remat's
    recompute, whose graph is never backpropagated), so the untraced
    cost is the forward range and one flag test."""
    hooked = (torch.autograd.profiler._is_profiler_enabled
              and torch.is_grad_enabled()
              and torch._C._current_graph_task_id() == -1
              and any(t.requires_grad for t in inputs))
    if hooked:
        inputs = [t.view_as(t) if t.requires_grad and t.is_leaf else t
                  for t in inputs]
    with annotate(name):
        out = fn(*inputs)
    if hooked:
        _backward_range(name, out if isinstance(out, tuple) else (out,),
                        [t for t in inputs if t.requires_grad])
    return out


def _backward_range(name: str, outs, ins) -> None:
    """The hooks of `spanned`'s backward range over one pass."""
    outs = [o for o in outs if o.requires_grad]
    if not outs:
        return
    # no tensor in the closures: a hook is kept by its tensor's autograd
    # node, so a tensor held here would outlive the graph
    state = {}

    def opened(grad):
        if "range" not in state:
            state["range"] = torch.profiler.record_function(name)
            state["range"].__enter__()

    def closed(grads):
        rng = state.pop("range", None)
        if rng is not None:
            rng.__exit__(None, None, None)
        # the multi-grad hook holds its tensors' autograd nodes: removed,
        # it leaves no cycle for the collector
        for h in state.pop("handles", ()):
            h.remove()

    state["handles"] = [o.register_hook(opened) for o in outs] + [
        torch.autograd.graph.register_multi_grad_hook(ins, closed,
                                                      mode="all")]


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
