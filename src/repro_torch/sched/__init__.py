"""repro_torch.sched — virtual-time asynchronous and semi-synchronous
rounds over the port's engine (the port of the JAX package's
``repro.sched``).

`latency` is the deterministic per-client latency model (compute seconds
per local step plus transfer seconds from the comm layer's exact
per-stream byte counts); `scheduler.VirtualScheduler` is the event loop,
with the ``sync``, ``semisync`` and ``async`` disciplines of
`repro_torch.configs.base.SchedConfig`.
"""
from repro_torch.sched.latency import (client_multipliers, dispatch_legs,
                                       dispatch_seconds, leg_bytes,
                                       stragglers)
from repro_torch.sched.scheduler import (SchedDispatch, SchedEvent,
                                         SchedTrace, VirtualScheduler)

__all__ = [
    "client_multipliers", "dispatch_legs", "dispatch_seconds",
    "leg_bytes", "stragglers",
    "SchedDispatch", "SchedEvent", "SchedTrace", "VirtualScheduler",
]
