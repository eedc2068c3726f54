"""Per-op cost of a traced program: the counterpart of the JAX package's
``launch/hlo_cost.py``, which walks optimized HLO text.  The port is
eager, with no fusion, so its cost is the aten ops it dispatches, and
`OpCost` tallies them as they run under ``FakeTensorMode``: shapes and
dtypes only, no storage and no arithmetic.

  * FLOPs: the formulas of `torch.utils.flop_counter` (matmuls,
    convolutions, attention), by dtype; the kernels' fp32 operations.
  * Bytes: the elements each op reads plus those it writes, at their
    widths (a broadcast input counts its distinct elements).  Views and
    aliases cost 0, as do allocations that write nothing (``empty``); an
    in-place op writes its output once.  Without fusion this is the
    traffic the program makes.
  * The kernels: each launch of the fifteen entry points on storage-less
    tensors is recorded by its shape-only path (`kernels/cost.py`) with
    its bytes and fp32 operations, and counted in ``launches``.
  * The peak: the bytes of live storages.  A storage is counted when an
    op first returns (or reads) it, and freed when its Python object is
    finalized; views share their base's storage.

Use::

    with FakeTensorMode(), OpCost() as oc:
        with oc.setup():            # allocations count, ops do not
            args = make_args()
        fn(*args)
    oc.summary(), oc.top_contributors(25)

Each op's roofline time is the larger of its compute and memory terms
at the card's peaks (`roofline`); ``roofline_s`` sums them.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize, robust_agg, sophia_update
from repro_torch.kernels import stale_accum
from repro_torch.launch import roofline

aten = torch.ops.aten

#: the kernel entry points of the table, in their modules' order
KERNEL_NAMES = tuple(name for mod in (sophia_update, quantize, stale_accum,
                                      robust_agg, kops)
                     for name in mod.LAUNCHES)

#: ops that allocate and write nothing
_ALLOC_ONLY = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default}
#: in-place ops that do not read the tensor they write
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}
COLLECTIVE_KINDS = roofline.COLLECTIVE_KINDS


def touched_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses: a stride-0
    (broadcast) axis counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _shape_str(tensors) -> str:
    return " ".join(f"{_dtype_name(t)}{list(t.shape)}" for t in tensors)


def _tensors(values) -> List[torch.Tensor]:
    """The tensors among ``values`` and inside their lists and tuples (an
    aten op's arguments nest no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


class OpCost(TorchDispatchMode):
    """A dispatch mode that tallies every aten op below it (module
    docstring).  Enter it inside ``FakeTensorMode``."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.by_op: Dict[str, List[float]] = {}      # op -> [flops, bytes]
        self._contrib: Dict[Tuple[str, str], dict] = {}
        self.launches: Dict[str, int] = {k: 0 for k in KERNEL_NAMES}
        self.roofline_s = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._counting = True

    # --------------------------------------------------------- lifecycle
    def __enter__(self):
        kcost.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kcost.SINKS.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def setup(self):
        """Ops inside allocate (their storages count toward the peak) but
        are not tallied: the arguments of the traced function."""
        self._counting = False
        try:
            yield self
        finally:
            self._counting = True

    # -------------------------------------------------------------- peak
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += self._live[key]
            weakref.finalize(st, self._free, key)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes

    # ------------------------------------------------------------- tally
    def _add(self, op: str, shape: str, flops_by_dtype: Dict[str, float],
             nbytes: float, seconds: float) -> None:
        flops = sum(flops_by_dtype.values())
        for d, f in flops_by_dtype.items():
            self.flops_by_dtype[d] = self.flops_by_dtype.get(d, 0.0) + f
        acc = self.by_op.setdefault(op, [0.0, 0.0])
        acc[0] += flops
        acc[1] += nbytes
        e = self._contrib.setdefault((op, shape), dict(
            name=op, opcode=op, bytes=0.0, flops=0.0, scale=0, shape=shape))
        e["bytes"] += nbytes
        e["flops"] += flops
        e["scale"] += 1
        self.roofline_s += seconds

    def kernel(self, name: str, nbytes: int, ops: float,
               shape: tuple) -> None:
        """A shape-only launch of a kernel of the table (`kernels/cost.py`
        calls it): counted, its fp32 operations as fp32 FLOPs."""
        if not self._counting:
            return
        self.launches[name] += 1
        seconds = max(roofline.compute_seconds({"float32": ops}),
                      nbytes / roofline.HBM_BYTES_PER_S)
        self._add(f"kernel:{name}", f"out {list(shape)}", {"float32": ops},
                  float(nbytes), seconds)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        self._track(ins + outs)
        if self._counting and outs:
            self._tally(func, ins, outs, args, kwargs, out)
        return out

    def _tally(self, func, ins, outs, args, kwargs, out) -> None:
        flops: Dict[str, float] = {}
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            if f:
                flops[_dtype_name(ins[0])] = f
        mutable = func._schema.is_mutable
        in_keys = {t.untyped_storage()._cdata for t in ins}
        nbytes = 0
        if func not in _ALLOC_ONLY:
            fresh = [o for o in outs
                     if o.untyped_storage()._cdata not in in_keys]
            if mutable or fresh:
                # a view or alias reads and writes nothing
                written = outs if mutable else fresh
                read = ins
                if func in _WRITE_ONLY:
                    read = ins[1:]
                nbytes = (sum(touched_bytes(t) for t in read)
                          + sum(touched_bytes(t) for t in written))
        if not flops and not nbytes:
            return
        seconds = max(roofline.compute_seconds(flops),
                      nbytes / roofline.HBM_BYTES_PER_S)
        self._add(packet.__name__, _shape_str(ins), flops, float(nbytes),
                  seconds)

    # ----------------------------------------------------------- reports
    def summary(self) -> dict:
        """`HloCost.summary`'s keys (``flops``, ``bytes``, ``collectives``
        all 0, ``collective_total``, ``bytes_by_opcode`` top 12,
        ``flops_by_opcode`` top 8), plus ``peak_bytes``,
        ``flops_by_dtype``, ``launches`` (every row of the kernel table)
        and ``roofline_s`` (each op's larger term, summed)."""
        out = {"flops": sum(f for f, _ in self.by_op.values()),
               "bytes": sum(b for _, b in self.by_op.values()),
               "collectives": {k: 0.0 for k in COLLECTIVE_KINDS}}
        out["collective_total"] = 0.0
        out["bytes_by_opcode"] = dict(sorted(
            ((k, round(v[1])) for k, v in self.by_op.items()),
            key=lambda kv: -kv[1])[:12])
        out["flops_by_opcode"] = dict(sorted(
            ((k, round(v[0])) for k, v in self.by_op.items()),
            key=lambda kv: -kv[1])[:8])
        out["peak_bytes"] = self.peak_bytes
        out["flops_by_dtype"] = dict(self.flops_by_dtype)
        out["launches"] = dict(self.launches)
        out["roofline_s"] = self.roofline_s
        return out

    def top_contributors(self, n: int = 25) -> List[dict]:
        """The heaviest ops by bytes, aggregated by op and input shapes;
        ``scale`` is how many times each ran."""
        return sorted(self._contrib.values(),
                      key=lambda e: -e["bytes"])[:n]
