"""One run of a cell: set-up, the measured window, the per-layer trace,
the check against the reference, and the result line.

Set-up builds the program's one engine and state from weights made from
the seed, and drives it through the window's own call
(`repro_torch.core.fed.FedEngine.round`) and feed for the checked rounds
(the gumbel draws and uplink noise given, so the reference gets the
same), reading what the check needs as it goes: the losses, every
client's Sophia m and h after the first round, the server model's change
over the checked rounds.  One more round with the window's generator
warms its path; then the window runs rounds back to back from the pool,
a CUDA event after each, no host synchronise, until ``--seconds`` have
passed, and ends at a synchronise.  With ``--trace 1`` the traced rounds
run under `torch.profiler` instead (the traffic's ``trace_rounds``).
Then the peak memory is read, the program's state freed, and the
reference follows the checked rounds on the same inputs.

`Program` is the whole of what the benchmark takes from the system under
test: its engine, its round, and readouts of its state through its own
layout description.
"""
from __future__ import annotations

import gc
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import cells, check, cost, traffic as gen, weights
from portbench import trace as ptrace
from portbench.reference.fed import FedRef, Hyper, leaf_norms
from portbench.reference.layers import no_tf32

#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the schedule's horizon in rounds: the lr stays at its peak throughout
TOTAL_ROUNDS = 1_000_000
#: untraced rounds a traced run times before its trace, per traced round
PLAIN_PER_TRACED = 3


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def since_process_start() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def program_config(d: dict, bench: Optional[cells.Bench] = None):
    """The program's model config as configuration file ``d`` states it,
    by the program module of its arch (`cells.Bench.program`)."""
    bench = bench or cells.Bench()
    return bench.program(d).program_config(d, bench.arch(d).from_json(d))


class Program:
    """The system under test: `FedEngine` over the program's `LMTask`,
    with the arch's own federated strategy and schedule."""

    def __init__(self, conf_json: dict, traffic: dict, device,
                 bench: Optional[cells.Bench] = None):
        from repro_torch import configs
        from repro_torch.configs.base import CommConfig, FedConfig
        from repro_torch.core.fed import FedEngine
        from repro_torch.models.transformer import LMTask
        self.cfg = program_config(conf_json, bench)
        over = configs.get_fed_overrides(conf_json["port"]["arch"])
        strategy = over.get("strategy", "parallel")
        if strategy != traffic["strategy"]:
            raise ValueError(f"the traffic asks for the {traffic['strategy']}"
                             f" strategy, the arch trains {strategy}")
        self.fed = FedConfig(
            num_clients=traffic["clients"],
            local_iters=traffic["local_iters"], tau=traffic["tau"],
            lr=traffic["lr"], total_rounds=TOTAL_ROUNDS, strategy=strategy,
            schedule=over.get("schedule", "const"),
            comm=CommConfig(compressor=traffic["compressor"]))
        self.engine = FedEngine(LMTask(self.cfg), self.fed, device=device)

    def start(self, params):
        return self.engine.pack_state(self.engine.init_from_params(params))

    def round(self, state, tokens, labels, **kw):
        return self.engine.round(state, {"tokens": tokens, "labels": labels},
                                 **kw)

    def _slices(self, state):
        spec = self.engine.runtime_for(state["params"]).spec
        off = 0
        for key, size in zip(spec.keys, spec.sizes):
            yield key, off, size
            off += size

    def client_norms(self, state) -> Dict[str, Dict[str, float]]:
        """Each client's leaf norms of its Sophia m and h."""
        opt = state["client_opt"]
        out = {}
        for name, buf in (("m", opt.m), ("h", opt.h)):
            flat = buf.reshape(buf.shape[0], -1)
            keys, vals = [], []
            for key, off, size in self._slices(state):
                keys.append(key)
                vals.append(torch.linalg.vector_norm(
                    flat[:, off:off + size].float(), dim=1))
            table = torch.stack(vals, dim=1).tolist()
            out[name] = {f"{c}/{k}": row[i] for c, row in enumerate(table)
                         for i, k in enumerate(keys)}
        return out

    def client_vectors(self, state) -> Dict[str, Dict[str, torch.Tensor]]:
        """Client 0's Sophia m and h, float32 on the host, as flat views
        keyed by leaf."""
        opt = state["client_opt"]
        out = {}
        for name, buf in (("m", opt.m), ("h", opt.h)):
            row = buf.reshape(buf.shape[0], -1)[0].to("cpu", torch.float32,
                                                      copy=True)
            out[name] = {key: row[off:off + size]
                         for key, off, size in self._slices(state)}
        return out

    def change(self, state, theta0):
        """Each leaf's norm of the server model's change from ``theta0``,
        and the change itself, float32 on the host, flat (a leaf at a
        time on the device)."""
        flat = state["params"].reshape(-1)
        norms, vecs = {}, {}
        for key, off, size in self._slices(state):
            d = flat[off:off + size].float() - theta0[key].reshape(-1).float()
            norms[key] = float(torch.linalg.vector_norm(d))
            vecs[key] = d.to("cpu", copy=True)
            del d
        return norms, vecs


class Clock:
    """Marks the end of each round: a CUDA event on the card, the host
    clock on the CPU (where every op has ended when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def empty_cache(device: torch.device) -> None:
    """Hand the allocator's free blocks back, so that the next large
    buffers are not cut from the last ones' remains."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@dataclass
class RunData:
    """What the metric readers read (`portbench/metrics/*.py`)."""
    cell: str
    #: the sizes the cell's arch read (its module: `cells.arch_of`)
    conf: Any
    traffic: dict
    setup_s: float
    rounds: int = 0
    window_s: float = 0.0
    round_ms: Optional[List[float]] = None
    peak_bytes: int = 0
    trace: Optional[ptrace.Trace] = None
    #: with a trace: the mean seconds of a round over the untraced rounds
    #: run just before it (`PLAIN_PER_TRACED` a traced round; CUDA events)
    plain_round_s: float = 0.0

    @property
    def tokens_per_round(self) -> int:
        return cost.trained_tokens(self.traffic)


class Inputs:
    """The cell's inputs from the seed: the weights, the pool of rounds'
    batches, the checked rounds' gumbel draws and uplink noise.  Each is
    made the same way for the program and for the reference."""

    def __init__(self, conf, traffic: dict, seed: int, device):
        self.conf, self.tr, self.seed, self.dev = conf, traffic, seed, device

    def weights(self):
        return weights.make(self.conf, gen.generator(self.dev, self.seed,
                                                     gen.WEIGHTS))

    def pool(self):
        tr = self.tr
        return gen.token_pool(gen.generator(self.dev, self.seed, gen.POOL),
                              tr["pool_rounds"], tr["clients"], tr["batch"],
                              tr["seq"], self.conf.vocab_size)

    def gumbel(self, r: int) -> torch.Tensor:
        """Round ``r``'s refresh draw of every client, ``(C, B, S, Vp)``."""
        tr = self.tr
        return gen.gumbel(gen.generator(self.dev, self.seed, gen.GUMBEL + r),
                          (tr["clients"], tr["batch"], tr["seq"],
                           self.conf.vocab_padded))

    def uplink(self) -> Optional[torch.Tensor]:
        """The checked rounds' uplink noise ``(rows, cols)``, shared by the
        clients and the rounds (one buffer: at an MoE's size it is
        gigabytes); None for a lossless uplink."""
        if self.tr["compressor"] == "identity":
            return None
        return gen.uniform(gen.generator(self.dev, self.seed, gen.UPLINK),
                           (cost.packed_rows(self.conf), cost.PACK_COLS))


def checked_kwargs(inputs: Inputs, r: int, u) -> dict:
    """The program's round arguments that give round ``r`` the checked
    inputs: the refresh draw for every local step, the uplink noise ``u``
    for every client (views, no copies)."""
    tr = inputs.tr
    g = inputs.gumbel(r)
    kw = {"gumbel": g.unsqueeze(1).expand(g.shape[0], tr["local_iters"],
                                          *g.shape[1:])}
    if u is not None:
        kw["comm_noise"] = {"uplink": u.expand(tr["clients"], *u.shape)}
    return kw


def checked_rounds(prog: Program, inputs: Inputs, tokens, labels):
    """The program's engine and state from the seed's weights, driven
    through the checked rounds on their given inputs: ``(state,
    readout)`` (`check`)."""
    u = inputs.uplink()              # first: its own block, before the state
    state = prog.start(inputs.weights())
    empty_cache(inputs.dev)          # the weights' draw
    readout: dict = {"loss": []}
    for r in range(inputs.tr["checked_rounds"]):
        state, met = prog.round(state, tokens[r], labels[r],
                                **checked_kwargs(inputs, r, u))
        readout["loss"].append(met["loss"])
        if r == 0:
            readout.update(prog.client_norms(state))
            readout["vec"] = prog.client_vectors(state)
    del u
    empty_cache(inputs.dev)
    readout["change"], readout["vec"]["change"] = prog.change(
        state, inputs.weights())
    readout["loss"] = [float(x) for x in readout["loss"]]
    return state, readout


def reference_readout(conf, traffic: dict, inputs: Inputs, others=(),
                      model: Optional[type] = None, keep: bool = False
                      ) -> dict:
    """The reference's readout of the checked rounds (`check`), on the
    same inputs as the program's.  For each readout of ``others`` (the
    program's, the control's), the distance of its client 0 vectors from
    the reference's, leaf by leaf, goes into its ``"dist"``.  ``model``
    is the reference's model class, by default the ``Model`` of
    ``conf``'s arch (`portbench.control` gives one of lower precision);
    ``keep`` keeps client 0's vectors on the host in the readout's
    ``"vec"``, as the program's readout has them."""
    tr = traffic
    hp = Hyper(clients=tr["clients"], local_iters=tr["local_iters"],
               tau=tr["tau"], lr=tr["lr"], compressor=tr["compressor"],
               quant_block=cost.PACK_COLS)
    for o in others:
        o["dist"] = {}

    def against(part: str, mine: Dict[str, torch.Tensor]) -> None:
        for o in others:
            o["dist"][part] = {
                k: float(torch.linalg.vector_norm(
                    o["vec"][part][k].to(v.device) - v.reshape(-1)))
                for k, v in mine.items()}

    with no_tf32():
        u = inputs.uplink()
        tokens, labels = inputs.pool()
        model = model or cells.arch_of(conf).Model
        ref = FedRef(model(conf), hp, inputs.weights())
        out: dict = {"loss": []}
        if keep:
            out["vec"] = {}
        for r in range(tr["checked_rounds"]):
            g = inputs.gumbel(r)
            loss = ref.round(r, tokens[r], labels[r], lambda i: g[i],
                             lambda i: u)
            out["loss"].append(float(loss))
            del g
            if r == 0:
                for name, per in (("m", ref.m), ("h", ref.h)):
                    out[name] = {f"{c}/{k}": v for c, tree in enumerate(per)
                                 for k, v in leaf_norms(tree).items()}
                    against(name, per[0])
                    if keep:
                        out["vec"][name] = {
                            k: v.reshape(-1).to("cpu", copy=True)
                            for k, v in per[0].items()}
        del u, ref.m, ref.h
        theta0 = inputs.weights()
        change = {k: ref.theta[k].sub_(theta0[k].float()) for k in theta0}
        del theta0, ref
        out["change"] = leaf_norms(change)
        against("change", change)
        if keep:
            out["vec"]["change"] = {k: v.reshape(-1).to("cpu", copy=True)
                                    for k, v in change.items()}
    return out


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def run(name: str, seed: int, seconds: float, traced: bool,
        device: torch.device, bench: Optional[cells.Bench] = None,
        program_hook: Optional[Callable] = None) -> dict:
    """One run of cell ``name``; returns the result object.
    ``program_hook(program)`` may replace parts of the program (the tests
    plant faults through it)."""
    bench = bench or cells.Bench()
    cell = bench.workload(name)
    conf_json = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    conf = bench.arch(conf_json).from_json(conf_json)
    log(f"portbench: cell {name} seed {seed} seconds {seconds} trace "
        f"{int(traced)} on {card_line(device)}")
    inputs = Inputs(conf, tr, seed, device)

    # ---------------------------------------------------------- set-up
    prog = Program(conf_json, tr, device, bench)
    if program_hook is not None:
        program_hook(prog)
    tokens, labels = inputs.pool()
    state, readout = checked_rounds(prog, inputs, tokens, labels)
    P = tr["pool_rounds"]
    rgen = gen.generator(device, seed, gen.ROUNDS)
    r = tr["checked_rounds"]
    state, _ = prog.round(state, tokens[r % P], labels[r % P],
                          generator=rgen)
    r += 1
    sync(device)
    gc.collect()                     # what set-up left to the collector
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    data = RunData(cell=name, conf=conf, traffic=tr,
                   setup_s=since_process_start())

    # ---------------------------------------------------------- window
    clock = Clock(device)
    losses = []

    def rounds(limit: Optional[int], marks: Clock = clock):
        nonlocal state, r
        t0 = time.perf_counter()
        n = 0
        while True:
            state, met = prog.round(state, tokens[r % P], labels[r % P],
                                    generator=rgen)
            losses.append(met["loss"])
            marks.mark()
            r += 1
            n += 1
            if (n >= limit if limit else
                    time.perf_counter() - t0 >= seconds):
                break
        return n

    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        # rounds untraced first, three times as many as the trace holds:
        # the profiler's host cost slows a host-paced round, so the
        # round's time comes from these
        plain = Clock(device)
        plain.mark()
        rounds(PLAIN_PER_TRACED * tr["trace_rounds"], plain)
        sync(device)
        data.plain_round_s = statistics.fmean(plain.intervals_ms()) / 1e3
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            rounds(1)                   # the profiler's own warm-up
            sync(device)
            clock.marks.clear()
            losses.clear()
            with record_function(ptrace.WINDOW):
                clock.mark()
                data.rounds = rounds(tr["trace_rounds"])
                sync(device)
        t_read = time.perf_counter()
        data.trace = ptrace.from_profile(prof, data.rounds)
        data.window_s = data.trace.window_s
        log(f"portbench: trace read in {time.perf_counter() - t_read:.1f} s"
            f" ({len(data.trace.kernels)} device activities); a round "
            f"{data.plain_round_s * 1e3:.3f} ms untraced, "
            f"{data.window_s / data.rounds * 1e3:.3f} ms traced")
        del prof
    else:
        sync(device)
        clock.mark()
        t0 = time.perf_counter()
        data.rounds = rounds(None)
        sync(device)
        data.window_s = time.perf_counter() - t0
    data.round_ms = clock.intervals_ms()
    if device.type == "cuda":
        data.peak_bytes = int(torch.cuda.max_memory_allocated(device))
        st = torch.cuda.memory_stats(device)
        log(f"portbench: allocator in the window: peak reserved "
            f"{st['reserved_bytes.all.peak']} bytes, "
            f"{st['num_alloc_retries']} alloc retries, "
            f"{st['num_device_alloc']} device allocs")
    losses = [float(x) for x in losses]
    failed = sum(not math.isfinite(x) for x in losses)
    log(f"portbench: {data.rounds} rounds in {data.window_s:.4f} s, "
        f"setup {data.setup_s:.4f} s, peak {data.peak_bytes} bytes, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if len(data.round_ms) >= 2:
        q = statistics.quantiles(data.round_ms, n=10)
        log(f"portbench: round ms over {len(data.round_ms)} rounds: "
            f"median {statistics.median(data.round_ms):.3f}, p90 {q[-1]:.3f}"
            f", max {max(data.round_ms):.3f}")

    # ---------------------------------------------------------- check
    del state, prog, tokens, labels, losses
    empty_cache(device)
    t_ref = time.perf_counter()
    ref = reference_readout(conf, tr, inputs, others=[readout])
    del readout["vec"]
    log(f"portbench: reference in {time.perf_counter() - t_ref:.1f} s")
    numbers = check.compare(readout, ref)
    correct, shown = check.verdict(numbers, bench.limits(name))
    correct = correct and failed == 0

    # ---------------------------------------------------------- result
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in bench.metrics(name, kind):
        value = bench.reader(m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": data.peak_bytes}
    result = {"correct": bool(correct), "attempted": data.rounds,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced and data.trace is not None:
        dev["busy_s"] = data.trace.busy_s()
        dev["window_s"] = data.trace.window_s
        result["breakdown"] = data.trace.breakdown()
    for k, v in shown.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    result["check"] = shown
    return result
