"""The round's phase ranges (`repro_torch.obs.spans.PHASES`) on the
CPU, through `FedEngine.round` under `torch.profiler` (no JAX needed):
a tiny LM on the direct parallel path, the sequential int8 comm path,
and a depth cut below the block pattern, whose empty stacks are leaves
that no op reaches.

Each phase opens the expected number of times a round, its backward
ranges included (opened and closed: a range left open is no event of
the profile); no phase range nests in another; every GEMM of the round
lies inside one; outside a profile no hook is registered; and the state
after a round is bitwise the same with and without the profiler.
"""
import dataclasses
import gc
import threading
import weakref

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.models import recurrent
from repro_torch.models import transformer as TT
from repro_torch.obs import spans
from test_torch_op_cost import one_cpu_thread  # noqa: F401 (autouse)

B, S, C, J = 1, 8, 2, 2
GEMMS = ("aten::mm", "aten::bmm", "aten::addmm")

#: (arch, layers, strategy, compressor, each phase's ranges in a round)
#: at C=2 clients, J=2 local steps, a GNB refresh at the first: per
#: client step, loss/grad opens forward and backward; the GNB its
#: draw, forward, backward, B g g and the zero h_hat; pack theta's
#: cast, the working copy and the one cast of the params leaves (the
#: Sophia step reads the grads and h_hat as leaves and writes the next
#: step's params leaves itself: no grad here needs a contiguous copy,
#: the tied embedding's comes back swapped, which the step reads)
CASES = {
    "direct-parallel": ("minicpm-2b", 2, "parallel", "identity", {
        "fed.loss_grad": 2 * J, "fed.gnb": 5, "fed.pack": 2 + 1,
        "fed.optimizer": J, "fed.comm": 0, "fed.aggregate": 5}),
    "sequential-int8": ("deepseek-v2-lite-16b", 2, "sequential", "int8", {
        "fed.loss_grad": C * 2 * J, "fed.gnb": C * 5,
        "fed.pack": 1 + C * (1 + 1), "fed.optimizer": C * J,
        "fed.comm": 3 + C, "fed.aggregate": 7 + C * 3}),
    "unreached-leaf": ("gemma2-9b", 1, "parallel", "identity", {
        "fed.loss_grad": 2 * J, "fed.gnb": 5, "fed.pack": 2 + 1,
        "fed.optimizer": J, "fed.comm": 0, "fed.aggregate": 5}),
}


def _engine(arch, layers, strategy, compressor):
    cfg = dataclasses.replace(
        configs.get_model_config(arch).reduced(d_model=64),
        num_layers=layers)
    fed = FedConfig(num_clients=C, local_iters=J, tau=J, lr=1e-3,
                    strategy=strategy,
                    comm=CommConfig(compressor=compressor))
    engine = FedEngine(TT.LMTask(cfg), fed, device="cpu")
    params = engine.task.init(torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    batches = {k: torch.randint(0, cfg.vocab_size, (C, B, S), generator=g)
               for k in ("tokens", "labels")}
    return engine, params, batches


def _round(engine, params, batches):
    state = engine.pack_state(engine.init_from_params(
        {k: v.clone() for k, v in params.items()}))
    state, _ = engine.round(state, batches,
                            generator=torch.Generator().manual_seed(3))
    return state


def _flat(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, tuple):
            out.update({f"{k}.{i}": x for i, x in enumerate(v)})
        elif torch.is_tensor(v):
            out[k] = v
    return out


def _inside(e, outer):
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("case", list(CASES))
def test_round_phase_ranges(case):
    arch, layers, strategy, compressor, want = CASES[case]
    engine, params, batches = _engine(arch, layers, strategy, compressor)
    if case == "unreached-leaf":
        task, pg = engine.task, {k: v.detach().requires_grad_(True)
                                 for k, v in params.items()}
        grads = torch.autograd.grad(
            task.loss(pg, {k: v[0] for k, v in batches.items()}).sum(),
            list(pg.values()), allow_unused=True)
        assert any(g is None for g in grads)
    plain = _round(engine, params, batches)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _round(engine, params, batches)
    a, b = _flat(plain), _flat(traced)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a), "the ranges moved a value"

    events = prof.events()
    rounds = [e for e in events if e.name == spans.ROUND_SPAN]
    assert len(rounds) == 1
    phases = [e for e in events if e.name in spans.PHASES]
    got = {p: sum(e.name == p for e in phases) for p in spans.PHASES}
    assert got == want
    assert all(_inside(e, rounds[0]) for e in phases)
    # the backward ranges: one a loss/grad step and one a GNB estimate,
    # each holding the autograd engine's nodes
    backward = [e for e in phases if any(
        c.name.startswith("autograd::engine::evaluate_function")
        for c in e.cpu_children)]
    assert sum(e.name == spans.LOSS_GRAD for e in backward) \
        == want["fed.loss_grad"] // 2
    assert sum(e.name == spans.GNB for e in backward) == want["fed.gnb"] // 5
    for x in phases:
        assert not any(y is not x and _inside(y, x) for y in phases), x.name
    gemms = [e for e in events if e.name in GEMMS]
    assert gemms
    assert all(any(_inside(e, p) for p in phases) for e in gemms)


def test_no_hook_outside_a_profile(monkeypatch):
    """A round outside a profile registers no autograd hook; inside one,
    the backward ranges' hooks."""
    calls = []
    real = torch.autograd.graph.register_multi_grad_hook

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        counted)
    real_hook = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda self, fn: calls.append(1) or real_hook(self,
                                                                      fn))
    engine, params, batches = _engine(*CASES["direct-parallel"][:4])
    _round(engine, params, batches)
    assert calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _round(engine, params, batches)
    assert calls


def test_spanned_backward_range_holds_no_tensor(monkeypatch):
    """`spanned`'s backward range opens and closes on one thread, skips
    an input that no op reaches, leaves grads as they were and, its
    hooks removed after the pass, keeps no tensor alive (freed without
    the collector)."""
    x = torch.randn(4, 3)
    leaves = [x[:2].detach().requires_grad_(True),
              x[2:].detach().requires_grad_(True),
              torch.zeros(0, 3, requires_grad=True)]
    want = torch.autograd.grad(
        (leaves[0] * leaves[1]).square().sum(), leaves[:2])
    threads = []
    real_rf = torch.profiler.record_function

    class recorded(real_rf):
        def __enter__(self):
            threads.append(("enter", self.name, threading.get_ident()))
            return super().__enter__()

        def __exit__(self, *exc):
            threads.append(("exit", self.name, threading.get_ident()))
            return super().__exit__(*exc)
    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    gc.disable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = spans.spanned("probe", lambda a, b, c: (a * b).square(),
                                leaves)
            got = torch.autograd.grad(out.sum(), leaves[:2])
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        refs = [weakref.ref(t) for t in leaves]
        del out, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
    assert sum(e.name == "probe" for e in prof.events()) == 2
    assert [k for k, n, _ in threads if n == "probe"] == [
        "enter", "exit", "enter", "exit"]
    assert len({t for _, n, t in threads if n == "probe"}) == 1


def test_one_range_helper():
    """The scans use the one forward-and-backward range helper."""
    assert recurrent.spanned is spans.spanned
    assert not hasattr(recurrent, "_spanned")
