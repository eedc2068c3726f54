"""Per-block remat, the layer stacks' single unbind and the round's
in-place aggregate of the port, on the CPU (no JAX needed).

* Remat (``ModelConfig.train_remat``, on by default as in the JAX
  package) runs each block under non-reentrant `torch.utils.checkpoint`:
  the loss, its grads, the GNB estimate and DONE's Hessian-vector
  products (double backward) are bitwise those without it, for a dense
  attention arch, the MoE arch and a recurrent arch (reduced, 2
  layers); it saves fewer bytes for the backward; the training path
  checkpoints every block, stacked and remainder alike, and prefill and
  serving never enter `checkpoint`.
* `transformer._blocks` unbinds each stack once: the backward of a
  stacked forward runs no ``select_backward`` and no add over a whole
  stack, and its grads are bitwise the per-layer ``select`` form's.
* The packed-resident round writes its new model (and FedAdam's m and
  v) into the resident buffers: their storage is the same after a
  round, on the direct (parallel and sequential), int8 and FedAdam
  rounds, fp32 and bf16.
"""
import dataclasses

import pytest
import torch
from torch.utils import checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.core.gnb import gnb_estimate, leaf_grads
from repro_torch.examples import serve_batched
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.small import MLPTask
from test_torch_op_cost import one_cpu_thread  # noqa: F401 (autouse)

#: a dense attention arch, the MoE (and MLA) arch, a recurrent arch
ARCHS = ("minicpm-2b", "deepseek-v2-lite-16b", "xlstm-1.3b")
B, S = 2, 8


def _cfg(arch, remat, **replace):
    cfg = configs.get_model_config(arch).reduced(d_model=64)
    return dataclasses.replace(cfg, train_remat=remat, **replace)


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}


def _train_outputs(cfg, params, batch):
    """The loss and its grads, the GNB estimate and one DONE step (five
    power iterations and a Richardson step of HVPs by double backward)
    of ``cfg``'s task on ``params``."""
    task = TT.LMTask(cfg)
    pg = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = task.loss(pg, batch)
    grads = leaf_grads(loss.sum(), list(pg.values()))
    gumbel = -torch.log(-torch.log(torch.rand(
        (B, S, cfg.vocab_padded), generator=torch.Generator().manual_seed(5))))
    h = gnb_estimate(task, params, batch, gumbel)
    engine = FedEngine(task, FedConfig(num_clients=1, optimizer="done",
                                       done_richardson_iters=1, lr=1.0),
                       device="cpu")
    spec = engine.runtime_for(params).spec
    theta = engine.pack_state(engine.init_from_params(params))["params"]
    done, _ = engine._local_done_flat(spec, theta.to(torch.float32), batch,
                                      1.0)
    return [loss.detach()] + grads + [h[k] for k in sorted(h)] + [done]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_no_remat(arch):
    on, off = _cfg(arch, True), _cfg(arch, False)
    params = TT.init_lm(torch.Generator().manual_seed(0), on)
    batch = _batch(on)
    got, want = (_train_outputs(c, params, batch) for c in (on, off))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), (arch, i)


def _saved_bytes(cfg, params, batch):
    """The bytes the loss's graph saves for its backward, counted by a
    `saved_tensors_hooks` around the forward (a checkpointed block saves
    its inputs, not its activations)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    pg = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TT.LMTask(cfg).loss(pg, batch)
    return sum(seen.values())


def test_remat_saves_less():
    on, off = (_cfg("minicpm-2b", r, num_layers=4) for r in (True, False))
    params = TT.init_lm(torch.Generator().manual_seed(0), on)
    batch = _batch(on)
    kept, full = (_saved_bytes(c, params, batch) for c in (on, off))
    assert 0 < kept < full, (kept, full)


def test_train_path_checkpoints_every_block(monkeypatch):
    """recurrentgemma-2b at 5 layers: one (rec, rec, local) pattern
    stacked once and two remainder blocks, each through `checkpoint`
    (none with remat off)."""
    calls = []
    real = checkpoint.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)
    monkeypatch.setattr(checkpoint, "checkpoint", counted)
    for remat, want in ((True, 5), (False, 0)):
        calls.clear()
        cfg = _cfg("recurrentgemma-2b", remat, num_layers=5)
        assert (cfg.pattern_reps, len(cfg.pattern_remainder)) == (1, 2)
        params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
        TT.LMTask(cfg).loss(params, _batch(cfg))
        assert len(calls) == want
        assert all(kw == dict(use_reentrant=False, preserve_rng_state=False)
                   for kw in calls)


def test_serving_never_remats(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("serving entered checkpoint")
    monkeypatch.setattr(checkpoint, "checkpoint", refused)
    cfg = _cfg("minicpm-2b", True)
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="remat=False"):
        TT.forward(params, cfg, _batch(cfg), want_cache=True)
    with torch.no_grad():
        _, cache, _ = TT.forward(params, cfg, _batch(cfg), want_cache=True,
                                 remat=False)
    assert cache
    serve.main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu",
                "--batch", "1", "--prompt-len", "8", "--gen", "2"])
    res = serve_batched.main(["--arch", "chatglm3-6b", "--device", "cpu",
                              "--batch", "1", "--prompt-len", "8",
                              "--gen", "2"])
    assert res["tokens"].shape == (1, 2)


class _OpLog(TorchDispatchMode):
    """Each aten op's name and its output's shape."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else None
        self.ops.append((str(func.overloadpacket.__name__), shape))
        return out


def _select_blocks(params, cfg):
    """The per-layer ``select`` form `_blocks` replaced."""
    n_lead = TT._n_lead(params)
    for pi, kind in enumerate(cfg.block_pattern):
        stacked = L.subtree(params, f"blocks_{pi}")
        for layer in range(cfg.pattern_reps):
            yield {k: v.select(n_lead, layer)
                   for k, v in stacked.items()}, kind
    for ri, kind in enumerate(cfg.pattern_remainder):
        yield L.subtree(params, f"rem_{ri}"), kind


@pytest.mark.parametrize("remat", [False, True])
def test_stacks_are_unbound_once(monkeypatch, remat):
    cfg = _cfg("minicpm-2b", remat, num_layers=8)
    assert cfg.pattern_reps == 8
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    batch = _batch(cfg)
    task = TT.LMTask(cfg)
    stacked = [k for k in params if k.startswith("blocks_")]
    stacks = {tuple(params[k].shape) for k in stacked}

    def grads():
        pg = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = task.loss(pg, batch)
        with _OpLog() as log:
            g = leaf_grads(loss.sum(), list(pg.values()))
        return g, log.ops
    got, ops = grads()
    names = [name for name, _ in ops]
    assert "select_backward" not in names
    assert not [op for op in ops if op[0].startswith("add")
                and op[1] in stacks], "an add over a whole stack"
    assert names.count("stack") == len(stacked)
    monkeypatch.setattr(TT, "_blocks", _select_blocks)
    want, ops = grads()
    assert [name for name, _ in ops].count("select_backward") == 8 * len(
        stacked)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _mlp_engine(**kw):
    fed = FedConfig(num_clients=4, local_iters=2, tau=2, lr=0.02,
                    total_rounds=4, **kw)
    return FedEngine(MLPTask(hidden=16), fed, device="cpu")


def _mlp_batches(seed):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn((4, 8, 28, 28, 1), generator=g),
            "y": torch.randint(0, 10, (4, 8), generator=g)}


ROUNDS_IN_PLACE = {
    "direct-parallel": dict(strategy="parallel"),
    "direct-sequential": dict(strategy="sequential"),
    "int8": dict(strategy="parallel", comm=CommConfig(compressor="int8")),
    "fedadam": dict(strategy="parallel", optimizer="fedadam"),
    "direct-parallel-bf16": dict(strategy="parallel", comm=CommConfig(
        state_dtype="bfloat16")),
    "fedadam-bf16": dict(strategy="parallel", optimizer="fedadam",
                         comm=CommConfig(state_dtype="bfloat16")),
}


@pytest.mark.parametrize("name", list(ROUNDS_IN_PLACE))
def test_round_keeps_resident_storage(name):
    engine = _mlp_engine(**ROUNDS_IN_PLACE[name])
    state = engine.pack_state(engine.init(torch.Generator().manual_seed(0)))

    def storages(s):
        out = {"params": s["params"]}
        if "server_opt" in s:
            out.update({f"server_opt/{k}": v
                        for k, v in s["server_opt"].items()})
        if "client_opt" in s:
            out.update(m=s["client_opt"].m, h=s["client_opt"].h)
        return {k: v.untyped_storage().data_ptr() for k, v in out.items()}
    before = storages(state)
    assert ("server_opt/m" in before) == ("fedadam" in name)
    for r in range(2):
        prev = state["params"].clone()
        state, m = engine.round(state, _mlp_batches(r),
                                generator=torch.Generator().manual_seed(r))
        assert torch.isfinite(m["loss"])
        assert not torch.equal(state["params"], prev)
        assert storages(state) == before
