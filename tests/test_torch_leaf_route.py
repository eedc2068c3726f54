"""The Sophia step's leaf route on the CPU (no JAX needed): the engine's
step at the loss/grad boundary (`kernels/sophia_update.py:
sophia_update_leaves`), which reads the grads and h_hat as autograd's
leaves and stores the next forward's params leaves itself.

* Its plain version is bitwise the packed route it replaces: the grads
  and h_hat packed to fp32, the flat step, the params unpacked; fp32,
  bf16 and mixed leaves, lead ``()`` and ``(N,)``, h_hat as leaves or as
  the zero buffer, a grad with its last two axes swapped.
* A model of the kernel's table and indexing (the run body, the tile
  body, the block search, a table split past `BOUNDARY_MAX_LEAVES`)
  over `_boundary_rows`' rows covers every leaf coordinate once, reads
  each operand where the pointers say, and gives the plain version's
  bits; the CUDA source walks the same indices (held on the card by
  tests/test_torch_kernels_cuda.py).
* Engine rounds on the leaf route are bitwise the packed route's in the
  params, m, h and losses: the MLP's fp32 leaves and LM bf16 leaves,
  parallel and sequential, refresh and plain steps, two micro-batches,
  round-mode h_hat, an int8 uplink; a narrow ``state_dtype`` keeps the
  packed route.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.comm.flat import flat_spec, pack, unpack
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core import fed as tfed
from repro_torch.core import sophia as tsophia
from repro_torch.core.fed import FedEngine
from repro_torch.kernels import sophia_update as tk
from repro_torch.kernels.ref import sophia_update_ref
from repro_torch.models import transformer as TT
from repro_torch.models.small import MLPTask
from repro_torch.obs import counters

HP = dict(beta1=0.9, beta2=0.95, rho=0.04, eps=1e-12, weight_decay=1e-4)
LR = 3e-3
BF = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Small CPU ops on one intra-op thread: under pytest-xdist the
    default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(shapes, dtypes, lead, seed, scale=1.0, swap=()):
    """Leaves ``(*lead, *shape)`` of random values (non-negative for
    ``scale`` < 0); the keys in ``swap`` stored with their last two
    axes swapped."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for (k, shp), dt in zip(shapes.items(), dtypes):
        x = torch.randn(lead + shp, generator=g)
        x = (x.abs() * -scale if scale < 0 else x * scale).to(dt)
        if k in swap:
            x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
        out[k] = x
    return out


def _state(spec, lead, seed):
    """fp32 theta, m, h in ``spec``'s layout, zero past the leaves (as
    every resident buffer is), a few h exactly 0."""
    g = torch.Generator().manual_seed(seed)
    bufs = []
    for scale in (1.0, 0.1, 0.01):
        x = torch.randn(lead + (spec.padded,), generator=g) * scale
        x[..., spec.total:] = 0
        bufs.append(x.reshape(lead + (spec.rows, spec.cols)))
    bufs[2] = bufs[2].abs()
    bufs[2].reshape(-1)[::7] = 0
    return bufs


SHAPES = {"a": (6, 10), "b": (7,), "c": (3, 5, 9), "d": (13, 8)}
MIXES = {"fp32": [torch.float32] * 4, "bf16": [BF] * 4,
         "mixed": [BF, torch.float32, BF, torch.float32]}


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("refresh", [True, False])
def test_plain_version_is_pack_step_unpack(lead, mix, refresh):
    dtypes = MIXES[mix]
    params = _tree(SHAPES, dtypes, (), 0)
    spec = flat_spec(params, cols=16)
    theta, m, h = _state(spec, lead, 1)
    grads = _tree(SHAPES, dtypes, lead, 2, swap=("a", "c"))
    h_hat = (_tree(SHAPES, dtypes, lead, 3, scale=-1.0, swap=("d",))
             if refresh else torch.zeros_like(theta))
    hh_flat = pack(h_hat, spec) if refresh else h_hat
    want = sophia_update_ref(theta, m, h, pack(grads, spec), hh_flat,
                             refresh, lr=LR, **HP)
    want_leaves = unpack(want[0], spec)
    out = {k: torch.full(lead + SHAPES[k], float("nan"), dtype=dt)
           for k, dt in zip(SHAPES, dtypes) if dt != torch.float32}
    got = tk.sophia_update_leaves(*(x.clone() for x in (theta, m, h)),
                                  grads, h_hat, refresh, LR, spec=spec,
                                  out=out, **HP)
    for w, g in zip(want, got[:3]):
        assert torch.equal(w, g)
    assert got[3] is out
    for k, v in out.items():
        assert torch.equal(v, want_leaves[k])
    # no store asked: the step alone
    again = tk.sophia_update_leaves(*(x.clone() for x in (theta, m, h)),
                                    grads, h_hat, refresh, LR, spec=spec,
                                    **HP)
    assert all(torch.equal(w, g) for w, g in zip(want, again[:3]))


def test_route_choice_and_readable_layouts():
    f32 = torch.zeros(2, 4, 8)
    assert tk.takes_leaves(f32, f32, f32)
    assert not tk.takes_leaves(f32, f32.to(BF), f32)
    assert not tk.takes_leaves(f32, f32, f32.to(torch.float8_e4m3fn))
    assert not tk.takes_leaves(f32[0, 0], f32[0, 0], f32[0, 0])
    x = torch.arange(105.0).reshape(3, 5, 7)
    assert not tk.swapped(x, 1)
    sw = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert tk.swapped(sw, 1)
    # a swap of the client axis with the leaf's own is no leaf layout,
    # nor is a strided slice: the kernel reads copies of those
    odd = {"t": torch.arange(15.0).reshape(5, 3).t(), "s": x[:, :, ::2]}
    tree = {"x": x, "sw": sw, **odd}
    got = tk._readable(tree, 1)
    assert got["x"] is x and got["sw"] is sw
    for k, v in odd.items():
        assert not tk.swapped(v, 1)
        assert got[k].is_contiguous() and torch.equal(got[k], v)
    assert tk._readable(x, 1) is x              # a buffer h_hat as it is


def _storage_of(ptr, tensors):
    """The 1-D typed view of the storage holding address ``ptr`` among
    ``tensors``, and ``ptr``'s element index in it."""
    for x in tensors:
        st = x.untyped_storage()
        if st.data_ptr() <= ptr < st.data_ptr() + st.nbytes():
            flat = torch.tensor([], dtype=x.dtype).set_(st)
            return flat, (ptr - st.data_ptr()) // x.element_size()
    raise AssertionError(f"pointer {ptr:#x} lies in no operand")


def _kernel_model(theta, m, h, grads, h_hat, out, spec, do_h):
    """The leaf-boundary kernel's walk over its table, in Python: per
    launch part, per client (the grid's y) and block, the leaf by the
    block search, the block's coordinates by the run or tile body, each
    operand read at the address the row gives it.  Returns the updated
    copies of theta, m, h and the coverage count a flat coordinate."""
    block, tile = tk.BOUNDARY_BLOCK, tk.BOUNDARY_TILE
    threads = 256
    rows = tk._boundary_rows(theta, m, h, grads, h_hat, out, spec)
    lead = tuple(theta.shape[:-2])
    clients = math.prod(lead)
    src = [theta, m, h]
    flat = [x.reshape(clients, spec.padded) for x in src]
    new = [x.clone().reshape(clients, spec.padded) for x in src]
    seen = torch.zeros(clients, spec.padded, dtype=torch.int64)
    tensors = list(grads.values()) + list(out.values()) + (
        [h_hat] if torch.is_tensor(h_hat) else list(h_hat.values()))
    e = torch.arange(2 * threads)                   # a block's groups
    for s in range(0, len(rows), tk.BOUNDARY_MAX_LEAVES):
        part = rows[s:s + tk.BOUNDARY_MAX_LEAVES]
        first = [0]
        for row in part:
            first.append(first[-1] + row[4])
        for c in range(clients):
            for b in range(first[-1]):
                lo, hi = 0, len(part) - 1
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    lo, hi = (mid, hi) if first[mid] <= b else (lo, mid - 1)
                (off, n, mats, r, k), ptrs, cs, flags, _ = part[lo]
                t = b - first[lo]
                q = torch.arange(4)
                if not flags[6]:
                    # four consecutive coordinates a group
                    i = (t * block + 4 * e[:, None] + q).reshape(-1)
                    i = i[i < n]
                    mat = row_ = col = None
                else:
                    tk_, tr_ = -(-k // tile[1]), -(-r // tile[0])
                    a = t // (tr_ * tk_)
                    r0 = t // tk_ % tr_ * tile[0]
                    k0 = t % tk_ * tile[1]
                    row_ = (r0 + e // (tile[1] // 4))[:, None].expand(-1, 4)
                    col = k0 + 4 * (e % (tile[1] // 4))[:, None] + q
                    keep = (row_ < r) & (col < k)
                    row_, col = row_[keep], col[keep]
                    mat = a * r * k
                    i = mat + row_ * k + col
                fidx = c * spec.padded + off + i
                v = [x.reshape(-1)[fidx] for x in flat]
                for j in range(2):
                    where = (mat + col * r + row_ if flags[3 + j]
                             else i) + c * cs[j]
                    mem, base = _storage_of(ptrs[j], tensors)
                    v.append(mem[base + where].float())
                res = sophia_update_ref(*v, do_h, lr=LR, **HP)
                for dst, val in zip(new, res):
                    dst.reshape(-1)[fidx] = val
                if ptrs[2]:
                    mem, base = _storage_of(ptrs[2], tensors)
                    mem[base + c * n + i] = res[0].to(mem.dtype)
                seen.reshape(-1)[fidx] += 1
    return [x.reshape(theta.shape) for x in new], seen


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("case", ["aligned", "odd", "past-the-cap"])
def test_kernel_model_covers_each_coordinate_once(lead, case):
    if case == "aligned":
        shapes = {"emb": (96, 128), "norm": (128,), "w": (2, 40, 64)}
        swap = ("emb", "w")
    elif case == "odd":
        # odd sizes put every later leaf at an unaligned offset
        shapes = {"a": (37, 70), "b": (5,), "c": (3, 33, 65), "d": (2051,)}
        swap = ("a", "c")
    else:
        shapes = {f"l{i:02d}": ((i % 5) + 1, 3 + (i % 4))
                  for i in range(tk.BOUNDARY_MAX_LEAVES + 5)}
        swap = ("l03", "l34")
    dtypes = [BF if i % 3 else torch.float32 for i in range(len(shapes))]
    params = _tree(shapes, dtypes, (), 0)
    spec = flat_spec(params, cols=64)
    theta, m, h = _state(spec, lead, 1)
    grads = _tree(shapes, dtypes, lead, 2, swap=swap)
    for refresh in (True, False):
        h_hat = (_tree(shapes, dtypes, lead, 3, scale=-1.0, swap=swap[:1])
                 if refresh else torch.zeros_like(theta))
        out = {k: torch.empty(lead + shp, dtype=dt)
               for (k, shp), dt in zip(shapes.items(), dtypes)
               if dt != torch.float32}
        mine = {k: v.clone() for k, v in out.items()}
        got, seen = _kernel_model(theta, m, h, grads, h_hat, mine, spec,
                                  refresh)
        want = tk.sophia_update_leaves(*(x.clone() for x in (theta, m, h)),
                                       grads, h_hat, refresh, LR,
                                       spec=spec, out=out, **HP)
        per = seen.reshape(-1, spec.padded)
        assert bool((per[:, :spec.total] == 1).all())
        assert bool((per[:, spec.total:] == 0).all())
        for w, g in zip(want[:3], got):
            assert torch.equal(w, g)
        for k in out:
            assert torch.equal(out[k], mine[k])
    rows = tk._boundary_rows(theta, m, h, grads, h_hat, out, spec)
    vec = {k: bool(r[3][5]) for k, r in zip(spec.keys, rows)}
    tiled = {k: bool(r[3][6]) for k, r in zip(spec.keys, rows)}
    assert tiled == {k: k in swap for k in spec.keys}
    if case == "aligned":
        assert all(vec.values())
    elif case == "odd":
        assert not vec["b"] and not vec["c"]


def _mlp(strategy, C=3, J=3, tau=2, **kw):
    fed = FedConfig(num_clients=C, local_iters=J, tau=tau, lr=0.02,
                    strategy=strategy, **kw)
    eng = FedEngine(MLPTask(hidden=16), fed, device="cpu")
    g = torch.Generator().manual_seed(5)
    batches = {"x": torch.randn(C, 8, 784, generator=g),
               "y": torch.randint(0, 10, (C, 8), generator=g)}
    return eng, eng.task.init(torch.Generator().manual_seed(0), "cpu"), \
        batches


def _lm(arch, strategy, C=2, J=2, tau=2, **kw):
    cfg = dataclasses.replace(
        configs.get_model_config(arch).reduced(d_model=64), num_layers=2)
    fed = FedConfig(num_clients=C, local_iters=J, tau=tau, lr=1e-3,
                    strategy=strategy, **kw)
    eng = FedEngine(TT.LMTask(cfg), fed, device="cpu")
    g = torch.Generator().manual_seed(1)
    batches = {k: torch.randint(0, cfg.vocab_size, (C, 2, 8), generator=g)
               for k in ("tokens", "labels")}
    return eng, eng.task.init(torch.Generator().manual_seed(0), "cpu"), \
        batches


def _rounds(eng, params, batches, leafy, monkeypatch, rounds=3):
    """``rounds`` rounds on the leaf route or forced off it; the state,
    the losses and the leaf-route steps counted."""
    steps = []
    real = tsophia.sophia_update_leaves
    monkeypatch.setattr(tsophia, "sophia_update_leaves",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    if not leafy:
        monkeypatch.setattr(tfed, "takes_leaves", lambda *a: False)
    state = eng.pack_state(eng.init_from_params(
        {k: v.clone() for k, v in params.items()}))
    gen = torch.Generator().manual_seed(3)
    losses = []
    for _ in range(rounds):
        state, met = eng.round(state, batches, generator=gen)
        losses.append(met["loss"])
    monkeypatch.undo()
    return state, losses, len(steps)


ENGINES = {
    "mlp-parallel": lambda: _mlp("parallel"),
    "mlp-sequential": lambda: _mlp("sequential"),
    "mlp-round-mode": lambda: _mlp("parallel", hessian_every_unit="round"),
    "mlp-microbatch2": lambda: _mlp("parallel", grad_microbatches=2),
    "mlp-bidir-int8": lambda: _mlp("parallel", comm=CommConfig(
        compressor="int8", downlink_compressor="int8",
        participation=2 / 3)),
    "lm-parallel": lambda: _lm("minicpm-2b", "parallel"),
    "lm-sequential-int8": lambda: _lm("deepseek-v2-lite-16b", "sequential",
                                      comm=CommConfig(compressor="int8")),
    "lm-microbatch2": lambda: _lm("minicpm-2b", "parallel",
                                  grad_microbatches=2),
    "lm-round-mode": lambda: _lm("gemma2-9b", "parallel", J=3,
                                 hessian_every_unit="round"),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_leaf_route_is_bitwise_the_packed_route(case, monkeypatch):
    eng, params, batches = ENGINES[case]()
    a, la, steps = _rounds(eng, params, batches, True, monkeypatch)
    b, lb, none = _rounds(eng, params, batches, False, monkeypatch)
    fed = eng.fed
    per_round = fed.local_iters * (1 if fed.strategy == "parallel"
                                   else fed.comm.num_participants(
                                       fed.num_clients))
    assert (steps, none) == (3 * per_round, 0)
    assert torch.equal(a["params"], b["params"])
    assert torch.equal(a["client_opt"].m, b["client_opt"].m)
    assert torch.equal(a["client_opt"].h, b["client_opt"].h)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_narrow_state_keeps_the_packed_route(monkeypatch):
    eng, params, batches = _lm("minicpm-2b", "parallel",
                               comm=CommConfig(state_dtype="bfloat16"))
    state, losses, steps = _rounds(eng, params, batches, True, monkeypatch,
                                   rounds=2)
    assert steps == 0
    assert state["client_opt"].m.dtype == BF
    assert all(torch.isfinite(x) for x in losses)


def test_leaf_route_share_counts_steps():
    tk.reset_launches()
    assert counters.sophia_leaf_route_share() is None
    tk.STEPS["sophia_update_leaves"] = 6
    tk.LAUNCHES["sophia_update_leaves"] = 9     # a split table
    assert counters.sophia_leaf_route_share() == 1.0
    tk.LAUNCHES["sophia_update_batched"] = 2
    assert counters.sophia_leaf_route_share() == 0.75
    tk.reset_launches()
    assert tk.STEPS == {"sophia_update_leaves": 0}
