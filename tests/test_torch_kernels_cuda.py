"""The port's CUDA kernels (the Sophia update and its pytree form, the six
quantize round-trip entry points, the four sign / top-k threshold entry
points, the stale accumulate and the robust combine) against their plain
PyTorch versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` (the kernel is built
from ``src/repro_torch/kernels/csrc`` at first use), so each is marked
``cuda`` and skips without a card.  The file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_kernels_cuda.py

Band: bitwise.  The kernel is built with ``-fmad=false`` and IEEE
division, and the plain version runs the same fp32 ops one by one, so
every stored bit agrees, narrow storage and overflow included.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.comm import flat as tflat
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref
from repro_torch.kernels import robust_agg as trobust
from repro_torch.kernels import sophia_update as tk
from repro_torch.kernels import stale_accum as tstale
from repro_torch.kernels.ref import sophia_update_ref
from repro_torch.obs import counters

HP = dict(beta1=0.9, beta2=0.95, rho=0.04, eps=1e-12, weight_decay=1e-4)
LR = 3e-3

STORES = {  # theta, m, h storage dtypes
    "fp32": (torch.float32,) * 3,
    "bf16": (torch.bfloat16,) * 3,
    "e4m3-e5m2": (torch.float32, torch.float8_e4m3fn, torch.float8_e5m2),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, device, seed=0, overflow=False):
    """theta, m, h, g, h_hat as fp32 on ``device`` (h, h_hat >= 0, every
    17th h exactly 0).  ``overflow`` scales g and h_hat so that m and h
    leave the fp8 ranges (|m| > 448, h > 57344) at some coordinates."""
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal(shape)
    m = 0.1 * rs.standard_normal(shape)
    h = np.abs(0.01 * rs.standard_normal(shape))
    h.reshape(-1)[::17] = 0.0
    g = 0.5 * rs.standard_normal(shape)
    hh = np.abs(0.02 * rs.standard_normal(shape))
    if overflow:
        g *= 1e4
        hh *= 1e8
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (theta, m, h, g, hh)]


def _bitwise(got, want):
    for gt, w in zip(got, want):
        assert gt.dtype == w.dtype and gt.shape == w.shape
        assert torch.equal(gt.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("do_h", [0, 1])
def test_batched_kernel_bitwise_vs_plain(card, store, do_h):
    xs = _inputs((3, 7, 1000), card, seed=4, overflow=store != "fp32")
    ins = [x.to(dt) for x, dt in zip(xs[:3], STORES[store])] + xs[3:]
    tk.reset_launches()
    got = tk.sophia_update_batched(*ins, do_h, LR, **HP)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sophia_update_batched"] == 1
    _bitwise(got, sophia_update_ref(*ins, do_h, lr=LR, **HP))


@pytest.mark.cuda
def test_flat_kernel_in_place_bitwise_vs_plain(card):
    ins = _inputs((7, 1000), card, seed=5)
    want = sophia_update_ref(*ins, 1, lr=LR, **HP)
    tk.reset_launches()
    got = tk.sophia_update_flat(*ins, 1, LR, inplace=True, **HP)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sophia_update_flat"] == 1
    assert all(a is b for a, b in zip(got, ins[:3]))
    _bitwise(got, want)


def _at_offset(x, offset):
    """A contiguous view of ``x``'s values ``offset`` elements into its
    storage (offset 1: not 16-byte aligned)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


SOPHIA_FORM_CASES = {  # name: (shape, storage offset, in place, fp32 form)
    "aligned": ((7, 1000), 0, False, True),
    "n%4=1": ((7, 999), 0, False, True),
    "n%4=3 in place": ((3, 7, 999), 0, True, True),
    "n=3": ((1, 3), 0, False, True),
    "offset 1": ((7, 1000), 1, False, False),
    "offset 1 in place": ((3, 7, 1000), 1, True, False),
    "offset 4": ((7, 999), 4, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOPHIA_FORM_CASES))
def test_sophia_kernel_forms_bitwise_vs_plain(card, name):
    """fp32 operands: the fp32 form when all eight pointers are 16-byte
    aligned (ragged n and in place included), the runtime-dtype form at
    storage offset 1; both bitwise the plain version."""
    shape, offset, inplace, f32x4 = SOPHIA_FORM_CASES[name]
    ins = [_at_offset(x, offset) for x in _inputs(shape, card, seed=7)]
    want = sophia_update_ref(*ins, 1, lr=LR, **HP)
    outs = ins[:3] if inplace else [torch.empty_like(x) for x in ins[:3]]
    assert tk.takes_f32x4(*outs, *ins) == f32x4
    entry = (tk.sophia_update_batched if len(shape) == 3
             else tk.sophia_update_flat)
    tk.reset_launches()
    got = entry(*ins, 1, LR, inplace=inplace, **HP)
    torch.cuda.synchronize()
    assert sum(tk.LAUNCHES.values()) == 1
    _bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["flat", "batched"])
def test_sophia_runtime_form_every_dtype_combination(card, entry):
    """Every storage dtype of each of the five operands but all-fp32 (the
    runtime-dtype form), with NaN, inf and fp8 overflow, bitwise."""
    base = _inputs((7, 999), card, seed=8, overflow=True)
    base[2][0, :5] = float("nan")
    base[3][1, :5] = float("inf")
    dtypes = list(AGG_STORES.values())
    combos = [c for c in itertools.product(dtypes, repeat=5)
              if any(dt != torch.float32 for dt in c)]
    fn = tk.sophia_update_flat if entry == "flat" else tk.sophia_update_batched
    tk.reset_launches()
    for combo in combos:
        ins = [x.to(dt) for x, dt in zip(base, combo)]
        if entry == "batched":
            ins = [x[None] for x in ins]
        assert not tk.takes_f32x4(*ins)
        got = fn(*ins, 0, LR, **HP)
        _bitwise(got, sophia_update_ref(*ins, 0, lr=LR, **HP))
    assert tk.LAUNCHES[f"sophia_update_{entry}"] == len(combos) == 1023


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_store_follows_torch_overflow_rule(card, dtype):
    """Past the fp8 range the kernel stores what ``Tensor.to`` gives on
    the card: with m = 0.1 * g and h = 0.05 * h_hat after one step, the
    stored m and h walk the boundary values."""
    edge = torch.tensor([0.0, 1e-3, 447.0, 448.0, 464.0, 470.0, 480.0, 1e5,
                         57344.0, 61439.0, 61440.0, 1e6, float("inf"),
                         float("nan")],
                        device=card)
    vals = torch.cat([edge, -edge])
    n = vals.numel()
    theta = torch.zeros(1, 1, n, device=card)
    m = torch.zeros(1, 1, n, device=card, dtype=dtype)
    h = torch.zeros(1, 1, n, device=card, dtype=dtype)
    g = (vals / 0.1).reshape(1, 1, n)
    hh = (vals.abs() / 0.05).reshape(1, 1, n)
    got = tk.sophia_update_batched(theta, m, h, g, hh, 1, LR, **HP)
    torch.cuda.synchronize()
    _bitwise(got, sophia_update_ref(theta, m, h, g, hh, 1, lr=LR, **HP))


@pytest.mark.cuda
def test_card_wrapper_rejects_strided_views(card):
    theta, m, h, g, hh = _inputs((7, 1000), card)
    shared = theta.expand(3, 7, 1000)       # the stride-0 start model
    stack = [x.expand(3, 7, 1000).contiguous() for x in (m, h, g, hh)]
    with pytest.raises(ValueError, match="contiguous"):
        tk.sophia_update_batched(shared, *stack, 1, LR, inplace=True, **HP)


QSTORES = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _quant_inputs(device, shape, store, shared, seed=0):
    """theta, other (start / ref), ef stored in ``store``; fp32 noise and
    the row scales of the corrected delta.  Every 7th row of theta and
    other is zero (scale 0); the scales of rows 1 mod 5 are quartered so
    codes clip at +-qmax."""
    rs = np.random.default_rng(seed)
    dt = QSTORES[store]
    theta = rs.standard_normal(shape)
    other = rs.standard_normal(shape[-2:] if shared else shape)
    theta[..., ::7, :] = 0.0
    other[..., ::7, :] = 0.0
    ef = 0.01 * rs.standard_normal(shape)
    ef[..., ::7, :] = 0.0
    t = [torch.tensor(x, dtype=torch.float32, device=device).to(dt)
         for x in (theta, other, ef)]
    f = [x.float() for x in t]
    scale = torch.amax(((f[0] - f[1]) + f[2]).abs(), -1, keepdim=True) / 7
    scale[..., 1::5, :] /= 4
    noise = torch.tensor(rs.uniform(size=shape), dtype=torch.float32,
                         device=device)
    return t + [noise, scale]


@pytest.mark.cuda
@pytest.mark.parametrize("store", list(QSTORES))
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
def test_quantize_kernels_bitwise_vs_plain(card, store, shared):
    """The six entry points at a ragged (3, 7, 1000), batched and flat,
    against the plain versions on the same card."""
    theta, other, ef, u, s = _quant_inputs(card, (3, 7, 1000), store, shared)
    flat_other = other if shared else other[1]
    calls = {
        "quant_roundtrip_batched": (
            lambda f: f(theta, u, s, qmax=7), ref.quant_roundtrip_ref),
        "quant_roundtrip_flat": (
            lambda f: f(theta[1], u[1], s[1], qmax=7),
            ref.quant_roundtrip_ref),
        "uplink_roundtrip_batched": (
            lambda f: f(theta, other, ef, u, s, qmax=7),
            ref.uplink_roundtrip_ref),
        "uplink_roundtrip_flat": (
            lambda f: f(theta[1], flat_other, ef[1], u[1], s[1], qmax=7),
            ref.uplink_roundtrip_ref),
        "broadcast_roundtrip_batched": (
            lambda f: f(other, theta, ef, u, s, qmax=7),
            ref.broadcast_roundtrip_ref),
        "broadcast_roundtrip_flat": (
            lambda f: f(flat_other, theta[1], ef[1], u[1], s[1], qmax=7),
            ref.broadcast_roundtrip_ref),
    }
    tq.reset_launches()
    for name, (call, plain) in calls.items():
        got = call(getattr(tq, name))
        torch.cuda.synchronize()
        assert tq.LAUNCHES[name] == 1
        want = call(lambda *a, qmax: plain(*a, qmax=qmax))
        _bitwise(got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,))


@pytest.mark.cuda
def test_quantize_kernels_pass_nan_through(card):
    theta, other, ef, u, s = _quant_inputs(card, (3, 7, 1000), "fp32", True)
    theta[0, 2, 5] = float("nan")
    s[1, 3, 0] = float("nan")
    s[2, 4, 0] = float("inf")
    got = tq.uplink_roundtrip_batched(theta, other, ef, u, s, qmax=127)
    _bitwise(got, ref.uplink_roundtrip_ref(theta, other, ef, u, s,
                                           qmax=127))
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.cuda
def test_quantize_wrappers_raise_on_card_inputs_they_do_not_take(card):
    theta, other, ef, u, s = _quant_inputs(card, (3, 7, 1000), "fp32", True)
    with pytest.raises(TypeError, match="noise"):
        tq.quant_roundtrip_batched(theta, u.double(), s, qmax=7)
    with pytest.raises(ValueError, match="contiguous"):
        tq.uplink_roundtrip_batched(theta, other.expand(3, 7, 1000), ef,
                                    u, s, qmax=7)
    with pytest.raises(ValueError, match="devices"):
        tq.broadcast_roundtrip_flat(other.cpu(), theta[0], ef[0], u[0],
                                    s[0], qmax=7)


def _biased_inputs(device, store, seed=0):
    """x ``(3, 7, 1000)`` in ``store`` with NaN, +-0 and +-inf and 8 ties
    at each client's threshold; one fp32 scalar per client (its mean |x|,
    rounded to ``store``; the last client's is 0)."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((3, 7, 1000)).astype(np.float32)
    flat = x.reshape(3, -1)
    v = torch.tensor(np.abs(flat).mean(-1)).to(QSTORES[store]).float()
    v[-1] = 0.0
    for n in range(3):
        pos = rs.choice(flat.shape[1], 14, replace=False)
        flat[n, pos[:8]] = float(v[n]) * np.array([1, -1] * 4, np.float32)
        flat[n, pos[8:]] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
    return (torch.tensor(x, device=device).to(QSTORES[store]),
            v.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("store", list(QSTORES))
def test_biased_kernels_bitwise_vs_plain(card, store):
    """The sign and threshold entry points, batched and flat, against
    their plain versions on the same card: bitwise, NaN and +-0 passed
    through (sign) or zeroed and kept (threshold) as jnp does."""
    x, v = _biased_inputs(card, store)
    calls = {
        "sign_roundtrip_batched": (lambda f: f(x, v),
                                   ref.sign_roundtrip_ref),
        "sign_roundtrip_flat": (lambda f: f(x[1], v[1]),
                                ref.sign_roundtrip_ref),
        "topk_threshold_batched": (lambda f: f(x, v),
                                   ref.topk_threshold_ref),
        "topk_threshold_flat": (lambda f: f(x[1], v[1]),
                                ref.topk_threshold_ref),
    }
    tq.reset_launches()
    for name, (call, plain) in calls.items():
        got = call(getattr(tq, name))
        torch.cuda.synchronize()
        assert tq.LAUNCHES[name] == 1
        _bitwise((got,), (call(plain),))
    if store == "fp32":
        sg = tq.sign_roundtrip_flat(x[0], v[0])
        nan, zero = torch.isnan(x[0]), x[0] == 0
        assert torch.equal(torch.isnan(sg), nan)
        assert torch.equal(torch.signbit(sg[zero]), torch.signbit(x[0][zero]))
        kept = tq.topk_threshold_flat(x[0], v[0])
        assert not bool(torch.isnan(kept).any())
        assert bool((kept[x[0].abs() == v[0]] != 0).all())


@pytest.mark.cuda
def test_biased_wrappers_raise_on_card_inputs_they_do_not_take(card):
    x, v = _biased_inputs(card, "fp32")
    with pytest.raises(ValueError, match="contiguous"):
        tq.sign_roundtrip_batched(x.transpose(1, 2), v)
    with pytest.raises(ValueError, match="contiguous"):
        tq.topk_threshold_batched(x, torch.stack([v, v], 1)[:, 0])
    with pytest.raises(TypeError, match="dtype"):
        tq.topk_threshold_flat(x[0].double(), v[0])
    with pytest.raises(TypeError, match="scale"):
        tq.sign_roundtrip_batched(x, v.double())
    with pytest.raises(ValueError, match="devices"):
        tq.sign_roundtrip_flat(x[0], v[0].cpu())


AGG_STORES = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _stack(card, K, shape, store, seed, special=True):
    """A (K, R, C) arrival stack stored in ``store``: arrivals 1 and 2
    tie, and with ``special`` NaN, +-inf and an all -inf coordinate."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((K,) + shape).astype(np.float32)
    if K > 2:
        x[2] = x[1]
    if special:
        flat = x.reshape(K, -1)
        for val in (np.nan, np.inf, -np.inf):
            flat[rs.integers(0, K, 40),
                 rs.integers(0, flat.shape[1], 40)] = val
        flat[:, 5] = -np.inf
    w = torch.tensor(rs.uniform(0.25, 2.0, K), dtype=torch.float32,
                     device=card)
    sc = torch.tensor(rs.uniform(0.5, 1.5, K), dtype=torch.float32,
                      device=card)
    return torch.tensor(x, device=card).to(AGG_STORES[store]), w, sc


def _same_fp32(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("store", list(AGG_STORES))
@pytest.mark.parametrize("K", [1, 2, 3, 7, 8, 9, 16, 17, 32, 33])
@pytest.mark.parametrize("shape,offset", [((7, 1000), 0), ((7, 1000), 1),
                                          ((7, 999), 0)],
                         ids=["vec4", "offset", "scalar"])
def test_stale_accum_kernel_bitwise_vs_plain(card, store, K, shape, offset):
    """Bitwise, with inv_norm 1, 1/sum(w) by value and as a device
    tensor, over the kernel's batches of sixteen loads and their tails;
    aligned fp32 stacks of a multiple of 4 coordinates take the
    float4 form, the rest (offset views, narrow wires) the
    one-coordinate form."""
    x, w, _ = _stack(card, K, shape, store, seed=K)
    x = _at_offset(x, offset)
    assert tstale.takes_f32x4(torch.empty(shape, device=card), x) == (
        store == "fp32" and shape == (7, 1000) and offset == 0)
    inv = float(np.float32(1.0) / np.float32(w.sum().item()))
    tstale.reset_launches()
    for s in (1.0, inv, torch.tensor([inv], device=card)):
        got = tstale.stale_accum_flat(x, w, s)
        torch.cuda.synchronize()
        _same_fp32(got, ref.stale_accum_ref(x, w, s))
    assert tstale.LAUNCHES["stale_accum_flat"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("store", list(AGG_STORES))
@pytest.mark.parametrize("K", [3, 16, 32, 65])
def test_robust_agg_kernel_bitwise_vs_plain(card, store, K):
    """Bitwise over trim 0, 1 and (K-1)//2 and both normalize settings,
    with scales != 1, ties, NaN and +-inf (K=65 takes the any-K form)."""
    x, w, sc = _stack(card, K, (5, 300), store, seed=100 + K)
    trobust.reset_launches()
    calls = 0
    for trim in sorted({0, 1, (K - 1) // 2}):
        for normalize in (True, False):
            got = trobust.robust_agg_flat(x, w, sc, trim=trim,
                                          normalize=normalize)
            torch.cuda.synchronize()
            calls += 1
            _same_fp32(got, ref.robust_agg_ref(x, w, sc, trim=trim,
                                               normalize=normalize))
    assert trobust.LAUNCHES["robust_agg_flat"] == calls


def _edge_stack(card, K, shape, seed):
    """A fp32 stack of heavy ties from {-FLT_MAX, -1, -0, +0, 1, FLT_MAX}:
    +-1 and +-0 only at even coordinates (the sort form), any of them at
    odd ones (+-FLT_MAX takes the pass form); unit scales."""
    rs = np.random.default_rng(seed)
    big = np.finfo(np.float32).max
    alphabet = np.array([-big, -1.0, -0.0, 0.0, 1.0, big], np.float32)
    flat = alphabet[rs.integers(0, 6, (K, int(np.prod(shape))))]
    flat[:, ::2] = alphabet[rs.integers(1, 5, flat[:, ::2].shape)]
    flat[:, ::16] = flat[0, ::16]
    w = torch.tensor(rs.uniform(0.25, 2.0, K), dtype=torch.float32,
                     device=card)
    return (torch.tensor(flat.reshape((K,) + shape), device=card), w,
            torch.ones(K, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["finite", "edges", "mixed"])
@pytest.mark.parametrize("K", [5, 16, 17, 32, 33, 64, 65])
def test_robust_agg_sort_form_bitwise_vs_plain(card, K, kind):
    """The sort form in each register bucket (16, 32, 64) and the any-K
    form: all-finite stacks with ties, +-FLT_MAX and +-0 ties, and stacks
    with a NaN or an inf at every third coordinate (every warp runs both
    forms); every trim, both normalize settings, bitwise."""
    if kind == "edges":
        x, w, sc = _edge_stack(card, K, (5, 300), seed=200 + K)
    else:
        x, w, sc = _stack(card, K, (5, 300), "fp32", seed=300 + K,
                          special=False)
        if kind == "mixed":
            flat = x.view(K, -1)
            cols = torch.arange(0, flat.shape[1], 3, device=card)
            gen = torch.Generator(card).manual_seed(K)
            rows = torch.randint(0, K, cols.shape, device=card,
                                 generator=gen)
            vals = torch.tensor([float("nan"), float("inf"), float("-inf")],
                                device=card)
            flat[rows, cols] = vals[(cols // 3) % 3]
    trobust.reset_launches()
    calls = 0
    for trim in range(0, (K - 1) // 2 + 1):
        for normalize in (True, False):
            got = trobust.robust_agg_flat(x, w, sc, trim=trim,
                                          normalize=normalize)
            torch.cuda.synchronize()
            calls += 1
            _same_fp32(got, ref.robust_agg_ref(x, w, sc, trim=trim,
                                               normalize=normalize))
    assert trobust.LAUNCHES["robust_agg_flat"] == calls


@pytest.mark.cuda
def test_robust_wrappers_raise_on_card_inputs_they_do_not_take(card):
    x, w, sc = _stack(card, 4, (3, 64), "fp32", seed=1)
    with pytest.raises(ValueError, match="2\\*trim"):
        trobust.robust_agg_flat(x, w, sc, trim=2)
    with pytest.raises(ValueError, match="weights on cpu"):
        trobust.robust_agg_flat(x, w.cpu(), sc, trim=1)
    with pytest.raises(ValueError, match="contiguous"):
        tstale.stale_accum_flat(x.transpose(1, 2), w, 1.0)
    with pytest.raises(ValueError, match="inv_norm on cpu"):
        tstale.stale_accum_flat(x, w, torch.ones(1))


@pytest.mark.cuda
def test_sophia_fused_step_bitwise_vs_plain(card):
    """The pytree route (one launch of the kernel's multi-leaf form)
    against the plain update of the same trees packed, then unpacked."""
    rs = np.random.default_rng(5)
    shapes = {"w1": (784, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)}

    def tree(scale, positive=False):
        t = {k: torch.tensor(scale * rs.standard_normal(s),
                             dtype=torch.float32, device=card)
             for k, s in shapes.items()}
        return {k: v.abs() for k, v in t.items()} if positive else t
    trees = [tree(1.0), tree(0.1), tree(0.01, True), tree(0.5),
             tree(0.02, True)]
    ops.reset_launches()
    got = ops.sophia_fused_step(*trees, 1, lr=LR, **HP)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sophia_fused_step"] == 1
    spec = tflat.flat_spec(trees[0], cols=ops.BLOCK_C)
    want = sophia_update_ref(*(tflat.pack(t, spec) for t in trees), 1,
                             lr=LR, **HP)
    for g, w in zip(got, want):
        for k, v in tflat.unpack(w, spec).items():
            _same_fp32(g[k], v)


@pytest.mark.cuda
def test_pytree_sophia_step_launches_fused_kernel(card):
    """`sophia_step` on CUDA trees takes the kernel route, one launch per
    step, and equals `sophia_fused_step` on the same trees bitwise."""
    from repro_torch.core import sophia as tsophia
    rs = np.random.default_rng(6)
    shapes = {"w1": (784, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)}

    def tree(scale, positive=False):
        t = {k: torch.tensor(scale * rs.standard_normal(s),
                             dtype=torch.float32, device=card)
             for k, s in shapes.items()}
        return {k: v.abs() for k, v in t.items()} if positive else t
    params, g, hh, m, h = (tree(1.0), tree(0.1), tree(0.01, True),
                           tree(0.5), tree(0.02, True))
    ops.reset_launches()
    got, state = tsophia.sophia_step(params, g, tsophia.SophiaState(m, h),
                                     hh, True, lr=LR, **HP)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sophia_fused_step"] == 1
    want = ops.sophia_fused_step(params, m, h, g, hh, True, lr=LR, **HP)
    for gt, wt in zip((got, state.m, state.h), want):
        for k in shapes:
            _same_fp32(gt[k], wt[k])


# ---------------------------------------- the pytree step's multi-leaf form
def _fused_plain(trees, do_h):
    """Row 3's plain version: the pack, the plain update, the unpack (all
    three results in the params leaves' dtypes)."""
    spec = tflat.flat_spec(trees[0], cols=ops.BLOCK_C)
    outs = sophia_update_ref(*(tflat.pack(t, spec) for t in trees), do_h,
                             lr=LR, **HP)
    return [tflat.unpack(o, spec) for o in outs]


def _trees_like(params, seed, overflow=False):
    """m, h, g, h_hat trees of ``params``' shapes: m and h in each params
    leaf's dtype (as `init_state` makes them), g and h_hat fp32.
    ``overflow`` scales g and h_hat past the fp8 ranges."""
    g = torch.Generator(device=next(iter(params.values())).device)
    g.manual_seed(seed)
    dev = g.device

    def like(scale, positive=False, keep_dtype=False):
        out = {}
        for k, v in params.items():
            t = scale * torch.randn(v.shape, generator=g, device=dev)
            t = t.abs() if positive else t
            out[k] = t.to(v.dtype) if keep_dtype else t
        return out
    big = 1e4 if overflow else 1.0
    return [params, like(0.1, keep_dtype=True),
            like(0.01, True, keep_dtype=True), like(0.5 * big),
            like(0.02 * big * big, True)]


def _check_fused(trees, launches, do_h=1):
    """One call of the pytree step on the card: ``launches`` launches of
    its kernel and none of the flat Sophia entry, every output leaf
    bitwise the plain version."""
    ops.reset_launches()
    tk.reset_launches()
    got = ops.sophia_fused_step(*trees, do_h, lr=LR, **HP)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sophia_fused_step"] == launches
    assert sum(tk.LAUNCHES.values()) == 0
    for g_, w_ in zip(got, _fused_plain(trees, do_h)):
        assert sorted(g_) == sorted(w_)
        for k in w_:
            assert g_[k].dtype == trees[0][k].dtype
            _bitwise((g_[k],), (w_[k],))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mlp128", "cnn"])
@pytest.mark.parametrize("do_h", [0, 1])
def test_fused_step_model_trees_one_launch(card, model, do_h):
    """The MLP-128 (six leaves, b3 of 10 coordinates) and CNN pytrees:
    one launch of the multi-leaf form, no pack, bitwise."""
    from repro_torch.models.small import CNNTask, MLPTask
    task = MLPTask(hidden=128) if model == "mlp128" else CNNTask(
        channels=(16, 32))
    params = task.init(torch.Generator(device=card).manual_seed(3), card)
    _check_fused(_trees_like(params, 4 + do_h), 1, do_h)


@pytest.mark.cuda
def test_fused_step_leaf_forms_and_dtypes(card):
    """Leaves that take each form in one launch: fp32 aligned, fp32 with
    n % 4 != 0 (1, 3, 10, 1001 coordinates), offset-1 views (the
    runtime-dtype form for that leaf only), one leaf per params dtype
    (fp32, bf16, e4m3, e5m2; m and h in the same dtype) with g and h_hat
    past the fp8 ranges, and a leaf whose m is stored narrower than its
    params leaf; NaN and inf in some leaves."""
    rs = np.random.default_rng(12)
    shapes = {"a": (64, 32), "b": (1,), "c": (3,), "d": (10,),
              "e": (7, 143), "f": (33, 64), "g": (40, 40), "h": (31,),
              "i": (2, 257), "j": (1000,)}
    params = {k: torch.tensor(rs.standard_normal(s), dtype=torch.float32,
                              device=card) for k, s in shapes.items()}
    params["f"] = _at_offset(params["f"], 1)
    params["g"] = params["g"].to(torch.bfloat16)
    params["h"] = params["h"].to(torch.float8_e4m3fn)
    params["i"] = params["i"].to(torch.float8_e5m2)
    trees = _trees_like(params, 13, overflow=True)
    trees[1]["j"] = trees[1]["j"].to(torch.bfloat16)     # m narrower
    trees[3]["a"] = _at_offset(trees[3]["a"], 1)          # g at offset 1
    trees[2]["e"][0, :3] = float("nan")
    trees[3]["d"][:2] = float("inf")
    leaves = [(k, (params[k],) * 3 + tuple(t[k] for t in trees))
              for k in sorted(params)]
    (table,) = ops.leaf_table(leaves, 1024)
    assert dict(zip(table.keys, table.f32x4)) == {
        "a": False, "b": True, "c": True, "d": True, "e": True, "f": False,
        "g": False, "h": False, "i": False, "j": False}
    for do_h in (0, 1):
        _check_fused(trees, 1, do_h)


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [32, 33, 98])
def test_fused_step_splits_past_the_cap(card, leaves):
    """More leaves than `ops.MAX_LEAVES`: one launch per 32, bitwise."""
    rs = np.random.default_rng(leaves)
    params = {f"p{i:03d}": torch.tensor(
        rs.standard_normal(1 + (i * 389) % 2000), dtype=torch.float32,
        device=card) for i in range(leaves)}
    _check_fused(_trees_like(params, leaves), -(-leaves // ops.MAX_LEAVES))


# ------------------------------------------- the quant round-trip's forms
QUANT_FORM_CASES = {  # name: (shape, x offset, noise offset, qmax, special,
    #                          fp32 form); a 3D shape takes the batched entry
    "MLP-128 int8": ((116, 1024), 0, 0, 127, False, True),
    "MLP-128 int4": ((116, 1024), 0, 0, 7, False, True),
    "NaN/inf int8": ((116, 1024), 0, 0, 127, True, True),
    "ragged int4": ((7, 1000), 0, 0, 7, True, True),
    "x offset 1": ((116, 1024), 1, 0, 127, False, False),
    "noise offset 1": ((7, 1000), 0, 1, 7, True, False),
    "cols % 4 = 2": ((7, 1002), 0, 0, 127, True, False),
    "cols % 4 = 3": ((5, 3), 0, 0, 7, False, False),
    "batched x16 NaN/inf int4": ((16, 116, 1024), 0, 0, 7, True, True),
    "batched noise offset 1": ((3, 7, 1000), 0, 1, 127, True, False),
    "batched cols % 4 = 2": ((3, 7, 1002), 0, 0, 7, True, False),
}


def _quant_form_inputs(card, shape, qmax, special, seed):
    """x, U[0,1) noise and row scales of x: every 7th row zero (scale
    0), rows 1 mod 5 with quartered scales (codes clip at +-qmax);
    ``special`` puts NaN and +-inf into x and a NaN and an inf scale."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal(shape).astype(np.float32)
    x[..., ::7, :] = 0.0
    s = (np.abs(x).max(-1, keepdims=True) / qmax).astype(np.float32)
    s[..., 1::5, :] /= 4
    if special:
        flat = x.reshape(-1)
        flat[rs.integers(0, flat.size, 16)] = np.nan
        flat[rs.integers(0, flat.size, 8)] = np.inf
        flat[rs.integers(0, flat.size, 8)] = -np.inf
        s.reshape(-1)[2:4] = np.nan, np.inf
    u = rs.uniform(size=shape).astype(np.float32)
    return [torch.tensor(a, device=card) for a in (x, u, s)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(QUANT_FORM_CASES))
def test_quant_forms_bitwise_vs_plain(card, name):
    """The quant entries on fp32: the fp32 form where x, noise and out
    are 16-byte aligned and C % 4 == 0, else the runtime-dtype form; one
    launch per call, bitwise the plain version (zero-scale rows, clipped
    codes, NaN and +-inf inputs and scales included)."""
    shape, xo, uo, qmax, special, f32x4 = QUANT_FORM_CASES[name]
    x, u, s = _quant_form_inputs(card, shape, qmax, special, 17)
    x, u = _at_offset(x, xo), _at_offset(u, uo)
    assert tq.quant_takes_f32x4(torch.empty_like(x), x, u) == f32x4
    entry = ("quant_roundtrip_batched" if len(shape) == 3
             else "quant_roundtrip_flat")
    tq.reset_launches()
    got = getattr(tq, entry)(x, u, s, qmax=qmax)
    torch.cuda.synchronize()
    assert tq.LAUNCHES == dict.fromkeys(tq.LAUNCHES, 0) | {entry: 1}
    _bitwise((got,), (ref.quant_roundtrip_ref(x, u, s, qmax=qmax),))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 128, 256, 512])
def test_quant_fp32_form_every_swept_block_size(card, threads, monkeypatch):
    """Each block size `chip_smoke.py: sweep_quant_grid` tries gives the
    same bits, flat and batched."""
    monkeypatch.setattr(tq, "F32X4_THREADS", threads)
    for shape, qmax in (((116, 1024), 127), ((3, 7, 1000), 7)):
        x, u, s = _quant_form_inputs(card, shape, qmax, True, 19)
        entry = (tq.quant_roundtrip_batched if len(shape) == 3
                 else tq.quant_roundtrip_flat)
        got = entry(x, u, s, qmax=qmax)
        _bitwise((got,), (ref.quant_roundtrip_ref(x, u, s, qmax=qmax),))


# -------------------------------------------- the uplink round-trip's forms
F32, BF16, E4M3 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
#: name: (shape, shared start, theta dtype, ef dtype, theta offset, noise
#: offset, fp32 form); a 3D shape takes the batched entry.  Also drives
#: tests/test_torch_quantize.py's CPU test of `uplink_takes_f32x4`.
UPLINK_FORM_CASES = {
    "fp32 aligned flat": ((116, 1024), False, F32, F32, 0, 0, True),
    "batched shared start": ((3, 7, 1000), True, F32, F32, 0, 0, True),
    "batched stacked start": ((3, 7, 1000), False, F32, F32, 0, 0, True),
    "bf16 theta": ((7, 1000), False, BF16, F32, 0, 0, False),
    "e4m3 ef": ((7, 1000), False, F32, E4M3, 0, 0, False),
    "theta offset 1": ((7, 1000), False, F32, F32, 1, 0, False),
    "noise offset 1": ((7, 1000), False, F32, F32, 0, 1, False),
    "cols % 4 = 2": ((7, 1002), False, F32, F32, 0, 0, False),
}


def uplink_form_inputs(device, name, seed, special=False):
    """theta, start, ef, U[0,1) noise and the row scales of the corrected
    delta for `UPLINK_FORM_CASES` entry ``name``: every 7th row zero
    (scale 0), rows 1 mod 5 with quartered scales (codes clip at
    +-qmax); ``special`` puts NaN and +-inf into theta and a NaN and an
    inf scale.  theta and noise at their entry's element offsets."""
    shape, shared, tdt, edt, to, uo, _ = UPLINK_FORM_CASES[name]
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal(shape).astype(np.float32)
    start = rs.standard_normal(shape[-2:] if shared else shape).astype(
        np.float32)
    ef = (0.01 * rs.standard_normal(shape)).astype(np.float32)
    for a in (theta, start, ef):
        a[..., ::7, :] = 0.0
    d = (theta - start) + ef
    s = (np.abs(d).max(-1, keepdims=True) / 127).astype(np.float32)
    s[..., 1::5, :] /= 4
    if special:
        flat = theta.reshape(-1)
        flat[rs.integers(0, flat.size, 16)] = np.nan
        flat[rs.integers(0, flat.size, 8)] = np.inf
        flat[rs.integers(0, flat.size, 8)] = -np.inf
        s.reshape(-1)[2:4] = np.nan, np.inf
    u = rs.uniform(size=shape).astype(np.float32)
    theta, start, ef, u, s = (torch.tensor(a, device=device)
                              for a in (theta, start, ef, u, s))
    return (_at_offset(theta.to(tdt), to), start, ef.to(edt),
            _at_offset(u, uo), s)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(UPLINK_FORM_CASES))
def test_uplink_forms_bitwise_vs_plain(card, name):
    """The uplink entries: the fp32 form where theta, start, ef and both
    outputs are fp32, those and the noise 16-byte aligned and C % 4 ==
    0, else the runtime-dtype form; one launch per call, counted as its
    form; bitwise the plain version (zero-scale rows, clipped codes, NaN
    and +-inf inputs, NaN and inf scales included)."""
    shape, *_, f32x4 = UPLINK_FORM_CASES[name]
    theta, start, ef, u, s = uplink_form_inputs(card, name, 23, special=True)
    outs = [torch.empty(theta.shape, dtype=theta.dtype, device=card)] * 2
    assert tq.uplink_takes_f32x4(outs, theta, start, ef, u) == f32x4
    entry = ("uplink_roundtrip_batched" if len(shape) == 3
             else "uplink_roundtrip_flat")
    tq.reset_launches()
    got = getattr(tq, entry)(theta, start, ef, u, s, qmax=127)
    torch.cuda.synchronize()
    assert tq.LAUNCHES == dict.fromkeys(tq.LAUNCHES, 0) | {entry: 1}
    assert tq.F32X4_LAUNCHES == (dict.fromkeys(tq.F32X4_LAUNCHES, 0)
                                 | {entry: int(f32x4)})
    _bitwise(got, ref.uplink_roundtrip_ref(theta, start, ef, u, s,
                                           qmax=127))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 128, 256, 512])
def test_uplink_fp32_form_every_swept_block_size(card, threads, monkeypatch):
    """Each block size `chip_smoke.py: sweep_uplink_grid` tries gives the
    same bits, flat and batched, shared and stacked start."""
    monkeypatch.setattr(tq, "UPLINK_F32X4_THREADS", threads)
    for name in ("fp32 aligned flat", "batched shared start",
                 "batched stacked start"):
        theta, start, ef, u, s = uplink_form_inputs(card, name, 29,
                                                    special=True)
        entry = (tq.uplink_roundtrip_batched if theta.ndim == 3
                 else tq.uplink_roundtrip_flat)
        tq.reset_launches()
        got = entry(theta, start, ef, u, s, qmax=7)
        assert sum(tq.F32X4_LAUNCHES.values()) == 1
        _bitwise(got, ref.uplink_roundtrip_ref(theta, start, ef, u, s,
                                               qmax=7))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_stale_accum_every_swept_block_size(card, threads, monkeypatch):
    """Each block size `chip_smoke.py: sweep_stale_grid` tries gives the
    same bits, in both forms, in one, two and three batches."""
    monkeypatch.setattr(tstale, "THREADS", threads)
    for K, store in ((1, "fp32"), (16, "fp32"), (33, "fp32"), (16, "bf16"),
                     (33, "e4m3")):
        x, w, _ = _stack(card, K, (116, 1024), store, seed=K)
        inv = float(np.float32(1.0) / np.float32(w.sum().item()))
        got = tstale.stale_accum_flat(x, w, inv)
        _same_fp32(got, ref.stale_accum_ref(x, w, inv))


# ----------------------------------------- the broadcast round-trip's forms
#: name: (shape, shared theta, theta dtype, ref dtype, ef dtype, operand
#: at storage offset 1 or None, fp32 form); a 3D shape takes the batched
#: entry (the flat entry's theta is always the one (R, C) model).  Also
#: drives tests/test_torch_quantize.py's CPU test of
#: `broadcast_takes_f32x4`.
BROADCAST_FORM_CASES = {
    "fp32 aligned flat": ((116, 1024), True, F32, F32, F32, None, True),
    "ragged flat": ((7, 1000), True, F32, F32, F32, None, True),
    "batched shared theta": ((3, 7, 1000), True, F32, F32, F32, None, True),
    "batched stacked theta": ((3, 7, 1000), False, F32, F32, F32, None,
                              True),
    "bf16 theta": ((7, 1000), True, BF16, F32, F32, None, False),
    "bf16 ref": ((7, 1000), True, F32, BF16, F32, None, False),
    "e4m3 ef": ((7, 1000), True, F32, F32, E4M3, None, False),
    "theta offset 1": ((7, 1000), True, F32, F32, F32, "theta", False),
    "ref offset 1": ((116, 1024), True, F32, F32, F32, "ref", False),
    "noise offset 1": ((7, 1000), True, F32, F32, F32, "noise", False),
    "cols % 4 = 2": ((7, 1002), True, F32, F32, F32, None, False),
    "batched ef offset 1": ((3, 7, 1000), True, F32, F32, F32, "ef",
                            False),
    "batched cols % 4 = 3": ((3, 7, 999), False, F32, F32, F32, None,
                             False),
}


def broadcast_form_inputs(device, name, seed, special=False):
    """theta (the server model: ``(R, C)`` when shared), ref (the
    replicas), ef, U[0,1) noise and the row scales of the corrected delta
    for `BROADCAST_FORM_CASES` entry ``name``: every 7th row zero (scale
    0), rows 1 mod 5 with quartered scales (codes clip at +-qmax), -0 in
    theta and ref; ``special`` puts NaN and +-inf into theta and ref and
    a NaN and an inf scale.  The entry's operand at storage offset 1."""
    shape, shared, tdt, rdt, edt, off, _ = BROADCAST_FORM_CASES[name]
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal(shape[-2:] if shared else shape).astype(
        np.float32)
    ref_ = rs.standard_normal(shape).astype(np.float32)
    ef = (0.01 * rs.standard_normal(shape)).astype(np.float32)
    for a in (theta, ref_, ef):
        a[..., ::7, :] = 0.0
    theta.reshape(-1)[rs.integers(0, theta.size, 8)] = -0.0
    ref_.reshape(-1)[rs.integers(0, ref_.size, 8)] = -0.0
    d = (theta - ref_) + ef
    s = (np.abs(d).max(-1, keepdims=True) / 127).astype(np.float32)
    s[..., 1::5, :] /= 4
    if special:
        for a in (theta, ref_):
            flat = a.reshape(-1)
            flat[rs.integers(0, flat.size, 8)] = np.nan
            flat[rs.integers(0, flat.size, 4)] = np.inf
            flat[rs.integers(0, flat.size, 4)] = -np.inf
        s.reshape(-1)[2:4] = np.nan, np.inf
    u = rs.uniform(size=shape).astype(np.float32)
    ops_ = dict(zip(("theta", "ref", "ef", "noise"),
                    (ref.store_as(torch.tensor(a, device=device), dt)
                     for a, dt in ((theta, tdt), (ref_, rdt), (ef, edt),
                                   (u, F32)))))
    ops_ = {k: _at_offset(t, int(k == off)) for k, t in ops_.items()}
    return (ops_["theta"], ops_["ref"], ops_["ef"], ops_["noise"],
            torch.tensor(s, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BROADCAST_FORM_CASES))
def test_broadcast_forms_bitwise_vs_plain(card, name):
    """The broadcast entries: the fp32 form where theta, ref, ef and both
    outputs are fp32, those and the noise 16-byte aligned and C % 4 ==
    0, else the runtime-dtype form; one launch per call, counted as its
    form; bitwise the plain version (zero-scale rows, clipped codes, -0,
    NaN and +-inf inputs, NaN and inf scales included)."""
    shape, *_, f32x4 = BROADCAST_FORM_CASES[name]
    theta, ref_, ef, u, s = broadcast_form_inputs(card, name, 37,
                                                  special=True)
    outs = [torch.empty(shape, dtype=theta.dtype, device=card)] * 2
    assert tq.broadcast_takes_f32x4(outs, theta, ref_, ef, u) == f32x4
    entry = ("broadcast_roundtrip_batched" if len(shape) == 3
             else "broadcast_roundtrip_flat")
    tq.reset_launches()
    got = getattr(tq, entry)(theta, ref_, ef, u, s, qmax=127)
    torch.cuda.synchronize()
    assert tq.LAUNCHES == dict.fromkeys(tq.LAUNCHES, 0) | {entry: 1}
    assert tq.F32X4_LAUNCHES == (dict.fromkeys(tq.F32X4_LAUNCHES, 0)
                                 | {entry: int(f32x4)})
    _bitwise(got, ref.broadcast_roundtrip_ref(theta, ref_, ef, u, s,
                                              qmax=127))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 128, 256, 512])
def test_broadcast_fp32_form_every_swept_block_size(card, threads,
                                                    monkeypatch):
    """Each block size `chip_smoke.py: sweep_broadcast_grid` tries gives
    the same bits, flat and batched, shared and stacked theta."""
    monkeypatch.setattr(tq, "BROADCAST_F32X4_THREADS", threads)
    for name in ("fp32 aligned flat", "batched shared theta",
                 "batched stacked theta"):
        theta, ref_, ef, u, s = broadcast_form_inputs(card, name, 41,
                                                      special=True)
        entry = (tq.broadcast_roundtrip_batched if ref_.ndim == 3
                 else tq.broadcast_roundtrip_flat)
        tq.reset_launches()
        got = entry(theta, ref_, ef, u, s, qmax=7)
        assert sum(tq.F32X4_LAUNCHES.values()) == 1
        _bitwise(got, ref.broadcast_roundtrip_ref(theta, ref_, ef, u, s,
                                                  qmax=7))


# ------------------------------------ the sign / threshold kernel's forms
E5M2 = torch.float8_e5m2
#: name: (shape, x dtype, x storage offset, fp32 form); a 3D shape takes
#: the batched entries.  Also drives tests/test_torch_quantize.py's CPU
#: test of `biased_takes_f32x4`.
BIASED_FORM_CASES = {
    "fp32 aligned flat": ((116, 1024), F32, 0, True),
    "flat C % 4 = 3, per client % 4 = 0": ((4, 999), F32, 0, True),
    "flat offset 4": ((7, 1000), F32, 4, True),
    "flat offset 1": ((7, 1000), F32, 1, False),
    "flat per client % 4 = 1": ((7, 999), F32, 0, False),
    "flat bf16": ((7, 1000), BF16, 0, False),
    "batched": ((3, 7, 1000), F32, 0, True),
    "batched C % 4 = 3, per client % 4 = 0": ((3, 4, 999), F32, 0, True),
    "batched offset 1": ((3, 7, 1000), F32, 1, False),
    "batched ragged": ((3, 7, 999), F32, 0, False),
    "batched e4m3": ((3, 7, 1000), E4M3, 0, False),
    "batched e5m2": ((3, 7, 1000), E5M2, 0, False),
}


def biased_form_inputs(device, name, seed, special=False):
    """x for `BIASED_FORM_CASES` entry ``name`` (at its storage offset)
    and its fp32 per-client scalars (0-dim for a flat x): each client's
    mean |x| rounded to x's dtype, 0 for the last client of a stack, with
    8 ties at +-scalar per client; ``special`` puts NaN, +-0 and +-inf
    into every client (stored by `ref.store_as`: e4m3 has no inf, so
    +-inf becomes NaN on either device)."""
    shape, dt, off, _ = BIASED_FORM_CASES[name]
    rs = np.random.default_rng(seed)
    x = rs.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, shape[-2] * shape[-1])     # a row per client
    v = torch.tensor(np.abs(flat).mean(-1)).to(dt).float()
    if len(shape) == 3:
        v[-1] = 0.0
    for n in range(flat.shape[0]):
        pos = rs.choice(flat.shape[1], 14, replace=False)
        flat[n, pos[:8]] = float(v[n]) * np.array([1, -1] * 4, np.float32)
        if special:
            flat[n, pos[8:]] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
    xt = _at_offset(ref.store_as(torch.tensor(x, device=device), dt), off)
    v = v.to(device)
    return xt, (v if len(shape) == 3 else v[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BIASED_FORM_CASES))
def test_biased_forms_bitwise_vs_plain(card, name):
    """The sign and threshold entries: the fp32 form where x and out are
    fp32 and 16-byte aligned and each client holds a multiple of 4
    elements, else the runtime-dtype form; one launch per call, counted
    as its form; bitwise the plain version (NaN, +-0, +-inf and ties at
    the threshold included)."""
    shape, _, _, f32x4 = BIASED_FORM_CASES[name]
    x, v = biased_form_inputs(card, name, 43, special=True)
    assert tq.biased_takes_f32x4(torch.empty_like(x), x) == f32x4
    kind = "batched" if len(shape) == 3 else "flat"
    for entry, plain in ((f"sign_roundtrip_{kind}", ref.sign_roundtrip_ref),
                         (f"topk_threshold_{kind}",
                          ref.topk_threshold_ref)):
        tq.reset_launches()
        got = getattr(tq, entry)(x, v)
        torch.cuda.synchronize()
        assert tq.LAUNCHES == dict.fromkeys(tq.LAUNCHES, 0) | {entry: 1}
        assert tq.F32X4_LAUNCHES == (dict.fromkeys(tq.F32X4_LAUNCHES, 0)
                                     | {entry: int(f32x4)})
        _bitwise((got,), (plain(x, v),))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [64, 128, 256, 512])
def test_biased_fp32_form_every_swept_block_size(card, threads,
                                                 monkeypatch):
    """Each block size `chip_smoke.py: sweep_biased_grid` tries gives the
    same bits, flat and batched, sign and threshold."""
    monkeypatch.setattr(tq, "BIASED_F32X4_THREADS", threads)
    for name in ("fp32 aligned flat", "batched",
                 "batched C % 4 = 3, per client % 4 = 0"):
        x, v = biased_form_inputs(card, name, 47, special=True)
        kind = "batched" if x.ndim == 3 else "flat"
        tq.reset_launches()
        for fn, plain in (("sign_roundtrip", ref.sign_roundtrip_ref),
                          ("topk_threshold", ref.topk_threshold_ref)):
            got = getattr(tq, f"{fn}_{kind}")(x, v)
            _bitwise((got,), (plain(x, v),))
        assert sum(tq.F32X4_LAUNCHES.values()) == 2


# ------------------------------------- the resident dtype policy's forms
#: the main path's packed MLP-128 stack: 32 clients of (116, 1024)
MAIN_STACK = (32, 116, 1024)
NARROW_MAIN = {  # m, h storage of the narrow phases (theta, g, h_hat fp32)
    "bf16": (torch.bfloat16, torch.bfloat16),
    "fp8": (torch.float8_e4m3fn, torch.float8_e5m2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("store", list(NARROW_MAIN))
@pytest.mark.parametrize("do_h", [0, 1])
def test_narrow_sophia_at_the_main_shape_bitwise(card, store, do_h):
    """The batched Sophia launch of the bf16 and fp8 resident phases, at
    the main path's shape, in place as the engine runs it: the
    runtime-dtype form, bitwise its plain version."""
    xs = _inputs(MAIN_STACK, card, seed=11, overflow=store == "fp8")
    m_dt, h_dt = NARROW_MAIN[store]
    ins = [xs[0], xs[1].to(m_dt), xs[2].to(h_dt), xs[3], xs[4]]
    want = sophia_update_ref(*ins, do_h, lr=LR, **HP)
    tk.reset_launches()
    got = tk.sophia_update_batched(*(x.clone() for x in ins[:3]), *ins[3:],
                                   do_h, LR, inplace=True, **HP)
    assert tk.LAUNCHES["sophia_update_batched"] == 1
    assert tk.F32X4_LAUNCHES["sophia_update_batched"] == 0
    _bitwise(got, want)


def _small_fed(**kw):
    from repro_torch.configs.base import FedConfig
    return FedConfig(**{**dict(num_clients=4, local_iters=2, tau=2), **kw})


def _card_vs_cpu(card, fed, rounds=2):
    """``rounds`` small rounds of ``fed`` on the card and on the CPU
    from the same weights, data and GNB noise; returns both states and
    the losses."""
    from repro_torch.core.fed import FedEngine
    from repro_torch.models.small import MLPTask
    task = MLPTask(hidden=16)
    init = task.init(torch.Generator().manual_seed(0))
    rs = np.random.default_rng(1)
    out = {}
    for dev in ("cpu", card):
        eng = FedEngine(task, fed, device=dev)
        state = eng.pack_state(eng.init_from_params(
            {k: v.to(dev) for k, v in init.items()}))
        losses = []
        for r in range(rounds):
            rs = np.random.default_rng(10 + r)
            b = {"x": torch.tensor(rs.standard_normal((4, 8, 28, 28, 1)),
                                   dtype=torch.float32, device=dev),
                 "y": torch.tensor(rs.integers(0, 10, (4, 8)), device=dev)}
            u = rs.uniform(size=(4, fed.local_iters, 8, 10))
            gum = torch.tensor(-np.log(-np.log(np.maximum(u, 1e-30))),
                               dtype=torch.float32, device=dev)
            state, m = eng.round(state, b, gumbel=gum)
            losses.append(float(m["loss"]))
        out[str(dev)] = (state, losses)
    return out["cpu"], out[str(card)]


def _close_in_dtype(a, b, rtol=1e-4, atol=1e-5):
    """fp32 within rtol/atol; a narrow buffer within that or its steps
    of its dtype (`kernels.ref.band_breach`)."""
    breach = ref.band_breach(a.cpu(), b.cpu(), rtol=rtol, atol=atol)
    assert breach is None, breach


@pytest.mark.cuda
def test_bf16_fedadam_round_on_the_card_matches_the_cpu(card):
    from repro_torch.configs.base import CommConfig
    (cs, cl), (gs, gl) = _card_vs_cpu(card, _small_fed(
        optimizer="fedadam", lr=0.02,
        comm=CommConfig(state_dtype="bfloat16")))
    np.testing.assert_allclose(gl, cl, rtol=1e-4, atol=1e-5)
    assert gs["params"].dtype == torch.bfloat16
    _close_in_dtype(gs["params"], cs["params"])
    for k in ("m", "v"):
        assert gs["server_opt"][k].dtype == torch.bfloat16
        _close_in_dtype(gs["server_opt"][k], cs["server_opt"][k])


@pytest.mark.cuda
def test_done_round_on_the_card_matches_the_cpu(card):
    (cs, cl), (gs, gl) = _card_vs_cpu(card, _small_fed(
        optimizer="done", lr=1.0, local_iters=1))
    np.testing.assert_allclose(gl, cl, rtol=1e-4, atol=1e-5)
    _close_in_dtype(gs["params"], cs["params"])


# ------------------------------------------- slice 10: the LM, checkpoints
def _lm_cfg(dtype):
    import dataclasses
    from repro_torch.configs import get_model_config
    return dataclasses.replace(
        get_model_config("minicpm-2b").reduced(d_model=128), dtype=dtype)


def _lm_batch(cfg, device, lead=()):
    rs = np.random.default_rng(3)
    tok = torch.tensor(rs.integers(0, cfg.vocab_size, lead + (2, 32)))
    return {"tokens": tok.to(device),
            "labels": torch.roll(tok, -1, dims=-1).to(device)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_grads_on_the_card_match_the_cpu(card, dtype):
    """minicpm-2b reduced(d_model=128): loss and grads on the card against
    the CPU, from the same weights and batch, with a leading client
    axis.  fp32 (TF32 off): rtol 1e-4 / atol 1e-5; bf16: the loss rtol
    1e-3, each grad leaf within 2^-5 of its largest magnitude (the bf16
    bands of tests/test_torch_lm.py)."""
    from repro_torch.models.transformer import LMTask
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg(dtype)
    task = LMTask(cfg)
    ps = [task.init(torch.Generator().manual_seed(s), "cpu") for s in (0, 1)]
    params = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    out = {}
    for dev in ("cpu", card):
        pg = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        loss = task.loss(pg, _lm_batch(cfg, dev, lead=(2,)))
        grads = torch.autograd.grad(loss.sum(), list(pg.values()))
        out[str(dev)] = (loss.detach().cpu(),
                         [g.float().cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out[str(card)]
    fp32 = dtype == "float32"
    np.testing.assert_allclose(lg.numpy(), lc.numpy(),
                               rtol=1e-4 if fp32 else 1e-3,
                               atol=1e-5 if fp32 else 0)
    for k, a, b in zip(params, gc, gg):
        if fp32:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(
                b.numpy(), a.numpy(), rtol=0,
                atol=2 ** -5 * float(a.abs().max()), err_msg=k)


@pytest.mark.cuda
def test_lm_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A packed LM state on the card saved and restored through the
    checkpoint shims: the leaves bitwise the saved ones, the packed
    buffer bitwise its bf16-rounded self, on the card."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.models.transformer import LMTask
    task = LMTask(_lm_cfg("bfloat16"))
    params = task.init(torch.Generator(device=card).manual_seed(0), card)
    spec = tflat.flat_spec(params)
    packed = tflat.pack(params, spec) + 1e-4 * torch.randn(
        spec.rows, spec.cols, device=card)
    ckpt.save_packed(str(tmp_path), packed, spec, step=2, extra={"k": 1})
    leaves = tflat.unpack(packed, spec)
    back = ckpt.restore(str(tmp_path), leaves)
    for k, v in leaves.items():
        assert back[k].device == v.device and back[k].dtype == v.dtype
        assert torch.equal(back[k].view(torch.int16), v.view(torch.int16))
    again = ckpt.restore_packed(str(tmp_path), spec, device=card)
    assert again.device.type == "cuda"
    assert torch.equal(again, tflat.pack(leaves, spec))
    assert ckpt.load_manifest(str(tmp_path))["extra"] == {"k": 1}


# ------------------------------------------- the leaf-boundary form
#: name: (leaf shapes, the keys whose grads come back swapped, cols)
BOUNDARY_CASES = {
    # a tied embedding's swapped grad, a norm, a stacked layer leaf
    "aligned": ({"emb": (480, 256), "norm": (256,), "w": (2, 96, 128)},
                ("emb", "w"), 1024),
    # odd sizes: ragged tiles and runs, an unaligned offset (c), a
    # vector leaf after it (d)
    "odd": ({"a": (36, 72), "b": (5,), "c": (3, 33, 65), "d": (4100,)},
            ("a", "c"), 1000),
    # more leaves than one launch's table holds
    "past-the-cap": ({f"l{i:02d}": ((i % 5) + 1, 3 + (i % 4) * 29)
                      for i in range(tk.BOUNDARY_MAX_LEAVES + 7)},
                     ("l03", "l34"), 64),
}


def _boundary_operands(card, shapes, swap, cols, lead, refresh, seed):
    """fp32 theta, m, h (zero past the leaves, some h 0), grads and h_hat
    leaves (bf16 and fp32 by turns, ``swap``'s keys swapped; h_hat the
    zero buffer without a refresh) and the spec."""
    rs = np.random.default_rng(seed)
    dtypes = {k: torch.float32 if i % 3 == 1 else torch.bfloat16
              for i, k in enumerate(shapes)}
    spec = tflat.flat_spec({k: torch.empty(s, dtype=dtypes[k])
                            for k, s in shapes.items()}, cols=cols)

    def leaves(scale, positive, swapped):
        out = {}
        for k, s in shapes.items():
            x = scale * rs.standard_normal(lead + s)
            x = torch.tensor(np.abs(x) if positive else x,
                             dtype=torch.float32, device=card)
            x = x.to(dtypes[k])
            if k in swapped:
                x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
            out[k] = x
        return out

    state = []
    for scale in (1.0, 0.1, 0.01):
        x = scale * rs.standard_normal(lead + (spec.padded,))
        x[..., spec.total:] = 0.0
        state.append(torch.tensor(x.reshape(lead + (spec.rows, spec.cols)),
                                  dtype=torch.float32, device=card))
    state[2] = state[2].abs()
    state[2].reshape(-1)[::17] = 0.0
    grads = leaves(0.5, False, swap)
    h_hat = (leaves(0.02, True, swap[:1]) if refresh
             else torch.zeros_like(state[0]))
    return state, grads, h_hat, spec, dtypes


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BOUNDARY_CASES))
@pytest.mark.parametrize("lead", [(), (3,)], ids=["flat", "cohort"])
@pytest.mark.parametrize("refresh", [1, 0])
@pytest.mark.parametrize("store", ["store", "last-step"])
def test_leaf_boundary_kernel_bitwise_vs_plain(card, case, lead, refresh,
                                               store):
    """The leaf-boundary form against its plain version: theta, m, h and
    the stored params leaves bitwise; without a store (a round's last
    step) the leaf buffers are not touched; one launch a
    `tk.BOUNDARY_MAX_LEAVES` leaves, all of them vector-aligned in the
    aligned case."""
    shapes, swap, cols = BOUNDARY_CASES[case]
    state, grads, h_hat, spec, dtypes = _boundary_operands(
        card, shapes, swap, cols, lead, refresh, len(shapes))
    sentinel = float("nan")
    out = {k: torch.full(lead + shapes[k], sentinel, dtype=dt, device=card)
           for k, dt in dtypes.items() if dt != torch.float32}
    want = ref.sophia_update_leaves_ref(
        *state, grads, h_hat, float(refresh), spec=spec,
        out_dtypes={k: v.dtype for k, v in out.items()}, lr=LR, **HP)
    tk.reset_launches()
    got = [x.clone() for x in state]
    tk.sophia_update_leaves(*got, grads, h_hat, refresh, LR, spec=spec,
                            out=out if store == "store" else None, **HP)
    torch.cuda.synchronize()
    _bitwise(got, want[:3])
    for k, v in out.items():
        if store == "store":
            _bitwise([v], [want[3][k]])
        else:
            assert bool(torch.isnan(v.float()).all()), k
    parts = -(-len(shapes) // tk.BOUNDARY_MAX_LEAVES)
    assert tk.LAUNCHES["sophia_update_leaves"] == parts
    assert tk.STEPS["sophia_update_leaves"] == 1
    if case == "aligned":
        assert tk.F32X4_LAUNCHES["sophia_update_leaves"] == parts
    assert counters.sophia_leaf_route_share() == 1.0


@pytest.mark.cuda
def test_leaf_boundary_reads_a_buffer_h_hat_at_offsets(card):
    """h_hat given as one resident-shaped buffer (the zero h_hat of a
    plain step; here random, zero past the leaves as every buffer of
    the layout is) is read at each leaf's offset, as the grads of an fp8
    leaf are read elementwise: bitwise the plain version."""
    shapes = {"a": (33, 40), "b": (71,), "c": (8, 64)}
    state, grads, _, spec, dtypes = _boundary_operands(
        card, shapes, ("a",), 256, (2,), 1, 11)
    grads["b"] = grads["b"].float().to(torch.float8_e4m3fn)
    hh = torch.rand_like(state[0]) * 0.02
    hh.reshape(2, -1)[:, spec.total:] = 0.0
    want = ref.sophia_update_leaves_ref(*state, grads, hh, 1.0, spec=spec,
                                        out_dtypes={}, lr=LR, **HP)
    got = [x.clone() for x in state]
    tk.sophia_update_leaves(*got, grads, hh, 1, LR, spec=spec, **HP)
    torch.cuda.synchronize()
    _bitwise(got, want[:3])


def _lm_round_engine(card, J=2):
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.fed import FedEngine
    from repro_torch.models.transformer import LMTask
    cfg = _lm_cfg("bfloat16")
    fed = FedConfig(num_clients=2, local_iters=J, tau=J, lr=1e-3)
    eng = FedEngine(LMTask(cfg), fed, device=card)
    params = eng.task.init(torch.Generator(device=card).manual_seed(0),
                           card)
    return eng, params, _lm_batch(cfg, card, (2,))


def _lm_rounds(eng, params, batches, rounds=2):
    state = eng.pack_state(eng.init_from_params(
        {k: v.clone() for k, v in params.items()}))
    gen = torch.Generator(device=eng.device).manual_seed(3)
    losses = []
    for _ in range(rounds):
        state, met = eng.round(state, batches, generator=gen)
        losses.append(met["loss"])
    torch.cuda.synchronize()
    return state, losses


@pytest.mark.cuda
def test_lm_round_takes_the_leaf_route(card, monkeypatch):
    """An LM round on the card: every Sophia step on the leaf route (the
    counter reads 1.0), the state and losses bitwise the packed route's,
    and fewer device activities a round by the pack's removed copies."""
    from repro_torch.core import fed as tfed
    eng, params, batches = _lm_round_engine(card)

    def profiled(leafy):
        if not leafy:
            monkeypatch.setattr(tfed, "takes_leaves", lambda *a: False)
        _lm_rounds(eng, params, batches, 1)          # warm
        tk.reset_launches()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            state, losses = _lm_rounds(eng, params, batches)
        monkeypatch.undo()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return state, losses, len(device), counters.sophia_leaf_route_share()

    a, la, na, share_a = profiled(True)
    b, lb, nb, share_b = profiled(False)
    assert (share_a, share_b) == (1.0, 0.0)
    assert tk.LAUNCHES["sophia_update_leaves"] == 0
    _bitwise([a["params"], a["client_opt"].m, a["client_opt"].h],
             [b["params"], b["client_opt"].m, b["client_opt"].h])
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert na < nb, (na, nb)
