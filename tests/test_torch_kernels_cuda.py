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
@pytest.mark.parametrize("K", [1, 16, 33])
@pytest.mark.parametrize("shape", [(7, 1000), (7, 999)],
                         ids=["vec4", "scalar"])
def test_stale_accum_kernel_bitwise_vs_plain(card, store, K, shape):
    """Bitwise, with inv_norm 1, 1/sum(w) by value and as a device
    tensor; fp32 stacks of a multiple of 4 coordinates take the 16-byte
    path."""
    x, w, _ = _stack(card, K, shape, store, seed=K)
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
    """The pytree route: pack, the Sophia kernel, unpack, against the
    plain update of the same packed buffers."""
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
