"""The port's CUDA kernels (the Sophia update and the six quantize
round-trip entry points) against their plain PyTorch versions, on the
card.

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

from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref
from repro_torch.kernels import sophia_update as tk
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
