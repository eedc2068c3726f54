"""The port's CUDA kernels against their plain PyTorch versions, on the
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
