"""The port's quantize round-trips (plain versions, the CPU path of
`repro_torch.kernels.quantize`) against the JAX package's.

* Against ``repro.kernels.ref``'s eager functions: bitwise, at fp32,
  bf16, e4m3 and e5m2 storage, with the shared ``(R, C)`` operand both
  shared and stacked.  Inputs are fp32 numpy, cast to the storage dtype
  in each framework (both round to nearest even), and stay inside the
  fp8 ranges.
* Against the Pallas kernels in interpret mode: inside the band of
  tests/test_kernel_conformance.py — fp32 ``rtol=atol=1e-6`` (XLA may
  contract ``r + q*s`` and ``d - q*s`` into FMAs inside the jitted
  body), one ulp of the storage format otherwise.
* Batched equals looped flat, bitwise; all-zero rows give +0 and a zero
  residual; the clip at +-qmax; CPU calls launch nothing; bad inputs
  raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as jq
from repro.kernels import ref as jref
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref

N, R, C = 3, 20, 100
QMAX = 7
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}
#: one-ulp band of each narrow storage format (test_kernel_conformance)
ULP = {"bf16": 2 ** -8, "e4m3": 2 ** -3, "e5m2": 2 ** -2}


def _inputs(seed=0, shared=True):
    """theta, other (start / ref), ef, noise, scale as fp32 numpy.
    ``other`` is ``(R, C)`` when shared; the scales are those of the
    corrected delta of the uplink."""
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal((N, R, C)).astype(np.float32)
    other = rs.standard_normal((R, C) if shared else (N, R, C)).astype(
        np.float32)
    ef = (0.01 * rs.standard_normal((N, R, C))).astype(np.float32)
    noise = rs.uniform(size=(N, R, C)).astype(np.float32)
    d = (theta - other) + ef
    scale = (np.abs(d).max(-1, keepdims=True) / QMAX).astype(np.float32)
    return theta, other, ef, noise, scale


def _pair(arrays, store):
    """The same arrays as torch and jnp; the first three (state) stored
    in ``store``, noise and scale fp32."""
    tdt, jdt = DTYPES[store]
    t = [torch.tensor(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    t[:3] = [x.to(tdt) for x in t[:3]]
    j[:3] = [x.astype(jdt) for x in j[:3]]
    return t, j


def _bitwise(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == w.dtype.name
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                      w.view(np.uint8))


def _close(got, want, store):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    band = ULP.get(store, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=band,
                                   atol=band)


@pytest.mark.parametrize("store", list(DTYPES))
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
def test_refs_bitwise_vs_jax_eager_refs(store, shared):
    t, j = _pair(_inputs(1, shared), store)
    _bitwise(tref.quant_roundtrip_ref(t[0], t[3], t[4], qmax=QMAX),
             jref.quant_roundtrip_ref(j[0], j[3], j[4], qmax=QMAX))
    _bitwise(tref.uplink_roundtrip_ref(*t, qmax=QMAX),
             jref.uplink_roundtrip_ref(j[0], j[1][None] if shared else j[1],
                                       *j[2:], qmax=QMAX))
    # broadcast: the shared operand is theta, the stack is the replicas
    bt = [t[1], t[0]] + t[2:]
    bj = [j[1][None] if shared else j[1], j[0]] + j[2:]
    _bitwise(tref.broadcast_roundtrip_ref(*bt, qmax=QMAX),
             jref.broadcast_roundtrip_ref(*bj, qmax=QMAX))


@pytest.mark.parametrize("store", list(DTYPES))
def test_plain_versions_match_pallas_interpret(store):
    t, j = _pair(_inputs(2, shared=True), store)
    _close(tq.quant_roundtrip_batched(t[0], t[3], t[4], qmax=QMAX),
           jq.quant_roundtrip_batched(j[0], j[3], j[4], qmax=QMAX,
                                      interpret=True), store)
    _close(tq.uplink_roundtrip_batched(*t, qmax=QMAX),
           jq.uplink_roundtrip_batched(*j, qmax=QMAX, interpret=True),
           store)
    bt, bj = [t[1], t[0]] + t[2:], [j[1], j[0]] + j[2:]
    _close(tq.broadcast_roundtrip_batched(*bt, qmax=QMAX),
           jq.broadcast_roundtrip_batched(*bj, qmax=QMAX, interpret=True),
           store)
    _close(tq.quant_roundtrip_flat(t[0][1], t[3][1], t[4][1], qmax=QMAX),
           jq.quant_roundtrip_flat(j[0][1], j[3][1], j[4][1], qmax=QMAX,
                                   interpret=True), store)
    _close(tq.uplink_roundtrip_flat(t[0][1], t[1], t[2][1], t[3][1],
                                    t[4][1], qmax=QMAX),
           jq.uplink_roundtrip_flat(j[0][1], j[1], j[2][1], j[3][1],
                                    j[4][1], qmax=QMAX, interpret=True),
           store)
    _close(tq.broadcast_roundtrip_flat(t[1], t[0][1], t[2][1], t[3][1],
                                       t[4][1], qmax=QMAX),
           jq.broadcast_roundtrip_flat(j[1], j[0][1], j[2][1], j[3][1],
                                       j[4][1], qmax=QMAX, interpret=True),
           store)


@pytest.mark.parametrize("store", list(DTYPES))
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
def test_batched_equals_looped_flat(store, shared):
    t, _ = _pair(_inputs(3, shared), store)
    th, other, ef, u, s = t

    def row(x, i):
        return x if x.ndim == 2 else x[i]

    def stack(outs):
        return tuple(torch.stack(o) for o in zip(*outs))
    up = tq.uplink_roundtrip_batched(th, other, ef, u, s, qmax=QMAX)
    loop = stack([tq.uplink_roundtrip_flat(th[i], row(other, i), ef[i],
                                           u[i], s[i], qmax=QMAX)
                  for i in range(N)])
    for a, b in zip(up, loop):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    bc = tq.broadcast_roundtrip_batched(other, th, ef, u, s, qmax=QMAX)
    loop = stack([tq.broadcast_roundtrip_flat(row(other, i), th[i], ef[i],
                                              u[i], s[i], qmax=QMAX)
                  for i in range(N)])
    for a, b in zip(bc, loop):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    qb = tq.quant_roundtrip_batched(th, u, s, qmax=QMAX)
    ql = torch.stack([tq.quant_roundtrip_flat(th[i], u[i], s[i], qmax=QMAX)
                      for i in range(N)])
    assert torch.equal(qb.view(torch.uint8), ql.view(torch.uint8))


def test_zero_rows_and_the_clip():
    """Round 0 of the downlink: replicas equal the server model, so the
    delta and its scale are 0; safe = 1 and u < 1 give q = 0, a +0
    replica update and a +0 residual.  A scale below max|x| / qmax puts
    codes past +-qmax, which clip."""
    g = torch.Generator().manual_seed(0)
    theta = torch.randn(R, C, generator=g)
    ref = theta.expand(N, R, C).contiguous()
    ef = torch.zeros(N, R, C)
    u = torch.rand(N, R, C, generator=g)
    scale = torch.zeros(N, R, 1)
    model, resid = tq.broadcast_roundtrip_batched(theta, ref, ef, u, scale,
                                                  qmax=127)
    assert torch.equal(model, ref)
    assert torch.equal(resid.view(torch.int32), torch.zeros_like(
        resid, dtype=torch.int32))
    u_max = torch.full((N, R, C), float(np.nextafter(np.float32(1),
                                                     np.float32(0))))
    xhat = tq.quant_roundtrip_batched(torch.zeros(N, R, C), u_max, scale,
                                      qmax=127)
    assert torch.equal(xhat.view(torch.int32),
                       torch.zeros(N, R, C, dtype=torch.int32))
    x = torch.randn(N, R, C, generator=g)
    small = x.abs().amax(-1, keepdim=True) / (4 * QMAX)
    out = tq.quant_roundtrip_batched(x, u, small, qmax=QMAX)
    q = torch.floor(x / small + u)
    clipped = q.abs() > QMAX
    assert bool(clipped.any()) and bool((~clipped).any())
    want = torch.where(clipped, torch.sign(q) * QMAX, q) * small
    assert torch.equal(out, want)


def test_cpu_calls_launch_nothing_and_bad_inputs_raise():
    t, _ = _pair(_inputs(4), "fp32")
    th, other, ef, u, s = t
    tq.reset_launches()
    tq.quant_roundtrip_batched(th, u, s, qmax=QMAX)
    tq.uplink_roundtrip_batched(th, other, ef, u, s, qmax=QMAX)
    tq.broadcast_roundtrip_batched(other, th, ef, u, s, qmax=QMAX)
    assert sum(tq.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="3D"):
        tq.quant_roundtrip_batched(th[0], u[0], s[0], qmax=QMAX)
    with pytest.raises(ValueError, match="scale"):
        tq.quant_roundtrip_batched(th, u, s[:, :1], qmax=QMAX)
    with pytest.raises(ValueError, match="start"):
        tq.uplink_roundtrip_batched(th, other[:1], ef, u, s, qmax=QMAX)
    with pytest.raises(TypeError, match="noise"):
        tq.quant_roundtrip_flat(th[0], u[0].double(), s[0], qmax=QMAX)
    with pytest.raises(ValueError, match="contiguous"):
        tq.broadcast_roundtrip_batched(other, th.transpose(1, 2).contiguous()
                                       .transpose(1, 2), ef, u, s,
                                       qmax=QMAX)
