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
  raise; the uplink, broadcast and sign / threshold wrappers' choice of
  their kernels' fp32 forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as jq
from repro.kernels import ref as jref
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref
from test_torch_kernels_cuda import (BIASED_FORM_CASES,
                                     BROADCAST_FORM_CASES,
                                     UPLINK_FORM_CASES,
                                     biased_form_inputs,
                                     broadcast_form_inputs,
                                     uplink_form_inputs)

N, R, C = 3, 20, 100
QMAX = 7
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}
#: one-ulp band of each narrow storage format (test_kernel_conformance)
ULP = {"bf16": 2 ** -8, "e4m3": 2 ** -3, "e5m2": 2 ** -2}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it: the JAX package's
    jitted Pallas kernels traced here would otherwise stay in jax's
    caches for other modules' tests, which trace the same shapes under
    other launch geometries."""
    yield
    jax.clear_caches()


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


# --------------------------------------- the biased compressors' kernels
#: scales and thresholds of the sign / top-k cases: one per client
SCALARS = np.array([0.8125, 0.5, 0.0], np.float32)
_BITS = {1: np.uint8, 2: np.int16, 4: np.int32}


def _biased_inputs(store, seed=5):
    """An ``(N, R, C)`` stack in ``store`` with NaN, +-0 and +-inf planted
    (no inf in e4m3, which has none) and ties at each client's threshold
    (``SCALARS``): exact +-thr, and the neighbours just below and above
    in the storage format.  Cast once by JAX; the torch tensor carries
    the same bytes.  Returns ``(torch x, jnp x)``."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((N, R, C)).astype(np.float32)
    flat = x.reshape(N, -1)
    specials = [np.nan, -np.nan, 0.0, -0.0]
    if store != "e4m3":
        specials += [np.inf, -np.inf]
    for n in range(N):
        pos = rs.choice(R * C, 40, replace=False)
        flat[n, pos[:len(specials)]] = specials
        thr = SCALARS[n]
        flat[n, pos[10:20]] = thr * np.array([1, -1] * 5, np.float32)
        flat[n, pos[20:25]] = thr * (1 - 2 ** -4)
        flat[n, pos[25:30]] = -thr * (1 + 2 ** -4)
    jdt = DTYPES[store][1]
    jx = jnp.asarray(x).astype(jdt)
    raw = np.asarray(jx).view(_BITS[jx.dtype.itemsize])
    return torch.from_numpy(raw.copy()).view(DTYPES[store][0]), jx


def _bitwise_nan(got, want):
    """`_bitwise`, but a NaN output need only be NaN in both: storing a
    NaN in bf16 or e5m2, torch writes its own NaN (bf16 0xFFFF on the
    CPU, e5m2 0x7F with the sign) where JAX keeps the payload."""
    w = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == w.dtype.name
    gf, wf = got.float().numpy(), w.astype(np.float32)
    nan = np.isnan(wf)
    np.testing.assert_array_equal(np.isnan(gf), nan)
    raw_g = got.view(torch.uint8).numpy().reshape(got.numel(), -1)
    raw_w = w.view(np.uint8).reshape(w.size, -1)
    np.testing.assert_array_equal(raw_g[~nan.reshape(-1)],
                                  raw_w[~nan.reshape(-1)])


@pytest.mark.parametrize("store", list(DTYPES))
def test_biased_refs_bitwise_vs_jax(store):
    """The plain sign / threshold versions against the JAX package's
    eager refs and its Pallas kernels in interpret mode, flat and
    batched: bitwise (one compare or one multiply: nothing to
    contract), NaN, +-0, +-inf and ties at the threshold included; NaN
    outputs as `_bitwise_nan` says (fp32 and e4m3 NaNs bitwise too)."""
    tx, jx = _biased_inputs(store)
    check = _bitwise if store in ("fp32", "e4m3") else _bitwise_nan
    ts, js = torch.from_numpy(SCALARS), jnp.asarray(SCALARS)
    for tfn, jref_fn, jkern in (
            (tq.sign_roundtrip_batched, jref.sign_roundtrip_ref,
             jq.sign_roundtrip_batched),
            (tq.topk_threshold_batched, jref.topk_threshold_ref,
             jq.topk_threshold_batched)):
        got = tfn(tx, ts)
        check(got, jref_fn(jx, js))
        check(got, jkern(jx, js, interpret=True))
    for n in range(N):
        for tfn, jref_fn, jkern in (
                (tq.sign_roundtrip_flat, jref.sign_roundtrip_ref,
                 jq.sign_roundtrip_flat),
                (tq.topk_threshold_flat, jref.topk_threshold_ref,
                 jq.topk_threshold_flat)):
            got = tfn(tx[n], ts[n])
            check(got, jref_fn(jx[n], js[n]))
            check(got, jkern(jx[n], js[n], interpret=True))


@pytest.mark.parametrize("store", list(DTYPES))
def test_biased_batched_equals_looped_flat(store):
    tx, _ = _biased_inputs(store, seed=6)
    ts = torch.from_numpy(SCALARS)
    for batched, flat in ((tq.sign_roundtrip_batched, tq.sign_roundtrip_flat),
                          (tq.topk_threshold_batched,
                           tq.topk_threshold_flat)):
        loop = torch.stack([flat(tx[n], ts[n]) for n in range(N)])
        assert torch.equal(batched(tx, ts).view(torch.uint8),
                           loop.view(torch.uint8))


def test_sign_and_threshold_semantics():
    """jnp.sign's rules, not torch.sign's: NaN stays NaN and -0 stays -0;
    the threshold keeps ties and -0 (at thr 0) and zeroes NaN."""
    x = torch.tensor([[float("nan"), -0.0, 0.0, 2.0, -3.0, float("inf")]])
    out = tq.sign_roundtrip_flat(x, torch.tensor(0.5))
    assert torch.isnan(out[0, 0])
    assert out[0, 1].item() == 0.0 and torch.signbit(out[0, 1])
    assert out[0, 2].item() == 0.0 and not torch.signbit(out[0, 2])
    assert out[0, 3:].tolist() == [0.5, -0.5, 0.5]
    keep = tq.topk_threshold_flat(x, torch.tensor(2.0))
    assert keep[0].tolist()[1:] == [0.0, 0.0, 2.0, -3.0, float("inf")]
    assert keep[0, 0].item() == 0.0
    zero = tq.topk_threshold_flat(x, torch.tensor(0.0))
    assert torch.signbit(zero[0, 1]) and zero[0, 0].item() == 0.0


def test_biased_cpu_calls_launch_nothing_and_bad_inputs_raise():
    tx, _ = _biased_inputs("fp32", seed=7)
    ts = torch.from_numpy(SCALARS)
    tq.reset_launches()
    tq.sign_roundtrip_batched(tx, ts)
    tq.topk_threshold_batched(tx, ts)
    tq.sign_roundtrip_flat(tx[0], ts[1])
    tq.topk_threshold_flat(tx[0], ts[0])
    assert sum(tq.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="3D"):
        tq.sign_roundtrip_batched(tx[0], ts)
    with pytest.raises(ValueError, match="thr"):
        tq.topk_threshold_batched(tx, ts[:2])
    with pytest.raises(ValueError, match="scale"):
        tq.sign_roundtrip_flat(tx[0], ts)
    with pytest.raises(TypeError, match="scale"):
        tq.sign_roundtrip_batched(tx, ts.double())
    with pytest.raises(TypeError, match="dtype"):
        tq.topk_threshold_flat(tx[0].double(), ts[0])
    with pytest.raises(TypeError, match="tensor"):
        tq.sign_roundtrip_flat(tx[0], 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        tq.topk_threshold_batched(tx.transpose(1, 2), ts)


# ------------------------------------------------ e4m3 stores on the CPU
#: magnitudes that walk e4m3's overflow rule (ml_dtypes: 464 rounds to
#: 448, NaN past it and for +-inf, NaN stays NaN)
E4M3_EDGE = np.array([447.0, 448.0, 464.0, 470.0, 500.0, 1e5, np.inf,
                      np.nan], np.float32)


@pytest.mark.parametrize("store", ["bf16", "e4m3", "e5m2"])
def test_store_as_follows_ml_dtypes(store):
    """`ref.store_as` against ml_dtypes' cast (what ``astype`` does in the
    JAX package) over the overflow edges, their neighbours one fp32 ulp
    away, subnormals, +-0, and log-uniform magnitudes across every
    format's range: bitwise for e4m3 (NaN sign included), NaN as NaN
    for bf16 and e5m2 (``Tensor.to`` writes its own NaN payload)."""
    tdt, jdt = DTYPES[store]
    rs = np.random.default_rng(31)
    edges = np.concatenate([E4M3_EDGE, [57344.0, 61439.0, 61440.0, 3e38,
                                        2.0 ** -9, 2.0 ** -10, 2.0 ** -17,
                                        0.0]]).astype(np.float32)
    near = np.concatenate([np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(0))])
    spread = (2.0 ** rs.uniform(-20, 20, 4000)).astype(np.float32)
    x = np.concatenate([edges, near, spread])
    x = np.concatenate([x, -x])
    want = np.asarray(jnp.asarray(x).astype(jdt))
    got = tref.store_as(torch.from_numpy(x), tdt)
    if store == "e4m3":
        _bitwise(got, want)
        assert (want.view(np.uint8)[x == np.float32(464)] == 0x7E).all()
    else:
        _bitwise_nan(got, want)


def _e4(x):
    """fp32 numpy -> (torch e4m3, jnp e4m3), cast once by JAX."""
    jx = jnp.asarray(np.asarray(x, np.float32)).astype(jnp.float8_e4m3fn)
    return (torch.from_numpy(np.asarray(jx).view(np.uint8).copy()).view(
        torch.float8_e4m3fn), jx)


def _rows(cols=8):
    """theta, other, ef (e4m3-exact) rows whose delta ``(theta - other)
    + ef`` is 447, 448, 464, 470, 500 and 1344 and their negatives, each
    row constant over ``cols``."""
    tri = np.array([[448, 1, 0], [448, 0, 0], [240, -224, 0],
                    [448, -22, 0], [448, -52, 0], [448, -448, 448]],
                   np.float32)
    tri = np.concatenate([tri, -tri])
    return [np.repeat(tri[:, k:k + 1], cols, axis=1) for k in range(3)]


def _noise_for(x, s):
    """U[0,1) noise per row that sends ``floor(x / s + u)`` to +-1 for the
    rows' x of +-448 (clipped into [0, 1))."""
    r = np.abs(x / s)
    u = np.where(x > 0, 1.5 - r, r - 0.5)
    return np.clip(u, 0.0, np.float32(1 - 2 ** -24)).astype(np.float32)


@pytest.mark.parametrize("fn", ["quant", "uplink", "broadcast", "sign",
                                "topk"])
def test_e4m3_overflow_stores_bitwise_vs_jax_eager_refs(fn):
    """Every plain version with an e4m3 output, on inputs whose fp32
    results walk `E4M3_EDGE` (and 1344, 896, NaN and inf scales), against
    the JAX package's eager refs: bitwise, a NaN as NaN (sign and payload
    of arithmetic NaNs are the framework's own).  ``Tensor.to`` alone
    saturates these stores at 448 in some torch versions."""
    qmax = 127
    if fn == "quant":
        mags = np.concatenate([E4M3_EDGE, E4M3_EDGE])
        sign = np.repeat([1.0, -1.0], E4M3_EDGE.size).astype(np.float32)
        x = np.repeat((448 * sign)[:, None], 8, axis=1)
        s = mags[:, None].astype(np.float32)
        u = np.repeat(_noise_for(x[:, :1], s), 8, axis=1)
        tx, jx = _e4(x)
        calls = [(lambda: tref.quant_roundtrip_ref(tx, torch.from_numpy(u),
                                                   torch.from_numpy(s),
                                                   qmax=qmax),
                  jref.quant_roundtrip_ref(jx, jnp.asarray(u),
                                           jnp.asarray(s), qmax=qmax)),
                 (lambda: tq.quant_roundtrip_flat(tx, torch.from_numpy(u),
                                                  torch.from_numpy(s),
                                                  qmax=qmax), None)]
    elif fn in ("uplink", "broadcast"):
        theta, other, ef = _rows()
        d = (theta - other) + ef
        # q = +-1 (xhat = d) in the first copy, +-2 (xhat = 2d) in the
        # second; a NaN and an inf scale in the third
        s = np.concatenate([np.abs(d[:, :1]), np.abs(d[:, :1]) / 2,
                            np.abs(d[:, :1])]).astype(np.float32)
        s[-2:, 0] = [np.nan, np.inf]
        theta, other, ef = (np.concatenate([a] * 3) for a in (theta, other,
                                                                ef))
        u = np.full(theta.shape, 0.5, np.float32)
        (tt, jt), (to, jo), (te, je) = (_e4(a) for a in (theta, other, ef))
        tu, ts = torch.from_numpy(u), torch.from_numpy(s)
        ju, js = jnp.asarray(u), jnp.asarray(s)
        if fn == "uplink":
            calls = [(lambda: tref.uplink_roundtrip_ref(tt, to, te, tu, ts,
                                                        qmax=qmax),
                      jref.uplink_roundtrip_ref(jt, jo, je, ju, js,
                                                qmax=qmax)),
                     (lambda: tq.uplink_roundtrip_flat(tt, to, te, tu, ts,
                                                       qmax=qmax), None)]
        else:
            calls = [(lambda: tref.broadcast_roundtrip_ref(tt, to, te, tu,
                                                           ts, qmax=qmax),
                      jref.broadcast_roundtrip_ref(jt, jo, je, ju, js,
                                                   qmax=qmax)),
                     (lambda: tq.broadcast_roundtrip_flat(tt, to, te, tu,
                                                          ts, qmax=qmax),
                      None)]
    else:
        rs = np.random.default_rng(33)
        n = 2 * E4M3_EDGE.size
        x = np.where(rs.uniform(size=(n, 2, 8)) < 0.5, -1.0, 1.0)
        x[:, 0, :3] = [448.0, -448.0, np.nan]
        v = np.concatenate([E4M3_EDGE, -E4M3_EDGE]).astype(np.float32)
        if fn == "topk":
            v = np.abs(v)
        tx, jx = _e4(x)
        tv, jv = torch.from_numpy(v), jnp.asarray(v)
        tfn = tref.sign_roundtrip_ref if fn == "sign" else \
            tref.topk_threshold_ref
        jfn = jref.sign_roundtrip_ref if fn == "sign" else \
            jref.topk_threshold_ref
        batched = tq.sign_roundtrip_batched if fn == "sign" else \
            tq.topk_threshold_batched
        calls = [(lambda: tfn(tx, tv), jfn(jx, jv)),
                 (lambda: batched(tx, tv), None)]
    want = calls[0][1]
    for call, _ in calls:
        got = call()
        got = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, wants):
            _bitwise_nan(g, w)
    first = np.asarray(wants[0], np.float32)
    if fn != "topk":    # a threshold only keeps or zeroes stored values
        assert np.isnan(first).sum() >= 4 * 8
    assert (first == 448).any() and (first == -448).any()


@pytest.mark.parametrize("name", list(UPLINK_FORM_CASES))
def test_uplink_takes_f32x4_cases(name):
    """`uplink_takes_f32x4` over the table the card's form test runs
    (`tests/test_torch_kernels_cuda.py`): the fp32 form only for fp32
    theta, start, ef and outputs, all six pointers 16-byte aligned
    (``data_ptr() % 16``, the same rule on either device) and C % 4 ==
    0.  The same inputs through the wrapper's CPU route are bitwise the
    JAX package's eager ref, and launch nothing."""
    shape, shared, *_, f32x4 = UPLINK_FORM_CASES[name]
    theta, start, ef, u, s = uplink_form_inputs("cpu", name, 31)
    outs = [torch.empty(theta.shape, dtype=theta.dtype)] * 2
    assert tq.uplink_takes_f32x4(outs, theta, start, ef, u) == f32x4
    entry = (tq.uplink_roundtrip_batched if len(shape) == 3
             else tq.uplink_roundtrip_flat)
    tq.reset_launches()
    got = entry(theta, start, ef, u, s, qmax=127)
    assert sum(tq.LAUNCHES.values()) + sum(tq.F32X4_LAUNCHES.values()) == 0
    j = [jnp.asarray(np.asarray(t.float()).astype(np.float32)).astype(
        DTYPES[k][1]) for t, k in ((theta, _name(theta)), (start, "fp32"),
                                   (ef, _name(ef)))]
    jstart = j[1][None] if shared and len(shape) == 3 else j[1]
    _bitwise(got, jref.uplink_roundtrip_ref(j[0], jstart, j[2],
                                            jnp.asarray(u.numpy()),
                                            jnp.asarray(s.numpy()),
                                            qmax=127))


def _name(t):
    return next(k for k, (tdt, _) in DTYPES.items() if tdt == t.dtype)


def _jnp_of(t):
    """A CPU tensor's values as a jnp array of its dtype (cast from fp32
    by JAX: the values are representable, so the cast is exact)."""
    return jnp.asarray(t.float().numpy()).astype(DTYPES[_name(t)][1])


@pytest.mark.parametrize("name", list(BROADCAST_FORM_CASES))
def test_broadcast_takes_f32x4_cases(name):
    """`broadcast_takes_f32x4` over the table the card's form test runs
    (`tests/test_torch_kernels_cuda.py`): the fp32 form only for fp32
    theta, ref, ef and outputs, all six pointers 16-byte aligned and
    C % 4 == 0.  The same inputs, with -0, NaN, +-inf and a NaN and an
    inf scale, through the wrapper's CPU route are bitwise the JAX
    package's eager ref (a NaN need only be NaN in both), and launch
    nothing."""
    shape, shared, *_, f32x4 = BROADCAST_FORM_CASES[name]
    theta, ref_, ef, u, s = broadcast_form_inputs("cpu", name, 53,
                                                  special=True)
    outs = [torch.empty(shape, dtype=theta.dtype)] * 2
    assert tq.broadcast_takes_f32x4(outs, theta, ref_, ef, u) == f32x4
    entry = (tq.broadcast_roundtrip_batched if len(shape) == 3
             else tq.broadcast_roundtrip_flat)
    tq.reset_launches()
    got = entry(theta, ref_, ef, u, s, qmax=127)
    assert sum(tq.LAUNCHES.values()) + sum(tq.F32X4_LAUNCHES.values()) == 0
    jtheta = _jnp_of(theta)
    want = jref.broadcast_roundtrip_ref(
        jtheta[None] if shared and len(shape) == 3 else jtheta,
        _jnp_of(ref_), _jnp_of(ef), jnp.asarray(u.numpy()),
        jnp.asarray(s.numpy()), qmax=127)
    for g, w in zip(got, want):
        _bitwise_nan(g, w)
    assert all(bool(torch.isnan(g.float()).any()) for g in got)


@pytest.mark.parametrize("name", list(BIASED_FORM_CASES))
def test_biased_takes_f32x4_cases(name):
    """`biased_takes_f32x4` over the table the card's form test runs: the
    fp32 form only for fp32 x and out, both 16-byte aligned, and a
    multiple of 4 elements a client.  The same inputs, with NaN, +-0,
    +-inf and ties at each client's threshold (one client's scalar 0 in
    a stack), through the sign and threshold wrappers' CPU routes are
    bitwise the JAX package's eager refs (a NaN need only be NaN in
    both), and launch nothing."""
    shape, _, _, f32x4 = BIASED_FORM_CASES[name]
    x, v = biased_form_inputs("cpu", name, 59, special=True)
    assert tq.biased_takes_f32x4(torch.empty_like(x), x) == f32x4
    kind = "batched" if len(shape) == 3 else "flat"
    jx, jv = _jnp_of(x), jnp.asarray(v.numpy())
    tq.reset_launches()
    for fn in ("sign_roundtrip", "topk_threshold"):
        got = getattr(tq, f"{fn}_{kind}")(x, v)
        _bitwise_nan(got, getattr(jref, f"{fn}_ref")(jx, jv))
    assert sum(tq.LAUNCHES.values()) + sum(tq.F32X4_LAUNCHES.values()) == 0
    xf = x.float()
    assert bool(torch.isnan(xf).any() and ((xf == 0)
                                           & torch.signbit(xf)).any())
    assert bool(torch.isinf(xf).any()) == (x.dtype != torch.float8_e4m3fn)

