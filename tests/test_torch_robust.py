"""The port's adversarial fleet against the JAX package's.

* Kernel plain versions: `stale_accum_ref` and `robust_agg_ref` sum over
  K in ascending order with one rounding per multiply and per add, which
  is bitwise the JAX package's eager refs (``repro.kernels.ref``).  The
  jitted refs and the Pallas kernels in interpret mode take the same
  ascending order but contract each multiply into its add (an FMA, found
  by emulating it in float64: 0 of 1,920 coordinates differ), so against
  those the band is FMA-aware: per coordinate ``2 K 2^-23 sum_k
  |w_k xs_k|`` (divided by the survivor weight when normalised), NaN and
  inf in the same places.  The survivor masks are equal exactly.
* The robust layer: masks, label corruption and partitions equal element
  for element (numpy on the same seeds); `trim_count` and `resolve`
  equal; sign-flip and scale attacks bitwise; ``random_wire`` fed the JAX
  draw, and `clip_scales`, within rtol 1e-6 (``jnp.std`` and the norms
  are full reductions, summed in other orders by XLA and torch).
* Rounds: 2 rounds of the port's `FedEngine` against ``jax.jit(FedEngine.
  round)`` with ``use_pallas=True`` and ``comm.use_pallas=True`` (MLP
  hidden 16, C=4, J=3, tau=2, B=8) on the same state, data and draws.
  The direct path within ``rtol=1e-5, atol=1e-6`` (the GEMMs and XLA's
  contraction, tests/test_torch_engine.py); the comm path under the flip
  band of tests/test_torch_comm_round.py (at most 16 coordinates per
  buffer beyond it, each within its streams' largest quant step).  A
  trimmed mean or median is continuous in its inputs (a swap between two
  near-equal survivors moves the result by their difference), so the
  bands hold.  At S=2 a trimmed mean trims nothing (it resolves to the
  mean, in both packages), so the comm path's trimming is held at S=4
  (the median).  Degenerate configs equal the port's own mean path
  bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import RobustConfig as JRobustConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.kernels import ref as jref
from repro.kernels.robust_agg import _survivor_mask as j_survivor_mask
from repro.kernels.robust_agg import robust_agg_flat as j_robust_agg
from repro.kernels.stale_accum import stale_accum_flat as j_stale_accum
from repro.models.small import MLPTask as JMLPTask
from repro.robust import aggregators as jagg
from repro.robust import attacks as jatt
from repro_torch import convert
from repro_torch.comm import compressors as tcomp
from repro_torch.configs.base import (AGGREGATORS, ATTACKS, COMM_STREAMS,
                                      CommConfig, FedConfig, RobustConfig)
from repro_torch.core.fed import FedEngine
from repro_torch.data import partition as tpart
from repro_torch.kernels import KERNELS
from repro_torch.kernels import ref as tref
from repro_torch.kernels import robust_agg as trobust
from repro_torch.kernels import stale_accum as tstale
from repro_torch.models.small import MLPTask
from repro_torch.robust import aggregators as tagg
from repro_torch.robust import attacks as tatt

EPS32 = 2.0 ** -23
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "float8_e4m3fn": jnp.float8_e4m3fn}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it: the JAX package's
    jitted Pallas kernels traced here would otherwise stay in jax's
    caches for other modules' tests, which trace the same shapes under
    other launch geometries."""
    yield
    jax.clear_caches()


# ----------------------------------------------------------- kernel refs
def _wires(K, R, C, dtype, seed, special=False):
    """The same (K, R, C) wires for both packages: fp32 numpy cast by
    JAX, the port's tensor made from the JAX bits.  Past four arrivals,
    ties are planted (arrivals 1 and 2 equal, arrival 4 equal to 0 in
    every other row); ``special`` plants NaN, +-inf (not in e4m3, which
    has no inf) and an all -inf column."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((K, R, C)).astype(np.float32)
    if K > 4:
        x[2] = x[1]
        x[4, ::2] = x[0, ::2]
    if special:
        flat = x.reshape(K, -1)
        for k, val in ((3, np.nan), (0, np.nan), (5, np.inf), (1, -np.inf)):
            flat[k, rs.choice(flat.shape[1], 20, replace=False)] = val
        flat[:, 7] = -np.inf
        if dtype == "float8_e4m3fn":
            flat[np.isinf(flat)] = np.nan
    jx = jnp.asarray(x).astype(JAX_DTYPES[dtype])
    if dtype == "float32":
        tx = torch.from_numpy(np.asarray(jx).copy())
    else:
        bits = np.asarray(jx).view(np.int16 if dtype == "bfloat16"
                                   else np.uint8).copy()
        tx = torch.from_numpy(bits).view(TORCH_DTYPES[dtype])
    return jx, tx


def _vectors(K, seed):
    rs = np.random.default_rng(seed)
    w = rs.uniform(0.25, 2.0, K).astype(np.float32)
    s = rs.uniform(0.5, 1.5, K).astype(np.float32)
    return w, s


def _same(got, want):
    """Bitwise, a NaN compared as NaN (torch and XLA NaN payloads may
    differ)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


def _within_fma_band(got, want, band):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    diff = np.abs(got[fin] - want[fin])
    assert np.all(diff <= band[fin]), float(np.max(diff - band[fin]))


@pytest.mark.parametrize("dtype", list(JAX_DTYPES))
@pytest.mark.parametrize("K", [1, 5])
def test_stale_accum_plain_vs_jax(K, dtype):
    jx, tx = _wires(K, 6, 200, dtype, seed=K)
    w, _ = _vectors(K, seed=10 + K)
    inv = np.float32(1.0) / np.float32(w.sum())
    got = tref.stale_accum_ref(tx, torch.from_numpy(w), float(inv)).numpy()
    _same(got, jref.stale_accum_ref(jx, w, inv))
    # the Pallas kernel (interpret): the same order with FMA contraction
    terms = np.abs(np.asarray(jx, np.float64) * w[:, None, None]).sum(0)
    band = 2 * K * EPS32 * terms * inv + 1e-30
    _within_fma_band(got, j_stale_accum(jx, w, inv, interpret=True), band)
    # the CPU wrapper runs the plain version and launches nothing
    tstale.reset_launches()
    _same(tstale.stale_accum_flat(tx, w.tolist(), float(inv)).numpy(), got)
    _same(tstale.stale_accum_flat(tx, torch.from_numpy(w),
                                  torch.tensor([inv])).numpy(), got)
    assert tstale.LAUNCHES["stale_accum_flat"] == 0


ROBUST_CASES = [(K, trim, dtype, special)
                for K in (9, 6)
                for trim in sorted({0, 1, (K - 1) // 2})
                for dtype in JAX_DTYPES
                for special in (False, True)]


@pytest.mark.parametrize(
    "K,trim,dtype,special", ROBUST_CASES,
    ids=[f"K{k}-trim{t}-{d}{'-special' if s else ''}"
         for k, t, d, s in ROBUST_CASES])
def test_robust_agg_plain_vs_jax(K, trim, dtype, special):
    """Eager ref bitwise, jitted ref and Pallas kernel within the FMA
    band, both normalize settings; the survivor masks equal."""
    jx, tx = _wires(K, 5, 96, dtype, seed=100 + K + trim, special=special)
    w, s = _vectors(K, seed=K + trim)
    xs32 = np.asarray(jx, np.float32) * s[:, None, None]
    mask = tref.survivor_mask(torch.from_numpy(xs32), trim).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(j_survivor_mask(jnp.asarray(xs32), trim)))
    wm = np.where(mask, w[:, None, None], 0.0)
    den = wm.sum(0)
    with np.errstate(invalid="ignore", over="ignore"):
        terms = np.nansum(np.abs(xs32.astype(np.float64) * wm), axis=0)
    terms[~np.isfinite(terms)] = 0.0
    jit_ref = jax.jit(jref.robust_agg_ref,
                      static_argnames=("trim", "normalize"))
    for normalize in (True, False):
        got = tref.robust_agg_ref(tx, torch.from_numpy(w),
                                  torch.from_numpy(s), trim=trim,
                                  normalize=normalize).numpy()
        _same(got, jref.robust_agg_ref(jx, w, s, trim=trim,
                                       normalize=normalize))
        band = 2 * K * EPS32 * terms / (den if normalize else 1.0) + 1e-30
        _within_fma_band(got, jit_ref(jx, w, s, trim=trim,
                                      normalize=normalize), band)
        _within_fma_band(got, j_robust_agg(jx, w, s, trim=trim,
                                           normalize=normalize,
                                           interpret=True), band)
        trobust.reset_launches()
        _same(trobust.robust_agg_flat(tx, w.tolist(), s.tolist(), trim=trim,
                                      normalize=normalize).numpy(), got)
        assert trobust.LAUNCHES["robust_agg_flat"] == 0


def test_survivor_mask_rules():
    """The reference's rules, one coordinate each: the first index among
    equal values, a NaN counted as the maximum (the first NaN wins), and
    a surviving -inf losing to the -FLT_MAX fill of removed entries, so
    that pass hits an entry already removed."""
    cols = np.array([
        [1.0, 3.0, 3.0, 0.0, 0.0],
        [np.nan, 1.0, np.nan, 2.0, 0.0],
        [5.0, -np.inf, -np.inf, -np.inf, -np.inf],
    ], np.float32).T[:, :, None]
    masks = {}
    for trim in (1, 2):
        masks[trim] = tref.survivor_mask(torch.from_numpy(cols),
                                         trim).numpy()[:, :, 0]
        np.testing.assert_array_equal(
            masks[trim], np.asarray(j_survivor_mask(jnp.asarray(cols),
                                                    trim))[:, :, 0])
    T, F = True, False
    np.testing.assert_array_equal(masks[1][:, 0], [T, F, T, F, T])
    np.testing.assert_array_equal(masks[1][:, 1], [F, T, F, T, T])
    np.testing.assert_array_equal(masks[2][:, 1], [F, F, F, T, F])
    # the second max pass meets only -inf survivors: it hits the removed
    # 5.0 again, and the min passes then take two of the -infs
    np.testing.assert_array_equal(masks[2][:, 2], [F, F, F, T, T])


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="2\\*trim"):
        trobust.robust_agg_flat(x, [1.0] * 4, [1.0] * 4, trim=2)
    with pytest.raises(ValueError, match="shape"):
        trobust.robust_agg_flat(x, [1.0] * 3, [1.0] * 4, trim=1)
    with pytest.raises(ValueError, match="\\(K, R, C\\)"):
        tstale.stale_accum_flat(x[0], [1.0] * 2, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        tstale.stale_accum_flat(x.double(), [1.0] * 4, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tstale.stale_accum_flat(x.transpose(1, 2), [1.0] * 4, 1.0)
    with pytest.raises(ValueError, match="one fp32 element"):
        tstale.stale_accum_flat(x, [1.0] * 4, torch.ones(2))
    assert KERNELS["stale_accum"] and KERNELS["robust_agg"]
    assert all(KERNELS.values())


# --------------------------------------------------------- robust layer
AGG_TABLE = [dict(aggregator=a, trim_fraction=f, clip_norm=c)
             for a in AGGREGATORS for f in (0.0, 0.1, 0.25, 0.5)
             for c in (0.0, 1.5)]


def test_trim_count_and_resolve_match_jax():
    for kw in AGG_TABLE:
        for K in (1, 2, 3, 4, 7, 16, 32):
            t, j = RobustConfig(**kw), JRobustConfig(**kw)
            assert tagg.trim_count(t, K) == jagg.trim_count(j, K), (kw, K)
            assert tagg.resolve(t, K) == jagg.resolve(j, K), (kw, K)
    with pytest.raises(ValueError):
        tagg.resolve(RobustConfig(aggregator="krum"), 4)


def test_masks_and_label_corruption_match_jax():
    rs = np.random.default_rng(0)
    for seed in (0, 3, 11):
        for frac in (0.0, 0.1, 0.25, 0.5, 1.0):
            kw = dict(attack="sign_flip", attack_fraction=frac,
                      label_noise_fraction=frac, label_noise_rate=0.4,
                      seed=seed)
            t, j = RobustConfig(**kw), JRobustConfig(**kw)
            for C in (4, 10, 32):
                np.testing.assert_array_equal(tatt.byzantine_mask(t, C),
                                              jatt.byzantine_mask(j, C))
                lm = tatt.label_noise_mask(t, C)
                np.testing.assert_array_equal(lm, jatt.label_noise_mask(j, C))
                assert (tatt.wire_attack_active(t, C)
                        == jatt.wire_attack_active(j, C))
                labels = rs.integers(0, 10, (C, 3, 8))
                np.testing.assert_array_equal(
                    tatt.corrupt_labels(t, labels, lm, 10),
                    jatt.corrupt_labels(j, labels, lm, 10))
    for attack in ATTACKS:
        t = RobustConfig(attack=attack, attack_fraction=0.5)
        np.testing.assert_array_equal(
            tatt.byzantine_mask(t, 8),
            jatt.byzantine_mask(JRobustConfig(attack=attack,
                                              attack_fraction=0.5), 8))
    with pytest.raises(ValueError):
        tatt.byzantine_mask(RobustConfig(attack="flood"), 4)


def test_partitions_match_jax():
    rs = np.random.default_rng(1)
    labels = rs.integers(0, 10, 600)
    for seed in (0, 5):
        for alpha in (0.1, 1.0, 100.0):
            tp = tpart.dirichlet_label_partition(labels, 8, alpha, seed=seed)
            jp = jpart.dirichlet_label_partition(labels, 8, alpha, seed=seed)
            assert len(tp) == len(jp)
            for a, b in zip(tp, jp):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tpart.equalize(tp, 40, seed),
                                          jpart.equalize(jp, 40, seed))
            np.testing.assert_array_equal(
                tpart.label_marginals(labels, tp, 10),
                jpart.label_marginals(labels, jp, 10))
        sizes = tpart.quantity_skew_sizes(600, 8, 0.5, seed=seed)
        np.testing.assert_array_equal(
            sizes, jpart.quantity_skew_sizes(600, 8, 0.5, seed=seed))
        np.testing.assert_array_equal(
            np.concatenate(tpart.subsample(tp, sizes // 2, seed)),
            np.concatenate(jpart.subsample(jp, sizes // 2, seed)))
        xs = rs.standard_normal((8, 5, 4)).astype(np.float32)
        np.testing.assert_array_equal(tpart.feature_shift(xs, 0.3, seed),
                                      jpart.feature_shift(xs, 0.3, seed))


@pytest.mark.parametrize("attack", ["sign_flip", "scale", "random_wire"])
def test_attack_wires_match_jax(attack):
    rs = np.random.default_rng(2)
    x = rs.standard_normal((6, 4, 64)).astype(np.float32)
    x[3] *= 1e-9     # a row whose std falls below the 1e-8 floor
    mask = np.array([True, False, True, True, False, False])
    kw = dict(attack=attack, attack_fraction=0.5, attack_scale=7.5)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jatt.attack_wires(JRobustConfig(**kw), jnp.asarray(x),
                                        mask, key))
    noise = np.array(jax.random.normal(
        jax.random.fold_in(key, tatt.ATTACK_SALT), x.shape, jnp.float32))
    got = tatt.attack_wires(RobustConfig(**kw), torch.from_numpy(x), mask,
                            noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got[~mask], x[~mask])
    if attack == "random_wire":
        # the row's std is a full reduction: ulps apart in XLA and torch
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        _same(got, want)


def test_clip_scales_match_jax():
    rs = np.random.default_rng(3)
    x = rs.standard_normal((7, 5, 96)).astype(np.float32)
    x[2] *= 1e-3                       # inside the ball: exactly 1
    for clip in (0.5, 5.0, 30.0):
        got = tagg.clip_scales(torch.from_numpy(x), clip).numpy()
        want = np.asarray(jagg.clip_scales(jnp.asarray(x), clip))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got == 1.0, want == 1.0)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kw", [
    dict(aggregator="trimmed_mean", trim_fraction=0.25),
    dict(aggregator="coordinate_median"),
    dict(aggregator="norm_clip", clip_norm=4.0),
    dict(aggregator="mean")], ids=lambda kw: kw["aggregator"])
def test_aggregate_stack_matches_jax(kw, normalize):
    rs = np.random.default_rng(4)
    K = 8
    x = rs.standard_normal((K, 5, 96)).astype(np.float32)
    x[5] *= 20.0                       # clipped by norm_clip
    w, _ = _vectors(K, seed=6)
    got = tagg.aggregate_stack(RobustConfig(**kw), torch.from_numpy(x),
                               torch.from_numpy(w),
                               normalize=normalize).numpy()
    for use_pallas in (False, True):
        want = np.asarray(jagg.aggregate_stack(
            JRobustConfig(**kw), jnp.asarray(x), w, normalize=normalize,
            use_pallas=use_pallas, interpret=True))
        # the clip scales and XLA's contraction: ulps per term
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ rounds
C, J, TAU, B, HIDDEN, ROUNDS = 4, 3, 2, 8, 16, 2
RTOL, ATOL = 1e-5, 1e-6
MAX_FLIPS = 16
STEPS_OF = {"params": ("uplink", "downlink"), "m": ("uplink", "downlink"),
            "h": ("uplink", "downlink", "hessian"),
            "comm_ef": ("uplink",), "comm_dn_model": ("downlink",),
            "comm_dn_ef": ("downlink",)}
SALT_UP = 0xC0
SIGN_TRIM = dict(attack="sign_flip", attack_fraction=0.25,
                 aggregator="trimmed_mean", trim_fraction=0.25)
MEDIAN = dict(aggregator="coordinate_median")
ROUND_CASES = {
    "direct-signflip-trimmed-parallel": ("parallel", {}, SIGN_TRIM),
    "direct-signflip-trimmed-sequential": ("sequential", {}, SIGN_TRIM),
    "direct-median-parallel": ("parallel", {}, MEDIAN),
    "direct-median-sequential": ("sequential", {}, MEDIAN),
    "comm-int8-randomwire-trimmed-parallel": (
        "parallel", dict(compressor="int8", participation=0.5),
        dict(attack="random_wire", attack_fraction=0.5,
             aggregator="trimmed_mean", trim_fraction=0.25)),
    "comm-int8-signflip-median-parallel": (
        "parallel", dict(compressor="int8"),
        dict(attack="sign_flip", attack_fraction=0.25,
             aggregator="coordinate_median")),
    "comm-int8-scale-normclip-sequential": (
        "sequential", dict(compressor="int8", participation=0.5),
        dict(attack="scale", attack_fraction=0.25, attack_scale=10.0,
             aggregator="norm_clip", clip_norm=0.05)),
}


@pytest.fixture(scope="module")
def data():
    key = jax.random.PRNGKey(0)
    x, y = jsyn.make_image_data(key, 256, "mnist", noise=1.3)
    part = jsyn.dirichlet_partition(jax.random.fold_in(key, 1), y, C,
                                    alpha=0.5)
    tr, _ = jsyn.train_test_split(part)
    batches = [jsyn.client_batches(jax.random.fold_in(key, 100 + r), x, y,
                                   tr, B) for r in range(ROUNDS)]
    rngs = [jax.random.fold_in(key, 1000 + r) for r in range(ROUNDS)]
    return key, batches, rngs


def round_draws(jeng, params, rng):
    """The JAX round's random inputs in the port's format: ``(gumbel,
    comm_noise)``, per-client noise by client id, the attack's gaussian
    by position in the attacked stack."""
    crngs = [jax.random.fold_in(rng, i) for i in range(C)]
    gumbel = np.stack([np.stack([
        np.asarray(jax.random.gumbel(jax.random.fold_in(k, j), (B, 10),
                                     jnp.float32)) for j in range(J)])
        for k in crngs])
    rt = jeng.comm_runtime(params)
    fed = jeng.fed
    noise = {}
    if jeng.uses_direct_path():
        n, akey = C, crngs[0]
    else:
        noise["participants"] = np.array(jeng.round_participants(rng))
        n, akey = len(noise["participants"]), rng
        if not fed.comm.lossless:
            noise["uplink"] = np.stack([np.array(jax.random.uniform(
                jax.random.fold_in(k, SALT_UP), (rt.spec.rows, rt.spec.cols)))
                for k in crngs])
    if fed.robust.attack == "random_wire":
        noise["attack"] = np.asarray(jax.random.normal(
            jax.random.fold_in(akey, tatt.ATTACK_SALT),
            (n, rt.spec.rows, rt.spec.cols), jnp.float32))
    return gumbel, noise


def _batch(b):
    return {"x": torch.tensor(np.asarray(b["x"])),
            "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}


def _buffers(st):
    """name -> fp32 numpy of every compared buffer of a numpy state."""
    out = {f"params[{k}]": np.asarray(v, np.float32)
           for k, v in st["params"].items()}
    opt = st.get("client_opt")
    if opt is not None:
        m, h = (opt["m"], opt["h"]) if isinstance(opt, dict) else opt
        out["m"], out["h"] = np.asarray(m), np.asarray(h)
    for k in convert.COMM_KEYS:
        if st.get(k) is not None:
            out[k] = np.asarray(st[k])
    return out


def _steps_probe(monkeypatch, comm):
    """The largest int8 row scale of each stream in a round (what a
    floor flip may move a coordinate by)."""
    steps = {}
    orig = tcomp.StochasticQuant.scales

    def wrapped(self, flat):
        s = orig(self, flat)
        for stream in COMM_STREAMS:
            if self.cfg == comm.stream(stream):
                steps[stream] = max(steps.get(stream, 0.0), float(s.max()))
        return s
    monkeypatch.setattr(tcomp.StochasticQuant, "scales", wrapped)
    return steps


def _engines(strategy, comm_kw, robust_kw):
    cfg = dict(num_clients=C, local_iters=J, lr=0.02, tau=TAU,
               total_rounds=8, strategy=strategy)
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN), JFedConfig(
        use_pallas=True, comm=JCommConfig(use_pallas=True, **comm_kw),
        robust=JRobustConfig(**robust_kw), **cfg))
    teng = FedEngine(MLPTask(hidden=HIDDEN), FedConfig(
        comm=CommConfig(**comm_kw), robust=RobustConfig(**robust_kw), **cfg),
        device="cpu")
    return jeng, teng


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_adversarial_round_parity(data, monkeypatch, name):
    strategy, comm_kw, robust_kw = ROUND_CASES[name]
    key, batches, rngs = data
    jeng, teng = _engines(strategy, comm_kw, robust_kw)
    steps = _steps_probe(monkeypatch, teng.fed.comm)
    jstate = jeng.init(jax.random.fold_in(key, 3))
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    params0 = jstate["params"]
    jround = jax.jit(jeng.round)
    trobust.reset_launches()
    for r in range(ROUNDS):
        gumbel, noise = round_draws(jeng, params0, rngs[r])
        jstate, jm = jround(jstate, batches[r], rngs[r])
        steps.clear()
        tstate, tm = teng.round(tstate, _batch(batches[r]),
                                gumbel=torch.from_numpy(gumbel),
                                comm_noise=noise)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        want = _buffers(jax.tree.map(np.asarray, jstate))
        got = _buffers(convert.state_to_numpy(tstate))
        assert sorted(got) == sorted(want)
        for buf, w in want.items():
            band = ATOL + RTOL * np.abs(w)
            diff = np.abs(got[buf] - w)
            out = diff > band
            if teng.uses_direct_path():
                assert not out.any(), (buf, float(diff.max()))
                continue
            step = sum(steps.get(s, 0.0)
                       for s in STEPS_OF[buf.split("[")[0]])
            assert int(out.sum()) <= MAX_FLIPS, (buf, int(out.sum()))
            assert np.all(diff[out] <= step + band[out]), (buf, step)
    # CPU tensors: the plain versions ran, no kernel launched
    assert trobust.LAUNCHES["robust_agg_flat"] == 0


DEGENERATE = {
    "trim-rounds-to-0": dict(aggregator="trimmed_mean", trim_fraction=0.1),
    "clip-off": dict(aggregator="norm_clip", clip_norm=0.0),
    "no-byzantine-client": dict(attack="sign_flip", attack_fraction=0.1),
    "attack-none": dict(attack="none", attack_fraction=0.5),
}


@pytest.mark.parametrize("path", ["direct", "comm"])
@pytest.mark.parametrize("strategy", ["parallel", "sequential"])
@pytest.mark.parametrize("name", list(DEGENERATE))
def test_degenerate_robust_config_is_the_mean_path(name, strategy, path):
    """A `RobustConfig` that resolves to the mean (and attacks no one)
    leaves two rounds bitwise the default config's."""
    comm = (CommConfig() if path == "direct"
            else CommConfig(compressor="int8", participation=0.5))
    base = FedConfig(num_clients=C, local_iters=2, tau=TAU, lr=0.02,
                     strategy=strategy, comm=comm)
    rs = np.random.default_rng(7)
    x = torch.tensor(rs.standard_normal((C, B, 28, 28, 1)),
                     dtype=torch.float32)
    y = torch.tensor(rs.integers(0, 10, (C, B)))
    out = []
    for fed in (base, dataclasses.replace(
            base, robust=RobustConfig(**DEGENERATE[name]))):
        eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
        g = torch.Generator().manual_seed(0)
        state = eng.init(g)
        for _ in range(2):
            state, _ = eng.round(state, {"x": x, "y": y}, generator=g)
        out.append(_buffers(convert.state_to_numpy(state)))
    assert sorted(out[0]) == sorted(out[1])
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k])


def test_random_wire_round_draws_from_the_generator():
    """Without injected noise the attack's gaussian comes from the
    round's generator: two runs on one seed agree bitwise, another seed
    differs."""
    fed = FedConfig(num_clients=C, local_iters=1, tau=TAU, lr=0.02,
                    robust=RobustConfig(attack="random_wire",
                                        attack_fraction=0.5,
                                        aggregator="coordinate_median"))
    rs = np.random.default_rng(8)
    batch = {"x": torch.tensor(rs.standard_normal((C, B, 28, 28, 1)),
                               dtype=torch.float32),
             "y": torch.tensor(rs.integers(0, 10, (C, B)))}
    outs = []
    for seed in (0, 0, 1):
        eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
        g = torch.Generator().manual_seed(seed)
        state = eng.init(torch.Generator().manual_seed(5))
        state, _ = eng.round(state, batch, generator=g)
        outs.append(eng.pack_state(state)["params"])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="attack"):
        eng.round(state, batch, gumbel=torch.zeros(C, 1, B, 10),
                  comm_noise={"attack": np.zeros((2, 3, 4), np.float32)})
