"""The Sophia health probes of the PyTorch port (`repro_torch.obs.probes`,
``ObsConfig.probes``) against the JAX package's.

* `sophia_health` on the same state (JAX-built, carried over by
  `repro_torch.convert`): ``clip_fraction`` (an integer count over one
  fp32 divide), ``h_staleness`` and ``gnb_refreshes`` exactly, the
  norms within ``rtol=1e-6`` (sums in another order); fp32, bf16 and
  e4m3 / e5m2 stacks, one client's buffer, both ``hessian_every_unit``s.
* A probed round's state is bitwise the unprobed round's, on the direct
  and the comm path, and its metrics are `sophia_health` of that state.
* The scheduler's event records carry the five scalars (sync from the
  round's metrics, semisync from the state after each apply), equal to
  the JAX scheduler's within the parity band of their states.
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import ObsConfig as JObsConfig
from repro.configs.base import SchedConfig as JSchedConfig
from repro.core import sophia as jsophia
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.models.small import MLPTask as JMLPTask
from repro.obs import probes as jprobes
from repro.sched import scheduler as jsched
from repro_torch import convert
from repro_torch.configs.base import (CommConfig, FedConfig, ObsConfig,
                                      SchedConfig)
from repro_torch.core.fed import FedEngine
from repro_torch.models.small import MLPTask
from repro_torch.obs import probes as tprobes
from repro_torch.obs import spans as tspans
from repro_torch.sched import scheduler as tsched
from test_torch_sched import jax_draws as sched_draws

C, J, TAU, B, HIDDEN = 4, 3, 2, 8, 16
EXACT = ("clip_fraction", "h_staleness", "gnb_refreshes")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it."""
    yield
    jax.clear_caches()


def test_probe_metrics_defined_once():
    assert tprobes.PROBE_METRICS == jprobes.PROBE_METRICS
    assert tspans.PROBE_METRICS is tprobes.PROBE_METRICS
    assert tsched.PROBE_METRICS is tprobes.PROBE_METRICS


def _opt(seed, shape, m_dt, h_dt):
    """m/h of mixed magnitudes: a third of the coordinates past the
    clip bound, every 13th h exactly 0 (the eps floor), a zero pad
    tail past ``total``."""
    rs = np.random.default_rng(seed)
    m = rs.standard_normal(shape) * np.exp(rs.uniform(-6, 0, shape))
    h = np.abs(rs.standard_normal(shape)) * np.exp(rs.uniform(-4, 2, shape))
    h.reshape(-1)[::13] = 0.0
    m.reshape(shape[:-2] + (-1,))[..., -100:] = 0.0
    h.reshape(shape[:-2] + (-1,))[..., -100:] = 0.0
    return m.astype(m_dt), h.astype(h_dt)


DTYPES = {"float32": (np.float32, np.float32),
          "bfloat16": (ml_dtypes.bfloat16, ml_dtypes.bfloat16),
          "fp8": (ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2)}


@pytest.mark.parametrize("unit", ["step", "round"])
@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("lead", [(C,), ()])
def test_sophia_health_matches_jax(unit, dtypes, lead):
    shape = lead + (3, 1024)
    total = 3 * 1024 - 100
    m, h = _opt(len(lead) + len(dtypes), shape, *DTYPES[dtypes])
    for r, tau, J_ in ((0, 2, 3), (1, 2, 3), (4, 3, 5), (7, 10, 10)):
        jfed = JFedConfig(num_clients=C, local_iters=J_, tau=tau,
                          hessian_every_unit=unit)
        tfed = FedConfig(num_clients=C, local_iters=J_, tau=tau,
                         hessian_every_unit=unit)
        want = jprobes.sophia_health(jsophia.SophiaState(m=m, h=h), r, jfed,
                                     total)
        got = tprobes.sophia_health(
            convert.state_from_numpy({"params": {}, "round": 0,
                                      "client_opt": {"m": m, "h": h}},
                                     "cpu")["client_opt"], r, tfed, total)
        assert sorted(got) == sorted(tprobes.PROBE_METRICS)
        for k in tprobes.PROBE_METRICS:
            assert got[k].dtype == torch.float32 and got[k].ndim == 0
            w, g = float(want[k]), float(got[k])
            if k in EXACT:
                assert g == w, (k, g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        assert 0.0 < float(got["clip_fraction"]) < 1.0


def _batches(seed, n=C):
    rs = np.random.default_rng(seed)
    return {"x": torch.tensor(rs.standard_normal((n, B, 28, 28, 1)),
                              dtype=torch.float32),
            "y": torch.tensor(rs.integers(0, 10, (n, B)))}


def _bitwise(a, b):
    a, b = convert.state_to_numpy(a), convert.state_to_numpy(b)

    def flat(s):
        out = dict(s["params"]) if isinstance(s["params"], dict) else {
            "params": s["params"]}
        out.update({f"opt.{k}": v for k, v in s["client_opt"].items()})
        out.update({k: s[k] for k in convert.COMM_KEYS if k in s})
        return out
    a, b = flat(a), flat(b)
    assert sorted(a) == sorted(b)
    for k in a:
        u, v = np.asarray(a[k]), np.asarray(b[k])
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u.view(np.uint8), v.view(np.uint8),
                                      err_msg=k)


PROBED = {
    "direct-parallel": ("parallel", dict()),
    "direct-sequential-round": ("sequential", dict()),
    "int8-bf16-parallel": ("parallel", dict(compressor="int8",
                                            state_dtype="bfloat16")),
    "bidir-fp8-sequential": ("sequential", dict(
        compressor="int8", downlink_compressor="int8",
        hessian_compressor="int4", participation=0.5,
        state_dtype="bfloat16", moment_dtype="float8_e4m3fn",
        hessian_dtype="float8_e5m2")),
}


@pytest.mark.parametrize("name", list(PROBED))
def test_probed_round_state_is_unprobed_state(name):
    strategy, comm_kw = PROBED[name]
    unit = "round" if name.endswith("round") else "step"
    states, metrics = [], []
    for probes in (False, True):
        eng = FedEngine(MLPTask(hidden=HIDDEN), FedConfig(
            num_clients=C, local_iters=J, tau=TAU, lr=0.02,
            strategy=strategy, hessian_every_unit=unit,
            comm=CommConfig(**comm_kw), obs=ObsConfig(probes=probes)),
            device="cpu")
        state = eng.pack_state(eng.init(torch.Generator().manual_seed(3)))
        g = torch.Generator().manual_seed(5)
        for r in range(3):
            state, m = eng.round(state, _batches(r), generator=g)
        states.append(state)
        metrics.append(m)
        if probes:
            again = eng.probe_metrics(state)
            assert sorted(again) == sorted(tprobes.PROBE_METRICS)
            for k in tprobes.PROBE_METRICS:
                assert float(again[k]) == float(m[k]), k
            assert float(m["gnb_refreshes"]) == (2 if unit == "round"
                                                 else 5)
    _bitwise(states[0], states[1])
    assert not set(tprobes.PROBE_METRICS) & set(metrics[0])
    assert float(metrics[0]["loss"]) == float(metrics[1]["loss"])


def test_probes_require_stateful_sophia():
    for kw in (dict(optimizer="fedavg"), dict(optimizer="done"),
               dict(persistent_client_state=False)):
        with pytest.raises(ValueError, match="probes"):
            FedEngine(MLPTask(hidden=HIDDEN), FedConfig(
                num_clients=C, obs=ObsConfig(probes=True), **kw),
                device="cpu")
    eng = FedEngine(MLPTask(hidden=HIDDEN),
                    FedConfig(num_clients=C, optimizer="fedavg"),
                    device="cpu")
    with pytest.raises(ValueError, match="probe_metrics"):
        eng.probe_metrics(eng.init(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("discipline", ["sync", "semisync"])
def test_scheduler_records_carry_probes(discipline):
    """Event records of a probed run carry the five scalars, equal to
    the JAX scheduler's within the band of the two runs' states (the
    m/h EMAs agree to ``rtol ~1e-5``, so a norm moves by as much and a
    clip decision can flip on a coordinate at the bound)."""
    key = jax.random.PRNGKey(0)
    x, y = jsyn.make_image_data(key, 256, "mnist", noise=1.0)
    part = jsyn.dirichlet_partition(jax.random.PRNGKey(1), y, C, alpha=0.5)
    tr, _ = jsyn.train_test_split(part)
    cache = {}

    def jbatch(v):
        if v not in cache:
            cache[v] = jsyn.client_batches(jax.random.fold_in(key, 100 + v),
                                           x, y, tr, B)
        return cache[v]

    def tbatch(v):
        b = jbatch(v)
        return {"x": torch.tensor(np.asarray(b["x"])),
                "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}
    sched_kw = dict(discipline=discipline, buffer_size=2,
                    latency_profile="straggler")
    comm_kw = dict(compressor="int8")
    cfg = dict(num_clients=C, local_iters=2, lr=0.02, tau=TAU,
               total_rounds=16)
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN), JFedConfig(
        use_pallas=True, comm=JCommConfig(use_pallas=True, **comm_kw),
        sched=JSchedConfig(**sched_kw), obs=JObsConfig(probes=True), **cfg))
    teng = FedEngine(MLPTask(hidden=HIDDEN), FedConfig(
        comm=CommConfig(**comm_kw), sched=SchedConfig(**sched_kw),
        obs=ObsConfig(probes=True), **cfg), device="cpu")
    jstate = jeng.init(jax.random.fold_in(key, 3))
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    rng = jax.random.PRNGKey(7)
    events = 3
    _, jtrace = jsched.VirtualScheduler(jeng, jbatch).run(jstate, events,
                                                          rng)
    draws = sched_draws(jeng, jstate["params"], rng)
    if discipline == "sync":
        # a sync round takes the engine's comm_noise and gumbel draws
        from test_torch_comm_round import jax_draws as round_draws

        def draws(version, ids, inner=draws):
            rng_v = jax.random.fold_in(rng, version)
            gumbel, noise = round_draws(jeng, jstate["params"], rng_v)
            return {**noise, "gumbel": gumbel[:, :2]}
    _, ttrace = tsched.VirtualScheduler(teng, tbatch).run(
        tstate, events, draws=draws)
    jrecs = [r for r in jtrace.to_records() if r["record"] == "sched_event"]
    trecs = [r for r in ttrace.to_records() if r["record"] == "sched_event"]
    assert len(trecs) == len(jrecs) == events
    for jr, tr_ in zip(jrecs, trecs):
        for k in tprobes.PROBE_METRICS:
            assert k in tr_ and np.isfinite(tr_[k])
            if k in ("h_staleness", "gnb_refreshes"):
                assert tr_[k] == jr[k]
            else:
                np.testing.assert_allclose(tr_[k], jr[k], rtol=1e-3,
                                           atol=1e-4, err_msg=k)
        assert {k: tr_[k] for k in tr_ if k not in tprobes.PROBE_METRICS
                and k != "loss"} == {k: jr[k] for k in jr if k not in
                                     tprobes.PROBE_METRICS and k != "loss"}
    back = tsched.SchedTrace.from_records(ttrace.to_records())
    assert [e.probes for e in back.events] == [e.probes
                                               for e in ttrace.events]
