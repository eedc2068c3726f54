"""The port's virtual-time scheduler against the JAX package's.

* The latency model and the trace records are host arithmetic: the
  multipliers, dispatch seconds, legs and leg bytes equal the JAX
  package's exactly (float64), and ``to_records`` equals the JAX
  package's record for record; ``from_records`` inverts it exactly.
* Inside the port: the ``sync`` discipline is a loop of
  `FedEngine.round`, bitwise; ``semisync`` with a full buffer under
  uniform latencies is ``sync``, bitwise, at C=4 (the apply's
  ``(1/wsum) * sum`` equals the round's ``sum / S`` where the reciprocal
  is exact; at other cohort sizes the two differ in the last ulp, the
  reference's two routes too).  Chunked dispatch (chunk 2 of C=6: full
  chunks and a tail) is bitwise unchunked.
* Against the JAX `VirtualScheduler` (``use_pallas`` and
  ``comm.use_pallas`` on, the kernels in interpret mode) with the JAX
  run's own draws injected (``fold_in(fold_in(rng, version), client)``
  per client, ``fold_in(rng_v, ATTACK_SALT)`` for the attack): every
  field of every event and dispatch record equal exactly but the losses
  (within rtol 1e-4: the states differ as below); the final state within
  the flip band of tests/test_torch_comm_round.py (``rtol=1e-5,
  atol=1e-6`` but for at most 16 coordinates per buffer, each within the
  streams' largest quant step).  MLP hidden 16, C=4, J=2, tau=2, B=8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import ObsConfig as JObsConfig
from repro.configs.base import RobustConfig as JRobustConfig
from repro.configs.base import SchedConfig as JSchedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.metrics.energy import ChannelModel as JChannelModel
from repro.models.small import MLPTask as JMLPTask
from repro.sched import latency as jlat
from repro.sched import scheduler as jsched
from repro_torch import convert
from repro_torch.comm import compressors as tcomp
from repro_torch.configs.base import (COMM_STREAMS, CommConfig, FedConfig,
                                      ObsConfig, RobustConfig, SchedConfig)
from repro_torch.core.fed import FedEngine
from repro_torch.kernels import robust_agg as trobust
from repro_torch.kernels import stale_accum as tstale
from repro_torch.metrics.energy import ChannelModel
from repro_torch.models.small import MLPTask
from repro_torch.robust.attacks import ATTACK_SALT
from repro_torch.sched import latency as tlat
from repro_torch.sched import scheduler as tsched

C, J, TAU, B, HIDDEN = 4, 2, 2, 8, 16
RTOL, ATOL = 1e-5, 1e-6
MAX_FLIPS = 16
STEPS_OF = {"params": ("uplink", "downlink"), "m": ("uplink", "downlink"),
            "h": ("uplink", "downlink", "hessian"),
            "comm_ef": ("uplink",), "comm_dn_model": ("downlink",),
            "comm_dn_ef": ("downlink",)}
SALT_UP, SALT_DN = 0xC0, 0xD0


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it: the JAX package's
    jitted Pallas kernels traced here would otherwise stay in jax's
    caches for other modules' tests, which trace the same shapes under
    other launch geometries."""
    yield
    jax.clear_caches()


# -------------------------------------------------------------- latency
LATENCY_CASES = [
    (dict(), dict()),
    (dict(latency_profile="straggler", straggler_frac=0.25,
          straggler_slowdown=10.0, seed=3), dict(compressor="int8")),
    (dict(latency_profile="lognormal", lognormal_sigma=0.9, seed=5),
     dict(compressor="int8", downlink_compressor="int4",
          hessian_compressor="int4", participation=0.5)),
    (dict(latency_profile="straggler", straggler_frac=0.1, seed=1,
          bandwidth_bps=3e6, compute_s=0.37),
     dict(compressor="topk", topk_ratio=0.05, downlink_compressor="signsgd")),
]


@pytest.mark.parametrize("case", range(len(LATENCY_CASES)))
def test_latency_matches_jax_exactly(case):
    sched_kw, comm_kw = LATENCY_CASES[case]
    for n_clients in (4, 7, 32):
        tfed = FedConfig(num_clients=n_clients, local_iters=3,
                         sched=SchedConfig(**sched_kw),
                         comm=CommConfig(**comm_kw))
        jfed = JFedConfig(num_clients=n_clients, local_iters=3,
                          sched=JSchedConfig(**sched_kw),
                          comm=JCommConfig(**comm_kw))
        for n in (13_002, 118_282):
            np.testing.assert_array_equal(
                tlat.client_multipliers(tfed.sched, n_clients),
                jlat.client_multipliers(jfed.sched, n_clients))
            np.testing.assert_array_equal(
                tlat.stragglers(tfed.sched, n_clients),
                jlat.stragglers(jfed.sched, n_clients))
            assert tlat.leg_bytes(tfed.comm, n) == jlat.leg_bytes(jfed.comm,
                                                                  n)
            np.testing.assert_array_equal(
                tlat.dispatch_seconds(tfed, n, n_clients),
                jlat.dispatch_seconds(jfed, n, n_clients))
            for a, b in zip(tlat.dispatch_legs(tfed, n, n_clients),
                            jlat.dispatch_legs(jfed, n, n_clients)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tlat.client_multipliers(SchedConfig(latency_profile="bogus"), 4)


def _trace(mod, with_probes=True):
    """One trace with every field set, built from ``mod``'s classes."""
    ev = [mod.SchedEvent(
        time=1.25 * (v + 1), version=v + 1, kind="aggregate",
        clients=(v % 3, 3), staleness=(0, v),
        weights=(1.0, 0.7071067811865476),
        loss=0.5 / (v + 1), cum_bytes=1000 * (v + 1) + 17,
        eval_loss=(0.4 if v == 1 else None),
        cum_uplink_bytes=400 * (v + 1), cum_downlink_bytes=600 * (v + 1),
        cum_hessian_uplink_bytes=10, cum_hessian_downlink_bytes=7,
        probes=({"clip_fraction": 0.125, "m_norm": 2.0, "h_norm": 0.5,
                 "h_staleness": 1.0, "gnb_refreshes": 3.0}
                if with_probes and v == 0 else None),
        trace_ids=(2 * v + 1, 2 * v + 2),
        aggregator=("coordinate_median" if v else "mean"),
        attack=("sign_flip" if v else "none"),
        byzantine=((3,) if v else ()), dropped=((3,) if v == 2 else ()))
        for v in range(3)]
    disp = [mod.SchedDispatch(
        trace_id=t, client=t % 4, version=t // 4, time=0.5 * t,
        arrival=0.5 * t + 1.75, compute_s=1.0, downlink_s=0.25,
        uplink_s=0.5, downlink_bytes=100, uplink_bytes=50,
        hessian_uplink_bytes=3, hessian_downlink_bytes=3)
        for t in range(1, 7)]
    return mod.SchedTrace(discipline="semisync", events=ev, dispatches=disp)


def test_records_match_jax_and_round_trip_exactly():
    ttrace, jtrace = _trace(tsched), _trace(jsched)
    for tch, jch in ((None, None), (ChannelModel(), JChannelModel())):
        trecs = ttrace.to_records(tch)
        assert trecs == jtrace.to_records(jch)
        back = tsched.SchedTrace.from_records(trecs)
        assert back.to_records(tch) == trecs
        assert back.events == ttrace.events
        assert back.dispatches == ttrace.dispatches
    assert ttrace.staleness_hist() == jtrace.staleness_hist()
    assert ttrace.time_to_target(0.3) == jtrace.time_to_target(0.3)
    assert ttrace.bytes_to_target(0.45) == jtrace.bytes_to_target(0.45)
    with pytest.raises(ValueError, match="sched_summary"):
        tsched.SchedTrace.from_records(trecs[:-1])


# --------------------------------------------------------- shared data
@pytest.fixture(scope="module")
def data():
    key = jax.random.PRNGKey(0)
    x, y = jsyn.make_image_data(key, 512, "mnist", noise=1.0)
    part = jsyn.dirichlet_partition(jax.random.PRNGKey(1), y, 6, alpha=0.5)
    tr, _ = jsyn.train_test_split(part)
    cache = {}

    def jbatch(n, v):
        if (n, v) not in cache:
            cache[(n, v)] = jsyn.client_batches(
                jax.random.fold_in(key, 100 + v), x, y, tr[:n], B)
        return cache[(n, v)]

    def tbatch(n, v):
        b = jbatch(n, v)
        return {"x": torch.tensor(np.asarray(b["x"])),
                "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}
    return key, jbatch, tbatch


def _cfg(n=C, **kw):
    base = dict(num_clients=n, local_iters=J, lr=0.02, tau=TAU,
                total_rounds=16)
    base.update(kw)
    return base


def _state_numpy(st):
    out = {}
    params = st["params"]
    if isinstance(params, dict):
        out.update({f"params[{k}]": np.asarray(v, np.float32)
                    for k, v in params.items()})
    else:
        out["params"] = np.asarray(params, np.float32)
    opt = st.get("client_opt")
    if opt is not None:
        m, h = (opt["m"], opt["h"]) if isinstance(opt, dict) else opt
        out["m"], out["h"] = np.asarray(m), np.asarray(h)
    for k in convert.COMM_KEYS:
        if st.get(k) is not None:
            out[k] = np.asarray(st[k])
    return out


def _bitwise(a, b):
    a = _state_numpy(convert.state_to_numpy(a))
    b = _state_numpy(convert.state_to_numpy(b))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------- inside the port
def _port_run(data, fed, events, seed=0, n=C, donate=False, **run_kw):
    _, _, tbatch = data
    eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
    state = eng.init(torch.Generator().manual_seed(3))
    sched = tsched.VirtualScheduler(eng, lambda v: tbatch(n, v),
                                    donate=donate)
    out = sched.run(state, events, torch.Generator().manual_seed(seed),
                    **run_kw)
    return eng, state, out


@pytest.mark.parametrize("comm_kw", [dict(compressor="int8"),
                                     dict(compressor="int8",
                                          participation=0.5),
                                     dict()],
                         ids=["int8", "int8-half", "direct"])
def test_sync_is_a_loop_of_engine_rounds(data, comm_kw):
    _, _, tbatch = data
    fed = FedConfig(comm=CommConfig(**comm_kw), **_cfg())
    eng, state0, (state, trace) = _port_run(data, fed, 3)
    g = torch.Generator().manual_seed(0)
    ref = eng.init(torch.Generator().manual_seed(3))
    losses = []
    for v in range(3):
        ref, m = eng.round(ref, tbatch(C, v), generator=g)
        losses.append(float(m["loss"]))
    _bitwise(state, ref)
    assert [e.loss for e in trace.events] == losses
    assert [e.version for e in trace.events] == [1, 2, 3]
    # donate=False: the state passed in is untouched
    _bitwise(state0, eng.init(torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("comm_kw", [
    dict(compressor="int8"),
    dict(compressor="int8", downlink_compressor="int8"),
    dict(compressor="topk", topk_ratio=0.05)],
    ids=["uplink-int8", "bidir-int8", "topk-ef"])
def test_semisync_full_buffer_uniform_is_sync(data, comm_kw):
    """C=4: the stale-accumulate kernel's (1/4)-scaled sum is the
    round's sum / 4 exactly."""
    fed = FedConfig(comm=CommConfig(**comm_kw), **_cfg())
    semi = dataclasses.replace(fed, sched=SchedConfig(discipline="semisync",
                                                      buffer_size=C))
    _, _, (s_sync, t_sync) = _port_run(data, fed, 3)
    tstale.reset_launches()
    _, _, (s_semi, t_semi) = _port_run(data, semi, 3)
    _bitwise(s_sync, s_semi)
    assert [e.time for e in t_sync.events] == [e.time for e in t_semi.events]
    assert [e.cum_bytes for e in t_sync.events] == \
        [e.cum_bytes for e in t_semi.events]
    assert all(e.staleness == (0,) * C for e in t_semi.events)
    assert tstale.LAUNCHES["stale_accum_flat"] == 0     # CPU: plain


@pytest.mark.parametrize("discipline", ["semisync", "async"])
def test_chunked_dispatch_is_unchunked(data, discipline):
    """Chunk 2 of C=6 (groups of 6 and 3: full chunks and a tail),
    bitwise, on a generator: the group's noise is drawn whole, in the
    unchunked order."""
    sched = dict(discipline=discipline, latency_profile="straggler",
                 buffer_size=3 if discipline == "semisync" else 0)
    fed = FedConfig(comm=CommConfig(compressor="int8",
                                    downlink_compressor="int8"),
                    sched=SchedConfig(**sched), **_cfg(n=6))
    chunked = dataclasses.replace(
        fed, sched=SchedConfig(dispatch_chunk=2, **sched))
    _, _, (s0, t0) = _port_run(data, fed, 3, n=6)
    _, _, (s1, t1) = _port_run(data, chunked, 3, n=6)
    _bitwise(s0, s1)
    assert t0.to_records() == t1.to_records()


def test_chunked_comm_round_is_unchunked(data):
    _, _, tbatch = data
    outs = []
    for chunk in (0, 4, 2):
        fed = FedConfig(comm=CommConfig(compressor="int8",
                                        error_feedback=True),
                        sched=SchedConfig(dispatch_chunk=chunk), **_cfg(n=6))
        eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
        g = torch.Generator().manual_seed(0)
        state = eng.init(torch.Generator().manual_seed(3))
        for v in range(2):
            state, _ = eng.round(state, tbatch(6, v), generator=g)
        outs.append(state)
    _bitwise(outs[0], outs[1])
    _bitwise(outs[0], outs[2])


def test_scheduler_validates_and_stops_at_target(data):
    _, _, tbatch = data
    for fed, err in (
            (FedConfig(sched=SchedConfig(discipline="weekly"), **_cfg()),
             "discipline"),
            (FedConfig(sched=SchedConfig(discipline="semisync",
                                         buffer_size=9), **_cfg()),
             "buffer_size"),
            (FedConfig(sched=SchedConfig(discipline="async"),
                       comm=CommConfig(compressor="int8",
                                       hessian_compressor="int4"),
                       **_cfg()), "hessian")):
        eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
        with pytest.raises(ValueError, match=err):
            tsched.VirtualScheduler(eng, lambda v: tbatch(C, v))
    fed = FedConfig(comm=CommConfig(compressor="int8"),
                    sched=SchedConfig(discipline="async"), **_cfg())
    eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
    batch = tbatch(C, 0)
    one = {k: v[0] for k, v in batch.items()}
    sched = tsched.VirtualScheduler(
        eng, lambda v: tbatch(C, v),
        eval_fn=lambda p: eng.task.loss(p, one), eval_every=2)
    state = eng.init(torch.Generator().manual_seed(3))
    _, trace = sched.run(state, 6, torch.Generator().manual_seed(0))
    assert [e.eval_loss is not None for e in trace.events] == \
        [False, True, False, True, False, True]
    _, trace = sched.run(state, 6, torch.Generator().manual_seed(0),
                         target_loss=1e9, stop_at_target=True)
    assert len(trace.events) == 1
    assert {s["name"] for s in sched.spans.records()} == {"dispatch",
                                                          "apply"}
    with pytest.raises(ValueError, match="generator or injected"):
        sched.run(state, 2)


def test_donated_run_updates_the_state_in_place(data):
    fed = FedConfig(comm=CommConfig(compressor="int8"),
                    sched=SchedConfig(discipline="semisync", buffer_size=2),
                    **_cfg())
    _, _, (kept, _) = _port_run(data, fed, 2)
    eng, state, (donated, _) = _port_run(data, fed, 2, donate=True)
    _bitwise(kept, donated)
    # the resident m stack passed in was written in place
    assert donated["client_opt"].m.data_ptr() == \
        state["client_opt"].m.data_ptr()


def test_packed_resident_async_is_tree_resident(data):
    """Async dispatches one client at a time: the one-client batched
    step must leave the server model alone (a stride-0 start stack of
    one client is a view of it), on packed-resident state too."""
    _, _, tbatch = data
    fed = FedConfig(comm=CommConfig(compressor="int8"),
                    sched=SchedConfig(discipline="async",
                                      latency_profile="lognormal"),
                    **_cfg())
    outs = []
    for packed in (False, True):
        eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
        state = eng.init(torch.Generator().manual_seed(3))
        if packed:
            state = eng.pack_state(state)
        sched = tsched.VirtualScheduler(eng, lambda v: tbatch(C, v))
        out, trace = sched.run(state, 4, torch.Generator().manual_seed(0))
        assert all(len(e.clients) == 1 for e in trace.events)
        outs.append(eng.unpack_state(out))
    _bitwise(outs[0], outs[1])


# ------------------------------------------------- against the JAX run
def jax_draws(jeng, params, rng, n_classes=10):
    """The JAX scheduler's draws, in the port's ``draws(version, ids)``
    format."""
    rt = jeng.comm_runtime(params)
    fed = jeng.fed

    def draws(version, ids):
        rng_v = jax.random.fold_in(rng, version)
        if ids is None:
            return {"participants":
                    np.asarray(jeng.round_participants(rng_v))}
        crngs = [jax.random.fold_in(rng_v, i) for i in ids]
        out = {"gumbel": np.stack([np.stack([np.asarray(jax.random.gumbel(
            jax.random.fold_in(k, j), (B, n_classes), jnp.float32))
            for j in range(fed.local_iters)]) for k in crngs])}
        for stream, comp, spec, salt in (
                ("uplink", rt.comp, rt.spec, SALT_UP),
                ("downlink", rt.comp_dn, rt.spec_dn, SALT_DN)):
            if comp is not None and hasattr(comp, "qmax"):
                out[stream] = np.stack([np.asarray(jax.random.uniform(
                    jax.random.fold_in(k, salt), (spec.rows, spec.cols)))
                    for k in crngs])
        if fed.robust.attack == "random_wire":
            out["attack"] = np.asarray(jax.random.normal(
                jax.random.fold_in(rng_v, ATTACK_SALT),
                (len(ids), rt.spec.rows, rt.spec.cols), jnp.float32))
        return out
    return draws


SCHED_CASES = {
    "semisync-buffer2-straggler": (
        dict(discipline="semisync", buffer_size=2,
             latency_profile="straggler", straggler_frac=0.25,
             straggler_slowdown=10.0),
        dict(compressor="int8"), dict(), dict(), 4),
    "async-lognormal": (
        dict(discipline="async", latency_profile="lognormal", seed=3),
        dict(compressor="int8"), dict(), dict(), 6),
    "semisync-bidir-churn-trace": (
        dict(discipline="semisync", buffer_size=3,
             latency_profile="lognormal", seed=1),
        dict(compressor="int8", downlink_compressor="int8",
             participation=0.75),
        dict(dropout_prob=0.4, rejoin_delay_s=30.0, seed=2),
        dict(trace=True), 4),
    "semisync-median-signflip": (
        dict(discipline="semisync", buffer_size=3,
             latency_profile="straggler"),
        dict(compressor="int8"),
        dict(aggregator="coordinate_median", attack="sign_flip",
             attack_fraction=0.5), dict(), 4),
    "async-randomwire-normclip": (
        dict(discipline="async", latency_profile="lognormal", seed=4),
        dict(compressor="int8"),
        dict(aggregator="norm_clip", clip_norm=0.02, attack="random_wire",
             attack_fraction=0.5), dict(), 5),
}


def _steps_probe(monkeypatch, comm):
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


@pytest.mark.parametrize("name", list(SCHED_CASES))
def test_scheduler_matches_jax(data, monkeypatch, name):
    sched_kw, comm_kw, robust_kw, obs_kw, events = SCHED_CASES[name]
    key, jbatch, tbatch = data
    cfg = _cfg(optimizer="fed_sophia")
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN), JFedConfig(
        use_pallas=True, comm=JCommConfig(use_pallas=True, **comm_kw),
        sched=JSchedConfig(**sched_kw), robust=JRobustConfig(**robust_kw),
        obs=JObsConfig(**obs_kw), **cfg))
    teng = FedEngine(MLPTask(hidden=HIDDEN), FedConfig(
        comm=CommConfig(**comm_kw), sched=SchedConfig(**sched_kw),
        robust=RobustConfig(**robust_kw), obs=ObsConfig(**obs_kw), **cfg),
        device="cpu")
    steps = _steps_probe(monkeypatch, teng.fed.comm)
    jstate = jeng.init(jax.random.fold_in(key, 3))
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    rng = jax.random.PRNGKey(7)
    jout, jtrace = jsched.VirtualScheduler(
        jeng, lambda v: jbatch(C, v)).run(jstate, events, rng)
    trobust.reset_launches()
    tout, ttrace = tsched.VirtualScheduler(
        teng, lambda v: tbatch(C, v)).run(
            tstate, events, draws=jax_draws(jeng, jstate["params"], rng))
    assert trobust.LAUNCHES["robust_agg_flat"] == 0
    jrecs, trecs = jtrace.to_records(), ttrace.to_records()
    assert len(jrecs) == len(trecs)
    for jr, tr in zip(jrecs, trecs):
        jl, tl = jr.pop("loss", None), tr.pop("loss", None)
        assert tr == jr
        if jl is not None:
            np.testing.assert_allclose(tl, jl, rtol=1e-4)
    if name.startswith("async"):
        assert max(max(e.staleness) for e in ttrace.events) > 0
    if obs_kw:
        assert ttrace.dispatches and any(e.dropped for e in ttrace.events)
    if robust_kw.get("attack"):
        assert any(e.byzantine for e in ttrace.events)
    # the final state within the flip band (the quant steps of the whole
    # run: a flip of an early event carries on)
    want = _state_numpy(jax.tree.map(np.asarray, jout))
    got = _state_numpy(convert.state_to_numpy(tout))
    assert sorted(got) == sorted(want)
    for buf, w in want.items():
        band = ATOL + RTOL * np.abs(w)
        diff = np.abs(got[buf] - w)
        out = diff > band
        step = sum(steps.get(s, 0.0) for s in STEPS_OF[buf.split("[")[0]])
        assert int(out.sum()) <= MAX_FLIPS, (buf, int(out.sum()))
        assert np.all(diff[out] <= step + band[out]), (buf, step)
