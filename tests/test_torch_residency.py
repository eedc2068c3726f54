"""The resident dtype policy of the PyTorch port (`CommConfig.state_dtype`,
``moment_dtype``, ``hessian_dtype``) against the JAX engine.

Both engines start from the same JAX-built state (carried over by
`repro_torch.convert`), see the same data and the JAX engine's own
random inputs and run 2 rounds: MLP hidden 16, C=4, J=3, tau=2, B=8,
``jax.jit(FedEngine.round)`` with the kernels in interpret mode against
the port on the CPU.  Cases: bf16 state, and bf16 state with e4m3
moments and an e5m2 hessian EMA, on the direct path, the int8 uplink and
the bidirectional int8/int8/int4 comm path, parallel and sequential,
dict- and packed-resident.

* Dtypes: every resident buffer after a round has exactly the JAX
  engine's dtype.
* Values: an fp32 buffer within slice 1's band (``rtol=1e-5,
  atol=1e-6``); a narrow one within that band or within its
  `kernels.ref.NARROW_STEPS` steps of its dtype (bf16 2, e4m3 1, e5m2
  1; ordinals apart, `kernels.ref.dtype_steps`), with at most
  `MAX_FLIPS` coordinates a buffer up to its outlier steps (bf16 4,
  fp8 2).  Two engines whose fp32 values differ in the last ulps round a
  value at a rounding midpoint to neighbouring steps.  Measured, after
  rounds 1 / 2, coordinates outside the fp32 band by steps apart (the
  comm flips below left out):

      bf16 direct par., int8 par.,    m {1: 7} / {1: 7-8, 2: 0-1, 4: 1};
      int8-ef sequential              h {1: 3} / {1: 3}
      bf16 direct sequential          m {1: 3} / {1: 3, 2: 1}; h {1: 2}
      bf16 bidir parallel             m {1: 3}; h {1: 2} / {1: 907}
      bf16 bidir-ef sequential        m {1: 4, 2: 1} / {1: 17, 2: 1};
                                      h - / {1: 2}; comm_dn_model - / {1: 1}
      fp8 direct (par., seq.),        none (m, h, params bitwise)
      fp8 int8 sequential
      fp8 int8 parallel               params {1: 1} / {1: 1}
      fp8 bidir parallel (resynced)   h {1: 8} / {1: 2}
      semisync bf16 / fedadam-bf16    m {1: 1}, h {1: 2, 2: 1} / params {1: 1}

  The one 4-step coordinate is an m whose EMA terms cancel: 0.9 m of
  about 1e-2 plus 0.1 g of about -1.15e-2 leaves -1.5e-3, where a half
  step of the larger term is 4 steps of the result.  On the comm paths
  the flip band of `tests/test_torch_comm_round.py` applies on top: at
  most `MAX_FLIPS` coordinates per buffer may also move by the streams'
  largest quant step (a floor that lands on the other side of an
  integer; measured at most 6 a buffer).  The fp8 bidir case starts each
  port round from the JAX state (`RESYNCED`): a one-step e5m2 difference
  of a client's h (a quarter of its value) can move its row's int4
  scale, and the server broadcast of that row then lands one int4 step
  apart on ~190 of its 1024 coordinates (measured; 406 coordinates of h
  2 to 31 steps apart after round 2 unresynced), a property of the
  configuration.

Inside the port, bitwise: the batched and the chunked comm client step
equal the looped per-client one in every dtype, as the JAX package's
`tests/test_residency.py` holds its own.

A semisync scheduler run with bf16 state and FedAdam against the JAX
`VirtualScheduler` with its draws injected: every record equal but the
losses (rtol 1e-4), the final state within the band above.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import SchedConfig as JSchedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.models.small import MLPTask as JMLPTask
from repro.sched import scheduler as jsched
from repro_torch import convert
from repro_torch.comm import downlink as cdown
from repro_torch.configs.base import CommConfig, FedConfig, SchedConfig
from repro_torch.core.fed import ClientNoise, FedEngine
from repro_torch.core.sophia import SophiaState
from repro_torch.kernels import ref as kref
from repro_torch.models.small import MLPTask
from repro_torch.sched import scheduler as tsched
from test_torch_comm_round import STEPS_OF as COMM_STEPS_OF
from test_torch_comm_round import jax_draws, scale_probe  # noqa: F401
from test_torch_sched import jax_draws as sched_draws

C, J, TAU, B, HIDDEN, ROUNDS = 4, 3, 2, 8, 16, 2
RTOL, ATOL = 1e-5, 1e-6
MAX_FLIPS = 16
STEPS_OF = {**COMM_STEPS_OF, "server_opt": ("uplink", "downlink")}
BF16 = dict(state_dtype="bfloat16")
FP8 = dict(state_dtype="bfloat16", moment_dtype="float8_e4m3fn",
           hessian_dtype="float8_e5m2")
BIDIR = dict(compressor="int8", downlink_compressor="int8",
             hessian_compressor="int4", participation=0.5)

CASES = {  # name: (strategy, CommConfig kwargs, packed)
    "bf16-direct-parallel-packed": ("parallel", BF16, True),
    "bf16-direct-sequential-dict": ("sequential", BF16, False),
    "fp8-direct-parallel-packed": ("parallel", FP8, True),
    "fp8-direct-sequential-packed": ("sequential", FP8, True),
    "bf16-int8-parallel-packed": ("parallel", dict(compressor="int8", **BF16),
                                  True),
    "bf16-int8-ef-sequential-packed": (
        "sequential", dict(compressor="int8", error_feedback=True, **BF16),
        True),
    "fp8-int8-parallel-packed": ("parallel", dict(compressor="int8", **FP8),
                                 True),
    "fp8-int8-sequential-dict": ("sequential",
                                 dict(compressor="int8", **FP8), False),
    "bf16-bidir-parallel-packed": ("parallel", dict(BIDIR, **BF16), True),
    "bf16-bidir-ef-sequential-dict": (
        "sequential", dict(BIDIR, error_feedback=True,
                           downlink_error_feedback=True, **BF16), False),
    "fp8-bidir-parallel-packed": ("parallel", dict(BIDIR, **FP8), True),
}
#: cases whose port rounds each start from the JAX state (docstring)
RESYNCED = {"fp8-bidir-parallel-packed"}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it (jitted JAX rounds and
    interpret-mode kernels stay out of other modules' caches)."""
    yield
    jax.clear_caches()


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
    return key, x, y, tr, batches, rngs


def _torch_batch(b):
    return {"x": torch.tensor(np.asarray(b["x"])),
            "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}


def buffers(state):
    """name -> numpy (in its stored dtype) of every resident buffer."""
    out = {}

    def add(name, tree):
        if isinstance(tree, dict):
            out.update({f"{name}[{k}]": np.asarray(v)
                        for k, v in tree.items()})
        else:
            out[name] = np.asarray(tree)
    add("params", state["params"])
    opt = state.get("client_opt")
    if opt is not None:
        m, h = (opt["m"], opt["h"]) if isinstance(opt, dict) else opt
        add("m", m)
        add("h", h)
    if state.get("server_opt") is not None:
        for k in ("m", "v"):
            add(f"server_opt.{k}", state["server_opt"][k])
    for k in convert.COMM_KEYS:
        if state.get(k) is not None:
            add(k, state[k])
    return out


def assert_within_band(jstate, tstate, quant_steps, flips=True):
    """The module docstring's band, buffer by buffer; dtypes exact.
    Returns the count of coordinates outside the steps per buffer."""
    want = convert.params_from_numpy(
        buffers(jax.tree.map(np.asarray, jstate)), device="cpu")
    got = convert.params_from_numpy(
        buffers(convert.state_to_numpy(tstate)), device="cpu")
    assert sorted(got) == sorted(want)
    counts = {}
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, name
        out = kref.outside_band(g, w, rtol=RTOL, atol=ATOL)
        far = kref.outside_band(g, w, rtol=RTOL, atol=ATOL, outliers=True)
        counts[name] = int(out.sum())
        assert counts[name] <= MAX_FLIPS, (name, counts[name])
        if far.any():
            # a comm flip: by at most the streams' quant step
            assert flips, (name, counts[name])
            base = name.split("[")[0].split(".")[0]
            move = sum(quant_steps.get(s, 0.0) for s in STEPS_OF[base])
            wf, gf = w.float(), g.float()
            diff = (gf - wf).abs()[far]
            assert bool((diff <= move + ATOL + RTOL * wf.abs()[far]).all()), (
                name, float(diff.max()), move)
    return counts


def run_pair(data, scale_probe, strategy, comm_kw, packed, resync=False):
    key, _, _, _, batches, rngs = data
    cfg = dict(num_clients=C, local_iters=J, lr=0.02, tau=TAU,
               total_rounds=8, optimizer="fed_sophia", strategy=strategy)
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN), JFedConfig(
        use_pallas=True, comm=JCommConfig(use_pallas=True, **comm_kw),
        **cfg))
    teng = FedEngine(MLPTask(hidden=HIDDEN),
                     FedConfig(comm=CommConfig(**comm_kw), **cfg),
                     device="cpu")
    jstate = jeng.init(jax.random.fold_in(key, 3))
    params0 = jstate["params"]
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    if packed:
        jstate, tstate = jeng.pack_state(jstate), teng.pack_state(tstate)
        assert_within_band(jstate, tstate, {}, flips=False)
    jround = jax.jit(jeng.round)
    for r in range(ROUNDS):
        gumbel, noise = jax_draws(jeng, params0, rngs[r])
        if resync:
            tstate = convert.state_from_numpy(
                jax.tree.map(np.asarray, jstate), device="cpu")
        jstate, jm = jround(jstate, batches[r], rngs[r])
        scale_probe.clear()
        scale_probe["comm"] = teng.fed.comm
        tstate, tm = teng.round(tstate, _torch_batch(batches[r]),
                                gumbel=torch.from_numpy(gumbel),
                                comm_noise=noise)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        assert_within_band(jstate, tstate, scale_probe,
                           flips=not teng.uses_direct_path())
    return jstate, tstate


@pytest.mark.parametrize("name", list(CASES))
def test_residency_round_parity(data, scale_probe, name):
    strategy, comm_kw, packed = CASES[name]
    _, tstate = run_pair(data, scale_probe, strategy, comm_kw, packed,
                         resync=name in RESYNCED)
    opt = tstate["client_opt"]
    assert opt.m.dtype == getattr(torch, comm_kw.get(
        "moment_dtype", comm_kw["state_dtype"]))
    assert opt.h.dtype == getattr(torch, comm_kw.get(
        "hessian_dtype", comm_kw["state_dtype"]))
    if packed:
        assert tstate["params"].dtype == torch.bfloat16
    else:
        assert all(v.dtype == torch.float32
                   for v in tstate["params"].values())


# ------------------------------------- batched == chunked == looped, bitwise
def _bits(x):
    if x is None:
        return None
    if isinstance(x, SophiaState):
        return (_bits(x.m), _bits(x.h))
    return x.contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    ).clone()


@pytest.mark.parametrize("dtypes", ["float32", "bf16", "fp8"])
def test_batched_and_chunked_client_step_match_looped(dtypes):
    """`comm_client_step_batched` (one launch a stage), its chunked form
    (chunks of 3 of 4 clients: a full chunk and a tail) and the looped
    per-client `comm_client_step` give the same bits in every output,
    with the gathered rows in their storage dtypes (bidir int8 / int8 /
    int4, EF on both links)."""
    comm_kw = dict(BIDIR, participation=1.0, error_feedback=True,
                   downlink_error_feedback=True,
                   **{"float32": {}, "bf16": BF16, "fp8": FP8}[dtypes])
    rs = np.random.default_rng(4)
    x = torch.tensor(rs.standard_normal((C, B, 28, 28, 1)),
                     dtype=torch.float32)
    y = torch.tensor(rs.integers(0, 10, (C, B)))
    outs = {}
    for chunk in (0, 3, -1):
        fed = FedConfig(num_clients=C, local_iters=J, tau=TAU, lr=0.02,
                        comm=CommConfig(**comm_kw),
                        sched=SchedConfig(dispatch_chunk=max(chunk, 0)))
        eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
        state = eng.pack_state(eng.init(torch.Generator().manual_seed(3)))
        # non-zero narrow state: one round in, the same for every run
        state, _ = eng.round(
            state, {"x": x, "y": y}, generator=torch.Generator().manual_seed(
                1))
        rt = eng.runtime_for(state["params"])
        theta = state["params"].to(torch.float32)
        g = torch.Generator().manual_seed(7)
        gumbel = torch.randn((C, J, B, 10), generator=g)
        uni = {s: torch.rand((C, sp.rows, sp.cols), generator=g)
               for s, sp in (("uplink", rt.spec), ("downlink", rt.spec_dn),
                             ("hessian", rt.spec_h))}
        rows = {k: state[k].clone() for k in convert.COMM_KEYS}
        opts = SophiaState(m=state["client_opt"].m.clone(),
                           h=state["client_opt"].h.clone())
        args = (rt, theta, theta, 1, torch.tensor(0.02))
        if chunk >= 0:
            out = eng.comm_client_step_batched(
                *args, opts, rows["comm_ef"], rows[cdown.MODEL_KEY],
                rows[cdown.EF_KEY], {"x": x, "y": y},
                ClientNoise(lambda j: gumbel[:, j], uni.get))
        else:
            per = []
            for i in range(C):
                per.append(eng.comm_client_step(
                    *args, SophiaState(m=opts.m[i], h=opts.h[i]),
                    rows["comm_ef"][i], rows[cdown.MODEL_KEY][i],
                    rows[cdown.EF_KEY][i], {"x": x[i], "y": y[i]},
                    ClientNoise(lambda j, i=i: gumbel[i, j],
                                lambda s, i=i: uni[s][i])))
            out = tuple(
                None if p[0] is None else
                SophiaState(m=torch.stack([q.m for q in p]),
                            h=torch.stack([q.h for q in p]))
                if isinstance(p[0], SophiaState) else torch.stack(list(p))
                for p in zip(*per))
        outs[chunk] = [_bits(o) for o in out] + [_bits(opts)]
        if dtypes == "fp8":
            assert opts.m.dtype == torch.float8_e4m3fn
            assert opts.h.dtype == torch.float8_e5m2
            assert rows["comm_ef"].dtype == torch.bfloat16

    def same(a, b):
        if a is None or b is None:
            assert a is None and b is None
        elif isinstance(a, tuple):
            for u, v in zip(a, b):
                same(u, v)
        else:
            assert torch.equal(a, b)
    for chunk in (3, -1):
        for a, b in zip(outs[0], outs[chunk]):
            same(a, b)


# ------------------------------------------------------ the scheduler
@pytest.mark.parametrize("case", ["bf16", "fedadam", "fedadam-bf16"])
def test_semisync_scheduler_matches_jax(data, scale_probe, case):
    """A semisync run (buffer 2, stragglers, int8 uplink) with bf16
    state, with FedAdam (the server step inside the apply), and with
    both: records equal the JAX scheduler's but the losses (rtol 1e-4),
    the final state within the band."""
    key, x, y, tr, _, _ = data
    comm_kw = dict(compressor="int8", **(BF16 if "bf16" in case else {}))
    sched_kw = dict(discipline="semisync", buffer_size=2,
                    latency_profile="straggler", straggler_frac=0.25,
                    straggler_slowdown=10.0)
    cfg = dict(num_clients=C, local_iters=2, lr=0.02, tau=TAU,
               total_rounds=16,
               optimizer="fedadam" if "fedadam" in case else "fed_sophia")
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN), JFedConfig(
        use_pallas=True, comm=JCommConfig(use_pallas=True, **comm_kw),
        sched=JSchedConfig(**sched_kw), **cfg))
    teng = FedEngine(MLPTask(hidden=HIDDEN), FedConfig(
        comm=CommConfig(**comm_kw), sched=SchedConfig(**sched_kw), **cfg),
        device="cpu")
    cache = {}

    def jbatch(v):
        if v not in cache:
            cache[v] = jsyn.client_batches(jax.random.fold_in(key, 100 + v),
                                           x, y, tr, B)
        return cache[v]
    jstate = jeng.init(jax.random.fold_in(key, 3))
    params0 = jstate["params"]
    tstate = teng.pack_state(convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu"))
    jstate = jeng.pack_state(jstate)
    rng = jax.random.PRNGKey(7)
    events = 4
    jout, jtrace = jsched.VirtualScheduler(jeng, jbatch).run(jstate, events,
                                                             rng)
    scale_probe["comm"] = teng.fed.comm
    tout, ttrace = tsched.VirtualScheduler(
        teng, lambda v: _torch_batch(jbatch(v))).run(
            tstate, events, draws=sched_draws(jeng, params0, rng))
    jrecs, trecs = jtrace.to_records(), ttrace.to_records()
    assert len(jrecs) == len(trecs)
    for jr, tr_ in zip(jrecs, trecs):
        jl, tl = jr.pop("loss", None), tr_.pop("loss", None)
        assert tr_ == jr
        if jl is not None:
            np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert_within_band(jout, tout, scale_probe)
    if "fedadam" in case:
        assert tout["server_opt"]["m"].dtype == tout["params"].dtype
