"""Comm-path round parity of the PyTorch port against the JAX engine.

Both engines start from the same JAX-built state (carried over by
`repro_torch.convert`), see the same data and the same random inputs —
the JAX engine's own participation sample, GNB gumbel noise and
stochastic-rounding noise of every stream, injected into the port — and
run 2 rounds each on its own state: MLP hidden 16, C=4, J=3, tau=2,
B=8.  The JAX side is ``jax.jit(FedEngine.round)`` with
``use_pallas=True`` and ``comm.use_pallas=True`` (the kernels in
interpret mode); the port runs on the CPU, where each kernel wrapper
runs its plain version.

Band.  The compression stage is bitwise the JAX eager path on identical
inputs (tests/test_torch_quantize.py, tests/test_torch_comm.py; SignSGD's
scale, a sum, within a few ulps); the local training that feeds it
agrees only to rtol ~1e-5 (GEMM order, and XLA's FMA contraction inside
the jitted round).  So now and then a coordinate lands on the other side
of a decision: ``floor(d/s + u)`` on the other side of an integer (its
reconstruction moves by one quant step ``s`` of its row), a magnitude on
the other side of top-k's threshold (kept in one engine, zeroed in the
other: it moves by about the threshold), a near-zero delta or aggregate
on the other side of 0 (SignSGD moves it by ``2·scale``, the majority
vote the server model by ``2·wstat``, at most twice the largest client
scale).  The difference stays in the carried state.  Every compared
coordinate (params, m, h, EF residuals, replicas) must lie within
``rtol=1e-5, atol=1e-6`` of the JAX engine's, except at most
``MAX_FLIPS`` per buffer after each round; each of those may differ by
no more than the largest such move of the streams that write the buffer
(`STEPS_OF`, recorded by `scale_probe`) in that round, plus the band.
Measured on these cases, coordinates outside the band after rounds 1
and 2:

    uplink-int8-parallel             params 2, 2
    uplink-int8-ef-parallel          params 2, 7; comm_ef 3, 10
    bidir-int8-parallel              params 2, 2; m 0, 1; comm_dn_model 0, 2
    bidir-int8-ef-sequential         params 2, 1; m 0, 1; comm_ef 3, 6;
                                     comm_dn_model 0, 2; comm_dn_ef 0, 4
    uplink-topk-parallel             comm_ef 1, 3
    uplink-signsgd-majority-parallel comm_ef 1, 1
    bidir-sign-topk-int4-sequential  comm_ef 1, 0 (each round from the
                                     JAX state: `RESYNCED`)
    int4 and FedAvg cases            none

each within its move (params by s/S: 4.7e-6 at S=4, 9.5e-6 at S=2,
against int8 steps near 1.9e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.models.small import MLPTask as JMLPTask
from repro_torch import convert
from repro_torch.comm import compressors as tcomp
from repro_torch.configs.base import COMM_STREAMS, CommConfig, FedConfig
from repro_torch.comm.downlink import wants_downlink_ef
from repro_torch.core.fed import FedEngine
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import quantize as tq
from repro_torch.models.small import MLPTask

C, J, TAU, B, HIDDEN, ROUNDS = 4, 3, 2, 8, 16, 2
RTOL, ATOL = 1e-5, 1e-6
MAX_FLIPS = 16
#: buffer -> the streams whose quant steps it may carry
STEPS_OF = {"params": ("uplink", "downlink"), "m": ("uplink", "downlink"),
            "h": ("uplink", "downlink", "hessian"),
            "comm_ef": ("uplink",), "comm_dn_model": ("downlink",),
            "comm_dn_ef": ("downlink",)}
#: jax.random.fold_in salts of the comm path's draws (repro/core/fed.py)
SALT_UP, SALT_DN, SALT_H, SALT_SERVER_H = 0xC0, 0xD0, 0x4E, 0x4D
BIDIR = dict(compressor="int8", downlink_compressor="int8",
             hessian_compressor="int4", participation=0.5)
BIASED_BIDIR = dict(compressor="signsgd", downlink_compressor="topk",
                    hessian_compressor="int4", topk_ratio=0.05,
                    participation=0.5)

CASES = {
    "uplink-int8-parallel": (dict(optimizer="fed_sophia",
                                  strategy="parallel"),
                             dict(compressor="int8")),
    "uplink-int4-sequential": (dict(optimizer="fed_sophia",
                                    strategy="sequential"),
                               dict(compressor="int4")),
    "uplink-int8-ef-parallel": (dict(optimizer="fed_sophia",
                                     strategy="parallel"),
                                dict(compressor="int8",
                                     error_feedback=True)),
    "bidir-int8-parallel": (dict(optimizer="fed_sophia",
                                 strategy="parallel"), BIDIR),
    "bidir-int8-ef-sequential": (
        dict(optimizer="fed_sophia", strategy="sequential"),
        dict(BIDIR, error_feedback=True, downlink_error_feedback=True,
             hessian_quant_block=512)),
    "fedavg-int8-sequential": (dict(optimizer="fedavg",
                                    strategy="sequential"),
                               dict(compressor="int8", participation=0.5)),
    "uplink-topk-parallel": (dict(optimizer="fed_sophia",
                                  strategy="parallel"),
                             dict(compressor="topk", topk_ratio=0.05)),
    "uplink-signsgd-majority-parallel": (
        dict(optimizer="fed_sophia", strategy="parallel"),
        dict(compressor="signsgd", sign_majority=True)),
    "bidir-sign-topk-int4-sequential": (
        dict(optimizer="fed_sophia", strategy="sequential"), BIASED_BIDIR),
}

#: cases whose port rounds each start from the JAX state: SignSGD's mean
#: of S=2 clients has a few distinct magnitudes, so the next downlink
#: delta is a sea of near-ties at top-k's threshold, split by the last
#: ulp of theta; a 1e-6 nudge of the weights moves thousands of
#: coordinates across it in the next round (measured on the CPU), a
#: property of the configuration, not of the port
RESYNCED = {"bidir-sign-topk-int4-sequential"}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it: its rounds trace the
    JAX package's jitted Pallas kernels at shapes that other modules'
    tests trace too, under other launch geometries, and jax's caches
    would hand those tests the programs traced here."""
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
    return key, batches, rngs


def _uniform(key, salt, shape):
    return np.array(jax.random.uniform(jax.random.fold_in(key, salt),
                                       shape))


def jax_draws(jeng, params, rng):
    """The JAX round's random inputs, in the port's injection format:
    ``(gumbel (C, J, B, K), comm_noise)``, every per-client array
    indexed by client id."""
    crngs = [jax.random.fold_in(rng, i) for i in range(C)]
    gumbel = np.stack([np.stack([
        np.asarray(jax.random.gumbel(jax.random.fold_in(k, j), (B, 10),
                                     jnp.float32)) for j in range(J)])
        for k in crngs])
    rt = jeng.comm_runtime(params)
    comm = jeng.fed.comm
    noise = {"participants": np.array(jeng.round_participants(rng))}
    if not comm.lossless:
        shape = (rt.spec.rows, rt.spec.cols)
        noise["uplink"] = np.stack([_uniform(k, SALT_UP, shape)
                                    for k in crngs])
    if rt.dn_on:
        shape = (rt.spec_dn.rows, rt.spec_dn.cols)
        noise["downlink"] = np.stack([_uniform(k, SALT_DN, shape)
                                      for k in crngs])
    if rt.h_on:
        shape = (rt.spec_h.rows, rt.spec_h.cols)
        noise["hessian"] = np.stack([_uniform(k, SALT_H, shape)
                                     for k in crngs])
        noise["server_hessian"] = _uniform(rng, SALT_SERVER_H, shape)
    return gumbel, noise


def _torch_batch(b):
    return {"x": torch.tensor(np.asarray(b["x"])),
            "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}


def _buffers(state):
    """name -> fp32 numpy of every compared buffer of a state."""
    out = {}
    params = state["params"]
    if isinstance(params, dict):
        out.update({f"params[{k}]": np.asarray(v, np.float32)
                    for k, v in params.items()})
    else:
        out["params"] = np.asarray(params, np.float32)
    opt = state.get("client_opt")
    if opt is not None:
        m, h = (opt["m"], opt["h"]) if isinstance(opt, dict) else opt
        out["m"], out["h"] = np.asarray(m), np.asarray(h)
    for k in convert.COMM_KEYS:
        if state.get(k) is not None:
            out[k] = np.asarray(state[k])
    return out


def flips_within_band(jstate, tstate, steps):
    """Asserts the flip band of the module docstring (``steps``: the
    largest row scale of each stream in the round); returns the count of
    coordinates outside ``rtol/atol`` per buffer."""
    want = _buffers(jstate)
    got = _buffers(convert.state_to_numpy(tstate))
    assert sorted(got) == sorted(want)
    counts = {}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        band = ATOL + RTOL * np.abs(w)
        diff = np.abs(g - w)
        out = diff > band
        counts[name] = int(out.sum())
        step = sum(steps.get(st, 0.0) for st in STEPS_OF[name.split("[")[0]])
        assert counts[name] <= MAX_FLIPS, (name, counts[name])
        assert np.all(diff[out] <= step + band[out]), (
            name, float(diff[out].max()), step)
    return counts


@pytest.fixture
def scale_probe(monkeypatch):
    """Records, per stream, the most a flipped coordinate may move its
    reconstruction: the largest row scale of a quantizer, the largest
    threshold of top-k, twice the largest scale of SignSGD (a stream
    whose config view equals another's records into both)."""
    steps = {}

    def probe(cls, name, factor):
        orig = getattr(cls, name)

        def wrapped(self, flat):
            s = orig(self, flat)
            for stream in COMM_STREAMS:
                if self.cfg == steps["comm"].stream(stream):
                    steps[stream] = max(steps.get(stream, 0.0),
                                        factor * float(s.max()))
            return s
        monkeypatch.setattr(cls, name, wrapped)
    probe(tcomp.StochasticQuant, "scales", 1.0)
    probe(tcomp.TopK, "thresholds", 1.0)
    probe(tcomp.SignSGD, "scales", 2.0)
    return steps


def run_both(data, fed_kw, comm_kw, scale_probe, packed=False, drop=(),
             generator=None, resync=False):
    """2 rounds of each engine; the port gets the JAX draws less the
    ``comm_noise`` keys in ``drop``, or, given ``generator``, only the
    gumbel noise injected and the generator for everything else.  With
    ``resync`` each port round starts from the JAX engine's state."""
    key, batches, rngs = data
    cfg = dict(num_clients=C, local_iters=J, lr=0.02, tau=TAU,
               total_rounds=8, **fed_kw)
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN), JFedConfig(
        use_pallas=True, comm=JCommConfig(use_pallas=True, **comm_kw),
        **cfg))
    teng = FedEngine(MLPTask(hidden=HIDDEN),
                     FedConfig(comm=CommConfig(**comm_kw), **cfg),
                     device="cpu")
    jstate = jeng.init(jax.random.fold_in(key, 3))
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    params0 = jstate["params"]
    if packed:
        jstate, tstate = jeng.pack_state(jstate), teng.pack_state(tstate)
    jround = jax.jit(jeng.round)
    counts = []
    for r in range(ROUNDS):
        gumbel, noise = jax_draws(jeng, params0, rngs[r])
        noise = {k: v for k, v in noise.items() if k not in drop}
        if resync:
            tstate = convert.state_from_numpy(
                jax.tree.map(np.asarray, jstate), device="cpu")
        jstate, jm = jround(jstate, batches[r], rngs[r])
        scale_probe.clear()
        scale_probe["comm"] = teng.fed.comm
        tstate, tm = teng.round(
            tstate, _torch_batch(batches[r]), generator=generator,
            gumbel=torch.from_numpy(gumbel),
            comm_noise=None if generator is not None else noise)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        assert tm["total_bytes"] == int(jm["total_bytes"])
        assert tm["participants"] == int(jm["participants"])
        counts.append(flips_within_band(jstate, tstate, scale_probe))
    return counts


@pytest.mark.parametrize("name", list(CASES))
def test_comm_round_parity(data, scale_probe, name):
    tq.reset_launches()
    run_both(data, *CASES[name], scale_probe, resync=name in RESYNCED)
    # CPU tensors run the plain versions: no kernel launch counted
    assert sum(tq.LAUNCHES.values()) == 0


def test_comm_round_parity_packed_resident(data, scale_probe):
    run_both(data, dict(optimizer="fed_sophia", strategy="parallel"),
             BIDIR, scale_probe, packed=True)


def test_identity_hessian_stream_needs_no_noise(data, scale_probe):
    """Only a quantized stream reads noise: an ``identity`` hessian
    stream runs without ``comm_noise["hessian"]`` or
    ``["server_hessian"]``, and a top-k downlink without
    ``["downlink"]``, and the round still matches the JAX round."""
    run_both(data, dict(optimizer="fed_sophia", strategy="parallel"),
             dict(compressor="int8", downlink_compressor="topk",
                  hessian_compressor="identity", participation=0.5),
             scale_probe, drop=("hessian", "server_hessian", "downlink"))


def test_noise_free_streams_draw_nothing(data, scale_probe):
    """With no quantized stream and every client taking part, a round
    on a generator draws nothing from it (the gumbel noise is injected),
    and matches the JAX round."""
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    run_both(data, dict(optimizer="fed_sophia", strategy="sequential"),
             dict(compressor="topk", downlink_compressor="signsgd",
                  hessian_compressor="identity", topk_ratio=0.05),
             scale_probe, generator=g)
    assert torch.equal(g.get_state(), before)


def test_participants_match_the_jax_sample():
    """`round_participants` peeks without advancing the generator, and
    the round trains exactly that cohort."""
    fed = FedConfig(num_clients=8, local_iters=1,
                    comm=CommConfig(compressor="int8", participation=0.5))
    eng = FedEngine(MLPTask(hidden=HIDDEN), fed, device="cpu")
    g = torch.Generator().manual_seed(5)
    ids = eng.round_participants(g)
    assert ids.shape == (4,) and bool(torch.all(ids[1:] > ids[:-1]))
    assert torch.equal(ids, eng.round_participants(g))
    assert torch.equal(ids, tcomp.participation_sample(g, 8, 4))


#: (stream, compressor, sign_majority, EF policy of the stream's link)
BIASED_MATRIX = [(stream, comp, vote, ef)
                 for stream in COMM_STREAMS
                 for comp, vote in (("topk", False), ("signsgd", False),
                                    ("signsgd", True))
                 for ef in (("auto", True, False) if stream != "hessian"
                            else ("auto",))]


@pytest.mark.parametrize("strategy", ["parallel", "sequential"])
@pytest.mark.parametrize(
    "stream,comp,vote,ef", BIASED_MATRIX,
    ids=[f"{s}-{c}{'-vote' if v else ''}-ef_{e}"
         for s, c, v, e in BIASED_MATRIX])
def test_biased_compressors_run_on_every_stream(stream, comp, vote, ef,
                                                strategy):
    """TopK and SignSGD (with and without the majority vote) on each
    stream, both strategies, EF auto/on/off: two rounds on a generator
    at participation 0.5 keep every buffer finite, materialise EF
    residuals exactly as the policy says ("auto": on for both), and
    carry nonzero residuals."""
    kw = {"uplink": dict(compressor=comp, error_feedback=ef),
          "downlink": dict(downlink_compressor=comp,
                           downlink_error_feedback=ef),
          "hessian": dict(hessian_compressor=comp)}[stream]
    comm = CommConfig(topk_ratio=0.05, sign_majority=vote, participation=0.5,
                      **kw)
    eng = FedEngine(MLPTask(hidden=HIDDEN),
                    FedConfig(num_clients=C, local_iters=2, tau=TAU,
                              lr=0.02, strategy=strategy, comm=comm),
                    device="cpu")
    g = torch.Generator().manual_seed(1)
    state = eng.init(g)
    rs = np.random.default_rng(0)
    x = torch.tensor(rs.standard_normal((64, 28, 28, 1)), dtype=torch.float32)
    y = torch.tensor(rs.integers(0, 10, 64))
    part = tsyn.dirichlet_partition(0, y, C, alpha=0.5)
    for r in range(2):
        batches = tsyn.client_batches(g, x, y, part, B)
        state, metrics = eng.round(state, batches, generator=g)
        assert np.isfinite(float(metrics["loss"]))
    bufs = _buffers(convert.state_to_numpy(state))
    assert all(np.all(np.isfinite(v)) for v in bufs.values())
    want_ef = {"comm_ef": tcomp.wants_error_feedback(comm),
               "comm_dn_ef": wants_downlink_ef(comm)}
    assert want_ef[{"uplink": "comm_ef", "downlink": "comm_dn_ef",
                    "hessian": "comm_ef"}[stream]] == (
        stream != "hessian" and ef in ("auto", True))
    for key, on in want_ef.items():
        assert (key in bufs) == on, key
        if on:
            assert np.any(bufs[key] != 0), key
