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
inputs (tests/test_torch_quantize.py, tests/test_torch_comm.py); the
local training that feeds it agrees only to rtol ~1e-5 (GEMM order, and
XLA's FMA contraction inside the jitted round).  So ``floor(d/s + u)``
now and then lands on the other side of an integer: that coordinate's
reconstruction differs by one quant step ``s`` of its row, the new
server model by ``s/S``, an EF residual or replica by ``s``, and the
difference stays in the carried state.  Every compared coordinate
(params, m, h, EF residuals, replicas) must lie within ``rtol=1e-5,
atol=1e-6`` of the JAX engine's, except at most ``MAX_FLIPS`` per buffer
after each round; each of those may differ by no more than the largest
quant step of the streams that write the buffer (`STEPS_OF`) in that
round, plus the band.  Measured on these cases, coordinates outside
the band after rounds 1 and 2:

    uplink-int8-parallel      params 2, 2
    uplink-int8-ef-parallel   params 2, 7; comm_ef 3, 10
    bidir-int8-parallel       params 2, 2; m 0, 1; comm_dn_model 0, 2
    bidir-int8-ef-sequential  params 2, 1; m 0, 1; comm_ef 3, 6;
                              comm_dn_model 0, 2; comm_dn_ef 0, 4
    int4 and FedAvg cases     none

each within one step (params by s/S: 4.7e-6 at S=4, 9.5e-6 at S=2,
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
from repro_torch.core.fed import FedEngine
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
    """Records the largest row scale the port computes per stream (a
    stream whose config view equals another's records into both)."""
    steps = {}
    orig = tcomp.StochasticQuant.scales

    def scales(self, flat):
        s = orig(self, flat)
        for name in COMM_STREAMS:
            if self.cfg == steps["comm"].stream(name):
                steps[name] = max(steps.get(name, 0.0), float(s.max()))
        return s
    monkeypatch.setattr(tcomp.StochasticQuant, "scales", scales)
    return steps


def run_both(data, fed_kw, comm_kw, scale_probe, packed=False):
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
        jstate, jm = jround(jstate, batches[r], rngs[r])
        scale_probe.clear()
        scale_probe["comm"] = teng.fed.comm
        tstate, tm = teng.round(tstate, _torch_batch(batches[r]),
                                gumbel=torch.from_numpy(gumbel),
                                comm_noise=noise)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        assert tm["total_bytes"] == int(jm["total_bytes"])
        assert tm["participants"] == int(jm["participants"])
        counts.append(flips_within_band(jstate, tstate, scale_probe))
    return counts


@pytest.mark.parametrize("name", list(CASES))
def test_comm_round_parity(data, scale_probe, name):
    tq.reset_launches()
    run_both(data, *CASES[name], scale_probe)
    # CPU tensors run the plain versions: no kernel launch counted
    assert sum(tq.LAUNCHES.values()) == 0


def test_comm_round_parity_packed_resident(data, scale_probe):
    run_both(data, dict(optimizer="fed_sophia", strategy="parallel"),
             BIDIR, scale_probe, packed=True)


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
