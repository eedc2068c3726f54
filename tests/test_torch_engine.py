"""Whole-round parity of the PyTorch port against the JAX engine.

Both engines start from the same JAX-built state, carried over by
`repro_torch.convert`, see the same data (as numpy) and the same GNB
label noise (the JAX engine's own gumbel draws, injected into the port),
and run 2 rounds: MLP hidden 16, C=4, J=3, tau=2, B=8.  The JAX side is
``jax.jit(FedEngine.round)`` with ``use_pallas=True`` (the Sophia
kernel in interpret mode, as the JAX tests run it); the port runs on the
CPU, where its kernel wrapper runs the plain version.

Band: ``rtol=1e-5, atol=1e-6`` on loss, params, m and h.  The port's
Sophia arithmetic is bitwise the reference's (tests/test_torch_sophia.py);
what differs is the summation order of the matmuls (torch's CPU GEMM vs
XLA's dot) and XLA's FMA contraction inside the jitted round, each a
few fp32 ulps per op, compounded over 2 rounds x 3 local steps.
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
from repro_torch.configs.base import (CommConfig, FedConfig, ObsConfig,
                                      RobustConfig, SchedConfig)
from repro_torch.core.fed import FedEngine
from repro_torch.kernels import sophia_update as tk
from repro_torch.models.small import MLPTask

C, J, TAU, B, HIDDEN, ROUNDS = 4, 3, 2, 8, 16, 2
RTOL, ATOL = 1e-5, 1e-6
#: jax.random.fold_in salt of the round-mode GNB draw (core/fed.py)
ROUND_SALT = 0x7FFFFFFF

CASES = {
    "sophia-parallel-step": dict(optimizer="fed_sophia",
                                 strategy="parallel"),
    "sophia-parallel-round": dict(optimizer="fed_sophia",
                                  strategy="parallel",
                                  hessian_every_unit="round"),
    "sophia-sequential-step": dict(optimizer="fed_sophia",
                                   strategy="sequential"),
    "sophia-sequential-round": dict(optimizer="fed_sophia",
                                    strategy="sequential",
                                    hessian_every_unit="round"),
    "sophia-stateless": dict(optimizer="fed_sophia", strategy="parallel",
                             persistent_client_state=False),
    "fedavg-parallel": dict(optimizer="fedavg", strategy="parallel"),
    "fedavg-sequential": dict(optimizer="fedavg", strategy="sequential"),
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


def _gumbel(rng, round_mode: bool) -> np.ndarray:
    """The JAX engine's GNB noise for one round, as (C, draws, B, K)."""
    salts = [ROUND_SALT] if round_mode else list(range(J))
    return np.stack([np.stack([
        np.asarray(jax.random.gumbel(
            jax.random.fold_in(jax.random.fold_in(rng, i), s), (B, 10),
            jnp.float32)) for s in salts]) for i in range(C)])


def _torch_batch(b):
    return {"x": torch.tensor(np.asarray(b["x"])),
            "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}


def _run_both(data, packed=False, **kw):
    key, batches, rngs = data
    cfg = dict(num_clients=C, local_iters=J, lr=0.02, tau=TAU,
               total_rounds=8, **kw)
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN),
                      JFedConfig(use_pallas=True, **cfg))
    teng = FedEngine(MLPTask(hidden=HIDDEN), FedConfig(**cfg), device="cpu")
    jstate = jeng.init(jax.random.fold_in(key, 3))
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    if packed:
        jstate, tstate = jeng.pack_state(jstate), teng.pack_state(tstate)
    jround = jax.jit(jeng.round)
    round_mode = cfg.get("hessian_every_unit") == "round"
    losses = []
    for r in range(ROUNDS):
        jstate, jm = jround(jstate, batches[r], rngs[r])
        tstate, tm = teng.round(
            tstate, _torch_batch(batches[r]),
            gumbel=torch.from_numpy(_gumbel(rngs[r], round_mode)))
        losses.append((float(jm["loss"]), float(tm["loss"])))
        assert tm["total_bytes"] == int(jm["total_bytes"])
        assert float(tm["lr"]) == float(jm["lr"])
    return jstate, tstate, losses


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol, err_msg=what)


def _compare(jstate, tstate, losses):
    for jl, tl in losses:
        _close(jl, tl, "loss")
    ts = convert.state_to_numpy(tstate)
    assert int(ts["round"]) == int(jstate["round"]) == ROUNDS
    jp = jstate["params"]
    if isinstance(jp, dict):
        assert sorted(ts["params"]) == sorted(jp)
        for k in jp:
            _close(jp[k], ts["params"][k], f"params[{k}]")
    else:
        _close(jp, ts["params"], "packed params")
    if "client_opt" in jstate:
        _close(jstate["client_opt"].m, ts["client_opt"]["m"], "m")
        _close(jstate["client_opt"].h, ts["client_opt"]["h"], "h")
    else:
        assert "client_opt" not in ts


@pytest.mark.parametrize("name", list(CASES))
def test_round_parity(data, name):
    tk.reset_launches()
    _compare(*_run_both(data, **CASES[name]))
    # CPU tensors run the plain version: no kernel launch counted
    assert sum(tk.LAUNCHES.values()) == 0


def test_round_parity_packed_resident(data):
    _compare(*_run_both(data, packed=True, optimizer="fed_sophia",
                        strategy="parallel"))


def test_convert_round_trip_exact(data):
    """A bidir state with EF on both links carries over exactly: params,
    the Sophia m/h stacks, the uplink EF residuals and the downlink
    replicas and residuals."""
    key, _, _ = data
    comm = JCommConfig(compressor="int8", error_feedback=True,
                       downlink_compressor="int8",
                       downlink_error_feedback=True,
                       hessian_compressor="int4", participation=0.5)
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN),
                      JFedConfig(num_clients=C, local_iters=J, comm=comm))
    jstate = jeng.init(jax.random.fold_in(key, 3))
    src = jax.tree.map(np.asarray, jstate)
    rs = np.random.default_rng(0)

    def noisy(a):
        return rs.standard_normal(a.shape).astype(np.float32)
    src = {**src, "client_opt": src["client_opt"]._replace(
        m=noisy(src["client_opt"].m)),
        "comm_ef": noisy(src["comm_ef"]),
        "comm_dn_model": noisy(src["comm_dn_model"]),
        "comm_dn_ef": noisy(src["comm_dn_ef"])}
    back = convert.state_to_numpy(convert.state_from_numpy(src, "cpu"))
    assert int(back["round"]) == int(src["round"])
    for k, v in src["params"].items():
        assert back["params"][k].dtype == v.dtype
        np.testing.assert_array_equal(back["params"][k], v)
    np.testing.assert_array_equal(back["client_opt"]["m"],
                                  src["client_opt"].m)
    np.testing.assert_array_equal(back["client_opt"]["h"],
                                  src["client_opt"].h)
    for k in ("comm_ef", "comm_dn_model", "comm_dn_ef"):
        assert back[k].dtype == np.float32 and back[k].shape[0] == C
        np.testing.assert_array_equal(back[k], src[k])
    packed = np.asarray(jeng.pack_state(jstate)["params"])
    again = convert.state_to_numpy(convert.state_from_numpy(
        {"params": packed, "round": 0}, "cpu"))
    np.testing.assert_array_equal(again["params"], packed)


OUTSIDE_SLICE = {
    "done": dict(optimizer="done"),
    "fedadam": dict(optimizer="fedadam"),
    "fedyogi": dict(optimizer="fedyogi"),
    "topk-uplink": dict(comm=CommConfig(compressor="topk")),
    "signsgd-uplink": dict(comm=CommConfig(compressor="signsgd")),
    "topk-downlink": dict(comm=CommConfig(downlink_compressor="topk")),
    "dispatch-chunk": dict(sched=SchedConfig(dispatch_chunk=4)),
    "robust-aggregator": dict(robust=RobustConfig(aggregator="trimmed_mean",
                                                  trim_fraction=0.25)),
    "attack": dict(robust=RobustConfig(attack="sign_flip",
                                       attack_fraction=0.25)),
    "probes": dict(obs=ObsConfig(probes=True)),
    "microbatches": dict(grad_microbatches=2),
    "bf16-state": dict(comm=CommConfig(state_dtype="bfloat16")),
    "fp8-moments": dict(comm=CommConfig(moment_dtype="float8_e4m3fn")),
}


@pytest.mark.parametrize("name", list(OUTSIDE_SLICE))
def test_settings_outside_the_slice_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FedEngine(MLPTask(hidden=HIDDEN),
                  FedConfig(num_clients=C, **OUTSIDE_SLICE[name]),
                  device="cpu")


def test_unknown_settings_raise_value_error():
    for kw in (dict(optimizer="adam"), dict(strategy="pipelined"),
               dict(hessian_every_unit="epoch"),
               dict(comm=CommConfig(state_dtype="float16"))):
        with pytest.raises(ValueError):
            FedEngine(MLPTask(hidden=HIDDEN), FedConfig(**kw), device="cpu")
