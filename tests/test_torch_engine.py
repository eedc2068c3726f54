"""Whole-round parity of the PyTorch port against the JAX engine.

Both engines start from the same JAX-built state, carried over by
`repro_torch.convert`, see the same data (as numpy) and the same GNB
label noise (the JAX engine's own gumbel draws, injected into the port),
and run 2 rounds: MLP hidden 16, C=4, J=3, tau=2, B=8.  The JAX side is
``jax.jit(FedEngine.round)`` with ``use_pallas=True`` (the Sophia
kernel in interpret mode, as the JAX tests run it); the port runs on the
CPU, where its kernel wrapper runs the plain version.

Micro-batched gradients (``grad_microbatches`` n = 2, 4): the JAX
engine draws micro-batch i's GNB noise from ``fold_in(rng_j, i)`` at
``(B / n, K)``; the port takes the ``(C, draws, B, K)`` noise laid out
micro-batch by micro-batch along B (`_gumbel`).

Band: ``rtol=1e-5, atol=1e-6`` on loss, params, m and h.  A params leaf
may hold one coordinate outside it (`_clip_flips`), where some client's
clip window ``rho * h`` (the JAX state's) is narrower than the band's
atol, by at most one flipped clipped step of one client,
``2 * lr * rho / C`` a round.  There a client's m that crosses zero
falls inside the window for one step, the engines' m differ by the
~1e-9 of their summation orders, and one engine takes a partial step
where the other takes a clipped one.  Measured: one such coordinate,
in ``sophia-microbatch2-sequential-round`` (w1 (321, 13): client 3's m
crosses zero in its third step while its h is 7.3e-7, so
``rho * h = 2.9e-8``; the first round's server mean moves by 3.2e-6);
no other case has one.  The port's
Sophia arithmetic is bitwise the reference's (tests/test_torch_sophia.py);
what differs is the summation order of the matmuls (torch's CPU GEMM vs
XLA's dot) and XLA's FMA contraction inside the jitted round, each a
few fp32 ulps per op, compounded over 2 rounds x 3 local steps.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.models.small import MLPTask as JMLPTask
from repro_torch import convert
from repro_torch.comm import flat as tflat
from repro_torch.configs.base import (CommConfig, FedConfig, RobustConfig,
                                      SchedConfig)
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
    # micro-batched gradients (and GNB estimates)
    "sophia-microbatch2-parallel-step": dict(
        optimizer="fed_sophia", strategy="parallel", grad_microbatches=2),
    "sophia-microbatch4-sequential-step": dict(
        optimizer="fed_sophia", strategy="sequential", grad_microbatches=4),
    "sophia-microbatch2-sequential-round": dict(
        optimizer="fed_sophia", strategy="sequential", grad_microbatches=2,
        hessian_every_unit="round"),
    "sophia-microbatch4-parallel-round": dict(
        optimizer="fed_sophia", strategy="parallel", grad_microbatches=4,
        hessian_every_unit="round"),
    "fedavg-microbatch2-parallel": dict(optimizer="fedavg",
                                        strategy="parallel",
                                        grad_microbatches=2),
    "fedavg-microbatch4-sequential": dict(optimizer="fedavg",
                                          strategy="sequential",
                                          grad_microbatches=4),
}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it: the jitted rounds here
    trace the JAX package's Pallas kernels, and jax's caches would hand
    other modules' tests the programs traced here."""
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


def _gumbel(rng, round_mode: bool, microbatches: int = 1) -> np.ndarray:
    """The JAX engine's GNB noise for one round, as (C, draws, B, K);
    with n > 1 micro-batches, draw s of client i is the concatenation
    along B of micro-batch k's ``(B / n, K)`` draw from
    ``fold_in(rng_s, k)``."""
    salts = [ROUND_SALT] if round_mode else list(range(J))

    def draw(key):
        if microbatches <= 1:
            return np.asarray(jax.random.gumbel(key, (B, 10), jnp.float32))
        return np.concatenate([np.asarray(jax.random.gumbel(
            jax.random.fold_in(key, k), (B // microbatches, 10),
            jnp.float32)) for k in range(microbatches)])
    return np.stack([np.stack([
        draw(jax.random.fold_in(jax.random.fold_in(rng, i), s))
        for s in salts]) for i in range(C)])


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
            gumbel=torch.from_numpy(_gumbel(
                rngs[r], round_mode, cfg.get("grad_microbatches", 1))))
        losses.append((float(jm["loss"]), float(tm["loss"])))
        assert tm["total_bytes"] == int(jm["total_bytes"])
        assert float(tm["lr"]) == float(jm["lr"])
    return jstate, tstate, losses


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol, err_msg=what)


def _clip_windows(jstate):
    """params leaf -> where some client's clip window ``rho * h`` in the
    JAX state is narrower than the band's atol (none without Sophia
    client state)."""
    opt = jstate.get("client_opt")
    if opt is None:
        return {}
    jp = {k: torch.from_numpy(np.array(v)) for k, v in jstate["params"].items()}
    h = opt.h
    h = ({k: np.asarray(v) for k, v in h.items()} if isinstance(h, dict)
         else {k: v.numpy() for k, v in tflat.unpack(
             torch.from_numpy(np.array(h)), tflat.flat_spec(jp)).items()})
    return {k: (FedConfig().rho * v < ATOL).any(0) for k, v in h.items()}


def _clip_flips(want, got, window, lr):
    """``got`` with its one permitted coordinate outside the band (see
    the module docstring) set to ``want``'s; asserts the rule."""
    out = ~(np.abs(got - want) <= ATOL + RTOL * np.abs(want))
    if not out.any():
        return got
    at = tuple(np.argwhere(out)[0])
    diff = abs(float(got[at]) - float(want[at]))
    assert out.sum() == 1 and window is not None and window[at], (
        int(out.sum()), at)
    assert diff <= ROUNDS * 2 * lr * FedConfig().rho / C, (at, diff)
    got = got.copy()
    got[at] = want[at]
    return got


def _compare(jstate, tstate, losses, lr=0.02):
    for jl, tl in losses:
        _close(jl, tl, "loss")
    ts = convert.state_to_numpy(tstate)
    assert int(ts["round"]) == int(jstate["round"]) == ROUNDS
    jp = jstate["params"]
    if isinstance(jp, dict):
        assert sorted(ts["params"]) == sorted(jp)
        windows = _clip_windows(jstate)
        for k in jp:
            want = np.array(jp[k])
            got = _clip_flips(want, ts["params"][k], windows.get(k), lr)
            _close(want, got, f"params[{k}]")
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


def _narrow_state(jeng, key):
    """A JAX FedAdam state packed in bf16 with noisy m/v, e4m3 m and
    e5m2 h stacks and bf16 EF residuals, replicas and residuals."""
    rs = np.random.default_rng(1)

    def noisy(a, dt):
        return (rs.standard_normal(np.shape(a)) * 3).astype(dt)
    src = jax.tree.map(np.asarray, jeng.pack_state(
        jeng.init(jax.random.fold_in(key, 3))))
    bf16 = ml_dtypes.bfloat16
    return {**src, "params": noisy(src["params"], bf16),
            "server_opt": {k: noisy(v, bf16)
                           for k, v in src["server_opt"].items()},
            "client_opt": {"m": noisy(np.zeros((C, 3, 64)),
                                      ml_dtypes.float8_e4m3fn),
                           "h": noisy(np.zeros((C, 3, 64)),
                                      ml_dtypes.float8_e5m2)},
            "comm_ef": noisy(src["comm_ef"], bf16),
            "comm_dn_model": noisy(src["comm_dn_model"], bf16),
            "comm_dn_ef": noisy(src["comm_dn_ef"], bf16)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint16)


def test_convert_round_trip_server_opt_exact(data):
    """FedAdam's ``server_opt`` m/v carry over exactly both ways, in the
    params' form (dicts) and packed, and the port's m/v after a round
    come back as the JAX layout."""
    key, _, _ = data
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN),
                      JFedConfig(num_clients=C, optimizer="fedadam"))
    jstate = jeng.init(jax.random.fold_in(key, 3))
    rs = np.random.default_rng(2)
    src = jax.tree.map(np.asarray, jstate)
    src["server_opt"] = jax.tree.map(
        lambda a: rs.standard_normal(a.shape).astype(np.float32),
        src["server_opt"])
    for state in (src, jax.tree.map(np.asarray, jeng.pack_state(
            {**jstate, "server_opt": src["server_opt"]}))):
        back = convert.state_to_numpy(convert.state_from_numpy(state, "cpu"))
        assert sorted(back) == sorted(state)
        for k in ("m", "v"):
            want, got = state["server_opt"][k], back["server_opt"][k]
            if isinstance(want, dict):
                assert sorted(got) == sorted(want)
                for leaf in want:
                    assert got[leaf].dtype == want[leaf].dtype
                    np.testing.assert_array_equal(got[leaf], want[leaf])
            else:
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_convert_round_trip_narrow_dtypes_bitwise(data):
    """bf16, e4m3 and e5m2 state (ml_dtypes arrays, as the JAX package
    holds it) carries over bit for bit both ways, NaN and +-inf
    included, and lands in the matching torch dtypes."""
    key, _, _ = data
    jeng = JFedEngine(JMLPTask(hidden=HIDDEN), JFedConfig(
        num_clients=C, optimizer="fedadam", comm=JCommConfig(
            compressor="int8", error_feedback=True,
            downlink_compressor="int8", downlink_error_feedback=True,
            state_dtype="bfloat16")))
    src = _narrow_state(jeng, key)
    for a in (src["params"], src["client_opt"]["h"]):
        flat = a.reshape(-1)
        flat[:3] = np.array([np.nan, np.inf, -np.inf]).astype(a.dtype)
    t = convert.state_from_numpy(src, "cpu")
    assert t["params"].dtype == torch.bfloat16
    assert t["server_opt"]["m"].dtype == torch.bfloat16
    assert t["client_opt"].m.dtype == torch.float8_e4m3fn
    assert t["client_opt"].h.dtype == torch.float8_e5m2
    assert t["comm_dn_ef"].dtype == torch.bfloat16
    # the torch values are the ml_dtypes values
    np.testing.assert_array_equal(t["client_opt"].m.float().numpy(),
                                  src["client_opt"]["m"].astype(np.float32))
    back = convert.state_to_numpy(t)
    pairs = [(back["params"], src["params"]),
             (back["client_opt"]["m"], src["client_opt"]["m"]),
             (back["client_opt"]["h"], src["client_opt"]["h"])]
    pairs += [(back["server_opt"][k], src["server_opt"][k])
              for k in ("m", "v")]
    pairs += [(back[k], src[k]) for k in convert.COMM_KEYS]
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_convert_imports_without_ml_dtypes():
    """`repro_torch.convert` imports, and carries fp32 state, in a
    process where neither ``ml_dtypes`` nor ``jax`` nor ``repro`` can
    be imported; it refuses a narrow tensor's way back to numpy there
    (numpy has no such dtype) with a TypeError."""
    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "for m in ('ml_dtypes', 'jax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np, torch\n"
            "from repro_torch import convert\n"
            "s = convert.state_from_numpy({'params': np.ones((2, 4), "
            "np.float32), 'round': 1}, 'cpu')\n"
            "assert convert.state_to_numpy(s)['params'].sum() == 8\n"
            "try:\n"
            "    convert.state_to_numpy({**s, 'params': "
            "s['params'].to(torch.bfloat16)})\n"
            "except TypeError:\n"
            "    print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_unknown_settings_raise_value_error():
    for kw in (dict(optimizer="adam"), dict(strategy="pipelined"),
               dict(hessian_every_unit="epoch"),
               dict(comm=CommConfig(state_dtype="float16")),
               dict(robust=RobustConfig(aggregator="krum")),
               dict(robust=RobustConfig(attack="flood")),
               dict(sched=SchedConfig(dispatch_chunk=-1))):
        with pytest.raises(ValueError):
            FedEngine(MLPTask(hidden=HIDDEN), FedConfig(**kw), device="cpu")
