"""The FedOpt baselines (FedAdam, FedYogi) and DONE in the PyTorch port
against the JAX engine.

Both engines start from the same JAX-built state (carried over by
`repro_torch.convert`), see the same data and the JAX engine's own
random inputs (the comm path's uniform noise; `tests/test_torch_comm_round.jax_draws`)
and run 2 rounds: MLP hidden 16, C=4, J=3 (DONE: J=1 and J=2), tau=2,
B=8.  The JAX side is ``jax.jit(FedEngine.round)`` with ``use_pallas``
(and ``comm.use_pallas``) on; the port runs on the CPU.

* FedAdam / FedYogi: local SGD, then the server's Adam / Yogi step on
  ``params - aggregate``, in the JAX operation order.  Parallel and
  sequential, dict- and packed-resident, direct and int8-uplink.
  Params and the server m/v within slice 1's band (``rtol=1e-5,
  atol=1e-6``).  Yogi's ``sign(v - delta^2)`` is 0 only at an exact tie;
  no coordinate of these runs sits within an ulp of one (the test would
  fail on it rather than widen the band).
* DONE (the paper's second-order baseline): parallel and sequential,
  ``rtol=1e-4, atol=1e-5`` on loss and params.  The port takes its
  Hessian-vector products by double backward, the JAX engine by
  forward-over-reverse ``jvp``; each of the 25 products (5 power
  iterations, 20 Richardson steps) sums in another order.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.models.small import MLPTask as JMLPTask
from repro_torch import convert
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import sophia_update as tk
from repro_torch.models.small import MLPTask
from test_torch_comm_round import jax_draws

C, TAU, B, HIDDEN, ROUNDS = 4, 2, 8, 16, 2
RTOL, ATOL = 1e-5, 1e-6
DONE_RTOL, DONE_ATOL = 1e-4, 1e-5


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
    return key, batches, rngs


def _torch_batch(b):
    return {"x": torch.tensor(np.asarray(b["x"])),
            "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}


def run_pair(data, fed_kw, comm_kw=None, packed=False, local_iters=3):
    """2 rounds of each engine from the same state; returns the final
    JAX state (numpy), the port's (numpy) and the per-round losses."""
    key, batches, rngs = data
    comm_kw = comm_kw or {}
    cfg = dict(num_clients=C, local_iters=local_iters, tau=TAU,
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
    losses = []
    for r in range(ROUNDS):
        gumbel, noise = jax_draws(jeng, params0, rngs[r])
        jstate, jm = jround(jstate, batches[r], rngs[r])
        tstate, tm = teng.round(
            tstate, _torch_batch(batches[r]),
            gumbel=torch.from_numpy(gumbel[:, :local_iters]),
            comm_noise=noise)
        losses.append((float(jm["loss"]), float(tm["loss"])))
        assert tm["total_bytes"] == int(jm["total_bytes"])
    return (jax.tree.map(np.asarray, jstate),
            convert.state_to_numpy(tstate), losses)


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        return {f"{prefix}[{k}]": np.asarray(v) for k, v in tree.items()}
    return {prefix: np.asarray(tree)}


def compare(jstate, tstate, losses, rtol=RTOL, atol=ATOL):
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol,
                                   err_msg="loss")
    assert int(tstate["round"]) == int(jstate["round"]) == ROUNDS
    want = _leaves(jstate["params"], "params")
    got = _leaves(tstate["params"], "params")
    if "server_opt" in jstate:
        for k in ("m", "v"):
            want.update(_leaves(jstate["server_opt"][k], f"server_opt.{k}"))
            got.update(_leaves(tstate["server_opt"][k], f"server_opt.{k}"))
    else:
        assert "server_opt" not in tstate
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                   err_msg=name)


FEDOPT_CASES = {
    f"{opt}-{strategy}-{res}-{path}": (opt, strategy, res == "packed",
                                       path == "int8")
    for opt in ("fedadam", "fedyogi")
    for strategy in ("parallel", "sequential")
    for res in ("dict", "packed")
    for path in ("direct", "int8")}


@pytest.mark.parametrize("name", list(FEDOPT_CASES))
def test_fedopt_round_parity(data, name):
    opt, strategy, packed, int8 = FEDOPT_CASES[name]
    tk.reset_launches()
    tq.reset_launches()
    jstate, tstate, losses = run_pair(
        data, dict(optimizer=opt, strategy=strategy, lr=0.02),
        dict(compressor="int8") if int8 else None, packed=packed)
    compare(jstate, tstate, losses)
    # local SGD: no Sophia step; CPU tensors count no launch anyway
    assert sum(tk.LAUNCHES.values()) == sum(tq.LAUNCHES.values()) == 0
    # the server moved the model and kept non-trivial moments
    assert np.any(np.concatenate([v.reshape(-1) for v in _leaves(
        tstate["server_opt"]["v"], "v").values()]) > 0)


@pytest.mark.parametrize("strategy", ["parallel", "sequential"])
@pytest.mark.parametrize("local_iters", [1, 2])
def test_done_round_parity(data, strategy, local_iters):
    """DONE at the paper's settings (lr 1.0, 20 Richardson iterations,
    damping 10; `benchmarks/run.py`'s Fig. 2 runs it at J=1)."""
    jstate, tstate, losses = run_pair(
        data, dict(optimizer="done", strategy=strategy, lr=1.0),
        local_iters=local_iters)
    compare(jstate, tstate, losses, rtol=DONE_RTOL, atol=DONE_ATOL)
    # the loss fell over the two rounds, as the JAX engine's did
    assert losses[1][0] < losses[0][0] and losses[1][1] < losses[0][1]
