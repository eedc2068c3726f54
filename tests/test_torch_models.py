"""The port's models, GNB estimator, lr schedules and data helpers
against the JAX package's.

Tolerances:
* logits, loss, grads and GNB estimates: ``rtol=1e-5, atol=1e-6`` —
  the same math, but torch's CPU GEMM / convolution and XLA's dot /
  conv sum in different orders;
* sampled labels, lr bits and the Dirichlet partition: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core.gnb import gnb_estimate as j_gnb
from repro.core.schedules import lr_at_round as j_lr
from repro.data import synthetic as jsyn
from repro.models.small import CNNTask as JCNNTask
from repro.models.small import MLPTask as JMLPTask
from repro_torch import convert
from repro_torch.configs.base import FedConfig
from repro_torch.core.gnb import gnb_estimate
from repro_torch.core.schedules import lr_at_round
from repro_torch.data import synthetic as syn
from repro_torch.models.small import CNNTask, MLPTask

RTOL, ATOL = 1e-5, 1e-6
B = 8

TASKS = {
    "mlp": (lambda: JMLPTask(hidden=16), lambda: MLPTask(hidden=16)),
    "cnn": (lambda: JCNNTask(channels=(4, 8)),
            lambda: CNNTask(channels=(4, 8))),
}


def _setup(name, seed=0):
    jmake, tmake = TASKS[name]
    jtask, ttask = jmake(), tmake()
    key = jax.random.PRNGKey(seed)
    jp = jtask.init(key)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, 28, 28, 1)).astype(np.float32)
    y = rs.integers(0, 10, B).astype(np.int32)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}
    return jtask, ttask, jp, tp, jb, tb, key


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _grads(ttask, tp, tb):
    leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    loss = ttask.loss(leaves, tb)
    gs = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, gs))


@pytest.mark.parametrize("name", list(TASKS))
def test_logits_loss_grads_match_jax(name):
    jtask, ttask, jp, tp, jb, tb, _ = _setup(name)
    with torch.no_grad():
        _close(ttask.logits(tp, tb).numpy(), jtask.logits(jp, jb), "logits")
    jl, jg = jax.value_and_grad(jtask.loss)(jp, jb)
    tl, tg = _grads(ttask, tp, tb)
    _close(tl.numpy(), jl, "loss")
    for k in jg:
        _close(tg[k].numpy(), jg[k], f"grad {k}")


@pytest.mark.parametrize("name", list(TASKS))
def test_client_axis_equals_per_client_calls(name):
    """A leading client axis is a batch dimension: each client's logits
    and loss are what the unbatched call gives for that client."""
    _, ttask, _, tp, _, tb, _ = _setup(name)
    scales = (1.0, 0.5, -1.5)
    tps = {k: torch.stack([s * v for s in scales]) for k, v in tp.items()}
    tbs = {k: torch.stack([v] * len(scales)) for k, v in tb.items()}
    with torch.no_grad():
        lb = ttask.logits(tps, tbs)
        loss_b = ttask.loss(tps, tbs)
        for i, s in enumerate(scales):
            pi = {k: s * v for k, v in tp.items()}
            _close(lb[i].numpy(), ttask.logits(pi, tb).numpy())
            _close(loss_b[i].numpy(), ttask.loss(pi, tb).numpy())


@pytest.mark.parametrize("name", list(TASKS))
def test_sampled_labels_and_gnb_match_jax(name):
    jtask, ttask, jp, tp, jb, tb, key = _setup(name, seed=1)
    rng = jax.random.fold_in(key, 5)
    gumbel = torch.tensor(np.asarray(jax.random.gumbel(rng, (B, 10),
                                                       jnp.float32)))
    logits = jtask.logits(jp, jb)
    want_y = np.asarray(jax.random.categorical(rng, logits, axis=-1))
    with torch.no_grad():
        tl = ttask.logits(tp, tb)
    got_y = torch.argmax(tl + gumbel, dim=-1).numpy()
    np.testing.assert_array_equal(got_y, want_y)
    _close(ttask.sampled_loss(tp, tb, gumbel).detach().numpy(),
           jtask.sampled_loss(jp, jb, rng), "sampled loss")
    want = j_gnb(jtask, jp, jb, rng)
    got = gnb_estimate(ttask, tp, tb, gumbel)
    for k in want:
        _close(got[k].numpy(), want[k], f"h_hat {k}")


SCHEDULES = [dict(schedule=s, warmup_rounds=w, total_rounds=t, lr=lr)
             for s in ("const", "cosine", "wsd")
             for w in (0, 3)
             for t, lr in ((20, 3e-3), (7, 0.02))]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=lambda kw: f"{kw['schedule']}-w{kw['warmup_rounds']}"
                         f"-t{kw['total_rounds']}")
def test_lr_at_round_bitwise(kw):
    jfed, tfed = JFedConfig(**kw), FedConfig(**kw)
    for r in range(kw["total_rounds"] + 2):
        want = np.asarray(j_lr(jfed, jnp.int32(r)), np.float32)
        got = lr_at_round(tfed, r)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert got.numpy().tobytes() == want.tobytes(), (r, got, want)


@pytest.mark.parametrize("alpha", [0.5, 0.1])
def test_dirichlet_partition_exact(alpha):
    key = jax.random.PRNGKey(4)
    _, y = jsyn.make_image_data(key, 600, "mnist")
    jkey = jax.random.fold_in(key, 1)
    want = jsyn.dirichlet_partition(jkey, y, 6, alpha=alpha)
    seed = int(jax.random.randint(jkey, (), 0, 2 ** 31 - 1))
    got = syn.dirichlet_partition(seed, torch.tensor(np.asarray(y)), 6,
                                  alpha=alpha)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(syn.train_test_split(got), jsyn.train_test_split(want)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_data_shapes():
    gen = torch.Generator().manual_seed(0)
    x, y = syn.make_image_data(gen, 300, "fmnist", noise=1.3)
    assert x.shape == (300, 28, 28, 1) and x.dtype == torch.float32
    assert y.shape == (300,) and int(y.min()) >= 0 and int(y.max()) <= 9
    assert torch.isfinite(x).all()
    part = syn.dirichlet_partition(1, y, 4, alpha=0.5)
    tr, te = syn.train_test_split(part)
    batches = syn.client_batches(gen, x, y, tr, 16)
    assert batches["x"].shape == (4, 16, 28, 28, 1)
    assert batches["y"].shape == (4, 16)
    rows = torch.as_tensor(tr).long()
    for i in range(4):   # every sample comes from the client's own shard
        sel = batches["y"][i]
        assert bool(torch.isin(sel, y[rows[i]]).all())
