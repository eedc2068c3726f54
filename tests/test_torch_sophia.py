"""The port's Sophia update against the JAX package's.

* The plain `sophia_update_ref` runs the JAX eager reference's ops one
  by one in the same order, so at fp32 it is **bitwise** the eager
  ``repro.kernels.ref.sophia_update_ref`` (with lr an fp32 scalar, as
  the engine passes it).
* Against the Pallas kernel in interpret mode (jitted) the band is
  ``rtol=atol=1e-6``: XLA contracts mul+add into FMAs inside the jitted
  kernel, a one-ulp drift (the FMA-aware band of
  tests/test_kernel_conformance.py).
* Narrow storage rounds each output once: bf16 2^-8, e4m3 2^-3, e5m2
  2^-2 (that file's one-ulp-class bands).

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.sophia_update import (sophia_update_batched as
                                         j_batched)
from repro.kernels.sophia_update import sophia_update_flat as j_flat
from repro_torch import resolve_device
from repro_torch.core.sophia import sophia_step_flat
from repro_torch.kernels import KERNELS
from repro_torch.kernels import sophia_update as tk
from repro_torch.kernels.ref import sophia_update_ref

HP = dict(beta1=0.9, beta2=0.95, rho=0.04, eps=1e-12, weight_decay=1e-4)
LR = 3e-3
N, R, C = 3, 20, 100

DTYPES = {  # name -> (torch dtype, jnp dtype, band)
    "bf16": (torch.bfloat16, jnp.bfloat16, 2 ** -8),
    "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn, 2 ** -3),
    "e5m2": (torch.float8_e5m2, jnp.float8_e5m2, 2 ** -2),
}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it: the JAX package's
    jitted Pallas kernels traced here would otherwise stay in jax's
    caches for other modules' tests, which trace the same shapes under
    other launch geometries."""
    yield
    jax.clear_caches()


def _inputs(shape, seed=0):
    """theta, m, h, g, h_hat as fp32 numpy (h and h_hat non-negative, a
    few h exactly 0 so the eps floor and the clip both bite)."""
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal(shape).astype(np.float32)
    m = (0.1 * rs.standard_normal(shape)).astype(np.float32)
    h = np.abs(0.01 * rs.standard_normal(shape)).astype(np.float32)
    h.reshape(-1)[::17] = 0.0
    g = (0.5 * rs.standard_normal(shape)).astype(np.float32)
    hh = np.abs(0.02 * rs.standard_normal(shape)).astype(np.float32)
    return theta, m, h, g, hh


def _t(xs):
    return [torch.tensor(x) for x in xs]


@pytest.mark.parametrize("do_h", [0, 1])
def test_ref_bitwise_vs_jax_eager_ref(do_h):
    xs = _inputs((R, C))
    want = jref.sophia_update_ref(*map(jnp.asarray, xs), jnp.float32(do_h),
                                  lr=jnp.float32(LR), **HP)
    got = sophia_update_ref(*_t(xs), do_h, lr=LR, **HP)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("do_h", [0, 1])
def test_ref_vs_pallas_interpret(do_h):
    xs = _inputs((N, R, C), seed=1)
    jx = list(map(jnp.asarray, xs))
    got_b = sophia_update_ref(*_t(xs), do_h, lr=LR, **HP)
    want_b = j_batched(*jx, do_h, LR, **HP, interpret=True)
    want_f = j_flat(*(x[1] for x in jx), do_h, LR, **HP, interpret=True)
    for w, g in zip(want_b, got_b):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    for w, g in zip(want_f, got_b):
        np.testing.assert_allclose(g[1].numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(DTYPES))
def test_narrow_storage_within_ulp_band(name):
    tdt, jdt, band = DTYPES[name]
    xs = _inputs((N, R, C), seed=2)
    # theta/m/h stored narrow, g/h_hat fp32, as the engine feeds them
    tx = [torch.tensor(x).to(tdt) for x in xs[:3]] + _t(xs[3:])
    jx = [jnp.asarray(x).astype(jdt) for x in xs[:3]] + \
        list(map(jnp.asarray, xs[3:]))
    for a, b in zip(tx[:3], jx[:3]):   # both frameworks round the same
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    got = sophia_update_ref(*tx, 1, lr=LR, **HP)
    want = j_batched(*jx, 1, LR, **HP, interpret=True)
    for w, g in zip(want, got):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=band,
                                   atol=band)


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    xs = _inputs((N, R, C), seed=3)
    tk.reset_launches()
    want = sophia_update_ref(*_t(xs), 1, lr=LR, **HP)
    got_b = tk.sophia_update_batched(*_t(xs), 1, LR, **HP)
    got_f = tk.sophia_update_flat(*(t[0] for t in _t(xs)), 1, LR, **HP)
    ins = _t(xs)
    got_i = sophia_step_flat(*ins, True, lr=LR, inplace=True, **HP)
    for w, b, f, i, dst in zip(want, got_b, got_f, got_i, ins[:3]):
        assert torch.equal(w, b) and torch.equal(w[0], f)
        assert torch.equal(w, i) and i is dst   # in place
    assert tk.LAUNCHES == {"sophia_update_flat": 0,
                           "sophia_update_batched": 0}


def test_wrapper_rejects_bad_inputs():
    th, m, h, g, hh = _t(_inputs((N, R, C)))
    with pytest.raises(ValueError, match="3D"):
        tk.sophia_update_batched(th[0], m[0], h[0], g[0], hh[0], 1, LR, **HP)
    with pytest.raises(ValueError, match="2D"):
        tk.sophia_update_flat(th, m, h, g, hh, 1, LR, **HP)
    with pytest.raises(ValueError, match="shape"):
        tk.sophia_update_batched(th, m, h, g[:, :1], hh, 1, LR, **HP)
    with pytest.raises(TypeError, match="dtype"):
        tk.sophia_update_batched(th.double(), m, h, g, hh, 1, LR, **HP)
    with pytest.raises(ValueError, match="contiguous"):
        tk.sophia_update_batched(th[:1].expand(N, R, C), m, h, g, hh, 1, LR,
                                 inplace=True, **HP)


def test_registry_marks_sophia_update_ported():
    from repro.kernels import KERNELS as JKERNELS
    assert tuple(KERNELS) == JKERNELS
    # every family of the JAX package's registry has its port
    assert all(KERNELS.values())


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(None)


# ------------------------------------------------- the pytree Sophia step
def _mlp_trees(seed):
    """The MLP-16 params of the JAX package, and grads / h_hat / m / h
    trees of its shapes, as (JAX trees, port trees)."""
    from repro.models.small import MLPTask as JMLPTask
    from repro_torch import convert
    params = jax.tree.map(np.asarray, JMLPTask(hidden=16).init(
        jax.random.PRNGKey(seed)))
    rs = np.random.default_rng(seed)

    def like(scale, positive=False):
        t = {k: (scale * rs.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
        return {k: np.abs(v) for k, v in t.items()} if positive else t
    trees = [params, like(0.5), like(0.02, True), like(0.1),
             like(0.01, True)]           # params, grads, h_hat, m, h
    return ([jax.tree.map(jnp.asarray, t) for t in trees],
            [convert.params_from_numpy(t, "cpu") for t in trees])


@pytest.mark.parametrize("do_h", [False, True])
def test_pytree_sophia_step_matches_jax(do_h):
    """Two steps of the pytree Sophia step on the MLP pytree, both
    routes.  `sophia_step` on CPU trees is the per-leaf route: it runs
    the JAX pytree form's ops in its order, bitwise its eager run.  The
    kernel route that `sophia_step` takes for CUDA trees
    (`kernels.ops.sophia_fused_step`: pack, the Sophia update, unpack),
    called directly here, against the JAX package's, the Pallas kernel
    in interpret mode: rtol=atol=1e-6 (XLA's FMA contraction)."""
    from repro.core import sophia as jsophia
    from repro_torch.core import sophia as tsophia
    from repro_torch.kernels import ops
    (jp, jg, jhh, jm, jh), (tp, tg, thh, tm, th) = _mlp_trees(do_h + 1)
    kw = dict(lr=LR, **HP)

    def fused(params, grads, state, h_hat, do_h, **kw):
        params, m, h = ops.sophia_fused_step(params, state.m, state.h,
                                             grads, h_hat, do_h, **kw)
        return params, tsophia.SophiaState(m=m, h=h)

    for use_pallas in (False, True):
        step = fused if use_pallas else tsophia.sophia_step
        jstate = jsophia.SophiaState(m=jm, h=jh)
        tstate = tsophia.SophiaState(m=tm, h=th)
        jparams, tparams = jp, tp
        ops.reset_launches()
        for _ in range(2):
            jparams, jstate = jsophia.sophia_step(
                jparams, jg, jstate, jhh, do_h, use_pallas=use_pallas, **kw)
            tparams, tstate = step(tparams, tg, tstate, thh, do_h, **kw)
        assert ops.LAUNCHES["sophia_fused_step"] == 0     # CPU: plain
        for jt, tt in ((jparams, tparams), (jstate.m, tstate.m),
                       (jstate.h, tstate.h)):
            assert sorted(tt) == sorted(jt)
            for k in jt:
                assert tt[k].shape == jt[k].shape
                if use_pallas:
                    np.testing.assert_allclose(tt[k].numpy(),
                                               np.asarray(jt[k]),
                                               rtol=1e-6, atol=1e-6)
                else:
                    np.testing.assert_array_equal(tt[k].numpy(),
                                                  np.asarray(jt[k]))


def test_pytree_helpers():
    from repro.utils import tree as jtree
    from repro_torch.core import sophia as tsophia
    from repro_torch.utils.tree import tree_leaves, tree_map
    (jp, *_), (tp, *_) = _mlp_trees(3)
    nested = {"b": tp, "a": (tp["w1"], None, [tp["b2"]])}
    jnested = {"b": jp, "a": (jp["w1"], None, [jp["b2"]])}
    got = [x.numpy() for x in tree_leaves(nested)]
    want = jax.tree.leaves(jnested)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    doubled = tree_map(lambda x, y: x + y, nested, nested)
    assert doubled["a"][1] is None
    assert torch.equal(doubled["a"][2][0], 2 * tp["b2"])
    state = tsophia.init_state(tp)
    assert sorted(state.m) == sorted(tp)
    assert all(not v.any() for v in tree_leaves(state))
    assert jtree.tree_count_params(jp) == sum(
        v.numel() for v in tree_leaves(tp))
    with pytest.raises(ValueError, match="keys"):
        tree_map(torch.add, tp, {"w1": tp["w1"]})
