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
                           "sophia_update_batched": 0,
                           "sophia_update_leaves": 0}


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


def _at_offset(x, offset):
    """A contiguous view of ``x``'s values ``offset`` elements into its
    storage."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def test_kernel_form_follows_dtypes_and_alignment():
    """The wrapper launches the kernel's fp32 form only when all eight
    tensors are fp32 and 16-byte aligned (decided from dtypes and
    ``data_ptr() % 16``, the same for tensors on either device)."""
    ins = _t(_inputs((N, R, C)))
    outs = [torch.empty_like(x) for x in ins[:3]]
    assert tk.takes_f32x4(*outs, *ins)
    assert tk.takes_f32x4(*(_at_offset(x, 4) for x in ins))   # 16 bytes
    for k in range(5):
        moved = list(ins)
        moved[k] = _at_offset(ins[k], 1)
        assert moved[k].is_contiguous()
        assert not tk.takes_f32x4(*outs, *moved)
        for dt in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            narrow = list(ins)
            narrow[k] = ins[k].to(dt)
            assert not tk.takes_f32x4(*outs, *narrow)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(7, 999), (1, 3)], ids=["7x999", "1x3"])
def test_ragged_and_offset_views_bitwise_vs_jax_eager_ref(shape, offset):
    """Shapes the fp32 form covers with its scalar tail (n % 4 != 0) and
    views that send the kernel to its runtime-dtype form, through the
    wrapper (its plain version on the CPU), flat and batched, out of
    place and in place: bitwise the JAX package's eager ref."""
    xs = _inputs(shape, seed=11)
    want = jref.sophia_update_ref(*(jnp.asarray(x) for x in xs), 1, lr=LR,
                                  **HP)
    for entry, lift in ((tk.sophia_update_flat, lambda x: x),
                        (tk.sophia_update_batched, lambda x: x[None])):
        for inplace in (False, True):
            ins = [lift(_at_offset(x, offset)) for x in _t(xs)]
            got = entry(*ins, 1, LR, inplace=inplace, **HP)
            for g_, w in zip(got, want):
                np.testing.assert_array_equal(
                    g_.reshape(shape).numpy().view(np.uint32),
                    np.asarray(w).view(np.uint32))
            if inplace:
                assert all(a is b for a, b in zip(got, ins[:3]))


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
    (`kernels.ops.sophia_fused_step`; on the CPU its plain version: pack,
    the Sophia update, unpack), called directly here, against the JAX
    package's, the Pallas kernel in interpret mode: rtol=atol=1e-6
    (XLA's FMA contraction)."""
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


# ------------------------------------------------ e4m3 stores on the CPU
#: stored values that walk e4m3's overflow rule (ml_dtypes: 464 rounds
#: to 448, NaN past it and for +-inf, NaN stays NaN), and their negatives
E4M3_EDGE = np.array([447.0, 448.0, 464.0, 470.0, 500.0, 1e5, np.inf,
                      np.nan], np.float32)


def _same_nan_as_nan(got, want):
    """Bitwise, but a NaN need only be NaN in both (the payload and sign
    of a NaN that arithmetic makes are the framework's own)."""
    w = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == w.dtype.name
    assert got.shape == w.shape
    nan = np.isnan(w.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got.float().numpy()), nan)
    raw_g = got.view(torch.uint8).numpy().reshape(got.numel(), -1)
    raw_w = w.view(np.uint8).reshape(w.size, -1)
    np.testing.assert_array_equal(raw_g[~nan.reshape(-1)],
                                  raw_w[~nan.reshape(-1)])


@pytest.mark.parametrize("do_h", [0, 1])
def test_e4m3_overflow_stores_bitwise_vs_jax_eager_ref(do_h):
    """theta, m and h stored in e4m3, with beta1 = beta2 = 0.5 so that m
    and h land exactly on `E4M3_EDGE` (m = g / 2, h = h_hat / 2 from 0):
    the plain version, directly and through both CPU wrappers, stores
    what the JAX package's eager ref stores (ml_dtypes' rule), where
    ``Tensor.to`` alone saturates at 448 in some torch versions."""
    hp = dict(HP, beta1=0.5, beta2=0.5)
    vals = np.concatenate([E4M3_EDGE, -E4M3_EDGE])
    rs = np.random.default_rng(21)
    n = 4 * vals.size
    theta = rs.standard_normal(n).astype(np.float32)
    g = np.tile(2 * vals, 4)
    hh = np.abs(g)
    zeros = np.zeros(n, np.float32)
    e4 = jnp.float8_e4m3fn
    jx = [jnp.asarray(theta).astype(e4), jnp.asarray(zeros).astype(e4),
          jnp.asarray(zeros).astype(e4), jnp.asarray(g), jnp.asarray(hh)]
    want = jref.sophia_update_ref(*jx, jnp.float32(do_h),
                                  lr=jnp.float32(LR), **hp)
    assert np.isnan(np.asarray(want[1], np.float32)).sum() >= 4 * 8
    assert (np.asarray(want[1], np.float32) == 448.0).sum() >= 4 * 2
    tx = [torch.from_numpy(np.asarray(x).view(np.uint8).copy()).view(
        torch.float8_e4m3fn) for x in jx[:3]] + _t((g, hh))
    for got in (sophia_update_ref(*tx, do_h, lr=LR, **hp),
                tk.sophia_update_flat(*(x.reshape(4, -1) for x in tx),
                                      do_h, LR, **hp),
                tk.sophia_update_batched(*(x.reshape(2, 2, -1) for x in tx),
                                         do_h, LR, **hp)):
        for g_, w in zip(got, want):
            _same_nan_as_nan(g_.reshape(-1), w)


# --------------------------------- the pytree step's CPU route and its table
def _jax_packed_eager(trees, do_h):
    """The JAX package's pytree form with its eager ref in the kernel's
    place: its pack, ``repro.kernels.ref.sophia_update_ref``, its unpack."""
    from repro.comm.flat import flat_spec as jspec
    from repro.comm.flat import pack as jpack
    from repro.comm.flat import unpack as junpack
    spec = jspec(trees[0], cols=1024)
    outs = jref.sophia_update_ref(*(jpack(t, spec) for t in trees),
                                  jnp.float32(do_h), lr=jnp.float32(LR),
                                  **HP)
    return [junpack(o, spec) for o in outs]


@pytest.mark.parametrize("do_h", [0, 1])
def test_fused_step_cpu_route_vs_jax_and_per_leaf(do_h):
    """`ops.sophia_fused_step` on CPU trees (its plain version: pack, the
    plain update, unpack) on the MLP-16 pytree:

    * bitwise the JAX package's pack / eager ref / unpack;
    * against ``repro.kernels.ops.sophia_fused_step(..., interpret=True)``
      within rtol=atol=1e-6: the jitted Pallas body contracts mul+add
      into FMAs (thousands of m coordinates an ulp off);
    * bitwise the port's per-leaf `sophia_step` CPU route;
    * all three results in the params leaves' dtypes, also when m is
      stored narrower (the JAX package unpacks with the params' layout).
    """
    from repro.kernels import ops as jops
    from repro_torch.core import sophia as tsophia
    from repro_torch.kernels import ops
    (jp, jg, jhh, jm, jh), (tp, tg, thh, tm, th) = _mlp_trees(7 + do_h)
    ops.reset_launches()
    got = ops.sophia_fused_step(tp, tm, th, tg, thh, do_h, lr=LR, **HP)
    assert ops.LAUNCHES["sophia_fused_step"] == 0
    eager = _jax_packed_eager([jp, jm, jh, jg, jhh], do_h)
    interp = jops.sophia_fused_step(jp, jm, jh, jg, jhh, do_h, lr=LR, **HP,
                                    interpret=True)
    params, state = tsophia.sophia_step(tp, tg, tsophia.SophiaState(tm, th),
                                        thh, bool(do_h), lr=LR, **HP)
    for g_, e, i, p in zip(got, eager, interp, (params, state.m, state.h)):
        assert sorted(g_) == sorted(tp)
        for k in tp:
            np.testing.assert_array_equal(g_[k].numpy(), np.asarray(e[k]))
            np.testing.assert_allclose(g_[k].numpy(), np.asarray(i[k]),
                                       rtol=1e-6, atol=1e-6)
            assert torch.equal(g_[k], p[k])
    narrow_m = {k: v.to(torch.bfloat16) for k, v in tm.items()}
    got = ops.sophia_fused_step(tp, narrow_m, th, tg, thh, do_h, lr=LR, **HP)
    eager = _jax_packed_eager(
        [jp, {k: v.astype(jnp.bfloat16) for k, v in jm.items()}, jh, jg,
         jhh], do_h)
    for g_, e in zip(got, eager):
        for k in tp:
            assert g_[k].dtype == torch.float32
            np.testing.assert_array_equal(g_[k].numpy(), np.asarray(e[k]))


def test_fused_step_rejects_trees_it_does_not_take():
    from repro_torch.kernels import ops
    _, (tp, tg, thh, tm, th) = _mlp_trees(4)
    with pytest.raises(ValueError, match="keys"):
        ops.sophia_fused_step(tp, {"w1": tm["w1"]}, th, tg, thh, 1, lr=LR,
                              **HP)
    with pytest.raises(ValueError, match="shape"):
        ops.sophia_fused_step(tp, tm, th, dict(tg, b1=tg["b1"][:3]), thh, 1,
                              lr=LR, **HP)
    with pytest.raises(TypeError, match="dtype"):
        ops.sophia_fused_step(tp, tm, th, dict(tg, b1=tg["b1"].double()),
                              thh, 1, lr=LR, **HP)


def _leaf_model(ns, f32x4, coords_per_block, cap):
    """numpy model of the leaf table: per launch, the first block of each
    leaf of at least one coordinate and the grid (a running sum of
    ceil(n / coords_per_block)), and its float4 flags."""
    keep = [(n, f) for n, f in zip(ns, f32x4) if n > 0]
    out = []
    for s in range(0, len(keep), cap):
        part = keep[s:s + cap]
        blocks = np.array([-(-n // coords_per_block) for n, _ in part])
        out.append((np.concatenate([[0], np.cumsum(blocks)]).tolist(),
                    [f for _, f in part], [n for n, _ in part]))
    return out


def _leaf(n, kind, seed):
    """One leaf's eight tensors (theta_out, m_out, h_out, theta, m, h, g,
    h_hat) of ``n`` coordinates: ``aligned`` fp32 fresh allocations,
    ``offset1`` with theta a view one element into its storage, or the
    params leaf (and so the outputs) ``bf16``."""
    xs = [torch.tensor(x) for x in _inputs((n,), seed)]
    if kind == "offset1":
        xs[0] = _at_offset(xs[0], 1)
    if kind == "bf16":
        xs[0] = xs[0].to(torch.bfloat16)
    outs = [torch.empty_like(xs[0]) for _ in range(3)]
    return tuple(outs + xs)


@pytest.mark.parametrize("leaves", [1, 6, 32, 33, 98])
def test_leaf_table_against_numpy_model(leaves):
    """`ops.leaf_table` on CPU tensors (the host side of the kernel's
    pytree form): first blocks, per-leaf float4 flags for aligned,
    offset-1 and bf16 leaves (n % 4 != 0 and empty leaves among them),
    the dtype codes and pointers, and the split into launches of at most
    ``MAX_LEAVES`` (cap, cap + 1 and 3 cap + 2 leaves)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import DTYPE_CODES
    assert ops.MAX_LEAVES == 32
    kinds = ("aligned", "offset1", "bf16")
    ns = [0 if i % 11 == 10 else 1 + (i * 397) % 3000 for i in range(leaves)]
    tensors = [_leaf(n, kinds[i % 3], i) for i, n in enumerate(ns)]
    flags = [kinds[i % 3] == "aligned" for i in range(leaves)]
    launches = ops.leaf_table(list(zip(map(str, range(leaves)), tensors)),
                              1024)
    model = _leaf_model(ns, flags, 1024, ops.MAX_LEAVES)
    assert len(launches) == len(model) == -(-sum(n > 0 for n in ns) // 32)
    kept = [(str(i), ts) for i, ts in enumerate(tensors) if ns[i] > 0]
    for j, (t, (first, f32x4, nn)) in enumerate(zip(launches, model)):
        part = kept[32 * j:32 * (j + 1)]
        assert list(t.first_block) == first
        assert list(t.f32x4) == f32x4
        assert list(t.ns) == nn
        assert t.keys == tuple(k for k, _ in part)
        assert list(t.ptrs) == [x.data_ptr() for _, ts in part for x in ts]
        assert list(t.codes) == [DTYPE_CODES[x.dtype] for _, ts in part
                                 for x in ts[2:]]
