"""The RG-LRU mixer and recurrentgemma-2b of the port against the JAX
package's, and the two repairs of the LM stack (bf16 scalars, depth cuts
below the block pattern), at a reduced size: ``reduced(d_model=128)``
(RG-LRU width 128, one ``(rec, rec, local)`` pattern, window cut to
16), seq 24-64, the same inputs (numpy, seeded) into both.  The
helpers, bands and engine loop come from tests/test_torch_lm.py.

Bands:

* bitwise against eager JAX: `associative_scan` (the recursion of
  ``lax.associative_scan``, with ``add`` and with the RG-LRU's combine,
  at even and odd lengths), `causal_conv1d` (fp32 and bf16: each
  product and add rounded in the operand dtype), the bf16 embedding
  scale and residual adds (fault 1) and the bf16 GeLU FFN activations;
  the RG-LRU combine's ``a`` is drawn from the RG-LRU's own range
  [0.9, 1): XLA:CPU flushes subnormals to zero and torch does not, so
  products of hundreds of factors near 0 would differ there and
  nowhere else;
* softplus and log-sigmoid within two ulps, their tangents ``rtol``
  1e-6 (`test_softplus_and_log_sigmoid_match_jax`);
* at fp32 ``rtol=1e-5`` and ``atol=1e-6`` of the largest magnitude
  (the GEMMs sum in other orders), forward and grads of `rglru_apply`
  and of the whole model (`model_vs_jax`); engine rounds by the engine
  band (`rounds_vs_jitted_jax`);
* at bf16 outputs within 2^-6 and grads within 2^-5 of their largest
  magnitude, the loss ``rtol=1e-3`` (bf16 rounds every op's output).
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.base import FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT
from test_torch_lm import (ATOL, RTOL, B, S, _batch, _cfgs, _close,
                           _loss_grads, _params, _t, model_vs_jax,
                           packs_as_jax, rounds_vs_jitted_jax)

REC = "recurrentgemma-2b"


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _pos(n):
    return np.broadcast_to(np.arange(n), (B, n))


def _tt(x):
    """A JAX or numpy array as a CPU tensor of its dtype (bf16 too)."""
    return convert._tensor(np.asarray(x), "cpu")


def _same(got, want, msg=""):
    if torch.is_tensor(got):
        got = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
               else got.detach().numpy())
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        want = want.view(np.int16)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _rel_close(got, want, rtol=RTOL, msg=""):
    """``rtol`` of each value and ``ATOL`` of the largest magnitude."""
    want = np.asarray(want, np.float32)
    _close(got, want, rtol=rtol,
           atol=ATOL * max(1.0, float(np.abs(want).max(initial=0))), msg=msg)


def _bf16_close(got, want, steps=2 ** -6, msg=""):
    want = np.asarray(want, np.float32)
    _close(got.float(), want, rtol=0,
           atol=steps * float(np.abs(want).max(initial=0)), msg=msg)


# ------------------------------------------------------------- helpers
@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 64, 256])
def test_associative_scan_is_jax_bitwise(n):
    rs = np.random.RandomState(n)
    x = rs.randn(3, n, 5).astype(np.float32)
    got = TR.associative_scan(lambda a, b: (a[0] + b[0],), (_t(x),), 1)[0]
    _same(got, jax.lax.associative_scan(jnp.add, jnp.asarray(x), axis=1))
    a = rs.uniform(0.9, 1.0, (2, 4, n, 6)).astype(np.float32)
    b = rs.randn(2, 4, n, 6).astype(np.float32)
    ta, tb = TR.associative_scan(TR._lru_combine, (_t(a), _t(b)), -2)
    ja, jb = jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c1[1] * c2[0] + c2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=2)
    _same(ta, ja)
    _same(tb, jb)


def test_cumsum_is_not_the_scan_and_is_held_in_the_band():
    """``jnp.cumsum`` on XLA:CPU adds neither in sequence nor by the
    scan's recursion (3,000-odd of 64 x 128 values differ from each), so
    the mLSTM's ``torch.cumsum`` is held to the band, not bitwise."""
    x = np.random.RandomState(0).randn(64, 128).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), -1))
    scan = TR.associative_scan(lambda a, b: (a[0] + b[0],), (_t(x),),
                               -1)[0].numpy()
    assert (scan != want).sum() > 1000
    _rel_close(torch.cumsum(_t(x), -1), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_is_jax_bitwise(dtype):
    rs = np.random.RandomState(1)
    u = rs.randn(2, 19, 24).astype(np.float32)
    w = (rs.randn(4, 24) * 0.3).astype(np.float32)
    ju, jw = (jnp.asarray(a).astype(dtype) for a in (u, w))
    tu, tw = (_t(a).to(getattr(torch, dtype)) for a in (u, w))
    want, want_state = JR.causal_conv1d(ju, jw)
    got, state = TR.causal_conv1d(tu, tw)
    assert got.dtype == tu.dtype
    _same(got, want)
    _same(state, want_state)
    # from a past (decode's conv state): the output and the new state
    past = (rs.randn(2, 3, 24)).astype(np.float32)
    jpast, tpast = jnp.asarray(past).astype(dtype), _t(past).to(tu.dtype)
    want, want_state = JR.causal_conv1d(ju[:, :1], jw, jpast)
    got, state = TR.causal_conv1d(tu[:, :1], tw, tpast)
    _same(got, want)
    _same(state, want_state)
    # with a client axis: each client's taps on its own sequence
    lead, _ = TR.causal_conv1d(torch.stack([tu, 2 * tu]),
                               torch.stack([tw, tw.flip(0)]))
    _same(lead[0], JR.causal_conv1d(ju, jw)[0])
    _same(lead[1], JR.causal_conv1d(2 * ju, jw[::-1])[0])


def test_softplus_and_log_sigmoid_match_jax():
    """JAX's ``logaddexp(x, 0)`` (past F.softplus's threshold 20 too)
    within two ulps, and its tangent ``exp(x - out)`` within 1e-6: ``exp``
    and ``log1p`` are each library's own approximations (18 of these 205
    values one ulp apart), and an ulp of ``out`` is several of ``x -
    out`` where they cancel (measured 2e-7 at x = 2.05).  XLA:CPU
    flushes a subnormal output (softplus(-90), 8.2e-40) to zero, which
    ``atol`` 2^-126 (the smallest normal) covers."""
    x = np.concatenate([np.random.RandomState(2).randn(200) * 8,
                        [0.0, 25.0, -30.0, 90.0, -90.0]]).astype(np.float32)
    tx = _t(x).requires_grad_(True)
    for tf, jf in ((TR.softplus, jax.nn.softplus),
                   (TR.log_sigmoid, jax.nn.log_sigmoid)):
        got = tf(tx)
        _close(got.detach(), jf(jnp.asarray(x)), rtol=2.5e-7,
               atol=2 ** -126)
        g, = torch.autograd.grad(got.sum(), tx)
        _close(g, jax.grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(x)),
               rtol=1e-6, atol=2 ** -126)


# ------------------------------------------------------------- RG-LRU
def test_rglru_init_matches_jax_layout_and_constants():
    """The port's init: JAX's leaf keys, shapes and dtypes (``lam`` fp32
    in a bf16 model), zero biases, and ``a = exp(-8 softplus(lam))`` in
    [0.9, 0.999]."""
    jcfg, tcfg = _cfgs(REC, "bfloat16")
    got = TR.init_rglru(torch.Generator().manual_seed(0), tcfg,
                        torch.bfloat16)
    want = jax.eval_shape(lambda: JR.init_rglru(jax.random.PRNGKey(0),
                                                jcfg, jnp.bfloat16))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
    assert got["lam"].dtype == torch.float32
    assert not got["b_a"].any() and not got["b_x"].any()
    a = torch.exp(-TR.RG_LRU_C * TR.softplus(got["lam"]))
    assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999


def _rglru_inputs(dtype, seed=4, S_=S):
    jcfg, tcfg = _cfgs(REC, dtype)
    jdt = jnp.dtype(dtype)
    jp = JR.init_rglru(jax.random.PRNGKey(seed), jcfg, jdt)
    rs = np.random.RandomState(seed)
    # biases off zero so that their grads and values count
    jp = dict(jp, b_a=(0.1 * rs.randn(*jp["b_a"].shape)).astype(jdt),
              b_x=(0.1 * rs.randn(*jp["b_x"].shape)).astype(jdt))
    x = rs.randn(B, S_, tcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_jax(dtype):
    """Forward and grads of every leaf and of x, at seq 64 (the gates'
    GEMMs fp32 and ``lam`` fp32 in both dtypes)."""
    jcfg, tcfg, jp, x = _rglru_inputs(dtype, S_=64)
    pos = _pos(64)
    jx = jnp.asarray(x).astype(dtype)
    tp = {k: _tt(v).requires_grad_(True) for k, v in jp.items()}
    tx = _t(x).to(getattr(torch, dtype)).requires_grad_(True)

    def jloss(p, xx):
        out, _ = JR.rglru_apply(p, jcfg, xx, jnp.asarray(pos))
        return jnp.sum(out.astype(jnp.float32) ** 2), out
    (_, want), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jx)
    got = TR.rglru_apply(tp, tcfg, tx, torch.tensor(pos))
    assert got.dtype == tx.dtype
    grads = torch.autograd.grad((got.float() ** 2).sum(),
                                list(tp.values()) + [tx])
    fp32 = dtype == "float32"
    pairs = list(zip(tp, grads)) + [("x", grads[-1])]
    jg = dict(jg, x=jgx)
    if fp32:
        _rel_close(got.detach(), want)
        for k, g in pairs:
            _rel_close(g, jg[k], msg=k)
    else:
        _bf16_close(got.detach(), want)
        for k, g in pairs:
            assert g.dtype == tp[k].dtype if k != "x" else True
            _bf16_close(g, jg[k], steps=2 ** -5, msg=k)


def test_rglru_client_axis_is_independent_models():
    """A leading client axis on every weight and on x gives each client
    its own block's output."""
    _, tcfg, jp, x = _rglru_inputs("float32", seed=5)
    tp = [{k: _t(v) * (1 + 0.1 * i) for k, v in jp.items()}
          for i in range(2)]
    xs = torch.stack([_t(x), _t(x).flip(1)])
    pos = torch.tensor(_pos(S))
    both = TR.rglru_apply({k: torch.stack([p[k] for p in tp])
                           for k in tp[0]}, tcfg, xs, pos)
    for i in range(2):
        np.testing.assert_array_equal(
            both[i].numpy(), TR.rglru_apply(tp[i], tcfg, xs[i], pos).numpy())


# ------------------------------------------------- recurrentgemma-2b
@pytest.mark.parametrize("layers,dtype", [(3, "bfloat16"), (5, "float32")])
def test_recurrentgemma_forward_loss_grads_sampled_loss_match_jax(layers,
                                                                  dtype):
    """recurrentgemma-2b reduced: one (rec, rec, local) pattern, and at 5
    layers its two remainder ``rec`` blocks (``rem_0``, ``rem_1``);
    GeGLU FFNs, tied embeddings, ``scale_emb`` sqrt(2560).  The 5-layer
    case runs the 3-layer pattern too, so fp32 is held there only."""
    jcfg, tcfg = _cfgs(REC, dtype, num_layers=layers)
    assert tcfg.pattern_remainder == ("rec", "rec")[:layers - 3]
    model_vs_jax(jcfg, tcfg, jit=True)


@pytest.mark.parametrize("layers", [3, 5])
def test_recurrentgemma_tree_and_init_match_jax(layers):
    """Packing bitwise as the JAX ``FlatSpec`` (the fp32 ``lam`` among
    bf16 leaves), and the port's init gives JAX's leaf keys, shapes and
    dtypes."""
    jcfg, tcfg = _cfgs(REC, "bfloat16", num_layers=layers)
    packs_as_jax(jcfg, tcfg)
    got = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    want = convert.flatten(jax.eval_shape(
        lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg)))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k


def test_recurrentgemma_rounds_match_jitted_jax():
    """Two engine rounds of the arch's FED strategy (parallel), C=2, at
    fp32 against the jitted JAX round, seq 24 past the window."""
    rounds_vs_jitted_jax(REC, "parallel", "float32", seq=S)


# ------------------------------------------- fault 1: bf16 scalars
@pytest.mark.parametrize("arch", ["gemma2-9b", REC, "minicpm-2b"])
def test_bf16_embed_scale_is_jax_bitwise(arch):
    """``x * scale_emb`` at bf16 rounds the scale to bf16 first, as JAX
    rounds a weak-typed scalar: sqrt(3584) is 59.75, sqrt(2560) 50.5,
    and the products are JAX's bit for bit (a Python float in torch
    gives a third of them one step off)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    assert tcfg.scale_emb != 1.0
    jp, tp = _params(jcfg, seed=7)
    jb, tb = _batch(jcfg.vocab_size, seed=7)
    _same(TT._embed_in(tp, tcfg, tb), JT._embed_in(jp, jcfg, jb))


def test_bf16_residual_adds_are_jax_bitwise(monkeypatch):
    """minicpm-2b's ``residual_scale`` 1.4/sqrt(40) at bf16: the block's
    two residual adds are JAX's bit for bit.  The mixer and the FFN are
    replaced in both packages by the same fixed outputs, so that only
    the adds (and the norm feeding the FFN) run."""
    jcfg, tcfg = _cfgs("minicpm-2b", "bfloat16")
    rs = np.random.RandomState(8)
    x, mix, f = (rs.randn(B, S, tcfg.d_model).astype(np.float32) * sc
                 for sc in (1.0, 3.0, 5.0))
    jmix, jf = (jnp.asarray(a).astype(jnp.bfloat16) for a in (mix, f))
    tmix, tf = (_t(a).bfloat16() for a in (mix, f))
    monkeypatch.setattr(JL, "attention_apply",
                        lambda *a, **k: (jmix, None))
    monkeypatch.setattr(JL, "ffn_apply", lambda *a, **k: jf)
    monkeypatch.setattr(TL, "attention_apply", lambda *a, **k: tmix)
    monkeypatch.setattr(TL, "ffn_apply", lambda *a, **k: tf)
    jp, _ = _params(jcfg, seed=8)
    bp = jax.tree.map(lambda a: a[0], jp["blocks_0"])
    tp = {k: _tt(v) for k, v in convert.flatten(
        jax.tree.map(np.asarray, bp)).items()}
    want, _, _ = JT.apply_block(bp, jcfg, "attn",
                                jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(_pos(S)))
    got, _ = TT.apply_block(tp, tcfg, "attn", _t(x).bfloat16(),
                            torch.tensor(_pos(S)))
    _same(got, want)
    # the scale is not a no-op, and a Python float would miss JAX's bits
    unrounded = _t(x).bfloat16() + tcfg.residual_scale * tmix
    once = _t(x).bfloat16() + TL.scalar(tcfg.residual_scale, tmix) * tmix
    assert not torch.equal(unrounded, once)


@pytest.mark.parametrize("kind", ["geglu", "gelu"])
def test_bf16_ffn_act_is_jax_bitwise(kind):
    """The GeLU FFN activations at bf16 are JAX's bit for bit:
    ``jax.nn.gelu(approximate=True)`` rounds every op, as
    `layers.gelu_tanh` does (``F.gelu`` rounds once: about 40% of these
    values a step off); swiglu's in tests/test_torch_lm_vlm.py."""
    rs = np.random.RandomState(10)
    g = (rs.randn(4096) * 3).astype(np.float32)
    u = rs.randn(4096).astype(np.float32)
    jg, ju = (jnp.asarray(a).astype(jnp.bfloat16) for a in (g, u))
    tg, tu = _t(g).bfloat16(), _t(u).bfloat16()
    want = JL.ffn_act(kind, jg, ju)
    _same(TL.ffn_act(kind, tg, tu), want)
    once = torch.nn.functional.gelu(tg, approximate="tanh")
    once = once * tu if kind == "geglu" else once
    off = once.view(torch.int16).numpy() != np.asarray(want).view(np.int16)
    assert off.mean() > 1 / 3


# ---------------------------------- fault 2: depth below the pattern
def test_gemma2_depth_below_its_pattern_trains_as_jax():
    """gemma2-9b at ``num_layers=1``: zero-length ``blocks_0`` and
    ``blocks_1`` stacks and one remainder ``local`` block, as JAX's
    ``vmap`` over no keys builds them.  Loss and grads against JAX (the
    empty leaves' grads empty), the packing bitwise as the JAX
    ``FlatSpec``, and an engine round of the port trains."""
    jcfg, tcfg = _cfgs("gemma2-9b", "float32", num_layers=1)
    assert tcfg.pattern_reps == 0 and tcfg.pattern_remainder == ("local",)
    tp = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    assert tp["blocks_0/mixer/wq"].shape[0] == 0
    model_vs_jax(jcfg, tcfg, jit=True)
    packs_as_jax(jcfg, tcfg)
    packs_as_jax(*_cfgs("gemma2-9b", "bfloat16", num_layers=1))
    task = TT.LMTask(tcfg)
    eng = FedEngine(task, FedConfig(num_clients=2, local_iters=2, tau=1,
                                    lr=1e-3, strategy="sequential"),
                    device="cpu")
    state = eng.pack_state(eng.init_from_params(tp))
    _, tb = _batch(tcfg.vocab_size, seed=9, lead=(2,))
    state, m = eng.round(state, tb, generator=torch.Generator()
                         .manual_seed(1))
    assert np.isfinite(float(m["loss"]))
    _, grads = _loss_grads(task, tp, {k: v[0] for k, v in tb.items()})
    assert grads["blocks_1/mixer/wq"].shape == tp["blocks_1/mixer/wq"].shape


# ------------------------------------------------ profiler ranges
def _live_tensors():
    gc.collect()
    return sum(1 for o in gc.get_objects() if torch.is_tensor(o))


@pytest.mark.parametrize("kind", ["rec", "m", "s"])
def test_scan_ranges_cover_forward_and_backward_and_hold_no_tensor(kind):
    """Each mixer's scan runs inside its profiler range once forward and
    once backward, and the range's hooks keep nothing alive: after the
    backward every tensor of the call is freed (a hook that held one
    would leak a round's graph every round)."""
    arch = REC if kind == "rec" else "xlstm-1.3b"
    _, tcfg = _cfgs(arch, "float32")
    init, apply = TT.RECURRENT[kind]
    span = {"rec": TR.RGLRU_SPAN, "m": TR.MLSTM_SPAN,
            "s": TR.SLSTM_SPAN}[kind]
    p = {k: v.requires_grad_(True) for k, v in init(
        torch.Generator().manual_seed(0), tcfg, torch.float32).items()}
    x = torch.randn(B, 8, tcfg.d_model)

    def step():
        out = apply(p, tcfg, x, None)
        torch.autograd.grad(out.square().sum(), list(p.values()))
    step()
    before = _live_tensors()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    assert _live_tensors() == before
    assert sum(e.name == span for e in prof.events()) == 2
