"""The port's LM zoo (dense decoder) against the JAX package's, at a
reduced size: minicpm-2b, chatglm3-6b, gemma2-9b and qwen3-14b
``reduced(d_model=128)``, 2 layers, seq 16-48, the same inputs (numpy,
seeded) into both; gemma2-9b's reduced window (64) is cut to
`WINDOW` so that its local block's window bites at seq 24.

Bands, stated per test:

* layers, loss, grads, sampled loss at fp32 (``dtype`` replaced by
  ``"float32"``): ``rtol=1e-5, atol=1e-6`` (torch's CPU GEMM and XLA's
  dot sum in different orders; sin / cos are an ulp apart); the logits
  ``rtol=1e-5`` and ``atol=1e-6`` times their largest magnitude (when
  above 1: an untied head's logits reach 4, and the GEMMs' order error
  scales with them; measured 8.8e-7 of it);
* the same at bf16, the arch's own dtype: logits within 2 bf16 steps of
  their largest magnitude (``atol`` 2^-6 of it), the loss ``rtol=1e-3``
  (measured 2.1e-4 at chatglm3-6b's untied head),
  each grad leaf within 2^-5 of its largest magnitude (bf16 rounds every
  op's output: 2^-8 relative, compounded over the layers);
* packing: bitwise `repro.comm.flat` at fp32 and bf16 leaves;
* engine rounds at fp32: the engine's band ``rtol=1e-5, atol=1e-6``
  (tests/test_torch_engine.py) on loss, params, m and h after each of 2
  rounds, against ``jax.jit(FedEngine.round)`` with its GNB draws
  injected; at bf16 (the arch's dtype) the loss within ``rtol=1e-3``, m
  and h within the grads' bf16 band, the params within ``atol=1e-4``
  plus a bf16 step of their value but for at most 16 coordinates, each
  within a flipped clipped step (`_bf16_band`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.comm import flat as jflat
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs, convert
from repro_torch.comm import flat as tflat
from repro_torch.configs.base import FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.core.gnb import leaf_grads
from repro_torch.data import synthetic as syn
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

RTOL, ATOL = 1e-5, 1e-6
#: the dense decoders the port runs
DENSE = ("minicpm-2b", "chatglm3-6b", "gemma2-9b", "qwen3-14b")
#: the MoE decoders it runs (tests/test_torch_lm_moe.py)
MOE = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
#: the recurrent-mixer archs it runs (tests/test_torch_lm_rec.py,
#: tests/test_torch_lm_xlstm.py)
RECURRENT = ("recurrentgemma-2b", "xlstm-1.3b")
B, S = 2, 24
#: the sliding window of the reduced configs that have one, below `S`
WINDOW = 16


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it (jitted rounds trace
    the JAX package's Pallas kernels)."""
    yield
    jax.clear_caches()


def _cfgs(arch, dtype=None, **replace):
    """The reduced (JAX, port) configs of ``arch`` in ``dtype``, with the
    fields of ``replace`` set in both."""
    j = jconfigs.get_model_config(arch).reduced(d_model=128)
    t = configs.get_model_config(arch).reduced(d_model=128)
    if t.window is not None:
        j, t = (dataclasses.replace(c, window=WINDOW) for c in (j, t))
    if dtype is not None:
        replace = dict(replace, dtype=dtype)
    if replace:
        j, t = (dataclasses.replace(c, **replace) for c in (j, t))
    return j, t


def _params(jcfg, seed=0):
    jp = JT.init_lm(jax.random.PRNGKey(seed), jcfg)
    # norm weights (every vector leaf, stacked over at most a few layers:
    # ln1/ln2, the post-norms, qk-norm's q_norm/k_norm, final_norm) off
    # one, so a norm-weight slip cannot hide behind ones
    rs = np.random.RandomState(seed)
    jp = jax.tree.map(
        lambda x: x if x.ndim > 2 or (x.ndim == 2 and x.shape[0] > 8) else
        (x * (1.0 + 0.2 * rs.randn(*x.shape))).astype(x.dtype), jp)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")


def _batch(vocab, seed=0, lead=()):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, vocab, lead + (B, S))
    lab = rs.randint(0, vocab, lead + (B, S))
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.tensor(tok), "labels": torch.tensor(lab)})


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------- layers
def test_rms_norm_softcap_and_ffn_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 64).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(64)).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(w)), JL.rms_norm(jnp.asarray(x),
                                                   jnp.asarray(w)))
    _close(TL.softcap(_t(x * 40), 30.0), JL.softcap(jnp.asarray(x * 40),
                                                    30.0))
    g, u = rs.randn(3, 7).astype(np.float32), rs.randn(3, 7).astype(
        np.float32)
    for kind in ("swiglu", "geglu", "gelu"):
        _close(TL.ffn_act(kind, _t(g), _t(u)),
               JL.ffn_act(kind, jnp.asarray(g), jnp.asarray(u)))
    p = {k: rs.randn(*shp).astype(np.float32) * 0.2 for k, shp in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    _close(TL.ffn_apply({k: _t(v) for k, v in p.items()}, "swiglu", _t(x)),
           JL.ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                        "swiglu", jnp.asarray(x)))


def test_init_helpers_and_pad_head_mask():
    """Init scales and shapes (the values are the generator's own), and
    the padded-head mask against the JAX package's."""
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, 400, 300, torch.bfloat16)
    ws = TL.stacked_dense_init(g, 3, 400, 300)
    assert w.dtype == torch.bfloat16 and ws.shape == (3, 400, 300)
    for x in (w.float(), ws):
        assert abs(float(x.std()) * 20.0 - 1.0) < 0.02
    _, tcfg = _cfgs("chatglm3-6b")
    jcfg, _ = _cfgs("chatglm3-6b")
    for pad in (4, 6, 8):
        tc, jc = (dataclasses.replace(c, pad_attn_heads=pad)
                  for c in (tcfg, jcfg))
        np.testing.assert_array_equal(TL.pad_head_mask(tc).numpy(),
                                      np.asarray(JL.pad_head_mask(jc)))


def test_padded_heads_are_no_ops():
    """With ``pad_attn_heads`` the padded heads change nothing: the
    attention block's output equals the unpadded block's on the real
    heads' weights, as in the JAX package."""
    jcfg, tcfg = _cfgs("chatglm3-6b", "float32")
    padded_j = dataclasses.replace(jcfg, pad_attn_heads=6)
    padded_t = dataclasses.replace(tcfg, pad_attn_heads=6)
    jp = JL.init_attention(jax.random.PRNGKey(1), padded_j, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    rs = np.random.RandomState(5)
    x = rs.randn(B, S, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    got = TL.attention_apply(tp, padded_t, _t(x), torch.tensor(pos),
                             kind="attn")
    want, _ = JL.attention_apply(jp, padded_j, jnp.asarray(x),
                                 jnp.asarray(pos), kind="attn")
    _close(got, want)


@pytest.mark.parametrize("arch", DENSE)
def test_rope_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    rs = np.random.RandomState(2)
    x = rs.randn(B, 48, 4, jcfg.resolved_head_dim).astype(np.float32)
    pos = np.broadcast_to(np.arange(48), (B, 48))
    _close(TL.apply_rope(_t(x), torch.tensor(pos), tcfg),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg))
    s, c = TL._rope_sin_cos(torch.tensor(pos), 32, 1e4)
    js, jc = JL._rope_sin_cos(jnp.asarray(pos), 32, 1e4)
    _close(s, js)
    _close(c, jc)


def _qkv(rs, Sq, H, K, hd=16):
    return (rs.randn(B, Sq, H, hd).astype(np.float32),
            rs.randn(B, Sq, K, hd).astype(np.float32),
            rs.randn(B, Sq, K, hd).astype(np.float32))


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
def test_attention_dense_matches_jax(heads):
    rs = np.random.RandomState(3)
    q, k, v = _qkv(rs, 20, *heads)
    pos = np.arange(20)
    for causal, window in ((True, None), (False, None), (True, 6)):
        jb = JL.attn_mask_bias(jnp.asarray(pos), jnp.asarray(pos),
                               causal=causal, window=window)
        tb = TL.attn_mask_bias(torch.tensor(pos), torch.tensor(pos),
                               causal=causal, window=window)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        _close(TL.attention_dense(_t(q), _t(k), _t(v), tb, 0.25),
               JL.attention_dense(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jb, 0.25))


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
@pytest.mark.parametrize("Sq,chunk", [(48, 16), (45, 16), (40, 64)])
def test_attention_chunked_matches_jax(heads, Sq, chunk):
    """The online softmax over KV chunks, Sq past the chunk (and a
    ragged last chunk), against the JAX scan; and the dispatcher's
    chunked route."""
    rs = np.random.RandomState(4)
    q, k, v = _qkv(rs, Sq, *heads)
    pos = np.arange(Sq)
    kw = dict(causal=True, window=None, scale=0.25, kv_chunk=chunk)
    got = TL.attention_chunked(_t(q), _t(k), _t(v), q_pos=torch.tensor(pos),
                               k_pos=torch.tensor(pos), **kw)
    want = JL.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_pos=jnp.asarray(pos),
                                k_pos=jnp.asarray(pos), **kw)
    _close(got, want)
    dense = TL.attention(_t(q), _t(k), _t(v), q_pos=torch.tensor(pos),
                         k_pos=torch.tensor(pos), causal=True, scale=0.25)
    routed = TL.attention(_t(q), _t(k), _t(v), q_pos=torch.tensor(pos),
                          k_pos=torch.tensor(pos), causal=True, scale=0.25,
                          chunk_threshold=8, kv_chunk=chunk)
    _close(routed, got)
    _close(dense, got, rtol=1e-5, atol=2e-6)


# ---------------------------------------------------- model and loss
def _loss_grads(task, params, batch):
    """Loss and the grads of every leaf (a zero-size leaf, a depth cut's
    empty stack, gets its empty grad: `gnb.leaf_grads`)."""
    pg = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = task.loss(pg, batch)
    grads = leaf_grads(loss.sum(), list(pg.values()))
    return loss.detach(), dict(zip(pg, grads))


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_grads_sampled_loss_match_jax(arch, dtype):
    model_vs_jax(*_cfgs(arch, dtype))


def model_vs_jax(jcfg, tcfg, jit=False, fp32_band=(RTOL, ATOL),
                 bf16_band=(2 ** -6, 2 ** -5)):
    """The forward, loss, grads and GNB sampled loss of the reduced
    configs against JAX's, from the same weights and batch, in the
    module's bands for ``tcfg.dtype``.  ``jit``: the JAX side as one
    jitted function (the recurrent archs: eager JAX takes tens of
    seconds there), else op by op.  ``fp32_band``: ``(rtol, atol)`` of
    the fp32 logits (``atol`` times their largest magnitude above 1),
    loss and grads; ``bf16_band``: the bf16 logits' and grads' shares of
    their largest magnitude."""
    rtol, atol = fp32_band
    logits_steps, grad_steps = bf16_band
    jp, tp = _params(jcfg)
    jb, tb = _batch(jcfg.vocab_size)
    jt, tt = JT.LMTask(jcfg), TT.LMTask(tcfg)
    fp32 = tcfg.dtype == "float32"
    key = jax.random.PRNGKey(9)

    def reference(p, b):
        return (JT.forward(p, jcfg, b)[0],
                jax.value_and_grad(jt.loss)(p, b),
                jt.sampled_loss(p, b, key))
    jl, (jloss, jg), jsampled = (jax.jit(reference) if jit
                                 else reference)(jp, jb)
    tl, _, _ = TT.forward(tp, tcfg, tb)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    top = float(np.abs(np.asarray(jl)).max())
    _close(tl, jl, rtol=rtol if fp32 else RTOL,
           atol=(atol if fp32 else logits_steps) * max(1.0, top))
    tloss, tg = _loss_grads(tt, tp, tb)
    _close(tloss, jloss, rtol=rtol if fp32 else 1e-3)
    jg = convert.flatten(jax.tree.map(np.asarray, jg))
    assert sorted(jg) == sorted(tg)
    for k, g in tg.items():
        want = np.asarray(jg[k], np.float32)
        assert g.dtype == tp[k].dtype
        if fp32:
            _close(g, want, rtol=rtol, atol=atol, msg=k)
        else:
            _close(g.float(), want, rtol=0,
                   atol=grad_steps * float(np.abs(want).max(initial=0)),
                   msg=k)
    # the GNB inner loss, JAX's own categorical draw injected: at fp32
    # the same labels; at bf16 labels may differ only at near-ties of
    # logits + gumbel (within the logits' band), and the loss against
    # JAX's labels is held to the loss band
    gum = np.array(jax.random.gumbel(key, tl.shape, jnp.float32))
    jy = np.asarray(JT.sample_labels(key, jl, jcfg.vocab_size))
    ty = TT.sample_labels(tl.detach(), tcfg.vocab_size,
                          torch.from_numpy(gum)).numpy()
    if fp32:
        np.testing.assert_array_equal(ty, jy)
        _close(tt.sampled_loss(tp, tb, torch.from_numpy(gum)), jsampled,
               rtol=rtol)
    else:
        z = np.asarray(jl, np.float32) + gum
        gap = (np.take_along_axis(z, jy[..., None], -1)
               - np.take_along_axis(z, ty[..., None], -1))
        assert np.all(gap <= 2 * logits_steps * max(1.0, top)), gap.max()
        _close(TT.cross_entropy(tl, torch.from_numpy(np.array(jy)),
                                tcfg.vocab_size), jsampled, rtol=1e-3)


def test_client_axis_is_a_batch_of_independent_models():
    """Params and batches with a leading client axis give each client the
    loss of its own model and batch, and grads of its own loss only."""
    _, tcfg = _cfgs("minicpm-2b", "float32")
    task = TT.LMTask(tcfg)
    ps = [task.init(torch.Generator().manual_seed(s), "cpu")
          for s in (0, 1, 2)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    _, tb = _batch(tcfg.vocab_size, seed=5, lead=(3,))
    loss, grads = _loss_grads(task, stacked, tb)
    assert loss.shape == (3,)
    for i, p in enumerate(ps):
        li, gi = _loss_grads(task, p, {k: v[i] for k, v in tb.items()})
        _close(loss[i], li)
        for k, g in gi.items():
            _close(grads[k][i], g, msg=k)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_tree_packs_bitwise_as_jax(arch, dtype):
    packs_as_jax(*_cfgs(arch, dtype))


def packs_as_jax(jcfg, tcfg):
    """The reduced tree packs and unpacks bitwise as the JAX
    ``FlatSpec`` does (leaf order, geometry, dtypes, buffer)."""
    jp, tp = _params(jcfg, seed=3)
    jspec, tspec = jflat.flat_spec(jp), tflat.flat_spec(tp)
    jorder = ["/".join(p.key for p in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tspec.keys) == jorder
    assert (tspec.total, tspec.rows, tspec.cols) == (jspec.total,
                                                     jspec.rows, jspec.cols)
    assert tspec.dtypes == tuple(getattr(torch, str(np.dtype(d)))
                                 for d in jspec.dtypes)
    jbuf = np.asarray(jflat.pack(jp, jspec))
    tbuf = tflat.pack(tp, tspec)
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    back = tflat.unpack(tbuf, tspec)
    for k, v in convert.flatten(jflat.unpack(jnp.asarray(jbuf),
                                             jspec)).items():
        assert back[k].dtype == tp[k].dtype
        np.testing.assert_array_equal(back[k].float().numpy(),
                                      np.asarray(v, np.float32))
    # nested numpy out, the JAX package's tree back in
    nested = convert.params_to_numpy(tp)
    assert jax.tree.structure(nested) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))


def test_token_batches():
    g = torch.Generator().manual_seed(0)
    b = syn.make_token_batch(g, 3, 2, 16, 500)
    assert b["tokens"].shape == b["labels"].shape == (3, 2, 16)
    assert b["tokens"].dtype == torch.int64
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 500
    np.testing.assert_array_equal(b["labels"][..., :-1].numpy(),
                                  b["tokens"][..., 1:].numpy())
    np.testing.assert_array_equal(b["labels"][..., -1].numpy(),
                                  b["tokens"][..., 0].numpy())
    again = syn.make_token_batch(torch.Generator().manual_seed(0), 3, 2,
                                 16, 500)
    np.testing.assert_array_equal(again["tokens"].numpy(),
                                  b["tokens"].numpy())


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if a not in DENSE + MOE + RECURRENT])
def test_unported_families_raise(arch):
    cfg = configs.get_model_config(arch).reduced(d_model=128)
    with pytest.raises(NotImplementedError, match=r"queue 1 \(g\)"):
        TT.LMTask(cfg)
    with pytest.raises(NotImplementedError, match=r"queue 1 \(g\)"):
        TT.init_lm(torch.Generator().manual_seed(0), cfg)


# ------------------------------------------------------- engine rounds
C, J, TAU, EB, ES, ROUNDS = 2, 2, 1, 2, 16, 2


def _gumbel(rng, vp, seq=ES):
    """The JAX engine's GNB draws of one round, ``(C, J, B, S, Vp)``:
    client i's step j from ``fold_in(fold_in(rng, i), j)``."""
    return np.stack([np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(rng, i), j), (EB, seq, vp),
        jnp.float32)) for j in range(J)]) for i in range(C)])


#: bf16 engine band of the params: ``atol`` plus a bf16 step of the
#: value; coordinates outside it (at most this many a buffer) each
#: within a flipped clipped step
BF16_ATOL, BF16_MAX_OUT = 1e-4, 16


def _bf16_band(got, want, name, flip, msg, outliers=0):
    """At bf16 parameters the grads agree to bf16 rounding, so m and h
    (EMAs of grads and squared grads) within 2^-5 of their largest
    magnitude, the grads' own band; with ``outliers``, at most that many
    coordinates of each out to twice it (a GNB label sampled at a
    near-tie of the logits flips, and moves its token's share of the
    curvature).  The params within ``BF16_ATOL``
    plus one bf16 step of their value (the resolution at which the
    model reads them), but for at most `BF16_MAX_OUT` coordinates where
    one engine's m
    crossed zero and the other's did not: each within a flipped clipped
    step, ``2 * lr`` per local step per client (``flip`` over the
    run)."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    diff = np.abs(got - want)
    if name != "params":
        top = float(np.abs(want).max())
        out = diff > 2 ** -5 * top
        assert int(out.sum()) <= outliers, (msg, float(diff.max()), top,
                                            int(out.sum()))
        assert np.all(diff <= 2 ** -4 * top), (msg, float(diff.max()), top)
        return
    out = diff > BF16_ATOL + 2 ** -8 * np.abs(want)
    assert int(out.sum()) <= BF16_MAX_OUT, (msg, int(out.sum()))
    assert np.all(diff[out] <= flip), (msg, float(diff.max()), flip)


def rounds_vs_jitted_jax(arch, strategy, dtype, seq=ES, outliers=0,
                         replace=None, fp32_band=None):
    """`ROUNDS` engine rounds of the reduced ``arch`` at ``seq`` tokens
    against ``jax.jit(FedEngine.round)`` from the same state, batches
    and GNB draws, held to the module's engine bands after each round
    (``outliers``: `_bf16_band`'s; ``replace``: config fields set in
    both packages, `_cfgs`; ``fp32_band(got, want, name, flip, msg)``
    replaces the fp32 engine band, with `_bf16_band`'s arguments)."""
    jcfg, tcfg = _cfgs(arch, dtype, **(replace or {}))
    kw = dict(num_clients=C, local_iters=J, tau=TAU, lr=1e-3,
              schedule="wsd", total_rounds=4, strategy=strategy)
    jeng = JFedEngine(JT.LMTask(jcfg), JFedConfig(use_pallas=True, **kw))
    teng = FedEngine(TT.LMTask(tcfg), FedConfig(**kw), device="cpu")
    key = jax.random.PRNGKey(0)
    jstate = jeng.init(jax.random.fold_in(key, 3))
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    jstate, tstate = jeng.pack_state(jstate), teng.pack_state(tstate)
    jround = jax.jit(jeng.round)
    fp32 = dtype == "float32"
    for r in range(ROUNDS):
        jb = jsyn.make_token_batch(jax.random.fold_in(key, 100 + r), C, EB,
                                   seq, jcfg.vocab_size)
        tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
        rng = jax.random.fold_in(key, 1000 + r)
        jstate, jm = jround(jstate, jb, rng)
        tstate, tm = teng.round(tstate, tb, gumbel=torch.from_numpy(
            _gumbel(rng, jcfg.vocab_padded, seq)))
        assert tm["total_bytes"] == int(jm["total_bytes"])
        assert float(tm["lr"]) == float(jm["lr"])
        _close(tm["loss"], jm["loss"], rtol=RTOL if fp32 else 1e-3)
        want = convert.state_to_numpy(tstate)
        got = jax.tree.map(np.asarray, jstate)
        for name, a, b in (("params", got["params"], want["params"]),
                           ("m", got["client_opt"].m,
                            want["client_opt"]["m"]),
                           ("h", got["client_opt"].h,
                            want["client_opt"]["h"])):
            if fp32 and fp32_band is not None:
                fp32_band(b, a, name, 2 * kw["lr"] * J * (r + 1) / C,
                          f"round {r} {name}")
            elif fp32:
                _close(b, a, msg=f"round {r} {name}")
            else:
                _bf16_band(b, a, name, 2 * kw["lr"] * J * (r + 1) / C,
                           f"round {r} {name}", outliers)


@pytest.mark.parametrize("strategy,dtype", [("parallel", "float32"),
                                            ("sequential", "float32"),
                                            ("parallel", "bfloat16")])
def test_lm_rounds_match_jitted_jax(strategy, dtype):
    rounds_vs_jitted_jax("minicpm-2b", strategy, dtype)
