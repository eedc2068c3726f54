"""The mLSTM and sLSTM mixers and xlstm-1.3b of the port against the JAX
package's, at a reduced size: ``reduced(d_model=128)`` (4 heads; mLSTM
width 256, heads of 64; sLSTM heads of 32; one ``(m x 7, s)`` pattern;
``reduced()`` gives it an FFN of ``2 d_model``, the published
``d_ff=0`` drops it), seq 16-256, the same inputs (numpy, seeded) into
both.  `MLSTM_CHUNK` is patched to 8 in both packages where a test says
so, so that a short sequence runs several chunks and the carry across
them; once it runs at its own 128 over S=256.  The helpers, bands and
engine loop come from tests/test_torch_lm.py.

Bands.  A single mixer at fp32: ``rtol=1e-5`` and ``atol=1e-6`` of the
largest magnitude (the GEMMs sum in other orders, ``jnp.cumsum`` adds in
XLA's order: tests/test_torch_lm_rec.py), forward, final state and
grads; at bf16 outputs within 2^-6 and grads within 2^-5 of their
largest magnitude, the loss ``rtol=1e-3``.  The chunk scan's grads of
the log gates at the published chunk (128) need ``rtol=1e-4``: they sum
a chunk's worth of exponentially weighted terms, and the error grows
with the chunk (measured, the largest error of a grad of ``lf`` over
its value: 1.6e-5 at chunk 128, inside 1e-5 at chunk 8).

The whole xlstm at 2 layers (two mLSTM blocks, every ``blocks_{pi}``
a zero-length stack): at fp32 `XLSTM_BAND` (below), at bf16 logits
within 2^-6 and grads within 2^-5 of their largest magnitude.  Eight
blocks and the engine rounds: tests/test_torch_lm_xlstm_model.py.

`XLSTM_BAND`, the whole model's fp32 band: ``rtol=1e-4``, ``atol=1e-5``
of the largest magnitude.  Recurrent blocks compound the order error of
each, and it grows with the sequence (measured on the CPU, the logits'
largest error over their largest magnitude, chunk 8: 1.6e-6, 2.6e-6,
3.7e-6 at S = 8, 24, 64 for eight mLSTM blocks; 1.4e-6, 1.5e-6, 2.2e-6
for eight sLSTM blocks); the gate biases' grads, summed over the steps,
reach 1.1e-5 of their largest magnitude at ``rtol=1e-5`` and 3.9e-6 at
``rtol=1e-4`` (S=24).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch import configs, convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT
from test_torch_lm import (ATOL, RTOL, B, _batch, _cfgs, _close,
                           _loss_grads, _params, _t, model_vs_jax,
                           packs_as_jax)

XLSTM = "xlstm-1.3b"
#: the whole model's fp32 band, (rtol, atol of the largest magnitude)
XLSTM_BAND = (1e-4, 1e-5)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture
def chunk8(monkeypatch):
    """`MLSTM_CHUNK` 8 in both packages."""
    monkeypatch.setattr(JR, "MLSTM_CHUNK", 8)
    monkeypatch.setattr(TR, "MLSTM_CHUNK", 8)


def _pos(n):
    return np.broadcast_to(np.arange(n), (B, n))


def _tt(x):
    return convert._tensor(np.asarray(x), "cpu")


def _rel_close(got, want, rtol=RTOL, msg=""):
    want = np.asarray(want, np.float32)
    _close(got, want, rtol=rtol,
           atol=ATOL * max(1.0, float(np.abs(want).max(initial=0))), msg=msg)


def _bf16_close(got, want, steps=2 ** -6, msg=""):
    want = np.asarray(want, np.float32)
    _close(got.float(), want, rtol=0,
           atol=steps * float(np.abs(want).max(initial=0)), msg=msg)


# ----------------------------------------------------------- mLSTM
def _scan_inputs(S, dh=16, H=2, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, S, dh).astype(np.float32) for _ in range(3))
    k = k / np.sqrt(dh)
    li = rs.randn(B, H, S).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        jnp.asarray(rs.randn(B, H, S) + 3.0, jnp.float32)))
    return q, k, v, li, lf


@pytest.mark.parametrize("chunk,S", [(8, 32), (8, 20), (128, 256)])
def test_mlstm_chunk_scan_matches_jax(monkeypatch, chunk, S):
    """The stabilized chunk scan from a zero state: h, the final (C, n,
    m) and the grads of every input; several chunks carry across.  A
    sequence that is not a whole number of chunks is refused."""
    monkeypatch.setattr(JR, "MLSTM_CHUNK", chunk)
    monkeypatch.setattr(TR, "MLSTM_CHUNK", chunk)
    rtol = 1e-4 if chunk == 128 else RTOL
    ins = _scan_inputs(S)
    if S % min(chunk, S):
        with pytest.raises(ValueError, match="divisible"):
            TR._mlstm_chunk_scan(*map(_t, ins))
        return

    def jfun(*a):
        h, st = JR._mlstm_chunk_scan(*a)
        return jnp.sum(h ** 2) + sum(jnp.sum(x) for x in st[:2]), (h, st)
    (_, (jh, jst)), jg = jax.jit(jax.value_and_grad(
        jfun, argnums=tuple(range(5)), has_aux=True))(*map(jnp.asarray,
                                                           ins))
    tin = [_t(a).requires_grad_(True) for a in ins]
    th, tst = TR._mlstm_chunk_scan(*tin)
    tg = torch.autograd.grad((th ** 2).sum() + sum(x.sum() for x in tst[:2]),
                             tin)
    _rel_close(th.detach(), jh)
    for got, want, name in zip(tst, jst, "Cnm"):
        _rel_close(got.detach(), want, msg=name)
    for got, want, name in zip(tg, jg, ("q", "k", "v", "li", "lf")):
        _rel_close(got, want, rtol=rtol, msg=name)


def _mlstm_inputs(dtype, d_model=128, seed=3, **replace):
    j = jconfigs.get_model_config(XLSTM).reduced(d_model=d_model)
    t = configs.get_model_config(XLSTM).reduced(d_model=d_model)
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype, **replace)
                  for c in (j, t))
    jdt = jnp.dtype(dtype)
    jp = JR.init_mlstm(jax.random.PRNGKey(seed), jcfg, jdt)
    rs = np.random.RandomState(seed)
    jp = dict(jp, b_if=jnp.asarray(jp["b_if"] + rs.randn(
        *jp["b_if"].shape).astype(np.float32)))
    return jcfg, tcfg, jp


def _block_vs_jax(japply, tapply, jcfg, tcfg, jp, S, seed):
    """A mixer's output and the grads of its leaves and of x, JAX jitted
    against the port, in the dtype's band."""
    dtype = tcfg.dtype
    x = np.random.RandomState(seed).randn(B, S, tcfg.d_model).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    pos = _pos(S)

    def jloss(p, xx):
        out, _ = japply(p, jcfg, xx, jnp.asarray(pos))
        return jnp.sum(out.astype(jnp.float32) ** 2), out
    (_, want), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jx)
    tp = {k: _tt(v).requires_grad_(True) for k, v in jp.items()}
    tx = _t(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = tapply(tp, tcfg, tx, torch.tensor(pos))
    assert got.dtype == tx.dtype
    grads = torch.autograd.grad((got.float() ** 2).sum(),
                                list(tp.values()) + [tx])
    jg = dict(jg, x=jgx)
    pairs = list(zip(list(tp) + ["x"], grads))
    for k, g in pairs:
        assert g.dtype == (tx if k == "x" else tp[k]).dtype, k
    if dtype == "float32":
        _rel_close(got.detach(), want)
        for k, g in pairs:
            _rel_close(g, jg[k], msg=k)
    else:
        _bf16_close(got.detach(), want)
        for k, g in pairs:
            _bf16_close(g, jg[k], steps=2 ** -5, msg=k)


@pytest.mark.parametrize("dtype,d_model,cdt", [
    ("float32", 128, "float32"), ("bfloat16", 128, "float32"),
    ("bfloat16", 256, "bfloat16")])
def test_mlstm_apply_matches_jax(chunk8, dtype, d_model, cdt):
    """The block at seq 24 (three chunks of 8): up-projection, conv, q /
    k / v heads, the fp32 gates (``w_if``, ``b_if`` fp32 in a bf16
    model), the scan, the output gate.  At d_model 256 the heads are
    128 wide: k / sqrt(128) at bf16 divides by 11.3125, the scalar
    rounded to bf16 as in JAX, and ``scan_compute_dtype="bfloat16"``
    rounds the chunk operands to bf16 with fp32 products and carries."""
    jcfg, tcfg, jp = _mlstm_inputs(dtype, d_model,
                                   scan_compute_dtype=cdt)
    assert TR._mlstm_dims(tcfg)[2] == d_model // 2
    _block_vs_jax(JR.mlstm_apply, TR.mlstm_apply, jcfg, tcfg, jp, 24, 4)


def test_mlstm_k_scale_is_jax_bitwise_at_bf16():
    """k / sqrt(dh) at bf16 is JAX's bit for bit at dh 128 (the divisor
    11.3137 rounded to 11.3125 first); a Python float is not."""
    x = jnp.asarray(np.random.RandomState(5).randn(4096), jnp.bfloat16)
    want = np.asarray(x / math.sqrt(128.0)).view(np.int16)
    tx = _tt(x)
    got = (tx / TL.scalar(math.sqrt(128.0), tx)).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(
        (tx / math.sqrt(128.0)).view(torch.int16).numpy(), want)


# ----------------------------------------------------------- sLSTM
@pytest.mark.parametrize("dtype,S", [("float32", 16), ("float32", 64),
                                     ("bfloat16", 24)])
def test_slstm_apply_matches_jax(dtype, S):
    """The gate pre-activations (fp32, ``b_gates`` fp32), the steps in
    order, the gn norm and the up / down projection; ``slstm_unroll``
    changes nothing."""
    jcfg, tcfg = _cfgs(XLSTM, dtype)
    jp = JR.init_slstm(jax.random.PRNGKey(6), jcfg, jnp.dtype(dtype))
    rs = np.random.RandomState(6)
    jp = dict(jp, gn=(1 + 0.2 * rs.randn(tcfg.d_model)).astype(
        jp["gn"].dtype))
    _block_vs_jax(JR.slstm_apply, TR.slstm_apply, jcfg, tcfg, jp, S, 7)
    tp = {k: _tt(v) for k, v in jp.items()}
    x = _t(rs.randn(B, 8, tcfg.d_model).astype(np.float32)).to(
        getattr(torch, dtype))
    unrolled = dataclasses.replace(tcfg, slstm_unroll=4)
    np.testing.assert_array_equal(
        TR.slstm_apply(tp, tcfg, x, None).float().numpy(),
        TR.slstm_apply(tp, unrolled, x, None).float().numpy())


def test_xlstm_init_matches_jax_layout_and_constants():
    """The port's init: JAX's leaf keys, shapes and dtypes (``w_if``,
    ``b_if``, ``b_gates`` fp32 in a bf16 model), no FFN at ``d_ff=0``,
    and the gate biases JAX's exactly."""
    jcfg, tcfg = _cfgs(XLSTM, "bfloat16", d_ff=0)
    got = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    want = convert.flatten(jax.eval_shape(
        lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg)))
    assert sorted(got) == sorted(want)
    assert not any("/ffn/" in k or k.endswith("/ln2") for k in got)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
    key = jax.random.PRNGKey(1)
    for k, init in (("blocks_0/mixer/b_if", JR.init_mlstm),
                    ("blocks_7/mixer/b_gates", JR.init_slstm)):
        np.testing.assert_array_equal(
            got[k][0].numpy(),
            np.asarray(init(key, jcfg, jnp.bfloat16)[k.split("/")[-1]]))
    assert got["blocks_0/mixer/w_if"].dtype == torch.float32
    # every grad of the eight bf16 blocks in its leaf's dtype, finite
    _, tb = _batch(tcfg.vocab_size)
    _, grads = _loss_grads(TT.LMTask(tcfg), got, tb)
    for k, g in grads.items():
        assert g.dtype == got[k].dtype and torch.isfinite(g).all(), k


# ------------------------------------------------ xlstm-1.3b, 2 layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_depth_below_its_pattern_trains_as_jax(chunk8, dtype):
    """xlstm-1.3b at 2 layers: every ``blocks_{pi}`` a zero-length
    stack and two remainder mLSTM blocks, as JAX builds them; forward,
    loss, grads and sampled loss against JAX (at bf16 in the standard
    band), packing bitwise (zero-size leaves included)."""
    jcfg, tcfg = _cfgs(XLSTM, dtype, d_ff=0, num_layers=2)
    assert tcfg.pattern_reps == 0 and tcfg.pattern_remainder == ("m", "m")
    model_vs_jax(jcfg, tcfg, jit=True, fp32_band=XLSTM_BAND)
    packs_as_jax(jcfg, tcfg)


def test_checkpoint_of_bf16_xlstm_reads_both_ways(tmp_path):
    """The reduced bf16 xlstm's params: the port's checkpoint read by the
    JAX package and JAX's by the port, bitwise, with the fp32 leaves of
    the bf16 model (``w_if``, ``b_if``, ``b_gates``) float32 in both
    manifests."""
    jcfg, _ = _cfgs(XLSTM, "bfloat16", d_ff=0)
    jp, tp = _params(jcfg, seed=6)
    tckpt.save(str(tmp_path / "port"), tp, step=2)
    jckpt.save(str(tmp_path / "jax"), jp, step=2)
    manifest = tckpt.load_manifest(str(tmp_path / "port"))
    assert manifest == jckpt.load_manifest(str(tmp_path / "jax"))
    for k in ("blocks_0/mixer/w_if", "blocks_0/mixer/b_if",
              "blocks_7/mixer/b_gates"):
        assert manifest["dtypes"][k] == "float32", k
    assert manifest["dtypes"]["blocks_0/mixer/wq"] == "bfloat16"
    from_jax = tckpt.restore(str(tmp_path / "jax"), tp)
    from_port = convert.flatten(jax.tree.map(
        np.asarray, jckpt.restore(str(tmp_path / "port"), jp)))
    for k, v in tp.items():
        assert from_jax[k].dtype == v.dtype
        assert torch.equal(from_jax[k].view(torch.uint8),
                           v.view(torch.uint8)), k
        assert from_port[k].dtype == convert._array(v).dtype
        np.testing.assert_array_equal(
            from_port[k].view(np.uint8), convert._array(v).view(np.uint8),
            err_msg=k)
