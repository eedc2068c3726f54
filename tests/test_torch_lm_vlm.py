"""M-RoPE and embedding inputs of the port against the JAX package's, at
a reduced size: qwen2-vl-2b (M-RoPE over ``(3, B, S)`` positions, a bf16
SwiGLU decoder on embedding inputs, tied) and hubert-xlarge (a
bidirectional encoder, ``causal=False``, on embedding inputs, untied, so
its token table ``embed`` reaches no op), ``reduced(d_model=128)``, 2
layers, seq 24 (16 in the engine and CLI runs), the same numpy inputs
into both.  The helpers, bands and engine loop come from
tests/test_torch_lm.py.

Bands, as there: fp32 ``rtol=1e-5, atol=1e-6`` (logits above 1 with
``atol`` times their largest magnitude); bf16 logits within 2^-6 of
their largest magnitude, the loss ``rtol=1e-3``, grads 2^-5 of each
leaf's largest magnitude; engine rounds (fp32) by the engine band but
for `ROUND_OUT` coordinates a buffer within ``rtol=1e-4``; the CLIs'
losses ``rtol=1e-3``.  The bf16 SwiGLU activation and the unreached
leaf's zeros are held exactly.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro import configs as jconfigs
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.obs import logio as jlogio
from repro_torch import convert
from repro_torch.comm import flat as tflat
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_lm import B, S, _cfgs, _close, _t

VLM, ENC = "qwen2-vl-2b", "hubert-xlarge"


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _same(got, want):
    """Bit for bit (bf16 compared through its 16-bit pattern)."""
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def _embeds(jcfg, seed=0, lead=(), seq=S):
    """An embeds batch with token labels: the (JAX, port) dicts, the
    embeds N(0, 1) in the config's dtype."""
    rs = np.random.RandomState(seed)
    emb = rs.randn(*(lead + (B, seq, jcfg.d_model))).astype(np.float32)
    lab = rs.randint(0, jcfg.vocab_size, lead + (B, seq))
    jb = {"embeds": jnp.asarray(emb).astype(JT.param_dtype(jcfg)),
          "labels": jnp.asarray(lab)}
    return jb, convert.params_from_numpy(jax.tree.map(np.asarray, jb),
                                         "cpu")


# ------------------------------------------------- the bf16 SwiGLU repair
def test_bf16_swiglu_is_jax_bitwise():
    """swiglu at bf16 is ``jax.nn.silu(gate) * up`` bit for bit: `silu`
    op by op, as XLA rounds each op (``F.silu`` rounds once: about a
    third of these values a step off); at fp32 it stays ``F.silu``."""
    rs = np.random.RandomState(10)
    g = (rs.randn(4096) * 3).astype(np.float32)
    u = rs.randn(4096).astype(np.float32)
    jg, ju = (jnp.asarray(a).astype(jnp.bfloat16) for a in (g, u))
    tg, tu = _t(g).bfloat16(), _t(u).bfloat16()
    want = JL.ffn_act("swiglu", jg, ju)
    _same(TL.ffn_act("swiglu", tg, tu), want)
    once = torch.nn.functional.silu(tg) * tu
    off = once.view(torch.int16).numpy() != np.asarray(want).view(np.int16)
    assert off.mean() > 1 / 4
    np.testing.assert_array_equal(
        TL.ffn_act("swiglu", _t(g), _t(u)).numpy(),
        (torch.nn.functional.silu(_t(g)) * _t(u)).numpy())


# --------------------------------------------------------------- M-RoPE
def _mrope_positions(seed, seq=S):
    """Three distinct position channels (t, h, w) ``(3, B, seq)``."""
    rs = np.random.RandomState(seed)
    return np.stack([np.sort(rs.randint(0, 4 * seq, (B, seq)), -1)
                     for _ in range(3)])


def test_mrope_matches_jax():
    """qwen2-vl's sections (8, 4, 4 of the reduced 16 slots) each from
    its own channel; a config without sections collapses the channels
    to the first, as JAX does."""
    jcfg, tcfg = _cfgs(VLM, "float32")
    assert tcfg.mrope_sections == (8, 4, 4)
    rs = np.random.RandomState(2)
    x = rs.randn(B, S, 4, tcfg.resolved_head_dim).astype(np.float32)
    pos = _mrope_positions(3)
    got = TL.apply_rope(_t(x), torch.tensor(pos), tcfg)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg))
    for c in range(3):          # each channel moves its own section
        moved = pos.copy()
        moved[c] += 7
        assert not torch.allclose(got, TL.apply_rope(
            _t(x), torch.tensor(moved), tcfg))
    jplain, tplain = _cfgs("minicpm-2b", "float32")
    plain = TL.apply_rope(_t(x), torch.tensor(pos), tplain)
    _close(plain, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jplain))
    np.testing.assert_array_equal(
        plain.numpy(), TL.apply_rope(_t(x), torch.tensor(pos[0]),
                                     tplain).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_attention_block_matches_jax(dtype):
    """qwen2-vl's attention block on three distinct position channels
    (the full-sequence mask from channel 0's first row, as in JAX)."""
    jcfg, tcfg = _cfgs(VLM, dtype)
    jp, tp = base._params(jcfg, seed=4)
    bp = jax.tree.map(lambda a: a[0], jp["blocks_0"]["mixer"])
    tmix = {k: v[0] for k, v in TL.subtree(tp, "blocks_0/mixer").items()}
    rs = np.random.RandomState(6)
    x = rs.randn(B, S, tcfg.d_model).astype(np.float32)
    pos = _mrope_positions(7)
    pos[0] = np.arange(S)          # the mask reads channel 0 (causal)
    jx = jnp.asarray(x).astype(dtype)
    want, _ = JL.attention_apply(bp, jcfg, jx, jnp.asarray(pos),
                                 kind="attn")
    got = TL.attention_apply(tmix, tcfg, _t(x).to(getattr(torch, dtype)),
                             torch.tensor(pos), kind="attn")
    top = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    _close(got.float(), np.asarray(want, np.float32),
           atol=(base.ATOL if dtype == "float32" else 2 ** -6) * top)


def test_default_positions_broadcast_for_mrope():
    """(3, B, S) for an M-RoPE config, (B, S) otherwise, as JAX's."""
    jcfg, tcfg = _cfgs(VLM)
    got = TT._default_positions(tcfg, B, 5, offset=3)
    want = JT._default_positions(jcfg, B, 5, offset=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jplain, tplain = _cfgs("minicpm-2b")
    np.testing.assert_array_equal(
        TT._default_positions(tplain, B, 5).numpy(),
        np.asarray(JT._default_positions(jplain, B, 5)))


# ---------------------------------------- embedding inputs, the encoder
@pytest.mark.parametrize("arch", [VLM, ENC])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embeds_forward_loss_grads_match_jax(arch, dtype):
    """tests/test_torch_lm.py's whole-model check on embeds batches: the
    logits, loss, every grad leaf and the GNB inner loss.  hubert-xlarge
    attends both ways, and its untied ``embed`` enters no op: its grad
    is zeros of its shape in both packages."""
    jcfg, tcfg = _cfgs(arch, dtype)
    assert tcfg.embedding_inputs and tcfg.causal == (arch == VLM)
    batch = _embeds(jcfg)
    base.model_vs_jax(jcfg, tcfg, jit=True, batch=batch)
    if arch == ENC:
        _, tp = base._params(jcfg)
        _, grads = base._loss_grads(TT.LMTask(tcfg), tp, batch[1])
        assert grads["embed"].shape == tp["embed"].shape
        assert not grads["embed"].any()


def test_encoder_attends_both_ways():
    """hubert-xlarge's logits at position 0 depend on later frames (its
    ``causal=False`` reaches the mask); a causal twin's do not."""
    _, tcfg = _cfgs(ENC, "float32")
    params = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    _, tb = _embeds(tcfg, seed=2)
    later = dict(tb, embeds=tb["embeds"].clone())
    later["embeds"][:, -1] += 1.0
    first = TT.forward(params, tcfg, tb)[0][:, 0]
    assert not torch.allclose(first, TT.forward(params, tcfg, later)[0][:, 0])
    causal = dataclasses.replace(tcfg, causal=True)
    np.testing.assert_array_equal(TT.forward(params, causal, tb)[0][:, 0],
                                  TT.forward(params, causal, later)[0][:, 0])


def test_embeds_under_a_client_axis():
    """Embeds ``(N, B, S, D)`` with stacked params: each client's loss is
    its own model's on its own frames."""
    _, tcfg = _cfgs(VLM, "float32")
    task = TT.LMTask(tcfg)
    ps = [task.init(torch.Generator().manual_seed(s), "cpu") for s in (0, 1)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    _, tb = _embeds(tcfg, seed=5, lead=(2,))
    loss = task.loss(stacked, tb)
    for i, p in enumerate(ps):
        _close(loss[i], task.loss(p, {k: v[i] for k, v in tb.items()}))


@pytest.mark.parametrize("arch", [VLM, ENC])
def test_embeds_packs_bitwise_as_jax(arch):
    base.packs_as_jax(*_cfgs(arch))


# ------------------------------------------------------- engine rounds
#: fp32 engine rounds: coordinates a buffer allowed out of the engine
#: band, each within ``rtol=1e-4`` (measured: one parameter of
#: qwen2-vl-2b's, ``blocks_0/ffn/w_down[1544]``, 5.8e-5 off relative
#: after each round: a coordinate whose Sophia ratio ``m / (rho h)``
#: passed near the clip in a step, where it scales the grads' order
#: error up)
ROUND_OUT, ROUND_OUT_RTOL = 4, 1e-4


def _round_band(got, want, name, flip, msg):
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    diff = np.abs(got - want)
    out = diff > base.ATOL + base.RTOL * np.abs(want)
    assert int(out.sum()) <= ROUND_OUT, (msg, int(out.sum()))
    assert np.all(diff[out] <= base.ATOL + ROUND_OUT_RTOL
                  * np.abs(want[out])), (msg, float(diff.max()))


@pytest.mark.parametrize("arch", [VLM, ENC])
def test_embeds_rounds_match_jitted_jax(arch):
    """Two parallel Fed-Sophia rounds at fp32 on embeds batches against
    ``jax.jit(FedEngine.round)``, in the engine band but for
    `ROUND_OUT` coordinates a buffer.  hubert-xlarge's ``embed`` gets
    zero grads and zero curvature: its m and h stay exactly 0 in every
    client's buffer (as JAX's ``jax.grad`` zeros give)."""
    teng, tstate = base.rounds_vs_jitted_jax(arch, "parallel", "float32",
                                             fp32_band=_round_band)
    if arch == ENC:
        spec = teng.runtime_for(tstate["params"]).spec
        i = list(spec.keys).index("embed")
        coords = tflat.leaf_coords(spec, "embed", 0, spec.shapes[i][-1])
        assert coords.numel() == spec.sizes[i]
        for buf in (tstate["client_opt"].m, tstate["client_opt"].h):
            flat = buf.reshape(buf.shape[0], -1)
            assert not flat[:, coords].any()
            assert flat.any()


def test_gnb_and_done_give_an_unreached_leaf_zeros():
    """The three grad sites of an untied embedding-input model: the loss
    / grad boundary and the GNB estimate (`gnb.leaf_grads`), and DONE's
    double backward (Hessian-vector products through the grads that
    have a graph): finite, and zero on ``embed``."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.fed import FedEngine
    from repro_torch.core.gnb import gnb_estimate
    _, tcfg = _cfgs(ENC, "float32")
    task = TT.LMTask(tcfg)
    params = task.init(torch.Generator().manual_seed(0), "cpu")
    _, tb = _embeds(tcfg, seed=3, lead=(2,))
    stacked = {k: torch.stack([v, v]) for k, v in params.items()}
    h = gnb_estimate(task, stacked, tb, torch.zeros(
        (2,) + task.gumbel_shape(tb)))
    assert not h["embed"].any() and h["lm_head"].any()
    eng = FedEngine(task, FedConfig(num_clients=2, local_iters=1, lr=1.0,
                                    optimizer="done",
                                    done_richardson_iters=2),
                    device="cpu")
    state = eng.pack_state(eng.init_from_params(params))
    spec = eng.runtime_for(state["params"]).spec
    before = tflat.unpack(state["params"].clone(), spec)
    state, m = eng.round(state, tb, generator=torch.Generator().manual_seed(1))
    after = tflat.unpack(state["params"], spec)
    assert np.isfinite(float(m["loss"]))
    assert torch.equal(after["embed"], before["embed"])
    assert not torch.equal(after["lm_head"], before["lm_head"])


# ------------------------------------------------------------------- CLI
C, J, TAU, CB, CS, ROUNDS, SEED = 2, 2, 2, 2, 16, 2, 0


def _jax_hooks(arch):
    """The JAX CLI's weights, embeds batches and GNB draws, in the port
    CLI's ``hooks`` format."""
    cfg = jconfigs.get_model_config(arch).reduced(d_model=128)
    key = jax.random.PRNGKey(SEED)

    def batches(r):
        kb = jax.random.fold_in(key, 1000 + r)
        jb = jsyn.make_token_batch(kb, C, CB, CS, cfg.vocab_size)
        jb = {"embeds": jax.random.normal(
            jax.random.fold_in(kb, 1), (C, CB, CS, cfg.d_model),
            dtype=JT.param_dtype(cfg)), "labels": jb["labels"]}
        return convert.params_from_numpy(jax.tree.map(np.asarray, jb),
                                         "cpu")

    def gumbel(r):
        rng = jax.random.fold_in(key, r)
        return {"gumbel": torch.from_numpy(np.stack([np.stack([np.asarray(
            jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(rng, i),
                                                 j),
                              (CB, CS, cfg.vocab_padded), jnp.float32))
            for j in range(J)]) for i in range(C)]))}

    return {"params": jax.tree.map(np.asarray, JT.init_lm(key, cfg)),
            "batches": batches, "round_kwargs": gumbel}


@pytest.mark.parametrize("arch", [VLM, ENC])
def test_cli_trains_on_embeds_as_jax(arch, tmp_path, monkeypatch):
    """Both trainer CLIs, ``--reduced``, on the JAX CLI's embeds batches
    (the port's through the ``batches`` hook): round records equal but
    the losses (``rtol=1e-3``) and timings; the port's own embeds
    batches (no hook) train too, with an int8 uplink."""
    argv = ["--arch", arch, "--reduced", "--clients", str(C),
            "--local-iters", str(J), "--tau", str(TAU), "--batch", str(CB),
            "--seq", str(CS), "--seed", str(SEED), "--rounds", str(ROUNDS)]
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--obs-log", str(tmp_path / "jax.jsonl")])
    jtrain.main()
    res = ttrain.main(argv + ["--device", "cpu", "--obs-log",
                              str(tmp_path / "port.jsonl")],
                      hooks=_jax_hooks(arch))
    want = [r for r in jlogio.read_records(str(tmp_path / "jax.jsonl"))
            if r["record"] == "round"]
    got = [r for r in res["records"] if r["record"] == "round"]
    assert len(got) == len(want) == ROUNDS
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        np.testing.assert_allclose(g.pop("loss"), w.pop("loss"), rtol=1e-3)
        g.pop("wall_s"), w.pop("wall_s")
        assert g == w
    own = ttrain.main(argv + ["--device", "cpu", "--compressor", "int8"])
    assert all(np.isfinite(own["losses"]))
