"""MLA attention and the MoE FFN of the port against the JAX package's,
at a reduced size: deepseek-v2-lite-16b (MLA, MoE with a shared expert)
and qwen3-moe-235b-a22b (GQA with qk-norm, MoE without shared experts),
``reduced(d_model=128)``, 2 layers, seq 16-24, the same inputs (numpy,
seeded) into both.  The helpers, bands and engine loop come from
tests/test_torch_lm.py.

Bands, as there: fp32 ``rtol=1e-5, atol=1e-6`` (outputs above 1 with
``atol`` times their largest magnitude); bf16 outputs within 2^-6 of
their largest magnitude, the loss ``rtol=1e-3``, grads 2^-5 of each
leaf's largest magnitude; engine rounds by the engine band at fp32 and
`_bf16_band` at bf16.  Routing is held exactly: the layer tests feed
identical inputs to both packages and assert identical ``expert_idx``
and keep masks (also past an expert's capacity and at exact ties of the
router's probabilities).

Routing near-ties.  XLA and torch compute the router's logits ulps apart
(at bf16 parameters, from hidden states a bf16 step apart), so a token
at a near-tie of its K-th and (K+1)-th expert may route differently.
The whole-model and engine comparisons record both packages' top-k
choices (`recorded_routes`), count the flipped (token, k) choices and
print each one's margin, the gap in probability between the two
experts (the engine rounds at each round's start, every round starting
both engines from JAX's state).  A token's first flip (its earlier
layers agree) at a margin above `FLIP_MARGIN` of its top probability
(1e-5 at fp32, the outputs' band 2^-6 at bf16) is a fault; later
layers' flips of the same token follow from its first.  In the engine
rounds the embedding rows of tokens whose choices flipped at the
round's start are left out of the state comparison (a flipped token's
whole gradient changes); every other coordinate is held to the band.
The whole-model forward, loss, grads and GNB loss are compared with
JAX's own choices injected into the port (`injected_routes`, through
`layers.moe_route`'s ``expert_idx`` seam), after the free forwards'
flips are counted: a near-tie flip then decides no comparison.
At bf16 the choices also flip inside the round (from the second local
step's params, a bf16 step apart, and GNB labels sampled at near-ties
of the logits), and a flipped token moves the gradient of every token
it attends to: the embedding rows of the round's tokens (a row's
gradient is its few positions' own) may leave the band, in at most
`EMBED_ROWS_OUT` rows a buffer, and every other leaf is held to
`_bf16_band` (measured on the CPU: 21 rows of m and 6 of h after
deepseek's first round, 1 and 9 after its second; every other leaf
inside the band).

Sophia's clip at m near 0.  An expert's weight whose gradient cancels to
near zero (few tokens reach an expert) has m and h at the order error of
the GEMMs, and ``clip(m / max(rho * h, eps), 1)`` then follows the sign
of that error: at fp32 `CLIP_FLIPS` parameter coordinates a buffer may
leave the engine band, each within a flipped clipped step (measured on
the CPU: 2 of 514,048 after deepseek's first round, where one client's
m is -5.8e-10 in JAX and +6.7e-11 in the port).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro.checkpoint import ckpt as jckpt
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.comm import flat as tflat
from repro_torch.configs.base import FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_lm import (ATOL, MOE, RTOL, B, S, _batch, _cfgs, _close,
                           _loss_grads, _params, _t)

DEEPSEEK, QWEN_MOE = MOE
#: a token's first flipped choice is a fault above this share of its top
#: probability: the order error of fp32 GEMMs; at bf16 the band of the
#: outputs (2^-6 of their largest magnitude), which the hidden states
#: feeding the router keep
FLIP_MARGIN = {"float32": 1e-5, "bfloat16": 2 ** -6}
#: fp32 engine rounds: parameter coordinates a buffer allowed out of the
#: band at a flipped Sophia clip (module docstring)
CLIP_FLIPS = 4
#: bf16 engine rounds: embedding rows a buffer allowed out of the band,
#: each a token of the round's batches (module docstring)
EMBED_ROWS_OUT = 32


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _pos(n):
    return np.broadcast_to(np.arange(n), (B, n))


def _bf16_close(got, want, msg=""):
    """bf16 outputs: within 2^-6 of their largest magnitude."""
    want = np.asarray(want, np.float32)
    _close(got.float(), want, rtol=0,
           atol=2 ** -6 * max(1.0, float(np.abs(want).max())), msg=msg)


# ----------------------------------------------------- routing records
@contextlib.contextmanager
def recorded_routes():
    """Record ``(probs, expert_idx)`` of every top-k call of both
    packages' MoE layers while inside: yields the (JAX, port) lists."""
    jrec, trec = [], []
    jtop, ttop = jax.lax.top_k, TL.top_k

    def jax_top_k(x, k):
        v, i = jtop(x, k)
        jax.debug.callback(
            lambda p, e: jrec.append((np.asarray(p), np.asarray(e))), x, i)
        return v, i

    def port_top_k(x, k):
        v, i = ttop(x, k)
        trec.append((x.detach().float().numpy(), i.numpy()))
        return v, i
    jax.lax.top_k, TL.top_k = jax_top_k, port_top_k
    try:
        yield jrec, trec
    finally:
        jax.lax.top_k, TL.top_k = jtop, ttop


class injected_routes:
    """While inside, the port's MoE layers route by ``choices`` (the JAX
    package's ``expert_idx`` of one forward, a layer each), through
    `layers.moe_route`'s seam: call ``i`` takes ``choices[i % len]``, so
    each forward from the same params and batch (the loss, its grads,
    the GNB loss) routes as JAX's did.  Reusable."""

    def __init__(self, choices):
        self.choices = [torch.from_numpy(np.asarray(c).astype(np.int64))
                        for c in choices]

    def __enter__(self):
        route, calls = TL.moe_route, iter(range(10 ** 9))

        def injected(cfg, probs, expert_idx=None):
            idx = self.choices[next(calls) % len(self.choices)]
            return route(cfg, probs, expert_idx=idx.reshape(
                probs.shape[:-1] + idx.shape[-1:]))
        self.route, TL.moe_route = route, injected
        return self

    def __exit__(self, *exc):
        TL.moe_route = self.route


def route_flips(jrec, trec, dtype, label):
    """The (token, k) choices that differ between the packages' records
    of one forward each, printed with their margins.  Asserts the
    near-tie rule (module docstring).  Returns the flipped token
    positions ``(*lead, b, s)``."""
    assert len(jrec) == len(trec) > 0, (len(jrec), len(trec))
    flipped, faults = set(), []
    for call, ((_, ji), (tp, ti)) in enumerate(zip(jrec, trec)):
        ji = ji.reshape(ti.shape)
        tp = tp.reshape(ti.shape[:-1] + tp.shape[-1:])
        rows = np.nonzero(np.any(np.sort(ji, -1) != np.sort(ti, -1), -1))
        for tok in zip(*(r.tolist() for r in rows)):
            js, ts = set(ji[tok].tolist()), set(ti[tok].tolist())
            top = float(tp[tok].max())
            for a, b in zip(sorted(js - ts), sorted(ts - js)):
                margin = abs(float(tp[tok][a]) - float(tp[tok][b]))
                first = tok not in flipped
                print(f"{label}: layer {call}, token {tok}: JAX expert {a}"
                      f", port expert {b}, margin {margin:.3g} of top "
                      f"{top:.3g}" + ("" if first else " (follows)"))
                if first and margin > FLIP_MARGIN[dtype] * top:
                    faults.append((call, tok, margin, top))
            flipped.add(tok)
    print(f"{label}: {len(flipped)} tokens with flipped choices")
    assert not faults, faults
    return flipped


def _jax_route(jcfg, probs):
    """The JAX package's routing bookkeeping (``moe_apply``,
    layers.py:473-488), run on ``probs``: (expert_idx, combine)."""
    mo = jcfg.moe
    Bn, Sn, E = probs.shape
    K = mo.top_k
    C = max(int(Sn * K / E * mo.capacity_factor), 1)
    gate, idx = jax.lax.top_k(probs, K)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    combine = jnp.zeros((Bn, Sn, E, C), jnp.float32)
    fill = jnp.zeros((Bn, E), jnp.float32)
    for kk in range(K):
        mask_k = jax.nn.one_hot(idx[:, :, kk], E)
        pos = jnp.cumsum(mask_k, axis=1) - mask_k + fill[:, None, :]
        keep = (pos < C) * mask_k
        slot = jax.nn.one_hot(pos.astype(jnp.int32), C)
        combine = combine + gate[:, :, kk, None, None] * keep[..., None] * slot
        fill = fill + jnp.sum(mask_k, axis=1)
    return np.asarray(idx), np.asarray(combine)


# --------------------------------------------------------------- MLA
def _mla_weights(jcfg, seed):
    p = JL.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rs = np.random.RandomState(seed)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["kv_norm"] = (p["kv_norm"] * (1.0 + 0.2 * rs.randn(*p["kv_norm"].shape))
                    ).astype(np.float32)
    return p


def _in(a, dtype):
    """numpy fp32 -> (jax, torch) arrays of ``dtype``, the same values."""
    return (jnp.asarray(a).astype(dtype),
            _t(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_jax(dtype):
    """deepseek's MLA block: q per head with a RoPE part, k and v from
    the kv_norm-ed latent, the RoPE key shared by the heads, scale
    1/sqrt(nope + rope), v's head dim (32) below q/k's (48).  At fp32
    also with the weights of two clients stacked."""
    jcfg, tcfg = _cfgs(DEEPSEEK, dtype)
    m = tcfg.mla
    assert m.v_head_dim != m.qk_nope_head_dim + m.qk_rope_head_dim
    rs = np.random.RandomState(11)
    outs, clients = [], []
    for seed in (1, 2):
        p = _mla_weights(jcfg, seed)
        x = rs.randn(B, S, tcfg.d_model).astype(np.float32)
        jp = {k: _in(v, dtype)[0] for k, v in p.items()}
        tp = {k: _in(v, dtype)[1] for k, v in p.items()}
        want, _ = JL.mla_apply(jp, jcfg, _in(x, dtype)[0],
                               jnp.asarray(_pos(S)))
        got = TL.mla_apply(tp, tcfg, _in(x, dtype)[1], torch.tensor(_pos(S)))
        assert got.dtype == getattr(torch, dtype)
        if dtype == "float32":
            _close(got, want)
        else:
            _bf16_close(got, want)
        outs.append(got)
        clients.append((tp, _in(x, dtype)[1]))
    if dtype == "float32":
        stacked = {k: torch.stack([c[0][k] for c in clients])
                   for k in clients[0][0]}
        both = TL.mla_apply(stacked, tcfg,
                            torch.stack([c[1] for c in clients]),
                            torch.tensor(_pos(S)))
        for i, got in enumerate(outs):
            _close(both[i], got)
    tp = TL.init_mla(torch.Generator().manual_seed(0), tcfg,
                     getattr(torch, dtype))
    jshapes = jax.eval_shape(lambda: JL.init_mla(jax.random.PRNGKey(0),
                                                 jcfg, jnp.dtype(dtype)))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jshapes.items()}
    np.testing.assert_array_equal(tp["kv_norm"].float().numpy(), 1.0)


def test_mla_chunking_follows_the_module_not_the_config(monkeypatch):
    """MLA calls `attention` without the config's ``attn_chunk_threshold``
    / ``attn_kv_chunk`` (the GQA block passes them): with the config's
    threshold below S the MLA block is bitwise its dense self, where
    qwen3-moe's GQA block moves to the chunked route.  With the modules'
    own threshold below S both packages take the chunked route for MLA,
    v's head dim unlike q/k's, a ragged last chunk."""
    jcfg, tcfg = _cfgs(DEEPSEEK, "float32")
    p = _mla_weights(jcfg, 3)
    x = np.random.RandomState(12).randn(B, S, tcfg.d_model).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    pos = torch.tensor(_pos(S))
    dense = TL.mla_apply(tp, tcfg, _t(x), pos)
    low = dict(attn_chunk_threshold=8, attn_kv_chunk=16)
    assert S > 8
    np.testing.assert_array_equal(
        TL.mla_apply(tp, dataclasses.replace(tcfg, **low), _t(x),
                     pos).numpy(), dense.numpy())
    qj, qt = _cfgs(QWEN_MOE, "float32")
    qp = {k: _t(np.asarray(v)) for k, v in JL.init_attention(
        jax.random.PRNGKey(3), qj, jnp.float32).items()}
    gqa = TL.attention_apply(qp, qt, _t(x), pos, kind="attn")
    gqa_low = TL.attention_apply(qp, dataclasses.replace(qt, **low), _t(x),
                                 pos, kind="attn")
    assert not torch.equal(gqa, gqa_low)
    _close(gqa_low, gqa, atol=2e-6)

    for mod in (JL, TL):
        monkeypatch.setattr(mod, "CHUNK_ATTN_THRESHOLD", 8)
        monkeypatch.setattr(mod, "KV_CHUNK", 16)
    got = TL.mla_apply(tp, tcfg, _t(x), pos)
    want, _ = JL.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(_pos(S)))
    assert not torch.equal(got, dense)
    _close(got, want)
    _close(got, dense, atol=2e-6)


# --------------------------------------------------------------- MoE
def test_top_k_is_jax_top_k_with_ties():
    """Descending order, ties to the lower index, on rows full of exact
    ties."""
    x = np.random.RandomState(0).randint(0, 4, (64, 8)).astype(np.float32)
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TL.top_k(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_route_seam_changes_no_bit(dtype):
    """`layers.moe_route` given the top-k's own choices (the seam the
    whole-model tests inject JAX's through) routes as without them: the
    same indices and combine weights, and a forward through
    `injected_routes` of the port's own choices is bitwise the free
    one's."""
    jcfg, tcfg = _cfgs(DEEPSEEK, dtype)
    probs = torch.softmax(_t(np.random.RandomState(3).randn(
        B, S, tcfg.moe.num_experts).astype(np.float32)), -1)
    idx, comb = TL.moe_route(tcfg, probs)
    idx2, comb2 = TL.moe_route(tcfg, probs, expert_idx=idx)
    assert torch.equal(idx, idx2) and torch.equal(comb, comb2)
    _, tp = _params(jcfg)
    _, tb = _batch(jcfg.vocab_size)
    with recorded_routes() as (_, trec):
        free, _, aux = TT.forward(tp, tcfg, tb)
    with injected_routes([i for _, i in trec]):
        fixed, _, aux2 = TT.forward(tp, tcfg, tb)
    assert torch.equal(free, fixed) and torch.equal(aux, aux2)


def _moe_case(case, jcfg, dtype, seed=4):
    """MoE weights (JAX init, numpy) and an input ``x`` for ``case``:
    ``random``; ``overflow``, every token's first choice expert 0, past
    its capacity; ``ties``, experts 1 and 2 with one router column, so
    their probabilities tie exactly."""
    p = JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    p = convert.flatten(jax.tree.map(np.asarray, p))
    x = np.random.RandomState(seed).randn(B, S, jcfg.d_model).astype(
        np.float32)
    router = np.array(p["router"])
    if case == "overflow":
        x[..., 0] = 3.0
        router[0, 0] = 5.0
    elif case == "ties":
        router[:, 2] = router[:, 1]
    p["router"] = router
    return p, x


@pytest.mark.parametrize("case", ["random", "overflow", "ties"])
@pytest.mark.parametrize("arch,dtype", [(DEEPSEEK, "float32"),
                                        (DEEPSEEK, "bfloat16"),
                                        (QWEN_MOE, "float32")])
def test_moe_apply_matches_jax(arch, dtype, case):
    """The MoE FFN: identical routing (top-k indices, keep masks, capacity
    slots), the output, the aux loss; the router fp32 in a bf16 model,
    applied to ``x`` cast to fp32."""
    jcfg, tcfg = _cfgs(arch, dtype)
    p, x = _moe_case(case, jcfg, dtype)
    assert p["router"].dtype == np.float32
    jp = convert.nest({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: _t(v.astype(np.float32)).to(
        torch.float32 if k == "router" else getattr(torch, dtype))
        for k, v in p.items()}
    jx, tx = _in(x, dtype)
    want, jaux = JL.moe_apply(jp, jcfg, jx)
    got, taux = TL.moe_apply(tp, tcfg, tx)
    assert got.dtype == tx.dtype and taux.dtype == torch.float32
    # routing, from each package's own router probabilities
    jprobs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"], axis=-1)
    tprobs = torch.softmax(TL.matmul(tx.float(), tp["router"]), dim=-1)
    _close(tprobs, jprobs)
    jidx, jcomb = _jax_route(jcfg, jprobs)
    tidx, tcomb = TL.moe_route(tcfg, tprobs)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tcomb.numpy() > 0, jcomb > 0)
    _close(tcomb, jcomb)
    K = tcfg.moe.top_k
    if case == "overflow":
        # expert 0 keeps its capacity C of each row's S first choices
        C = int(S * K / tcfg.moe.num_experts * tcfg.moe.capacity_factor)
        assert np.all(jidx[..., 0] == 0) and C < S
        assert int((jcomb[..., 0, :] > 0).sum()) == B * C
    if case == "ties":
        pr = tprobs.numpy()
        assert np.array_equal(pr[..., 1], pr[..., 2])
        # the tie decides a choice: expert 1 in, expert 2 out
        cut = (np.sum(pr > pr[..., 1:2], -1) == K - 1)
        assert cut.any() and np.all(np.any(jidx[cut] == 1, -1))
        assert not np.any(jidx[cut] == 2)
    _close(taux, jaux)
    if dtype == "float32":
        _close(got, want)
    else:
        _bf16_close(got, want)


def test_moe_client_axis_and_init():
    """Weights of two clients stacked: each client's output and aux are
    its own; the aux comes back ``(N,)``.  The port's init: the router
    fp32 in a bf16 model, experts stacked ``(E, d_in, d_out)``, the
    shared experts under ``shared/``, the JAX package's shapes."""
    jcfg, tcfg = _cfgs(DEEPSEEK, "float32")
    outs, clients = [], []
    for seed in (5, 6):
        p, x = _moe_case("random", jcfg, "float32", seed)
        tp = {k: _t(v) for k, v in p.items()}
        outs.append(TL.moe_apply(tp, tcfg, _t(x)))
        clients.append((tp, _t(x)))
    stacked = {k: torch.stack([c[0][k] for c in clients])
               for k in clients[0][0]}
    out, aux = TL.moe_apply(stacked, tcfg,
                            torch.stack([c[1] for c in clients]))
    assert aux.shape == (2,)
    for i, (o, a) in enumerate(outs):
        _close(out[i], o)
        _close(aux[i], a)
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tp = TL.init_moe(torch.Generator().manual_seed(0), bcfg, torch.bfloat16)
    jshapes = convert.flatten(jax.eval_shape(lambda: JL.init_moe(
        jax.random.PRNGKey(0), jcfg, jnp.bfloat16)))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tp.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jshapes.items()}
    assert tp["router"].dtype == torch.float32
    assert {"shared/w_gate", "shared/w_up", "shared/w_down"} <= set(tp)


# ---------------------------------------------------- model and loss
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_grads_sampled_loss_match_jax(arch, dtype):
    """tests/test_torch_lm.py's whole-model check on the MoE archs, after
    the routing of both forwards is compared (`route_flips`): the
    logits, the aux loss (summed over the layers), the loss with it,
    every grad leaf, the GNB inner loss with JAX's own categorical draw
    injected.  These port forwards route by JAX's own choices
    (`injected_routes`, the seam of `layers.moe_route`), so that a
    near-tie the packages break apart (the bf16 deepseek's layer 1, at
    a margin of 0.000449 of top 0.388) cannot decide the comparison.  At
    fp32 a grad leaf whose largest magnitude is above 1 (deepseek's
    embedding, 1.19) takes ``atol`` times it, as the logits do."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg)
    jb, tb = _batch(jcfg.vocab_size)
    jt, tt = JT.LMTask(jcfg), TT.LMTask(tcfg)
    fp32 = dtype == "float32"
    with recorded_routes() as (jrec, trec):
        jl, _, jaux = JT.forward(jp, jcfg, jb)
        TT.forward(tp, tcfg, tb)
    assert len(trec) == tcfg.num_layers
    route_flips(jrec, trec, dtype, f"{arch} {dtype} forward")
    routes = injected_routes([i for _, i in jrec])
    with routes:
        tl, _, taux = TT.forward(tp, tcfg, tb)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert taux.shape == () and taux.dtype == torch.float32
    _close(taux, jaux, rtol=RTOL if fp32 else 1e-3)
    top = float(np.abs(np.asarray(jl)).max())
    _close(tl, jl, atol=(ATOL if fp32 else 2 ** -6) * max(1.0, top))
    jloss, jg = jax.value_and_grad(jt.loss)(jp, jb)
    with routes:
        tloss, tg = _loss_grads(tt, tp, tb)
    _close(tloss, jloss, rtol=RTOL if fp32 else 1e-3)
    jg = convert.flatten(jax.tree.map(np.asarray, jg))
    assert sorted(jg) == sorted(tg)
    for k, g in tg.items():
        want = np.asarray(jg[k], np.float32)
        big = float(np.abs(want).max())
        assert g.dtype == tp[k].dtype
        if fp32:
            _close(g, want, atol=ATOL * max(1.0, big), msg=k)
        else:
            _close(g.float(), want, rtol=0, atol=2 ** -5 * big, msg=k)
    key = jax.random.PRNGKey(9)
    gum = np.array(jax.random.gumbel(key, tl.shape, jnp.float32))
    jy = np.asarray(JT.sample_labels(key, jl, jcfg.vocab_size))
    ty = TT.sample_labels(tl.detach(), tcfg.vocab_size,
                          torch.from_numpy(gum)).numpy()
    want = jt.sampled_loss(jp, jb, key)
    if fp32:
        np.testing.assert_array_equal(ty, jy)
        with routes:
            _close(tt.sampled_loss(tp, tb, torch.from_numpy(gum)), want)
    else:
        z = np.asarray(jl, np.float32) + gum
        gap = (np.take_along_axis(z, jy[..., None], -1)
               - np.take_along_axis(z, ty[..., None], -1))
        assert np.all(gap <= 2 * 2 ** -6 * max(1.0, top)), gap.max()
        _close(TT.cross_entropy(tl, torch.from_numpy(np.array(jy)),
                                tcfg.vocab_size) + taux, want, rtol=1e-3)


def test_dense_configs_have_no_aux_loss():
    """A dense FFN adds nothing to the loss: forward's aux is None and
    the loss is the cross-entropy itself, bit for bit."""
    _, tcfg = _cfgs("minicpm-2b", "float32")
    task = TT.LMTask(tcfg)
    params = task.init(torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(tcfg.vocab_size)
    logits, _, aux = TT.forward(params, tcfg, tb)
    assert aux is None
    assert torch.equal(task.loss(params, tb), TT.cross_entropy(
        logits, tb["labels"], tcfg.vocab_size))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_tree_packs_bitwise_as_jax(arch, dtype):
    """tests/test_torch_lm.py's packing check on the MoE and MLA trees
    (stacked experts ``(L, E, D, F)``, ``ffn/shared/...``, ``mixer/
    w_dkv``, ``kv_norm``, ``w_ukv``), the router leaves fp32 in the spec,
    the unpacked views and the nested numpy tree; `convert.flatten` /
    `nest` round-trip the JAX tree."""
    base.test_lm_tree_packs_bitwise_as_jax(arch, dtype)
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, seed=3)
    mo, L, D = tcfg.moe, tcfg.num_layers, tcfg.d_model
    assert tuple(tp["blocks_0/ffn/w_gate"].shape) == (L, mo.num_experts, D,
                                                      mo.d_ff_expert)
    want = {"blocks_0/ffn/router", "blocks_0/ffn/w_down"}
    if tcfg.mla is not None:
        want |= {"blocks_0/ffn/shared/w_up", "blocks_0/mixer/w_dkv",
                 "blocks_0/mixer/kv_norm", "blocks_0/mixer/w_ukv"}
    assert want <= set(tp)
    spec = tflat.flat_spec(tp)
    back = tflat.unpack(tflat.pack(tp, spec), spec)
    nested = convert.params_to_numpy(tp)
    for k in tp:
        router = k.endswith("/router")
        assert (spec.dtypes[spec.keys.index(k)] == torch.float32) or \
            not router
        if router:
            assert back[k].dtype == torch.float32
            assert nested["blocks_0"]["ffn"]["router"].dtype == np.float32
    jnp_tree = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(convert.nest(convert.flatten(jnp_tree))) == \
        jax.tree.structure(jnp_tree)


def test_client_axis_is_a_batch_of_independent_models():
    """deepseek (MLA and MoE) with a leading client axis: each client
    gets the loss (with its own aux) and the grads of its own model and
    batch."""
    _, tcfg = _cfgs(DEEPSEEK, "float32")
    task = TT.LMTask(tcfg)
    ps = [task.init(torch.Generator().manual_seed(s), "cpu")
          for s in (0, 1, 2)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    _, tb = _batch(tcfg.vocab_size, seed=5, lead=(3,))
    loss, grads = _loss_grads(task, stacked, tb)
    _, _, aux = TT.forward(stacked, tcfg, tb)
    assert loss.shape == aux.shape == (3,)
    for i, p in enumerate(ps):
        bi = {k: v[i] for k, v in tb.items()}
        li, gi = _loss_grads(task, p, bi)
        _close(loss[i], li)
        _close(aux[i], TT.forward(p, tcfg, bi)[2])
        for k, g in gi.items():
            _close(grads[k][i], g, msg=k)


# ------------------------------------------------------- checkpoints
def test_checkpoint_of_bf16_deepseek_reads_both_ways(tmp_path):
    """The reduced bf16 deepseek's params: the port's checkpoint read by
    the JAX package and JAX's by the port, bitwise, with the routers'
    logical dtype float32 in both manifests."""
    jcfg, _ = _cfgs(DEEPSEEK, "bfloat16")
    jp, tp = _params(jcfg, seed=6)
    tckpt.save(str(tmp_path / "port"), tp, step=2)
    jckpt.save(str(tmp_path / "jax"), jp, step=2)
    manifest = tckpt.load_manifest(str(tmp_path / "port"))
    assert manifest == jckpt.load_manifest(str(tmp_path / "jax"))
    assert manifest["dtypes"]["blocks_0/ffn/router"] == "float32"
    assert manifest["dtypes"]["blocks_0/ffn/w_gate"] == "bfloat16"
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


# ------------------------------------------------------- engine rounds
def _embed_rows(spec, rows):
    """Flat coordinates of the ``embed`` rows ``rows`` in ``spec``'s
    layout."""
    i = spec.keys.index("embed")
    off, D = sum(spec.sizes[:i]), spec.shapes[i][1]
    return np.concatenate([np.arange(off + r * D, off + (r + 1) * D)
                           for r in sorted(rows)] or [np.zeros(0, int)])


def _masked(a, b, coords):
    """``a``, ``b`` flattened, ``b`` taking ``a``'s values at
    ``coords`` (per leading index: a list of coordinate arrays)."""
    a = np.asarray(a, np.float32).copy()
    b = np.asarray(b, np.float32).copy()
    a2, b2 = a.reshape(len(coords), -1), b.reshape(len(coords), -1)
    for i, c in enumerate(coords):
        b2[i, c] = a2[i, c]
    return a, b


def _embed_rows_out(spec, a, b, name, seen):
    """The embedding rows of the port's ``b`` outside `_bf16_band`'s
    band around JAX's ``a``, counted over the leading indices; asserts
    each is a row of a token of that index's batch (``seen``: the rows'
    coordinates; for the server params, any client's)."""
    n = len(seen) if name != "params" else 1
    a2, b2 = a.reshape(n, -1), b.reshape(n, -1)
    diff = np.abs(b2 - a2)
    out = (diff > 2 ** -5 * float(np.abs(a).max()) if name != "params" else
           diff > base.BF16_ATOL + 2 ** -8 * np.abs(a2))
    emb = _embed_rows(spec, range(spec.shapes[spec.keys.index("embed")][0]))
    D = spec.shapes[spec.keys.index("embed")][1]
    rows = 0
    for i in range(n):
        bad = emb[out[i, emb]]
        ok = np.concatenate(seen) if name == "params" else seen[i]
        assert np.isin(bad, ok).all(), (name, i)
        rows += len(np.unique((bad - emb[0]) // D))
    return rows


def moe_rounds_vs_jitted_jax(arch, strategy, dtype):
    """`base.ROUNDS` engine rounds of the reduced MoE ``arch`` against
    ``jax.jit(FedEngine.round)`` (tests/test_torch_lm.py's loop), each
    round from the same state: after a round both engines go on from
    JAX's (a clip flipped in one round moves the next round's grads
    near it by ~1e-4 of their size, past the fp32 band).  Before each
    round both packages' forwards of each client's batch at that state
    are compared by `route_flips`; the embedding rows of the flipped
    tokens are left out of that round's state comparison; every other
    coordinate is held to the engine's bands (fp32: the engine band,
    with `CLIP_FLIPS` parameter coordinates at a flipped clipped step;
    bf16: `_bf16_band`)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    kw = dict(num_clients=base.C, local_iters=base.J, tau=base.TAU,
              lr=1e-3, schedule="wsd", total_rounds=4, strategy=strategy)
    jeng = base.JFedEngine(JT.LMTask(jcfg),
                           base.JFedConfig(use_pallas=True, **kw))
    teng = FedEngine(TT.LMTask(tcfg), FedConfig(**kw), device="cpu")
    key = jax.random.PRNGKey(0)
    jstate = jeng.init(jax.random.fold_in(key, 3))
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    spec = tflat.flat_spec(tstate["params"])
    jstate, tstate = jeng.pack_state(jstate), teng.pack_state(tstate)
    jround = jax.jit(jeng.round)
    fp32 = dtype == "float32"
    flip = 2 * kw["lr"] * base.J / base.C
    for r in range(base.ROUNDS):
        jb = base.jsyn.make_token_batch(jax.random.fold_in(key, 100 + r),
                                        base.C, base.EB, base.ES,
                                        jcfg.vocab_size)
        tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
        jparams, tparams = (jeng.unpack_params(jstate),
                            teng.unpack_params(tstate))
        rows = []
        for c in range(base.C):
            with recorded_routes() as (jrec, trec):
                JT.forward(jparams, jcfg, {"tokens": jb["tokens"][c]})
                TT.forward(tparams, tcfg, {"tokens": tb["tokens"][c]})
            toks = route_flips(jrec, trec, dtype,
                               f"{arch} {strategy} {dtype} round {r} "
                               f"client {c}")
            rows.append({int(tb["tokens"][c][t]) for t in toks})
        every = _embed_rows(spec, set().union(*rows))
        each = [_embed_rows(spec, rw) for rw in rows]
        rng = jax.random.fold_in(key, 1000 + r)
        jstate, jm = jround(jstate, jb, rng)
        tstate, tm = teng.round(tstate, tb, gumbel=torch.from_numpy(
            base._gumbel(rng, jcfg.vocab_padded)))
        assert tm["total_bytes"] == int(jm["total_bytes"])
        _close(tm["loss"], jm["loss"], rtol=RTOL if fp32 else 1e-3)
        got = jax.tree.map(np.asarray, jstate)
        want = convert.state_to_numpy(tstate)
        seen = [_embed_rows(spec, set(np.unique(t.numpy()).tolist()))
                for t in tb["tokens"]]
        for name, a, b, coords in (
                ("params", got["params"], want["params"], [every]),
                ("m", got["client_opt"].m, want["client_opt"]["m"], each),
                ("h", got["client_opt"].h, want["client_opt"]["h"], each)):
            a, b = _masked(a, b, coords)
            msg = f"round {r} {name}"
            if not fp32:
                n_out = _embed_rows_out(spec, a, b, name, seen)
                print(f"{msg}: {n_out} embedding rows out of the band")
                assert n_out <= EMBED_ROWS_OUT, (msg, n_out)
                a, b = _masked(a, b, [np.concatenate(seen)] * len(coords))
                base._bf16_band(b, a, name, flip, msg)
                continue
            if name != "params":
                _close(b, a, msg=msg)
                continue
            diff = np.abs(b - a)
            out = diff > ATOL + RTOL * np.abs(a)
            print(f"{msg}: {int(out.sum())} coordinates at a flipped clip")
            assert int(out.sum()) <= CLIP_FLIPS, (msg, int(out.sum()))
            assert np.all(diff <= flip), (msg, diff.max())
        # the next round starts both engines from JAX's state
        tstate = teng.pack_state(convert.state_from_numpy(got, "cpu"))


@pytest.mark.parametrize("arch,strategy,dtype", [
    (DEEPSEEK, "sequential", "float32"), (DEEPSEEK, "parallel", "float32"),
    (DEEPSEEK, "sequential", "bfloat16"), (QWEN_MOE, "sequential",
                                           "float32")])
def test_moe_rounds_match_jitted_jax(arch, strategy, dtype):
    moe_rounds_vs_jitted_jax(arch, strategy, dtype)
