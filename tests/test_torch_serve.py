"""The serving path of the port against the JAX package's, at a reduced
size (``reduced(d_model=128)``, fp32 but for the CLI runs, prompts of
8-24 tokens): every cache kind through ``forward(want_cache=True)``,
`prefill_to_decode_cache` and three `decode_step`s, the same numpy
inputs and converted weights into both packages, the caches compared
leaf by leaf (`convert.cache_from_numpy`); `write_slot`'s clamp against
``jax.lax.dynamic_update_slice``; decode against the full forward within
the port (the JAX package's own invariant, tests/test_models.py); the
serve CLIs with the JAX CLI's draws injected.

Cases, one a cache kind: GQA with qk-norm (qwen3-14b); gemma2-9b's
rolling ``local`` buffer beside its ``global`` cache, both softcaps, the
window (16) above, at and below the prompt (8, 16, 24 tokens); MLA with
the MoE FFN (deepseek-v2-lite-16b); RG-LRU (recurrentgemma-2b, the
remainder blocks too at 5 layers); mLSTM and sLSTM (xlstm-1.3b); M-RoPE
on embedding inputs (qwen2-vl-2b).

Bands: the logits and every cache leaf at fp32 ``rtol=1e-5`` and
``atol=1e-6`` times the larger of 1 and the leaf's largest magnitude
(tests/test_torch_lm.py's logits band: the GEMMs sum in other orders),
xlstm-1.3b's in its whole-model band `XLSTM_BAND` (``rtol=1e-4``,
``atol=1e-5``: the recurrences compound each block's order error,
tests/test_torch_lm_xlstm.py); decode against forward
``rtol=1e-3, atol=2e-3``, the JAX package's invariant; the CLIs' sampled
tokens exactly (bf16 models, each sampling step's gumbel draw
injected).
"""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as base
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import configs, convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_lm import B, _cfgs, _close
from test_torch_lm_xlstm import XLSTM_BAND

#: the fp32 band, (rtol, atol of the larger of 1 and the largest
#: magnitude)
BAND = (base.RTOL, base.ATOL)
#: (arch, prompt, gen, config fields, band): one case a cache kind
CASES = {
    "gqa qk-norm": ("qwen3-14b", 12, 4, {}, BAND),
    "local P<W": ("gemma2-9b", 8, 8, {}, BAND),
    "local P=W": ("gemma2-9b", 16, 4, {}, BAND),
    "local P>W": ("gemma2-9b", 24, 4, {}, BAND),
    "mla moe": ("deepseek-v2-lite-16b", 12, 4, {}, BAND),
    "rglru": ("recurrentgemma-2b", 12, 4, {"num_layers": 5}, BAND),
    "mlstm slstm": ("xlstm-1.3b", 12, 4, {}, XLSTM_BAND),
    "mrope embeds": ("qwen2-vl-2b", 12, 4, {}, BAND),
}
DECODE_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _band(got, want, msg, band=BAND):
    rtol, atol = band
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max(initial=0))
    _close(got.float(), want, rtol=rtol, atol=atol * max(1.0, top),
           msg=msg)


def _same_cache(got, jcache, msg, band=BAND):
    want = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert sorted(got) == sorted(want), (msg, sorted(got), sorted(want))
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, (
            msg, k, got[k].shape, v.shape)
        _band(got[k], v, f"{msg}: {k}", band)


def _inputs(jcfg, n, seed):
    """``n`` positions of the case's input: tokens, or embeds."""
    rs = np.random.RandomState(seed)
    if jcfg.embedding_inputs:
        return rs.randn(B, n, jcfg.d_model).astype(np.float32)
    return rs.randint(0, jcfg.vocab_size, (B, n))


def _batches(jcfg, a):
    name = "embeds" if jcfg.embedding_inputs else "tokens"
    return {name: jnp.asarray(a)}, {name: torch.tensor(a)}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    """The case's prompt through both packages' ``forward(want_cache=
    True)``, `prefill_to_decode_cache` to ``prompt + gen`` positions and
    three decode steps on the same inputs: logits and every cache leaf
    in the band after each stage (the port's decode writes its cache in
    place; the JAX package returns a new one)."""
    arch, P, G, fields, band = CASES[case]
    jcfg, tcfg = _cfgs(arch, "float32", **fields)
    jp, tp = base._params(jcfg)
    ins = _inputs(jcfg, P + DECODE_STEPS, seed=1)
    jb, tb = _batches(jcfg, ins[:, :P])
    jl, jcache, _ = JT.forward(jp, jcfg, jb, want_cache=True)
    with torch.no_grad():
        tl, tcache, _ = TT.forward(tp, tcfg, tb, want_cache=True,
                                   remat=False)
    _band(tl, jl, f"{case} prefill logits", band)
    _same_cache(tcache, jcache, f"{case} prefill cache", band)
    jcache = JT.prefill_to_decode_cache(jcfg, jcache, P, P + G)
    tcache = TT.prefill_to_decode_cache(tcfg, tcache, P, P + G)
    _same_cache(tcache, jcache, f"{case} decode layout", band)
    for i in range(DECODE_STEPS):
        jb, tb = _batches(jcfg, ins[:, P + i:P + i + 1])
        jl, jcache = JT.decode_step(jp, jcfg, jb, jcache,
                                    jnp.asarray(P + i, jnp.int32))
        with torch.no_grad():
            tl, tcache = TT.decode_step(tp, tcfg, tb, tcache, P + i)
        _band(tl, jl, f"{case} decode {i} logits", band)
        _same_cache(tcache, jcache, f"{case} decode {i} cache",
                    band)


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if a != "hubert-xlarge"])
def test_init_cache_matches_jax(arch):
    """`init_cache`: the JAX package's leaves, shapes, dtypes and values
    (the mLSTM's and sLSTM's m at -1e30), at the arch's own dtype."""
    jcfg, tcfg = _cfgs(arch)
    jc = JT.init_cache(jcfg, B, 40)
    tc = TT.init_cache(tcfg, B, 40)
    want = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert sorted(tc) == sorted(want)
    for k, v in want.items():
        assert tc[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      v.float().numpy(), err_msg=k)


def test_long_mode_swa_only_serves_every_block_local():
    """``long_mode_swa_only``: a ``global`` block's cache is a rolling
    local one (`init_block_cache` through `_effective_kind`), and prefill
    and decode match JAX's with it."""
    jcfg, tcfg = (dataclasses.replace(c, long_mode_swa_only=True)
                  for c in _cfgs("gemma2-9b", "float32"))
    tc = TT.init_cache(tcfg, B, 40)
    assert tc["g1/k"].shape[2] == tcfg.window == tc["g0/k"].shape[2]
    jp, tp = base._params(jcfg)
    ins = _inputs(jcfg, 25, seed=4)
    jl, jcache, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(
        ins[:, :24])}, want_cache=True)
    with torch.no_grad():
        _, tcache, _ = TT.forward(tp, tcfg, {"tokens": torch.tensor(
            ins[:, :24])}, want_cache=True, remat=False)
    jcache = JT.prefill_to_decode_cache(jcfg, jcache, 24, 40)
    tcache = TT.prefill_to_decode_cache(tcfg, tcache, 24, 40)
    _same_cache(tcache, jcache, "swa-only layout")
    jl, jcache = JT.decode_step(jp, jcfg, {"tokens": jnp.asarray(
        ins[:, 24:])}, jcache, jnp.asarray(24, jnp.int32))
    with torch.no_grad():
        tl, tcache = TT.decode_step(tp, tcfg, {"tokens": torch.tensor(
            ins[:, 24:])}, tcache, 24)
    _band(tl, jl, "swa-only decode")
    _same_cache(tcache, jcache, "swa-only decode")


# ------------------------------------------------- dynamic_update_slice
@pytest.mark.parametrize("start", [-20, -3, 0, 5, 7, 8, 20])
def test_write_slot_clamps_as_dynamic_update_slice(start):
    """One position written at ``start`` of an 8-long axis: past the end
    the start clamps so the update fits, a negative start counts from
    the end (and clamps at 0), as ``jax.lax.dynamic_update_slice``
    does."""
    rs = np.random.RandomState(0)
    buf = rs.randn(2, 8, 3).astype(np.float32)
    new = rs.randn(2, 1, 3).astype(np.float32)
    want = jax.lax.dynamic_update_slice(jnp.asarray(buf), jnp.asarray(new),
                                        (0, start, 0))
    got = torch.tensor(buf)
    TL.write_slot(got, torch.tensor(new), start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-lite-16b"])
def test_decode_at_or_past_the_end_clamps_as_jax(arch):
    """A decode step at the cache's last position and past it (full
    attention's ``min(pos, W - 1)`` slot, MLA's clamped write): logits
    and cache as JAX's."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = base._params(jcfg)
    ins = _inputs(jcfg, 12, seed=2)
    jl, jcache, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(
        ins[:, :8])}, want_cache=True)
    with torch.no_grad():
        _, tcache, _ = TT.forward(tp, tcfg, {"tokens": torch.tensor(
            ins[:, :8])}, want_cache=True, remat=False)
    jcache = JT.prefill_to_decode_cache(jcfg, jcache, 8, 10)
    tcache = TT.prefill_to_decode_cache(tcfg, tcache, 8, 10)
    for pos in (9, 10, 13):
        tok = ins[:, pos - 1:pos] if pos < 12 else ins[:, 11:12]
        jl, jcache = JT.decode_step(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                    jcache, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            tl, tcache = TT.decode_step(tp, tcfg, {"tokens": torch.tensor(
                tok)}, tcache, pos)
        _band(tl, jl, f"{arch} decode at {pos}")
        _same_cache(tcache, jcache, f"{arch} decode at {pos}")


# ------------------------------------------ decode == the full forward
@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if a != "hubert-xlarge"])
def test_decode_equals_forward(arch):
    """Within the port: the decode step's logits at position S, from the
    prefill's cache of S tokens, equal the full forward's at position S
    over S + 1 (the MoE archs at capacity factor 4, where neither drops
    a choice, as the JAX package's own test runs them)."""
    _, tcfg = _cfgs(arch, "float32")
    if tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=4.0))
    params = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    S = 20
    a = _inputs(tcfg, S + 1, seed=3)
    full = {("embeds" if tcfg.embedding_inputs else "tokens"):
            torch.tensor(a)}
    with torch.no_grad():
        _, cache, _ = TT.forward(params, tcfg, {k: v[:, :S] for k, v in
                                                full.items()},
                                 want_cache=True, remat=False)
        cache = TT.prefill_to_decode_cache(tcfg, cache, S, S + 4)
        dec, _ = TT.decode_step(params, tcfg, {k: v[:, S:] for k, v in
                                               full.items()}, cache, S)
        ref, _, _ = TT.forward(params, tcfg, full, remat=False)
    np.testing.assert_allclose(dec[:, 0].numpy(), ref[:, S].numpy(),
                               rtol=1e-3, atol=2e-3)


# ------------------------------------------------------------- the CLI
SERVE = dict(batch=2, prompt=8, gen=5, seed=0)


def _serve_argv(arch):
    return ["--arch", arch, "--reduced", "--batch", str(SERVE["batch"]),
            "--prompt-len", str(SERVE["prompt"]), "--gen",
            str(SERVE["gen"]), "--seed", str(SERVE["seed"])]


def _jax_serve_hooks(arch):
    """The JAX serve CLI's weights, prompt and sampling draws
    (``fold_in(key, 99)`` from the prefill, ``fold_in(key, 100 + i)``
    after decode step i), in the port CLI's ``hooks`` format."""
    cfg = jconfigs.get_model_config(arch).reduced(d_model=128)
    key = jax.random.PRNGKey(SERVE["seed"])
    shape = (SERVE["batch"], SERVE["prompt"])
    if cfg.embedding_inputs:
        prompt = {"embeds": jax.random.normal(
            key, shape + (cfg.d_model,), dtype=JT.param_dtype(cfg))}
    else:
        prompt = {"tokens": jax.random.randint(key, shape, 0,
                                               cfg.vocab_size)}

    def gumbel(step):
        k = jax.random.fold_in(key, 99 if step == 0 else 99 + step)
        return np.array(jax.random.gumbel(
            k, (SERVE["batch"], cfg.vocab_padded), jnp.float32))
    return {"params": jax.tree.map(np.asarray, JT.init_lm(key, cfg)),
            "prompt": convert.params_from_numpy(
                jax.tree.map(np.asarray, prompt), "cpu"),
            "gumbel": gumbel}


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-vl-2b"])
def test_serve_cli_samples_jax_tokens(arch, tmp_path, monkeypatch, capsys):
    """Both serve CLIs, ``--reduced`` (bf16): the port's run on the JAX
    run's weights, prompt and gumbel draws samples the JAX run's tokens
    (qwen2-vl-2b feeds each sampled token's ``embed`` row back, with
    M-RoPE positions); the ``serve`` records agree but for timings."""
    monkeypatch.setattr(sys, "argv", ["serve"] + _serve_argv(arch) + [
        "--obs-log", str(tmp_path / "jax.jsonl")])
    jserve.main()
    out = capsys.readouterr().out
    want = eval(re.search(r"sampled token ids: (.*)", out).group(1))
    res = tserve.main(_serve_argv(arch) + [
        "--device", "cpu", "--obs-log", str(tmp_path / "port.jsonl")],
        hooks=_jax_serve_hooks(arch))
    assert res["tokens"].tolist() == want
    assert len(res["logits"]) == SERVE["gen"]
    assert len(res["step_ms"]) == SERVE["gen"] - 1
    rec = [r for r in res["records"] if r["record"] == "serve"][0]
    assert (rec["batch"], rec["decode_steps"]) == (SERVE["batch"],
                                                  SERVE["gen"])
    assert rec["decode_p50_ms"] <= rec["decode_p95_ms"] <= rec[
        "decode_p99_ms"]


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if a != "hubert-xlarge"])
def test_serve_cli_runs_every_causal_arch(arch):
    res = tserve.main(_serve_argv(arch) + ["--device", "cpu"])
    assert res["tokens"].shape == (SERVE["batch"], SERVE["gen"])
    assert all(torch.isfinite(lg).all() for lg in res["logits"])


def test_serve_cli_needs_a_card_and_a_decoder():
    """Without ``--device cpu`` the CLI raises here (no card, no fallback
    to the CPU); the encoder-only hubert-xlarge is refused, as JAX's."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(_serve_argv("minicpm-2b"))
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(_serve_argv("hubert-xlarge") + ["--device", "cpu"])
