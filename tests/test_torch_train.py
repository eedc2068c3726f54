"""The port's trainer CLI (`repro_torch.launch.train`) against the JAX
package's (`repro.launch.train`), both on the CPU: minicpm-2b
``--reduced`` (d_model 128, 2 layers, bf16 parameters), 2 clients,
J=2, tau=2, batch 2, seq 16.

The port's run gets the JAX run's randomness through `main`'s ``hooks``
(the RNG seam): the JAX CLI's initial weights (``init_lm(PRNGKey(seed))``),
its token batches (``fold_in(key, 1000 + r)``) and its GNB draws (round
r, client i, step j: ``fold_in(fold_in(fold_in(key, r), i), j)``; the
scheduler's ``fold_in(fold_in(key, version), i)``).

Compared: every record field exactly (byte counters, energy, virtual
times, staleness, the manifest's schema fingerprint and meta) but the
losses, held to ``rtol=1e-3`` (the bf16 loss band of
tests/test_torch_lm.py), and the host timings (``wall_s``,
``t_wall_s``), which only need be present.  The checkpoints either CLI
writes are read by the other's ``--resume``; the params they hold agree
within the bf16 engine band of tests/test_torch_lm.py (``_bf16_band``)
widened by one bf16 rounding of the saved leaves.
"""
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.obs import logio as jlogio
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.launch import train as ttrain
from test_torch_lm import BF16_ATOL, BF16_MAX_OUT

ARCH, C, J, TAU, B, S, ROUNDS, SEED = "minicpm-2b", 2, 2, 2, 2, 16, 2, 0
LOSS_RTOL = 1e-3
#: a flipped clipped Sophia step per local step per client, over the
#: run (tests/test_torch_lm.py: _bf16_band); the CLI's default lr
FLIP = 2 * 1e-3 * J * ROUNDS / C
BASE = ["--arch", ARCH, "--reduced", "--clients", str(C), "--local-iters",
        str(J), "--tau", str(TAU), "--batch", str(B), "--seq", str(S),
        "--seed", str(SEED)]
#: host timings: present, not compared
TIMINGS = ("wall_s", "t_wall_s")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()


def jax_hooks():
    """The JAX CLI's weights, batches and draws, in the port's ``hooks``
    format."""
    cfg = jconfigs.get_model_config(ARCH).reduced(d_model=128)
    key = jax.random.PRNGKey(SEED)
    vp = cfg.vocab_padded

    def gumbel(rng, ids):
        return torch.from_numpy(np.stack([np.stack([np.asarray(
            jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(rng, i),
                                                 j), (B, S, vp),
                              jnp.float32)) for j in range(J)])
            for i in ids]))

    def batches(r):
        jb = jsyn.make_token_batch(jax.random.fold_in(key, 1000 + r), C, B,
                                   S, cfg.vocab_size)
        return {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}

    def sched_draws(version, ids):
        if ids is None:
            return {"participants": np.arange(C)}
        return {"gumbel": gumbel(jax.random.fold_in(key, version), ids)}

    return {"params": jax.tree.map(np.asarray, JT.init_lm(key, cfg)),
            "batches": batches,
            "round_kwargs": lambda r: {"gumbel": gumbel(
                jax.random.fold_in(key, r), range(C))},
            "sched_draws": sched_draws}


def _records(path):
    return jlogio.read_records(str(path))


def _same_records(got, want):
    """Equal record streams: exact but the losses (band) and timings;
    the manifest's free-form meta also names the port's device, and its
    residency is "packed" where the JAX run's is "packed+donated" (the
    port updates resident state in place, no donation)."""
    assert [r["record"] for r in got] == [r["record"] for r in want]
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        if g["record"] == "manifest":
            g["meta"] = {k: v for k, v in g["meta"].items()
                         if k != "device"}
            w["meta"]["residency"] = g["meta"]["residency"]
        for k in ("loss", "eval_loss"):
            if k in w:
                np.testing.assert_allclose(g.pop(k), w.pop(k),
                                           rtol=LOSS_RTOL)
        for k in TIMINGS:
            assert (k in g) == (k in w)
            g.pop(k, None), w.pop(k, None)
        assert g == w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' runs: sync with --obs-log and --ckpt-dir, and semisync
    with --obs-log --trace."""
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("train")
    hooks = jax_hooks()
    out = {"dir": d, "hooks": hooks}
    try:
        for tag, extra in (("sync", ["--ckpt-dir"]),
                           ("semisync", ["--schedule", "semisync",
                                         "--trace", "--ckpt-dir"])):
            for who in ("jax", "port"):
                argv = BASE + ["--rounds", str(ROUNDS), "--obs-log",
                               str(d / f"{who}-{tag}.jsonl"),
                               *extra, str(d / f"{who}-{tag}-ckpt")]
                if who == "jax":
                    _jax_cli(mp, argv)
                else:
                    out[tag] = ttrain.main(argv + ["--device", "cpu"],
                                           hooks=hooks)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("tag", ["sync", "semisync"])
def test_records_match_the_jax_cli(runs, tag):
    d = runs["dir"]
    want = _records(d / f"jax-{tag}.jsonl")
    got = _records(d / f"port-{tag}.jsonl")
    _same_records(got, want)
    kinds = {r["record"] for r in got}
    assert kinds >= ({"manifest", "round", "span"} if tag == "sync" else
                     {"manifest", "sched_event", "sched_dispatch",
                      "sched_summary", "span"})
    losses = runs[tag]["losses"]
    assert len(losses) == ROUNDS and np.all(np.isfinite(losses))


@pytest.mark.parametrize("tag", ["sync", "semisync"])
def test_checkpoints_match_the_jax_cli(runs, tag):
    d = runs["dir"]
    jm = jckpt.load_manifest(str(d / f"jax-{tag}-ckpt"))
    tm = tckpt.load_manifest(str(d / f"port-{tag}-ckpt"))
    assert tm == jm
    jz = np.load(d / f"jax-{tag}-ckpt" / "arrays.npz")
    tz = np.load(d / f"port-{tag}-ckpt" / "arrays.npz")
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        want, got = jz[k], tz[k]
        assert got.dtype == want.dtype == np.float32
        # the engines' bf16 band, plus one bf16 rounding of the saved
        # leaves (2^-8 relative, both folded into 2^-7)
        diff, ulp = np.abs(got - want), 2 ** -7 * np.abs(want)
        out = diff > BF16_ATOL + ulp
        assert int(out.sum()) <= BF16_MAX_OUT, (k, int(out.sum()))
        assert np.all(diff[out] <= FLIP + ulp[out]), k


def test_resume_from_either_cli(runs, tmp_path, monkeypatch):
    """``--resume`` of each CLI from the other's checkpoint (and its
    own): the wire headers check out, and the resumed round's loss
    agrees across the four runs."""
    d, hooks = runs["dir"], runs["hooks"]
    losses = {}
    for src in ("jax", "port"):
        for who in ("jax", "port"):
            ck = tmp_path / f"{who}-from-{src}"
            shutil.copytree(d / f"{src}-sync-ckpt", ck)
            argv = BASE + ["--rounds", "1", "--ckpt-dir", str(ck),
                           "--resume"]
            if who == "jax":
                log = tmp_path / f"{who}-{src}.jsonl"
                _jax_cli(monkeypatch, argv + ["--obs-log", str(log)])
                losses[who, src] = _records(log)[1]["loss"]
            else:
                res = ttrain.main(argv + ["--device", "cpu"], hooks=hooks)
                losses[who, src] = res["losses"][0]
            assert tckpt.load_manifest(str(ck))["step"] == 1
    want = losses["jax", "jax"]
    for k, v in losses.items():
        np.testing.assert_allclose(v, want, rtol=LOSS_RTOL, err_msg=str(k))


def test_resume_refuses_another_wire_layout(runs, tmp_path):
    ck = tmp_path / "ck"
    shutil.copytree(runs["dir"] / "jax-sync-ckpt", ck)
    with pytest.raises(ValueError, match="compressor was 'identity'"):
        ttrain.main(BASE + ["--rounds", "1", "--ckpt-dir", str(ck),
                            "--resume", "--compressor", "int8",
                            "--device", "cpu"])


def test_cli_needs_a_card_or_device_cpu(monkeypatch):
    """No fallback: without a card the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(BASE + ["--rounds", "1"])
