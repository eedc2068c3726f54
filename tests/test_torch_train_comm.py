"""The port's trainer CLI against the JAX package's on the LM round with
compression, and on gemma2-9b and qwen3-14b, both CLIs on the CPU,
``--reduced`` (d_model 128, 2 layers, bf16 parameters), J=2, tau=2,
batch 2, 2 rounds:

* minicpm-2b, 4 clients, seq 16: ``--compressor int8``; bidirectional
  int8 / ``--downlink-compressor int8`` / ``--hessian-compressor int4``
  at ``--participation 0.5``; ``topk``; ``signsgd --sign-majority``;
* gemma2-9b, 2 clients, seq 80 (past its reduced window of 64), on its
  arch's sequential strategy: identity and ``int8``;
* qwen3-14b, 2 clients, seq 16, sequential: identity.

The port's run gets the JAX run's randomness through `main`'s ``hooks``
(tests/test_torch_train.py: the weights, batches and GNB draws) plus
each round's comm draws: the participation sample
(`FedEngine.round_participants`) and each quantized stream's U[0, 1)
noise by client id (``fold_in(fold_in(rng, i), salt)``, as
tests/test_torch_comm_round.py injects them).  Both CLIs take
``--comm-pallas`` on the comm runs, so the JAX run takes the kernel
route whose tie rules the port follows (top-k keeps every tie at the
threshold).

The JAX CLI passes only ``schedule`` of an arch's ``FED`` overrides to
its `FedConfig`; the port's passes ``strategy`` too.  So the JAX side of
the gemma2-9b and qwen3-14b runs gets the arch's strategy patched into
its `FedConfig`, and both train sequentially.

Compared: the records as tests/test_torch_train.py compares them (exact
but the losses, ``rtol=1e-3``, and the timings); the checkpoints under
the comm flip band over the bf16 engine band: every leaf within
``BF16_ATOL`` plus one bf16 rounding of the saved value, but for at most
`MAX_OUT` coordinates, each within `FLIP` (a Sophia step flipped where
m crossed zero in one engine only) plus the largest move of the run's
streams (`scale_probe`: a quant step, a top-k threshold, twice a
SignSGD scale) plus that rounding.  Under SignSGD's majority vote the
count is `VOTE_SHARE` of the leaf: at bf16 parameters the sign of a
client's delta differs between the engines wherever its update was
near zero, and each such sign can tip a tied vote, which moves the
server coordinate by the vote's step (measured on the CPU: 266
coordinates over the leaves, at most 83 in one, 0.13% of ``embed``;
each within 6% of its move bound).  The identity runs' checkpoints are
read by either CLI's ``--resume``.
"""
import functools
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.comm import compressors as tcomp
from repro_torch.configs.base import COMM_STREAMS
from repro_torch.launch import train as ttrain
from test_torch_lm import BF16_ATOL, BF16_MAX_OUT
from test_torch_train import LOSS_RTOL, _records, _same_records

J, TAU, B, ROUNDS, SEED = 2, 2, 2, 2, 0
#: a flipped clipped Sophia step per local step per client, over the
#: run, at the CLI's default lr (tests/test_torch_lm.py: _bf16_band)
FLIP = 2 * 1e-3 * J * ROUNDS
#: coordinates a leaf may have outside the band: the bf16 engine band's
#: and the comm flip band's (tests/test_torch_comm_round.py) allowances
MAX_OUT = BF16_MAX_OUT + 16
#: under SignSGD's majority vote: the share of a leaf that may be out
VOTE_SHARE = 0.005
#: jax.random.fold_in salts of the comm path's draws (repro/core/fed.py)
SALT_UP, SALT_DN, SALT_H, SALT_SERVER_H = 0xC0, 0xD0, 0x4E, 0x4D
QUANT = ("int8", "int4")
BIDIR = ["--compressor", "int8", "--downlink-compressor", "int8",
         "--hessian-compressor", "int4", "--participation", "0.5"]
#: tag -> (arch, clients, seq, extra flags)
RUNS = {
    "minicpm-int8": ("minicpm-2b", 4, 16, ["--compressor", "int8"]),
    "minicpm-bidir": ("minicpm-2b", 4, 16, BIDIR),
    "minicpm-topk": ("minicpm-2b", 4, 16, ["--compressor", "topk"]),
    "minicpm-signsgd": ("minicpm-2b", 4, 16,
                        ["--compressor", "signsgd", "--sign-majority"]),
    "gemma2-int8": ("gemma2-9b", 2, 80, ["--compressor", "int8"]),
    "gemma2-identity": ("gemma2-9b", 2, 80, []),
    "qwen3-identity": ("qwen3-14b", 2, 16, []),
}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def base_argv(tag):
    arch, clients, seq, extra = RUNS[tag]
    comm = ["--comm-pallas"] if extra else []
    return ["--arch", arch, "--reduced", "--clients", str(clients),
            "--local-iters", str(J), "--tau", str(TAU), "--batch", str(B),
            "--seq", str(seq), "--seed", str(SEED), *extra, *comm]


def comm_of(argv):
    """The CLI's `CommConfig` for ``argv``, and its fields as the JAX
    `CommConfig` takes them."""
    comm = ttrain.comm_config(ttrain.build_parser().parse_args(argv))
    return comm, dict(compressor=comm.compressor,
                      participation=comm.participation,
                      topk_ratio=comm.topk_ratio,
                      sign_majority=comm.sign_majority,
                      downlink_compressor=comm.downlink_compressor,
                      hessian_compressor=comm.hessian_compressor)


def jax_hooks(tag):
    """The JAX CLI's weights, batches and every draw of its rounds, in
    the port's ``hooks`` format."""
    arch, C, seq, _ = RUNS[tag]
    argv = base_argv(tag)
    cfg = jconfigs.get_model_config(arch).reduced(d_model=128)
    key = jax.random.PRNGKey(SEED)
    vp = cfg.vocab_padded
    params = JT.init_lm(key, cfg)
    _, comm = comm_of(argv)
    jeng = JFedEngine(JT.LMTask(cfg), JFedConfig(
        num_clients=C, local_iters=J, tau=TAU,
        comm=JCommConfig(use_pallas=True, **comm)))
    rt = jeng.comm_runtime(params)
    streams = [(s, salt, sp) for s, salt, on, sp in (
        ("uplink", SALT_UP, comm["compressor"], rt.spec),
        ("downlink", SALT_DN, comm["downlink_compressor"], rt.spec_dn),
        ("hessian", SALT_H, comm["hessian_compressor"], rt.spec_h))
        if on in QUANT]

    def uniform(k, shape):
        return np.array(jax.random.uniform(k, shape))

    def batches(r):
        jb = jsyn.make_token_batch(jax.random.fold_in(key, 1000 + r), C, B,
                                   seq, cfg.vocab_size)
        return {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}

    def round_kwargs(r):
        rng = jax.random.fold_in(key, r)
        crngs = [jax.random.fold_in(rng, i) for i in range(C)]
        out = {"gumbel": torch.from_numpy(np.stack([np.stack([np.asarray(
            jax.random.gumbel(jax.random.fold_in(k, j), (B, seq, vp),
                              jnp.float32)) for j in range(J)])
            for k in crngs]))}
        if jeng.uses_direct_path():
            return out
        noise = {"participants": np.array(jeng.round_participants(rng))}
        for stream, salt, sp in streams:
            noise[stream] = np.stack([uniform(jax.random.fold_in(k, salt),
                                              (sp.rows, sp.cols))
                                      for k in crngs])
            if stream == "hessian":
                noise["server_hessian"] = uniform(
                    jax.random.fold_in(rng, SALT_SERVER_H),
                    (sp.rows, sp.cols))
        out["comm_noise"] = noise
        return out

    return {"params": jax.tree.map(np.asarray, params), "batches": batches,
            "round_kwargs": round_kwargs}


def _jax_cli(monkeypatch, tag, argv):
    """The JAX CLI on ``argv``, its `FedConfig` given the arch's FED
    strategy (which it does not pass on itself)."""
    strategy = configs.get_fed_overrides(RUNS[tag][0]).get("strategy",
                                                           "parallel")
    monkeypatch.setattr(jtrain, "FedConfig",
                        functools.partial(JFedConfig, strategy=strategy))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()


def _steps_probe(mp, steps, comm):
    """Records, per stream, the most a flipped coordinate may move its
    reconstruction (tests/test_torch_comm_round.py's ``scale_probe``): a
    quantizer's largest row scale, top-k's largest threshold, twice
    SignSGD's largest scale."""
    def probe(cls, name, factor):
        orig = getattr(cls, name)

        def wrapped(self, flat):
            s = orig(self, flat)
            for stream in COMM_STREAMS:
                if self.cfg == comm.stream(stream):
                    steps[stream] = max(steps.get(stream, 0.0),
                                        factor * float(s.max()))
            return s
        mp.setattr(cls, name, wrapped)
    probe(tcomp.StochasticQuant, "scales", 1.0)
    probe(tcomp.TopK, "thresholds", 1.0)
    probe(tcomp.SignSGD, "scales", 2.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' runs of every tag, with --obs-log and --ckpt-dir."""
    d = tmp_path_factory.mktemp("train_comm")
    out = {"dir": d}
    for tag in RUNS:
        hooks = jax_hooks(tag)
        steps = {}
        for who in ("jax", "port"):
            mp = pytest.MonkeyPatch()
            argv = base_argv(tag) + [
                "--rounds", str(ROUNDS),
                "--obs-log", str(d / f"{who}-{tag}.jsonl"),
                "--ckpt-dir", str(d / f"{who}-{tag}-ckpt")]
            try:
                if who == "jax":
                    _jax_cli(mp, tag, argv)
                else:
                    _steps_probe(mp, steps, comm_of(argv)[0])
                    out[tag] = ttrain.main(argv + ["--device", "cpu"],
                                           hooks=hooks)
            finally:
                mp.undo()
        # the params carry the uplink's and the downlink's moves
        out[tag]["move"] = sum(steps.get(s, 0.0)
                               for s in ("uplink", "downlink"))
        out[tag]["hooks"] = hooks
    return out


@pytest.mark.parametrize("tag", list(RUNS))
def test_records_match_the_jax_cli(runs, tag):
    d = runs["dir"]
    got = _records(d / f"port-{tag}.jsonl")
    _same_records(got, _records(d / f"jax-{tag}.jsonl"))
    assert {"manifest", "round", "span"} <= {r["record"] for r in got}
    losses = runs[tag]["losses"]
    assert len(losses) == ROUNDS and np.all(np.isfinite(losses))
    # the arch's FED strategy reached the port's FedConfig
    arch = RUNS[tag][0]
    want = configs.get_fed_overrides(arch).get("strategy", "parallel")
    assert runs[tag]["engine"].fed.strategy == want


@pytest.mark.parametrize("tag", list(RUNS))
def test_checkpoints_match_the_jax_cli(runs, tag):
    d, move = runs["dir"], runs[tag]["move"]
    assert (move > 0) == bool(RUNS[tag][3])
    jm = tckpt.load_manifest(str(d / f"jax-{tag}-ckpt"))
    assert tckpt.load_manifest(str(d / f"port-{tag}-ckpt")) == jm
    jz = np.load(d / f"jax-{tag}-ckpt" / "arrays.npz")
    tz = np.load(d / f"port-{tag}-ckpt" / "arrays.npz")
    assert sorted(tz.files) == sorted(jz.files)
    vote = "--sign-majority" in RUNS[tag][3]
    for k in jz.files:
        want, got = jz[k], tz[k]
        assert got.dtype == want.dtype == np.float32
        diff, ulp = np.abs(got - want), 2 ** -7 * np.abs(want)
        out = diff > BF16_ATOL + ulp
        limit = max(MAX_OUT, VOTE_SHARE * want.size) if vote else MAX_OUT
        assert int(out.sum()) <= limit, (k, int(out.sum()))
        assert np.all(diff[out] <= FLIP + move + ulp[out]), (
            k, float(diff.max()), move)


@pytest.mark.parametrize("tag", ["gemma2-identity", "qwen3-identity"])
def test_resume_from_either_cli(runs, tag, tmp_path):
    """``--resume`` of each CLI from the other's checkpoint (and its
    own): the wire headers check out, and the resumed round's loss
    agrees across the four runs."""
    d, hooks = runs["dir"], runs[tag]["hooks"]
    losses = {}
    for src in ("jax", "port"):
        for who in ("jax", "port"):
            ck = tmp_path / f"{who}-from-{src}"
            shutil.copytree(d / f"{src}-{tag}-ckpt", ck)
            argv = base_argv(tag) + ["--rounds", "1", "--ckpt-dir",
                                     str(ck), "--resume"]
            if who == "jax":
                log = tmp_path / f"{who}-{src}.jsonl"
                mp = pytest.MonkeyPatch()
                try:
                    _jax_cli(mp, tag, argv + ["--obs-log", str(log)])
                finally:
                    mp.undo()
                losses[who, src] = _records(log)[1]["loss"]
            else:
                res = ttrain.main(argv + ["--device", "cpu"], hooks=hooks)
                losses[who, src] = res["losses"][0]
                assert res["ckpt"]["restore_s"] >= 0
            assert tckpt.load_manifest(str(ck))["step"] == 1
    want = losses["jax", "jax"]
    for k, v in losses.items():
        np.testing.assert_allclose(v, want, rtol=LOSS_RTOL, err_msg=str(k))


@pytest.mark.parametrize("arch,layers,kinds", [
    ("gemma2-9b", 2, ("local", "global")),
    ("gemma2-9b", 3, ("local", "global", "local")),
    ("qwen3-14b", 2, ("attn", "attn"))])
def test_layers_keep_the_block_pattern(arch, layers, kinds):
    """``--layers`` cuts the depth at the published widths; the block
    pattern tiles it (gemma2-9b at 2 layers: one local, one global
    block), as `forward` walks the stacked blocks, then the
    remainder."""
    cfg = ttrain.model_config(ttrain.build_parser().parse_args(
        ["--arch", arch, "--layers", str(layers)]))
    full = configs.get_model_config(arch)
    assert (cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        full.d_model, full.d_ff, full.vocab_size)
    walked = tuple(k for k in cfg.block_pattern
                   for _ in range(cfg.pattern_reps)) + cfg.pattern_remainder
    assert walked == kinds and cfg.num_layers == layers
