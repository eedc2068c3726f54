"""The port's example twins (`repro_torch.examples`) against the JAX
package's ``examples/``, on the CPU: ``fed_llm_train``'s configs field by
field and a short run; ``comm_compression``'s wire bytes per regime
against ``repro.comm.round_bytes`` and a one-round run of the four
regimes; ``serve_batched``'s prefill and first decode logits, on the JAX
example's weights and prompt (through `convert`), within
tests/test_torch_serve.py's band (xlstm-1.3b, the example's other
arch, runs); and each example raises without a
card unless ``--device cpu`` asks for the CPU."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.comm import round_bytes as jround_bytes
from repro.configs.base import CommConfig as JCommConfig
from repro.models import transformer as JT
from repro.models.small import MLPTask as JMLPTask
from repro_torch import configs
from repro_torch.examples import comm_compression, fed_llm_train
from repro_torch.examples import serve_batched
from test_torch_op_cost import one_cpu_thread  # noqa: F401 (autouse)
from test_torch_serve import _band

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _jax_example(name):
    """The JAX package's example module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("small", [True, False])
def test_fed_llm_train_config_equals_jax(small):
    got = dataclasses.asdict(fed_llm_train.build_cfg(small))
    want = dataclasses.asdict(_jax_example("fed_llm_train").build_cfg(small))
    assert got == want


def test_fed_llm_train_runs_on_the_cpu(tmp_path):
    res = fed_llm_train.main(["--small", "--device", "cpu",
                              "--local-iters", "1", "--clients", "2",
                              "--ckpt", str(tmp_path / "ckpt")])
    assert len(res["losses"]) == 5 and np.isfinite(res["losses"]).all()
    fed = res["engine"].fed
    assert (fed.schedule, fed.tau, fed.warmup_rounds) == ("wsd", 5, 1)
    assert (tmp_path / "ckpt" / "arrays.npz").exists()
    args = fed_llm_train.parse(["--small"])
    assert (args.rounds, args.seq, args.batch, args.ckpt) == (
        5, 64, 2, "build/fed_llm_ckpt")


def test_comm_compression_bytes_equal_jax_and_runs(monkeypatch):
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(
        JMLPTask(hidden=comm_compression.HIDDEN).init(
            jax.random.PRNGKey(0))))
    monkeypatch.setattr(comm_compression, "ROUNDS", 1)
    monkeypatch.setattr(comm_compression, "LOCAL_ITERS", 1)
    res = comm_compression.main(["--device", "cpu"])
    assert list(res) == list(comm_compression.REGIMES)
    for name, comm in comm_compression.REGIMES.items():
        want = jround_bytes(JCommConfig(**dataclasses.asdict(comm)), n,
                            comm_compression.CLIENTS)
        assert res[name]["wire"] == want, name
        assert comm_compression.regime_bytes(n)[name] == want
        assert res[name]["engine"].num_params(
            res[name]["engine"].init(torch.Generator().manual_seed(0))) == n
        assert np.isfinite(res[name]["losses"]).all()
        assert 0.0 <= res[name]["accuracy"][0] <= 1.0


def test_serve_batched_first_decode_matches_jax():
    """The JAX example's flow (prefill, `prefill_to_decode_cache`, one
    greedy decode step) on its own weights and prompt, at fp32, against
    the port example given the same weights and prompt (chatglm3-6b, the
    example's default; tests/test_torch_serve.py holds every cache kind
    against JAX)."""
    arch, B, P = "chatglm3-6b", 2, 8
    cfg = dataclasses.replace(
        jconfigs.get_model_config(arch).reduced(d_model=128),
        dtype="float32")
    key = jax.random.PRNGKey(0)
    params = JT.init_lm(key, cfg)
    prompt = {"tokens": jax.random.randint(key, (B, P), 0, cfg.vocab_size)}
    logits, cache, _ = JT.forward(params, cfg, prompt, want_cache=True,
                                  remat=False)
    cache = JT.prefill_to_decode_cache(cfg, cache, P, P + 2)
    tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)
    lg, _ = JT.decode_step(params, cfg, {"tokens": tok[:, None]}, cache,
                           jnp.asarray(P, jnp.int32))
    res = serve_batched.main(
        ["--arch", arch, "--device", "cpu", "--batch", str(B),
         "--prompt-len", str(P), "--gen", "2"],
        hooks={"cfg": dataclasses.replace(
                   configs.get_model_config(arch).reduced(d_model=128),
                   dtype="float32"),
               "params": jax.tree.map(np.asarray, params),
               "prompt": {"tokens": np.array(prompt["tokens"])}})
    _band(res["logits"][0], np.asarray(logits[:, -1]), f"{arch} prefill")
    assert res["tokens"][:, 0].tolist() == np.asarray(tok).tolist()
    _band(res["logits"][1], np.asarray(lg[:, -1]), f"{arch} decode")


def test_serve_batched_runs_xlstm():
    """The JAX example's other arch, recurrent caches, on the CPU."""
    res = serve_batched.main(["--arch", "xlstm-1.3b", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "8", "--gen",
                              "3"])
    assert res["tokens"].shape == (2, 3)
    assert all(torch.isfinite(lg).all() for lg in res["logits"])


def test_examples_need_a_card_or_device_cpu():
    for main in (fed_llm_train.main, comm_compression.main,
                 serve_batched.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
