"""The port's example twins (`repro_torch.examples`) against the JAX
package's ``examples/``, on the CPU: ``fed_llm_train``'s configs field by
field and a short run; ``comm_compression``'s wire bytes per regime
against ``repro.comm.round_bytes`` and a one-round run of the four
regimes; ``serve_batched``'s prefill and first decode logits, on the JAX
example's weights and prompt (through `convert`), within
tests/test_torch_serve.py's band (xlstm-1.3b, the example's other
arch, runs); ``hyperparam_table``'s grid and harness settings against
the JAX example's and ``benchmarks/common.py``'s (read with `ast`: the
example runs its grid when imported), and one round of one cell
against the JAX engine built as ``run_federated`` builds it, with its
draws injected, within tests/test_torch_engine.py's round band; and
each example raises without a card unless ``--device cpu`` asks for the
CPU."""
import ast
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
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import synthetic as jsyn
from repro.models import transformer as JT
from repro.models.small import CNNTask as JCNNTask
from repro.models.small import MLPTask as JMLPTask
from repro_torch import configs, convert
from repro_torch.examples import comm_compression, fed_llm_train
from repro_torch.examples import hyperparam_table, serve_batched
from test_torch_engine import _clip_flips, _clip_windows, _close
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


def _literal(node, names):
    """An ast expression's value: a literal, or a loop variable's."""
    if isinstance(node, ast.Name):
        return names[node.id]
    return ast.literal_eval(node)


def test_hyperparam_table_grid_equals_jax():
    """Every ``run_federated`` call of the JAX example's loops, and the
    harness's data, model and round settings, against the twin's."""
    tree = ast.parse((ROOT / "examples" / "hyperparam_table.py").read_text())
    cells, calls = [], []
    for loop in [n for n in tree.body if isinstance(n, ast.For)]:
        for value in ast.literal_eval(loop.iter):
            names = {loop.target.id: value}
            call = next(n for n in ast.walk(loop) if isinstance(n, ast.Call)
                        and getattr(n.func, "attr", "") == "run_federated")
            kw = {k.arg: _literal(k.value, names) for k in call.keywords}
            calls.append(([_literal(a, names) for a in call.args],
                          kw.pop("clients"), kw.pop("rounds")))
            cells.append((kw.pop("lr"), kw.pop("local_iters")))
            assert not kw, kw
    assert tuple(cells) == hyperparam_table.CELLS
    assert all(c == (["cnn", "fmnist", "fed_sophia"],
                     hyperparam_table.CLIENTS, hyperparam_table.ROUNDS)
               for c in calls)
    common = ast.parse((ROOT / "benchmarks" / "common.py").read_text())
    top = {t.id: n.value for n in common.body if isinstance(n, ast.Assign)
           for t in n.targets if isinstance(t, ast.Name)}
    assert ast.literal_eval(top["N_SAMPLES"]) == hyperparam_table.IMAGES
    assert ast.literal_eval(top["NOISE"])["fmnist"] == hyperparam_table.NOISE
    run = next(n for n in common.body if isinstance(n, ast.FunctionDef)
               and n.name == "run_federated")
    defaults = {a.arg: ast.literal_eval(d) for a, d in zip(
        run.args.kwonlyargs, run.args.kw_defaults) if d is not None}
    assert (defaults["tau"], defaults["batch"], defaults["seed"]) == (
        hyperparam_table.TAU, hyperparam_table.BATCH, 0)
    src = ast.unparse(run)
    assert f"alpha={hyperparam_table.ALPHA}" in src
    assert f"te, {hyperparam_table.TEST_BATCH})" in src
    assert (f"CNNTask(channels={hyperparam_table.CHANNELS})"
            in ast.unparse(common))


def _cell_gumbel(rng, J, shape):
    """The JAX engine's GNB draws of a round at ``hessian_every_unit=
    "step"``: client i's step j from ``fold_in(fold_in(rng, i), j)``."""
    return np.stack([np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(rng, i), j), shape,
        jnp.float32)) for j in range(J)])
        for i in range(hyperparam_table.CLIENTS)])


def test_hyperparam_table_cell_matches_jax():
    """One round of the cell (lr 0.001, J=1): the JAX engine built and
    driven as ``run_federated`` builds it (its data, partition, initial
    state, batches and GNB draws, all from ``PRNGKey(0)``, injected into
    the twin through its hooks) against the twin's round: the loss,
    params, m and h within the round band (one flipped clipped step
    allowed per leaf), the test accuracy within one test image."""
    ht = hyperparam_table
    lr, J = ht.CELLS[3]
    key = jax.random.PRNGKey(0)
    # jitted whole (eager JAX compiles each op; both packages get these)
    x, y = jax.jit(lambda k: jsyn.make_image_data(
        k, ht.IMAGES, "fmnist", noise=ht.NOISE))(key)
    part = jsyn.dirichlet_partition(jax.random.fold_in(key, 1), y,
                                    ht.CLIENTS, alpha=ht.ALPHA)
    tr, te = jsyn.train_test_split(part)
    task = JCNNTask(channels=ht.CHANNELS)
    engine = JFedEngine(task, JFedConfig(
        num_clients=ht.CLIENTS, local_iters=J, optimizer="fed_sophia",
        lr=lr, tau=ht.TAU, total_rounds=1, comm=JCommConfig()))
    state = jax.jit(engine.init)(jax.random.fold_in(key, 2))
    teb = jax.jit(lambda k, x, y: jsyn.client_batches(
        k, x, y, te, ht.TEST_BATCH))(jax.random.fold_in(key, 3), x, y)
    batches = jax.jit(lambda k, x, y: jsyn.client_batches(
        k, x, y, tr, ht.BATCH))(jax.random.fold_in(key, 100), x, y)

    def torch_batch(b):
        return {"x": torch.tensor(np.asarray(b["x"])),
                "y": torch.tensor(np.asarray(b["y"]), dtype=torch.int64)}
    rng = jax.random.fold_in(key, 1000)
    data = (torch.tensor(np.asarray(x)),
            torch.tensor(np.asarray(y), dtype=torch.int64), (tr, te))
    hooks = {"init": lambda eng: convert.state_from_numpy(
                 jax.tree.map(np.asarray, state), device="cpu"),
             "batches": lambda r: torch_batch(batches),
             "gumbel": lambda r: torch.from_numpy(_cell_gumbel(
                 rng, J, (ht.BATCH, 10))),
             "test_batches": torch_batch(teb)}
    got = ht.run_cell(lr, J, "cpu", data, rounds=1, hooks=hooks)
    jstate, jm = jax.jit(engine.round)(state, batches, rng)
    jacc = float(jax.jit(lambda p, teb: jnp.mean(jax.vmap(
        lambda b: task.accuracy(p, b))(teb)))(jstate["params"], teb))
    _close(float(jm["loss"]), got["losses"][0], "loss")
    ts = convert.state_to_numpy(got["state"])
    windows = _clip_windows(jstate)
    for k, v in jstate["params"].items():
        want = np.array(v)
        _close(want, _clip_flips(want, ts["params"][k], windows.get(k), lr),
               f"params[{k}]")
    for name in ("m", "h"):
        _close(getattr(jstate["client_opt"], name), ts["client_opt"][name],
               name)
    n_test = ht.CLIENTS * ht.TEST_BATCH
    assert abs(got["accs"][0] - jacc) <= 1 / n_test + 1e-7


def test_examples_need_a_card_or_device_cpu():
    for main in (fed_llm_train.main, comm_compression.main,
                 serve_batched.main, hyperparam_table.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
