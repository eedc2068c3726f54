"""The port's flat wire layout against the JAX package's, and the port's
import hygiene.

`pack`, `unpack` and `zeros` are pure data movement (fp32 in, fp32
out), so they are compared bitwise.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.comm import flat as jflat
from repro.models.small import CNNTask as JCNNTask
from repro.models.small import MLPTask as JMLPTask
from repro_torch import convert
from repro_torch.comm import flat as tflat

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

TREES = {
    "mlp": (lambda: JMLPTask(hidden=16), ("b1", "b2", "b3", "w1", "w2",
                                          "w3")),
    "cnn": (lambda: JCNNTask(channels=(4, 8)), ("bc1", "bc2", "bfc",
                                                "conv1", "conv2", "fc")),
}


def _jax_params(task):
    params = task.init(jax.random.PRNGKey(1))
    # non-zero biases, so a leaf-order slip cannot hide behind zeros
    return jax.tree.map(lambda x: x + 0.25, params)


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("cols", [1024, 96])
def test_pack_unpack_zeros_bitwise(name, cols):
    make, _ = TREES[name]
    jp = _jax_params(make())
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jspec = jflat.flat_spec(jp, cols=cols)
    tspec = tflat.flat_spec(tp, cols=cols)
    assert (tspec.total, tspec.rows, tspec.cols) == (jspec.total, jspec.rows,
                                                     jspec.cols)
    jbuf = np.asarray(jflat.pack(jp, jspec))
    tbuf = tflat.pack(tp, tspec)
    assert tbuf.dtype == torch.float32
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    back = tflat.unpack(tbuf, tspec)
    for k, v in jflat.unpack(jax.numpy.asarray(jbuf), jspec).items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(
        tflat.zeros(tspec, (3,)).numpy(),
        np.asarray(jflat.zeros(jspec, (3,))))


def test_pack_with_client_axis_matches_per_client_packs():
    jp = _jax_params(JMLPTask(hidden=16))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    spec = tflat.flat_spec(tp)
    stacked = {k: torch.stack([v, 2 * v, -v]) for k, v in tp.items()}
    buf = tflat.pack(stacked, spec)
    assert buf.shape == (3, spec.rows, spec.cols)
    for i, s in enumerate((1, 2, -1)):
        want = tflat.pack({k: s * v for k, v in tp.items()}, spec)
        np.testing.assert_array_equal(buf[i].numpy(), want.numpy())
    back = tflat.unpack(buf, spec)
    for k in tp:
        np.testing.assert_array_equal(back[k].numpy(), stacked[k].numpy())


@pytest.mark.parametrize("name", list(TREES))
def test_leaf_order_is_sorted_keys(name):
    make, order = TREES[name]
    jp = _jax_params(make())
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tflat.flat_spec(tp).keys == order
    jax_order = [path[0].key for path, _ in
                 jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert jax_order == list(order)


def test_leaf_coords_index_a_slice_of_each_matching_leaf():
    """``leaf_coords`` gives the packed coordinates of ``leaf[..., lo:hi]``
    for every leaf whose key ends with the suffix: a stack, a lone
    vector and a zero-length stack among other leaves."""
    tree = {"blocks_0/mixer/b_gates": torch.arange(16.).reshape(2, 8),
            "blocks_1/mixer/b_gates": torch.zeros(0, 8),
            "blocks_0/mixer/w": torch.full((5,), -1.),
            "rem_0/mixer/b_gates": 100 + torch.arange(8.)}
    spec = tflat.flat_spec(tree, cols=16)
    idx = tflat.leaf_coords(spec, "/mixer/b_gates", 2, 4)
    assert idx.dtype == torch.int64 and torch.all(idx[1:] > idx[:-1])
    got = tflat.pack(tree, spec).reshape(-1)[idx]
    np.testing.assert_array_equal(got.numpy(),
                                  [2., 3., 10., 11., 102., 103.])
    assert len(tflat.leaf_coords(spec, "/ln1", 0, 1)) == 0


def test_as_dtype_names_match_jax():
    for name in ("float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"):
        assert np.dtype(jflat.as_dtype(name)).name == name
        assert tflat.as_dtype(name) == getattr(torch, name)
    for mod in (jflat, tflat):
        with pytest.raises(ValueError, match="state_dtype"):
            mod.as_dtype("float16")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_repro_statically():
    """A scan of every port module and chip_smoke.py: no ``import jax``
    and no import of the JAX package."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_port_imports_without_jax_or_repro():
    """Every port module imports in a process where ``jax`` and ``repro``
    cannot be imported at all."""
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    # the scheduler, the adversarial fleet and their helpers are scanned
    for name in ("repro_torch.sched.scheduler", "repro_torch.sched.latency",
                 "repro_torch.robust.aggregators",
                 "repro_torch.robust.attacks", "repro_torch.obs.spans",
                 "repro_torch.data.partition", "repro_torch.utils.tree",
                 "repro_torch.kernels.ops", "repro_torch.kernels.stale_accum",
                 "repro_torch.kernels.robust_agg",
                 # slice 10: the LM zoo's dense decoder, the record
                 # system, checkpoints and the trainer
                 "repro_torch.models.layers", "repro_torch.models.transformer",
                 "repro_torch.obs.schema", "repro_torch.obs.sinks",
                 "repro_torch.obs.logio", "repro_torch.obs.trace",
                 "repro_torch.obs.buffer", "repro_torch.checkpoint.ckpt",
                 "repro_torch.launch.train", "repro_torch.configs.minicpm_2b",
                 # slice 15: the cost tools and the example twins
                 "repro_torch.kernels.cost", "repro_torch.launch.api",
                 "repro_torch.launch.op_cost", "repro_torch.launch.roofline",
                 "repro_torch.launch.dryrun", "repro_torch.launch.profile",
                 "repro_torch.examples.fed_llm_train",
                 "repro_torch.examples.comm_compression",
                 "repro_torch.examples.serve_batched"):
        assert name in mods, name
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules) > 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout
