"""The port's checkpoints (`repro_torch.checkpoint.ckpt`) against the
JAX package's, in both directions, and `FedEngine.restore_params`
against the JAX engine's.  Checkpoint data is moved, not computed:
bitwise throughout, bf16 leaves included; the one computed comparison,
the JAX package's committed minicpm-2b checkpoint restored into the
port's model, holds the loss to the bf16 band of tests/test_torch_lm.py
(``rtol=1e-3``).
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (numpy learns the bf16 dtype by name)
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.comm import flat as jflat
from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.models import transformer as JT
from repro_torch import configs, convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.comm import flat as tflat
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "experiments" / "fed_llm_ckpt"


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _trees(dtype):
    jcfg = jconfigs.get_model_config("minicpm-2b").reduced(d_model=128)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jp = JT.init_lm(jax.random.PRNGKey(4), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _same_tree(port, jaxtree):
    flat = convert.flatten(jax.tree.map(np.asarray, jaxtree))
    assert sorted(port) == sorted(flat)
    for k, v in flat.items():
        t = port[k]
        assert str(t.dtype) == f"torch.{np.dtype(v.dtype).name}", k
        np.testing.assert_array_equal(_bits(convert._array(t)), _bits(v),
                                      err_msg=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_save_jax_restore_and_back_bitwise(dtype, tmp_path):
    jp, tp = _trees(dtype)
    extra = {"arch": "minicpm-2b", "wire": {"uplink": {"compressor": "x"}}}
    tckpt.save(str(tmp_path / "port"), tp, step=3, extra=extra)
    jckpt.save(str(tmp_path / "jax"), jp, step=3, extra=extra)
    assert tckpt.load_manifest(str(tmp_path / "port")) == \
        jckpt.load_manifest(str(tmp_path / "jax"))
    assert json.loads((tmp_path / "port" / "manifest.json").read_text()) \
        == json.loads((tmp_path / "jax" / "manifest.json").read_text())
    # the JAX package restores the port's checkpoint, and the reverse
    _same_tree(tp, jckpt.restore(str(tmp_path / "port"), jp))
    _same_tree(tckpt.restore(str(tmp_path / "jax"), tp), jp)


def test_save_packed_restore_packed_bitwise(tmp_path):
    jp, tp = _trees("bfloat16")
    jspec, tspec = jflat.flat_spec(jp), tflat.flat_spec(tp)
    # a packed fp32 state after training is off the bf16 grid: the save
    # rounds each leaf to its logical dtype, as the JAX shim does
    noise = np.random.RandomState(0).randn(tspec.rows, tspec.cols)
    jbuf = jflat.pack(jp, jspec) + jnp.asarray(noise * 1e-4, jnp.float32)
    tbuf = torch.from_numpy(np.array(jbuf))
    tckpt.save_packed(str(tmp_path / "port"), tbuf, tspec, step=1)
    jckpt.save_packed(str(tmp_path / "jax"), jbuf, jspec, step=1)
    for name in ("port", "jax"):
        got = tckpt.restore_packed(str(tmp_path / name), tspec)
        want = jckpt.restore_packed(str(tmp_path / name), jspec)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = np.load(tmp_path / "port" / "arrays.npz")
    b = np.load(tmp_path / "jax" / "arrays.npz")
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k])
    bf = tckpt.restore_packed(str(tmp_path / "port"), tspec,
                              dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.float().numpy(),
        np.asarray(jckpt.restore_packed(str(tmp_path / "port"), jspec,
                                        dtype=jnp.bfloat16), np.float32))


def test_committed_jax_checkpoint_gives_the_jax_loss():
    """experiments/fed_llm_ckpt (read only): the JAX package's minicpm-2b
    ``reduced(d_model=128)`` checkpoint, restored into each package's
    model, the loss of one batch within the bf16 band."""
    manifest = tckpt.load_manifest(str(COMMITTED))
    assert manifest == jckpt.load_manifest(str(COMMITTED))
    assert manifest["extra"]["cfg"] == "minicpm-2b"
    jcfg = jconfigs.get_model_config("minicpm-2b").reduced(d_model=128)
    tcfg = configs.get_model_config("minicpm-2b").reduced(d_model=128)
    like_j = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    like_t = TT.LMTask(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    jp = jckpt.restore(str(COMMITTED), like_j)
    tp = tckpt.restore(str(COMMITTED), like_t)
    _same_tree(tp, jp)
    rs = np.random.RandomState(7)
    tok = rs.randint(0, jcfg.vocab_size, (2, 32))
    lab = np.roll(tok, -1, axis=1)
    jloss = JT.LMTask(jcfg).loss(jp, {"tokens": jnp.asarray(tok),
                                      "labels": jnp.asarray(lab)})
    tloss = TT.LMTask(tcfg).loss(tp, {"tokens": torch.tensor(tok),
                                      "labels": torch.tensor(lab)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)


@pytest.mark.parametrize("packed", [False, True])
def test_restore_params_matches_jax(packed):
    """`FedEngine.restore_params` with EF on the uplink and an int8
    downlink: the params swapped in, EF zeroed, the replicas re-synced
    to the restored model and their residuals zeroed, the Sophia EMAs
    kept — bitwise the JAX engine's."""
    jcfg = jconfigs.get_model_config("minicpm-2b").reduced(d_model=128)
    tcfg = configs.get_model_config("minicpm-2b").reduced(d_model=128)
    kw = dict(num_clients=2, local_iters=1)
    comm = dict(compressor="int8", error_feedback=True,
                downlink_compressor="int8", downlink_error_feedback=True)
    jeng = JFedEngine(JT.LMTask(jcfg), JFedConfig(comm=JCommConfig(**comm),
                                                  **kw))
    teng = FedEngine(TT.LMTask(tcfg), FedConfig(comm=CommConfig(**comm),
                                                **kw), device="cpu")
    jstate = jeng.init(jax.random.PRNGKey(1))
    # a state that has moved: EF, replicas and EMAs off their init
    moved = {k: (v + 0.5 if k in ("comm_ef", "comm_dn_model", "comm_dn_ef")
                 else v) for k, v in jstate.items()}
    moved["client_opt"] = jax.tree.map(lambda x: x + 0.25,
                                       jstate["client_opt"])
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, moved), "cpu")
    new_jp = JT.init_lm(jax.random.PRNGKey(2), jcfg)
    new_tp = convert.params_from_numpy(jax.tree.map(np.asarray, new_jp),
                                       "cpu")
    want = jax.tree.map(np.asarray, jeng.restore_params(moved, new_jp))
    if packed:
        tstate = teng.pack_state(tstate)
    got = teng.restore_params(tstate, new_tp)
    assert teng.params_packed(got["params"]) == packed
    got = convert.state_to_numpy(teng.unpack_state(got))
    _same_tree(convert.params_from_numpy(got["params"], "cpu"),
               want["params"])
    for key in ("comm_ef", "comm_dn_model", "comm_dn_ef"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert not got["comm_ef"].any()
    np.testing.assert_array_equal(got["client_opt"]["m"],
                                  want["client_opt"].m)
    np.testing.assert_array_equal(got["client_opt"]["h"],
                                  want["client_opt"].h)
    # a packed buffer is taken as it is
    again = teng.restore_params(teng.pack_state(tstate),
                                tflat.pack(new_tp, teng.spec_for(new_tp)))
    np.testing.assert_array_equal(
        again["comm_dn_model"].numpy(), want["comm_dn_model"])
