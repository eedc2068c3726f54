"""The port's comm layer against the JAX package's: byte accounting, the
versioned wire header, `repack`, the serialized payloads of the golden
fixture, and the compression stage of the comm round.

* `accounting` is pure integer arithmetic: exact ints, every compressor
  and stream, and the fixture's ``round_totals/bidir``.
* `Header` bytes are compared byte for byte; `repack` and the
  compression stage (uplink encode with EF on and off, the downlink
  broadcast, the hessian round-trip) bitwise, the port fed the JAX
  eager path's own noise (``jax.random.uniform`` of the same key).
* The golden payloads: the port's `StochasticQuant.encode` fed the
  noise ``jax.random.uniform(PRNGKey(99), shape)`` that
  tests/test_wire_golden.py encodes with, then `serialize`, gives the
  JAX package's bytes, and the fixture's length and header.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.comm import accounting as jacc
from repro.comm import downlink as jdown
from repro.comm import flat as jflat
from repro.comm.compressors import make_stream_compressor as jmake
from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.models.small import MLPTask as JMLPTask
from repro_torch import convert
from repro_torch.comm import accounting as tacc
from repro_torch.comm import downlink as tdown
from repro_torch.comm import flat as tflat
from repro_torch.comm.compressors import make_stream_compressor as tmake
from repro_torch.configs.base import CommConfig, FedConfig
from repro_torch.core.fed import FedEngine
from repro_torch.models.small import MLPTask

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "wire_format.json")
QUANT_BLOCK = 128
ENCODE_KEY = 99
COMPRESSORS = ("identity", "int8", "int4", "topk", "signsgd")


def _both(**kw):
    return JCommConfig(**kw), CommConfig(**kw)


# ------------------------------------------------------------- accounting
@pytest.mark.parametrize("comp", COMPRESSORS)
@pytest.mark.parametrize("streams", ["uplink", "bidir"])
def test_round_bytes_exact(comp, streams):
    kw = dict(compressor=comp, quant_block=96, topk_ratio=0.03,
              participation=0.375)
    if streams == "bidir":
        kw.update(downlink_compressor=comp, hessian_compressor=comp,
                  downlink_quant_block=256, hessian_topk_ratio=0.2)
    jc, tc = _both(**kw)
    for n, clients in ((1, 1), (100_000, 8), (118_282, 32), (54_321, 10)):
        assert tacc.round_bytes(tc, n, clients) == jacc.round_bytes(
            jc, n, clients)
        for stream in ("uplink", "downlink", "hessian"):
            assert tacc.stream_bytes(tc, stream, n) == jacc.stream_bytes(
                jc, stream, n)


def test_round_totals_match_golden():
    with open(GOLDEN) as f:
        golden = json.load(f)["round_totals/bidir"]
    comm = CommConfig(compressor="int8", downlink_compressor="int8",
                      hessian_compressor="int4", participation=0.5)
    assert {"n_params": 100_000, "num_clients": 8,
            **tacc.round_bytes(comm, 100_000, 8)} == golden


# ----------------------------------------------------------------- header
HEADERS = [dict(compressor="identity", total=13_002, quant_block=1024),
           dict(compressor="int4", total=1500, quant_block=512,
                state_dtype="bfloat16"),
           dict(compressor="topk", total=7, quant_block=96, aux=3,
                state_dtype="float8_e5m2"),
           dict(compressor="int8", total=2 ** 40, quant_block=128,
                version=1)]


@pytest.mark.parametrize("kw", HEADERS, ids=lambda kw: kw["compressor"])
def test_header_bytes_match_jax(kw):
    jh, th = jflat.Header(**kw), tflat.Header(**kw)
    raw = jh.pack()
    assert th.pack() == raw and len(raw) == tflat.HEADER_BYTES
    assert tflat.Header.unpack(raw) == th
    assert tflat.Header.from_dict(jh.to_dict()) == th
    assert th.to_dict() == jh.to_dict()


def test_header_rejects_what_jax_rejects():
    good = jflat.Header(compressor="int8", total=10, quant_block=8).pack()
    bad = [b"XXXX" + good[4:], good[:4] + b"\x03\x00" + good[6:],
           good[:6] + b"\x09" + good[7:], good[:7] + b"\x10" + good[8:],
           good[:10]]
    for raw in bad:
        with pytest.raises(ValueError):
            jflat.Header.unpack(raw)
        with pytest.raises(ValueError):
            tflat.Header.unpack(raw)
    with pytest.raises(ValueError, match="v1"):
        tflat.Header(compressor="int8", total=1, quant_block=8, version=1,
                     state_dtype="bfloat16").pack()


def test_check_headers_agrees_with_jax():
    base = {"uplink": tflat.Header("int8", 100, 128).to_dict()}
    v1 = {"uplink": {k: v for k, v in base["uplink"].items()
                     if k != "state_dtype"} | {"version": 1}}
    moved = {"uplink": tflat.Header("int8", 100, 256).to_dict()}
    extra = {**base, "hessian": tflat.Header("int4", 100, 128).to_dict()}
    for saved, now, ok in ((base, base, True), (v1, base, True),
                           (moved, base, False), (extra, base, False),
                           ({}, base, False)):
        for mod in (jflat, tflat):
            if ok:
                mod.check_headers(saved, now)
            else:
                with pytest.raises(ValueError):
                    mod.check_headers(saved, now)


# ----------------------------------------------------------------- repack
@pytest.mark.parametrize("to_cols", [128, 1024, 96])
def test_repack_matches_jax(to_cols):
    rs = np.random.default_rng(0)
    tree = {"a": rs.standard_normal((300,)).astype(np.float32),
            "b": rs.standard_normal((48, 25)).astype(np.float32)}
    jtree = jax.tree.map(jax.numpy.asarray, tree)
    src_j = jflat.flat_spec(jtree, cols=128)
    dst_j = jflat.flat_spec(jtree, cols=to_cols)
    ttree = convert.params_from_numpy(tree, "cpu")
    src_t = tflat.flat_spec(ttree, cols=128)
    dst_t = tflat.with_cols(src_t, to_cols)
    assert dst_t == tflat.flat_spec(ttree, cols=to_cols)
    buf = tflat.pack(ttree, src_t)
    want = np.asarray(jflat.repack(jflat.pack(jtree, src_j), src_j, dst_j))
    got = tflat.repack(buf, src_t, dst_t)
    np.testing.assert_array_equal(got.numpy(), want)
    stacked = tflat.repack(torch.stack([buf, 2 * buf]), src_t, dst_t)
    np.testing.assert_array_equal(stacked[1].numpy(), 2 * want)
    if to_cols == 128:
        assert tflat.repack(buf, src_t, dst_t) is buf


# ---------------------------------------------------------- golden payloads
GOLDEN_CASES = {
    "uplink/identity": ("uplink", dict(compressor="identity"), False),
    "uplink/int8": ("uplink", dict(compressor="int8"), False),
    "uplink/int4": ("uplink", dict(compressor="int4"), False),
    "downlink/int8": ("downlink", dict(downlink_compressor="int8"), False),
    "hessian/int8": ("hessian", dict(hessian_compressor="int8"), True),
    "hessian/int4": ("hessian", dict(hessian_compressor="int4"), True),
    "hessian/int4-coarse": ("hessian", dict(
        hessian_compressor="int4", hessian_quant_block=4 * QUANT_BLOCK),
        True),
}


def _golden_tree():
    """tests/test_wire_golden.py's fixed input, as numpy."""
    key = jax.random.PRNGKey(1234)
    return {"b": np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                              (300,))),
            "w": np.asarray(jax.random.normal(key, (48, 25)))}


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_payload_matches_golden(name):
    """The port's serialized payload is byte for byte the JAX package's
    on the same input and noise, and has the fixture's length and
    header.  Its sha256 is therefore the fixture's wherever the JAX
    package reproduces the fixture (tests/test_wire_golden.py): the
    fixture's input and noise come from ``jax.random.normal`` /
    ``uniform``, whose values depend on the jax version and its
    ``jax_threefry_partitionable`` default."""
    stream, kw, square = GOLDEN_CASES[name]
    kw = dict(quant_block=QUANT_BLOCK, topk_ratio=0.02, **kw)
    comm, jcomm = CommConfig(**kw), JCommConfig(**kw)
    view = comm.stream(stream)
    tree_np = _golden_tree()
    tree = convert.params_from_numpy(tree_np, "cpu")
    spec = tflat.flat_spec(tree, cols=view.quant_block)
    flat = tflat.pack(tree, spec)
    jtree = jax.tree.map(jax.numpy.asarray, tree_np)
    jspec = jflat.flat_spec(jtree, cols=view.quant_block)
    jflat_buf = jflat.pack(jtree, jspec)
    if square:
        flat, jflat_buf = flat * flat, jflat_buf * jflat_buf
    key = jax.random.PRNGKey(ENCODE_KEY)
    u = torch.from_numpy(np.array(jax.random.uniform(key,
                                                     tuple(flat.shape))))
    comp = tmake(comm, stream, spec)
    raw = comp.serialize(comp.encode(u, flat))
    jcomp = jmake(jcomm, stream, jspec)
    assert raw == jcomp.serialize(jcomp.encode(key, jflat_buf))
    with open(GOLDEN) as f:
        golden = json.load(f)["payloads"][name]
    assert tflat.Header.unpack(raw) == comp.header()
    assert len(raw) == golden["bytes"] == tacc.wire_bytes(view, spec.total)
    assert raw[:tflat.HEADER_BYTES].hex() == golden["header_hex"]


# ------------------------------------------------------- compression stage
def _stage_inputs(seed, n, rows, cols):
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal((n, rows, cols)).astype(np.float32)
    start = rs.standard_normal((rows, cols)).astype(np.float32)
    ef = (1e-2 * rs.standard_normal((n, rows, cols))).astype(np.float32)
    return theta, start, ef


def _spec_pair(rows, cols):
    tree = {"w": np.zeros((rows * cols - 5,), np.float32)}
    return (jflat.flat_spec(jax.tree.map(jax.numpy.asarray, tree), cols),
            tflat.flat_spec(convert.params_from_numpy(tree, "cpu"), cols))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got.numpy()).view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("comp", ["int8", "int4"])
@pytest.mark.parametrize("ef_on", [False, True], ids=["ef-off", "ef-on"])
def test_uplink_stage_bitwise_vs_jax_eager(comp, ef_on):
    """Per client and batched (shared start), the port's uplink encode is
    bitwise the JAX package's eager, non-Pallas encode on the same
    inputs and noise."""
    n, rows, cols = 3, 5, 64
    jspec, tspec = _spec_pair(rows, cols)
    jc = jmake(JCommConfig(compressor=comp, quant_block=cols), "uplink",
               jspec)
    tc = tmake(CommConfig(compressor=comp, quant_block=cols), "uplink",
               tspec)
    theta, start, ef = _stage_inputs(1, n, rows, cols)
    jt, js, je = (jax.numpy.asarray(a) for a in (theta, start, ef))
    keys = [jax.random.PRNGKey(10 + i) for i in range(n)]
    u = np.stack([np.array(jax.random.uniform(k, (rows, cols)))
                  for k in keys])
    want = [jc.encode_delta(k, jt[i], js, je[i] if ef_on else None)
            for i, k in enumerate(keys)]
    t = [torch.from_numpy(a) for a in (theta, start, ef, u)]
    for i in range(n):
        xhat, _, new_ef = tc.encode_delta(t[3][i], t[0][i], t[1],
                                          t[2][i] if ef_on else None)
        _eq(xhat, want[i][0])
        assert (new_ef is None) == (not ef_on)
        if ef_on:
            _eq(new_ef, want[i][2])
    xhat, _, new_ef = tc.encode_delta_batched(t[3], t[0], t[1],
                                              t[2] if ef_on else None)
    _eq(xhat, np.stack([w[0] for w in want]))
    if ef_on:
        _eq(new_ef, np.stack([w[2] for w in want]))


@pytest.mark.parametrize("ef_on", [False, True], ids=["ef-off", "ef-on"])
def test_downlink_and_hessian_stage_bitwise_vs_jax_eager(ef_on):
    n, rows, cols = 3, 4, 128
    jspec, tspec = _spec_pair(rows, cols)
    kw = dict(downlink_compressor="int8", downlink_error_feedback=ef_on,
              hessian_compressor="int4", quant_block=cols)
    jdn = jmake(JCommConfig(**kw), "downlink", jspec)
    tdn = tmake(CommConfig(**kw), "downlink", tspec)
    theta, replicas, ef = _stage_inputs(2, n, rows, cols)
    server = replicas          # the (rows, cols) server model
    replicas = theta           # the (n, rows, cols) client replicas
    keys = [jax.random.PRNGKey(20 + i) for i in range(n)]
    u = np.stack([np.array(jax.random.uniform(k, (rows, cols)))
                  for k in keys])
    js, jr, je = (jax.numpy.asarray(a) for a in (server, replicas, ef))
    want = [jdown.broadcast(jdn, k, js, jr[i], je[i] if ef_on else None)
            for i, k in enumerate(keys)]
    t = [torch.from_numpy(a) for a in (server, replicas, ef, u)]
    for i in range(n):
        model, new_ef = tdown.broadcast(tdn, t[3][i], t[0], t[1][i],
                                        t[2][i] if ef_on else None)
        _eq(model, want[i][0])
        if ef_on:
            _eq(new_ef, want[i][1])
        else:
            assert new_ef is None
    models, new_efs = tdown.broadcast_batched(tdn, t[3], t[0], t[1],
                                              t[2] if ef_on else None)
    _eq(models, np.stack([w[0] for w in want]))
    if ef_on:
        _eq(new_efs, np.stack([w[1] for w in want]))
    # the hessian stream's round-trip of a nonnegative EMA
    jh = jmake(JCommConfig(**kw), "hessian", jspec)
    th = tmake(CommConfig(**kw), "hessian", tspec)
    h = np.abs(theta[0])
    _eq(th.roundtrip(t[3][0], torch.from_numpy(h))[0],
        jh.roundtrip(keys[0], jax.numpy.asarray(h))[0])
    _eq(th.roundtrip_batched(t[3], torch.from_numpy(np.abs(theta)))[0],
        np.stack([jh.roundtrip(k, jax.numpy.asarray(np.abs(theta[i])))[0]
                  for i, k in enumerate(keys)]))


# ------------------------------------------------------- engine plumbing
def test_wire_headers_and_init_state_match_jax():
    comm_kw = dict(compressor="int8", error_feedback=True,
                   downlink_compressor="int4", downlink_error_feedback=True,
                   downlink_quant_block=512, hessian_compressor="int4",
                   hessian_quant_block=256, participation=0.5)
    cfg = dict(num_clients=4, local_iters=2)
    jeng = JFedEngine(JMLPTask(hidden=16),
                      JFedConfig(comm=JCommConfig(**comm_kw), **cfg))
    teng = FedEngine(MLPTask(hidden=16),
                     FedConfig(comm=CommConfig(**comm_kw), **cfg),
                     device="cpu")
    jstate = jeng.init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), "cpu")
    tstate = teng.init_from_params(params)
    assert teng.wire_headers(params) == jeng.wire_headers(jstate["params"])
    want = convert.state_to_numpy(convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu"))
    got = convert.state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for k in convert.COMM_KEYS:
        np.testing.assert_array_equal(got[k], want[k])
    assert not teng.uses_direct_path()
