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
#: SignSGD's scale, sum|x| / n, against the JAX package's: the sums
#: add in different orders (measured on the golden input: 3 ulps,
#: 2.2e-7 relative)
SCALE_RTOL = 1e-6
COMPRESSORS = ("identity", "int8", "int4", "topk", "signsgd")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave the process as this module found it: the JAX package's
    jitted Pallas kernels traced here would otherwise stay in jax's
    caches for other modules' tests, which trace the same shapes under
    other launch geometries."""
    yield
    jax.clear_caches()


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
    "uplink/topk": ("uplink", dict(compressor="topk"), False),
    "uplink/signsgd": ("uplink", dict(compressor="signsgd"), False),
    "downlink/int8": ("downlink", dict(downlink_compressor="int8"), False),
    "downlink/topk": ("downlink", dict(downlink_compressor="topk"), False),
    "downlink/topk-coarse": ("downlink", dict(downlink_compressor="topk",
                                              downlink_topk_ratio=0.05),
                             False),
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
    ``jax_threefry_partitionable`` default.

    signsgd's last 4 bytes, its fp32 scale ``sum|x| / n``, are held
    within ``SCALE_RTOL`` instead: a sum is not bitwise across
    frameworks (XLA and torch add in different orders), so its bytes
    match only where the orders happen to round alike.  Its header and
    sign bits are byte for byte."""
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
    want = jcomp.serialize(jcomp.encode(key, jflat_buf))
    if view.compressor == "signsgd":
        assert raw[:-4] == want[:-4] and len(raw) == len(want)
        np.testing.assert_allclose(np.frombuffer(raw[-4:], "<f4"),
                                   np.frombuffer(want[-4:], "<f4"),
                                   rtol=SCALE_RTOL, atol=0)
    else:
        assert raw == want
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


# ------------------------------------------------- the biased compressors
def _biased_pair(comp, rows, cols, use_pallas=False, **kw):
    jspec, tspec = _spec_pair(rows, cols)
    kw = dict(compressor=comp, quant_block=cols, **kw)
    return (jmake(JCommConfig(use_pallas=use_pallas, **kw), "uplink", jspec),
            tmake(CommConfig(**kw), "uplink", tspec))


def _buffer(seed, rows, cols):
    """A packed buffer with its 5-coordinate pad tail at 0."""
    x = np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)
    x.reshape(-1)[rows * cols - 5:] = 0.0
    return x


@pytest.mark.parametrize("ratio", [0.003, 0.05, 0.5, 1.0])
def test_topk_encode_decode_header_match_jax(ratio):
    """k, the (idx, val) payload, its decode, the header and the wire
    length, against the JAX package's exact-k encode."""
    rows, cols = 6, 64
    jc, tc = _biased_pair("topk", rows, cols, topk_ratio=ratio)
    x = _buffer(11, rows, cols)
    assert tc.k == jc.k == tacc.topk_k(tc.cfg, tc.spec.total)
    jp = jc.encode(None, jax.numpy.asarray(x))
    tp = tc.encode(None, torch.from_numpy(x))
    assert tp["idx"].dtype == torch.int32 and tp["val"].dtype == torch.float32
    np.testing.assert_array_equal(tp["idx"].numpy(), np.asarray(jp["idx"]))
    _eq(tp["val"], jp["val"])
    _eq(tc.decode(tp), jc.decode(jp))
    assert tc.header().to_dict() == jc.header().to_dict()
    raw = tc.serialize(tp)
    assert raw == jc.serialize(jp)
    assert len(raw) == tacc.wire_bytes(tc.cfg, tc.spec.total)


def test_topk_ties_exact_k_encode_against_threshold_roundtrip():
    """Planted ties at the k-th magnitude.  ``encode`` keeps exactly k,
    lowest index first, as ``lax.top_k`` does (``torch.topk`` need not:
    a stable descending sort picks them); the round-trip runs the
    threshold kernel, which keeps every tie, as the JAX package's
    ``use_pallas`` route does.  The two JAX routes differ here too."""
    rows, cols = 4, 32
    x = np.zeros((rows, cols), np.float32)
    flat = x.reshape(-1)
    flat[[3, 40, 77, 90, 101, 120]] = [9.0, -9.0, 9.0, 3.0, -2.0, 9.0]
    flat[[7, 8]] = [12.0, -11.0]
    jc, tc = _biased_pair("topk", rows, cols, topk_ratio=4 / 123)
    jk, _ = _biased_pair("topk", rows, cols, use_pallas=True,
                         topk_ratio=4 / 123)
    assert tc.k == 4
    jx, tx = jax.numpy.asarray(x), torch.from_numpy(x)
    tp = tc.encode(None, tx)
    assert tp["idx"].tolist() == [7, 8, 3, 40]
    np.testing.assert_array_equal(tp["idx"].numpy(),
                                  np.asarray(jc.encode(None, jx)["idx"]))
    exact = tc.decode(tp)
    _eq(exact, jc.roundtrip(None, jx)[0])
    kept, stat = tc.roundtrip(None, tx)
    _eq(kept, jk.roundtrip(None, jx)[0])
    assert float(stat) == 0.0
    assert int((exact != 0).sum()) == 4 and int((kept != 0).sum()) == 6
    assert torch.equal(kept.reshape(-1)[[3, 7, 8, 40, 77, 120]],
                       tx.reshape(-1)[[3, 7, 8, 40, 77, 120]])


def test_signsgd_encode_decode_header_match_jax():
    """Signs (int8, jnp.sign's zero), header and sign bits byte for byte;
    the scale, a sum, within SCALE_RTOL; decode and the majority vote
    follow."""
    rows, cols = 6, 64
    jc, tc = _biased_pair("signsgd", rows, cols, sign_majority=True)
    x = _buffer(12, rows, cols)
    x[1, :3] = [0.0, -0.0, 0.0]
    jp = jc.encode(None, jax.numpy.asarray(x))
    tp = tc.encode(None, torch.from_numpy(x))
    np.testing.assert_array_equal(tp["sign"].numpy(), np.asarray(jp["sign"]))
    assert tp["scale"].shape == () and tp["scale"].dtype == torch.float32
    np.testing.assert_allclose(float(tp["scale"]), float(jp["scale"]),
                               rtol=SCALE_RTOL)
    np.testing.assert_allclose(tc.decode(tp).numpy(),
                               np.asarray(jc.decode(jp)), rtol=SCALE_RTOL)
    assert float(tc.stat(tp)) == float(tp["scale"])
    assert tc.header().to_dict() == jc.header().to_dict()
    raw, want = tc.serialize(tp), jc.serialize(jp)
    assert raw[:-4] == want[:-4]
    assert len(raw) == tacc.wire_bytes(tc.cfg, tc.spec.total)


@pytest.mark.parametrize("majority", [False, True], ids=["mean", "vote"])
def test_signsgd_server_combine_matches_jax(majority):
    """The server's majority vote ``wstat * sign(agg)``, bitwise, with
    the pad tail's zeros (and a -0) kept at 0; without the vote the
    mean passes through."""
    rows, cols = 3, 64
    jc, tc = _biased_pair("signsgd", rows, cols, sign_majority=majority)
    agg = _buffer(13, rows, cols)
    agg[0, :2] = [-0.0, np.nan]
    wstat = np.float32(0.37)
    got = tc.server_combine(torch.from_numpy(agg), torch.tensor(wstat))
    _eq(got, jc.server_combine(jax.numpy.asarray(agg), jax.numpy.asarray(
        wstat)))
    if majority:
        assert float(got.reshape(-1)[-1]) == 0.0


@pytest.mark.parametrize("comp", ["topk", "signsgd"])
@pytest.mark.parametrize("ef_on", [False, True], ids=["ef-off", "ef-on"])
def test_biased_stages_vs_jax(comp, ef_on):
    """The uplink encode, the downlink broadcast and the hessian
    round-trip with a biased compressor, per client and batched, against
    the JAX package's kernel route (``use_pallas``, interpret mode; the
    non-kernel route where that is the only one, the downlink's vmap of
    its round-trip).  Top-k: bitwise.  SignSGD: the reconstruction's
    signs exact, every output within SCALE_RTOL of its largest value
    (the scale is a sum; replica and residual inherit its error)."""
    n, rows, cols = 3, 4, 128
    jspec, tspec = _spec_pair(rows, cols)
    kw = dict(compressor=comp, downlink_compressor=comp,
              hessian_compressor=comp, error_feedback=ef_on,
              downlink_error_feedback=ef_on, quant_block=cols,
              topk_ratio=0.05)
    theta, start, ef = _stage_inputs(3, n, rows, cols)
    jt, js, je = (jax.numpy.asarray(a) for a in (theta, start, ef))
    t = [torch.from_numpy(a) for a in (theta, start, ef)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(n)]

    def same(got, want, signs=False):
        if comp == "topk":
            _eq(got, want)
            return
        w = np.asarray(want)
        if signs:
            np.testing.assert_array_equal(np.sign(got.numpy()), np.sign(w))
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=SCALE_RTOL * np.abs(w).max())

    jc = jmake(JCommConfig(use_pallas=True, **kw), "uplink", jspec)
    tc = tmake(CommConfig(**kw), "uplink", tspec)
    want = [jc.encode_delta(k, jt[i], js, je[i] if ef_on else None)
            for i, k in enumerate(keys)]
    for i in range(n):
        xhat, stat, new_ef = tc.encode_delta(None, t[0][i], t[1],
                                             t[2][i] if ef_on else None)
        same(xhat, want[i][0], signs=True)
        np.testing.assert_allclose(float(stat), float(want[i][1]),
                                   rtol=SCALE_RTOL)
        if ef_on:
            same(new_ef, want[i][2])
        else:
            assert new_ef is None
    xhat, stats, new_ef = tc.encode_delta_batched(None, t[0], t[1],
                                                  t[2] if ef_on else None)
    same(xhat, np.stack([w[0] for w in want]), signs=True)
    np.testing.assert_allclose(stats.numpy(), [float(w[1]) for w in want],
                               rtol=SCALE_RTOL)
    if ef_on:
        same(new_ef, np.stack([w[2] for w in want]))
    # downlink: the server model is `start`, the replicas `theta`
    jdn = jmake(JCommConfig(use_pallas=True, **kw), "downlink", jspec)
    tdn = tmake(CommConfig(**kw), "downlink", tspec)
    want = [jdown.broadcast(jdn, k, js, jt[i], je[i] if ef_on else None)
            for i, k in enumerate(keys)]
    for i in range(n):
        model, new_ef = tdown.broadcast(tdn, None, t[1], t[0][i],
                                        t[2][i] if ef_on else None)
        same(model, want[i][0])
        if ef_on:
            same(new_ef, want[i][1])
    models, new_efs = tdown.broadcast_batched(tdn, None, t[1], t[0],
                                              t[2] if ef_on else None)
    same(models, np.stack([w[0] for w in want]))
    if ef_on:
        same(new_efs, np.stack([w[1] for w in want]))
    # the hessian stream's round-trip of a nonnegative EMA
    jh = jmake(JCommConfig(use_pallas=True, **kw), "hessian", jspec)
    th = tmake(CommConfig(**kw), "hessian", tspec)
    h = np.abs(theta)
    same(th.roundtrip(None, torch.from_numpy(h[0]))[0],
         jh.roundtrip(keys[0], jax.numpy.asarray(h[0]))[0], signs=True)
    same(th.roundtrip_batched(None, torch.from_numpy(h))[0],
         np.stack([jh.roundtrip(k, jax.numpy.asarray(h[i]))[0]
                   for i, k in enumerate(keys)]), signs=True)
