"""The port's record system (`repro_torch.obs`) against the JAX
package's `repro.obs`: the schema (its fingerprint and every record the
port emits), the sinks and run manifest, the Chrome trace export, the
log readers and the device-side metrics buffer.  Exact throughout: the
record system is host arithmetic on the same values.
"""
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from repro import obs as jobs
from repro.obs import schema as jschema
from repro_torch import obs as tobs
from repro_torch.launch import train as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--arch", "minicpm-2b", "--reduced", "--clients", "2",
        "--local-iters", "2", "--tau", "2", "--batch", "2", "--seq", "16",
        "--rounds", "2", "--device", "cpu"]


def test_schema_and_fingerprint_equal_jax():
    assert tobs.fingerprint() == jobs.fingerprint()
    assert tobs.describe() == jobs.describe()
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert tobs.SUPPORTED_SCHEMA_VERSIONS == jobs.SUPPORTED_SCHEMA_VERSIONS
    assert sorted(tobs.__all__) == sorted(
        n for n in jobs.__all__ if n != "annotate")


@pytest.mark.parametrize("rec", [
    {"record": "round", "round": 0, "loss": 1.0},           # missing
    {"record": "span", "name": "x", "t_wall_s": 0.0, "wall_s": 0.0,
     "bogus": 1},                                           # unknown
    {"record": "round", "round": 0, "loss": 1.0, "lr": 0.1,
     "participants": 2, "uplink_bytes": 1.0, "downlink_bytes": 0,
     "hessian_uplink_bytes": 0, "hessian_downlink_bytes": 0,
     "total_bytes": 1, "cum_total_bytes": 1, "energy_J": 0.0,
     "carbon_kg": 0.0},                                     # float bytes
    {"record": "nope"},
])
def test_bad_records_refused_alike(rec):
    with pytest.raises(jschema.ObsSchemaError):
        jschema.validate_record(rec)
    with pytest.raises(tobs.ObsSchemaError):
        tobs.validate_record(rec)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """The port's CLI logs: the sync obs loop (with probes) and the
    semisync scheduler with trace contexts."""
    d = tmp_path_factory.mktemp("obs")
    out = {}
    for tag, extra in (("sync", ["--probes"]),
                       ("semisync", ["--schedule", "semisync", "--trace",
                                     "--compressor", "int8"])):
        path = d / f"{tag}.jsonl"
        ttrain.main(BASE + ["--obs-log", str(path)] + extra)
        out[tag] = path
    return out


@pytest.mark.parametrize("tag", ["sync", "semisync"])
def test_every_emitted_record_validates_under_jax_schema(logs, tag):
    recs = jobs.read_records(str(logs[tag]))
    kinds = {r["record"] for r in recs}
    assert kinds >= ({"manifest", "round", "span"} if tag == "sync" else
                     {"manifest", "sched_event", "sched_dispatch",
                      "sched_summary", "span"})
    for rec in recs:
        jschema.validate_record(rec)
    head = recs[0]
    assert head["record"] == "manifest"
    assert head["schema_sha256"] == jobs.fingerprint()
    manifest = json.loads(pathlib.Path(str(logs[tag]) + ".manifest.json")
                          .read_text())
    assert manifest["schema_sha256"] == jobs.fingerprint()
    counts = {}
    for r in recs:
        counts[r["record"]] = counts.get(r["record"], 0) + 1
    assert manifest["records"] == counts
    if tag == "sync":
        rounds = [r for r in recs if r["record"] == "round"]
        assert [r["round"] for r in rounds] == [0, 1]
        assert all("clip_fraction" in r for r in rounds)


@pytest.mark.parametrize("tag", ["sync", "semisync"])
def test_tools_read_port_logs(logs, tag, tmp_path):
    """tools/obs_report.py --validate and tools/obs_trace.py, as
    subprocesses, on the port's logs."""
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    rep = subprocess.run([sys.executable, str(ROOT / "tools/obs_report.py"),
                          "--validate", str(logs[tag])], env=env,
                         capture_output=True, text=True, timeout=300)
    assert rep.returncode == 0, rep.stderr
    assert "valid" in rep.stdout
    out = tmp_path / "trace.json"
    tr = subprocess.run([sys.executable, str(ROOT / "tools/obs_trace.py"),
                         str(logs[tag]), "--out", str(out), "--validate"],
                        env=env, capture_output=True, text=True, timeout=300)
    assert tr.returncode == 0, tr.stderr
    recs = tobs.read_records(str(logs[tag]))
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        tobs.chrome_trace(recs)))
    assert tobs.validate_chrome_trace(tobs.chrome_trace(recs)) == []


def test_chrome_trace_and_readers_equal_jax(logs):
    recs = jobs.read_records(str(logs["semisync"]))
    assert tobs.read_records(str(logs["semisync"])) == recs
    assert json.dumps(tobs.chrome_trace(recs), sort_keys=True) == \
        json.dumps(jobs.chrome_trace(recs), sort_keys=True)
    bad = {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0,
                            "ts": 5.0, "dur": -1.0},
                           {"name": "b", "ph": "X", "pid": 1, "tid": 0,
                            "ts": 1.0, "dur": 1.0}]}
    assert tobs.validate_chrome_trace(bad) == jobs.validate_chrome_trace(bad)
    assert tobs.validate_chrome_trace(bad)


def test_recorder_writes_what_jax_writes(logs, tmp_path):
    """The same records through both `RunRecorder`s: the same JSONL bytes
    and the same run manifest; the rings keep the same tail."""
    recs = [r for r in jobs.read_records(str(logs["semisync"]))
            if r["record"] != "manifest"]
    meta = {"arch": "minicpm-2b", "clients": 2}
    paths = {}
    for name, mod in (("jax", jobs), ("port", tobs)):
        path = tmp_path / f"{name}.jsonl"
        rec = mod.RunRecorder(str(path), ring_capacity=3, meta=meta)
        rec.emit_all(recs)
        assert len(rec.ring) == 3
        paths[name] = (path, rec.close(), rec.ring.records(), rec.counts)
    (jp, jm, jr, jc), (tp, tm, tr, tc) = paths["jax"], paths["port"]
    assert tp.read_bytes() == jp.read_bytes()
    tman, jman = (json.loads(pathlib.Path(m).read_text()) for m in (tm, jm))
    assert (tman.pop("log"), jman.pop("log")) == ("port.jsonl", "jax.jsonl")
    assert tman == jman
    assert tr == jr and tc == jc
    closed = tobs.RunRecorder(None)
    closed.close()
    with pytest.raises(ValueError, match="closed"):
        closed.emit(recs[0])


def _metrics(r):
    return {"loss": 2.5 - 0.125 * r, "lr": 1e-3 * (r + 1),
            "clip_fraction": 0.1 * r, "participants": 4}


@pytest.mark.parametrize("capacity", [1, 3, 10])
def test_metrics_accumulator_flushes_equal_jax(capacity):
    """The same metrics (device scalars beside host numbers) through both
    buffers: equal flushes, in order, at every window; the same refusals
    when full or when the names change."""
    jacc = jobs.MetricsAccumulator(capacity)
    tacc = tobs.MetricsAccumulator(capacity)
    jrows, trows = [], []
    for r in range(7):
        m = _metrics(r)
        jacc.add({k: jnp.asarray(v, jnp.float32) if k != "participants"
                  else v for k, v in m.items()})
        tacc.add({k: torch.tensor(v, dtype=torch.float32)
                  if k != "participants" else v for k, v in m.items()})
        assert len(tacc) == len(jacc)
        if len(jacc) == capacity or r == 6:
            jrows += jacc.flush()
            trows += tacc.flush()
    assert trows == jrows
    assert tacc.flush() == jacc.flush() == []
    for acc in (jacc, tacc):
        acc.add(_metrics(0))
        with pytest.raises(ValueError, match="names changed"):
            acc.add({"loss": 1.0})
        if capacity == 1:
            with pytest.raises(ValueError, match="full"):
                acc.add(_metrics(1))
    with pytest.raises(ValueError):
        tobs.MetricsAccumulator(0)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tobs.profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with tobs.profile_trace(""):
        pass
    assert sorted(p.name for p in tmp_path.iterdir()) == ["prof"]
