"""The benchmark finds every cell, configuration, traffic mix, metric and
arch by name; a new cell, traffic mix, metric or arch is picked up as
new files and entries alone; ``BENCHMARK.json`` keeps to its documented
shape; the configuration files state the program's configurations as
run."""
import dataclasses
import hashlib
import json
import re
import shutil

import pytest
import torch

from portbench import (cells, check, control, harness, tiny, traffic,
                       weights)
from portbench.programs import decoder as program_decoder
from portbench.reference import decoder

BENCH = cells.Bench()
CELLS = [w["name"] for w in BENCH.spec["workloads"]]
METRICS = [m["name"] for kind in ("end_to_end", "per_layer")
           for m in BENCH.spec[kind]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = BENCH.workload(cell)
    d = BENCH.config(w["config"])
    conf = BENCH.arch(d).from_json(d)
    tr = BENCH.traffic(w["traffic"])
    assert tr["checked_rounds"] == 3
    if BENCH.arch(d) is decoder:
        assert conf.num_hidden_layers == 2
    limits = BENCH.limits(cell)
    assert limits and set(limits) <= set(check.NUMBERS)
    assert {"grad_dist", "change_dist"} <= set(limits)
    e2e = {m["name"] for m in BENCH.metrics(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    moved = {m["moves"] for m in BENCH.metrics(cell, "per_layer")}
    assert moved and moved <= e2e


@pytest.mark.parametrize("name", [c["name"] for c in BENCH.spec["configs"]
                                  if "arch" not in BENCH.config(c["name"])])
def test_config_without_arch_gets_the_decoder(name):
    d = BENCH.config(name)
    assert BENCH.arch(d) is decoder and BENCH.program(d) is program_decoder
    assert cells.arch_of(decoder.from_json(d)) is decoder


@pytest.mark.parametrize("arch,error", [("no_such_arch", FileNotFoundError),
                                        ("../decoder", ValueError)])
def test_unknown_arch_refused(arch, error):
    with pytest.raises(error):
        BENCH.arch({"arch": arch})


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    """A split name (``tokens_per_s.seq``) is read by its base's file."""
    assert callable(BENCH.reader(metric).read)


def test_benchmark_json_shape():
    spec = BENCH.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(spec["workloads"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH.spec["configs"]])
def test_config_file_is_the_program_config_as_run(name):
    from repro_torch import configs
    d = BENCH.config(name)
    want = dataclasses.replace(configs.get_model_config(d["port"]["arch"]),
                               num_layers=d["port"]["layers"])
    assert harness.program_config(d) == want


@pytest.mark.parametrize("name,params", [("minicpm-2b.l2", 405_220_608),
                                         ("deepseek-v2-lite-16b.l2",
                                          1_589_128_192)])
def test_weights_have_the_program_layout(name, params):
    from repro_torch.models import transformer as T
    d = BENCH.config(name)
    conf = BENCH.arch(d).from_json(d)
    port = T.init_lm(T._ShapeOnly(), harness.program_config(d))
    assert {k: (tuple(v.shape), v.dtype) for k, v in port.items()} == {
        k: (s, dt) for k, (s, dt, _) in weights.schema(conf).items()}
    assert weights.count(conf) == params


def test_new_cell_traffic_and_metric_are_picked_up(tmp_path):
    """A cell over a new traffic mix, with a new metric, added as files
    and BENCHMARK.json entries only, runs end to end (tiny, on the
    CPU)."""
    bench = tiny.write(tmp_path, dtype="float32")
    here = bench.here
    t = bench.traffic("par-c4.j5.b2s256")
    t.update(clients=2, seq=8)
    (here / "traffic" / "par-c2.b2s8.json").write_text(json.dumps(t))
    (here / "limits" / "mc-extra.json").write_text(json.dumps(
        json.loads((here / "limits" /
                    "minicpm2b-l2.par-c4.j5.b2s256.json").read_text())))
    (here / "metrics" / "rounds_done.py").write_text(
        "def read(run):\n    return float(run.rounds)\n")
    spec = bench.spec
    spec["workloads"].append({"name": "mc-extra", "config": "minicpm-2b.l2",
                              "traffic": "par-c2.b2s8", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "rounds_done", "unit": "rounds",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["mc-extra"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = harness.run("mc-extra", 7, 0.05, False, torch.device("cpu"),
                      cells.Bench(tmp_path))
    assert res["correct"] is True
    assert res["metrics"]["rounds_done"]["value"] == res["attempted"] >= 1
    assert set(res["metrics"]) == {"rounds_done", "setup_s"}
    assert list(res)[-1] == "check"


def hashes(folder):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()}


def test_new_arch_is_picked_up_as_files(tmp_path):
    """An arch added as files and BENCHMARK.json entries only: a copy of
    the decoder's two modules under a new name, a configuration that
    names it and a cell over it (tiny, on the CPU).  The lookup finds
    the copies, the weights are the decoder's bit for bit, program and
    reference agree at float32, the float8 control builds for the new
    ``Model`` and is judged not correct, and no file that was there
    changes."""
    bench = tiny.write(tmp_path, dtype="float32")
    here = bench.here
    before = hashes(here)
    arch, name, cell = "decoder_copy", "copy.l2", "copy-l2.par-c4.j5.b2s256"
    for folder in ("reference", "programs"):
        (here / folder).mkdir(exist_ok=True)
        shutil.copy(cells.HERE / folder / "decoder.py",
                    here / folder / f"{arch}.py")
    base_d = bench.config("minicpm-2b.l2")
    d = dict(base_d, name=name, arch=arch)
    (here / "configs" / f"{name}.json").write_text(json.dumps(d))
    shutil.copy(here / "limits" / "minicpm2b-l2.par-c4.j5.b2s256.json",
                here / "limits" / f"{cell}.json")
    spec = bench.spec
    spec["configs"].append({"name": name, "source": "test",
                            "file": f"portbench/configs/{name}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": "par-c4.j5.b2s256", "chips": 1,
                              "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = cells.Bench(tmp_path)

    ref, prog = bench.arch(d), bench.program(d)
    assert ref.__file__ == str(here / "reference" / f"{arch}.py")
    assert prog.__file__ == str(here / "programs" / f"{arch}.py")
    assert bench.arch(d) is ref and ref is not decoder
    conf, base = ref.from_json(d), decoder.from_json(base_d)
    assert cells.arch_of(conf) is ref and cells.arch_of(base) is decoder
    assert harness.program_config(d, bench) == harness.program_config(base_d)

    def draw(c):
        return weights.make(c, traffic.generator(torch.device("cpu"), 5,
                                                 traffic.WEIGHTS))
    mine, theirs = draw(conf), draw(base)
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in theirs)

    res = harness.run(cell, 3, 0.05, False, torch.device("cpu"), bench)
    assert res["correct"] is True, res["check"]
    gaps = {k: v["value"] for k, v in res["check"].items()}
    assert gaps.pop("change_dist") < 2e-3 and max(gaps.values()) < 2e-5, gaps

    fp8 = control.fp8_model(ref.Model)
    assert issubclass(fp8, ref.Model) and fp8.lin is not ref.Model.lin
    tr = bench.traffic("par-c4.j5.b2s256")
    inputs = harness.Inputs(conf, tr, 17, torch.device("cpu"))
    ctl = harness.reference_readout(conf, tr, inputs, model=fp8, keep=True)
    r = harness.reference_readout(conf, tr, inputs, others=[ctl])
    assert not check.verdict(check.compare(ctl, r), bench.limits(cell))[0]

    after = hashes(here)
    assert {p: h for p, h in after.items() if p in before} == before
