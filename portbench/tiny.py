"""A tiny copy of the benchmark for the CPU tests: the same
``BENCHMARK.json`` cells and metrics over configurations of the same
shape at small widths (the keys of the real files, the sizes cut by
``portbench/tiny_widths/<configuration>.json``, found by name) and
traffic of the same mix at small batches, written to a folder of its
own.  The real configurations and traffic are read, never changed."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import cells

#: the tiny traffic: small batches, a short pool and trace
TRAFFIC = {"batch": 2, "seq": 8, "pool_rounds": 4, "checked_rounds": 2,
           "trace_rounds": 2}


def write(dest: Path, dtype: str = "float32") -> cells.Bench:
    """The tiny benchmark under ``dest``; its configurations in
    ``dtype``."""
    real = cells.Bench()
    dest = Path(dest)
    here = dest / "portbench"
    for sub in ("configs", "traffic"):
        (here / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "limits"):
        shutil.copytree(real.here / sub, here / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(real.spec))
    for c in spec["configs"]:
        d = real.config(c["name"])
        d.update(json.loads((real.here / "tiny_widths" /
                             f"{c['name']}.json").read_text()))
        d["torch_dtype"] = dtype
        c["file"] = f"portbench/configs/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(d, indent=1))
    for w in spec["workloads"]:
        t = real.traffic(w["traffic"])
        t.update(TRAFFIC)
        (here / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return cells.Bench(dest)
