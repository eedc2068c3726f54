"""Where the benchmark finds a cell and what belongs to it, by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration and traffic mix, and each metric with the cells that
report it.  Everything else is a file of its own, found by name:

* a configuration: the ``file`` its ``configs`` entry gives
  (``portbench/configs/<name>.json``);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns
  the value or None; a metric split by the end-to-end metric it moves
  (``<name>.<part>``, as ``tokens_per_s.seq``) is read by ``<name>.py``
  unless it has a file of its own;
* a cell's limits on the numbers that decide ``correct``:
  ``portbench/limits/<cell>.json``;
* an architecture, named by a configuration file's ``"arch"`` key
  (`DEFAULT_ARCH` without one): ``portbench/reference/<arch>.py``, its
  sizes, weight schema and float32 reference, and
  ``portbench/programs/<arch>.py``, its mapping onto the program's
  config.  A conf that the reference module made leads back to it
  (`arch_of`).

So a cell, a configuration, a traffic mix, a metric or an architecture
is added as new files and entries in ``BENCHMARK.json``, with no edit to
a file here.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

#: the benchmark's folder, and the checkout's root above it
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the arch of a configuration file with no ``"arch"`` key
DEFAULT_ARCH = "decoder"


class Bench:
    """``BENCHMARK.json`` of a checkout, and the benchmark's files."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.here = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in self.spec['workloads']]})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> Dict[str, float]:
        path = self.here / "limits" / f"{cell}.json"
        if not path.exists():
            return {}
        return {k: float(v) for k, v in
                json.loads(path.read_text())["limits"].items()}

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``kind`` ("end_to_end" or "per_layer") metrics that
        ``cell`` reports: those that list it, and those that list no
        cells."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str) -> ModuleType:
        """The module of ``metrics/<name>.py``, or of the file of the
        name's part before its first dot."""
        path = self.here / "metrics" / f"{name}.py"
        if not path.exists():
            path = self.here / "metrics" / f"{name.split('.', 1)[0]}.py"
        mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def arch(self, conf_json: dict) -> ModuleType:
        """The reference module of configuration file ``conf_json``'s
        arch (``reference/<arch>.py``): ``from_json``, ``schema``,
        ``active_params`` and ``Model``."""
        return self._module("reference", conf_json.get("arch", DEFAULT_ARCH))

    def program(self, conf_json: dict) -> ModuleType:
        """The program module of its arch (``programs/<arch>.py``):
        ``program_config``."""
        return self._module("programs", conf_json.get("arch", DEFAULT_ARCH))

    def _module(self, folder: str, name: str) -> ModuleType:
        """``<folder>/<name>.py`` of this checkout, or of the benchmark's
        own folder where the checkout has none (a test's checkout holds
        only data and what it adds); each file loaded once, and kept in
        ``sys.modules`` so that `arch_of` finds it."""
        if not re.fullmatch(r"[A-Za-z0-9_]+", name):
            raise ValueError(f"arch {name!r}: letters, digits and _ only")
        path = self.here / folder / f"{name}.py"
        own = HERE / folder / f"{name}.py"
        if not path.exists() or path.resolve() == own.resolve():
            if not own.exists():
                raise FileNotFoundError(f"no {folder} module for arch "
                                        f"{name!r}: {path}")
            return importlib.import_module(f"portbench.{folder}.{name}")
        mod_name = "portbench_" + re.sub(r"\W", "_", str(path.resolve()))
        mod = sys.modules.get(mod_name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            try:
                spec.loader.exec_module(mod)
            except BaseException:
                del sys.modules[mod_name]
                raise
        return mod


def arch_of(conf) -> ModuleType:
    """The reference module whose ``from_json`` made ``conf``: the module
    that defines its class."""
    return sys.modules[type(conf).__module__]
