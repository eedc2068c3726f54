"""Build and load the hand-written CUDA kernels, and the launch
constants their wrappers share.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root (named by the hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header rebuilds) and loaded with `ctypes`.  Nothing is built
when a module is imported, and nothing is built for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: the kernels match their op-by-op
              # PyTorch versions bitwise; "/" stays IEEE (no fast math)
              "-fmad=false", "-Xptxas", "-v")

#: the kernel sources of the port, one shared library each
SOURCES = ("sophia_update", "quantize", "stale_accum", "robust_agg")

#: runtime dtype codes of the kernels' load/store helpers
#: (``csrc/dtype_io.cuh``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1,
               torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}

#: blocks per SM of the grid-stride launches
BLOCKS_PER_SM = 8


@dataclass(frozen=True)
class BuildInfo:
    name: str
    path: Path
    seconds: float          # 0.0 when the library was already built
    ptxas: List[str]        # the -Xptxas -v lines: registers, spills


_LOCK = threading.Lock()
_BUILDS: Dict[str, BuildInfo] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    return torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device()
    ).multi_processor_count


def grid_blocks(work_items: int, device: torch.device) -> int:
    """Blocks of a grid-stride launch over ``work_items`` blocks' worth
    of work: enough to fill every SM, never more than the work."""
    return max(1, min(work_items, sm_count(device.index) * BLOCKS_PER_SM))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, BuildInfo]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Raises with the compiler's
    output if any build fails."""
    with _LOCK:
        todo = [n for n in names if n not in _BUILDS]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _target(n)
            if out.exists():
                _BUILDS[n] = BuildInfo(n, out, 0.0, [])
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (out, tmp, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (out, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, out)
            ptxas = [ln.strip() for ln in log.splitlines()
                     if "ptxas" in ln or "spill" in ln]
            _BUILDS[n] = BuildInfo(n, out, time.perf_counter() - t0, ptxas)
        if failed:
            raise RuntimeError("\n".join(failed))
        return {n: _BUILDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use)."""
    lib = _LIBS.get(name)
    if lib is None:
        info = build_all((name,))[name]
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(info.path))
                _LIBS[name] = lib
    return lib
