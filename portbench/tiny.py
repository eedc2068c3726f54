"""A tiny copy of the benchmark for the CPU tests: the same
``BENCHMARK.json`` cells and metrics over configurations of the same
shape at small widths (the keys of the real files, the sizes cut) and
traffic of the same mix at small batches, written to a folder of its
own.  The real configurations and traffic are read, never changed."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import cells

#: the sizes of the tiny configurations, by the real file's name
WIDTHS = {
    "minicpm-2b.l2": {"hidden_size": 64, "num_attention_heads": 4,
                      "num_key_value_heads": 4, "intermediate_size": 128,
                      "vocab_size": 300},
    "deepseek-v2-lite-16b.l2": {
        "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "n_routed_experts": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 32, "n_shared_experts": 1,
        "vocab_size": 300},
}
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
        d.update(WIDTHS[c["name"]])
        d["torch_dtype"] = dtype
        c["file"] = f"portbench/configs/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(d, indent=1))
    for w in spec["workloads"]:
        t = real.traffic(w["traffic"])
        t.update(TRAFFIC)
        (here / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return cells.Bench(dest)
