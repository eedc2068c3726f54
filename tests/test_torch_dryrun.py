"""The port's dry run (`repro_torch.launch.dryrun`) at reduced size on
the CPU: the five combinations of the JAX package's
tests/test_dryrun_small.py, traced shape-only (`--reduced`, one local
iteration; the sequential MoE round traces 8 clients) end ``ok`` with a
record of the JAX record's keys; its skip rules; the donation check
(it finds the one resident buffer the packed-resident round replaces,
the params', with its bytes, and fails on it); and the trace's kernel
launches equal the real CPU round's calls of the kernel entries."""
import json

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import fed as tfed
from repro_torch.launch import api, dryrun
from test_torch_op_cost import one_cpu_thread  # noqa: F401 (autouse)

COMBOS = [
    ("minicpm-2b", "train_4k"),
    ("qwen3-moe-235b-a22b", "train_4k"),       # sequential + MoE
    ("gemma2-9b", "prefill_32k"),
    ("deepseek-v2-lite-16b", "decode_32k"),    # MLA cache
    ("xlstm-1.3b", "long_500k"),               # recurrent decode
]
#: the JAX record's keys that the port's record keeps
JAX_KEYS = ("status", "entry", "roofline", "params", "model_flops_total",
            "useful_flops_ratio", "bytes_by_opcode", "flops_by_opcode",
            "collective_bytes")


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_dryrun_reduced(arch, shape, tmp_path, capsys):
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", arch, "--shape", shape, "--reduced",
                     "--local-iters", "1", "--out-dir", str(tmp_path)])
    assert ex.value.code == 0, capsys.readouterr().out
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == [f"{arch}_{shape}_card.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert all(k in rec for k in JAX_KEYS)
    assert rec["op_flops_per_dev"] > 0 and rec["op_bytes_per_dev"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["collective_bytes"]["total"] == 0.0
    assert rec["peak_bytes"] > 0 and rec["trace_s"] > 0
    assert rec["fits"] is None and rec["memory_bytes"] is None
    train = shape == "train_4k"
    assert (sum(rec["launches"].values()) > 0) == train
    if train:
        fed = api.resolve_fed(arch, local_iters=1)
        entry = ("sophia_update_batched" if fed.strategy == "parallel"
                 else "sophia_update_flat")
        per_step = 1 if fed.strategy == "parallel" else fed.num_clients
        assert rec["launches"][entry] == per_step


def test_dryrun_skip_rules_and_fits(tmp_path, capsys):
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                     "--reduced", "--out-dir", str(tmp_path)])
    assert ex.value.code == 0
    assert "skipped" in capsys.readouterr().out
    rec = dryrun.run_one("chatglm3-6b", "long_500k", out_dir="")
    assert rec["status"] == "skipped"
    rec = dryrun.run_one("chatglm3-6b", "decode_32k", reduced=True,
                         out_dir="", memory_bytes=10 ** 6)
    assert rec["fits"] is False and rec["memory_bytes"] == 10 ** 6


def test_donation_check(capsys):
    """The round returns the aggregate as a new params buffer (ROADMAP
    queue 3): the check reports exactly that buffer's bytes, every other
    resident buffer (the clients' m and h, updated in place by the
    kernel) kept, and exits 1."""
    bundle = api.build_train("minicpm-2b", reduced=True, local_iters=2,
                             packed_state=True)
    with FakeTensorMode():
        state = bundle.make_args()[0]
        params_b = state["params"].untyped_storage().nbytes()
        resident = sum(t.untyped_storage().nbytes()
                       for t in dryrun._resident(state).values())
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "minicpm-2b", "--check-donation",
                     "--local-iters", "2", "--out-dir", ""])
    out = capsys.readouterr().out
    assert ex.value.code == 1, out
    assert (f"{params_b} of {resident} bytes ({{'params': {params_b}}})"
            in out), out
    assert len(dryrun._resident(state)) > 1


def test_trace_launches_equal_the_cpu_rounds_calls(monkeypatch):
    """The same reduced round traced and run on the CPU: the trace's
    launches of each kernel are the real round's calls of its entry."""
    calls = {}
    real = tfed.sophia_step_flat

    def counted(theta, *a, **kw):
        name = ("sophia_update_batched" if theta.ndim == 3
                else "sophia_update_flat")
        calls[name] = calls.get(name, 0) + 1
        return real(theta, *a, **kw)
    bundle = api.build_train("hubert-xlarge", reduced=True,
                             local_iters=3,
                             fed_overrides={"num_clients": "2", "tau": "2"})
    traced = dryrun.trace(bundle).summary()["launches"]
    monkeypatch.setattr(tfed, "sophia_step_flat", counted)
    state, batches, gen = bundle.make_args()
    _, metrics = bundle.fn(state, batches, gen)
    assert torch.isfinite(metrics["loss"])
    assert {k: v for k, v in traced.items() if v} == calls == {
        "sophia_update_batched": 3}
