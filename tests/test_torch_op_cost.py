"""`repro_torch.launch.op_cost.OpCost` and the kernels' shape-only path
(`repro_torch.kernels.cost`), on the CPU.

The peak tracker and the byte count are exact on hand-built chains of
ops (views and allocations at 0 bytes, broadcasts at their distinct
elements, in-place ops writing once).  Each of the fifteen kernel entry
points, given fake tensors, returns the real CPU call's shapes and
dtypes and records the bytes `kernels/cost.py: launch_bytes` counts over
the real call's operands and outputs; given real CPU tensors it records
nothing.  The traced GEMM FLOPs of one loss + grad at reduced size match
the ``dot`` FLOPs of `repro.launch.hlo_cost.HloCost` over the jitted JAX
loss-and-grad, with JAX's layer rematerialisation off (the port keeps
its activations; with remat on, JAX's default, the layers' forward GEMMs
run twice: minicpm-2b's count with it is printed too).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch.hlo_cost import HloCost
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.kernels import cost, ops, quantize, robust_agg
from repro_torch.kernels import sophia_update, stale_accum
from repro_torch.launch.op_cost import KERNEL_NAMES, OpCost
from repro_torch.models import transformer as TT

HP = dict(beta1=0.9, beta2=0.95, rho=0.04, eps=1e-12, weight_decay=1e-4)
N, R, C = 3, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Small real CPU ops on one intra-op thread: under pytest-xdist the
    default pool oversubscribes the cores and the ops wait on each other
    (a fake-tensor trace computes nothing and is unaffected)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_peak_and_bytes_exact_on_a_chain():
    with FakeTensorMode(), OpCost() as oc:
        a = torch.empty(1000)                  # 4000 B, nothing written
        b = a.view(10, 100)                    # a view: no storage, 0 B
        c = b * 2                              # reads 4000, writes 4000
        assert (oc.live_bytes, oc.peak_bytes) == (8000, 8000)
        del a, b                               # the base goes with its view
        assert oc.live_bytes == 4000
        d = c.t().contiguous()                 # t: a view; the copy 8000
        assert (oc.live_bytes, oc.peak_bytes) == (8000, 8000)
        d.add_(1.0)                            # in place: 4000 + 4000
        d.copy_(c.t())                         # reads c only: 4000 + 4000
        e = torch.empty(100).expand(10, 100) + 1   # 400 read, 4000 written
        assert oc.peak_bytes == 8000 + 400 + 4000
        del c, d, e
        assert oc.live_bytes == 0
    s = oc.summary()
    assert s["bytes_by_opcode"] == {"mul": 8000, "clone": 8000,
                                    "add_": 8000, "copy_": 8000,
                                    "add": 4400}
    assert s["bytes"] == 36400 and s["flops"] == 0
    assert s["peak_bytes"] == 12400
    assert s["launches"] == {k: 0 for k in KERNEL_NAMES}


def test_matmul_flops_by_dtype():
    with FakeTensorMode(), OpCost() as oc:
        x = torch.empty(4, 8, 16, dtype=torch.bfloat16)
        w = torch.empty(16, 32, dtype=torch.bfloat16)
        x @ w
        torch.empty(5, 6) @ torch.empty(6, 7)
    assert oc.summary()["flops_by_dtype"] == {
        "bfloat16": 2.0 * 32 * 16 * 32, "float32": 2.0 * 5 * 6 * 7}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _flat_inputs(shape, n, seed=0):
    g = _gen(seed)
    return [torch.randn(shape, generator=g) for _ in range(n)]


def _entries():
    """entry name -> (call(*tensors), the real CPU operand list that the
    wrapper's launch reads, in its order)."""
    th, m, h, gr, hh = _flat_inputs((R, C), 5)
    bt, bm, bh, bg, bhh = _flat_inputs((N, R, C), 5, 1)
    h, bh = h.abs(), bh.abs()
    u, bu = torch.rand(R, C, generator=_gen(2)), torch.rand(
        N, R, C, generator=_gen(3))
    sc, bsc = torch.full((R, 1), 0.1), torch.full((N, R, 1), 0.1)
    v0, bv = torch.tensor(0.3), torch.full((N,), 0.3)
    wires = torch.randn(5, R, C, generator=_gen(4))
    w5, s5 = torch.ones(5), torch.full((5,), 0.5)
    tree = {"a": torch.randn(R, C, generator=_gen(5)),
            "b": torch.randn(3, generator=_gen(6))}
    trees = [tree] + [{k: torch.rand(v.shape, generator=_gen(7 + i))
                       for k, v in tree.items()} for i in range(4)]
    q = dict(qmax=127)
    return {
        "sophia_update_flat": (lambda *t: sophia_update.sophia_update_flat(
            *t, 1, 0.01, **HP), [th, m, h, gr, hh]),
        "sophia_update_batched": (
            lambda *t: sophia_update.sophia_update_batched(
                *t, 0, 0.01, **HP, inplace=True), [bt, bm, bh, bg, bhh]),
        "quant_roundtrip_flat": (lambda *t: quantize.quant_roundtrip_flat(
            *t, **q), [th, u, sc]),
        "quant_roundtrip_batched": (
            lambda *t: quantize.quant_roundtrip_batched(*t, **q),
            [bt, bu, bsc]),
        "uplink_roundtrip_flat": (lambda *t: quantize.uplink_roundtrip_flat(
            *t, **q), [th, m, gr, u, sc]),
        "uplink_roundtrip_batched": (
            lambda *t: quantize.uplink_roundtrip_batched(*t, **q),
            [bt, th, bg, bu, bsc]),
        "broadcast_roundtrip_flat": (
            lambda *t: quantize.broadcast_roundtrip_flat(*t, **q),
            [th, m, gr, u, sc]),
        "broadcast_roundtrip_batched": (
            lambda *t: quantize.broadcast_roundtrip_batched(*t, **q),
            [th, bm, bg, bu, bsc]),
        "sign_roundtrip_flat": (quantize.sign_roundtrip_flat, [th, v0]),
        "sign_roundtrip_batched": (quantize.sign_roundtrip_batched,
                                   [bt, bv]),
        "topk_threshold_flat": (quantize.topk_threshold_flat, [th, v0]),
        "topk_threshold_batched": (quantize.topk_threshold_batched,
                                   [bt, bv]),
        "stale_accum_flat": (lambda x, w: stale_accum.stale_accum_flat(
            x, w, 0.25), [wires, w5]),
        "robust_agg_flat": (lambda x, w, s: robust_agg.robust_agg_flat(
            x, w, s, trim=1), [wires, w5, s5]),
        "sophia_fused_step": (
            lambda *leaves: ops.sophia_fused_step(
                *[dict(zip(("a", "b"), leaves[i:i + 2]))
                  for i in range(0, 10, 2)], 1, lr=0.01, **HP),
            [t[k] for t in trees for k in ("a", "b")]),
    }


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [x for o in out for x in _leaves(o)]


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_shape_only_path_of_each_entry(name):
    """Fake operands: the real CPU call's shapes and dtypes, one launch
    recorded with `launch_bytes` of the real call's operands and
    outputs, and nothing computed.  Real CPU operands: the plain version
    runs and the trace records nothing."""
    call, real = _entries()[name]
    with OpCost() as oc_real:
        want = _leaves(call(*[t.clone() for t in real]))
    assert sum(oc_real.launches.values()) == 0
    assert not [k for k in oc_real.by_op if k.startswith("kernel:")]
    mode = FakeTensorMode()
    fakes = [mode.from_tensor(t) for t in real]
    assert all(map(cost.shape_only, fakes))
    assert not any(map(cost.shape_only, real))
    with mode, OpCost() as oc:
        got = _leaves(call(*fakes))
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]
    assert oc.launches == {k: int(k == name) for k in KERNEL_NAMES}
    nbytes = cost.launch_bytes(real, want)
    assert oc.by_op[f"kernel:{name}"][1] == nbytes
    assert oc.summary()["bytes"] == nbytes      # no other op moved a byte
    before = sum(sophia_update.LAUNCHES.values()) + sum(
        quantize.LAUNCHES.values())
    assert before == 0, "the shape-only path counts no kernel launch"


def _jax_dot_flops(jcfg, B, S):
    task = JT.LMTask(jcfg)
    p = jax.eval_shape(lambda k: JT.init_lm(k, jcfg), jax.random.PRNGKey(0))
    lab = jax.ShapeDtypeStruct((B, S), jnp.int32)
    b = ({"embeds": jax.ShapeDtypeStruct((B, S, jcfg.d_model),
                                         JT.param_dtype(jcfg))}
         if jcfg.embedding_inputs else {"tokens": lab})
    b["labels"] = lab
    f = jax.jit(jax.value_and_grad(lambda p, b: task.loss(p, b)))
    hlo = f.lower(p, b).compile().as_text()
    return HloCost(hlo).summary()["flops_by_opcode"]["dot"]


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-2b"])
def test_gemm_flops_match_hlo_cost(arch):
    B, S = 2, 32
    tcfg = configs.get_model_config(arch).reduced(d_model=128)
    jcfg = jconfigs.get_model_config(arch).reduced(d_model=128)
    with FakeTensorMode(allow_fallback_kernels=False), OpCost() as oc:
        with oc.setup():
            params = {k: v.requires_grad_(True) for k, v in
                      TT.init_lm(torch.Generator().manual_seed(0),
                                 tcfg).items()}
            batch = {"tokens": torch.zeros((B, S), dtype=torch.int64),
                     "labels": torch.zeros((B, S), dtype=torch.int64)}
        loss = TT.LMTask(tcfg).loss(params, batch)
        torch.autograd.grad(loss.sum(), list(params.values()),
                            allow_unused=True)
    got = sum(oc.summary()["flops_by_dtype"].values())
    want = _jax_dot_flops(dataclasses.replace(jcfg, train_remat=False), B, S)
    print(f"{arch}: port {got} GEMM FLOPs; JAX dot {want} without remat")
    if arch == "minicpm-2b":
        remat = _jax_dot_flops(jcfg, B, S)
        print(f"{arch}: JAX dot {remat} with remat (the default; the port "
              f"counts {got / remat:.4f} of it)")
    assert abs(got / want - 1.0) <= 0.02
