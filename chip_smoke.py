#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in this
checkout (into ``build/repro_torch/``), holds each kernel against its
plain PyTorch version on the card, drives the synchronous Fed-Sophia
round at the paper's full MLP width (hidden 128, 32 clients, J=10,
tau=10, batch 64, 60,000 synthetic MNIST-shaped images), checks a small
round against the same round on the CPU, and times each kernel with
CUDA events.  Any failure ends the run with a nonzero exit; nothing is
caught.  Without a card it exits nonzero before printing any result.

The second-to-last line of standard output is the ``{"kernels": [...]}``
record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import cnn_mnist, mlp_mnist  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.fed import FedEngine  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sophia_update as tk  # noqa: E402
from repro_torch.kernels.ref import sophia_update_ref  # noqa: E402
from repro_torch.models.small import CNNTask, MLPTask  # noqa: E402

SEED = 0
HP = dict(beta1=0.9, beta2=0.95, rho=0.04, eps=1e-12, weight_decay=1e-4)
LR = 3e-3

# the main path: the paper's MNIST experiment at full width
CLIENTS, LOCAL_ITERS, TAU, BATCH, IMAGES = 32, 10, 10, 64, 60_000
MLP_ROUNDS, CNN_ROUNDS = 5, 2
SOPHIA_LR, FEDAVG_LR = 0.02, 0.05
MLP_PACKED = (116, 1024)   # 118,282 parameters, MLP hidden 128
CNN_PACKED = (21, 1024)    # 20,490 parameters, CNN channels (16, 32)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: fp32 operations per coordinate of the Sophia update (m: 3, h EMA: 3,
#: h select: 3, decay: 2, max: 1, divide: 1, clip: 2, step: 2)
SOPHIA_OPS = 17
TIMED_LAUNCHES = 200
#: timed calls queued at once, and the sleep (GPU clock cycles, about
#: 50 ms) they queue behind
TIMED_CHUNK = 50
SLEEP_CYCLES = 100_000_000

#: small-round check against the CPU: MLP hidden 16, C=4, J=3, tau=2,
#: B=8, 2 rounds.  Band: cuBLAS and the CPU GEMM sum the matmuls in
#: different orders (a few fp32 ulps per op, compounded over 6 steps)
SMALL = dict(hidden=16, clients=4, iters=3, tau=2, batch=8, rounds=2)
SMALL_RTOL, SMALL_ATOL = 1e-4, 1e-5


def gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def sync() -> None:
    torch.cuda.synchronize()


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel checks
def sophia_inputs(shape, device, seed, dtypes=(torch.float32,) * 3,
                  special=False):
    """theta, m, h, g, h_hat on ``device``; theta/m/h stored in
    ``dtypes``.  h, h_hat >= 0 with every 17th h exactly 0 (the eps floor
    and the clip both bite).  Narrow storage scales g and h_hat so that m
    and h leave the fp8 ranges at some coordinates; ``special`` puts NaN
    and inf into h, g and theta."""
    rs = np.random.default_rng(seed)
    theta = rs.standard_normal(shape)
    m = 0.1 * rs.standard_normal(shape)
    h = np.abs(0.01 * rs.standard_normal(shape))
    h.reshape(-1)[::17] = 0.0
    g = 0.5 * rs.standard_normal(shape)
    hh = np.abs(0.02 * rs.standard_normal(shape))
    if any(dt.itemsize == 1 for dt in dtypes):
        g *= 1e4
        hh *= 1e8
    if special:
        for arr, val in ((h, np.nan), (g, np.inf), (g, -np.inf),
                         (theta, np.nan), (h, np.inf)):
            arr.reshape(-1)[rs.integers(0, arr.size, 64)] = val
    xs = [torch.tensor(x, dtype=torch.float32, device=device)
          for x in (theta, m, h, g, hh)]
    return [x.to(dt) for x, dt in zip(xs[:3], dtypes)] + xs[3:]


def check_kernels(device):
    """Each kernel against its plain version on the card, bitwise
    (compared as raw bytes, NaN included).  Returns the largest
    |kernel - plain| over finite coordinates, per kernel."""
    bf16 = (torch.bfloat16,) * 3
    fp8 = (torch.float32, torch.float8_e4m3fn, torch.float8_e5m2)
    N, R, C = (CLIENTS,) + MLP_PACKED
    cases = [  # (label, entry, shape, dtypes, do_h, special, in place)
        ("batched fp32 do_h=0", "batched", (N, R, C), None, 0, False, False),
        ("batched fp32 do_h=1", "batched", (N, R, C), None, 1, False, False),
        ("batched fp32 in place", "batched", (N, R, C), None, 1, False, True),
        ("batched bf16 theta/m/h", "batched", (N, R, C), bf16, 1, False,
         False),
        ("batched bf16 do_h=0", "batched", (N, R, C), bf16, 0, False, False),
        ("batched e4m3 m + e5m2 h", "batched", (N, R, C), fp8, 1, False,
         False),
        ("batched NaN/inf", "batched", (N, R, C), None, 1, True, False),
        ("batched fp8 NaN/inf", "batched", (N, R, C), fp8, 1, True, False),
        ("flat fp32", "flat", (R, C), None, 1, False, False),
        ("flat fp32 in place", "flat", (R, C), None, 0, False, True),
        ("batched ragged", "batched", (3, 7, 1000), None, 1, False, False),
        ("flat ragged e4m3 m + e5m2 h", "flat", (7, 1000), fp8, 1, False,
         False),
    ]
    fns = {"batched": tk.sophia_update_batched, "flat": tk.sophia_update_flat}
    err = {"sophia_update_batched": 0.0, "sophia_update_flat": 0.0}
    for i, (label, entry, shape, dts, do_h, special, inplace) in enumerate(
            cases):
        ins = sophia_inputs(shape, device, SEED + i,
                            dts or (torch.float32,) * 3, special)
        want = sophia_update_ref(*ins, do_h, lr=LR, **HP)
        before = tk.LAUNCHES[f"sophia_update_{entry}"]
        args = [x.clone() for x in ins[:3]] + ins[3:] if inplace else ins
        got = fns[entry](*args, do_h, LR, inplace=inplace, **HP)
        sync()
        if tk.LAUNCHES[f"sophia_update_{entry}"] != before + 1:
            raise SystemExit(f"kernel check {label}: the kernel did not "
                             "launch")
        worst = 0.0
        for name, g_, w_ in zip(("theta", "m", "h"), got, want):
            if g_.dtype != w_.dtype or g_.shape != w_.shape:
                raise SystemExit(f"kernel check {label}: {name} came back "
                                 f"{g_.dtype}{tuple(g_.shape)}, plain "
                                 f"{w_.dtype}{tuple(w_.shape)}")
            gf, wf = g_.float(), w_.float()
            fin = torch.isfinite(gf) & torch.isfinite(wf)
            worst = max(worst, float((gf - wf).abs()[fin].max()))
            same = torch.equal(g_.view(torch.uint8), w_.view(torch.uint8))
            if not same:
                raise SystemExit(
                    f"kernel check {label}: {name} differs from the plain "
                    f"version (max |diff| {worst}, "
                    f"{int((g_.view(torch.uint8) != w_.view(torch.uint8)).sum())}"
                    " bytes differ)")
        key = f"sophia_update_{entry}"
        err[key] = max(err[key], worst)
        print(f"  {label:30s} {tuple(shape)} bitwise equal")
    return err


def fp8_overflow_rule(device):
    """What ``Tensor.to(float8_*)`` stores past the fp8 range, on the
    card; the kernel checks above hold the kernel to the same."""
    vals = torch.tensor([448.0, 464.0, 465.0, 480.0, 1e6, float("inf"),
                         57344.0, 61439.0, 61440.0, float("nan")],
                        device=device)
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        got = vals.to(dt).float().tolist()
        print(f"  {str(dt):22s} "
              + "  ".join(f"{v:g}->{o:g}" for v, o in
                          zip(vals.tolist(), got)))


# --------------------------------------------------------------- main path
def make_data(device):
    x, y = syn.make_image_data(gen(device, SEED), IMAGES, "mnist", noise=1.3)
    part = syn.dirichlet_partition(SEED + 1, y, CLIENTS, alpha=0.5)
    train_idx, _ = syn.train_test_split(part)
    return x, y, train_idx


def run_rounds(task, fed, data, rounds, device):
    """``rounds`` rounds through `FedEngine.round`; returns the final
    state, the per-round losses and host seconds per round (each timed
    around work that ends in a device synchronise)."""
    x, y, train_idx = data
    engine = FedEngine(task, fed, device=device)
    state = engine.init(gen(device, SEED + 3))
    noise = gen(device, SEED + 1000)
    losses, secs = [], []
    for r in range(rounds):
        batches = syn.client_batches(gen(device, SEED + 100 + r), x, y,
                                     train_idx, BATCH)
        sync()
        t0 = time.perf_counter()
        state, metrics = engine.round(state, batches, generator=noise)
        sync()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    params = engine.unpack_params(state)
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite loss: {losses}")
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise SystemExit("non-finite parameters after the run")
    return engine, state, losses, secs


def drive(label, task, fed, data, rounds, device, want):
    """One path of the main run, with every launch count set to 0 just
    before it and read just after.  ``want``: the exact launch count of
    each kernel on this path."""
    tk.reset_launches()
    engine, state, losses, secs = run_rounds(task, fed, data, rounds,
                                             device)
    got = dict(tk.LAUNCHES)
    print(f"{label}: losses {losses}")
    print(f"{label}: seconds per round {secs}")
    print(f"{label}: launches {got}")
    if got != want:
        raise SystemExit(f"{label}: launches {got}, want {want}")
    return engine, state, losses, secs


def main_path(device):
    """The main path's runs; returns each kernel's launch count on its
    own path."""
    data = make_data(device)
    print(f"data: {IMAGES} images {tuple(data[0].shape)} on {device}, "
          f"{CLIENTS} clients x {data[2].shape[1]} train samples")
    mlp = MLPTask(hidden=mlp_mnist.HIDDEN)
    sophia = FedConfig(num_clients=CLIENTS, local_iters=LOCAL_ITERS, tau=TAU,
                       lr=SOPHIA_LR, optimizer="fed_sophia",
                       strategy="parallel")
    zero = {"sophia_update_flat": 0, "sophia_update_batched": 0}

    torch.cuda.reset_peak_memory_stats()
    engine, state, losses, secs = drive(
        "fed_sophia parallel MLP-128", mlp, sophia, data, MLP_ROUNDS, device,
        {**zero, "sophia_update_batched": MLP_ROUNDS * LOCAL_ITERS})
    packed = tuple(state["client_opt"].m.shape[1:])
    if engine.num_params(state) != 118_282 or packed != MLP_PACKED:
        raise SystemExit(f"MLP-128 packs {engine.num_params(state)} "
                         f"parameters as {packed}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"fed_sophia local loss did not fall: {losses}")
    steady = sum(secs[1:]) / len(secs[1:])
    launches = {"sophia_update_batched": tk.LAUNCHES["sophia_update_batched"]}
    print(f"fed_sophia parallel MLP-128: steady seconds per round "
          f"(mean of rounds 1-{MLP_ROUNDS - 1}) {steady}; peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes")
    profile_round(engine, state, data, device, steady)

    fedavg = FedConfig(num_clients=CLIENTS, local_iters=LOCAL_ITERS,
                       lr=FEDAVG_LR, optimizer="fedavg", strategy="parallel")
    drive("fedavg parallel MLP-128", mlp, fedavg, data, MLP_ROUNDS, device,
          zero)

    seq = FedConfig(num_clients=CLIENTS, local_iters=LOCAL_ITERS, tau=TAU,
                    lr=SOPHIA_LR, optimizer="fed_sophia",
                    strategy="sequential")
    drive("fed_sophia sequential MLP-128", mlp, seq, data, 1, device,
          {**zero, "sophia_update_flat": CLIENTS * LOCAL_ITERS})
    launches["sophia_update_flat"] = tk.LAUNCHES["sophia_update_flat"]

    cnn = CNNTask(channels=cnn_mnist.CHANNELS)
    engine, state, _, _ = drive(
        "fed_sophia parallel CNN-(16,32)", cnn, sophia, data, CNN_ROUNDS,
        device, {**zero, "sophia_update_batched": CNN_ROUNDS * LOCAL_ITERS})
    packed = tuple(state["client_opt"].m.shape[1:])
    if engine.num_params(state) != 20_490 or packed != CNN_PACKED:
        raise SystemExit(f"CNN packs {engine.num_params(state)} parameters "
                         f"as {packed}")
    return launches


# ------------------------------------------------------- small-round check
def small_round_check(device):
    """Two small rounds on the card against the same rounds on the CPU
    (plain versions there): same initial weights, batches and GNB noise."""
    s = SMALL
    task = MLPTask(hidden=s["hidden"])
    rs = np.random.default_rng(SEED)
    x = torch.tensor(rs.standard_normal((256, 28, 28, 1)), dtype=torch.float32)
    y = torch.tensor(rs.integers(0, 10, 256))
    part = syn.dirichlet_partition(SEED, y, s["clients"], alpha=0.5)
    init = task.init(gen("cpu", SEED))
    for strategy in ("parallel", "sequential"):
        fed = FedConfig(num_clients=s["clients"], local_iters=s["iters"],
                        tau=s["tau"], lr=0.02, strategy=strategy)
        out = {}
        for dev in ("cpu", device):
            engine = FedEngine(task, fed, device=dev)
            state = engine.init_from_params(
                {k: v.to(dev) for k, v in init.items()})
            losses = []
            for r in range(s["rounds"]):
                b = syn.client_batches(gen("cpu", 10 + r), x, y, part,
                                       s["batch"])
                noise = torch.tensor(small_noise(r, s), device=dev)
                state, metrics = engine.round(
                    state, {k: v.to(dev) for k, v in b.items()},
                    gumbel=noise)
                losses.append(float(metrics["loss"]))
            out[str(dev)] = (losses, engine.pack_state(state)["params"].cpu(),
                             state["client_opt"].m.cpu(),
                             state["client_opt"].h.cpu())
        cpu, card = out["cpu"], out[str(device)]
        for what, a, b in zip(("loss", "params", "m", "h"), card, cpu):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=SMALL_RTOL,
                atol=SMALL_ATOL, err_msg=f"small {strategy} round: {what}")
        print(f"small {strategy} round: card agrees with the CPU within "
              f"rtol={SMALL_RTOL} atol={SMALL_ATOL}; losses card "
              f"{card[0]} cpu {cpu[0]}")


def small_noise(r, s):
    """The GNB gumbel noise of small round ``r``, ``(C, J, B, 10)``."""
    u = np.random.default_rng(SEED + 500 + r).uniform(
        size=(s["clients"], s["iters"], s["batch"], 10))
    return (-np.log(-np.log(np.maximum(u, 1e-30)))).astype(np.float32)


# ------------------------------------------------------------------ timing
def host_ms(fn, launches=TIMED_LAUNCHES) -> float:
    """Host milliseconds per call, back to back, synchronised at the end:
    what a caller that launches one update after another pays."""
    sync()
    t0 = time.perf_counter()
    for i in range(launches):
        fn(i)
    sync()
    return (time.perf_counter() - t0) * 1e3 / launches


def time_ms(fn, launches=TIMED_LAUNCHES, chunk=TIMED_CHUNK,
            warmup=20) -> float:
    """Device milliseconds per call by CUDA events.  Each chunk of calls
    is queued behind a sleep kernel that outlasts its enqueue, so the
    device runs the chunk back to back whatever the host's pace; the
    events bracket the chunk alone.  Raises if a chunk took longer to
    enqueue than the sleep covers (the reading would include host gaps)."""
    for i in range(warmup):
        fn(i)
    sync()
    total = 0.0
    for c in range(0, launches, chunk):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        slept = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for i in range(c, c + chunk):
            fn(i)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        sync()
        sleep_ms = slept.elapsed_time(start)
        if enqueue_ms >= sleep_ms:
            raise SystemExit(f"timing: a chunk took {enqueue_ms} ms to "
                             f"enqueue, the sleep covers {sleep_ms} ms")
        total += start.elapsed_time(stop)
    return total / launches


def bound(ins, outs_like):
    """Least time for one update: the larger of bytes over HBM rate and
    fp32 operations over the fp32 peak.  Each input read once, each
    output written once."""
    nbytes = sum(x.numel() * x.element_size() for x in ins)
    nbytes += sum(x.numel() * x.element_size() for x in outs_like)
    ops = SOPHIA_OPS * ins[0].numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def time_kernels(device):
    """Kernel and plain version at the main path's shapes, fp32, do_h=1,
    in turns (plain, kernel, kernel, plain).  The flat entry walks the 32
    client slices of the stack in turn, so each launch finds its buffers
    outside the 50 MB L2, as the sequential strategy does."""
    N, R, C = (CLIENTS,) + MLP_PACKED
    ins = sophia_inputs((N, R, C), device, SEED + 99)
    lr = torch.tensor(LR)
    calls = {
        "sophia_update_batched": (
            lambda i: tk.sophia_update_batched(*ins, 1, lr, **HP),
            lambda i: sophia_update_ref(*ins, 1, lr=lr, **HP),
            ins),
        "sophia_update_flat": (
            lambda i: tk.sophia_update_flat(*(x[i % N] for x in ins), 1, lr,
                                            **HP),
            lambda i: sophia_update_ref(*(x[i % N] for x in ins), 1, lr=lr,
                                        **HP),
            [x[0] for x in ins]),
    }
    out = {}
    for name, (kern, plain, one) in calls.items():
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        host = host_ms(kern)
        b_ms, b_by, nbytes = bound(one, one[:3])
        k = (k1 + k2) / 2
        out[name] = dict(ms=k, plain_ms=(p1 + p2) / 2, host_ms=host,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=list(one[0].shape))
        print(f"{name} {tuple(one[0].shape)} fp32: device kernel {k1} / {k2}"
              f" ms, plain {p1} / {p2} ms, bound {b_ms} ms ({b_by}, "
              f"{nbytes} bytes); kernel at {nbytes / k / 1e9} TB/s, "
              f"{b_ms / k} of the bound; host {host} ms per call")
    return out


def profile_round(engine, state, data, device, steady_s):
    """One more steady round of the main path under `torch.profiler`:
    device time by kernel, and the device's busy share of the
    unprofiled steady round time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, y, train_idx = data
    batches = syn.client_batches(gen(device, SEED + 200), x, y, train_idx,
                                 BATCH)
    noise = gen(device, SEED + 2000)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.round(state, batches, generator=noise)
        sync()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        raise SystemExit("profile: the profiler recorded no device time")
    busy_us = sum(t for t, _ in by_name.values())
    n_kernels = sum(n for _, n in by_name.values())
    print(f"profiled round: {n_kernels} device activities, device busy "
          f"{busy_us} us; wall {wall * 1e6} us under the profiler, "
          f"busy share of the unprofiled steady round "
          f"{busy_us / (steady_s * 1e6)}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (t, n) in top:
        print(f"  {t:10.1f} us  {n:5d}x  {name[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA card")
    device = torch.device("cuda", 0)
    print(card_info())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    for info in build.build_all().values():
        print(f"built {info.path.name} in {info.seconds:.2f} s")
        for line in info.ptxas:
            print(f"  {line}")
    print(f"build phase {time.perf_counter() - t0:.2f} s")

    print("fp8 stores of Tensor.to on the card:")
    fp8_overflow_rule(device)
    print("kernels against their plain versions on the card:")
    err = check_kernels(device)

    small_round_check(device)
    launches = main_path(device)
    timing = time_kernels(device)

    replaces = {"sophia_update_batched":
                "src/repro/kernels/sophia_update.py:100",
                "sophia_update_flat": "src/repro/kernels/sophia_update.py:57"}
    kernels = []
    for name in ("sophia_update_batched", "sophia_update_flat"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sophia_update.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "host_ms": t["host_ms"],
            "shape": t["shape"], "bitwise_vs_plain": True})
    print("library_ms: none; no single PyTorch call computes the Sophia "
          "update")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
