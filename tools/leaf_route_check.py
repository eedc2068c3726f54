"""The Sophia step's leaf route against the packed route on one card, at
the benchmark cells' own sizes.  From the root of a checkout:

    python3 tools/leaf_route_check.py [--part bits|time|both]
        [--cells CELL ...] [--seed N]

``bits``: each cell's checked rounds (`portbench.harness.checked_rounds`:
the seed's weights, batches, GNB draws and uplink noise) once on the
leaf route and once on the packed route (`core.fed.takes_leaves` forced
off); the params, every client's Sophia m and h and the losses are
compared bit for bit, and the share of Sophia steps on the leaf route
(`repro_torch.obs.counters.sophia_leaf_route_share`) is printed for
each.  The default cells cover both configurations.

``time``: one local step's Sophia work at each cell's shape, by CUDA
events, from the cell's weights and real grads (their layouts as the
model gives them): the leaf-boundary form with the params store, on a
plain step and on a refresh, against the packed route's grads pack,
flat step and unpack of the same step; the flat step alone; the one
cast of the start model; and the form's bytes bound at 3.35e12 B/s.

Each result is one JSON line on standard output.  Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from portbench import cells, harness  # noqa: E402
from portbench.reference import conf as rconf  # noqa: E402
from repro_torch.comm.flat import leaves_of, pack, unpack  # noqa: E402
from repro_torch.core import fed as tfed  # noqa: E402
from repro_torch.kernels import sophia_update as tk  # noqa: E402
from repro_torch.obs import counters  # noqa: E402

CELLS = ("minicpm2b-l2.par-c4.j5.b2s256", "dsv2lite-l2.seq-c2-int8.b2s256")
HBM_BYTES_PER_S = 3.35e12
#: elements compared a piece, on the card
PIECE = 1 << 27


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def _cell(bench, cell, seed, dev):
    w = bench.workload(cell)
    d = bench.config(w["config"])
    tr = bench.traffic(w["traffic"])
    return (harness.Program(d, tr, dev),
            harness.Inputs(rconf.from_json(d), tr, seed, dev), tr)


def _checked(prog, inputs, pool, leafy):
    """The checked rounds on one route: the resident buffers, the
    losses and the leaf-route share.  The buffers of the first route
    are kept on the host."""
    real = tfed.takes_leaves
    if not leafy:
        tfed.takes_leaves = lambda *a: False
    tk.reset_launches()
    try:
        state, readout = harness.checked_rounds(prog, inputs, *pool)
    finally:
        tfed.takes_leaves = real
    torch.cuda.synchronize()
    bufs = {"params": state["params"], "m": state["client_opt"].m,
            "h": state["client_opt"].h}
    return bufs, readout["loss"], counters.sophia_leaf_route_share()


def _differing(host: torch.Tensor, card: torch.Tensor) -> int:
    """Elements whose bits differ, compared a piece at a time."""
    a, b = host.reshape(-1), card.reshape(-1)
    n = 0
    for i in range(0, a.numel(), PIECE):
        x = a[i:i + PIECE].to(card.device).view(torch.int32)
        n += int((x != b[i:i + PIECE].view(torch.int32)).sum())
    return n


def bits(bench, cell, seed, dev) -> None:
    prog, inputs, _ = _cell(bench, cell, seed, dev)
    pool = inputs.pool()
    bufs, loss_a, share_a = _checked(prog, inputs, pool, True)
    host = {k: v.to("cpu", copy=True) for k, v in bufs.items()}
    del bufs
    harness.empty_cache(dev)
    bufs, loss_b, share_b = _checked(prog, inputs, pool, False)
    diff = {k: _differing(host[k], bufs[k]) for k in host}
    emit(part="bits", cell=cell, seed=seed, leaf_route_share=share_a,
         packed_route_share=share_b, losses_leaf=loss_a,
         losses_packed=loss_b, losses_equal=loss_a == loss_b,
         differing=diff, bitwise=loss_a == loss_b and not any(diff.values()),
         elements={k: v.numel() for k, v in host.items()})
    del bufs, host
    harness.empty_cache(dev)


def _ms(fn, reps=10, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timing(bench, cell, seed, dev) -> None:
    prog, inputs, tr = _cell(bench, cell, seed, dev)
    eng, fed = prog.engine, prog.fed
    params = inputs.weights()
    spec = eng.spec_for(params)
    t = pack(params, spec)
    del params
    tokens, labels = inputs.pool()
    batch = {"tokens": tokens[0], "labels": labels[0]}
    if fed.strategy == "parallel":
        t = t.unsqueeze(0).repeat(tr["clients"], 1, 1)
    else:
        batch = {k: v[0] for k, v in batch.items()}
    lead = t.ndim - 2
    m = torch.zeros_like(t)
    h = torch.full_like(t, 1e-3)
    no_hh = torch.zeros_like(t)
    leaves = leaves_of(t, spec)
    stores = {k: v for k, v in leaves.items() if v.dtype != t.dtype}
    _, g, _ = eng._leaf_value_and_grad(leaves, batch)
    hh = {k: v * v for k, v in g.items()}       # the grads' layouts
    swapped = sorted(k for k, v in g.items() if tk.swapped(v, lead))
    hp = dict(beta1=fed.beta1, beta2=fed.beta2, rho=fed.rho, eps=fed.eps,
              weight_decay=fed.weight_decay)
    lr = fed.lr
    step = (tk.sophia_update_batched if t.ndim == 3
            else tk.sophia_update_flat)

    def leaf(h_hat, do_h):
        return lambda: tk.sophia_update_leaves(t, m, h, g, h_hat, do_h, lr,
                                               spec=spec, out=stores, **hp)

    def packed(refresh):
        def run():
            g32 = pack(g, spec)
            h32 = pack(hh, spec) if refresh else no_hh
            step(t, m, h, g32, h32, int(refresh), lr, inplace=True, **hp)
            unpack(t, spec)
        return run

    g32 = pack(g, spec)
    clients = t.numel() // spec.padded
    coords = clients * spec.total
    state_b = 24 * coords
    in_b = sum(v.numel() * v.element_size() for v in g.values())
    out_b = sum(v.numel() * v.element_size() for v in stores.values())
    hh_b = sum(v.numel() * v.element_size() for v in hh.values())
    rec = dict(part="time", cell=cell, card=torch.cuda.get_device_name(0),
               shape=list(t.shape), leaves=len(spec.keys), swapped=swapped,
               coords=coords)
    for name, fn, nbytes in (
            ("leaf_plain_ms", leaf(no_hh, 0), state_b + in_b + 4 * coords
             + out_b),
            ("leaf_refresh_ms", leaf(hh, 1), state_b + in_b + hh_b + out_b),
            ("packed_plain_ms", packed(False), None),
            ("packed_refresh_ms", packed(True), None),
            ("flat_step_ms", lambda: step(t, m, h, g32, no_hh, 0, lr,
                                          inplace=True, **hp), 32 * coords),
            ("start_cast_ms", lambda: leaves_of(t, spec), None)):
        ms = _ms(fn)
        rec[name] = ms
        if nbytes is not None:
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rec[name.replace("_ms", "_bound_ms")] = bound
            rec[name.replace("_ms", "_of_bound")] = bound / ms
    tk.reset_launches()
    leaf(no_hh, 0)()
    rec["launches_a_step"] = tk.LAUNCHES["sophia_update_leaves"]
    rec["vector_launches"] = tk.F32X4_LAUNCHES["sophia_update_leaves"]
    emit(**rec)
    del t, m, h, no_hh, leaves, stores, g, hh, g32
    harness.empty_cache(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/leaf_route_check.py")
    ap.add_argument("--part", choices=("bits", "time", "both"),
                    default="both")
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=2 ** 31 + 30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("leaf_route_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    bench = cells.Bench(ROOT)
    for cell in args.cells:
        if args.part in ("time", "both"):
            timing(bench, cell, args.seed, dev)
        if args.part in ("bits", "both"):
            bits(bench, cell, args.seed, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
