"""The benchmark's readers of the round's phase ranges
(`portbench/metrics/`), on a hand-made `portbench.trace.Trace`: each
value, None where its range is absent (the program before the ranges),
a coverage of at most 100, and each reader's range string the
program's own constant (`repro_torch.obs.spans`)."""
import pytest

from portbench import cells, harness
from portbench.reference import conf as rconf
from portbench.trace import Trace
from repro_torch.obs import spans

BENCH = cells.Bench()
#: reader file -> the program's range it reads
MS_READERS = {"loss_grad_ms_per_round": spans.LOSS_GRAD,
              "gnb_ms_per_round": spans.GNB,
              "pack_ms_per_round": spans.PACK,
              "aggregate_ms_per_round": spans.AGGREGATE,
              "comm_ms_per_round": spans.COMM}


def _run(trace, cell="minicpm2b-l2.par-c4.j5.b2s256"):
    w = BENCH.workload(cell)
    return harness.RunData(cell=cell,
                           conf=rconf.from_json(BENCH.config(w["config"])),
                           traffic=BENCH.traffic(w["traffic"]), setup_s=0.0,
                           trace=trace)


def _trace(ranges):
    # times in microseconds; two traced rounds
    return Trace(rounds=2, start=0.0, end=1000.0,
                 kernels=[("nvjet_gemm_fwd", 0, 100),
                          ("nvjet_gemm_bwd", 100, 300),
                          ("elementwise_pack", 300, 350),
                          ("sophia_update_f32x4_kernel", 350, 550),
                          ("reduce_mean", 560, 600),
                          ("fill_outside", 900, 910)],
                 ranges=ranges)


PHASED = {spans.LOSS_GRAD: [(0, 90), (100, 290)],
          spans.PACK: [(300, 340)],
          spans.OPTIMIZER: [(350, 550)],
          spans.AGGREGATE: [(560, 600)]}


@pytest.mark.parametrize("name", list(MS_READERS))
def test_phase_ms_reader(name):
    reader = BENCH.reader(name)
    assert reader.SPAN == MS_READERS[name]
    got = reader.read(_run(_trace(PHASED)))
    # the activities that start inside the range, clipped at its end, in
    # ms a round
    want = {spans.LOSS_GRAD: (90 + 190) / 2 / 1e3,
            spans.PACK: 40 / 2 / 1e3,
            spans.AGGREGATE: 40 / 2 / 1e3}.get(MS_READERS[name])
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
    assert reader.read(_run(_trace({}))) is None
    assert reader.read(_run(None)) is None


def test_optimizer_roofline_reads_the_range_not_the_name():
    """The same work as `sophia_roofline` where the one kernel fills the
    range; under another kernel name it still reads, and without the
    range it reads None."""
    opt, named = (BENCH.reader("optimizer_roofline"),
                  BENCH.reader("sophia_roofline"))
    assert opt.SPAN == spans.OPTIMIZER
    run = _run(_trace(PHASED))
    assert opt.read(run) == pytest.approx(named.read(run))
    assert 0 < opt.read(run)
    renamed = _trace(PHASED)
    renamed.kernels[3] = ("fused_update_kernel", 350, 550)
    assert opt.read(_run(renamed)) == pytest.approx(named.read(run))
    assert named.read(_run(renamed)) is None
    assert opt.read(_run(_trace({}))) is None
    seq = _run(_trace(PHASED), "dsv2lite-l2.seq-c2-int8.b2s256")
    assert opt.read(seq) == pytest.approx(named.read(seq))


def test_phase_coverage():
    reader = BENCH.reader("phase_coverage_pct")
    assert reader.PHASES == spans.PHASES
    total = 100 + 200 + 50 + 200 + 40 + 10
    # every activity but the fill at 900 starts inside a phase range
    assert reader.read(_run(_trace(PHASED))) == pytest.approx(
        100 * (total - 10) / total)
    # overlapping ranges count an activity once: at most 100
    both = dict(PHASED, **{spans.GNB: [(0, 1000)]})
    assert reader.read(_run(_trace(both))) == pytest.approx(100.0)
    assert reader.read(_run(_trace({}))) is None
    assert reader.read(_run(_trace({"moe dispatch/combine": [(0, 99)]}))) \
        is None


def test_phase_metrics_listed_in_their_cells():
    """Each phase reader's metrics are entries of ``BENCHMARK.json``:
    the bare names in the parallel cells, ``.seq`` in the sequential
    one, the comm phase there alone."""
    par = {m["name"] for m in BENCH.metrics("minicpm2b-l2.par-c4.j5.b2s256",
                                            "per_layer")}
    seq = {m["name"] for m in BENCH.metrics("dsv2lite-l2.seq-c2-int8.b2s256",
                                            "per_layer")}
    bases = ["loss_grad_ms_per_round", "gnb_ms_per_round",
             "pack_ms_per_round", "optimizer_roofline",
             "aggregate_ms_per_round", "phase_coverage_pct"]
    assert set(bases) <= par
    assert {b + ".seq" for b in bases} | {"comm_ms_per_round"} <= seq
    assert "comm_ms_per_round" not in par
