"""The plain reference against the program at small widths on the CPU
(both archs, float32: they agree to rounding), and the check's verdict
on the controls and on the planted faults: the controls (the program
with its resident state in bfloat16, the reference with float8
products) and a broken timed path come out not correct against each
cell's limits, a sound run correct."""
import pytest
import torch

from portbench import cells, check, control, harness, tiny

CELLS = [w["name"] for w in cells.Bench().spec["workloads"]]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"), dtype="float32")


def parts(bench, cell, seed):
    w = bench.workload(cell)
    d = bench.config(w["config"])
    tr = bench.traffic(w["traffic"])
    conf = bench.arch(d).from_json(d)
    return d, tr, conf, harness.Inputs(conf, tr, seed, CPU)


@pytest.mark.parametrize("cell", CELLS[:2])
def test_reference_matches_program_at_float32(bench, cell):
    d, tr, conf, inputs = parts(bench, cell, 2 ** 31 + 5)
    tokens, labels = inputs.pool()
    _, prog = harness.checked_rounds(harness.Program(d, tr, CPU, bench),
                                     inputs, tokens, labels)
    ref = harness.reference_readout(conf, tr, inputs, others=[prog])
    numbers = check.compare(prog, ref)
    assert set(numbers) == set(check.NUMBERS)
    # Sophia's clip turns a near-zero m's rounding into a sign: a few
    # coordinates of the change move by 2 lr rho on one side only
    assert numbers.pop("change_dist") < 2e-3, numbers
    assert max(numbers.values()) < 2e-5, numbers
    assert len(prog["m"]) == tr["clients"] * len(prog["change"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    res = harness.run(cell, 11, 0.05, False, CPU, bench,
                      program_hook=control.bf16_state)
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(bench, cell):
    """The reference with float8 products in the program's place."""
    d, tr, conf, inputs = parts(bench, cell, 17)
    fp8 = control.fp8_model(cells.arch_of(conf).Model)
    ctl = harness.reference_readout(conf, tr, inputs, model=fp8, keep=True)
    ref = harness.reference_readout(conf, tr, inputs, others=[ctl])
    numbers = check.compare(ctl, ref)
    assert not check.verdict(numbers, bench.limits(cell))[0], numbers


def unchanged(monkeypatch):
    """A step that returns its state unchanged: the Sophia update does
    nothing."""
    import repro_torch.core.fed as fed
    monkeypatch.setattr(fed, "sophia_step_flat", lambda *a, **k: None)


@pytest.mark.parametrize("fault", ["none", "half_batch", "unchanged"])
@pytest.mark.parametrize("cell", CELLS[:2])
def test_faults_are_not_correct(bench, cell, fault, monkeypatch):
    hook = None
    if fault == "half_batch":
        hook = control.half_batch
    elif fault == "unchanged":
        unchanged(monkeypatch)
    res = harness.run(cell, 3, 0.05, False, CPU, bench, program_hook=hook)
    assert res["correct"] is (fault == "none"), res["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size_on_the_card(cell):
    """At the cell's own size on the card: a sound seed within every
    limit, each control (the bfloat16 state, the float8 reference) past
    one (``python -m pytest -m cuda
    portbench/``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    real = cells.Bench()
    seed = 2 ** 31 + 77
    rd, = control.readings(real, cell, [seed], [seed], [],
                           torch.device("cuda", 0), fp8_seeds=[seed])
    assert check.verdict(rd["sound"], real.limits(cell))[0], rd
    assert not check.verdict(rd["control"], real.limits(cell))[0], rd
    assert not check.verdict(rd["fp8"], real.limits(cell))[0], rd
