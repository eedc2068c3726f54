"""The port's copy of the paper's energy model (`repro_torch.metrics.
energy`) against the JAX package's ``repro.metrics.energy``: the same
Python float arithmetic, so every value is equal exactly."""
import pytest

from repro.metrics import energy as jenergy
from repro_torch.metrics import energy as tenergy

CHANNELS = [dict(), dict(p_t=0.2, distance=10.0),
            dict(bandwidth=1e6, n0=4e-9, bits_per_param=16)]


@pytest.mark.parametrize("kw", CHANNELS, ids=["paper", "near", "narrow"])
def test_channel_model_matches_jax(kw):
    jc, tc = jenergy.ChannelModel(**kw), tenergy.ChannelModel(**kw)
    assert tc.rate() == jc.rate()
    for n in (1, 118_282, 20_490):
        assert tc.tx_energy_per_round(n) == jc.tx_energy_per_round(n)
    for n_bytes in (0, 1500, 8 * 118_282):
        assert (tenergy.tx_energy_joules(n_bytes, tc)
                == jenergy.tx_energy_joules(n_bytes, jc))


@pytest.mark.parametrize("hessian_iters", [0, 3])
def test_round_energy_and_footprint_match_jax(hessian_iters):
    kw = dict(num_params=118_282, flops_per_iter=7.1e8, local_iters=10,
              hessian_iters=hessian_iters, hessian_flop_mult=1.0)
    want = jenergy.round_energy(**kw, compute=jenergy.ComputeModel(
        device_flops=2e12, device_power=5.0))
    got = tenergy.round_energy(**kw, compute=tenergy.ComputeModel(
        device_flops=2e12, device_power=5.0))
    assert got == want
    assert tenergy.round_energy(**kw) == jenergy.round_energy(**kw)
    assert tenergy.CARBON_KG_PER_MJ == jenergy.CARBON_KG_PER_MJ
    assert (tenergy.footprint_kg_co2(got["total_J"])
            == jenergy.footprint_kg_co2(want["total_J"]))
