"""The port's cost tools against the JAX package's: the input shapes and
`RunConfig`, the skip rules (`api.applicable`) over every arch x shape,
`api.resolve_fed` against the JAX ``resolve_fed`` on a stand-in of the
production 1-pod mesh, `roofline.count_params` at the full published
sizes (the JAX one shapes the weights by ``jax.eval_shape``, the port's
on the meta device) and `roofline.model_flops` for every arch x shape,
all exactly; `roofline.roofline_terms` at the card's own peaks."""
import dataclasses
import functools

import pytest

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import api as japi
from repro.launch import roofline as jroof
from repro_torch import configs
from repro_torch.configs import base as tbase
from repro_torch.launch import api, roofline

ARCHS = list(configs.ARCH_IDS)


class _Mesh:
    """What the JAX ``resolve_fed`` reads of its production 1-pod mesh."""
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def test_input_shapes_and_run_config_equal_jax():
    assert list(tbase.INPUT_SHAPES) == list(jbase.INPUT_SHAPES)
    for name, shape in tbase.INPUT_SHAPES.items():
        assert _fields(shape) == _fields(jbase.INPUT_SHAPES[name]), name
    tf = [(f.name, f.default) for f in dataclasses.fields(tbase.RunConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(jbase.RunConfig)]
    assert tf == jf
    run = tbase.RunConfig(model=configs.get_model_config("minicpm-2b"))
    jrun = jbase.RunConfig(model=jconfigs.get_model_config("minicpm-2b"))
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_equals_jax(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for shape in tbase.INPUT_SHAPES:
        assert api.applicable(arch, shape) == japi.applicable(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_fed_equals_jax(arch):
    got = dataclasses.asdict(api.resolve_fed(arch, local_iters=3))
    want = dataclasses.asdict(japi.resolve_fed(arch, _Mesh(),
                                               local_iters=3))
    assert got == want


@functools.lru_cache(maxsize=None)
def _jax_counts(arch):
    return jroof.count_params(jconfigs.get_model_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_jax_at_full_size(arch):
    got = roofline.count_params(configs.get_model_config(arch))
    assert got == _jax_counts(arch)
    assert got["active"] <= got["total"]


def test_model_flops_equal_jax_every_arch_and_shape(monkeypatch):
    port_counts = functools.lru_cache(maxsize=None)(roofline.count_params)
    monkeypatch.setattr(roofline, "count_params", port_counts)
    monkeypatch.setattr(jroof, "count_params",
                        lambda cfg: _jax_counts(cfg.name))
    for arch in ARCHS:
        for shape in tbase.INPUT_SHAPES:
            got = roofline.model_flops(configs.get_model_config(arch),
                                       shape, local_iters=2)
            want = jroof.model_flops(jconfigs.get_model_config(arch), shape,
                                     local_iters=2)
            assert got == want, (arch, shape)


def test_roofline_terms_at_the_cards_peaks():
    """The compute term sums each dtype's FLOPs over its own peak (fp32
    GEMMs run without TF32); one card moves no collective bytes."""
    t = roofline.roofline_terms({"bfloat16": 989.4e12, "float32": 67e12},
                                3.35e12)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert (t["collective_s"], t["bottleneck"]) == (0.0, "compute")
    assert roofline.roofline_terms(1e12, 6.7e12)["bottleneck"] == "memory"
    assert roofline.collective_bytes()["total"] == 0.0
    with pytest.raises(ValueError):
        roofline.roofline_terms(1.0, 1.0, 1.0)
