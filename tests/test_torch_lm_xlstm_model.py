"""xlstm-1.3b of the port against the JAX package's at one full block
pattern: ``reduced(d_model=128)``, eight blocks ``(m x 7, s)``, as
``reduced()`` gives it (an FFN of ``2 d_model`` in every block) and at
its published ``d_ff=0`` (FFN-less blocks), seq 16-24 with
`MLSTM_CHUNK` patched to 8 in both packages (two and three chunks).
The mixers alone and the 2-layer cut: tests/test_torch_lm_xlstm.py,
which also holds `XLSTM_BAND` and its measurements; the helpers and
the engine loop come from tests/test_torch_lm.py.

Bands.  Forward, loss, grads and sampled loss at fp32 in `XLSTM_BAND`.
Engine rounds (`_xlstm_round_band`): m and h and the params in that
band, but for the sLSTM's input-gate biases (``b_gates[D:2D]``), whose
gradient cancels to rounding noise (the stabilizer ``m_t = max(f_t +
m_{t-1}, i_t)`` makes ``exp(i_t - m_t)`` flat in ``i_t`` wherever
``i_t`` is the max), so that Sophia's clip follows the noise's sign:
each of those coordinates within a flipped clipped step, ``2 lr J / C``
a round (measured: 91 of the 128 after round 1, 107 after round 2; no
other coordinate out).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.comm import flat as tflat
from repro_torch.models import transformer as TT
from test_torch_lm import _cfgs, model_vs_jax, rounds_vs_jitted_jax
from test_torch_lm_xlstm import XLSTM, XLSTM_BAND, chunk8  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("d_ff", [None, 0])
def test_xlstm_forward_loss_grads_sampled_loss_match_jax(chunk8, d_ff):
    """xlstm-1.3b reduced at fp32, seq 24 (three mLSTM chunks): as
    ``reduced()`` gives it and at its published ``d_ff=0``."""
    replace = {} if d_ff is None else {"d_ff": d_ff}
    jcfg, tcfg = _cfgs(XLSTM, "float32", **replace)
    assert (tcfg.d_ff > 0) == (d_ff is None)
    model_vs_jax(jcfg, tcfg, jit=True, fp32_band=XLSTM_BAND)


def _xlstm_round_band(tcfg):
    rtol, atol = XLSTM_BAND
    # the sLSTM's input-gate biases, b_gates[D:2D]
    D = tcfg.d_model
    gates = tflat.leaf_coords(tflat.flat_spec(TT.init_lm(
        torch.Generator().manual_seed(0), tcfg)), "/mixer/b_gates", D,
        2 * D).numpy()

    def band(got, want, name, flip, msg):
        got, want = (np.asarray(x, np.float32) for x in (got, want))
        diff = np.abs(got - want)
        out = diff > atol * float(np.abs(want).max()) + rtol * np.abs(want)
        if name == "params":
            flat = out.reshape(-1)
            allowed = np.zeros_like(flat)
            allowed[gates] = True
            assert not np.any(flat & ~allowed), (msg, np.flatnonzero(
                flat & ~allowed)[:8])
            assert np.all(diff[out] <= flip), (msg, float(diff.max()), flip)
        else:
            assert not out.any(), (msg, int(out.sum()), float(diff.max()))
    return band


def test_xlstm_rounds_match_jitted_jax(chunk8):
    """Two engine rounds at the arch's FED strategy (parallel), C=2,
    fp32, ``d_ff=0``, seq 16 (two mLSTM chunks), against the jitted JAX
    round, in `_xlstm_round_band`."""
    _, tcfg = _cfgs(XLSTM, "float32", d_ff=0)
    rounds_vs_jitted_jax(XLSTM, "parallel", "float32", replace={"d_ff": 0},
                         fp32_band=_xlstm_round_band(tcfg))
