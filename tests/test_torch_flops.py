"""The port's FLOPs model and MFU (``hfrep_tpu_torch.obs.flops``) against
the JAX package's ``hfrep_tpu/obs/flops.py``.

``gf``, ``cf`` and ``epoch_flops`` are the same logical model, integer
for integer, over a grid of (W, F, H, B) that includes the two presets'
(48, 35) and (168, 36).  The peaks are the H100 SXM5's, not TPU v5e's;
a rate that is not finite or not positive gives NaN.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import pytest

from hfrep_tpu.obs import flops as jax_flops
from hfrep_tpu_torch.obs import flops
from hfrep_tpu_torch.analysis.contracts import ContractError

GRID = list(itertools.product((1, 24, 48, 168), (4, 35, 36), (8, 100, 128), (1, 32)))


@pytest.mark.parametrize("w,f,h,b", GRID[::5] + [(48, 35, 100, 32), (168, 36, 100, 32)])
def test_epoch_flops_equal_jax(w, f, h, b):
    assert flops.gf(b, w, f, h) == jax_flops.gf(b, w, f, h)
    assert flops.cf(b, w, f, h) == jax_flops.cf(b, w, f, h)
    got, ref = flops.epoch_flops(w, f, h, b), jax_flops.epoch_flops(w, f, h, b)
    assert isinstance(got, int) and got == ref


def test_default_epoch_is_the_flagship_at_both_presets():
    for w, f in ((48, 35), (168, 36)):
        assert flops.epoch_flops(w, f) == jax_flops.epoch_flops(w, f)


def test_peaks_are_the_h100s():
    assert flops.PEAK_BF16 == 989.4e12
    assert flops.PEAK_F32 == 66.9e12
    assert flops.PEAK_BF16 != jax_flops.PEAK_BF16


def test_mfu_against_the_h100_peaks():
    rate = 20.0
    want = jax_flops.epoch_flops(48, 35) * rate / 989.4e12
    assert flops.mfu(rate, 48, 35) == pytest.approx(want, rel=1e-12)
    assert flops.mfu(rate, 48, 35, peak=flops.PEAK_F32) == pytest.approx(
        jax_flops.epoch_flops(48, 35) * rate / 66.9e12, rel=1e-12)
    # the same rate against each package's peak: the ratio is the peaks'
    assert flops.mfu(rate, 168, 36) / jax_flops.mfu(rate, 168, 36) == pytest.approx(
        jax_flops.PEAK_BF16 / flops.PEAK_BF16, rel=1e-12)


@pytest.mark.parametrize("rate", [float("nan"), 0.0, -3.0, None, "fast", float("-inf")])
def test_mfu_nan_on_a_rate_that_is_not_positive(rate):
    assert math.isnan(flops.mfu(rate, 48, 35))
    assert math.isnan(jax_flops.mfu(rate, 48, 35))


def test_mfu_nan_on_an_infinite_rate():
    """The JAX docstring promises NaN for every non-finite rate; its code
    returns inf for +inf.  The port keeps the promise."""
    assert math.isnan(flops.mfu(float("inf"), 48, 35))


def test_mfu_series_matches_jax_and_checks_its_contract():
    dt = np.array([0.05, 0.0, -1.0, 0.2])
    got = flops.mfu_series(dt, 48, 35)
    ref = jax_flops.mfu_series(dt, 48, 35) * (jax_flops.PEAK_BF16 / flops.PEAK_BF16)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert np.isnan(got[1]) and np.isnan(got[2])
    with pytest.raises(ContractError):
        flops.mfu_series(np.zeros((2, 2)), 48, 35)


def test_report_prints_both_shares(capsys):
    assert flops.main(["20", "10"]) == 0
    out = capsys.readouterr().out
    assert out.count("MFU vs bf16 peak") == 2 and out.count("MFU vs f32 peak") == 2
    assert "executed" not in out
