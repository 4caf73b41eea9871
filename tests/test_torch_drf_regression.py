"""The port's regression DRF against the JAX reference's on
tests/test_torch_drf.py's frame, seeds and forests (that module's
``forests`` fixture, grown here for the numeric response only): the mean
training MSE over the seeds within 5%."""

import pytest

from jax_reference import _jax_compile_cache  # noqa: F401
from test_torch_drf import _cpu_port, _means, forests  # noqa: F401


def test_regression_forest_mse_within_5pct_of_reference(forests):
    _, _, _, out = forests
    ref, port = _means(out["t"], "mse")
    assert port == pytest.approx(ref, rel=0.05)
