"""Cross-validation of the port's RuleFit against the JAX package's, on
tests/test_torch_cv.py's frame and at its tolerances for RuleFit (its
``check_builder_cv``: rtol 2e-3 and 5e-3 of the largest holdout
prediction, since the level-1 L1 GLM is not unique): a file of its own,
the costliest case of the cross-validation tests, so that pytest-xdist's
``--dist loadfile`` runs it beside the others."""

import pytest

from jax_reference import _jax_compile_cache  # noqa: F401
from test_torch_cv import (_cpu_port, check_builder_cv,  # noqa: F401
                           frames)


@pytest.mark.parametrize("case", ["rulefit"])
def test_every_supervised_builder_cross_validates(frames, case, monkeypatch):
    check_builder_cv(frames, case, monkeypatch)
