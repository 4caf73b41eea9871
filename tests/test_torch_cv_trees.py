"""Cross-validation of the tree builders of the port (DRF, XGBoost's DART
and gbtree, the decision tree, uplift DRF, the infogram's GBM
surrogates) against the JAX package's ``ModelBuilder``, on
tests/test_torch_cv.py's frame and at its tolerances (its
``check_builder_cv`` and ``check_random_builder_cv`` hold each case): a
file of its own so that pytest-xdist's ``--dist loadfile`` spreads the
cross-validation cases over its workers."""

import pytest

from jax_reference import _jax_compile_cache  # noqa: F401
from test_torch_cv import (_cpu_port, check_builder_cv,  # noqa: F401
                           check_random_builder_cv, frames)


@pytest.mark.parametrize("case", ["drf", "xgboost_dart", "xgboost_gbtree",
                                  "decision_tree", "uplift_drf",
                                  "infogram"])
def test_every_supervised_builder_cross_validates(frames, case, monkeypatch):
    check_builder_cv(frames, case, monkeypatch)


@pytest.mark.parametrize("case", ["drf", "psvm"])
def test_random_builders_cross_validate_like_the_reference(case):
    check_random_builder_cv(case)
