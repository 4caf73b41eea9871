"""Distribution families — the part of ``h2o3_tpu/models/distributions.py``
this slice needs (reference: ``hex/Distribution.java``,
``DistributionFactory``): the gaussian family, whose per-row deviance the
regression metrics average. Bernoulli GBM takes its gradients from
``gbm._grad_hess`` and its AUC and logloss from ``metrics``, as in the
reference, so it needs nothing here; GLM's families come with GLM.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Family:
    """Link pair + per-row deviance (reference: GLMParameters.Family)."""

    name: str
    link: Callable          # eta = g(mu)
    linkinv: Callable       # mu = g^-1(eta)
    deviance: Callable      # per-row deviance d(y, mu)


def _gaussian() -> Family:
    return Family("gaussian", link=lambda mu: mu, linkinv=lambda eta: eta,
                  deviance=lambda y, mu: (y - mu) ** 2)


_FAMILIES: dict[str, Callable[[], Family]] = {"gaussian": _gaussian}


def get_family(name: str) -> Family:
    try:
        return _FAMILIES[name]()
    except KeyError:
        raise ValueError(f"unknown family {name!r}; the port has "
                         f"{sorted(_FAMILIES)}") from None
