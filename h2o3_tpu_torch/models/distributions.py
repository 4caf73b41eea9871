"""GLM families and link functions — the port of
``h2o3_tpu/models/distributions.py`` (reference: ``hex/Distribution.java``,
``DistributionFactory``, and the family/link tables of
``hex/glm/GLMModel.java``).

Each family carries what IRLS needs (link, inverse link, d mu/d eta,
variance function) and its per-row deviance, which the regression metrics
average too (gaussian). Bernoulli GBM takes its gradients from
``gbm._grad_hess`` and its AUC and logloss from ``metrics``, as in the
reference, so it needs nothing here. Every function is elementwise torch
on float32 tensors, with the reference's clips in the same places.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

_EPS = 1e-10


def _clip01(p):
    return p.clamp(_EPS, 1.0 - _EPS)


def _exp_clip(eta):
    return torch.exp(eta.clamp(-30.0, 30.0))


def _floor(mu):
    return mu.clamp_min(_EPS)


@dataclasses.dataclass(frozen=True)
class Family:
    """GLM family: link pair + variance + deviance (reference:
    GLMParameters.Family)."""

    name: str
    link: Callable          # eta = g(mu)
    linkinv: Callable       # mu = g^-1(eta)
    dmu_deta: Callable      # mu'(eta)
    variance: Callable      # Var(y|mu) up to dispersion
    deviance: Callable      # per-row deviance d(y, mu)

    def initialize_mu(self, y):
        """Starting mu for IRLS (reference: GLM.java initialization)."""
        if self.name == "binomial":
            return (y + 0.5) / 2.0
        if self.name in ("poisson", "gamma", "tweedie"):
            return y.clamp_min(0.1)
        return y


def _gaussian():
    return Family(
        "gaussian",
        link=lambda mu: mu,
        linkinv=lambda eta: eta,
        dmu_deta=torch.ones_like,
        variance=torch.ones_like,
        deviance=lambda y, mu: (y - mu) ** 2,
    )


def _sigmoid(eta):
    """The reference's two-sided logistic: no exp overflow either way."""
    return _clip01(torch.where(eta >= 0, 1.0 / (1.0 + torch.exp(-eta)),
                               torch.exp(eta) / (1.0 + torch.exp(eta))))


def _binomial():
    return Family(
        "binomial",
        link=lambda mu: torch.log(_clip01(mu) / (1.0 - _clip01(mu))),
        linkinv=_sigmoid,
        dmu_deta=lambda eta: _clip01(_sigmoid(eta))
        * (1.0 - _clip01(_sigmoid(eta))),
        variance=lambda mu: _clip01(mu) * (1.0 - _clip01(mu)),
        deviance=lambda y, mu: -2.0 * (y * torch.log(_clip01(mu))
                                       + (1 - y) * torch.log(1 - _clip01(mu))),
    )


def _log_link(name: str, variance, deviance) -> Family:
    return Family(name, link=lambda mu: torch.log(_floor(mu)),
                  linkinv=_exp_clip, dmu_deta=_exp_clip, variance=variance,
                  deviance=deviance)


def _poisson():
    return _log_link(
        "poisson", variance=_floor,
        deviance=lambda y, mu: 2.0 * (torch.where(
            y > 0, y * torch.log(_floor(y) / _floor(mu)), 0.0) - (y - mu)))


def _gamma():
    # log link, as the reference's default (H2O allows the inverse link)
    return _log_link(
        "gamma", variance=lambda mu: _floor(mu) ** 2,
        deviance=lambda y, mu: -2.0 * (torch.log(_floor(y) / _floor(mu))
                                       - (y - mu) / _floor(mu)))


def _tweedie(p: float = 1.5):
    def deviance(y, mu):
        mu = _floor(mu)
        y1 = _floor(y)
        return 2.0 * (y1 ** (2 - p) / ((1 - p) * (2 - p))
                      - y * mu ** (1 - p) / (1 - p) + mu ** (2 - p) / (2 - p))

    return _log_link("tweedie", variance=lambda mu: _floor(mu) ** p,
                     deviance=deviance)


def _negativebinomial(theta: float = 1.0):
    """Log link; Var = mu + theta*mu^2 (reference: GLM negativebinomial
    family with dispersion theta)."""
    def deviance(y, mu):
        mu = _floor(mu)
        y1 = _floor(y)
        t1 = torch.where(y > 0, y * torch.log(y1 / mu), 0.0)
        t2 = (y + 1.0 / theta) * torch.log((1.0 + theta * y)
                                           / (1.0 + theta * mu))
        return 2.0 * (t1 - t2)

    return _log_link(
        "negativebinomial",
        variance=lambda mu: _floor(mu) * (1.0 + theta * _floor(mu)),
        deviance=deviance)


def _quasibinomial():
    """Binomial machinery on a continuous y in [0, 1] (reference:
    quasibinomial / fractionalbinomial: the same link and variance)."""
    b = _binomial()
    return Family(
        "quasibinomial", link=b.link, linkinv=b.linkinv, dmu_deta=b.dmu_deta,
        variance=b.variance,
        deviance=lambda y, mu: -2.0 * (
            torch.where(y > 0, y * torch.log(_clip01(mu) / _floor(y)), 0.0)
            + torch.where(y < 1, (1 - y) * torch.log(
                (1 - _clip01(mu)) / _floor(1 - y)), 0.0)),
    )


_FAMILIES: dict[str, Callable[..., Family]] = {
    "gaussian": _gaussian,
    "binomial": _binomial,
    "bernoulli": _binomial,
    "poisson": _poisson,
    "gamma": _gamma,
    "tweedie": _tweedie,
    "negativebinomial": _negativebinomial,
    "quasibinomial": _quasibinomial,
    "fractionalbinomial": _quasibinomial,
}


def get_family(name: str, **kw) -> Family:
    try:
        f = _FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown family {name!r}; have "
                         f"{sorted(_FAMILIES)}") from None
    return f(**kw) if kw else f()
