"""ModelSelection and ANOVAGLM — builders that fit many GLMs — the port of
``h2o3_tpu/models/model_selection.py`` (reference:
``hex/modelselection/ModelSelection.java``: best-subset GLMs by mode
maxr, maxrsweep, forward or backward, subsets ranked by R² (gaussian) or
deviance; ``hex/anovaglm/ANOVAGLM.java``: an F test of each predictor by
the deviance it adds to the full model).

Every candidate subset is one fit of the port's GLM on the frame already
on the device. ``maxr`` here enumerates every subset of each size, as the
JAX package does (not H2O's sequential replacement). The F test's tail
probability is scipy's, on the host.
"""

from __future__ import annotations

import itertools

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key


def _fit_glm(frame, xs, y, weights, params):
    return GLM(family=params.get("family", "AUTO"),
               lambda_=float(params.get("lambda_", 0.0)),
               alpha=float(params.get("alpha", 0.0)),
               standardize=bool(params.get("standardize", True))) \
        .train(x=list(xs), y=y, training_frame=frame, weights=weights)


def _score(m) -> float:
    """R² where the metrics have one, else minus the residual deviance."""
    r2 = getattr(m.training_metrics, "r2", None)
    if r2 is not None and np.isfinite(r2):
        return float(r2)
    return -float(m.output.get("residual_deviance", np.inf))


class ModelSelectionModel(Model):
    algo = "modelselection"

    def _score_raw(self, frame: Frame):
        return self.output["best_model"]._score_raw(frame)

    def result(self) -> list[dict]:
        """Each size's best subset (h2o-py: ``result()``)."""
        return self.output["results"]

    def coef(self):
        return self.output["best_model"].coef()


class ModelSelection(ModelBuilder):
    """h2o-py surface: ``H2OModelSelectionEstimator`` (mode maxr,
    maxrsweep or allsubsets — each enumerates every subset — forward or
    backward)."""

    algo = "modelselection"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            mode="maxr",
            max_predictor_number=3,
            min_predictor_number=1,
            family="AUTO",
            lambda_=0.0,
            alpha=0.0,
            standardize=True,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights
             ) -> ModelSelectionModel:
        self._refuse_checkpoint()
        p = self.params
        mode = str(p["mode"]).lower()
        results = []
        best_per_size = {}

        if mode in ("maxr", "maxrsweep", "allsubsets"):
            maxk = min(int(p["max_predictor_number"]), len(x))
            for k in range(int(p["min_predictor_number"]), maxk + 1):
                best = None
                for subset in itertools.combinations(x, k):
                    m = _fit_glm(frame, subset, y, weights, p)
                    if best is None or _score(m) > _score(best):
                        best = m
                best_per_size[k] = best
                names = best.output["coef_names"]
                results.append(dict(
                    n_predictors=k,
                    predictors=[c for c in x if c in names or any(
                        n.startswith(c + ".") for n in names)],
                    r2=_score(best), model_key=best.key))
                job.update(k / maxk, f"best of size {k}: "
                                     f"r2={_score(best):.4f}")
        elif mode == "forward":
            chosen: list[str] = []
            maxk = min(int(p["max_predictor_number"]), len(x))
            while len(chosen) < maxk:
                cand = [(c, _fit_glm(frame, chosen + [c], y, weights, p))
                        for c in x if c not in chosen]
                c, m = max(cand, key=lambda t: _score(t[1]))
                chosen.append(c)
                best_per_size[len(chosen)] = m
                results.append(dict(n_predictors=len(chosen),
                                    predictors=list(chosen),
                                    r2=_score(m), model_key=m.key))
                job.update(len(chosen) / maxk, f"+{c}")
        elif mode == "backward":
            chosen = list(x)
            m = _fit_glm(frame, chosen, y, weights, p)
            best_per_size[len(chosen)] = m
            results.append(dict(n_predictors=len(chosen),
                                predictors=list(chosen),
                                r2=_score(m), model_key=m.key))
            while len(chosen) > int(p["min_predictor_number"]):
                cand = [(c, _fit_glm(frame, [d for d in chosen if d != c],
                                     y, weights, p)) for c in chosen]
                c, m = max(cand, key=lambda t: _score(t[1]))
                chosen.remove(c)
                best_per_size[len(chosen)] = m
                results.append(dict(n_predictors=len(chosen),
                                    predictors=list(chosen),
                                    r2=_score(m), model_key=m.key))
                job.update(1 - len(chosen) / len(x), f"-{c}")
        else:
            raise ValueError(f"unknown mode {p['mode']!r}")

        best = max(best_per_size.values(), key=_score)
        yvec = frame.vec(y)
        return ModelSelectionModel(
            key=make_model_key(self.algo, self.model_id),
            params=self.params, response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(results=results, best_model=best,
                        best_per_size={k: m.key
                                       for k, m in best_per_size.items()}))


class ANOVAGLMModel(Model):
    algo = "anovaglm"

    def _score_raw(self, frame: Frame):
        return self.output["full_model"]._score_raw(frame)

    def anova_table(self) -> list[dict]:
        return self.output["table"]


class ANOVAGLM(ModelBuilder):
    """h2o-py surface: ``H2OANOVAGLMEstimator`` — the significance of each
    predictor by the deviance the full model loses without it."""

    algo = "anovaglm"

    @classmethod
    def defaults(cls) -> dict:
        return dict(
            super().defaults(),
            family="AUTO",
            lambda_=0.0,
            alpha=0.0,
            standardize=True,
            highest_interaction_term=2,
        )

    def _fit(self, job: Job, frame: Frame, x, y, weights) -> ANOVAGLMModel:
        from scipy.stats import f as f_dist
        self._refuse_checkpoint()
        p = self.params
        full = _fit_glm(frame, x, y, weights, p)
        dev_full = float(full.output.get("residual_deviance", np.nan))
        n = frame.nrows
        n_coef = len(full.output["coef_names"])
        df_resid = max(n - n_coef - 1, 1)

        table = []
        for i, c in enumerate(x):
            reduced = [d for d in x if d != c]
            if not reduced:
                continue
            m = _fit_glm(frame, reduced, y, weights, p)
            dev_r = float(m.output.get("residual_deviance", np.nan))
            df = n_coef - len(m.output["coef_names"])
            ss = max(dev_r - dev_full, 0.0)
            denom = max(dev_full, 1e-12) / df_resid
            fstat = (ss / max(df, 1)) / denom
            pval = float(f_dist.sf(fstat, max(df, 1), df_resid))
            table.append(dict(predictor=c, df=df, deviance=ss,
                              f_value=fstat, p_value=pval))
            job.update((i + 1) / len(x), f"dropped {c}: p={pval:.4g}")

        yvec = frame.vec(y)
        return ANOVAGLMModel(
            key=make_model_key(self.algo, self.model_id),
            params=self.params, response_column=y,
            response_domain=yvec.domain if yvec.is_categorical else None,
            output=dict(full_model=full, table=table))
