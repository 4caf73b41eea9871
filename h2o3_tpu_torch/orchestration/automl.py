"""AutoML — automatic model search with a modeling plan — the port of
``h2o3_tpu/orchestration/automl.py``.

Reference: ``ai/h2o/automl/AutoML.java:49`` and
``modeling/{GLM,DRF,GBM,DeepLearning,StackedEnsemble,XGBoost}StepsProvider
.java``: a run executes modeling steps (defaults, then random grids, then
the lr-annealed exploitation step, then the ensembles) under a model and
time budget (``WorkAllocations.java``), ranks everything on a Leaderboard
and logs to an EventLog. The plan, its parameters, the budget's decisions
and the event wording are the JAX package's; every model is built with
``nfolds`` CV and kept out-of-fold predictions, so the ensembles can stack
them. Base steps and grid builds overlap ``parallelism`` at a time, each
on a CUDA stream of its own; the leaderboard follows plan order whatever
order they finish in.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import Model
from h2o3_tpu_torch.orchestration.grid import (GridSearch, default_metric,
                                               metric_higher_is_better)
from h2o3_tpu_torch.orchestration.leaderboard import Leaderboard
from h2o3_tpu_torch.utils.tracing import TRACER


class EventLog:
    """Timestamped AutoML events (reference: ``ai/h2o/automl/events/
    EventLogEntry.java``: timestamp, level, stage, message, name, value;
    the name/value rows are h2o-py's ``aml.training_info``)."""

    def __init__(self):
        self.events: list[tuple[float, str, str, str, str, str]] = []

    def log(self, stage: str, message: str, level: str = "Info",
            name: str = "", value: str = "") -> None:
        self.events.append((time.time(), level, stage, message,
                            str(name), str(value)))

    def info(self, name: str, value) -> None:
        """A training_info entry."""
        self.log("TrainingInfo", "", name=name, value=value)

    def table_rows(self) -> list[list[str]]:
        return [[time.strftime("%Y.%m.%d %H:%M:%S", time.localtime(t)),
                 lvl, s, m, n, v]
                for t, lvl, s, m, n, v in self.events]

    def as_list(self) -> list[str]:
        return [f"[{time.strftime('%H:%M:%S', time.localtime(t))}] {s}: "
                f"{m or f'{n}={v}'}"
                for t, _lvl, s, m, n, v in self.events]


class AutoML:
    """h2o-py surface: ``H2OAutoML(max_models=..., max_runtime_secs=...)``."""

    def __init__(self, max_models: int = 0, max_runtime_secs: float = 0.0,
                 seed: int = -1, nfolds: int = 5,
                 sort_metric: str | None = None,
                 exclude_algos: Sequence[str] = (),
                 include_algos: Sequence[str] | None = None,
                 project_name: str | None = None,
                 preprocessing: Sequence[str] | None = None,
                 exploitation_ratio: float = 0.1,
                 parallelism: int = 2):
        if not max_models and not max_runtime_secs:
            max_runtime_secs = 3600.0   # the reference's default budget
        self.max_models = int(max_models)
        self.max_runtime_secs = float(max_runtime_secs)
        self.seed = int(seed)
        self.nfolds = int(nfolds)
        self.sort_metric = sort_metric
        self.exclude_algos = {a.upper() for a in exclude_algos}
        self.include_algos = ({a.upper() for a in include_algos}
                              if include_algos is not None else None)
        self.project_name = project_name or f"automl_{int(time.time())}"
        self.preprocessing = list(preprocessing or [])
        self.exploitation_ratio = float(exploitation_ratio)
        # builds in flight at once (1: strictly sequential)
        self.parallelism = max(1, int(parallelism))
        self.leaderboard: Leaderboard | None = None
        self._scheduler = None      # MeshScheduler, one per train() run
        self.event_log = EventLog()
        self._t0 = 0.0
        self._n_built = 0

    # -- budget --------------------------------------------------------------

    def _budget_left(self) -> bool:
        cap = getattr(self, "_cap", None)
        if cap is None:
            cap = self.max_models
        if cap and self._n_built >= cap:
            return False
        if self.max_runtime_secs and \
                time.time() - self._t0 > self.max_runtime_secs:
            return False
        return True

    def _algo_enabled(self, algo: str) -> bool:
        algo = algo.upper()
        if self.include_algos is not None:
            return algo in self.include_algos
        return algo not in self.exclude_algos

    # -- plan ----------------------------------------------------------------

    def _steps(self):
        """(algo, builder class, params) in the reference's default plan
        order (``ModelingPlans.java``)."""
        from h2o3_tpu_torch.models.deeplearning import DeepLearning
        from h2o3_tpu_torch.models.gbm import DRF, GBM
        from h2o3_tpu_torch.models.glm import GLM
        from h2o3_tpu_torch.models.xgboost import XGBoost

        steps: list[tuple[str, type, dict]] = []
        steps.append(("GLM", GLM, dict(lambda_=1e-4, alpha=0.5)))
        # XGBoostStepsProvider defaults 1-3
        for d, sr in ((6, 0.8), (9, 0.6), (3, 0.8)):
            steps.append(("XGBOOST", XGBoost,
                          dict(ntrees=50, max_depth=d, sample_rate=sr,
                               col_sample_rate_per_tree=0.8, learn_rate=0.3)))
        # GBMStepsProvider's 5 fixed configurations
        for d in (6, 7, 8, 10, 13):
            steps.append(("GBM", GBM,
                          dict(ntrees=50, max_depth=min(d, 13),
                               learn_rate=0.1, sample_rate=0.8,
                               col_sample_rate=0.8)))
        steps.append(("DRF", DRF, dict(ntrees=50)))
        # XRT: the extremely randomized variant
        steps.append(("DRF", DRF, dict(ntrees=50, sample_rate=1.0,
                                       max_depth=16)))
        steps.append(("DEEPLEARNING", DeepLearning,
                      dict(hidden=[64, 64], epochs=10, mini_batch_size=32)))
        return steps

    def _grids(self):
        from h2o3_tpu_torch.models.gbm import GBM
        from h2o3_tpu_torch.models.xgboost import XGBoost
        rng_seed = self.seed if self.seed >= 0 else 42
        return [
            ("GBM", GBM,
             dict(ntrees=50),
             {"max_depth": [3, 5, 7, 9], "learn_rate": [0.05, 0.1, 0.2],
              "sample_rate": [0.6, 0.8, 1.0],
              "col_sample_rate": [0.4, 0.7, 1.0]},
             rng_seed),
            ("XGBOOST", XGBoost,
             dict(ntrees=50),
             {"max_depth": [4, 6, 8], "learn_rate": [0.1, 0.3],
              "reg_lambda": [0.1, 1.0, 10.0], "sample_rate": [0.6, 0.8, 1.0]},
             rng_seed + 1),
        ]

    # -- the run -------------------------------------------------------------

    def train(self, x: Sequence[str] | None = None, y: str | None = None,
              training_frame: Frame | None = None,
              leaderboard_frame: Frame | None = None) -> Model | None:
        # one span for the whole run: every leaderboard build hangs
        # underneath it, so the creating request's trace holds the tree
        with TRACER.span(f"automl:{self.project_name}", kind="orchestration",
                         attrs={"max_models": self.max_models,
                                "parallelism": self.parallelism}):
            return self._train(x, y, training_frame, leaderboard_frame)

    def _train(self, x: Sequence[str] | None, y: str | None,
               training_frame: Frame | None,
               leaderboard_frame: Frame | None) -> Model | None:
        if y is None or training_frame is None:
            raise ValueError("y and training_frame are required")
        self._t0 = time.time()
        self.event_log.info("creation_epoch", int(self._t0))
        self.event_log.info("start_epoch", int(self._t0))
        yvec = training_frame.vec(y)
        classification = yvec.is_categorical
        self.leaderboard = Leaderboard(self.sort_metric, leaderboard_frame)
        log = self.event_log
        log.log("init", f"AutoML {self.project_name}: y={y!r} "
                        f"{'classification' if classification else 'regression'}, "
                        f"budget max_models={self.max_models} "
                        f"max_runtime_secs={self.max_runtime_secs}")

        common = dict(nfolds=self.nfolds, seed=self.seed,
                      keep_cross_validation_predictions=True)
        base_models: list[Model] = []
        # the exploitation share of the model budget is reserved
        # (reference WorkAllocations); below 5 models there is no reserve,
        # which would starve the base plan and the ensembles behind it
        reserved = (max(1, int(round(self.max_models
                                     * self.exploitation_ratio)))
                    if self.max_models >= 5 and self.exploitation_ratio > 0
                    and (self._algo_enabled("GBM")
                         or self._algo_enabled("XGBOOST"))
                    else 0)
        self._cap = (self.max_models - reserved) if self.max_models else None

        # preprocessing (reference ai/h2o/automl/preprocessing/
        # TargetEncoding.java): high-cardinality enums target-encoded for
        # the tree steps; the linear and DL steps keep the raw frame
        tree_frame, tree_x, te_model = training_frame, x, None
        if "target_encoding" in self.preprocessing:
            hi_card = [c for c in training_frame.names
                       if c != y and training_frame.vec(c).is_categorical
                       and training_frame.vec(c).cardinality() > 10]
            if hi_card and classification:
                try:
                    from h2o3_tpu_torch.models.target_encoder import \
                        TargetEncoder
                    te = TargetEncoder(data_leakage_handling="KFold",
                                       blending=True, seed=self.seed).train(
                        x=hi_card, y=y, training_frame=training_frame)
                    te_model = te
                    tree_frame = te.transform(training_frame)
                    tree_x = [c for c in tree_frame.names if c != y
                              and c not in hi_card] if x is None else \
                        [c for c in x if c not in hi_card] + \
                        [f"{c}_te" for c in hi_card]
                    log.log("preprocess",
                            f"target-encoded {hi_card} for tree steps")
                except Exception as e:
                    log.log("error", f"target encoding failed: "
                                     f"{type(e).__name__}: {e}")

        tree_algos = {"GBM", "XGBOOST", "DRF"}

        from h2o3_tpu_torch.orchestration.parallel_build import \
            windowed_parallel
        from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
        self._scheduler = MeshScheduler(slices=self.parallelism)

        def enabled_steps():
            for algo, cls, params in self._steps():
                if self._algo_enabled(algo):
                    yield algo, cls, params

        def can_submit(n_submitted: int) -> bool:
            cap = self._cap if self._cap else 0
            if cap and self._n_built + n_submitted >= cap:
                return False
            return not (self.max_runtime_secs
                        and time.time() - self._t0 > self.max_runtime_secs)

        def build_step(step):
            algo, cls, params = step
            t = time.time()
            fr_s, x_s = ((tree_frame, tree_x) if algo in tree_algos
                         else (training_frame, x))
            with TRACER.span(f"automl_step:{algo}", kind="build",
                             attrs={"algo": algo}):
                m = cls(**{**params, **common}).train(x=x_s, y=y,
                                                      training_frame=fr_s)
            return m, algo, time.time() - t

        results, _ = windowed_parallel(
            enabled_steps(), self.parallelism, can_submit, build_step,
            scheduler=self._scheduler,
            job_meta=lambda step: dict(rows=training_frame.nrows,
                                       algo=step[0]))
        # leaderboard membership follows plan order, however builds ended
        for step, res, exc in results:
            if exc is not None:
                log.log("error", f"{step[0]} failed: "
                                 f"{type(exc).__name__}: {exc}")
                continue
            m, algo, dt = res
            if te_model is not None and algo in tree_algos:
                m.preprocessors.append(te_model)
            self._n_built += 1
            base_models.append(m)
            self.leaderboard.add(m)
            log.log("model", f"{m.key} ({algo}) in {dt:.1f}s")

        # random grids under the remaining budget
        for algo, cls, fixed, hyper, gseed in self._grids():
            if not self._budget_left():
                break
            if not self._algo_enabled(algo):
                continue
            remaining_models = (self.max_models - self._n_built
                                if self.max_models else 5)
            remaining_secs = (self.max_runtime_secs
                              - (time.time() - self._t0)
                              if self.max_runtime_secs else 0.0)
            gs = GridSearch(cls, hyper,
                            search_criteria=dict(
                                strategy="RandomDiscrete",
                                max_models=max(remaining_models, 0),
                                max_runtime_secs=max(remaining_secs, 0.0),
                                seed=gseed),
                            parallelism=self.parallelism,
                            scheduler=self._scheduler,
                            **{**fixed, **common})
            # grids are tree families: the base tree steps' frame
            grid = gs.train(x=tree_x, y=y, training_frame=tree_frame)
            for m in grid.models:
                if te_model is not None:
                    m.preprocessors.append(te_model)
                self._n_built += 1
                base_models.append(m)
                self.leaderboard.add(m)
                log.log("model", f"{m.key} ({algo} grid)")

        # exploitation (reference ModelingPlans exploitation steps): the
        # best GBM / XGBoost retrained with half the learn rate and twice
        # the trees, in the reserved share of the budget
        self._cap = self.max_models or None
        if self.exploitation_ratio > 0 and self._budget_left() \
                and self.leaderboard is not None:
            for fam in ("gbm", "xgboost"):
                if not self._budget_left() or not self._algo_enabled(fam):
                    continue
                cands = [m for m in self.leaderboard.models
                         if m.algo == fam]
                if not cands:
                    continue
                p = dict(cands[0].params)   # the family's leader
                anneal = {k: p[k] for k in
                          ("max_depth", "sample_rate", "col_sample_rate",
                           "col_sample_rate_per_tree", "nbins") if k in p}
                anneal["learn_rate"] = float(p.get("learn_rate", 0.1)) / 2
                anneal["ntrees"] = int(p.get("ntrees", 50)) * 2
                try:
                    t = time.time()
                    from h2o3_tpu_torch.models.gbm import GBM
                    from h2o3_tpu_torch.models.xgboost import XGBoost
                    bcls = XGBoost if fam == "xgboost" else GBM
                    m = bcls(**{**anneal, **common}).train(
                        x=tree_x, y=y, training_frame=tree_frame)
                    if te_model is not None:
                        m.preprocessors.append(te_model)
                    self._n_built += 1
                    base_models.append(m)
                    self.leaderboard.add(m)
                    log.log("exploit", f"lr-annealed {fam}: {m.key} in "
                                       f"{time.time() - t:.1f}s")
                except Exception as e:
                    log.log("error", f"exploitation {fam} failed: "
                                     f"{type(e).__name__}: {e}")

        # ensembles (reference StackedEnsembleStepsProvider): BestOfFamily
        # and AllModels
        if self._algo_enabled("STACKEDENSEMBLE") and len(base_models) >= 2:
            from h2o3_tpu_torch.orchestration.stacked_ensemble import \
                StackedEnsemble
            stackable = [m for m in base_models
                         if m.cv_holdout_predictions is not None]
            metric = self.sort_metric or (default_metric(stackable[0])
                                          if stackable else "rmse")
            dec = metric_higher_is_better(metric)

            def mval(m):
                mm = m.cross_validation_metrics or m.training_metrics
                v = getattr(mm, metric, np.nan)
                return float(v() if callable(v) else v)

            best_of_family: dict[str, Model] = {}
            for m in stackable:
                v = mval(m)
                if np.isnan(v):
                    continue   # no sort metric: it cannot stand for a family
                cur = best_of_family.get(m.algo)
                if cur is None or np.isnan(mval(cur)) or \
                        ((v > mval(cur)) if dec else (v < mval(cur))):
                    best_of_family[m.algo] = m
            for name, group in (("BestOfFamily",
                                 list(best_of_family.values())),
                                ("AllModels", stackable)):
                if len(group) < 2:
                    continue
                try:
                    se = StackedEnsemble(
                        base_models=group,
                        model_id=f"StackedEnsemble_{name}_"
                                 f"{self.project_name}",
                    ).train(y=y, training_frame=training_frame)
                    # ranked by the metalearner's metrics on the level-one
                    # frame, out of fold for the base models and so
                    # comparable to their CV metrics
                    se.cross_validation_metrics = \
                        se.output["metalearner"].training_metrics
                    self.leaderboard.add(se)
                    log.log("model", f"{se.key} over {len(group)} base "
                                     "models")
                except Exception as e:
                    log.log("error", f"StackedEnsemble {name} failed: "
                                     f"{type(e).__name__}: {e}")

        log.log("done", f"{len(self.leaderboard)} models in "
                        f"{time.time() - self._t0:.1f}s")
        log.info("stop_epoch", int(time.time()))
        log.info("duration_secs", round(time.time() - self._t0, 1))
        return self.leader

    def modeling_steps(self) -> list[tuple[str, list[str]]]:
        """The effective plan by provider family (reference
        ``StepDefinition``/``ModelingPlans.java``; h2o-py
        ``aml.modeling_steps``)."""
        fams: dict[str, list[str]] = {}
        for algo, _cls, _p in self._steps():
            if self._algo_enabled(algo):
                lst = fams.setdefault(algo, [])
                lst.append(f"def_{len(lst) + 1}")
        for algo, _cls, _f, _h, _s in self._grids():
            if self._algo_enabled(algo):
                fams.setdefault(algo, []).append("grid_1")
        if self._algo_enabled("STACKEDENSEMBLE"):
            fams["StackedEnsemble"] = ["best_of_family", "all"]
        return [(k, v) for k, v in fams.items()]

    @property
    def leader(self) -> Model | None:
        return self.leaderboard.leader if self.leaderboard else None
