"""Grid search — hyperparameter space walkers — the port of
``h2o3_tpu/orchestration/grid.py``.

Reference: ``hex/grid/`` — ``HyperSpaceWalker.java:409`` (Cartesian),
``:511`` (RandomDiscrete with max_models and max_runtime budgets),
``GridSearch.java`` search, ``Grid.java`` container keyed in the DKV.

Model ids are ``{grid_id}_model_{md5(combo_key(combo))[:8]}``, the JAX
package's, and the RandomDiscrete walk draws from
``np.random.default_rng(seed)`` as it does, so both packages visit the
same combos in the same order. Builds overlap on host threads, each on a
CUDA stream of its own (``parallelism``; :mod:`~h2o3_tpu_torch.
orchestration.parallel_build`). ``recovery_dir`` waits for the persist
slice and is refused by :class:`~h2o3_tpu_torch.persist.recovery.Recovery`.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from typing import Any, Sequence

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder
from h2o3_tpu_torch.utils.registry import DKV


def _metric_value(model: Model, metric: str | None, prefer_cv: bool) -> float:
    mm = (model.cross_validation_metrics if prefer_cv and
          model.cross_validation_metrics is not None else
          (model.validation_metrics or model.training_metrics))
    if mm is None:
        return float("nan")
    if metric is None:
        metric = default_metric(model)
    v = getattr(mm, metric, float("nan"))
    return float(v() if callable(v) else v)


def default_metric(model: Model) -> str:
    """Reference defaults: AUC (binomial), logloss (multinomial), rmse."""
    if model.nclasses == 2:
        return "auc"
    if model.nclasses > 2:
        return "logloss"
    return "rmse"


def metric_higher_is_better(metric: str) -> bool:
    return metric in ("auc", "pr_auc", "aucpr", "accuracy", "r2", "gini")


class Grid:
    """Trained-model container, sortable by metric (reference:
    ``hex.grid.Grid``), put into the DKV under its id."""

    def __init__(self, grid_id: str, models: list[Model],
                 failures: list[tuple[dict, str]], metric: str | None = None):
        self.grid_id = grid_id
        self.models = models
        self.failures = failures
        self._metric = metric
        DKV.put(grid_id, self)

    def sorted_models(self, metric: str | None = None,
                      decreasing: bool | None = None) -> list[Model]:
        if not self.models:
            return []
        metric = metric or self._metric or default_metric(self.models[0])
        if decreasing is None:
            decreasing = metric_higher_is_better(metric)
        keyed = [(m, _metric_value(m, metric, prefer_cv=True))
                 for m in self.models]
        keyed.sort(key=lambda t: (np.isnan(t[1]),
                                  -t[1] if decreasing else t[1]))
        return [m for m, _ in keyed]

    @property
    def model_ids(self) -> list[str]:
        return [m.key for m in self.models]

    def __repr__(self) -> str:
        lines = [f"Grid(id={self.grid_id!r}, {len(self.models)} models, "
                 f"{len(self.failures)} failed)"]
        for m in self.sorted_models()[:10]:
            lines.append(f"  {m.key}")
        return "\n".join(lines)


class GridSearch:
    """h2o-py surface: ``H2OGridSearch(builder, hyper_params,
    search_criteria)``. search_criteria: ``{"strategy": "Cartesian"}`` (the
    default) or ``{"strategy": "RandomDiscrete", "max_models": N,
    "max_runtime_secs": S, "seed": k}``."""

    def __init__(self, builder_cls: type[ModelBuilder] | ModelBuilder,
                 hyper_params: dict[str, Sequence[Any]],
                 grid_id: str | None = None,
                 search_criteria: dict | None = None,
                 recovery_dir: str | None = None,
                 parallelism: int = 1, scheduler=None, **fixed_params):
        if isinstance(builder_cls, ModelBuilder):
            fixed_params = {**builder_cls.params, **fixed_params}
            builder_cls = type(builder_cls)
        self.builder_cls = builder_cls
        self.hyper_params = {k: list(v) for k, v in hyper_params.items()}
        self.fixed_params = fixed_params
        self.search_criteria = dict(search_criteria
                                    or {"strategy": "Cartesian"})
        self.grid_id = grid_id or f"{builder_cls.algo}_grid_{int(time.time())}"
        self.recovery_dir = recovery_dir
        self.parallelism = max(1, int(parallelism))
        self.scheduler = scheduler
        self.grid: Grid | None = None

    def _combos(self):
        """Lazy combo stream: Cartesian iterates the product;
        RandomDiscrete draws index tuples without enumerating the space
        (reference ``HyperSpaceWalker.RandomDiscreteValueWalker``)."""
        keys = sorted(self.hyper_params)
        strategy = str(self.search_criteria.get("strategy",
                                                "Cartesian")).lower()
        if strategy == "cartesian":
            for vs in itertools.product(*(self.hyper_params[k]
                                          for k in keys)):
                yield dict(zip(keys, vs))
            return
        if strategy != "randomdiscrete":
            raise ValueError(f"unknown search strategy "
                             f"{self.search_criteria.get('strategy')!r}")
        sizes = [len(self.hyper_params[k]) for k in keys]
        total = int(np.prod(sizes)) if sizes else 0
        seed = int(self.search_criteria.get("seed", 0) or 0)
        rng = np.random.default_rng(seed if seed > 0 else None)
        seen: set[tuple] = set()
        misses = 0
        while len(seen) < total and misses < 1000:
            idx = tuple(int(rng.integers(s)) for s in sizes)
            if idx in seen:
                misses += 1
                continue
            misses = 0
            seen.add(idx)
            yield {k: self.hyper_params[k][i] for k, i in zip(keys, idx)}

    def train(self, x=None, y=None, training_frame: Frame | None = None,
              validation_frame: Frame | None = None, **kw) -> Grid:
        max_models = int(self.search_criteria.get("max_models", 0) or 0)
        max_secs = float(self.search_criteria.get("max_runtime_secs", 0.0)
                         or 0.0)
        t0 = time.time()
        models: list[Model] = []
        failures: list[tuple[dict, str]] = []
        if self.recovery_dir:
            from h2o3_tpu_torch.persist.recovery import Recovery
            Recovery(self.recovery_dir)

        from h2o3_tpu_torch.orchestration.parallel_build import \
            windowed_parallel
        from h2o3_tpu_torch.orchestration.scheduler import MeshScheduler
        from h2o3_tpu_torch.persist.recovery import combo_key

        scheduler = self.scheduler or MeshScheduler(slices=self.parallelism)
        meta = dict(rows=training_frame.nrows if training_frame else None,
                    algo=self.builder_cls.algo)

        def can_submit(n_submitted: int) -> bool:
            if max_models and len(models) + n_submitted >= max_models:
                return False
            return not (max_secs and time.time() - t0 > max_secs)

        def build_one(combo: dict) -> Model:
            params = {**self.fixed_params, **combo}
            # the id comes from the combo, so it is the JAX package's too
            tag = hashlib.md5(combo_key(combo).encode()).hexdigest()[:8]
            params["model_id"] = f"{self.grid_id}_model_{tag}"
            m = self.builder_cls(**params).train(
                x=x, y=y, training_frame=training_frame,
                validation_frame=validation_frame, **kw)
            m.output["hyper_values"] = combo
            return m

        # a failed build does not use up the model budget (reference
        # GridSearch keeps walking the space)
        results, _ = windowed_parallel(
            self._combos(), self.parallelism, can_submit, build_one,
            scheduler=scheduler, job_meta=lambda combo: meta)
        for combo, m, exc in results:
            if exc is not None:
                failures.append((combo, f"{type(exc).__name__}: {exc}"))
                continue
            models.append(m)
        self.grid = Grid(self.grid_id, models, failures,
                         metric=self.search_criteria.get("sort_metric"))
        return self.grid

    def get_grid(self, sort_by: str | None = None,
                 decreasing: bool | None = None):
        return self.grid.sorted_models(sort_by, decreasing) if self.grid \
            else []
