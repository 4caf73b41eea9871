"""V3 schema serialization — framework objects → REST JSON — the port of
``h2o3_tpu/api/schemas.py``.

Reference: ``water/api/Schema.java`` (reflection-driven field copy via ``@API``
annotations) and ``water/api/schemas3/*.java`` (FrameV3, ModelSchemaV3,
JobV3, CloudV3 …). The wire format keys (``__meta.schema_type``, field names)
follow the reference so existing h2o-py response parsing recognizes them.
Tensors are fetched to numpy before serialisation; the histograms of
``ColV3`` are counted on the column's device. CloudV3 counts the ranks of
a multi-process cloud (``cloud_size`` the world size, a node row a rank);
its ``workers`` (elastic membership) stay empty until elastic training is
ported.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np


def _clean(x: Any) -> Any:
    """JSON-safe: numpy scalars → python, non-finite floats → None."""
    if isinstance(x, (np.floating, float)):
        f = float(x)
        return f if math.isfinite(f) else None
    if isinstance(x, (np.integer, int)):
        return int(x)
    if isinstance(x, np.ndarray):
        return [_clean(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (str, bool)) or x is None:
        return x
    return str(x)


def _meta(schema_type: str) -> dict:
    return {"__meta": {"schema_version": 3, "schema_name": schema_type,
                       "schema_type": schema_type}}


def _cloud_devices() -> list[str]:
    """The devices of this process's cloud: in a multi-process cloud one
    per rank (its host and device), else every CUDA card when the port
    runs on the card, else the one device the caller chose."""
    import torch

    from h2o3_tpu_torch.device import _default
    from h2o3_tpu_torch.parallel.distributed import placements
    ranks = placements()
    if len(ranks) > 1:
        return [f"rank {r}: {p}" for r, p in enumerate(ranks)]
    if (_default is None or _default.type == "cuda") \
            and torch.cuda.is_available():
        return [f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                for i in range(torch.cuda.device_count())]
    return [str(_default or "cpu")]


def cloud_v3(version: str) -> dict:
    import os as _os

    from h2o3_tpu_torch.utils.memory import MEMORY, host_stats
    devs = _cloud_devices()
    # real memory accounting behind the reference's per-node heap fields
    # (water/api/schemas3/CloudV3.java semantics): max_mem = machine total,
    # free_mem = machine available, mem_value_size = bytes resident in the
    # DKV (card tensors included; the per-device split lives in
    # /3/Memory), pojo_mem = process RSS not attributable to HOST-resident
    # DKV bytes. One process serves the whole device cloud, so the process
    # numbers ride on every node row.
    host = host_stats()
    dkv_bytes, _by_kind, nkeys = MEMORY.dkv_totals()
    pojo = max(host["rss_bytes"] - MEMORY.dkv_host_bytes(), 0)
    pid = _os.getpid()
    # stream-lease utilization (orchestration/scheduler.py): layout + per
    # stream busy seconds / builds / queue wait
    from h2o3_tpu_torch.orchestration.scheduler import SLICE_STATS
    return {**_meta("CloudV3"), "version": version,
            "cloud_name": "h2o3_tpu_torch",
            "mesh_slices": SLICE_STATS.snapshot(),
            # elastic local-SGD membership is not ported yet
            "workers": [],
            "cloud_size": len(devs), "cloud_healthy": True, "bad_nodes": 0,
            "consensus": True, "locked": True, "is_client": False,
            "cloud_uptime_millis": 0, "internal_security_enabled": False,
            "branch_name": "cuda", "build_number": "0", "build_age": "",
            "build_too_old": False, "node_idx": 0,
            "cloud_internal_timezone": "UTC",
            "datafile_parser_timezone": "UTC",
            "nodes": [{"h2o": d, "healthy": True, "num_cpus": 1,
                       "cpus_allowed": 1,
                       "free_mem": host["available_bytes"],
                       "max_mem": host["total_bytes"],
                       "mem_value_size": dkv_bytes, "pojo_mem": pojo,
                       "swap_mem": 0,
                       "free_disk": 0, "max_disk": 0, "num_keys": nkeys,
                       "tcps_active": 0, "open_fds": 0, "rpcs_active": 0,
                       "last_ping": 0, "sys_load": 0.0,
                       "my_cpu_pct": 0, "sys_cpu_pct": 0, "pid": pid}
                      for d in devs]}


def memory_v3(summary: dict) -> dict:
    """``GET /3/Memory`` — the three-level byte accounting: host RSS +
    machine totals, per-device HBM (``memory_stats`` or live-array
    fallback), DKV totals by kind with the top-N keys (spilled stubs keep
    their on-disk bytes under the ``spilled`` kind), monotonic watermarks,
    the leak-detector report (utils/memory.py), and the Cleaner's spill
    view — budget, spill/fault-in/view-drop counters, ice_root contents
    (utils/cleaner.py; docs/INGEST.md)."""
    return {**_meta("MemoryV3"), **_clean(summary)}


def compute_v3(snapshot: dict) -> dict:
    """``GET /3/Compute`` — the compute observatory (utils/costs.py): per
    logical site the recorded signatures (shapes/dtypes/statics),
    capture seconds, the cost functions' FLOPs/bytes, and recompile
    events with signature diffs; per loop the achieved FLOP/s / bytes/s,
    arithmetic intensity, and utilization against the card's peak row
    (utilization and roofline are null off the card — on the CPU
    included)."""
    return {**_meta("ComputeV3"), **_clean(snapshot)}


def health_v3(verdict: dict) -> dict:
    """``GET /3/Health`` — the health evaluator's subsystem-scored verdict
    (utils/health.py): overall + per-subsystem ``healthy`` / ``degraded``
    / ``unhealthy``, every finding carrying the tripping rule, the
    observed value, and the threshold; plus the rule catalog with its env
    knobs and the currently-open incident rules
    (docs/OBSERVABILITY.md "Health & incidents")."""
    return {**_meta("HealthV3"), **_clean(verdict)}


def incidents_v3(summaries: list) -> dict:
    """``GET /3/Incidents`` — the bounded incident ring, newest first:
    rule / subsystem / severity / status / observed vs threshold /
    repeats / timestamps (contexts served per-incident by
    ``GET /3/Incidents/{id}``)."""
    return {**_meta("IncidentsV3"), "incidents": _clean(summaries)}


def timeseries_v3(payload: dict) -> dict:
    """``GET /3/TimeSeries`` — the flight recorder (utils/flight.py):
    matching retained series, each with its raw ``[t, value]`` tail and
    min/max/mean/last rollup windows, plus the recorder's stats
    (running / interval / retention / dropped-series counters)
    (docs/OBSERVABILITY.md "Flight recorder & post-mortems")."""
    return {**_meta("TimeSeriesV3"), **_clean(payload)}


def ops_v3(payload: dict) -> dict:
    """``GET/POST /3/Ops`` — the ops plane: remediation policy view
    (mode/map/bounds), the append-only action log, per-tenant usage, and
    the configured quotas (docs/OPERATIONS.md is the operator catalog)."""
    return {**_meta("OpsV3"), **_clean(payload)}


def incident_v3(record: dict) -> dict:
    """``GET /3/Incidents/{id}`` — one incident with its trip-time
    correlated context: recent trace ids, log-ring tail, memory top-keys,
    compute loop rows, the rule's observed-value series, and (for
    profiled compute incidents) the profiler capture id."""
    return {**_meta("IncidentV3"), **_clean(record)}


def _column_histogram(vec, r, nbins: int = 20) -> dict:
    """ColV3 histogram fields (reference ``FrameV3.ColV3``: Flow's frame
    inspector renders these as sparklines): fixed-stride bins over
    [min, max] counted in one device pass."""
    import math as _math

    import torch
    x = vec.data
    lo, hi = float(r.min), float(r.max)
    if not (_math.isfinite(lo) and _math.isfinite(hi)):
        # +/-inf rows are counted by rollups but must not set the range
        finite = torch.isfinite(x)
        big = float(torch.finfo(torch.float32).max)
        lo = float(torch.where(finite, x, big).min())
        hi = float(torch.where(finite, x, -big).max())
    if not (hi > lo) or r.nrows == 0:
        return {"histogram_bins": [], "histogram_base": _clean(lo),
                "histogram_stride": 0}
    stride = (hi - lo) / nbins
    ok = torch.isfinite(x)
    ids = ((x - lo) / stride).to(torch.int32).clamp(0, nbins - 1)
    cnt = torch.zeros(nbins, dtype=torch.int64, device=x.device)
    cnt.index_add_(0, torch.where(ok, ids, 0).long(), ok.long())
    return {"histogram_bins": [int(v) for v in cnt.cpu().tolist()],
            "histogram_base": _clean(lo), "histogram_stride": _clean(stride)}


def _histogram_cached(vec, r) -> dict:
    """Histograms are immutable like the rollups — compute once per vec
    (the reference caches them in RollupStats for the same reason; frame
    summaries are served repeatedly to Flow's side panel and h2o-py)."""
    cache = getattr(vec, "_hist_cache", None)
    if cache is None:
        if vec.is_numeric:
            cache = _column_histogram(vec, r)
        else:
            # categorical "histogram": per-level counts (reference ColV3
            # serves these for Flow's frame inspector bars)
            import torch
            codes = vec.data
            ok = codes >= 0
            cnt = torch.zeros(len(vec.domain), dtype=torch.int64,
                              device=codes.device)
            cnt.index_add_(0, codes.clamp(0, len(vec.domain) - 1).long(),
                           ok.long())
            cache = {"histogram_bins": [int(v) for v in cnt.cpu().tolist()],
                     "histogram_base": 0, "histogram_stride": 1}
        vec._hist_cache = cache
    return cache


def frame_v3(key: str, frame, rows: int = 10) -> dict:
    """FrameV3 with the exact per-column fields h2o-py's expr cache pops
    (``h2o-py/h2o/expr.py:_fill_data``): __meta, domain_cardinality,
    string_data, data; enum data = integer codes + domain (reference
    water/api/schemas3/FrameV3.java ColV3)."""
    cols = []
    for name, vec in zip(frame.names, frame.vecs):
        r = vec.rollups()     # handles host-resident (string/uuid) vecs too
        if rows <= 0:
            data, sdata = [], None
        elif vec.type.value == "string" or not vec.type.on_device:
            data, sdata = None, [None if v is None else str(v)
                                 for v in vec.to_numpy()[:rows]]
        else:
            data, sdata = _clean(vec.to_numpy()[:rows]), None
        col = {"__meta": {"schema_name": "ColV3", "schema_type": "ColV3"},
               "label": name, "type": vec.type.value,
               "missing_count": int(r.na_cnt),
               "domain": list(vec.domain) if vec.domain else None,
               "domain_cardinality": vec.cardinality(),
               "data": data, "string_data": sdata,
               "precision": 0, "zero_count": 0,
               "positive_infinity_count": 0, "negative_infinity_count": 0}
        if vec.is_numeric:
            col.update(mins=[_clean(r.min)], maxs=[_clean(r.max)],
                       mean=_clean(r.mean), sigma=_clean(r.sigma))
            col.update(_histogram_cached(vec, r))
        else:
            col.update(mins=[], maxs=[], mean=None, sigma=None)
            if vec.domain and vec.type.on_device:
                col.update(_histogram_cached(vec, r))
        cols.append(col)
    return {**_meta("FrameV3"), "frame_id": {"name": key},
            "rows": frame.nrows, "row_count": frame.nrows,
            "row_offset": 0, "column_offset": 0,
            "column_count": frame.ncols, "total_column_count": frame.ncols,
            "columns": cols}


def frames_list_v3(store) -> dict:
    from h2o3_tpu_torch.frame.frame import Frame
    # raw_items: spilled frames list from their stubs (nrows/ncols carried)
    # instead of being re-inflated from disk just for a listing
    frames = [{"frame_id": {"name": k}, "rows": v.nrows, "column_count": v.ncols}
              for k, v in store.raw_items()
              if isinstance(v, Frame) or type(v).__name__ == "SwappedFrame"]
    return {**_meta("FramesV3"), "frames": frames}


def metrics_v3(mm, domain=None) -> dict | None:
    if mm is None:
        return None
    out = {}
    if domain is not None and hasattr(mm, "auc"):
        # h2o-py's perf.confusion_matrix() reads the class labels here
        out["domain"] = list(domain)
    for f in ("mse", "rmse", "mae", "r2", "logloss", "auc", "pr_auc",
              "mean_per_class_error", "residual_deviance", "null_deviance",
              "accuracy", "mean_residual_deviance", "totss", "tot_withinss",
              "betweenss"):
        v = getattr(mm, f, None)
        if v is not None and not callable(v):
            out[f] = _clean(v)
    # h2o-py's metrics mixins read the reference's exact (capitalized) keys
    # and pick their class from __meta.schema_name (h2o/model/metrics/)
    schema = {"ModelMetricsBinomial": "ModelMetricsBinomialV3",
              "ModelMetricsMultinomial": "ModelMetricsMultinomialV3",
              "ModelMetricsRegression": "ModelMetricsRegressionV3",
              "ModelMetricsClustering": "ModelMetricsClusteringV3",
              }.get(type(mm).__name__, "ModelMetricsV3")
    for lower, upper in (("mse", "MSE"), ("rmse", "RMSE"), ("auc", "AUC"),
                         ("gini", "Gini"), ("r2", "r2")):
        v = getattr(mm, lower, None)
        if v is not None and not callable(v):
            out[upper] = _clean(v)
    out.setdefault("nobs", _clean(getattr(mm, "nobs", 0)))
    if hasattr(mm, "threshold_table"):
        # AUC2 criteria tables (reference: hex/AUC2.java; h2o-py's
        # perf.F1()/mcc()/find_threshold_by_max_metric read these)
        tcols, trows = mm.threshold_table()
        if trows:
            out["thresholds_and_metric_scores"] = twodim_table_v3(
                "Metrics for Thresholds", "Binomial metrics as a function of "
                "classification thresholds",
                [(c, "long" if c == "idx" else "double", "%f")
                 for c in tcols], trows)
            _, mrows = mm.max_criteria_and_metric_scores((tcols, trows))
            out["max_criteria_and_metric_scores"] = twodim_table_v3(
                "Maximum Metrics", "Maximum metrics at their respective "
                "thresholds",
                [("metric", "string", "%s"), ("threshold", "double", "%f"),
                 ("value", "double", "%f"), ("idx", "long", "%d")], mrows)
    out["description"] = None
    out["custom_metric_name"] = getattr(mm, "custom_metric_name", None)
    out["custom_metric_value"] = _clean(getattr(mm, "custom_metric_value", 0.0))
    out["scoring_time"] = 0
    return {**_meta(schema), **out}


def model_v3(model) -> dict:
    out = {**_meta("ModelSchemaV3"),
           "model_id": {"name": model.key}, "algo": model.algo,
           "algo_full_name": model.algo,
           "response_column_name": model.response_column,
           "parameters": [{"name": k, "actual_value": _clean(v)}
                          for k, v in dict(model.params).items()],
           "output": {
               "model_category": ("Binomial" if model.nclasses == 2 else
                                  "Multinomial" if model.nclasses > 2 else
                                  "Regression"),
               "training_metrics": metrics_v3(model.training_metrics,
                                              model.response_domain),
               "validation_metrics": metrics_v3(model.validation_metrics,
                                                model.response_domain),
               "cross_validation_metrics": metrics_v3(
                   model.cross_validation_metrics, model.response_domain),
               "cross_validation_metrics_summary":
                   _cv_summary_v3(getattr(model, "cv_metrics_summary",
                                          None)),
               # folds are fits by weight masking, so no per-fold model
               # keys exist; h2o-py reads this key
               # unconditionally when CV metrics are present
               "cross_validation_models": None,
               "run_time_ms": model.run_time_ms,
           }}
    if model.scoring_history is not None:
        cols, rows = model.scoring_history
        out["output"]["scoring_history"] = twodim_table_v3(
            "Scoring History", "", cols, rows)
    if hasattr(model, "varimp"):
        # h2o-py model.varimp() reads output.variable_importances
        # (reference: ModelOutputSchemaV3._variable_importances). Memoized:
        # recomputing fetches every tree's splits from the device, and Flow
        # fetches the payload per plot.
        try:
            vi_rows = getattr(model, "_varimp_rows", None)
            if vi_rows is None:
                vi_rows = model.varimp()
                try:
                    model._varimp_rows = vi_rows
                except Exception:   # noqa: BLE001 — frozen model classes
                    pass
        except Exception:   # noqa: BLE001 — varimp optional on some families
            vi_rows = None
        if vi_rows:
            out["output"]["variable_importances"] = twodim_table_v3(
                "Variable Importances", "",
                [("variable", "string", "%s"),
                 ("relative_importance", "float", "%5f"),
                 ("scaled_importance", "float", "%5f"),
                 ("percentage", "float", "%5f")],
                [list(r) for r in vi_rows])
    meta_model = (model.output or {}).get("metalearner")
    if meta_model is not None:
        # h2o-py's H2OStackedEnsembleEstimator.metalearner() fetches this key
        out["output"]["metalearner"] = {"name": meta_model.key}
        out["output"]["stacking_strategy"] = "cross_validation"
    return out


def models_list_v3(store) -> dict:
    from h2o3_tpu_torch.models.model_base import Model
    models = [{"model_id": {"name": k}, "algo": v.algo}
              for k, v in store.raw_items()
              if isinstance(v, Model)]
    return {**_meta("ModelsV3"), "models": models}


def raw_frame_v3(key: str, nbytes: int) -> dict:
    """FramesV3 body for a RAW upload key (reference exposes /3/PostFile
    results as 1-column ByteVec frames; h2o.upload_mojo's get_frame step
    reads this shape before handing the key to the generic builder)."""
    col = {"__meta": {"schema_version": 3, "schema_name": "ColV3",
                      "schema_type": "Vec"},
           "label": "C1", "type": "uuid", "data": [], "string_data": [],
           "missing_count": 0, "domain": None, "domain_cardinality": 0,
           "mean": 0, "sigma": 0, "zero_count": 0,
           "positive_infinity_count": 0, "negative_infinity_count": 0,
           "histogram_bins": [], "histogram_base": 0, "histogram_stride": 0,
           "percentiles": []}
    return {"__meta": {"schema_type": "FramesV3"},
            "frames": [{"frame_id": {"name": key},
                        "rows": nbytes, "row_count": nbytes,
                        "row_offset": 0, "column_offset": 0,
                        "column_count": 1, "total_column_count": 1,
                        "byte_size": nbytes, "is_text": False,
                        "columns": [col], "checksum": 0,
                        "default_percentiles": [], "compatible_models": [],
                        "chunk_summary": None,
                        "distribution_summary": None}]}


def _cv_summary_v3(summary) -> dict | None:
    """Per-fold CV metric table (reference ModelBuilder's
    cross_validation_metrics_summary: rows = metrics, columns = mean, sd,
    cv_{k}_valid; h2o-py renders it verbatim)."""
    if summary is None:
        return None
    _names, nfolds, rows = summary
    cols = [("", "string", "%s"), ("mean", "double", "%f"),
            ("sd", "double", "%f")] + [(f"cv_{k + 1}_valid", "double", "%f")
                                       for k in range(nfolds)]
    return twodim_table_v3("Cross-Validation Metrics Summary",
                           "per-fold holdout metrics", cols, rows)


def twodim_table_v3(name: str, description: str,
                    columns: list[tuple[str, str, str]],
                    rows: list[list], row_headers: bool = False) -> dict:
    """TwoDimTableV3 wire format (reference:
    ``water/api/schemas3/TwoDimTableV3.java:55`` ``fillFromImpl``); ``data``
    is column-major. With ``row_headers`` a leading row-index column (name
    ``""`` after pythonify("#"), type string) is embedded — the
    leaderboard/event-log convention, where h2o-py's ``_fetch_table`` drops
    it via ``fr[1:]``. Metric/scoring tables ship WITHOUT it (the reference
    passes a null colHeaderForRowHeaders; h2o-py indexes ``cell_values[0]``
    as the first real column)."""
    cols = ([{"name": "", "type": "string", "format": "%s", "description": "#"}]
            if row_headers else [])
    cols += [{"name": n, "type": t, "format": f, "description": n}
             for n, t, f in columns]
    data = [[str(i) for i in range(len(rows))]] if row_headers else []
    for c in range(len(columns)):
        data.append([_clean(r[c]) for r in rows])
    return {"__meta": {"schema_version": 3, "schema_name": "TwoDimTableV3",
                       "schema_type": "TwoDimTable"},
            "name": name, "description": description,
            "columns": cols, "rowcount": len(rows), "data": data}


def leaderboard_v99(aml, extensions: list[str] | None = None) -> dict:
    """LeaderboardV99 (reference:
    ``water/automl/api/schemas3/LeaderboardV99.java:11``)."""
    lb = aml.leaderboard
    cols, rows, sort_metric, sort_dec, sort_vals, model_ids = (
        lb.table(extensions) if lb is not None
        else ([("model_id", "string", "%s")], [], "auc", True, [], []))
    table = twodim_table_v3(
        f"Leaderboard for project {aml.project_name}",
        (f"models sorted in order of {sort_metric}, best first"
         if rows else "no models in this leaderboard"),
        cols, rows, row_headers=True)
    return {"__meta": {"schema_version": 99, "schema_name": "LeaderboardV99",
                       "schema_type": "Leaderboard"},
            "project_name": aml.project_name,
            "models": [{"name": k} for k in model_ids],
            "sort_metric": sort_metric,
            "sort_metrics": _clean(sort_vals),
            "sort_decreasing": sort_dec,
            "table": table}


def automl_v99(aml, job_key: str | None = None) -> dict:
    """AutoMLV99 state (reference:
    ``water/automl/api/schemas3/AutoMLV99.java:17``): the exact fields
    h2o-py's ``_fetch_state`` reads — project_name, leaderboard.models,
    leaderboard_table, event_log_table."""
    lbv = leaderboard_v99(aml)
    ev_cols = [("timestamp", "string", "%s"), ("level", "string", "%s"),
               ("stage", "string", "%s"), ("message", "string", "%s"),
               ("name", "string", "%s"), ("value", "string", "%s")]
    ev_rows = aml.event_log.table_rows()
    return {"__meta": {"schema_version": 99, "schema_name": "AutoMLV99",
                       "schema_type": "AutoML"},
            "automl_id": {"name": job_key or aml.project_name},
            "project_name": aml.project_name,
            "leaderboard": lbv,
            "leaderboard_table": lbv["table"],
            "event_log": {"name": f"{aml.project_name}_eventlog"},
            "event_log_table": twodim_table_v3(
                f"Event Log for:{aml.project_name}",
                "Actions taken and discoveries made by AutoML",
                ev_cols, ev_rows, row_headers=True),
            "sort_metric": lbv["sort_metric"],
            "modeling_steps": [
                {"name": name, "steps": [{"id": s, "weight": 10, "group": 1}
                                         for s in steps]}
                for name, steps in aml.modeling_steps()]}


def _run_time(job) -> float:
    """Seconds the job has run (to its end, or to now while it runs)."""
    import time as _time
    start = getattr(job, "start_time", None)
    if start is None:
        return 0.0
    end = getattr(job, "end_time", None)
    return (end if end is not None else _time.time()) - start


def job_v3(job_id: str, job) -> dict:
    status = {"RUNNING": "RUNNING", "DONE": "DONE", "FAILED": "FAILED",
              "CANCELLED": "CANCELLED"}.get(job.status, job.status)
    d = {**_meta("JobV3"), "key": {"name": job_id}, "status": status,
         "progress": _clean(job.progress), "progress_msg": job.progress_msg,
         "msec": int(_run_time(job) * 1000),
         "description": getattr(job, "description", ""),
         # reliability surface (docs/RELIABILITY.md): True when the build
         # auto-checkpoints under auto_recovery_dir (hex/faulttolerance
         # semantics — a crashed job restarts from its snapshot); h2o-py's
         # H2OJob reads auto_recoverable/exception/warnings unconditionally
         "auto_recoverable": bool(getattr(job, "auto_recovery_dir", None)),
         "auto_recovery_dir": getattr(job, "auto_recovery_dir", None),
         # dispatch retries this job's build absorbed + its deadline budget
         "retries": int(getattr(job, "retries", 0) or 0),
         "max_runtime_secs": _clean(float(
             getattr(job, "max_runtime_secs", 0.0) or 0.0)),
         "deadline_exceeded": bool(getattr(job, "deadline_exceeded", False)),
         # elastic membership decay (multi-GPU, not ported): always 0
         "workers_ejected": int(getattr(job, "workers_ejected", 0) or 0),
         "exception": None,
         "warnings": None,
         # the trace the job's execution reports into
         "trace_id": getattr(job, "trace_id", None),
         "dest": {"name": getattr(job, "dest_key", None) or job_id}}
    if job.status == "FAILED" and job.exception is not None:
        d["exception"] = str(job.exception)
        d["stacktrace"] = ""
        if getattr(job, "retry_history", None):
            # what the retry budget tried before giving up (DispatchFailed)
            d["retry_history"] = job.retry_history
    return d


def score_v3(payload: dict) -> dict:
    """``POST /3/Score/{model}`` — batched request-sized predictions:
    ``predictions`` maps output columns (``predict``, ``p{level}``) to
    value lists; ``batch_rows``/``batch_requests`` report how the
    micro-batcher fused this request; ``priority`` echoes the request's
    shedding class and ``replica`` names the serving replica when a pool
    is routing."""
    return {**_meta("ScoreV3"), **_clean(payload)}


def serving_v3(stats: dict) -> dict:
    """``GET /3/Score`` — scoring-tier state: resident models with
    artifact bytes + request counts + per-model ``slo`` controller state
    (target/window/p50/p99), residency budget, eviction count,
    captured-graph cache hit/miss counters and each signature's mode,
    ``shed`` accounting by reason/priority, the ``replicas`` pool view
    (stream leases, busy and queue-wait seconds, scale events), memory
    watermarks."""
    return {**_meta("ServingV3"), **_clean(stats)}


def trace_v3(trace: dict) -> dict:
    """One completed trace (``GET /3/Traces/{id}``): flat span list, the
    nested span tree, and the computed critical path — the chain of spans
    that determined the request's wall time."""
    from h2o3_tpu_torch.utils import tracing
    return {**_meta("TraceV3"),
            "trace_id": trace["trace_id"], "name": trace["name"],
            "start_ns": trace["start_ns"], "dur_ns": trace["dur_ns"],
            "nspans": trace["nspans"], "dropped": trace.get("dropped", 0),
            "status": trace["status"],
            "in_progress": bool(trace.get("in_progress")),
            "spans": trace.get("spans", []),
            "tree": tracing.span_tree(trace),
            "critical_path": tracing.critical_path(trace)}
