"""The remediation action catalog + the append-only audit log.

The port of ``h2o3_tpu/ops_plane/actions.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: H2O-3's Cleaner is the archetype — a runtime daemon allowed to
change system state (spill memory) only inside strict bounds (the
budget); this module holds every bounded mutation the remediation engine
(:mod:`h2o3_tpu_torch.ops_plane.remediate`) may take, and the audit trail that
makes them operable:

- **actions are functions named ``act_*``** returning what they did, how
  to undo it, and whether they actually touched anything. Each action is
  *bounded* (replica cap, Cleaner-budget ceiling, one worker per
  reassignment, one pinned bucket) so a runaway policy cannot scale or
  spill without limit.
- **ActionLog.record is the ONLY entry point** — no ops-plane code
  calls a live policy setter (replica
  count, Cleaner budget, admission window, shard map) outside an
  ``act_*`` body, and no code calls an ``act_*`` function except the
  log. In ``observe`` mode the log records what it WOULD do and executes
  nothing; in ``act`` mode it executes, stamps the outcome
  (``applied`` / ``skipped`` / ``failed``), and keeps a rollback token.

Probe seams (``_scoring`` / ``_cleaner`` / ``_live_groups`` /
``_scorer_cache``) are module-level so tests monkeypatch them exactly
like the health evaluator's (utils/health.py).
"""

from __future__ import annotations

import os
import time
import uuid

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm

#: every recorded action, by rule, action class, and outcome
ACTIONS_TOTAL = _tm.METRICS.counter(
    "h2o3_ops_actions", "remediation actions recorded",
    ("rule", "action", "outcome"))

#: audit ring capacity (append-only semantics within the bound)
LOG_CAPACITY = 256


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def max_replicas_from_env(default: int = 4) -> int:
    """Replica-count ceiling for serving relief
    (``H2O3TPU_OPS_MAX_REPLICAS``)."""
    return max(_env_int("H2O3TPU_OPS_MAX_REPLICAS", default), 1)


def cleaner_cap_factor_from_env(default: float = 4.0) -> float:
    """How far the Cleaner budget may be raised, as a multiple of its
    value when remediation first touched it
    (``H2O3TPU_OPS_CLEANER_CAP_FACTOR``)."""
    return max(_env_float("H2O3TPU_OPS_CLEANER_CAP_FACTOR", default), 1.0)


# -- live-target seams (tests monkeypatch these) -----------------------------

def _scoring():
    """The scoring tier ONLY if serving is already loaded — remediation
    must not be what imports the stack."""
    import sys
    m = sys.modules.get("h2o3_tpu_torch.serving.service")
    return m.SCORING if m is not None else None


def _scorer_cache():
    svc = _scoring()
    return svc.cache if svc is not None else None


def _cleaner():
    from h2o3_tpu_torch.utils.cleaner import CLEANER
    return CLEANER


def _live_groups():
    """Live elastic groups: none until the multi-GPU slice ports elastic
    local-SGD (``act_reassign_shards`` then skips, as the reference's does
    with no live group)."""
    return []


def _quotas():
    from h2o3_tpu_torch.ops_plane.tenancy import QUOTAS
    return QUOTAS


#: Cleaner budget when remediation first raised it — the ceiling anchor.
#: Keyed by id(cleaner) so a test's private Cleaner gets its own anchor.
_CLEANER_BASE: dict[int, int] = {}
_CLEANER_BASE_LOCK = lockwitness.lock("ops_plane.actions._CLEANER_BASE_LOCK")


class _ActionResult:
    """What an ``act_*`` function did: parameters for the audit record, a
    rollback thunk (None = irreversible/nothing to undo), and whether it
    touched anything (``skipped`` actions changed no state)."""

    __slots__ = ("outcome", "params", "rollback")

    def __init__(self, outcome: str, params: dict, rollback=None):
        self.outcome = outcome      # "applied" | "skipped"
        self.params = params
        self.rollback = rollback


def _applied(params: dict, rollback=None) -> _ActionResult:
    return _ActionResult("applied", params, rollback)


def _skipped(reason: str, **params) -> _ActionResult:
    return _ActionResult("skipped", {"reason": reason, **params})


# -- the catalog (each bounded; docs/OPERATIONS.md is the operator table) ----

def act_serving_relief(incident: dict) -> _ActionResult:
    """Shed-rate / p99 trip: widen the admission window of every resident
    model with an SLO target (cumulative ×1.5, bounded at ×4 the original
    — ``ScoringService.widen_admission``); with nothing to widen, add ONE
    scoring replica up to ``H2O3TPU_OPS_MAX_REPLICAS``. Rollback restores
    the original targets / removes the added replica."""
    svc = _scoring()
    if svc is None:
        return _skipped("serving tier not loaded")
    widened = svc.widen_admission()
    if widened:
        return _applied({"widened": widened},
                        rollback=svc.restore_admission)
    pool = svc.pool
    cap = max_replicas_from_env()
    if pool is not None and len(pool.replicas) < cap:
        n = len(pool.replicas) + 1
        svc.configure_replicas(n)
        return _applied({"replicas": n},
                        rollback=lambda: svc.configure_replicas(n - 1))
    return _skipped("no SLO target to widen and no replica headroom",
                    replica_cap=cap)


def act_raise_cleaner_budget(incident: dict) -> _ActionResult:
    """Spill-thrash trip: raise the Cleaner budget ×1.5 so the working
    set fits, bounded at ``H2O3TPU_OPS_CLEANER_CAP_FACTOR`` × the budget
    remediation first saw. At the ceiling, fall back to parking the
    coldest quota'd tenant's two least-recently-touched keys on disk
    (``Cleaner.force_spill`` — spilled behind stubs, never deleted).
    Rollback restores the previous budget."""
    cleaner = _cleaner()
    budget = cleaner.budget
    if budget is None:
        return _skipped("cleaner disabled (no budget to raise)")
    with _CLEANER_BASE_LOCK:
        base = _CLEANER_BASE.setdefault(id(cleaner), int(budget))
    cap = int(base * cleaner_cap_factor_from_env())
    new_budget = min(int(budget * 1.5), cap)
    if new_budget > budget:
        def rollback(c=cleaner, prev=int(budget)):
            c.budget = prev
        cleaner.budget = new_budget
        return _applied({"budget_bytes": new_budget,
                         "previous_bytes": int(budget),
                         "cap_bytes": cap}, rollback=rollback)
    quotas = _quotas()
    tenant = quotas.coldest_tenant()
    if tenant is not None:
        keys = sorted(quotas.keys_of(tenant),
                      key=cleaner.last_touched)
        spilled = cleaner.force_spill(keys, limit=2)
        if spilled:
            return _applied({"budget_at_cap_bytes": cap,
                             "evicted_tenant": tenant,
                             "spilled_keys": spilled})
    return _skipped("budget at ceiling and no cold tenant keys to park",
                    cap_bytes=cap)


def act_reassign_shards(incident: dict) -> _ActionResult:
    """Heartbeat-gap trip: preemptively move the silent worker's data
    shards to live peers NOW (``ElasticGroup.preempt_reassign``) instead
    of waiting for the round-boundary sweep — bounded to the ONE worst
    worker per action. Rollback re-admits the worker at the next round
    boundary (``request_join``)."""
    worst = None     # (gap_ms, group, wid)
    for g in _live_groups():
        for row in g.rows():
            if row["state"] in ("ACTIVE", "SUSPECT"):
                gap = row["last_heartbeat_ago_ms"]
                if worst is None or gap > worst[0]:
                    worst = (gap, g, row["worker"])
    if worst is None:
        return _skipped("no live elastic workers to inspect")
    gap_ms, group, wid = worst
    moved = group.preempt_reassign(wid)

    def rollback(g=group, w=wid):
        g.request_join(w)
    return _applied({"group": group.group_id, "worker": wid,
                     "heartbeat_gap_ms": gap_ms, "moved_shards": moved},
                    rollback=rollback)


def act_pin_bucket(incident: dict) -> _ActionResult:
    """Recompile-storm trip: pin the scorer cache's bucket floor at the
    largest bucket already compiled, collapsing churning small signatures
    onto one warm executable (``ScorerCache.pin_bucket`` — padding waste
    bounded by the pin). Rollback unpins."""
    cache = _scorer_cache()
    if cache is None:
        return _skipped("serving tier not loaded")
    if cache.pinned_bucket() is not None:
        return _skipped("bucket already pinned",
                        pinned_bucket=cache.pinned_bucket())
    buckets = cache.compiled_buckets()
    if not buckets:
        return _skipped("no compiled serving signatures to pin")
    pinned = cache.pin_bucket(max(buckets))
    return _applied({"pinned_bucket": pinned,
                     "compiled_buckets": buckets},
                    rollback=cache.unpin_bucket)


#: rule-facing registry — the policy map (remediate.py) names these
CATALOG: dict = {
    "serving_relief": act_serving_relief,
    "raise_cleaner_budget": act_raise_cleaner_budget,
    "reassign_shards": act_reassign_shards,
    "pin_bucket": act_pin_bucket,
}


class ActionLog:
    """Append-only audit trail of remediation actions — THE gateway every
    policy mutation flows through. One record per
    decision: action class, trigger rule + incident id, parameters,
    outcome, and a rollback token when the action is reversible."""

    def __init__(self, capacity: int = LOG_CAPACITY):
        self._lock = lockwitness.lock("ops_plane.actions.ActionLog._lock")
        self._capacity = capacity
        self._records: list[dict] = []
        self._rollbacks: dict[str, object] = {}   # action id -> thunk

    def record(self, action: str, rule: str, incident_id: str | None,
               mode: str) -> dict:
        """Decide-and-audit one action. ``observe`` mode appends the
        record with outcome ``observed`` and EXECUTES NOTHING; ``act``
        mode runs the catalog function and stamps what happened. The
        record is returned (and appended) in every case — including
        ``failed`` — because an audit trail with holes is not one."""
        fn = CATALOG.get(action)
        aid = f"act_{uuid.uuid4().hex[:10]}"
        rec = {"id": aid, "action": action, "rule": rule,
               "incident_id": incident_id, "mode": mode,
               "at_ms": int(time.time() * 1000),
               "params": {}, "outcome": None, "rollback_token": None}
        if fn is None:
            rec["outcome"] = "failed"
            rec["params"] = {"error": f"unknown action {action!r}"}
        elif mode != "act":
            rec["outcome"] = "observed"
        else:
            try:
                result = fn({"id": incident_id, "rule": rule})
                rec["outcome"] = result.outcome
                rec["params"] = result.params
                if result.rollback is not None:
                    rec["rollback_token"] = aid
            except Exception as e:   # noqa: BLE001 — a failed action is a
                # record, not a crash of the incident path that fired it
                rec["outcome"] = "failed"
                rec["params"] = {"error": f"{type(e).__name__}: {e}"}
                result = None
        with self._lock:
            self._records.append(rec)
            del self._records[:-self._capacity]
            if rec["rollback_token"] is not None:
                self._rollbacks[aid] = result.rollback
        ACTIONS_TOTAL.labels(rule=rule, action=action,
                             outcome=rec["outcome"]).inc()
        return dict(rec)

    def rollback(self, action_id: str) -> bool:
        """Undo a recorded action by its rollback token; the rollback is
        itself appended to the trail. False when the token is unknown or
        already consumed."""
        with self._lock:
            thunk = self._rollbacks.pop(action_id, None)
            src = next((r for r in self._records
                        if r["id"] == action_id), None)
        if thunk is None:
            return False
        rec = {"id": f"act_{uuid.uuid4().hex[:10]}", "action": "rollback",
               "rule": src["rule"] if src else None,
               "incident_id": src["incident_id"] if src else None,
               "mode": "act", "at_ms": int(time.time() * 1000),
               "params": {"rolls_back": action_id}, "outcome": None,
               "rollback_token": None}
        try:
            thunk()
            rec["outcome"] = "applied"
        except Exception as e:   # noqa: BLE001 — audit the failure too
            rec["outcome"] = "failed"
            rec["params"]["error"] = f"{type(e).__name__}: {e}"
        with self._lock:
            self._records.append(rec)
            del self._records[:-self._capacity]
        ACTIONS_TOTAL.labels(rule=rec["rule"] or "unknown",
                             action="rollback",
                             outcome=rec["outcome"]).inc()
        return rec["outcome"] == "applied"

    # -- views ---------------------------------------------------------------

    def list(self) -> list[dict]:
        """All records, newest first (the ``GET /3/Ops`` action log)."""
        with self._lock:
            return [dict(r) for r in reversed(self._records)]

    def applied_total(self) -> int:
        with self._lock:
            return sum(1 for r in self._records
                       if r["outcome"] == "applied")

    def recorded_total(self) -> int:
        with self._lock:
            return len(self._records)

    def reset(self) -> None:
        """Drop the trail (tests/bench isolation only)."""
        with self._lock:
            self._records.clear()
            self._rollbacks.clear()


#: the process-wide audit trail (``GET /3/Ops`` → ``actions``)
ACTIONS = ActionLog()
