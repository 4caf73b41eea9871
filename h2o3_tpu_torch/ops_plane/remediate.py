"""RemediationEngine — incident rising edges → bounded audited actions.

The port of ``h2o3_tpu/ops_plane/remediate.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: the "self-managing runtime" half of the TensorFlow design
(PAPERS.md) scoped by H2O-3 conservatism — the engine may only take
actions from the fixed catalog (:mod:`h2o3_tpu_torch.ops_plane.actions`), one
per incident episode, cooldown-limited per rule, and only when the
operator turned the key:

``H2O3TPU_REMEDIATE`` (resolved at each incident, never at import —
read per call):

- ``off``      — the listener does nothing at all;
- ``observe``  — DEFAULT: every decision is recorded in the ActionLog
  with outcome ``observed``; no state is touched (log-what-I-would-do);
- ``act``      — the action executes; outcome/rollback are recorded and
  the ``action_id`` is stamped back into the trigger incident.

The policy map is deliberately small and static — four of the ten health
rules have a safe automatic response; the rest (leak growth, MFU
collapse, retry exhaustion…) page a human, on purpose. The subscription
uses :meth:`IncidentLog.add_listener` rising edges, so a repeating trip
(folded into the open incident) can never re-fire the action — one
episode, one action, until the incident resolves and re-opens.
"""

from __future__ import annotations

import os
import time

from h2o3_tpu_torch.ops_plane.actions import ACTIONS, ACTIONS_TOTAL
from h2o3_tpu_torch.utils import lockwitness

#: health rule -> action class (actions.CATALOG names the functions)
POLICY: dict = {
    "serving_shed_rate": "serving_relief",
    "serving_p99_slo": "serving_relief",
    "memory_spill_thrash": "raise_cleaner_budget",
    "elastic_heartbeat_gap": "reassign_shards",
    "compute_recompile_storm": "pin_bucket",
}

MODES = ("off", "observe", "act")


def remediate_mode() -> str:
    """The kill switch, resolved at call time. Unknown values read as
    ``observe`` — a typo in the knob must fail safe (log, touch
    nothing), not silently arm the engine."""
    mode = os.environ.get("H2O3TPU_REMEDIATE", "observe").strip().lower()
    return mode if mode in MODES else "observe"


def cooldown_secs_from_env(default: float = 60.0) -> float:
    """Per-rule action cooldown (``H2O3TPU_OPS_COOLDOWN_SECS``) — the
    rate limit between actions for the SAME rule."""
    try:
        return max(float(os.environ.get("H2O3TPU_OPS_COOLDOWN_SECS", "")
                         or default), 0.0)
    except ValueError:
        return default


class RemediationEngine:
    """The incident listener (singleton :data:`ENGINE`; tests build their
    own with a private ActionLog)."""

    def __init__(self, actions=None):
        self.actions = actions if actions is not None else ACTIONS
        self._lock = lockwitness.lock("ops_plane.remediate.RemediationEngine._lock")
        self._last_action: dict[str, float] = {}    # rule -> monotonic
        self._installed_on: list = []

    # -- subscription --------------------------------------------------------

    def install(self, incident_log=None) -> None:
        """Subscribe to ``incident_log`` rising edges (default: the
        process-wide ring). Idempotent — add_listener dedupes."""
        if incident_log is None:
            from h2o3_tpu_torch.utils.incidents import INCIDENTS
            incident_log = INCIDENTS
        incident_log.add_listener(self.on_incident)
        with self._lock:
            if incident_log not in self._installed_on:
                self._installed_on.append(incident_log)

    def uninstall(self) -> None:
        with self._lock:
            logs, self._installed_on = self._installed_on, []
        for log in logs:
            log.remove_listener(self.on_incident)

    # -- the decision --------------------------------------------------------

    def on_incident(self, record: dict, log) -> "dict | None":
        """One incident OPEN → at most one audited action. Returns the
        action record (or None: mode off, unmapped rule, or cooldown)."""
        mode = remediate_mode()
        if mode == "off":
            return None
        rule = record.get("rule")
        action = POLICY.get(rule)
        if action is None:
            return None       # this rule pages a human, by design
        now = time.monotonic()
        cooldown = cooldown_secs_from_env()
        with self._lock:
            last = self._last_action.get(rule)
            if last is not None and now - last < cooldown:
                # rate limit: metered but NOT appended — a storm of
                # re-opened incidents inside the cooldown must not fill
                # the audit ring with no-ops
                ACTIONS_TOTAL.labels(rule=rule, action=action,
                                     outcome="cooldown").inc()
                return None
            self._last_action[rule] = now
        rec = self.actions.record(action, rule, record.get("id"), mode)
        if mode == "act" and log is not None:
            log.annotate_action(record.get("id"), rec["id"])
        return rec

    # -- views ---------------------------------------------------------------

    def policy_view(self) -> dict:
        """The ``GET /3/Ops`` policy block: mode, map, bounds."""
        from h2o3_tpu_torch.ops_plane.actions import (cleaner_cap_factor_from_env,
                                                max_replicas_from_env)
        return {
            "mode": remediate_mode(),
            "cooldown_secs": cooldown_secs_from_env(),
            "policy": dict(POLICY),
            "bounds": {"max_replicas": max_replicas_from_env(),
                       "cleaner_cap_factor": cleaner_cap_factor_from_env(),
                       "reassign_workers_per_action": 1,
                       "spill_keys_per_action": 2},
        }

    def reset(self) -> None:
        """Forget cooldowns (tests/bench isolation only)."""
        with self._lock:
            self._last_action.clear()


#: the process-wide engine (installed by ``H2OServer.start``)
ENGINE = RemediationEngine()


def install(incident_log=None) -> None:
    """Module-level convenience: subscribe the process engine."""
    ENGINE.install(incident_log)
