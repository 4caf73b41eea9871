"""Ops plane — the layer that turns observability into behavior.

The port of ``h2o3_tpu/ops_plane/__init__.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: H2O-3's L1 substrate (PAPER.md) arbitrates resources with a
priority scheduler and a Cleaner; TensorFlow (PAPERS.md) is the template
for a runtime that self-manages placement and memory under load. Four
PRs of observability (metrics, traces, memory, compute, health) end at a
human; this package closes the loop:

- :mod:`h2o3_tpu_torch.ops_plane.remediate` — a policy engine subscribed to
  :class:`~h2o3_tpu_torch.utils.incidents.IncidentLog` rising edges, mapping
  each health-rule class to one bounded, cooldown-limited action.
- :mod:`h2o3_tpu_torch.ops_plane.actions` — the action catalog + the
  append-only :class:`~h2o3_tpu_torch.ops_plane.actions.ActionLog` every
  mutation of a live policy target flows through.
- :mod:`h2o3_tpu_torch.ops_plane.tenancy` — per-tenant admission quotas
  (device-seconds, bytes, QPS) so no one caller can starve the rest.

Everything is opt-in: nothing here imports at server start beyond the
subscription, the kill switch ``H2O3TPU_REMEDIATE=off|observe|act``
defaults to ``observe`` (log-what-I-would-do, touch nothing), and the
serving/DKV hot paths only consult tenancy when this package is already
loaded. docs/OPERATIONS.md is the operator-facing catalog.
"""

from h2o3_tpu_torch.ops_plane.actions import ACTIONS, ActionLog
from h2o3_tpu_torch.ops_plane.remediate import ENGINE, RemediationEngine, install
from h2o3_tpu_torch.ops_plane.tenancy import QUOTAS, QuotaExceeded, QuotaManager

__all__ = ["ACTIONS", "ActionLog", "ENGINE", "RemediationEngine",
           "install", "QUOTAS", "QuotaExceeded", "QuotaManager"]
