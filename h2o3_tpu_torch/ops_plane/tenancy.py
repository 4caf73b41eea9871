"""Multi-tenant admission — per-tenant quotas over the meters we already have.

The port of ``h2o3_tpu/ops_plane/tenancy.py``: the same names, payload keys and
decisions; it imports nothing of the JAX package.

Reference: H2O-3's F/J priority ladder keeps one user's giant parse from
starving another's interactive scoring; "millions of users" (PAPER.md)
needs the same property across *tenants*. This module prices each tenant
by the three meters earlier PRs built —

- **device-seconds**: the scoring tier charges each request its pro-rata
  share of batch device wall (``serving/service.py``, queue wait
  excluded) into a rolling window;
- **bytes**: DKV puts tag their key with the putting tenant
  (``utils/registry.py``) and the ledger prices keys with the same
  ``MemoryMeter`` measure ``/3/Memory`` reports;
- **QPS**: a one-second sliding admission window.

Requests carry a tenant id (REST ``X-H2O3-Tenant`` header or ``tenant``
param; untagged callers are the ``default`` tenant). ``QuotaManager.
admit`` enforces configured budgets; over-quota work is refused with
:class:`QuotaExceeded` — the REST layer maps it to ``429 + Retry-After``,
never a silent drop. Tenants without a configured quota are admitted
unmetered-by-budget but still metered (usage shows in ``GET /3/Ops``).

Metric labels are bounded: only the default tenant and tenants with a
configured quota get their own label; everyone else folds into
``other`` (an open tenant namespace must not explode the registry).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import time

from h2o3_tpu_torch.utils import lockwitness
from h2o3_tpu_torch.utils import telemetry as _tm

DEFAULT_TENANT = "default"

_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "h2o3_tenant", default=DEFAULT_TENANT)

#: admissions by tenant and outcome (admitted / shed_qps /
#: shed_device_seconds / shed_bytes)
TENANT_REQUESTS = _tm.METRICS.counter(
    "h2o3_tenant_requests", "tenant admissions by outcome",
    ("tenant", "outcome"))

#: DKV bytes attributed to each tenant's tagged keys
TENANT_BYTES = _tm.METRICS.gauge(
    "h2o3_tenant_bytes", "DKV bytes owned by tenant", ("tenant",))

#: device-seconds charged to each tenant (scoring pro-rata batch wall)
TENANT_DEVICE_SECONDS = _tm.METRICS.counter(
    "h2o3_tenant_device_seconds", "device-seconds charged to tenant",
    ("tenant",))


def window_secs_from_env(default: float = 60.0) -> float:
    """Rolling window for the device-seconds budget
    (``H2O3TPU_TENANT_WINDOW_SECS``)."""
    try:
        return max(float(os.environ.get("H2O3TPU_TENANT_WINDOW_SECS", "")
                         or default), 1.0)
    except ValueError:
        return default


def sanitize_tenant(tenant) -> str:
    """Validate a caller-supplied tenant id (None/empty → the default
    tenant; anything outside ``[A-Za-z0-9._-]{1,64}`` raises — the REST
    layer maps that to 400, a hostile header must not mint labels)."""
    if tenant is None or tenant == "":
        return DEFAULT_TENANT
    tenant = str(tenant)
    if not _TENANT_RE.match(tenant):
        raise ValueError(f"invalid tenant id {tenant!r} "
                         "(allowed: [A-Za-z0-9._-]{1,64})")
    return tenant


def current_tenant() -> str:
    return _CURRENT.get()


@contextlib.contextmanager
def tenant_scope(tenant: str):
    """Bind the request's tenant for the current context (the REST
    dispatcher wraps each handler call; DKV puts and scoring charges made
    inside attribute to it)."""
    token = _CURRENT.set(sanitize_tenant(tenant))
    try:
        yield
    finally:
        _CURRENT.reset(token)


class QuotaExceeded(RuntimeError):
    """Admission refused under a tenant budget (HTTP 429 + Retry-After)."""

    def __init__(self, tenant: str, dimension: str, observed, budget,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"tenant {tenant!r} over {dimension} quota: "
            f"{observed} > {budget}; retry after {retry_after_s:.1f}s")
        self.tenant = tenant
        self.dimension = dimension
        self.observed = observed
        self.budget = budget
        self.retry_after_s = max(retry_after_s, 0.1)


class QuotaManager:
    """Per-tenant budgets + usage ledgers (singleton :data:`QUOTAS`)."""

    def __init__(self):
        self._lock = lockwitness.lock("ops_plane.tenancy.QuotaManager._lock")
        # tenant -> {"qps": float|None, "device_seconds": float|None,
        #            "bytes": int|None}
        self._quotas: dict[str, dict] = {}
        self._requests: dict[str, list] = {}        # admit timestamps (1s)
        self._device: dict[str, list] = {}          # (ts, secs) window
        self._device_total: dict[str, float] = {}   # lifetime
        self._key_owner: dict[str, str] = {}        # DKV key -> tenant
        self._shed: dict[str, dict] = {}            # tenant -> {dim: count}

    # -- label bounding ------------------------------------------------------

    def _label_locked(self, tenant: str) -> str:
        return tenant if tenant == DEFAULT_TENANT \
            or tenant in self._quotas else "other"

    # -- quota CRUD ----------------------------------------------------------

    def set_quota(self, tenant: str, qps=None, device_seconds=None,
                  bytes=None) -> dict:   # noqa: A002 — the REST param name
        """Install (replace) a tenant's budgets. ``None`` dimensions are
        unlimited. Returns the installed record."""
        tenant = sanitize_tenant(tenant)
        rec = {"qps": float(qps) if qps is not None else None,
               "device_seconds": (float(device_seconds)
                                  if device_seconds is not None else None),
               "bytes": int(bytes) if bytes is not None else None}
        with self._lock:
            self._quotas[tenant] = rec
        return {"tenant": tenant, **rec}

    def remove_quota(self, tenant: str) -> bool:
        with self._lock:
            return self._quotas.pop(sanitize_tenant(tenant), None) is not None

    def quotas(self) -> list[dict]:
        with self._lock:
            return [{"tenant": t, **q}
                    for t, q in sorted(self._quotas.items())]

    # -- admission -----------------------------------------------------------

    def admit(self, tenant: str | None = None) -> str:
        """Admit one request for ``tenant`` (default: the bound context
        tenant), charging the QPS window; raises :class:`QuotaExceeded`
        when any configured dimension is over budget. Returns the
        sanitized tenant id."""
        tenant = sanitize_tenant(tenant) if tenant is not None \
            else current_tenant()
        now = time.monotonic()
        window = window_secs_from_env()
        with self._lock:
            label = self._label_locked(tenant)
            quota = self._quotas.get(tenant) or {}
            reqs = self._requests.setdefault(tenant, [])
            del reqs[:self._expired(reqs, now - 1.0)]
            dev = self._device.setdefault(tenant, [])
            self._trim_device_locked(dev, now - window)
            try:
                budget = quota.get("qps")
                if budget is not None and len(reqs) >= budget:
                    retry = (reqs[0] + 1.0 - now) if reqs else 1.0
                    raise QuotaExceeded(tenant, "qps", len(reqs), budget,
                                        retry_after_s=retry)
                budget = quota.get("device_seconds")
                if budget is not None:
                    used = sum(s for _t, s in dev)
                    if used >= budget:
                        retry = (dev[0][0] + window - now) if dev else 1.0
                        raise QuotaExceeded(
                            tenant, "device_seconds", round(used, 4),
                            budget, retry_after_s=retry)
                budget = quota.get("bytes")
                if budget is not None:
                    used = self._bytes_locked(tenant)
                    if used >= budget:
                        raise QuotaExceeded(tenant, "bytes", used, budget,
                                            retry_after_s=5.0)
            except QuotaExceeded as e:
                shed = self._shed.setdefault(tenant, {})
                shed[e.dimension] = shed.get(e.dimension, 0) + 1
                TENANT_REQUESTS.labels(
                    tenant=label, outcome=f"shed_{e.dimension}").inc()
                raise
            reqs.append(now)
        TENANT_REQUESTS.labels(tenant=label, outcome="admitted").inc()
        return tenant

    @staticmethod
    def _expired(stamps: list, cutoff: float) -> int:
        i = 0
        while i < len(stamps) and stamps[i] < cutoff:
            i += 1
        return i

    @staticmethod
    def _trim_device_locked(dev: list, cutoff: float) -> None:
        i = 0
        while i < len(dev) and dev[i][0] < cutoff:
            i += 1
        del dev[:i]

    # -- charging ------------------------------------------------------------

    def charge_device_seconds(self, tenant: str, seconds: float) -> None:
        """Scoring charges each request's pro-rata device wall here
        (``serving/service.py`` after a successful score)."""
        if seconds <= 0:
            return
        now = time.monotonic()
        with self._lock:
            tenant = sanitize_tenant(tenant)
            self._device.setdefault(tenant, []).append((now, seconds))
            self._device_total[tenant] = \
                self._device_total.get(tenant, 0.0) + seconds
            label = self._label_locked(tenant)
        TENANT_DEVICE_SECONDS.labels(tenant=label).inc(seconds)

    # -- DKV tenant tagging (registry put/remove hooks) ----------------------

    def tag_key(self, key: str) -> None:
        with self._lock:
            self._key_owner[key] = current_tenant()

    def untag_key(self, key: str) -> None:
        with self._lock:
            self._key_owner.pop(key, None)

    def untag_all(self) -> None:
        with self._lock:
            self._key_owner.clear()

    def owner_of(self, key: str) -> str | None:
        with self._lock:
            return self._key_owner.get(key)

    def keys_of(self, tenant: str) -> list[str]:
        with self._lock:
            return [k for k, t in self._key_owner.items() if t == tenant]

    def _bytes_locked(self, tenant: str) -> int:
        from h2o3_tpu_torch.utils.memory import MEMORY
        # MEMORY.key_bytes takes the meter lock; the order
        # quotas→meter is one-way — the meter never calls back here
        return sum(MEMORY.key_bytes(k)
                   for k, t in self._key_owner.items() if t == tenant)

    # -- views ---------------------------------------------------------------

    def usage(self, tenant: str) -> dict:
        now = time.monotonic()
        window = window_secs_from_env()
        with self._lock:
            tenant = sanitize_tenant(tenant)
            reqs = self._requests.get(tenant, [])
            dev = self._device.get(tenant, [])
            self._trim_device_locked(dev, now - window)
            nbytes = self._bytes_locked(tenant)
            keys = sum(1 for t in self._key_owner.values() if t == tenant)
            label = self._label_locked(tenant)
            out = {
                "tenant": tenant,
                "qps_1s": len(reqs) - self._expired(reqs, now - 1.0),
                "device_seconds_window": round(sum(s for _t, s in dev), 4),
                "device_seconds_total": round(
                    self._device_total.get(tenant, 0.0), 4),
                "bytes": nbytes, "keys": keys,
                "quota": dict(self._quotas.get(tenant) or {}) or None,
                "shed": dict(self._shed.get(tenant, {})),
            }
        TENANT_BYTES.labels(tenant=label).set(nbytes)
        return out

    def usage_all(self) -> list[dict]:
        with self._lock:
            tenants = ({DEFAULT_TENANT} | set(self._quotas)
                       | set(self._key_owner.values())
                       | set(self._device_total) | set(self._requests))
        return [self.usage(t) for t in sorted(tenants)]

    def coldest_tenant(self) -> str | None:
        """The quota'd tenant holding the most bytes — the spill-thrash
        remediation's eviction candidate when the Cleaner budget is
        already at its ceiling. Never the default tenant (evicting the
        anonymous pool would punish everyone)."""
        with self._lock:
            candidates = [t for t in self._quotas if t != DEFAULT_TENANT]
            if not candidates:
                return None
            sized = [(self._bytes_locked(t), t) for t in candidates]
        sized.sort(reverse=True)
        return sized[0][1] if sized and sized[0][0] > 0 else None

    def reset(self) -> None:
        """Drop all quotas/ledgers (tests/bench isolation only)."""
        with self._lock:
            self._quotas.clear()
            self._requests.clear()
            self._device.clear()
            self._device_total.clear()
            self._key_owner.clear()
            self._shed.clear()


#: the process-wide quota manager (``GET/POST /3/Ops``)
QUOTAS = QuotaManager()
