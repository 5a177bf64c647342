"""Multi-tenant QoS: tenant identity, quotas, weighted-fair queueing,
priority tiers, and per-tenant accounting.

Heavy production traffic is not one FIFO queue: a single flooding caller
can fill the front door's in-flight gate, the bounded serving queues,
and every generation slot, starving everyone else — the PR-5 admission
control degrades *gracefully* but not *fairly*. This module adds the
tenant dimension the whole serving path threads through
(ROADMAP item 5; the production-serving posture of large-scale ML
systems, Abadi et al. arXiv:1605.08695 §9 — DL4J's ParallelInference
serving layer grown into a fair multi-tenant one):

- :class:`TenantPolicy` / :class:`TenantRegistry` — per-tenant weight,
  optional priority tier, and request-rate / token-rate quotas enforced
  by token buckets (the PR-5 ``RetryBudget`` pattern generalized to a
  continuous-refill bucket). Env/JSON-configurable via
  ``DL4J_TPU_TENANT_CONFIG`` (inline JSON or a file path); traffic with
  no tenant label rides the **default tenant** and behaves exactly as
  before.
- :class:`QuotaExceeded` — typed admission outcome (a
  :class:`~deeplearning4j_tpu_torch.resilience.policy.ShedError` subclass, so
  every existing error-accounting surface treats it as a lifecycle
  result, and the HTTP front door maps it to 429). It carries
  ``retry_after_s`` — the bucket's refill time — which the front door
  turns into a ``Retry-After`` header.
- :class:`FairQueue` — the drop-in replacement for the single-FIFO
  serving queues: deficit-weighted round-robin over per-tenant FIFOs
  (DRR: each visit grants ``quantum x weight`` deficit; a request pops
  when its cost fits), grouped by priority tier (a higher tier always
  pops first), with tenant-aware full-queue shedding
  (:meth:`FairQueue.pick_victim`: shed the most over-share tenant's
  newest request, never an under-share one).
- :class:`PreemptedError` — a typed shed outcome for step-boundary slot
  preemption in ``GenerationPipeline``: a higher-tier request may claim
  the slot of the most over-share tenant's longest-running lower-tier
  request; the preempted caller resolves typed, never hangs.
- Per-tenant accounting — ``dl4j_tenant_{requests,tokens,shed,
  cost_flops}_total{tenant}`` and a per-tenant latency histogram, all
  label-bounded through :func:`tenant_label` (configured tenants plus
  the first ``DL4J_TPU_TENANT_TOP_N`` unconfigured ones get their own
  series; the rest fold into one ``__other__`` overflow bucket, so an
  attacker spraying tenant ids cannot explode the registry).
  Request cost is the PR-6 cost model's FLOPs for the executed bucket
  (or prefill + per-slot decode-step share), attributed per tenant.

Kill switch ``DL4J_TPU_QOS=0`` (read live): the serving paths construct
their original FIFO queues, no tenant series are created, and the front
door skips quota admission — byte-identical pre-QoS behavior, asserted
in tests like the resilience/rollout switches. Pipeline-level QoS also
requires the resilience layer (``DL4J_TPU_RESILIENCE=1``): fair
scheduling sheds typed outcomes, which is resilience machinery.
"""
from __future__ import annotations

import json
import os
import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.policy import ShedError

#: the tenant every unlabeled request rides — its default policy is
#: unlimited, so pre-QoS callers see identical behavior
DEFAULT_TENANT = "default"

#: the bounded-cardinality overflow label for tenants beyond the top-N
OVERFLOW_TENANT = "__other__"


def qos_enabled() -> bool:
    """``DL4J_TPU_QOS`` kill switch (read live, like the resilience and
    rollout switches — flipping it affects new pipelines/requests
    without a restart)."""
    return os.environ.get("DL4J_TPU_QOS", "1") != "0"


def tenant_top_n() -> int:
    """``DL4J_TPU_TENANT_TOP_N``: how many *unconfigured* tenants get
    their own metric label before folding into ``__other__``."""
    try:
        return max(0, int(os.environ.get("DL4J_TPU_TENANT_TOP_N", 16)))
    except (TypeError, ValueError):
        return 16


class QuotaExceeded(ShedError):
    """The tenant is over its request-rate or token-rate quota — a typed
    admission outcome (HTTP 429 at the front door). ``retry_after_s`` is
    the quota bucket's refill time for one unit of work — the
    ``Retry-After`` header the front door derives."""

    def __init__(self, message: str, tenant: str = DEFAULT_TENANT,
                 quota: str = "request", retry_after_s: float = 1.0):
        super().__init__(message)
        self.tenant = tenant
        self.quota = quota
        self.retry_after_s = float(retry_after_s)


class PreemptedError(ShedError):
    """This request's generation slot was claimed by a higher-priority
    tenant at a decode step boundary — a typed lifecycle outcome; the
    caller may re-submit (its tokens so far are lost)."""


# ------------------------------------------------------------ token bucket
class TokenBucket:
    """Continuous-refill token bucket (the RetryBudget pattern with a
    rate): ``rate`` tokens/second refill up to ``burst``. Two admission
    styles: :meth:`try_acquire` (classic — spend-or-refuse, for
    request-rate quotas where the cost of one unit is known) and the
    debt model via :meth:`charge` + :meth:`in_debt` (for token quotas
    where a generation's cost is only known after it ran: admission
    requires a non-negative balance, usage is charged after the fact and
    may push the balance negative — the next admission waits out the
    debt)."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = max(1e-9, float(rate))
        self.burst = float(burst) if burst is not None else \
            max(1.0, self.rate)
        self._level = self.burst
        self._at = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float):
        self._level = min(self.burst,
                          self._level + (now - self._at) * self.rate)
        self._at = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked(time.monotonic())
            if self._level >= n:
                self._level -= n
                return True
            return False

    def charge(self, n: float):
        """Post-hoc usage charge; may drive the level negative (debt)."""
        with self._lock:
            self._refill_locked(time.monotonic())
            self._level -= float(n)

    def in_debt(self) -> bool:
        with self._lock:
            self._refill_locked(time.monotonic())
            return self._level < 0.0

    def level(self) -> float:
        with self._lock:
            self._refill_locked(time.monotonic())
            return self._level

    def time_to(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens are available (0 when they already
        are) — the Retry-After derivation."""
        with self._lock:
            self._refill_locked(time.monotonic())
            missing = n - self._level
        return max(0.0, missing / self.rate)


# ------------------------------------------------------------- policies
class TenantPolicy:
    """One tenant's QoS contract. ``None`` rates mean unlimited (the
    default tenant ships unlimited so unlabeled traffic is untouched).
    ``weight`` drives the deficit-weighted round-robin share;
    ``priority`` is the preemption tier (higher preempts lower; equal
    tiers never preempt — the default 0 everywhere disables it)."""

    __slots__ = ("name", "weight", "priority", "request_rate",
                 "request_burst", "token_rate", "token_burst")

    def __init__(self, name: str, weight: float = 1.0, priority: int = 0,
                 request_rate: Optional[float] = None,
                 request_burst: Optional[float] = None,
                 token_rate: Optional[float] = None,
                 token_burst: Optional[float] = None):
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0, "
                             f"got {weight}")
        for label, rate in (("request_rate", request_rate),
                            ("token_rate", token_rate)):
            if rate is not None and rate <= 0:
                # a falsy 0 would silently skip bucket creation and
                # mean UNLIMITED — the opposite of an operator's
                # "block this tenant" intent. Refuse loudly; blocking
                # is a tiny positive rate.
                raise ValueError(
                    f"tenant {name!r}: {label} must be > 0 or None "
                    f"(got {rate}); to effectively block a tenant use "
                    "a tiny rate like 0.001")
        self.name = str(name)
        self.weight = float(weight)
        self.priority = int(priority)
        self.request_rate = (float(request_rate)
                             if request_rate is not None else None)
        self.request_burst = (float(request_burst)
                              if request_burst is not None else None)
        self.token_rate = (float(token_rate)
                           if token_rate is not None else None)
        self.token_burst = (float(token_burst)
                            if token_burst is not None else None)

    @classmethod
    def from_dict(cls, name: str, doc: dict) -> "TenantPolicy":
        known = {"weight", "priority", "request_rate", "request_burst",
                 "token_rate", "token_burst"}
        alien = set(doc) - known
        if alien:
            raise ValueError(
                f"tenant {name!r}: unknown policy keys {sorted(alien)} "
                f"(known: {sorted(known)})")
        return cls(name, **doc)

    def to_dict(self) -> dict:
        return {"weight": self.weight, "priority": self.priority,
                "request_rate": self.request_rate,
                "request_burst": self.request_burst,
                "token_rate": self.token_rate,
                "token_burst": self.token_burst}


class _TenantState:
    """Runtime state per tenant: quota buckets + lifetime counters."""

    __slots__ = ("policy", "req_bucket", "tok_bucket", "requests",
                 "tokens", "shed", "cost_flops", "configured")

    def __init__(self, policy: TenantPolicy, configured: bool):
        self.policy = policy
        self.configured = configured
        self.req_bucket = (TokenBucket(policy.request_rate,
                                       policy.request_burst)
                           if policy.request_rate else None)
        self.tok_bucket = (TokenBucket(policy.token_rate,
                                       policy.token_burst)
                          if policy.token_rate else None)
        self.requests = 0
        self.tokens = 0.0
        self.shed = 0
        self.cost_flops = 0.0


class TenantRegistry:
    """The process-wide tenant policy + accounting store. One instance
    via :func:`global_tenants`; tests may construct their own (FairQueue
    takes the registry explicitly)."""

    def __init__(self, load_env: bool = True):
        self._lock = threading.Lock()
        self._states: Dict[str, _TenantState] = {}
        self._default_policy = TenantPolicy(DEFAULT_TENANT)
        self._labels: Dict[str, str] = {}   # tenant -> bounded label
        self._n_unconfigured = 0
        # bumped on configure(); FairQueue caches policy views against
        # it so the pop hot path pays one registry-lock hit per tenant
        # per config generation, not per pop
        self.version = 0
        if load_env:
            self._load_env()

    @staticmethod
    def _max_tracked() -> int:
        """Distinct UNCONFIGURED tenants that get their own state/label
        entry before folding into the shared overflow state — an
        id-spraying caller must not grow `_states`/`_labels` (and with
        them /debug/tenants and tenants.json) without bound."""
        return max(256, 8 * tenant_top_n())

    # --------------------------------------------------------- config
    def _load_env(self):
        raw = os.environ.get("DL4J_TPU_TENANT_CONFIG")
        if not raw:
            return
        text = raw
        if not raw.lstrip().startswith("{"):
            with open(raw, encoding="utf-8") as f:
                text = f.read()
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError("DL4J_TPU_TENANT_CONFIG must be a JSON "
                             "object {default?, tenants?}")
        self.configure(
            {name: TenantPolicy.from_dict(name, spec)
             for name, spec in (doc.get("tenants") or {}).items()},
            default=(TenantPolicy.from_dict(DEFAULT_TENANT, doc["default"])
                     if isinstance(doc.get("default"), dict) else None))

    def configure(self, policies: Dict[str, TenantPolicy],
                  default: Optional[TenantPolicy] = None):
        """(Re)install tenant policies. Existing tenants keep their
        lifetime counters but take fresh quota buckets (a live config
        push resets debt — operators expect a raised quota to admit
        immediately)."""
        with self._lock:
            if default is not None:
                self._default_policy = default
            for name, pol in policies.items():
                prev = self._states.get(name)
                st = _TenantState(pol, configured=True)
                if prev is not None:
                    st.requests, st.tokens = prev.requests, prev.tokens
                    st.shed, st.cost_flops = prev.shed, prev.cost_flops
                if prev is not None and not prev.configured:
                    self._n_unconfigured -= 1
                self._states[name] = st
                # a tenant first seen unconfigured may have folded into
                # the overflow label; configuring it grants its own
                self._labels.pop(name, None)
            self.version += 1

    # ------------------------------------------------------- identity
    @staticmethod
    def resolve(tenant) -> str:
        """Canonical tenant name for a request label (None/empty → the
        default tenant; whitespace trimmed; length-bounded so a header
        cannot smuggle megabytes into queues and snapshots)."""
        if tenant is None:
            return DEFAULT_TENANT
        name = str(tenant).strip()
        return name[:128] if name else DEFAULT_TENANT

    def _state(self, tenant: str) -> _TenantState:
        st = self._states.get(tenant)
        if st is None:
            name = tenant
            if (self._n_unconfigured >= self._max_tracked()
                    and tenant != DEFAULT_TENANT):
                # past the tracking cap every fresh unconfigured name
                # shares ONE overflow state (one bucket set, one row in
                # snapshots) — hostile id-spraying stays O(1)
                name = OVERFLOW_TENANT
                st = self._states.get(name)
                if st is not None:
                    return st
            st = self._states[name] = _TenantState(
                TenantPolicy(name,
                             weight=self._default_policy.weight,
                             priority=self._default_policy.priority,
                             request_rate=self._default_policy.request_rate,
                             request_burst=self._default_policy.request_burst,
                             token_rate=self._default_policy.token_rate,
                             token_burst=self._default_policy.token_burst),
                configured=False)
            self._n_unconfigured += 1
        return st

    def policy(self, tenant) -> TenantPolicy:
        with self._lock:
            return self._state(self.resolve(tenant)).policy

    def weight(self, tenant) -> float:
        return self.policy(tenant).weight

    def priority(self, tenant) -> int:
        return self.policy(tenant).priority

    # ------------------------------------------------------ admission
    def admit(self, tenant) -> str:
        """Quota gate for one arriving request: spends a request-rate
        token and requires the token-rate bucket to be out of debt.
        Raises :class:`QuotaExceeded` (counted per tenant) when either
        quota refuses; returns the resolved tenant name otherwise."""
        name = self.resolve(tenant)
        with self._lock:
            st = self._state(name)
            req_bucket, tok_bucket = st.req_bucket, st.tok_bucket
        # token-debt first: it consumes nothing, so a tenant waiting
        # out its debt doesn't ALSO drain its request-rate bucket on
        # every (correctly paced) retry and stay throttled past what
        # either quota implies
        if tok_bucket is not None and tok_bucket.in_debt():
            retry = tok_bucket.time_to(0.0)
            self.count_shed(name, "quota")
            raise QuotaExceeded(
                f"tenant {name!r} over its token-rate quota "
                f"({st.policy.token_rate} tokens/s); retry in "
                f"{retry:.3f}s", tenant=name, quota="token",
                retry_after_s=retry)
        if req_bucket is not None and not req_bucket.try_acquire():
            retry = req_bucket.time_to(1.0)
            self.count_shed(name, "quota")
            raise QuotaExceeded(
                f"tenant {name!r} over its request-rate quota "
                f"({st.policy.request_rate}/s); retry in {retry:.3f}s",
                tenant=name, quota="request", retry_after_s=retry)
        return name

    def over_quota(self, tenant) -> bool:
        """Is the tenant currently past either quota? (The tenant-aware
        shed-victim tie-breaker: prefer shedding someone already over
        their contract.)"""
        with self._lock:
            st = self._states.get(self.resolve(tenant))
        if st is None:
            return False
        if st.req_bucket is not None and st.req_bucket.level() < 1.0:
            return True
        return st.tok_bucket is not None and st.tok_bucket.in_debt()

    # ----------------------------------------------------- accounting
    def observe_request(self, tenant, latency_s: float,
                        error: Optional[BaseException] = None):
        """One resolved request's per-tenant accounting (success, typed
        shed, and error paths all share it)."""
        name = self.resolve(tenant)
        with self._lock:
            self._state(name).requests += 1
        label = self.tenant_label(name)
        _tenant_requests(label).inc()
        _tenant_latency(label).observe(max(0.0, float(latency_s)))

    def account_tokens(self, tenant, n: float):
        """Charge ``n`` tokens of usage (emitted generation tokens, or
        scored examples on the classify path) against the tenant's token
        bucket (debt model) and the per-tenant counter."""
        if n <= 0:
            return
        name = self.resolve(tenant)
        with self._lock:
            st = self._state(name)
            st.tokens += float(n)
            bucket = st.tok_bucket
        if bucket is not None:
            bucket.charge(n)
        _tenant_tokens(self.tenant_label(name)).inc(float(n))

    def account_cost(self, tenant, flops: float):
        """Attribute ``flops`` of accounted device work (the PR-6 cost
        model's bucket/prefill/decode FLOPs) to the tenant."""
        if not flops or flops <= 0:
            return
        name = self.resolve(tenant)
        with self._lock:
            self._state(name).cost_flops += float(flops)
        _tenant_cost(self.tenant_label(name)).inc(float(flops))

    def count_shed(self, tenant, reason: str):
        name = self.resolve(tenant)
        with self._lock:
            self._state(name).shed += 1
        _tenant_shed(self.tenant_label(name), reason).inc()
        _faults.record_event("tenant_shed", tenant=name, reason=reason)

    # --------------------------------------------------------- labels
    def tenant_label(self, tenant) -> str:
        """THE bounded-cardinality label mapper every ``{tenant}`` metric
        series routes through (lint-enforced by check_metric_names):
        configured tenants always get their own label; the first
        ``DL4J_TPU_TENANT_TOP_N`` *unconfigured* tenants do too; every
        further distinct name folds into ``__other__``."""
        name = self.resolve(tenant)
        with self._lock:
            label = self._labels.get(name)
            if label is not None:
                return label
            st = self._states.get(name)
            if (st is not None and st.configured) or name == DEFAULT_TENANT:
                label = name
            elif len(self._labels) >= self._max_tracked():
                # the label CACHE is bounded too: past the cap the
                # answer is always the overflow bucket — return it
                # without remembering yet another sprayed name
                return OVERFLOW_TENANT
            else:
                distinct = sum(1 for t, lb in self._labels.items()
                               if lb == t and not (
                                   t in self._states
                                   and self._states[t].configured)
                               and t != DEFAULT_TENANT)
                label = name if distinct < tenant_top_n() else \
                    OVERFLOW_TENANT
            self._labels[name] = label
            return label

    # ------------------------------------------------------- queries
    def snapshot(self) -> dict:
        """``/debug/tenants`` + the flight recorder's ``tenants.json``:
        policies, live bucket levels, and lifetime per-tenant counters."""
        with self._lock:
            states = dict(self._states)
            default = self._default_policy
            labels = dict(self._labels)
        tenants = {}
        for name, st in sorted(states.items()):
            tenants[name] = {
                "policy": st.policy.to_dict(),
                "configured": st.configured,
                "label": labels.get(name, name),
                "requests": st.requests,
                "tokens": st.tokens,
                "shed": st.shed,
                "cost_flops": st.cost_flops,
                "request_bucket_level": (st.req_bucket.level()
                                         if st.req_bucket else None),
                "token_bucket_level": (st.tok_bucket.level()
                                       if st.tok_bucket else None),
                "over_quota": (
                    (st.req_bucket is not None
                     and st.req_bucket.level() < 1.0)
                    or (st.tok_bucket is not None
                        and st.tok_bucket.in_debt())),
            }
        return {
            "enabled": qos_enabled(),
            "default_policy": default.to_dict(),
            "top_n": tenant_top_n(),
            "overflow_label": OVERFLOW_TENANT,
            "tenants": tenants,
        }


# ---------------------------------------------------------- fair queue
class FairQueue:
    """Deficit-weighted round-robin queue over per-tenant FIFOs — the
    drop-in replacement for the serving queues' ``queue.Queue`` subset
    (``put_nowait`` / ``get(timeout)`` / ``get_nowait`` / ``qsize`` /
    ``maxsize``, stdlib ``queue.Full``/``queue.Empty`` semantics).

    Pop order: the highest priority *tier* with queued work always pops
    first; within a tier, classic DRR — visiting a tenant grants
    ``quantum x weight`` deficit and its head request pops when its
    ``cost_fn`` fits the deficit (cost = examples for inference, 1 slot
    for generation), so a backlogged heavy tenant cannot starve a light
    one and long-run service converges to the weight ratio.

    :meth:`pick_victim` implements tenant-aware full-queue shedding:
    the victim is the most over-share tenant's NEWEST request (an
    under-share tenant is never chosen; a tenant past its rate quota is
    preferred over one merely over its queue share). ``None`` means the
    *arriving* tenant is itself the most over-share — the caller sheds
    the arrival instead."""

    QUANTUM = 1.0

    def __init__(self, maxsize: int, tenants: "TenantRegistry",
                 cost_fn=None):
        self.maxsize = max(1, int(maxsize))
        self._tenants = tenants
        self._cost = cost_fn or (lambda req: 1.0)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {}
        self._order: List[str] = []        # arrival order of active tenants
        self._deficit: Dict[str, float] = {}
        self._tcost: Dict[str, float] = {}  # running queued-cost totals
        # DRR visit state: the tenant currently being served and whether
        # it already received this visit's quantum (a tenant keeps
        # popping while its deficit lasts — that is where the weight
        # ratio comes from; granting per pop would collapse to 1:1)
        self._cur: Optional[str] = None
        self._cur_granted = False
        self._size = 0
        # (priority, weight) views cached against the registry's config
        # version: the pop hot path would otherwise take the registry
        # lock O(active tenants) times per pop
        self._pv_cache: Dict[str, tuple] = {}
        self._pv_version = -1

    def _pview(self, tenant: str) -> tuple:
        v = self._tenants.version
        if v != self._pv_version:
            self._pv_cache.clear()
            self._pv_version = v
        view = self._pv_cache.get(tenant)
        if view is None:
            pol = self._tenants.policy(tenant)
            view = self._pv_cache[tenant] = (pol.priority, pol.weight)
        return view

    def qsize(self) -> int:
        with self._lock:
            return self._size

    def tenant_sizes(self) -> Dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}

    def _tenant_of(self, req) -> str:
        return getattr(req, "tenant", None) or DEFAULT_TENANT

    def _rcost(self, req) -> float:
        return max(1e-9, float(self._cost(req)))

    def _remove_cost(self, t: str, cost: float):
        """Bookkeeping after removing one request of ``t``: running
        cost totals stay consistent, and a tenant whose queue emptied
        is dropped from EVERY per-tenant dict (queues, deficit, order,
        cost, policy view) — an id-spraying caller must not grow the
        queue's internals without bound either."""
        left = self._tcost.get(t, 0.0) - cost
        self._tcost[t] = left
        self._size -= 1
        if not self._queues.get(t):
            self._queues.pop(t, None)
            self._deficit.pop(t, None)
            self._tcost.pop(t, None)
            self._pv_cache.pop(t, None)
            if t in self._order:
                self._order.remove(t)
            if self._cur == t:
                self._cur = None

    def put_nowait(self, req):
        with self._not_empty:
            if self._size >= self.maxsize:
                raise _queue.Full
            t = self._tenant_of(req)
            q = self._queues.get(t)
            if q is None:
                q = self._queues[t] = deque()
            if not q:
                if t not in self._order:
                    self._order.append(t)
                self._deficit.setdefault(t, 0.0)
            q.append(req)
            self._tcost[t] = self._tcost.get(t, 0.0) + self._rcost(req)
            self._size += 1
            self._not_empty.notify()

    # ---------------------------------------------------------- pops
    def _pop_locked(self):
        """One DRR pop (caller holds the lock; queue known non-empty).
        Highest-priority tier first; within it, the visit pointer STAYS
        on a tenant while its deficit covers the next head's cost (one
        quantum x weight granted per visit, not per pop — that is where
        the weight ratio comes from). Moving past every tenant grants
        each another quantum, so a pop happens in bounded cycles."""
        active = [t for t in self._order if self._queues.get(t)]
        if not active:
            return None
        top = max(self._pview(t)[0] for t in active)
        tier = [t for t in active
                if self._pview(t)[0] == top]
        if self._cur not in tier:
            self._cur = None
            self._cur_granted = False
        idx = tier.index(self._cur) if self._cur is not None else 0
        scanned = 0
        while True:
            t = tier[idx % len(tier)]
            if t != self._cur:
                self._cur = t
                self._cur_granted = False
            if not self._cur_granted:
                self._deficit[t] = self._deficit.get(t, 0.0) \
                    + self.QUANTUM * self._pview(t)[1]
                self._cur_granted = True
            q = self._queues[t]
            cost = max(1e-9, float(self._cost(q[0])))
            if self._deficit[t] >= cost:
                req = q.popleft()
                if q:
                    self._deficit[t] -= cost
                else:
                    # DRR: an emptied tenant forfeits its deficit
                    # (saved-up credit must not burst later)
                    self._deficit[t] = 0.0
                self._remove_cost(t, cost)
                return req
            # can't afford the head: this visit is over — ending it
            # matters even when the tenant re-arrives immediately (a
            # single-tenant queue whose head costs more than one
            # quantum x weight must keep accruing on each new visit,
            # or this scan would spin forever)
            self._cur = None
            idx += 1
            scanned += 1
            if scanned >= len(tier):
                # a full wrap popped nothing: bulk-grant the minimum
                # number of further quanta that lets SOME tenant afford
                # its head — O(tenants), instead of spinning one
                # quantum per wrap under the lock when a head's cost is
                # many times quantum x weight (e.g. a 512-example
                # request from a low-weight tenant)
                scanned = 0
                need = None
                for t2 in tier:
                    c2 = max(1e-9, float(self._cost(self._queues[t2][0])))
                    w2 = max(1e-9, self.QUANTUM * self._pview(t2)[1])
                    k2 = (c2 - self._deficit.get(t2, 0.0)) / w2
                    if need is None or k2 < need:
                        need = k2
                grants = max(0, int(need))
                if grants:
                    for t2 in tier:
                        self._deficit[t2] = self._deficit.get(t2, 0.0) \
                            + grants * self.QUANTUM * self._pview(t2)[1]

    def get_nowait(self):
        with self._not_empty:
            if self._size == 0:
                raise _queue.Empty
            return self._pop_locked()

    def get(self, timeout: Optional[float] = None):
        with self._not_empty:
            if timeout is None:
                while self._size == 0:
                    self._not_empty.wait()
            else:
                end = time.monotonic() + max(0.0, timeout)
                while self._size == 0:
                    rem = end - time.monotonic()
                    if rem <= 0:
                        raise _queue.Empty
                    self._not_empty.wait(timeout=rem)
            return self._pop_locked()

    def peek_priority(self) -> Optional[int]:
        """Highest priority tier with queued work (None when empty) —
        the generation pipeline's preemption trigger."""
        with self._lock:
            active = [t for t in self._order if self._queues.get(t)]
            if not active:
                return None
            return max(self._pview(t)[0] for t in active)

    # ------------------------------------------------------- shedding
    def pick_victim(self, arriving_req):
        """Remove and return the queued request to shed when the queue
        is full and ``arriving_req`` wants in (see class doc). The
        arriving request is weighed as if queued, so a flooding arrival
        correctly identifies ITSELF as the victim (→ ``None``)."""
        arr_t = self._tenant_of(arriving_req)
        arr_cost = self._rcost(arriving_req)
        with self._lock:
            ratios = self._ratios_locked(arr_t, arr_cost)
            # ONLY over-share tenants are eligible victims — the quota
            # state is a tie-break AMONG them, never the primary key (a
            # quota-limited but under-share tenant must not mask the
            # actual flooder and get the innocent arrival shed)
            over_share = [t for t in ratios if ratios[t] > 1.0]
            if not over_share:
                return None
            victim_t = max(sorted(over_share), key=lambda t: (
                1 if self._tenants.over_quota(t) else 0, ratios[t]))
            if victim_t == arr_t:
                # the arrival's own tenant is the chosen victim: shed
                # the arrival (the caller's decision how)
                return None
            q = self._queues[victim_t]
            req = q.pop()                  # newest of the over-share flow
            self._remove_cost(victim_t, self._rcost(req))
            return req

    def _ratios_locked(self, arr_t: str,
                       arr_cost: float) -> Dict[str, float]:
        """Per-tenant queued-cost / weight-fair-share ratios, with the
        arrival weighed as if queued — from the RUNNING totals, so a
        full-queue arrival storm pays O(tenants), never O(queued
        requests)."""
        costs = {t: c for t, c in self._tcost.items()
                 if self._queues.get(t)}
        if arr_t:
            costs[arr_t] = costs.get(arr_t, 0.0) + arr_cost
        total = sum(costs.values())
        weights = {t: self._pview(t)[1] for t in costs}
        wsum = sum(weights.values()) or 1.0
        return {t: costs[t] / max(total * weights[t] / wsum, 1e-9)
                for t in costs}

    def pop_oldest_of(self, tenant) -> Optional[object]:
        """Remove and return ``tenant``'s OLDEST queued request (None
        when it has none) — the tenant-scoped generalization of the
        ``reject_oldest`` policy for when the arrival's own tenant is
        the shed victim: its stale head gives way to the fresh arrival
        instead of the arrival bouncing off its own backlog."""
        name = self.resolve_name(tenant)
        with self._lock:
            q = self._queues.get(name)
            if not q:
                return None
            req = q.popleft()
            self._remove_cost(name, self._rcost(req))
            return req

    def pop_global_oldest(self) -> Optional[object]:
        """Remove and return the most-backlogged tenant's oldest
        request (ties broken by the oldest head) — the last-resort
        ``reject_oldest`` fallback when nobody is strictly over-share
        and the arrival has no backlog of its own (e.g. a brand-new
        tenant arriving at a queue where every tenant sits exactly at
        its fair share): pre-QoS reject_oldest always admitted the
        fresh arrival, and the most underserved newcomer must not be
        the one request that bounces."""
        with self._lock:
            if self._size == 0:
                return None
            ratios = self._ratios_locked("", 0.0)

            def age(t):
                head = self._queues[t][0]
                return -float(getattr(head, "t_enqueue_us", 0.0) or 0.0)

            victim_t = max(sorted(ratios),
                           key=lambda t: (ratios[t], age(t)))
            q = self._queues[victim_t]
            req = q.popleft()
            self._remove_cost(victim_t, self._rcost(req))
            return req

    @staticmethod
    def resolve_name(tenant) -> str:
        return tenant if tenant else DEFAULT_TENANT


# ------------------------------------------------------ metric handles
def _tenant_requests(label: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_tenant_requests_total",
            "requests resolved per tenant (success, typed shed, or "
            "error; label bounded via the top-N tenant_label helper)",
            label_names=("tenant",)).labels(tenant=label)
    return _faults.cached_metric_handle(("tenant_req", label), make)


def _tenant_tokens(label: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_tenant_tokens_total",
            "usage tokens charged per tenant (emitted generation tokens "
            "+ scored classify examples)",
            label_names=("tenant",)).labels(tenant=label)
    return _faults.cached_metric_handle(("tenant_tok", label), make)


def _tenant_shed(label: str, reason: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_tenant_shed_total",
            "requests shed per tenant, by reason (quota = admission "
            "refusal, queue_full/deadline/preempted = in-pipeline)",
            label_names=("tenant", "reason")).labels(
                tenant=label, reason=reason)
    return _faults.cached_metric_handle(("tenant_shed", label, reason),
                                        make)


def _tenant_cost(label: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_tenant_cost_flops_total",
            "accounted device work per tenant: the cost model's FLOPs "
            "for each executed bucket / prefill / decode-step share",
            label_names=("tenant",)).labels(tenant=label)
    return _faults.cached_metric_handle(("tenant_cost", label), make)


def _tenant_latency(label: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().histogram(
            "dl4j_tenant_latency_seconds",
            "end-to-end request latency per tenant (the per-tenant SLO "
            "rule's read surface; worst tenant grades /health)",
            label_names=("tenant",)).labels(tenant=label)
    return _faults.cached_metric_handle(("tenant_lat", label), make)


# ------------------------------------------------------ process wiring
_global_tenants: Optional[TenantRegistry] = None
_tenants_lock = threading.Lock()


def global_tenants() -> TenantRegistry:
    """THE process-wide tenant registry (front door, pipelines, and
    /debug/tenants all consult it)."""
    global _global_tenants
    if _global_tenants is None:
        with _tenants_lock:
            if _global_tenants is None:
                _global_tenants = TenantRegistry()
    return _global_tenants


def reset_global_tenants() -> TenantRegistry:
    global _global_tenants
    with _tenants_lock:
        _global_tenants = TenantRegistry()
    return _global_tenants


def snapshot() -> dict:
    """``tenants.json`` / ``/debug/tenants`` payload — never constructs
    the registry structure beyond what traffic already created."""
    return global_tenants().snapshot()
