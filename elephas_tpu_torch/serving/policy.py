"""SLO-aware admission policies.

Counterpart of ``elephas_tpu/serving/policy.py``, host code that the port
keeps as its own copy (the same classes, defaults, orders, verdicts and
messages). Under a mixed multi-tenant load a FIFO queue lets one heavy
tenant, or one burst of long prompts, park everyone else's
time-to-first-token behind its own prefills, and nothing ever says "no".
A :class:`Policy` makes the admission order, and the right to enter the
queue at all, pluggable:

- :class:`FifoPolicy` — submission order, admit everything (the engine
  without a policy takes the same order and skips every hook).
- :class:`FairSharePolicy` — token-weighted fair queueing across tenants
  in the style of VTC ("Fairness in Serving Large Language Models", Sheng
  et al., OSDI 2024): each tenant carries a **virtual token counter**
  advanced by the tokens served for it (prefill and decode tokens at
  separate weights, over the tenant's share weight), and every admission
  attempt serves the backlogged tenant with the smallest counter. Within a
  tenant requests order **earliest-deadline-first** (tighter
  ``ttft_deadline_ms`` first, submission order inside a deadline class),
  and **aging** promotes any request that has waited ``aging_waves``
  admission waves to the front. ``max_queue_tokens`` adds overload
  **admission control**: the queue token budget divides across tenants by
  weight, and a submit that would push its own tenant's outstanding token
  debt past its share is rejected (:class:`AdmissionRejected`, with a
  deterministic Retry-After hint).

No wall clock enters an ordering decision: deadlines order by their
declared millisecond budgets (a deadline class), ages count admission
waves, and the counters advance by token counts. Wall-clock TTFT meets the
deadline only in the engine's SLO counters.
"""

from __future__ import annotations

import math
from collections import deque

#: Label every tenant-less request accounts under. Declaring a tenant
#: literally named "default" simply merges with it.
DEFAULT_TENANT = "default"


class AdmissionRejected(RuntimeError):
    """A submit refused by the policy's overload admission control.

    ``retry_after_s`` is the policy's deterministic backoff hint — the
    gateway surfaces it as a ``Retry-After`` header on the 429."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class Verdict:
    """One admission-control decision for one submit."""

    __slots__ = ("admitted", "retry_after_s", "reason")

    def __init__(self, admitted: bool, retry_after_s: float = 0.0,
                 reason: str = ""):
        self.admitted = bool(admitted)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


ADMIT = Verdict(True)


def normalize_tenants(tenants) -> dict:
    """``{name: weight}`` from a dict, an iterable of names (weight
    1.0 each), or None (no declared tenants). Loud on bad weights."""
    if tenants is None:
        return {}
    if isinstance(tenants, dict):
        out = {str(k): float(v) for k, v in tenants.items()}
    else:
        out = {str(t): 1.0 for t in tenants}
    for name, w in out.items():
        if not w > 0:
            raise ValueError(
                f"tenant {name!r} has non-positive weight {w} — a "
                f"zero/negative share can never be scheduled fairly"
            )
    return out


class Policy:
    """Admission-policy interface the scheduler and engine drive.

    Hooks, in request-lifecycle order:

    - :meth:`admission_verdict` — at ``submit()``, before the request
      joins the queue; a non-admitted verdict rejects it loudly.
    - :meth:`on_submit` — the request joined the waiting queue.
    - :meth:`begin_wave` / :meth:`reorder` — each admission wave ticks
      the logical age clock once, then the scheduler asks for the
      queue order before every single admission attempt (so the order
      can react to the charges of admissions earlier in the same wave).
    - :meth:`on_admit` — the request leased its slot (``resumed`` when
      it is a preemption resume, which must not re-charge prefill).
    - :meth:`on_token` — one generated token emitted.
    - :meth:`on_finish` — the request left the engine (done or failed).
    - :meth:`priority_of` — the preemption-effective priority; paged
      preemption compares THESE, so a policy can let deadline traffic
      outrank best-effort without callers touching ``submit(priority=)``.

    Subclasses override what they need; the base is a valid no-op
    policy that admits everything in submission order."""

    #: submit(ttft_deadline_ms=) is refused unless the engine's policy
    #: actually reads deadlines — a deadline nobody schedules by is a
    #: silent lie to the caller.
    reads_deadlines = False

    def __init__(self, tenants=None):
        self.tenants = normalize_tenants(tenants)

    # -- identity ------------------------------------------------------

    @property
    def tenant_names(self) -> tuple:
        """Every label value the engine should pre-register."""
        names = set(self.tenants) | {DEFAULT_TENANT}
        return tuple(sorted(names))

    def knows(self, tenant) -> bool:
        """Is ``tenant`` a legal label for this policy? ``None`` (the
        implicit default tenant) always is; a named tenant must be
        declared up front when any are."""
        if tenant is None or tenant == DEFAULT_TENANT:
            return True
        return tenant in self.tenants

    def resolve(self, tenant) -> str:
        return DEFAULT_TENANT if tenant is None else str(tenant)

    # -- lifecycle hooks (no-op defaults) ------------------------------

    def admission_verdict(self, req, queued_tokens: int,
                          tenant_queued_tokens: int = 0) -> Verdict:
        return ADMIT

    def on_submit(self, req) -> None:
        pass

    def begin_wave(self) -> None:
        pass

    def reorder(self, waiting: deque, pinned=()) -> None:
        pass

    def on_admit(self, req, resumed: bool = False) -> None:
        pass

    def on_preempt(self, req) -> None:
        pass

    def on_token(self, req) -> None:
        pass

    def on_finish(self, req) -> None:
        pass

    def priority_of(self, req) -> int:
        return req.priority

    def stats(self) -> dict:
        """Policy-internal state for ``engine.stats()['policy']``."""
        return {"name": type(self).__name__}

    def snapshot_counters(self) -> dict:
        """Per-tenant virtual-counter snapshot: the fairness state an
        admission verdict was decided against. Cheap and read-only —
        policies without counters return ``{}``."""
        return {}


class FifoPolicy(Policy):
    """Submission order, admit everything — the legacy behavior as an
    explicit policy object (useful as the control arm of an A/B, and
    for tenant-labeled accounting without fairness)."""


class FairSharePolicy(Policy):
    """VTC-style token-weighted fair share + deadline EDF + aging +
    overload admission control. See the module docstring for the
    scheduling story; knobs:

    - ``tenants``: ``{name: weight}`` (or iterable, weight 1.0). The
      implicit ``"default"`` tenant always exists at weight 1.0 unless
      declared otherwise.
    - ``prefill_weight`` / ``decode_weight``: virtual-counter cost per
      prompt/generated token (VTC uses 1/2 — decode tokens cost more
      service per token than prefill's batched FLOPs).
    - ``max_queue_tokens``: overload bound on the waiting queue's
      outstanding token debt (prompt + remaining budget, summed) —
      divided across tenants by WEIGHT SHARE, so each tenant sheds
      against its own slice of the queue budget and a hog's backlog
      can never crowd a light tenant out of admission (shedding falls
      on the tenant causing the debt). ``None`` disables admission
      control.
    - ``aging_waves``: admission waves a request may wait before it is
      promoted to the queue front regardless of its tenant's counter.
      Waves tick once per engine step (every ``begin_wave``), so this
      is a bound in SCHEDULING OPPORTUNITIES, not requests — size it
      in step counts. Too small and an unadmittable promoted request
      (e.g. a preempted heavy resume waiting for blocks) head-blocks
      urgent arrivals, re-creating in miniature the FIFO collapse the
      policy exists to prevent; the default is deliberately lazy —
      aging is the starvation BACKSTOP, not the scheduler.
    - ``deadline_boost``: preemption-priority bump for requests that
      carry a TTFT deadline and have not emitted their first token yet
      (composes with paged ``preemption=True``: deadline traffic may
      swap out best-effort work; once the first token lands, the TTFT
      is settled and the bump drops).
    - ``retry_after_s``: base Retry-After hint; the actual hint scales
      deterministically with how far past the bound the queue is.
    """

    reads_deadlines = True

    def __init__(self, tenants=None, *, prefill_weight: float = 1.0,
                 decode_weight: float = 2.0,
                 max_queue_tokens: int | None = None,
                 aging_waves: int = 256, deadline_boost: int = 1,
                 retry_after_s: float = 1.0):
        super().__init__(tenants)
        if prefill_weight < 0 or decode_weight < 0:
            raise ValueError(
                f"token weights must be non-negative, got prefill="
                f"{prefill_weight} decode={decode_weight}"
            )
        if max_queue_tokens is not None and int(max_queue_tokens) < 1:
            raise ValueError(
                f"max_queue_tokens={max_queue_tokens} < 1 would reject "
                f"every request — use None to disable admission control"
            )
        if aging_waves < 1:
            raise ValueError(f"aging_waves={aging_waves} < 1")
        if retry_after_s <= 0:
            raise ValueError(f"retry_after_s={retry_after_s} <= 0")
        self.prefill_weight = float(prefill_weight)
        self.decode_weight = float(decode_weight)
        self.max_queue_tokens = (
            None if max_queue_tokens is None else int(max_queue_tokens)
        )
        self.aging_waves = int(aging_waves)
        self.deadline_boost = int(deadline_boost)
        self.retry_after_s = float(retry_after_s)
        # virtual token counters: weighted service each tenant has
        # received; the wave serves the smallest. Monotone within a
        # tenant; lifted on arrival-after-idle so an idle tenant cannot
        # bank unbounded credit (the VTC lift).
        self._vtc: dict[str, float] = {}
        # outstanding (queued + active) requests per tenant — drives
        # the lift and the "backlogged" notion in the fairness bound
        self._outstanding: dict[str, int] = {}
        # logical age clock: wave index at first sight of each rid
        self._wave = 0
        self._seen: dict[int, int] = {}
        # report-only tallies for stats()
        self._rejected = 0

    def _weight(self, tenant: str) -> float:
        return self.tenants.get(tenant, 1.0)

    # -- admission control ---------------------------------------------

    def _share(self, tenant: str) -> float:
        """``tenant``'s slice of the queue token budget: its weight
        over the declared total (an undeclared/default tenant rides at
        weight 1.0 against the same denominator)."""
        total = sum(self.tenants.values()) or 1.0
        return self.max_queue_tokens * self._weight(tenant) / total

    def admission_verdict(self, req, queued_tokens: int,
                          tenant_queued_tokens: int = 0) -> Verdict:
        if self.max_queue_tokens is None:
            return ADMIT
        t = self.resolve(req.tenant)
        share = self._share(t)
        debt = (
            int(tenant_queued_tokens)
            + len(req.prompt) + req.max_new_tokens
        )
        if debt <= share:
            return ADMIT
        self._rejected += 1
        # deterministic backoff hint: scale the base by how many full
        # shares deep the tenant's debt would be — a queue 3 shares
        # deep needs roughly 3 drain windows, not 1
        hint = self.retry_after_s * math.ceil(debt / share)
        return Verdict(
            False, retry_after_s=hint,
            reason=(
                f"tenant {t!r} queue token debt {debt} would exceed "
                f"its admission bound {share:g} (weight share of "
                f"{self.max_queue_tokens})"
            ),
        )

    # -- lifecycle ------------------------------------------------------

    def on_submit(self, req) -> None:
        t = self.resolve(req.tenant)
        n = self._outstanding.get(t, 0)
        if n == 0:
            # VTC lift: a tenant returning from idle starts at the
            # floor of the currently-backlogged tenants' counters —
            # idle time earns no credit against active tenants
            busy = [
                self._vtc.get(u, 0.0)
                for u, c in self._outstanding.items() if c > 0
            ]
            if busy:
                self._vtc[t] = max(self._vtc.get(t, 0.0), min(busy))
        self._outstanding[t] = n + 1
        self._seen.setdefault(req.rid, self._wave)

    def begin_wave(self) -> None:
        self._wave += 1

    def _charge(self, tenant: str, cost: float) -> None:
        self._vtc[tenant] = (
            self._vtc.get(tenant, 0.0) + cost / self._weight(tenant)
        )

    def on_admit(self, req, resumed: bool = False) -> None:
        self._seen.pop(req.rid, None)
        if not resumed:
            self._charge(
                self.resolve(req.tenant),
                self.prefill_weight * len(req.prompt),
            )

    def on_preempt(self, req) -> None:
        # back in the queue: re-arm the aging clock so a preempted
        # request is bounded-wait like any other waiter (its tenant's
        # counter usually sorts it behind the traffic that preempted
        # it — aging is what guarantees it still resumes)
        self._seen.setdefault(req.rid, self._wave)

    def on_token(self, req) -> None:
        self._charge(self.resolve(req.tenant), self.decode_weight)

    def on_finish(self, req) -> None:
        t = self.resolve(req.tenant)
        n = self._outstanding.get(t, 0)
        if n > 0:
            self._outstanding[t] = n - 1
        self._seen.pop(req.rid, None)

    # -- ordering -------------------------------------------------------

    def _key(self, req):
        """Deterministic sort key: aged requests first (oldest
        arrival first — the starvation bound), then smallest tenant
        counter (fair share), then tightest declared deadline
        (deadline-class EDF), then submission order."""
        age = self._wave - self._seen.get(req.rid, self._wave)
        aged = age >= self.aging_waves
        dl = (
            req.ttft_deadline_ms
            if req.ttft_deadline_ms is not None else math.inf
        )
        return (
            0 if aged else 1,
            req.rid if aged else 0,
            self._vtc.get(self.resolve(req.tenant), 0.0),
            dl,
            req.rid,
        )

    def reorder(self, waiting: deque, pinned=()) -> None:
        """Rank EVERYONE by the fair-share key — including preempted
        requests awaiting resume (``pinned`` is deliberately ignored
        here). Resume-from-any-position is safe (the offloaded K/V
        waits on the host keyed by rid), and pinning a preempted
        heavy request at the front would head-block every later
        urgent arrival behind a resume that cannot fit yet — the
        exact FIFO collapse this policy exists to prevent. Aging is
        what bounds the preempted request's wait instead."""
        if len(waiting) < 2:
            return
        items = sorted(waiting, key=self._key)
        waiting.clear()
        waiting.extend(items)

    def priority_of(self, req) -> int:
        boost = (
            self.deadline_boost
            if req.ttft_deadline_ms is not None and not req.tokens
            else 0
        )
        return req.priority + boost

    # -- introspection --------------------------------------------------

    def snapshot_counters(self) -> dict:
        return {t: round(v, 3) for t, v in sorted(self._vtc.items())}

    def stats(self) -> dict:
        return {
            "name": type(self).__name__,
            "virtual_counters": {
                t: round(v, 3) for t, v in sorted(self._vtc.items())
            },
            "outstanding": dict(sorted(self._outstanding.items())),
            "wave": self._wave,
            "max_queue_tokens": self.max_queue_tokens,
            "rejected": self._rejected,
        }


def resolve_policy(policy, tenants=None):
    """The ``serve(policy=, tenants=)`` knob resolver: ``None`` (no
    policy at all — the legacy zero-overhead path) unless tenants are
    declared, a policy name (``"fifo"`` / ``"fair"``), or a
    :class:`Policy` instance. Loud on every ambiguous combination."""
    if policy is None:
        if tenants is None:
            return None
        # tenants declared without a policy: fair share is the only
        # reason to declare them — defaulting to FIFO would record
        # labels while silently not isolating anybody
        return FairSharePolicy(tenants)
    if isinstance(policy, str):
        name = policy.lower()
        if name == "fifo":
            return FifoPolicy(tenants)
        if name == "fair":
            return FairSharePolicy(tenants)
        raise ValueError(
            f"unknown policy {policy!r} — use 'fifo', 'fair', or a "
            f"serving.policy.Policy instance"
        )
    if not isinstance(policy, Policy):
        raise TypeError(
            f"policy must be a str or serving.policy.Policy, got "
            f"{type(policy).__name__}"
        )
    if tenants is not None:
        raise ValueError(
            "pass tenants= only with a policy name — a Policy instance "
            "already declared its own tenants, and merging two tenant "
            "sets silently would hide which weights actually apply"
        )
    return policy
