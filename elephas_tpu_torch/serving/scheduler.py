"""Iteration-level request scheduling (Orca-style continuous batching).

Host-only copy of the fixed-arena half of
``elephas_tpu/serving/scheduler.py``: the scheduler decides *which*
request occupies *which* slot at each engine step, and the engine turns
those decisions into device work. Admission is greedy (FIFO) into free
slots at every step boundary, lowest free slot first; requests submitted
mid-flight join the next step's admission wave, and slots reclaim the
moment a sequence hits EOS or its token budget.

Prompt lengths are padded up to a fixed **bucket ladder**
(:func:`default_buckets`: powers of two, capped at the model's
``maxlen``), so prefill runs at a small closed set of shapes.

With ``prefix_cache=True`` finished requests' prompt rows stay resident as
donor slots under a :class:`~elephas_tpu_torch.serving.prefix_cache.\
PrefixCache`: admission matches each request against them, and evicts the
least recently used donor when no slot is free.

With an ``allocator`` (the paged arena) a request needs a free slot AND its
whole block reservation (:meth:`Scheduler.admit_paged`); the prefix cache
becomes a :class:`~elephas_tpu_torch.serving.prefix_cache.PagedPrefixIndex`
whose hits splice blocks into the new table; with ``preemption=True`` an
arrival may swap out active requests of strictly lower priority
(:class:`Preemption`), which re-queue at the front and resume bit for bit.

A ``policy`` (:mod:`~elephas_tpu_torch.serving.policy`) re-ranks the
waiting queue before every admission attempt, is charged at admission and
told of preemptions, and gives the priorities preemption compares; the
queue's outstanding token debt (``queued_tokens``, per tenant by
:meth:`Scheduler.queued_tokens_for`) feeds its admission control. Without
one the scheduler takes the FIFO path and calls no hook. The order of every
decision is the reference's.

Admissions by kind and the waiting queue's depth are mirrored into the
port's telemetry registry (the reference's ``elephas_serving_admissions_total``
and ``elephas_serving_waiting_requests``, labeled ``scheduler=<instance>``),
report-only: no decision reads them. :meth:`Scheduler.adopt_preempted`
queues a migrated request whose K/V the engine holds on the host, and
:meth:`Scheduler.queue_snapshot` lists the queue for ``debug_snapshot``.

Not ported yet, raising ``NotImplementedError`` that names its ROADMAP.md
item: wave-aware slot placement.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.serving.paged_kv import blocks_for
from elephas_tpu_torch.serving.policy import DEFAULT_TENANT
from elephas_tpu_torch.serving.prefix_cache import PagedPrefixIndex, PrefixCache

_TODO = "Scheduler({}) is not ported yet (ROADMAP.md, Queue A item {})"

# Each scheduler mints rids from its own stride of the integer line, so
# two engines in one process never share a rid.
RID_STRIDE = 1 << 40
_rid_bases = itertools.count()


def default_buckets(max_len: int, floor: int = 16) -> tuple[int, ...]:
    """Power-of-two prompt buckets ``[floor, 2·floor, ..]`` capped at
    (and always including) ``max_len``."""
    if max_len <= 0:
        raise ValueError(f"max_len must be positive, got {max_len}")
    buckets = []
    b = max(1, floor)
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def bucket_for(prompt_len: int, buckets) -> int:
    """Smallest bucket holding ``prompt_len`` tokens."""
    for b in buckets:
        if b >= prompt_len:
            return int(b)
    raise ValueError(
        f"prompt of {prompt_len} tokens exceeds the largest bucket "
        f"{max(buckets)}"
    )


@dataclass
class Request:
    """One in-flight generation request.

    ``tokens`` accumulates the GENERATED continuation only (the prompt is
    not repeated there). ``on_token(token, done)`` is an optional
    per-token consumer callback; when it raises, the engine fails THIS
    request (``error`` set, slot reclaimed) and keeps serving the rest.
    ``token_times`` holds the host arrival time of each generated token:
    ``token_times[0] - submit_time`` is the TTFT, the consecutive deltas
    the inter-token latencies. ``tenant`` (None: the default tenant) and
    ``ttft_deadline_ms`` are read by a policy; ``spec_drafted`` /
    ``spec_accepted`` count this request's drafted and accepted tokens
    under speculative decoding. ``submit_step`` (the scheduler step at
    submit: queue waits are counted in steps, never wall time) and
    ``exemplar`` (the rid label set of its latency observations, built once)
    feed telemetry only."""

    rid: int
    prompt: tuple
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: int | None = None
    priority: int = 0
    tenant: str | None = None
    ttft_deadline_ms: float | None = None
    tokens: list = field(default_factory=list)
    slot: int | None = None
    done: bool = False
    submit_step: int | None = None
    submit_time: float | None = None
    finish_time: float | None = None
    on_token: object | None = None
    error: BaseException | None = None
    token_times: list = field(default_factory=list)
    # prompt tokens served from the prefix cache instead of prefill
    reused_tokens: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    exemplar: dict | None = None

    @property
    def full_sequence(self) -> list:
        return list(self.prompt) + self.tokens

    @property
    def ttft(self) -> float | None:
        """Submit→first-token seconds (None until the first token)."""
        if not self.token_times or self.submit_time is None:
            return None
        return self.token_times[0] - self.submit_time

    @property
    def inter_token_times(self) -> list:
        """Deltas between consecutive token arrivals (seconds)."""
        tt = self.token_times
        return [b - a for a, b in zip(tt, tt[1:])]


@dataclass
class Admission:
    """One admission decision: ``req`` leases ``slot``; when the prefix
    cache found a donor, ``donor_slot``'s first ``reuse_len`` arena rows
    are copied before the (suffix-only) prefill.

    Paged admissions fill the second group instead: ``blocks`` is the slot's
    new block table (shared splice + own allocation), ``shared_len`` the
    prefix tokens already resident in the spliced blocks (prefill starts
    there), and ``resume`` the preemption record when this admission brings
    an offloaded request back (the engine restores its K/V and cursor
    instead of prefilling)."""

    req: Request
    slot: int
    donor_slot: int | None = None
    reuse_len: int = 0
    blocks: list | None = None
    shared_len: int = 0
    resume: "Preemption | None" = None


@dataclass
class Preemption:
    """One preemption decision (paged arena): ``req`` lost ``slot``; its
    first ``len(blocks)`` table blocks hold the K/V of positions
    ``0..cur_len-1`` and must be offloaded to the host before any pool write
    (the engine orders it so). The request re-queues at the front and
    resumes bit for bit."""

    req: Request
    slot: int
    blocks: tuple
    cur_len: int


class Scheduler:
    """FIFO (or policy-ordered) queue + slot (and, paged, block) lease
    tracking for :class:`~elephas_tpu_torch.serving.engine.InferenceEngine`."""

    def __init__(self, num_slots: int, buckets, prefix_cache: bool = False,
                 prefix_min_reuse: int = 1, allocator=None,
                 preemption: bool = False, policy=None,
                 wave_slots: int | None = None):
        if wave_slots:
            raise NotImplementedError(_TODO.format(f"wave_slots={wave_slots!r}", 5))
        self.num_slots = int(num_slots)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.waiting: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self._free: list[int] = list(range(self.num_slots))
        self.rid_base = next(_rid_bases) * RID_STRIDE
        self._ids = itertools.count(self.rid_base)
        # the admission policy (None: the FIFO path, no hook called) and
        # the waiting queue's outstanding token debt, kept at every enqueue
        # and dequeue
        self.policy = policy
        self.queued_tokens = 0
        # paged arena: an allocator switches admission to slot + block
        # leasing, and the prefix cache to the block-refcount index
        self.allocator = allocator
        self.preemption = bool(preemption)
        if preemption and allocator is None:
            raise ValueError(
                "preemption requires the paged allocator — the fixed "
                "arena has no blocks to swap out"
            )
        self.tables: dict[int, list[int]] = {}
        # bumped on any table change: the engine restages its device tables
        self.tables_version = 0
        self._preempted: dict[int, Preemption] = {}
        self.prefix_index = (
            PagedPrefixIndex(allocator) if prefix_cache and allocator is not None else None
        )
        self.prefix_cache = PrefixCache() if prefix_cache and allocator is None else None
        # matches shallower than this admit cold: a 1-2 token coincidental
        # prefix is not worth a copy
        self.prefix_min_reuse = max(1, int(prefix_min_reuse))
        # occupancy accounting: decode steps, and busy slots summed over them
        self._steps = 0
        self._busy_slot_steps = 0
        # admissions by kind and the queue depth, report-only mirrors
        reg = telemetry.registry()
        sid = telemetry.instance_label()
        self.telemetry_label = sid
        admissions = reg.counter(
            "elephas_serving_admissions_total",
            "Requests admitted into KV slots, by admission kind",
            labels=("scheduler", "kind"),
        )
        self._m_admit_cold = admissions.labels(scheduler=sid, kind="cold")
        self._m_admit_hit = admissions.labels(scheduler=sid, kind="prefix_hit")
        self._m_admit_resume = admissions.labels(scheduler=sid, kind="resume")
        self._m_waiting = reg.gauge(
            "elephas_serving_waiting_requests",
            "Requests queued behind a full slot arena",
            labels=("scheduler",),
        ).labels(scheduler=sid)

    def release_telemetry(self) -> None:
        """Retire this scheduler's labeled series, and its prefix cache's,
        from the registry (the engine's ``release_telemetry`` cascades
        here)."""
        telemetry.remove_series(scheduler=self.telemetry_label)
        if self.prefix_cache is not None:
            self.prefix_cache.release_telemetry()
        if self.prefix_index is not None:
            self.prefix_index.release_telemetry()

    # -- submission ----------------------------------------------------

    @staticmethod
    def _debt(req: Request) -> int:
        """Tokens the request still owes the engine (prompt + remaining
        budget), frozen while it waits."""
        return len(req.prompt) + req.max_new_tokens - len(req.tokens)

    def submit(self, request: Request) -> Request:
        request.rid = next(self._ids) if request.rid is None else request.rid
        self.waiting.append(request)
        self.queued_tokens += self._debt(request)
        if self.policy is not None:
            self.policy.on_submit(request)
        self._m_waiting.set(len(self.waiting))
        return request

    def make_request(self, prompt, max_new_tokens, temperature=0.0,
                     eos_id=None, on_token=None, priority: int = 0,
                     tenant: str | None = None,
                     ttft_deadline_ms: float | None = None) -> Request:
        return Request(
            rid=next(self._ids),
            prompt=tuple(int(t) for t in prompt),
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            eos_id=None if eos_id is None else int(eos_id),
            on_token=on_token,
            priority=int(priority),
            tenant=tenant,
            ttft_deadline_ms=None if ttft_deadline_ms is None else float(ttft_deadline_ms),
        )

    def remove_waiting(self, rid: int) -> Request | None:
        """Pull one request out of the waiting queue by rid (cancel,
        migration export): its token debt and any preemption record drop,
        and the caller owns its policy accounting. None when the rid is not
        waiting."""
        req = next((r for r in self.waiting if r.rid == rid), None)
        if req is not None:
            self.waiting.remove(req)
            self.queued_tokens -= self._debt(req)
            self._preempted.pop(rid, None)
            self._m_waiting.set(len(self.waiting))
        return req

    def adopt_preempted(self, req: Request, cur_len: int) -> None:
        """Queue a request whose K/V the engine holds as a host offload
        record (a migration import): it waits at the front like a local
        preemption victim, and :meth:`admit_paged` plans its resume through
        the same path."""
        self._preempted[req.rid] = Preemption(req=req, slot=-1, blocks=(), cur_len=int(cur_len))
        self.waiting.appendleft(req)
        self.queued_tokens += self._debt(req)
        if self.policy is not None:
            self.policy.on_submit(req)
        self._m_waiting.set(len(self.waiting))

    @staticmethod
    def _tenant_of(req: Request) -> str:
        return req.tenant if req.tenant is not None else DEFAULT_TENANT

    def waiting_count(self, tenant: str) -> int:
        """Waiting requests accounted under ``tenant``."""
        return sum(1 for r in self.waiting if self._tenant_of(r) == tenant)

    def queued_tokens_for(self, tenant: str | None) -> int:
        """The waiting queue's token debt owed by one tenant (None: the
        default tenant), computed over the queue."""
        t = DEFAULT_TENANT if tenant is None else tenant
        return sum(self._debt(r) for r in self.waiting if self._tenant_of(r) == t)

    def _prio(self, req: Request) -> int:
        """Preemption-effective priority: the policy's when one is
        installed, the caller's ``submit(priority=)`` otherwise."""
        if self.policy is not None:
            return self.policy.priority_of(req)
        return req.priority

    def _policy_reorder(self) -> None:
        """Let the policy re-rank the waiting queue before an admission
        attempt."""
        if self.policy is not None:
            self.policy.reorder(self.waiting, self._preempted)

    def _pop_free_slot(self) -> int:
        """Take the lowest free slot."""
        return self._free.pop(0)

    def _dequeue_head(self) -> Request:
        """Pop the queue head into an admission: its debt drops and the
        policy charges the prefill (a resume charges nothing)."""
        req = self.waiting.popleft()
        self.queued_tokens -= self._debt(req)
        if self.policy is not None:
            self.policy.on_admit(req, resumed=req.rid in self._preempted)
        return req

    # -- per-step decisions --------------------------------------------

    def admit(self) -> list[Admission]:
        """Lease slots to waiting requests (FIFO), lowest free slot first,
        evicting LRU prefix-cache donors under slot pressure. Returns the
        wave's :class:`Admission` plan (donor and reuse length resolved per
        request); the engine runs the copies and prefills.

        A donor chosen for one admission is pinned through the wave, so a
        later admission cannot evict it before the engine's copy reads it.
        When the only evictable slot is that pinned donor, the request
        drops its reuse and is admitted cold into the evicted donor:
        progress beats reuse, and a one-slot engine must not livelock."""
        admitted: list[Admission] = []
        pinned: list[int] = []
        cache = self.prefix_cache
        if self.policy is not None:
            self.policy.begin_wave()
        while self.waiting:
            # re-rank before every attempt: an admission earlier in the
            # wave charged its tenant's counter
            self._policy_reorder()
            req = self.waiting[0]
            donor, reuse = (None, 0)
            if cache is not None:
                # match() is pure: a blocked queue head is probed every step
                donor, reuse = cache.match(req.prompt)
                if donor is not None and reuse < self.prefix_min_reuse:
                    donor, reuse = None, 0
                if donor is not None:
                    cache.pin(donor)
                    pinned.append(donor)
            if self._free:
                slot = self._pop_free_slot()
            else:
                slot = cache.evict_lru() if cache is not None else None
                if slot is None and donor is not None:
                    cache.unpin(donor)
                    pinned.pop()
                    donor, reuse = None, 0
                    slot = cache.evict_lru()
                if slot is None:
                    break  # full: the request keeps waiting
            self._dequeue_head()
            if cache is not None:
                cache.remove(slot)  # its rows are about to be overwritten
                if donor is not None:
                    cache.commit_hit(donor, reuse)
                else:
                    cache.record_miss()
            req.slot = slot
            req.reused_tokens = reuse
            self.active[slot] = req
            (self._m_admit_hit if donor is not None else self._m_admit_cold).inc()
            admitted.append(Admission(req=req, slot=slot, donor_slot=donor, reuse_len=reuse))
        # the engine copies the donors' rows right after this wave returns,
        # and nothing evicts before the next admit(): the pins end here
        if cache is not None:
            for slot in pinned:
                cache.unpin(slot)
        self._m_waiting.set(len(self.waiting))
        return admitted

    # -- paged admission ------------------------------------------------

    def blocks_needed(self, req: Request) -> int:
        """Full reservation of ``req``: blocks covering its prompt and whole
        token budget, reserved up front, so an admitted request never meets
        an exhausted pool mid-flight."""
        return blocks_for(len(req.prompt) + req.max_new_tokens, self.allocator.block_size)

    def admit_paged(self, prefilling=frozenset()):
        """Paged admission wave: FIFO head-blocking like :meth:`admit`, but a
        request needs a free slot AND its full block reservation. Shortfalls
        resolve in the reference's order: evict least recently used prefix
        entries first, then, with ``preemption`` and a head that outranks an
        active request, preempt victims (lowest priority first, youngest
        first within one) until the head fits, or none at all if even that
        would not admit it. ``prefilling`` slots are never victims.

        Returns ``(admissions, preemptions)``; the engine offloads every
        preemption's blocks before any pool write, then runs the
        admissions."""
        if self.allocator is None:
            raise RuntimeError("admit_paged() on a non-paged scheduler")
        admitted: list[Admission] = []
        preempts: list[Preemption] = []
        # rids admitted by this wave are never its preemption victims
        wave_rids: set[int] = set()
        alloc, idx = self.allocator, self.prefix_index
        if self.policy is not None:
            self.policy.begin_wave()
        while self.waiting:
            self._policy_reorder()
            req = self.waiting[0]
            need_total = self.blocks_needed(req)
            record = self._preempted.get(req.rid)
            eid, reuse = None, 0
            if record is None and idx is not None:
                # pure probe; the hit commits only when the admission lands
                eid, reuse = idx.match(req.prompt)
                if eid is not None and reuse < self.prefix_min_reuse:
                    eid, reuse = None, 0
            own_need = need_total - reuse // alloc.block_size
            short = own_need - alloc.free_count
            if short > 0 and idx is not None:
                idx.evict_for(short)
                short = own_need - alloc.free_count
            plan = []
            if short > 0 or not self._free:
                if self.preemption:
                    plan = self._plan_preemption(req, short, bool(self._free), prefilling,
                                                 wave_rids)
                if not plan:
                    break  # the head keeps waiting; nothing may jump it
            # the head will admit: off the queue before the preemptions, so
            # the victims re-queue ahead of the REST of the queue
            self._dequeue_head()
            for victim in plan:
                preempts.append(self._preempt(victim))
            shared: list[int] = []
            if eid is not None:
                shared = idx.commit_hit(eid, reuse)
            elif idx is not None and record is None:
                idx.record_miss()
            own = alloc.alloc(own_need)
            assert own is not None  # guaranteed by the short check
            slot = self._pop_free_slot()
            self.tables[slot] = shared + own
            self.tables_version += 1
            req.slot = slot
            self.active[slot] = req
            wave_rids.add(req.rid)
            if record is not None:
                self._preempted.pop(req.rid)
                self._m_admit_resume.inc()
                admitted.append(Admission(req=req, slot=slot, blocks=self.tables[slot],
                                          resume=record))
            else:
                req.reused_tokens = reuse
                (self._m_admit_hit if eid is not None else self._m_admit_cold).inc()
                admitted.append(Admission(req=req, slot=slot, blocks=self.tables[slot],
                                          shared_len=reuse))
        self._m_waiting.set(len(self.waiting))
        return admitted, preempts

    def _plan_preemption(self, req: Request, short: int, have_slot: bool, prefilling,
                         wave_rids):
        """Victims that would admit ``req``, or none at all. Eligible: active,
        of strictly lower priority (the policy's, with one), not mid-prefill, not admitted by this
        wave, holding a generated token. Order: lowest priority first, then
        youngest (largest rid). Only blocks whose last reference is the
        victim's table count as freed."""
        head_prio = self._prio(req)
        cands = [
            r for slot, r in self.active.items()
            if self._prio(r) < head_prio and slot not in prefilling
            and r.tokens and r.rid not in wave_rids
        ]
        cands.sort(key=lambda r: (self._prio(r), -r.rid))
        chosen, freed, slots_freed = [], 0, 0
        for r in cands:
            if freed >= short and (have_slot or slots_freed > 0):
                break
            freed += sum(1 for b in self.tables[r.slot] if self.allocator.ref_count(b) == 1)
            slots_freed += 1
            chosen.append(r)
        if freed < short or not (have_slot or slots_freed > 0):
            return []
        return chosen

    def _preempt(self, req: Request) -> Preemption:
        """Bookkeeping half of a preemption: snapshot the offloadable blocks,
        free the slot and the block references, re-queue the victim at the
        front. The device rows stay intact until the next pool write."""
        slot = req.slot
        table = self.tables.pop(slot)
        self.tables_version += 1
        # resident K/V: the prompt and every generated token but the last
        # sampled one (its K/V lands on the next decode step)
        cur_len = len(req.prompt) + len(req.tokens) - 1
        rec = Preemption(req=req, slot=slot,
                         blocks=tuple(table[: blocks_for(cur_len, self.allocator.block_size)]),
                         cur_len=cur_len)
        self.active.pop(slot)
        req.slot = None
        self._free.append(slot)
        self._free.sort()
        self.allocator.deref(table)
        self._preempted[req.rid] = rec
        self.waiting.appendleft(req)
        # back in the queue, back in the debt; the policy re-arms its aging
        # clock (no counter lift)
        self.queued_tokens += self._debt(req)
        if self.policy is not None:
            self.policy.on_preempt(req)
        return rec

    def on_prefill_complete(self, req: Request) -> None:
        """Register the request's prompt rows as a reusable prefix (its
        slot's first ``len(prompt)`` rows now hold that K/V); paged, its
        prompt's full blocks by refcount."""
        if req.slot is None:
            return
        if self.prefix_index is not None:
            n_full = len(req.prompt) // self.allocator.block_size
            if n_full:
                self.prefix_index.insert(req.prompt, self.tables[req.slot][:n_full])
        elif self.prefix_cache is not None:
            self.prefix_cache.insert(req.slot, req.prompt)

    def flush_prefix_cache(self) -> None:
        """Invalidate every cached prefix and return the donor slots to the
        free list (their rows are stale after a weight refresh); paged, the
        index's block references drop."""
        if self.prefix_index is not None:
            self.prefix_index.flush()
            return
        if self.prefix_cache is None:
            return
        self._free.extend(self.prefix_cache.flush())
        self._free.sort()

    def on_token(self, slot: int, token: int) -> bool:
        """Record one generated token for the slot's occupant; returns
        True when the request just finished (EOS or budget) — the caller
        then reclaims the slot."""
        req = self.active[slot]
        req.tokens.append(int(token))
        if (
            req.eos_id is not None and int(token) == req.eos_id
        ) or len(req.tokens) >= req.max_new_tokens:
            req.done = True
            return True
        return False

    def reclaim(self, slot: int) -> Request:
        """Free the slot immediately: the next :meth:`admit` can hand it
        to a waiting request in the same engine step. With the prefix
        cache on, a slot whose prompt rows are indexed is retained as a
        donor instead (evicted LRU under pressure)."""
        req = self.active.pop(slot)
        req.slot = None
        if self.allocator is not None:
            # paged: the slot always frees; the table's references drop, and
            # blocks the prefix index holds survive on its own references
            table = self.tables.pop(slot, None)
            if table is not None:
                self.allocator.deref(table)
                self.tables_version += 1
        elif self.prefix_cache is not None and self.prefix_cache.release(slot):
            return req  # resident donor: off the free list
        self._free.append(slot)
        self._free.sort()
        return req

    def note_step(self) -> None:
        self._steps += 1
        self._busy_slot_steps += len(self.active)

    # -- introspection -------------------------------------------------

    def queue_snapshot(self) -> list[dict]:
        """The waiting queue as rows, in its current (policy-ranked) order:
        rid, tenant, priority, outstanding token debt, prompt length,
        deadline, and whether the entry is a preempted request awaiting
        resume (``debug_snapshot``'s queue section)."""
        return [
            {
                "rid": r.rid,
                "tenant": r.tenant,
                "priority": r.priority,
                "debt_tokens": self._debt(r),
                "prompt_tokens": len(r.prompt),
                "ttft_deadline_ms": r.ttft_deadline_ms,
                "preempted": r.rid in self._preempted,
            }
            for r in self.waiting
        ]

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    @property
    def occupancy(self) -> float:
        """Mean busy-slot fraction over all decode steps so far."""
        if self._steps == 0:
            return 0.0
        return self._busy_slot_steps / (self._steps * self.num_slots)

    def bucket_for(self, prompt_len: int) -> int:
        return bucket_for(prompt_len, self.buckets)
