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

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: paged admission with preemption, SLO policies, wave-aware
slot placement and the telemetry counters.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

from elephas_tpu_torch.serving.prefix_cache import PrefixCache

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
    the inter-token latencies."""

    rid: int
    prompt: tuple
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: int | None = None
    priority: int = 0
    tokens: list = field(default_factory=list)
    slot: int | None = None
    done: bool = False
    submit_time: float | None = None
    finish_time: float | None = None
    on_token: object | None = None
    error: BaseException | None = None
    token_times: list = field(default_factory=list)
    # prompt tokens served from the prefix cache instead of prefill
    reused_tokens: int = 0

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
    are copied before the (suffix-only) prefill."""

    req: Request
    slot: int
    donor_slot: int | None = None
    reuse_len: int = 0


class Scheduler:
    """FIFO queue + slot lease tracking for the fixed arena of
    :class:`~elephas_tpu_torch.serving.engine.InferenceEngine`."""

    def __init__(self, num_slots: int, buckets, prefix_cache: bool = False,
                 prefix_min_reuse: int = 1, allocator=None,
                 preemption: bool = False, policy=None,
                 wave_slots: int | None = None):
        for name, value, item in (("allocator", allocator, 3),
                                  ("preemption", preemption, 3),
                                  ("policy", policy, 3),
                                  ("wave_slots", wave_slots, 5)):
            if value:
                raise NotImplementedError(_TODO.format(f"{name}={value!r}", item))
        self.num_slots = int(num_slots)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.waiting: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self._free: list[int] = list(range(self.num_slots))
        self.rid_base = next(_rid_bases) * RID_STRIDE
        self._ids = itertools.count(self.rid_base)
        self.prefix_cache = PrefixCache() if prefix_cache else None
        # matches shallower than this admit cold: a 1-2 token coincidental
        # prefix is not worth a copy
        self.prefix_min_reuse = max(1, int(prefix_min_reuse))
        # occupancy accounting: decode steps, and busy slots summed over them
        self._steps = 0
        self._busy_slot_steps = 0

    # -- submission ----------------------------------------------------

    def submit(self, request: Request) -> Request:
        request.rid = next(self._ids) if request.rid is None else request.rid
        self.waiting.append(request)
        return request

    def make_request(self, prompt, max_new_tokens, temperature=0.0,
                     eos_id=None, on_token=None, priority: int = 0) -> Request:
        return Request(
            rid=next(self._ids),
            prompt=tuple(int(t) for t in prompt),
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            eos_id=None if eos_id is None else int(eos_id),
            on_token=on_token,
            priority=int(priority),
        )

    def remove_waiting(self, rid: int) -> Request | None:
        """Pull one request out of the waiting queue by rid (cancel); None
        when the rid is not waiting."""
        req = next((r for r in self.waiting if r.rid == rid), None)
        if req is not None:
            self.waiting.remove(req)
        return req

    def _pop_free_slot(self) -> int:
        """Take the lowest free slot."""
        return self._free.pop(0)

    def _dequeue_head(self) -> Request:
        return self.waiting.popleft()

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
        while self.waiting:
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
            admitted.append(Admission(req=req, slot=slot, donor_slot=donor, reuse_len=reuse))
        # the engine copies the donors' rows right after this wave returns,
        # and nothing evicts before the next admit(): the pins end here
        if cache is not None:
            for slot in pinned:
                cache.unpin(slot)
        return admitted

    def on_prefill_complete(self, req: Request) -> None:
        """Register the request's prompt rows as a reusable prefix (its
        slot's first ``len(prompt)`` rows now hold that K/V)."""
        if req.slot is not None and self.prefix_cache is not None:
            self.prefix_cache.insert(req.slot, req.prompt)

    def flush_prefix_cache(self) -> None:
        """Invalidate every cached prefix and return the donor slots to the
        free list (their rows are stale after a weight refresh)."""
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
        if self.prefix_cache is not None and self.prefix_cache.release(slot):
            return req  # resident donor: off the free list
        self._free.append(slot)
        self._free.sort()
        return req

    def note_step(self) -> None:
        self._steps += 1
        self._busy_slot_steps += len(self.active)

    # -- introspection -------------------------------------------------

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
