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

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: the prefix cache, paged admission with preemption, SLO
policies, wave-aware slot placement and the telemetry counters.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

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
    """One admission decision: ``req`` leases ``slot`` (cold: its whole
    prompt prefills)."""

    req: Request
    slot: int


class Scheduler:
    """FIFO queue + slot lease tracking for the fixed arena of
    :class:`~elephas_tpu_torch.serving.engine.InferenceEngine`."""

    def __init__(self, num_slots: int, buckets, prefix_cache: bool = False,
                 allocator=None, preemption: bool = False, policy=None,
                 wave_slots: int | None = None):
        for name, value, item in (("prefix_cache", prefix_cache, 1),
                                  ("allocator", allocator, 3),
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
        """Lease free slots to waiting requests, FIFO, lowest free slot
        first. Returns the wave's :class:`Admission` plan; the engine runs
        the prefills."""
        admitted: list[Admission] = []
        while self.waiting and self._free:
            req = self._dequeue_head()
            slot = self._pop_free_slot()
            req.slot = slot
            self.active[slot] = req
            admitted.append(Admission(req=req, slot=slot))
        return admitted

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
        to a waiting request in the same engine step."""
        req = self.active.pop(slot)
        req.slot = None
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
