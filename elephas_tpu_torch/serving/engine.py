"""InferenceEngine — the continuous-batching serving loop.

Counterpart of ``elephas_tpu/serving/engine.py`` on its default path: the
fixed slot arena, whole-prompt prefill, ``attention="flash"`` (or
``"naive"``, the parity oracle). One engine wraps one causal
:func:`~elephas_tpu_torch.transformer_lm` and serves any number of
generation requests through two kinds of device work:

- **prefill**, one forward per prompt-length bucket of an admission wave
  (:func:`~elephas_tpu_torch.serving.kv_cache.prefill_forward`; the flash
  forward kernel on the card), writing each prompt's K/V into its leased
  slot;
- a **decode window** of ``steps_per_sync`` steps over the whole arena
  (:func:`~elephas_tpu_torch.serving.kv_cache.token_decode_step`; the
  span-decode kernel on the card), each advancing every in-flight sequence
  by one token at its own position. Within a window the tokens stay on the
  device: a step's input is the previous step's sampled tensor, and the
  host reads the window once.

Each :meth:`InferenceEngine.step`: admit waiting requests into free slots
(prefill), run one decode window, reclaim slots that hit EOS or their
token budget. Requests may be submitted at any time and join the next
step's admission wave.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: the prefix cache and chunked prefill, the paged arena,
preemption and quantized KV, speculative decoding, SLO policies,
sequence-parallel prefill, meshes, the gateway and telemetry.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from elephas_tpu_torch.device import resolve_device
from elephas_tpu_torch.models.transformer import (
    _filter_logits,
    _is_neutral,
    validate_token_decode_model,
)
from elephas_tpu_torch.ops.flash_serving import span_bucket_for, span_buckets
from elephas_tpu_torch.serving.kv_cache import SlotKVCache, prefill_forward, token_decode_step
from elephas_tpu_torch.serving.scheduler import Request, Scheduler, default_buckets

logger = logging.getLogger(__name__)

_TODO = "InferenceEngine({}) is not ported yet (ROADMAP.md, Queue A item {})"


class RequestCancelled(RuntimeError):
    """Set as ``req.error`` when :meth:`InferenceEngine.cancel` reclaims
    an in-flight request: the request is ``done`` without completing, its
    tokens-so-far kept for the caller."""


def _sample_dynamic(logits, generator, temps, top_k, top_p):
    """Per-row sampling with a temperature vector: rows with
    ``temps <= 0`` take the greedy argmax, the rest temperature-scaled
    categorical sampling under the engine's top_k/top_p filters (the
    Gumbel-max draw, as ``jax.random.categorical`` makes it, from
    ``generator``). Both are computed for every row, so the draw consumes
    the generator the same way whatever the temperatures, and nothing
    waits for the host."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = _filter_logits(logits / torch.clamp(temps, min=1e-6)[:, None], top_k, top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


class InferenceEngine:
    """Continuous-batching server over a slot-based KV cache.

    ``num_slots`` bounds concurrent in-flight sequences; ``buckets``
    overrides the prompt-padding ladder; ``top_k`` / ``top_p`` are
    engine-wide sampling filters; per-request ``temperature`` rides as
    data (0 = greedy), sampled from a ``torch.Generator`` seeded with
    ``seed``. ``steps_per_sync`` decode steps run per window between host
    reads. ``attention="flash"`` (the default) prefills through the flash
    forward and decodes through the span-decode kernel over a span bucket
    that covers the live residents; ``"naive"`` selects the dense masked
    softmax over the whole ``maxlen`` row, the parity oracle. ``device``
    defaults to the model's device; the engine runs where the model is.

    Every other keyword of the reference is accepted: at the value that
    leaves the behaviour unchanged (the reference's default, and
    ``flight_recorder=None`` or ``0``: the port records nothing yet), any
    other value raising ``NotImplementedError`` that names its ROADMAP.md
    item."""

    def __init__(self, model, num_slots: int = 8, mesh=None,
                 batch_axes=("data",), model_axis=None, rules=None,
                 top_k: int | None = None, top_p: float | None = None,
                 seed: int = 0, buckets=None, steps_per_sync: int = 1,
                 prefix_cache: bool = False,
                 prefix_min_reuse: int = 1,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 paged: bool = False,
                 block_size: int | None = None,
                 num_blocks: int | None = None,
                 preemption: bool = False,
                 kv_dtype: str = "fp",
                 speculative: bool = False,
                 spec_k: int | None = None,
                 spec_drafter=None,
                 policy=None,
                 attention: str = "flash",
                 sp_prefill=None,
                 sp_axis: str = "seq",
                 sp_threshold: int | None = None,
                 sp_mechanism: str = "ring",
                 flight_recorder: int | None = None,
                 device=None):
        layers = validate_token_decode_model(
            model, what="the serving engine", hint="use one-shot generate()"
        )
        # (name, value, the value that leaves the behaviour unchanged, item)
        unported = (
            ("prefix_cache", prefix_cache, False, 1), ("prefix_min_reuse", prefix_min_reuse, 1, 1),
            ("prefill_chunk", prefill_chunk, None, 1), ("prefill_budget", prefill_budget, None, 1),
            ("paged", paged, False, 3), ("block_size", block_size, None, 3),
            ("num_blocks", num_blocks, None, 3), ("preemption", preemption, False, 3),
            ("kv_dtype", kv_dtype, "fp", 3), ("speculative", speculative, False, 3),
            ("spec_k", spec_k, None, 3), ("spec_drafter", spec_drafter, None, 3),
            ("policy", policy, None, 3), ("flight_recorder", flight_recorder or None, None, 3),
            ("mesh", mesh, None, 5), ("batch_axes", batch_axes, ("data",), 5),
            ("model_axis", model_axis, None, 5), ("rules", rules, None, 5),
            ("sp_prefill", sp_prefill, None, 5), ("sp_axis", sp_axis, "seq", 5),
            ("sp_threshold", sp_threshold, None, 5), ("sp_mechanism", sp_mechanism, "ring", 5),
        )
        for name, value, neutral, item in unported:
            if not _is_neutral(value, neutral):
                raise NotImplementedError(_TODO.format(f"{name}={value!r}", item))
        self.model = model
        self.maxlen = int(model.maxlen)
        self.vocab = int(model.vocab_size)
        self.top_k = top_k
        self.top_p = top_p
        if top_k is not None and not 0 < int(top_k) <= self.vocab:
            raise ValueError(
                f"top_k={top_k} outside (0, vocab={self.vocab}]"
            )
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p={top_p} outside (0, 1]")
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots} < 1")
        self.num_slots = int(num_slots)
        if buckets is not None:
            buckets = tuple(int(b) for b in buckets)
            bad = [b for b in buckets if not 0 < b <= self.maxlen]
            if bad:
                raise ValueError(
                    f"buckets {bad} outside (0, maxlen={self.maxlen}] — "
                    f"a bucket beyond maxlen would overflow the KV arena"
                )
        if attention not in ("flash", "naive"):
            raise ValueError(
                f"attention must be 'flash' or 'naive', got "
                f"{attention!r}"
            )
        self.attention = attention
        self.device = model.device
        if device is not None and resolve_device(device) not in (
                self.device, torch.device(self.device.type)):
            raise ValueError(
                f"the engine runs on the model's device ({self.device}), not "
                f"{device}: move the model first"
            )
        # span ladder: flash decode attends over cache[:, :span], the
        # smallest bucket covering the live residents and the window
        self._sbuckets = span_buckets(self.maxlen)
        self.steps_per_sync = max(1, int(steps_per_sync))

        self.arena = SlotKVCache(layers, self.num_slots, self.maxlen, self.device)
        self.scheduler = Scheduler(self.num_slots, buckets or default_buckets(self.maxlen))
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))
        # per-slot device state: cursor (resident length), last token,
        # temperature, and the decode-active mask (host mirror + device
        # copy, re-uploaded only when membership changes)
        dev = self.device
        self._lengths = torch.zeros(self.num_slots, dtype=torch.int32, device=dev)
        self._last = torch.zeros(self.num_slots, dtype=torch.long, device=dev)
        self._temps = torch.zeros(self.num_slots, dtype=torch.float32, device=dev)
        self._active_host = np.zeros((self.num_slots,), bool)
        self._active_dev = torch.zeros(self.num_slots, dtype=torch.bool, device=dev)
        self._active_dirty = False
        # completed requests, bounded: callers keep their own Request
        # handles from submit(); this registry feeds stats() and run(),
        # and evicts the oldest past the bound
        self.finished: dict[int, Request] = {}
        self._finished_bound = 4096
        self._protected: set[int] = set()
        self.total_generated = 0
        self.finished_count = 0
        self.finished_evicted = 0
        self.cancelled = 0

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        """The reference stops its attached gateway here; the port
        attaches none yet (ROADMAP.md, Queue A item 3), so this only keeps
        ``with engine:`` as in the reference. Idempotent; the engine stays
        usable."""

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- request API ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, eos_id: int | None = None,
               on_token=None, priority: int = 0,
               tenant: str | None = None,
               ttft_deadline_ms: float | None = None) -> Request:
        """Queue one generation request (admitted at the next step;
        submission is legal at any time, including mid-flight).
        ``on_token(token, done)`` streams tokens to the caller as they
        land; a raising callback fails only ITS request (``req.error`` set,
        KV slot reclaimed) and the engine keeps serving. ``priority``,
        ``tenant`` and ``ttft_deadline_ms`` are validated as the reference
        validates them on an engine without preemption or a policy."""
        prompt = np.asarray(prompt).reshape(-1)
        p = len(prompt)
        if p < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} < 1")
        if p + max_new_tokens > self.maxlen:
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the model's maxlen ({self.maxlen})"
            )
        if temperature < 0:
            raise ValueError(f"temperature={temperature} < 0")
        # fail here, not mid-flight with a slot leased: a custom bucket
        # ladder may top out below the model's maxlen
        self.scheduler.bucket_for(p)
        if priority:
            logger.warning(
                "submit(priority=%d) on an engine without "
                "preemption=True — priority is recorded but IGNORED "
                "(admission stays FIFO); serve with paged=True, "
                "preemption=True for priority scheduling", priority,
            )
        if tenant is not None:
            raise ValueError(
                f"submit(tenant={tenant!r}) on an engine without a "
                f"policy — serve with policy=/tenants= to declare "
                f"tenants before accounting requests under them"
            )
        if ttft_deadline_ms is not None:
            if not float(ttft_deadline_ms) > 0:
                raise ValueError(
                    f"ttft_deadline_ms={ttft_deadline_ms} must be "
                    f"positive — a deadline at or before submit time "
                    f"can never be met"
                )
            raise ValueError(
                "submit(ttft_deadline_ms=) needs a deadline-aware "
                "policy (e.g. FairSharePolicy) — this engine's "
                "policy never reads deadlines, so the knob would "
                "be a silent no-op"
            )
        req = self.scheduler.make_request(
            prompt, max_new_tokens, temperature=temperature, eos_id=eos_id,
            on_token=on_token, priority=priority,
        )
        req.submit_time = time.perf_counter()
        return self.scheduler.submit(req)

    # -- token bookkeeping ----------------------------------------------

    def _emit(self, req: Request, token: int) -> bool:
        """Record one generated token; reclaim and file the request when it
        finished. Returns done. A raising per-token callback fails the
        request cleanly: its slot is reclaimed and the engine goes on."""
        self.total_generated += 1
        slot = req.slot
        req.token_times.append(time.perf_counter())
        done = self.scheduler.on_token(slot, token)
        if req.on_token is not None:
            try:
                req.on_token(token, done)
            except Exception as e:
                req.error = e
                req.done = True
                done = True
                logger.warning(
                    "request %d failed in its on_token callback (%r) — "
                    "slot %d reclaimed, engine continues", req.rid, e, slot,
                )
        if done:
            req.finish_time = req.token_times[-1]
            self.scheduler.reclaim(slot)
            self._set_active(slot, False)
            self.finished_count += 1
            self.finished[req.rid] = req
            self._evict_finished()
        return done

    def _evict_finished(self) -> None:
        """Trim the bounded finished-request registry, oldest first, never
        evicting a request an in-flight :meth:`run` has yet to return; warns
        on the first eviction and every 1024th."""
        while len(self.finished) > self._finished_bound:
            victim = next((rid for rid in self.finished if rid not in self._protected), None)
            if victim is None:
                return  # every resident request is protected
            self.finished.pop(victim)
            self.finished_evicted += 1
            if self.finished_evicted == 1 or self.finished_evicted % 1024 == 0:
                logger.warning(
                    "finished-request registry hit its bound (%d): "
                    "evicted request %d (%d evicted so far) — consume "
                    "results promptly or keep your own Request handles "
                    "from submit()",
                    self._finished_bound, victim, self.finished_evicted,
                )

    def _decode_span(self):
        """Span bucket for one decode window: every decoding slot's
        resident length plus the window's new positions; ``None`` (the
        whole ``maxlen`` row) for the naive oracle."""
        if self.attention != "flash":
            return None
        m = max(len(r.prompt) + len(r.tokens) - 1 for r in self.scheduler.active.values())
        n = max(1, min(self.maxlen, m + self.steps_per_sync))
        return span_bucket_for(n, self._sbuckets)

    def _set_active(self, slot: int, value: bool) -> None:
        if bool(self._active_host[slot]) != value:
            self._active_host[slot] = value
            self._active_dirty = True

    def _sync_active(self):
        if self._active_dirty:
            self._active_dev = torch.from_numpy(self._active_host.copy()).to(self.device)
            self._active_dirty = False
        return self._active_dev

    # -- device work ----------------------------------------------------

    @torch.inference_mode()
    def _prefill_wave(self, admitted: list[Request]) -> None:
        """Prefill one admission wave: one forward per prompt bucket over
        the wave's requests of that bucket, the first token of each
        sampled from its prompt-end logits."""
        by_bucket: dict[int, list[Request]] = {}
        for req in admitted:
            by_bucket.setdefault(self.scheduler.bucket_for(len(req.prompt)), []).append(req)
        dev = self.device
        for bucket in sorted(by_bucket):
            reqs = by_bucket[bucket]
            rows = np.zeros((len(reqs), bucket), np.int64)
            for i, req in enumerate(reqs):
                rows[i, : len(req.prompt)] = req.prompt
            slots = torch.tensor([r.slot for r in reqs], dtype=torch.long, device=dev)
            p_lens = torch.tensor([len(r.prompt) for r in reqs], dtype=torch.int32, device=dev)
            temps = torch.tensor([r.temperature for r in reqs], dtype=torch.float32, device=dev)
            logits = prefill_forward(self.model, torch.from_numpy(rows).to(dev), self.arena,
                                     slots, self.attention)
            last_logits = logits[torch.arange(len(reqs), device=dev), p_lens.long() - 1]
            firsts = _sample_dynamic(last_logits, self._generator, temps, self.top_k, self.top_p)
            self._lengths[slots] = p_lens
            self._last[slots] = firsts
            self._temps[slots] = temps
            toks = firsts.cpu().numpy()
            for i, req in enumerate(reqs):
                self._set_active(req.slot, True)
                self._emit(req, int(toks[i]))

    def _admit_wave(self, plan) -> list[tuple[Request, int, bool]]:
        """Execute one admission wave (the cold path: every admitted
        request prefills its whole prompt)."""
        cold = [a.req for a in plan]
        self._prefill_wave(cold)
        return [(req, req.tokens[-1], req.done) for req in cold]

    def step(self) -> list[tuple[Request, int, bool]]:
        """One engine iteration: admission of waiting requests into free
        slots (prefill), then one arena-wide decode window of
        ``steps_per_sync`` steps. Returns ``(request, token, done)``
        triples in generation order; ``done`` is per TOKEN, True only on a
        request's final token."""
        emitted: list[tuple[Request, int, bool]] = []
        plan = self.scheduler.admit()
        if plan:
            emitted.extend(self._admit_wave(plan))
        if self.scheduler.active:
            emitted.extend(self._decode_window())
        return emitted

    @torch.inference_mode()
    def _decode_window(self):
        """One arena-wide decode window of ``steps_per_sync`` steps; the
        host reads its tokens once, at the end."""
        span = self._decode_span()
        active = self._sync_active()
        maxlen = self.maxlen
        lengths, last = self._lengths, self._last
        window = torch.empty(self.steps_per_sync, self.num_slots, dtype=torch.long,
                             device=self.device)
        for i in range(self.steps_per_sync):
            positions = torch.clamp(lengths, max=maxlen - 1)
            logits = token_decode_step(self.model, last, positions, self.arena, active,
                                       self.attention, span)
            sampled = _sample_dynamic(logits, self._generator, self._temps, self.top_k,
                                      self.top_p)
            lengths = torch.where(active, torch.clamp(lengths + 1, max=maxlen), lengths)
            last = torch.where(active, sampled, last)
            window[i] = sampled
        self._lengths, self._last = lengths, last
        toks = window.cpu().numpy()  # [steps_per_sync, num_slots]
        emitted: list[tuple[Request, int, bool]] = []
        for i in range(self.steps_per_sync):
            if not self.scheduler.active:
                break  # the window's tail decoded for empty slots
            self.scheduler.note_step()
            for slot, req in sorted(self.scheduler.active.items()):
                done = self._emit(req, int(toks[i, slot]))
                emitted.append((req, req.tokens[-1], done))
        return emitted

    # -- running the engine ---------------------------------------------

    def stream(self):
        """Drive the engine until the queue drains, yielding
        ``(request_id, token, done)`` as tokens land. More requests may be
        submitted while consuming (they join the next admission wave)."""
        while self.scheduler.has_work:
            for req, token, done in self.step():
                yield req.rid, token, done

    def run(self, requests=None) -> dict[int, np.ndarray]:
        """Optionally submit ``requests`` (``(prompt, max_new_tokens)``
        pairs or kwargs dicts), drive the engine until idle, and return
        ``{request_id: prompt + generated tokens}``. Requests submitted
        through this call are not evicted from the finished registry
        before it returns."""
        submitted: list[Request] = []
        for r in requests or ():
            if isinstance(r, dict):
                submitted.append(self.submit(**r))
            else:
                prompt, max_new = r
                submitted.append(self.submit(prompt, max_new))
        protected = {r.rid for r in submitted} - self._protected
        self._protected |= protected
        try:
            drained: dict[int, np.ndarray] = {}
            while self.scheduler.has_work:
                for req, _tok, done in self.step():
                    if done:
                        drained[req.rid] = np.asarray(req.full_sequence, np.int32)
        finally:
            self._protected -= protected
            self._evict_finished()
        return drained

    def cancel(self, rid: int) -> bool:
        """Abort one request and reclaim its slot now: a waiting request
        leaves the queue, an active one frees its slot (host bookkeeping
        only). Returns True when the rid was live (``req.done`` flips True
        with ``req.error`` a :class:`RequestCancelled`; tokens so far are
        kept, and a live ``on_token`` gets ``(None, True)``), False when it
        was unknown or already finished."""
        rid = int(rid)
        sched = self.scheduler
        req = sched.remove_waiting(rid)
        if req is None:
            slot = next((s for s, r in sched.active.items() if r.rid == rid), None)
            if slot is None:
                return False
            req = sched.reclaim(slot)
            self._set_active(slot, False)
        req.done = True
        req.error = RequestCancelled(f"request {rid} cancelled")
        if req.on_token is not None:
            try:
                req.on_token(None, True)
            except Exception:
                logger.warning("request %d stream-end callback failed", rid, exc_info=True)
        self.cancelled += 1
        self.finished[rid] = req
        self._evict_finished()
        return True

    # -- introspection -------------------------------------------------

    @staticmethod
    def _percentiles(xs) -> dict:
        """``{p50, p99, n}`` summary (seconds) of a latency sample."""
        if not xs:
            return {"p50": None, "p99": None, "n": 0}
        return {
            "p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)),
            "n": len(xs),
        }

    def stats(self) -> dict:
        """Serving counters: generated tokens, decode steps, mean slot
        occupancy, per-request latencies, TTFT (submit → first token) and
        inter-token percentiles of the finished requests, and decode-only
        tokens/s (each request's first-to-last token window)."""
        finished = list(self.finished.values())
        lat = [
            r.finish_time - r.submit_time
            for r in finished
            if r.finish_time is not None and r.submit_time is not None
        ]
        ttfts = [r.ttft for r in finished if r.ttft is not None]
        itls = [d for r in finished for d in r.inter_token_times]
        d_toks = sum(len(r.token_times) - 1 for r in finished if len(r.token_times) > 1)
        d_secs = sum(
            r.token_times[-1] - r.token_times[0] for r in finished if len(r.token_times) > 1
        )
        return {
            "total_generated": self.total_generated,
            "attention": self.attention,
            "decode_steps": self.scheduler._steps,
            "occupancy": self.scheduler.occupancy,
            "latencies": lat,
            "finished": self.finished_count,
            "finished_evicted": self.finished_evicted,
            "num_slots": self.num_slots,
            "ttft_s": self._percentiles(ttfts),
            "inter_token_s": self._percentiles(itls),
            "queue_depth": len(self.scheduler.waiting),
            "decode_tok_s": (d_toks / d_secs) if d_secs > 0 else None,
            "cancelled": self.cancelled,
        }
