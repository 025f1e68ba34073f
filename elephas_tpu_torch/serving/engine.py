"""InferenceEngine — the continuous-batching serving loop.

Counterpart of ``elephas_tpu/serving/engine.py``, single device: the fixed
slot arena or the paged block pool (``paged=True``, with preemption and
int8 / int4 KV), whole-prompt or chunked prefill, the prefix cache,
``attention="flash"`` (or ``"naive"``, the parity oracle), and
:meth:`InferenceEngine.score`. One engine wraps one causal
:func:`~elephas_tpu_torch.transformer_lm` or
:func:`~elephas_tpu_torch.switch_transformer_lm` and serves any number of
generation requests through these kinds of device work:

- **prefill**, one forward per prompt-length bucket of an admission wave
  (:func:`~elephas_tpu_torch.serving.kv_cache.prefill_forward`; the flash
  forward kernel on the card), writing each prompt's K/V into its leased
  slot;
- **chunks** (:func:`~elephas_tpu_torch.serving.kv_cache.\
chunked_prefill_forward`; the span-chunk kernel on the card): with
  ``prefill_chunk`` every prompt streams in chunks under a per-step token
  budget between decode windows, and a prefix-cache hit prefills only its
  suffix after :func:`~elephas_tpu_torch.serving.kv_cache.prefix_copy`
  has copied the donor's rows;
- a **decode window** of ``steps_per_sync`` steps over the whole arena
  (:func:`~elephas_tpu_torch.serving.kv_cache.token_decode_step`; the
  span-decode kernel on the card), each advancing every in-flight sequence
  by one token at its own position. Within a window the tokens stay on the
  device: a step's input is the previous step's sampled tensor, and the
  host reads the window once.

The paged arena (:mod:`~elephas_tpu_torch.serving.paged_kv`) replaces the
slot rows by block tables into one pool: every prefill is a chunk pass
(:func:`~elephas_tpu_torch.serving.paged_kv.paged_chunk_forward`; the paged
span-chunk kernel on the card) from the prompt's start or from the end of
its copy-free prefix splice, every decode step a paged step
(:func:`~elephas_tpu_torch.serving.paged_kv.paged_token_decode_step`; the
paged span-decode kernel). With ``preemption=True`` a higher-priority
arrival swaps lower-priority requests' blocks out to pinned host memory
and they resume bit for bit.

With ``speculative=True`` a decode phase is a **verify round** on either
arena: a drafter (:mod:`~elephas_tpu_torch.serving.speculative`) proposes
up to ``spec_k`` tokens a slot, one pass feeds every decoding slot's window
of ``spec_k + 1`` rows
(:func:`~elephas_tpu_torch.serving.kv_cache.verify_forward` or
:func:`~elephas_tpu_torch.serving.paged_kv.paged_verify_forward`; the
span-chunk kernels on the card), and the longest draft prefix the model
agrees with is accepted plus one bonus token; cursors roll back on the
host. A round where nobody drafted is a plain decode window. A
``policy`` (:mod:`~elephas_tpu_torch.serving.policy`) orders admission,
rejects at :meth:`InferenceEngine.submit` under overload and keeps
per-tenant and SLO counts; it never touches decoding.

The Switch LM's routed experts run inside each pass's block
(:class:`~elephas_tpu_torch.models.switch.MoeFFN`), with an expert
capacity from the tokens of that pass: a prefill wave's admitted rows
(``n · bucket``; the reference's engine routes ``num_slots · bucket``), a
chunk's ``n · C``, a verify round's window rows, a decode step's
``num_slots`` rows, idle slots included. Where tokens drop, the tokens
served depend on those populations; where ``k · capacity_factor ≥
num_experts`` nothing drops and the engine is token-exact with
``generate(kv_cache=True)`` and the reference, as the reference documents
its own contract. The routing makes no host synchronisation.

Each :meth:`InferenceEngine.step`: admit waiting requests into free slots
(offloads of preempted requests first, then resumes, copies and prefill),
spend the step's chunk budget, run one decode window over the slots whose
prefill is complete, reclaim slots that hit EOS or their token budget.
Requests may be submitted at any time and join the next step's admission
wave.

**Telemetry.** The engine registers the reference's ``elephas_serving_*``
series in the port's registry (:mod:`elephas_tpu_torch.telemetry`), traces
each request's lifecycle on the event tracer (``serve.submit`` →
``serve.admission_verdict`` → ``serve.admit`` → ``serve.prefill`` /
``serve.prefill_chunk`` → ``serve.first_token`` → ``serve.preempt`` /
``serve.resume`` / ``serve.spec_verify`` → ``serve.finish``, with spans
around each wave, chunk, window and verify round) and keeps the last
``flight_recorder`` (default 256) finished lifecycles for
:meth:`InferenceEngine.explain`; :meth:`InferenceEngine.scrape`,
:meth:`InferenceEngine.debug_snapshot` and
:meth:`InferenceEngine.release_telemetry` read and retire them, and
:class:`~elephas_tpu_torch.serving.gateway.Gateway` serves them over HTTP.
Two rules hold: every value recorded is a host value already at hand (the
engine reads the card once a window, a prefill wave and a verify round,
and telemetry adds no read), and no decision reads a series back:
``stats()``, the scheduler, the policy and the throttle keep their plain
counts, exact under null mode while the series read 0.
:meth:`InferenceEngine.export_request` and
:meth:`InferenceEngine.import_request` move a request between engines as a
migration record (:mod:`elephas_tpu_torch.fleet.migration`).

Parts of the reference with no counterpart here: the JAX compile set
(``compile_stats``, the ``compile_stats`` key of :meth:`debug_snapshot` and
the ``jit.compile`` spans; the eager port compiles no programs) and the
backend probe (``backend_fallback`` in :meth:`debug_snapshot` is always
``None``: the port has no fallback). Not ported yet, each raising
``NotImplementedError`` that names its ROADMAP.md item: the decode meshes
(``mesh``, ``batch_axes``, ``model_axis``, ``rules``: item 5, its 5c
remainder: head-sharded KV arenas; one-shot ``generate`` takes a mesh).

``sp_prefill=`` (a :class:`~elephas_tpu_torch.parallel.mesh.Mesh`, paged
engines) arms the sequence-parallel long-prompt prefill: a cold prompt of
at least ``sp_threshold`` tokens (default ``maxlen // 2``) runs one
ring- or Ulysses-sharded forward over the mesh's ``sp_axis``
(:mod:`elephas_tpu_torch.serving.sp_prefill`), its K/V land straight in the
slot's pool blocks, and it decodes unmeshed (``sp_mechanism="ring"`` has no
head-count constraint; ``"ulysses"`` needs ``num_heads % axis_size == 0``).
A prompt with no power-of-two pad length inside ``maxlen`` takes the
single-device path, with a warning. Its prefill-tokens observation carries
the bucket ``sp<S>``, and the trace a ``serve.sp_prefill`` span.

Weight generations: :meth:`InferenceEngine.refresh_weights` stamps the
generation served (``weight_version``: stats, scrape, explain, migration
records) and drops what the old weights computed (the prefix cache,
donations of prefills that straddle the change, a draft model's
frontiers); :meth:`InferenceEngine.load_weights` puts a pulled weight list
into the model first. The module's parameters are updated in place, so a
new generation goes in only between two steps (``step`` and the copy take
one lock): a step never reads two generations.
"""

from __future__ import annotations

import copy
import logging
import time
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.device import resolve_device
from elephas_tpu_torch.models.transformer import (
    _filter_logits,
    _is_neutral,
    validate_token_decode_model,
)
from elephas_tpu_torch.ops.flash_serving import span_bucket_for, span_buckets
from elephas_tpu_torch.serving.blocks import BlockAllocator
from elephas_tpu_torch.serving.kv_cache import (
    SlotKVCache,
    chunked_prefill_forward,
    prefill_forward,
    prefix_copy,
    token_decode_step,
    verify_forward,
)
from elephas_tpu_torch.serving.kv_quant import check_kv_dtype, quantize_rows
from elephas_tpu_torch.serving.locks import HandoffLock
from elephas_tpu_torch.serving.paged_kv import (
    PagedKVPool,
    blocks_for,
    gather_blocks,
    paged_chunk_forward,
    paged_token_decode_step,
    paged_verify_forward,
    scatter_blocks,
    table_bucket_for,
    table_buckets,
)
from elephas_tpu_torch.serving.policy import DEFAULT_TENANT, AdmissionRejected, Policy
from elephas_tpu_torch.serving.scheduler import Request, Scheduler, default_buckets
from elephas_tpu_torch.serving.sp_prefill import sp_pad_len, sp_prefill_forward
from elephas_tpu_torch.serving.speculative import AcceptanceThrottle, resolve_drafter

logger = logging.getLogger(__name__)

_TODO = "InferenceEngine({}) is not ported yet (ROADMAP.md, Queue A item {})"


class RequestCancelled(RuntimeError):
    """Set as ``req.error`` when :meth:`InferenceEngine.cancel` reclaims
    an in-flight request: the request is ``done`` without completing, its
    tokens-so-far kept for the caller."""


class _OffloadRecord:
    """A preempted request's K/V on the host: ``rows`` is ``{layer: leaves}``
    at the pool's stored dtype (fp ``(k, v)`` or ``(kq, vq, k_scale,
    v_scale)``), each ``[n_blocks, block_size, ...]`` (pinned memory when the
    pool is on a card), with the cursor of a bit-exact resume."""

    __slots__ = ("rows", "n_blocks", "cur_len")

    def __init__(self, rows, n_blocks, cur_len):
        self.rows = rows
        self.n_blocks = int(n_blocks)
        self.cur_len = int(cur_len)

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for leaves in self.rows.values()
                   for a in leaves)


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

    ``prefix_cache=True`` keeps finished requests' prompt K/V resident as
    donor slots under a deterministic radix index: a request sharing a
    prompt prefix (at least ``prefix_min_reuse`` tokens) pays one
    slot-to-slot copy plus a suffix-only prefill. ``prefill_chunk=c``
    splits prefill into ``c``-token chunks run under a per-step token
    budget (``prefill_budget``, default one chunk) between decode windows,
    so a long prompt no longer stalls every in-flight request's next
    token. Both compose; temperature-0 tokens are those of the engine
    without them.

    ``paged=True`` serves from a pool of ``num_blocks`` blocks of
    ``block_size`` positions (default 16, and enough blocks for every slot
    to hold ``maxlen``): a request reserves the blocks of its prompt and
    budget, prefix hits share full blocks by refcount, and a request that
    can never fit is rejected at :meth:`submit`. ``preemption=True`` lets an
    arrival of higher ``priority`` swap lower ones out to the host.
    ``kv_dtype`` ``"int8"`` / ``"int4"`` stores the pool quantized with
    per-(position, head) scales (``"fp"``, the default, is the parity
    oracle). The five keywords take the reference's validation.

    ``speculative=True`` decodes draft-and-verify: ``spec_drafter``
    (``"ngram"`` prompt lookup by default, a port LM module as a draft
    model, or a :class:`~elephas_tpu_torch.serving.speculative.Drafter`)
    proposes up to ``spec_k`` (default 4) tokens a slot and one batched
    verify pass accepts the longest agreeing prefix plus a bonus token,
    token-exact with plain decode at temperature 0; a per-request
    acceptance throttle falls back to plain decode when drafts stop
    landing. ``policy`` (a :class:`~elephas_tpu_torch.serving.policy.Policy`)
    orders admission by tenant fair share, deadline and age, may refuse a
    submit under overload, and derives preemption priorities.

    ``flight_recorder`` keeps the last N finished request lifecycles for
    :meth:`explain` (0 or None: off; an engine built under telemetry null
    mode records none). Every other keyword of the reference is accepted:
    at the value that leaves the behaviour unchanged (the reference's
    default), any other value raising ``NotImplementedError`` that names
    its ROADMAP.md item."""

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
                 flight_recorder: int | None = 256,
                 device=None):
        layers = validate_token_decode_model(
            model, what="the serving engine", hint="use one-shot generate()"
        )
        # (name, value, the value that leaves the behaviour unchanged, item)
        unported = (
            ("mesh", mesh, None, "5: 5c"), ("batch_axes", batch_axes, ("data",), "5: 5c"),
            ("model_axis", model_axis, None, "5: 5c"), ("rules", rules, None, "5: 5c"),
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
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if not 0 < prefill_chunk <= self.maxlen:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} outside "
                    f"(0, maxlen={self.maxlen}]"
                )
        self.prefill_chunk = prefill_chunk
        if prefill_budget is not None:
            if prefill_chunk is None:
                raise ValueError(
                    "prefill_budget requires prefill_chunk — without "
                    "chunking, prefill is a single blocking wave and "
                    "the budget would be silently ignored"
                )
            if int(prefill_budget) < 1:
                raise ValueError(f"prefill_budget={prefill_budget} < 1")
        # prefill tokens a step() spends in chunked mode: one chunk by default
        self._prefill_budget = (
            int(prefill_budget) if prefill_budget is not None else (prefill_chunk or 0)
        )
        # the paged arena's knobs, validated as the reference does
        self.paged = bool(paged)
        if not self.paged:
            if block_size is not None or num_blocks is not None:
                raise ValueError(
                    "block_size/num_blocks require paged=True — the "
                    "fixed arena has no blocks, silently ignoring the "
                    "knobs would misreport capacity"
                )
            if preemption:
                raise ValueError(
                    "preemption requires paged=True — the fixed arena "
                    "has no block pool to swap out of"
                )
            self.block_size = None
            self.num_blocks = None
        else:
            bs = 16 if block_size is None else int(block_size)
            if not 0 < bs <= self.maxlen:
                raise ValueError(
                    f"block_size={bs} outside (0, maxlen={self.maxlen}]"
                )
            self.block_size = bs
            # blocks one request may need (a whole maxlen context); the
            # default pool lets every slot hold one
            self.max_blocks_per_slot = blocks_for(self.maxlen, bs)
            nb = (
                int(num_blocks) if num_blocks is not None
                else self.num_slots * self.max_blocks_per_slot
            )
            if nb < 1:
                raise ValueError(f"num_blocks={nb} < 1")
            self.num_blocks = nb
            self._tbuckets = table_buckets(self.max_blocks_per_slot)
        self.preemption = bool(preemption)
        check_kv_dtype(kv_dtype)
        if kv_dtype != "fp" and not self.paged:
            raise ValueError(
                "kv_dtype requires paged=True — the fixed slot arena "
                "has no quantized storage path; silently serving fp "
                "would misreport the KV byte budget"
            )
        self.kv_dtype = kv_dtype
        self.speculative = bool(speculative)
        if not self.speculative:
            if spec_k is not None or spec_drafter is not None:
                raise ValueError(
                    "spec_k/spec_drafter require speculative=True — "
                    "silently ignoring the knobs would misreport how "
                    "the engine decodes"
                )
            self.spec_k = None
        else:
            k = 4 if spec_k is None else int(spec_k)
            # the window feeds the last token and k drafts; the drafts a
            # round are capped so writes stay inside maxlen
            if not 1 <= k < self.maxlen:
                raise ValueError(
                    f"spec_k={k} outside [1, maxlen={self.maxlen})"
                )
            self.spec_k = k
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
        self._init_sp(sp_prefill, sp_axis, sp_threshold, sp_mechanism, layers)
        self.steps_per_sync = max(1, int(steps_per_sync))
        if policy is not None and not isinstance(policy, Policy):
            raise TypeError(
                f"policy must be a serving.policy.Policy (or None), "
                f"got {type(policy).__name__} — build one with "
                f"FairSharePolicy(tenants=...) or resolve_policy()"
            )
        self.policy = policy

        self._layers = layers
        if self.paged:
            self.arena = PagedKVPool(layers, self.num_blocks, self.block_size, self.device,
                                     self.kv_dtype)
        else:
            self.arena = SlotKVCache(layers, self.num_slots, self.maxlen, self.device)
        # the telemetry identity, captured before the allocator so its gauge
        # shares the engine's label (release_telemetry retires them
        # together); an engine built under null mode stays null for life
        treg = telemetry.registry()
        self._telemetry_registry = treg
        self._tracer = telemetry.tracer()
        eid = telemetry.instance_label()
        self.telemetry_label = eid
        if flight_recorder is not None and int(flight_recorder) < 0:
            raise ValueError(
                f"flight_recorder={flight_recorder} < 0 — use 0/None "
                f"to disable, or a positive record capacity"
            )
        fr_capacity = 0 if flight_recorder is None else int(flight_recorder)
        self._flight = (
            telemetry.FlightRecorder(fr_capacity)
            if fr_capacity and not telemetry.null_mode() else None
        )
        # in-flight lifecycle records (rid -> dict); finished ones move
        # into the bounded ring
        self._flight_live: dict[int, dict] = {}
        allocator = None
        if self.paged:
            allocator = BlockAllocator(
                self.num_blocks, self.block_size,
                free_gauge=treg.gauge(
                    "elephas_serving_blocks_free",
                    "Unleased KV pool blocks (paged arena)",
                    labels=("engine",),
                ).labels(engine=eid),
            )
        self.scheduler = Scheduler(self.num_slots, buckets or default_buckets(self.maxlen),
                                   prefix_cache=prefix_cache,
                                   prefix_min_reuse=prefix_min_reuse,
                                   allocator=allocator, preemption=preemption,
                                   policy=policy)
        # paged: the device block tables, restaged only when the scheduler's
        # tables or their bucket change; preempted requests' K/V on the host
        self._tables_cache: tuple | None = None
        self._offloaded: dict[int, _OffloadRecord] = {}
        # slots mid-chunked-prefill: slot -> [Admission, progress], progress
        # the prompt tokens already resident (a copied prefix included); the
        # slot decodes once progress == len(prompt)
        self._prefilling: dict[int, list] = {}
        # slots whose chunked prefill straddled refresh_weights(): their rows
        # mix two generations, so they decode but never donate a prefix
        self._stale_prefill: set[int] = set()
        # the one lock over this engine's serving state: step(), score(),
        # load_weights() and refresh_weights() take it, and so do the
        # callers above (a gateway's handlers, a fleet replica's submit,
        # probe and export). A step reads one generation of the module's
        # parameters; a driver stepping in a tight loop lets a waiting
        # caller in before its next step instead of re-taking it at once
        self.lock = HandoffLock()
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
        self.preemptions = 0
        self.resumes = 0
        self.offloaded_blocks = 0
        self.rejected = 0
        self.kv_quant_offload_bytes = 0
        self.score_requests = 0
        # speculative decoding: the drafter, the per-request acceptance
        # throttle, and the flag set when verify rounds left the device
        # cursors behind the host's (restaged before a plain window)
        self._drafter = (
            resolve_drafter(spec_drafter, num_slots=self.num_slots, maxlen=self.maxlen,
                            vocab=self.vocab) if self.speculative else None
        )
        self._spec_throttle = AcceptanceThrottle() if self.speculative else None
        self._spec_dirty = False
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rounds = 0
        self.spec_throttled = 0
        # the policy's refusals at submit, and per-tenant counts by label:
        # admitted, rejected, tokens, SLO met and missed
        self.admission_rejected = 0
        self._tenant_counts: dict[str, dict[str, int]] = {}
        self.migrated_out = 0
        self.migrated_in = 0
        self.kv_quant_export_bytes = 0
        # the weight generation served; refresh_weights stamps it
        self.weight_version = 0
        # the Gateway serving this engine, if any: close() stops it
        self.gateway = None
        self._register_series(treg, eid)

    def _register_series(self, treg, eid: str) -> None:
        """The engine's registry series: report-only mirrors of the plain
        counts above (names, help texts and labels as the reference's)."""
        def _c(name, help_):
            return treg.counter(name, help_, labels=("engine",)).labels(engine=eid)

        self._m_tokens = _c(
            "elephas_serving_tokens_generated_total",
            "Generated tokens emitted by the serving engine",
        )
        self._m_finished = _c(
            "elephas_serving_requests_finished_total",
            "Requests that completed (EOS or token budget)",
        )
        self._m_finished_evicted = _c(
            "elephas_serving_finished_evicted_total",
            "Finished requests evicted from the bounded result registry "
            "before the caller consumed them",
        )
        self._m_decode_windows = _c(
            "elephas_serving_decode_windows_total",
            "Arena-wide decode window dispatches",
        )
        self._m_prefill_stalls = _c(
            "elephas_serving_prefill_stall_slots_total",
            "Mid-prefill slots deferred to a later step because the "
            "per-step chunk-token budget was exhausted",
        )
        self._m_ttft = treg.histogram(
            "elephas_serving_ttft_seconds",
            "Submit-to-first-token latency of served requests",
            labels=("engine",),
        ).labels(engine=eid)
        self._m_itl = treg.histogram(
            "elephas_serving_inter_token_seconds",
            "Arrival gap between consecutive tokens of one request",
            labels=("engine",),
        ).labels(engine=eid)
        self._m_preemptions = _c(
            "elephas_serving_preemptions_total",
            "Requests preempted (blocks offloaded to host) so a "
            "higher-priority arrival could admit",
        )
        self._m_resumes = _c(
            "elephas_serving_resumes_total",
            "Preempted requests restored from host offload",
        )
        self._m_offload_blocks = _c(
            "elephas_serving_offloaded_blocks_total",
            "KV pool blocks swapped to host memory by preemption",
        )
        self._m_rejected = _c(
            "elephas_serving_rejected_total",
            "Requests rejected at submit because prompt + "
            "max_new_tokens can never fit the block pool",
        )
        self._m_spec_drafted = _c(
            "elephas_serving_spec_draft_tokens_total",
            "Drafted tokens scored by the speculative verify forward",
        )
        self._m_spec_accepted = _c(
            "elephas_serving_spec_accepted_tokens_total",
            "Drafted tokens accepted by the longest-matching-prefix "
            "rule (each saved one target-model decode step)",
        )
        self._m_spec_rounds = _c(
            "elephas_serving_spec_verify_rounds_total",
            "Batched speculative verify dispatches",
        )
        self._m_spec_throttled = _c(
            "elephas_serving_spec_throttled_total",
            "Times a request's collapsed acceptance rate tripped the "
            "drafting throttle (fell back to plain decode)",
        )
        self._m_admission_rejected = _c(
            "elephas_serving_admission_rejected_total",
            "Requests rejected at submit by the policy's overload "
            "admission control (429 on the gateway)",
        )
        self._m_cancelled = _c(
            "elephas_serving_cancelled_total",
            "In-flight requests cancelled before completion "
            "(slot/blocks reclaimed; gateway client disconnects land "
            "here)",
        )
        self._m_migrated_out = _c(
            "elephas_serving_migrated_out_total",
            "Requests exported off this engine as migration records "
            "(fleet drain / rebalancing)",
        )
        self._m_migrated_in = _c(
            "elephas_serving_migrated_in_total",
            "Requests adopted from another replica's migration record",
        )
        self._m_offload_bytes = _c(
            "elephas_serving_kv_quant_offload_bytes_total",
            "Host bytes written by preemption offload records (KV "
            "block rows + scales at the arena's stored kv_dtype)",
        )
        self._m_export_bytes = _c(
            "elephas_serving_kv_quant_export_bytes_total",
            "Payload bytes of migration/handoff export records "
            "(per-layer arrays at the stored kv_dtype, header "
            "excluded) — the counted wire-size the bench quant "
            "section gates on",
        )
        self._m_score_requests = _c(
            "elephas_serving_score_requests_total",
            "Completions scored through score() / POST /v1/score "
            "(one verify-style forward each, engine state untouched)",
        )

        def _tc(name, help_):
            return treg.counter(name, help_, labels=("engine", "tenant"))

        # the per-tenant families by the key of _count
        self._mf_tenant = {
            "tokens": _tc("elephas_serving_tenant_tokens_total",
                          "Generated tokens emitted, by tenant"),
            "admitted": _tc("elephas_serving_tenant_admitted_total",
                            "Requests admitted into KV slots, by tenant"),
            "rejected": _tc("elephas_serving_tenant_rejected_total",
                            "Requests rejected at submit, by tenant (admission "
                            "control and paged never-fit alike)"),
            "slo_met": _tc("elephas_serving_slo_met_total",
                           "First tokens that landed within their declared TTFT "
                           "deadline, by tenant"),
            "slo_missed": _tc("elephas_serving_slo_missed_total",
                              "First tokens that landed after their declared TTFT "
                              "deadline, by tenant"),
        }
        tenant_queue = treg.gauge(
            "elephas_serving_tenant_queue_depth",
            "Waiting requests queued, by tenant",
            labels=("engine", "tenant"),
        )
        if self.policy is not None:
            # pull-time gauges over the live queue, through a weak reference:
            # the process registry must not keep a dropped engine's
            # scheduler alive
            sched = weakref.ref(self.scheduler)
            for t in self.policy.tenant_names:
                tenant_queue.labels(engine=eid, tenant=t).set_function(
                    lambda t=t: sched().waiting_count(t) if sched() is not None else 0)
                # the zero-valued children exist before the first request
                for fam in self._mf_tenant.values():
                    fam.labels(engine=eid, tenant=t)
        treg.gauge(
            "elephas_serving_attn_kernel",
            "Attention kernel the serving programs run (info gauge: "
            "constant 1, kernel name in the label)",
            labels=("engine", "kernel"),
        ).labels(engine=eid, kernel=self.attention).set(1)
        treg.gauge(
            "elephas_serving_kv_quant_mode",
            "KV storage dtype of the paged arena (info gauge: "
            "constant 1, dtype name in the label)",
            labels=("engine", "kv_dtype"),
        ).labels(engine=eid, kv_dtype=self.kv_dtype).set(1)
        self._g_weight_version = treg.gauge(
            "elephas_serving_weight_version",
            "Weight generation the engine currently serves "
            "(0 = unversioned; stamped by refresh_weights(version=))",
            labels=("engine",),
        ).labels(engine=eid)
        self._g_weight_version.set(self.weight_version)
        self._mf_prefill_tokens = treg.histogram(
            "elephas_serving_prefill_tokens",
            "Prompt tokens ingested per completed prefill, by prompt "
            "size class (the prompt-bucket ladder; sp<S> = sequence-"
            "parallel padded length). NOTE: chunked/paged prefills "
            "compile per chunk width, not per prompt bucket — this "
            "label classifies the PROMPT, not the program.",
            labels=("engine", "bucket"),
        )
        treg.gauge(
            "elephas_serving_slots", "KV-cache slots in the arena",
            labels=("engine",),
        ).labels(engine=eid).set(self.num_slots)
        treg.gauge(
            "elephas_serving_kv_arena_bytes",
            "Host-side size estimate of the full KV arena at its "
            "stored dtype (f32, or int8/int4 codes + scales)",
            labels=("engine",),
        ).labels(engine=eid).set(self.arena.nbytes())
        if self.paged:
            treg.gauge(
                "elephas_serving_kv_blocks",
                "KV pool blocks in the paged arena",
                labels=("engine",),
            ).labels(engine=eid).set(self.num_blocks)

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        """Stop the attached gateway (``engine.gateway``), if any: its live
        SSE connections are severed, its port released, its threads
        joined. Idempotent; the engine itself stays usable in process."""
        gw = self.gateway
        if gw is not None:
            self.gateway = None
            gw.stop()

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
        validates them on an engine without a policy; ``priority`` matters
        only with ``preemption=True``.

        Paged: a request whose prompt and budget can never fit the block
        pool comes back ``done`` with ``req.error`` a ``RuntimeError``, never
        queued."""
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
        # ladder may top out below the model's maxlen (chunked prefill pads
        # to no prompt bucket)
        if not self.prefill_chunk:
            self.scheduler.bucket_for(p)
        if priority and not self.preemption:
            logger.warning(
                "submit(priority=%d) on an engine without "
                "preemption=True — priority is recorded but IGNORED "
                "(admission stays FIFO); serve with paged=True, "
                "preemption=True for priority scheduling", priority,
            )
        if tenant is not None:
            if self.policy is None:
                raise ValueError(
                    f"submit(tenant={tenant!r}) on an engine without a "
                    f"policy — serve with policy=/tenants= to declare "
                    f"tenants before accounting requests under them"
                )
            if not self.policy.knows(tenant):
                raise ValueError(
                    f"unknown tenant {tenant!r} — declared tenants: "
                    f"{sorted(self.policy.tenants) or '[none]'} (plus "
                    f"the implicit {DEFAULT_TENANT!r})"
                )
        if ttft_deadline_ms is not None:
            if not float(ttft_deadline_ms) > 0:
                raise ValueError(
                    f"ttft_deadline_ms={ttft_deadline_ms} must be "
                    f"positive — a deadline at or before submit time "
                    f"can never be met"
                )
            if self.policy is None or not self.policy.reads_deadlines:
                raise ValueError(
                    "submit(ttft_deadline_ms=) needs a deadline-aware "
                    "policy (e.g. FairSharePolicy) — this engine's "
                    "policy never reads deadlines, so the knob would "
                    "be a silent no-op"
                )
        req = self.scheduler.make_request(
            prompt, max_new_tokens, temperature=temperature, eos_id=eos_id,
            on_token=on_token, priority=priority, tenant=tenant,
            ttft_deadline_ms=ttft_deadline_ms,
        )
        req.submit_time = time.perf_counter()
        # the rid is the request's trace identity from here on
        req.submit_step = self.scheduler._steps
        req.exemplar = {"rid": str(req.rid)}
        rec = self._fr_new(req)
        submit_seq = self._tracer.emit(
            "serve.submit", rid=req.rid,
            tenant=DEFAULT_TENANT if tenant is None else str(tenant),
            prompt_tokens=p, max_new_tokens=int(max_new_tokens),
            step=req.submit_step,
        )
        if rec is not None:
            rec["submit_seq"] = submit_seq
        if self.paged:
            need = blocks_for(p + max_new_tokens, self.block_size)
            if need > self.num_blocks:
                # it would wait at the queue head forever: reject it now
                req.error = RuntimeError(
                    f"request {req.rid} needs {need} KV blocks "
                    f"(prompt {p} + max_new_tokens {max_new_tokens} "
                    f"at block_size {self.block_size}) but the pool "
                    f"only has {self.num_blocks} — it can never be "
                    f"admitted; rejected at submit"
                )
                req.done = True
                self.rejected += 1
                self._m_rejected.inc()
                self._count(tenant, "rejected")
                logger.warning("%s", req.error)
                self._fr_finish(req, "rejected_capacity")
                self.finished[req.rid] = req
                self._evict_finished()
                return req
        if self.policy is not None:
            # overload admission control: the policy sees the queue's
            # outstanding token debt and may shed this request now
            tenant_debt = self.scheduler.queued_tokens_for(tenant)
            verdict = self.policy.admission_verdict(
                req, self.scheduler.queued_tokens, tenant_debt,
            )
            # the fairness state the verdict was made against rides along
            self._tracer.emit(
                "serve.admission_verdict", rid=req.rid,
                admitted=verdict.admitted, reason=verdict.reason,
                queued_tokens=self.scheduler.queued_tokens,
                tenant_queued_tokens=tenant_debt,
            )
            if rec is not None:
                rec["verdict"] = {
                    "admitted": verdict.admitted,
                    "reason": verdict.reason,
                    "retry_after_s": verdict.retry_after_s,
                    "queued_tokens": self.scheduler.queued_tokens,
                    "tenant_queued_tokens": tenant_debt,
                    "virtual_counters": self.policy.snapshot_counters(),
                }
            if not verdict.admitted:
                req.error = AdmissionRejected(
                    f"request {req.rid} rejected by "
                    f"{type(self.policy).__name__}: {verdict.reason}; "
                    f"retry after {verdict.retry_after_s:.1f}s",
                    retry_after_s=verdict.retry_after_s,
                )
                req.done = True
                self.admission_rejected += 1
                self._m_admission_rejected.inc()
                self._count(tenant, "rejected")
                logger.warning("%s", req.error)
                self._fr_finish(req, "rejected_admission")
                self.finished[req.rid] = req
                self._evict_finished()
                return req
        return self.scheduler.submit(req)

    def _count(self, tenant, key: str) -> None:
        """Bump one per-tenant count (``tenant`` None: the default
        tenant) and its tenant-labeled series."""
        label = DEFAULT_TENANT if tenant is None else str(tenant)
        counts = self._tenant_counts.setdefault(label, {})
        counts[key] = counts.get(key, 0) + 1
        self._mf_tenant[key].labels(engine=self.telemetry_label, tenant=label).inc()

    # -- request lifecycle records --------------------------------------

    def _fr(self, rid: int) -> dict | None:
        """The request's lifecycle record: in flight first, then the
        finished ring (late entries, such as the verify round that ended the
        request, land there). None when recording is off or the record was
        evicted."""
        if self._flight is None:
            return None
        rec = self._flight_live.get(rid)
        return rec if rec is not None else self._flight.get(rid)

    def _fr_new(self, req: Request) -> dict | None:
        """Open one in-flight lifecycle record. Every key is set here and
        only reassigned later, so a reader without the engine lock always
        sees a dict of fixed shape."""
        if self._flight is None:
            return None
        rec = {
            "rid": req.rid,
            "tenant": req.tenant,
            "prompt_tokens": len(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature,
            "priority": req.priority,
            "ttft_deadline_ms": req.ttft_deadline_ms,
            "submit_step": req.submit_step,
            "submit_seq": -1,  # set from the serve.submit instant
            "weight_version": self.weight_version,
            "verdict": None,
            # first-admission mirrors; `admissions` keeps every entry
            "admission_kind": None,
            "reuse_len": 0,
            "queue_wait_steps": None,
            "admissions": [],
            "chunks": [],
            "sp_prefill": None,
            "preemptions": [],
            "resumes": [],
            "spec_rounds": [],
            "first_token": None,
            "token_steps": [],
            "tokens": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "finish": None,
        }
        self._flight_live[req.rid] = rec
        return rec

    def _fr_finish(self, req: Request, reason: str) -> None:
        """Emit ``serve.finish`` and file the request's record in the
        bounded ring."""
        seq = self._tracer.emit(
            "serve.finish", rid=req.rid, reason=reason,
            tokens=len(req.tokens), step=self.scheduler._steps,
        )
        if self._flight is None:
            return
        rec = self._flight_live.get(req.rid)
        if rec is None:
            return
        rec["finish"] = {
            "reason": reason,
            "step": self.scheduler._steps,
            "seq": seq,
            "error": None if req.error is None else str(req.error),
        }
        rec["tokens"] = len(req.tokens)
        rec["spec_drafted"] = req.spec_drafted
        rec["spec_accepted"] = req.spec_accepted
        # into the ring before leaving the live map: a reader between the
        # two stores finds the record in one of them
        self._flight.record(req.rid, rec)
        self._flight_live.pop(req.rid, None)

    def _trace_admissions(self, plan) -> None:
        """One ``serve.admit`` instant and record entry per admission of
        the wave: kind (cold, prefix_hit, resume), slot, reuse length and
        the queue wait in scheduler steps."""
        step = self.scheduler._steps
        for a in plan:
            if a.resume is not None:
                kind, reuse = "resume", 0
            elif a.donor_slot is not None or a.shared_len:
                kind, reuse = "prefix_hit", (a.reuse_len or a.shared_len)
            else:
                kind, reuse = "cold", 0
            req = a.req
            wait = step - req.submit_step if req.submit_step is not None else None
            seq = self._tracer.emit(
                "serve.admit", rid=req.rid, kind=kind, slot=a.slot,
                reuse_len=reuse, step=step, queue_wait_steps=wait,
            )
            rec = self._fr(req.rid)
            if rec is not None:
                rec["admissions"].append({
                    "kind": kind, "slot": a.slot, "reuse_len": reuse,
                    "step": step, "seq": seq,
                })
                if rec["admission_kind"] is None:
                    rec["admission_kind"] = kind
                    rec["reuse_len"] = reuse
                    rec["queue_wait_steps"] = wait

    # -- token bookkeeping ----------------------------------------------

    def _emit(self, req: Request, token: int) -> bool:
        """Record one generated token; reclaim and file the request when it
        finished. Returns done. A raising per-token callback fails the
        request cleanly: its slot is reclaimed and the engine goes on."""
        self.total_generated += 1
        self._m_tokens.inc()
        slot = req.slot
        now = time.perf_counter()
        req.token_times.append(now)
        rec = self._fr(req.rid) if self._flight is not None else None
        if rec is not None:
            rec["token_steps"].append(self.scheduler._steps)
        # the latency observations carry the rid as an exemplar
        if len(req.token_times) == 1:
            seq = self._tracer.emit("serve.first_token", rid=req.rid,
                                    step=self.scheduler._steps)
            if req.submit_time is not None:
                ttft = now - req.submit_time
                self._m_ttft.observe(ttft, exemplar=req.exemplar)
                if rec is not None:
                    # wall-derived, export-only
                    rec["first_token"] = {"step": self.scheduler._steps, "seq": seq,
                                          "ttft_s": ttft}
                if req.ttft_deadline_ms is not None:
                    # SLO attainment: the wall-clock TTFT meets the declared
                    # budget here only, never in the schedule
                    met = ttft * 1e3 <= req.ttft_deadline_ms
                    self._count(req.tenant, "slo_met" if met else "slo_missed")
        else:
            self._m_itl.observe(now - req.token_times[-2], exemplar=req.exemplar)
        if self.policy is not None:
            self.policy.on_token(req)
            self._count(req.tenant, "tokens")
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
            self._m_finished.inc()
            if req.error is not None:
                reason = "callback_error"
            elif req.eos_id is not None and req.tokens and req.tokens[-1] == req.eos_id:
                reason = "eos"
            else:
                reason = "budget"
            self._detach(req, reason)
            self.finished[req.rid] = req
            self._evict_finished()
        return done

    def _detach(self, req: Request, reason: str) -> None:
        """A request left the engine (finished, failed, cancelled or
        migrated): the policy's and the throttle's accounting of it drop
        and its record files with ``reason``."""
        if self.policy is not None:
            self.policy.on_finish(req)
        if self._spec_throttle is not None:
            self._spec_throttle.forget(req.rid)
        self._fr_finish(req, reason)

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
            self._m_finished_evicted.inc()
            self._tracer.emit("serve.evict", rid=victim)
            if self.finished_evicted == 1 or self.finished_evicted % 1024 == 0:
                logger.warning(
                    "finished-request registry hit its bound (%d): "
                    "evicted request %d (%d evicted so far) — consume "
                    "results promptly or keep your own Request handles "
                    "from submit()",
                    self._finished_bound, victim, self.finished_evicted,
                )

    def _fixed_span(self, max_pos_excl: int):
        """The smallest span bucket covering ``max_pos_excl`` resident
        positions; ``None`` (the whole ``maxlen`` row) for the naive
        oracle."""
        if self.attention != "flash":
            return None
        n = max(1, min(self.maxlen, int(max_pos_excl)))
        return span_bucket_for(n, self._sbuckets)

    def _decode_span(self):
        """Span bucket for one decode window: every decoding slot's
        resident length plus the window's new positions."""
        m = max((len(r.prompt) + len(r.tokens) - 1
                 for slot, r in self.scheduler.active.items() if slot not in self._prefilling),
                default=0)
        return self._fixed_span(m + self.steps_per_sync)

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

    def _prefill_wave(self, admitted: list[Request]) -> None:
        """Prefill one admission wave: one forward per prompt bucket over
        the wave's requests of that bucket, the first token of each
        sampled from its prompt-end logits."""
        with self._tracer.span("serve.prefill_wave", reqs=len(admitted)):
            self._prefill_wave_inner(admitted)

    def _note_prefill(self, req: Request, bucket) -> None:
        """One prefill-tokens observation per completed prefill, labeled by
        the prompt's bucket (its size class, not the pass that ran it)."""
        self._mf_prefill_tokens.labels(
            engine=self.telemetry_label, bucket=str(bucket)
        ).observe(len(req.prompt))

    @torch.inference_mode()
    def _prefill_wave_inner(self, admitted: list[Request]) -> None:
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
                # the prompt rows are resident: index them before _emit (a
                # one-token request reclaims inside it, and reclaim retains
                # only slots the cache knows)
                self.scheduler.on_prefill_complete(req)
                self._set_active(req.slot, True)
                self._note_prefill(req, bucket)
                seq = self._tracer.emit(
                    "serve.prefill", rid=req.rid, bucket=bucket,
                    prompt_tokens=len(req.prompt), step=self.scheduler._steps,
                )
                rec = self._fr(req.rid)
                if rec is not None:
                    # a whole-prompt wave is one chunk covering the prompt
                    rec["chunks"].append({"offset": 0, "take": len(req.prompt),
                                          "step": self.scheduler._steps, "seq": seq})
                self._emit(req, int(toks[i]))

    def _copy_vectors(self, copies):
        """``(src_idx, copy_mask, copy_len)`` device vectors of a wave's
        donor transplants."""
        src = np.zeros((self.num_slots,), np.int64)
        mask = np.zeros((self.num_slots,), bool)
        clen = np.zeros((self.num_slots,), np.int64)
        for a in copies:
            src[a.slot] = a.donor_slot
            mask[a.slot] = True
            clen[a.slot] = a.reuse_len
        return tuple(torch.from_numpy(v).to(self.device) for v in (src, mask, clen))

    @torch.inference_mode()
    def _copy_prefixes(self, copies) -> None:
        if copies:
            prefix_copy(self.arena, *self._copy_vectors(copies))

    def _run_chunk(self, items: list, width: int, copies=()):
        """One chunk pass: each ``(admission, progress, take)`` item
        advances ``take`` prompt tokens (``<= width``) of its slot from
        absolute offset ``progress``, after ``copies``' donor rows land.
        Items whose prompt completes sample their first token from their
        prompt-end logits and join decode. Only the items' slots are
        computed. Returns the ``(request, token, done)`` emissions of the
        finished prefills."""
        with self._tracer.span("serve.chunk", width=width, slots=len(items),
                               copies=len(copies)):
            return self._run_chunk_inner(items, width, copies)

    @torch.inference_mode()
    def _run_chunk_inner(self, items: list, width: int, copies):
        self._copy_prefixes(copies)
        n, dev = len(items), self.device
        rows = np.zeros((n, width), np.int64)
        offs = np.zeros((n,), np.int32)
        clens = np.zeros((n,), np.int32)
        for i, (adm, progress, take) in enumerate(items):
            rows[i, :take] = adm.req.prompt[progress:progress + take]
            offs[i], clens[i] = progress, take
            seq = self._tracer.emit(
                "serve.prefill_chunk", rid=adm.req.rid, offset=progress, take=take,
                final=progress + take == len(adm.req.prompt), step=self.scheduler._steps,
            )
            rec = self._fr(adm.req.rid)
            if rec is not None:
                rec["chunks"].append({"offset": progress, "take": take,
                                      "step": self.scheduler._steps, "seq": seq})
        slots = torch.tensor([a.slot for a, _p, _t in items], dtype=torch.long, device=dev)
        offs_d = torch.from_numpy(offs).to(dev)
        if self.paged:
            # the block tables carry the mapping, spliced prefix blocks too
            logits = paged_chunk_forward(self.model, torch.from_numpy(rows).to(dev), self.arena,
                                         self._staged_tables()[slots].contiguous(), offs_d,
                                         torch.from_numpy(clens).to(dev),
                                         attention=self.attention)
        else:
            # the attended row need only cover this call's deepest written
            # position: queries see the copied prefix and earlier chunks
            span = self._fixed_span(int((offs + clens).max()))
            logits = chunked_prefill_forward(self.model, torch.from_numpy(rows).to(dev),
                                             self.arena, offs_d,
                                             torch.from_numpy(clens).to(dev),
                                             attention=self.attention, span=span, slots=slots)
        fin = [i for i, (a, p, t) in enumerate(items) if p + t == len(a.req.prompt)]
        if not fin:
            return []
        idx = torch.tensor(fin, dtype=torch.long, device=dev)
        ends = torch.tensor([len(items[i][0].req.prompt) - items[i][1] - 1 for i in fin],
                            dtype=torch.long, device=dev)
        p_lens = torch.tensor([len(items[i][0].req.prompt) for i in fin], dtype=torch.int32,
                              device=dev)
        temps = torch.tensor([items[i][0].req.temperature for i in fin], dtype=torch.float32,
                             device=dev)
        firsts = _sample_dynamic(logits[idx, ends], self._generator, temps, self.top_k,
                                 self.top_p)
        fin_slots = slots[idx]
        self._lengths[fin_slots] = p_lens
        self._last[fin_slots] = firsts
        self._temps[fin_slots] = temps
        toks = firsts.cpu().numpy()
        emitted = []
        for j, i in enumerate(fin):
            req = items[i][0].req
            slot = items[i][0].slot
            self._prefilling.pop(slot, None)
            if slot in self._stale_prefill:
                # the prefill straddled refresh_weights(): its rows mix two
                # generations — decode fine, donate never
                self._stale_prefill.discard(slot)
            else:
                self.scheduler.on_prefill_complete(req)
            self._set_active(req.slot, True)
            self._note_prefill(req, self.scheduler.bucket_for(len(req.prompt)))
            self._emit(req, int(toks[j]))
            emitted.append((req, req.tokens[-1], req.done))
        return emitted

    def _admit_wave(self, plan) -> list[tuple[Request, int, bool]]:
        """Execute one admission wave. Without chunking: the bucketed
        whole-prompt prefill for the cold requests, and for the prefix hits
        their donor copies and one suffix chunk pass per suffix bucket.
        With chunking: the wave's copies land now (the donors are pinned
        only through this wave), and every admission queues for budgeted
        chunks."""
        emitted: list[tuple[Request, int, bool]] = []
        copies = [a for a in plan if a.donor_slot is not None]
        if self.prefill_chunk:
            self._copy_prefixes(copies)
            for a in plan:
                self._prefilling[a.slot] = [a, a.reuse_len]
            return emitted
        cold = [a.req for a in plan if a.donor_slot is None]
        if cold:
            self._prefill_wave(cold)
            emitted.extend((req, req.tokens[-1], req.done) for req in cold)
        by_width: dict[int, list] = {}
        for a in copies:
            suffix = len(a.req.prompt) - a.reuse_len
            by_width.setdefault(self.scheduler.bucket_for(suffix), []).append(
                (a, a.reuse_len, suffix))
        for width in sorted(by_width):
            emitted.extend(self._run_chunk(by_width[width], width,
                                           copies=[a for a, _p, _t in by_width[width]]))
        return emitted

    # -- the paged arena ------------------------------------------------

    def _staged_tables(self):
        """The scheduler's block tables on the device, ``[num_slots, T]``
        int32 for the table bucket ``T`` covering the longest live table,
        padded with the sentinel id (idle slots all sentinel); rebuilt only
        when the tables or the bucket change."""
        sched = self.scheduler
        need = max((len(t) for t in sched.tables.values()), default=1)
        t = table_bucket_for(need, self._tbuckets)
        key = (sched.tables_version, t)
        if self._tables_cache is None or self._tables_cache[0] != key:
            arr = np.full((self.num_slots, t), self.num_blocks, np.int32)
            for slot, table in sched.tables.items():
                arr[slot, : len(table)] = table
            self._tables_cache = (key, torch.from_numpy(arr).to(self.device))
        return self._tables_cache[1]

    def _host_copy(self, z):
        """``z`` into host memory: pinned, copied without a sync, when it is
        on a card (a later copy back on the same stream is ordered after
        it)."""
        if z.device.type == "cpu":
            return z
        out = torch.empty(z.shape, dtype=z.dtype, pin_memory=True)
        out.copy_(z, non_blocking=True)
        return out

    @torch.inference_mode()
    def _offload(self, pre) -> None:
        """Swap a preemption victim's blocks to host memory. Runs before any
        pool write of the step: the scheduler has already re-leased the
        blocks on paper, and the gather is enqueued on the stream ahead of
        every later write."""
        req = pre.req
        n = len(pre.blocks)
        with self._tracer.span("serve.preempt", rid=req.rid, blocks=n) as sp:
            rec = self._fr(req.rid)
            if rec is not None:
                rec["preemptions"].append({"blocks": n, "cur_len": pre.cur_len,
                                           "step": self.scheduler._steps,
                                           "seq": sp.begin_seq})
            ids = torch.tensor(pre.blocks, dtype=torch.long, device=self.device)
            rows = gather_blocks(self.arena, ids)
            store = _OffloadRecord(
                rows={name: tuple(self._host_copy(z) for z in leaves)
                      for name, leaves in rows.items()},
                n_blocks=n, cur_len=pre.cur_len,
            )
            self._offloaded[req.rid] = store
        self._set_active(pre.slot, False)
        self.preemptions += 1
        self.offloaded_blocks += n
        self.kv_quant_offload_bytes += store.nbytes()
        self._m_preemptions.inc()
        self._m_offload_blocks.inc(n)
        self._m_offload_bytes.inc(store.nbytes())
        logger.info(
            "preempted request %d (priority %d): %d blocks offloaded "
            "to host, slot %d freed", req.rid, req.priority, n, pre.slot,
        )

    @torch.inference_mode()
    def _resume(self, adm) -> None:
        """Restore an offloaded request into its new table's leading blocks
        and re-arm its slot's cursor, last token and temperature: the rows
        are bitwise the offloaded ones."""
        req = adm.req
        store = self._offloaded.pop(req.rid)
        n = store.n_blocks
        with self._tracer.span("serve.resume", rid=req.rid, blocks=n) as sp:
            rec = self._fr(req.rid)
            if rec is not None:
                rec["resumes"].append({"blocks": n, "cur_len": store.cur_len,
                                       "step": self.scheduler._steps, "seq": sp.begin_seq})
            ids = torch.tensor(adm.blocks[:n], dtype=torch.long, device=self.device)
            scatter_blocks(self.arena, ids, store.rows)
            self._lengths[adm.slot] = store.cur_len
            self._last[adm.slot] = req.tokens[-1]
            self._temps[adm.slot] = req.temperature
        self._set_active(adm.slot, True)
        self.resumes += 1
        self._m_resumes.inc()
        logger.info(
            "resumed request %d into slot %d (%d blocks restored, "
            "cursor %d)", req.rid, adm.slot, n, store.cur_len,
        )

    # -- sequence-parallel long-prompt prefill ----------------------------

    def _init_sp(self, sp_prefill, sp_axis, sp_threshold, sp_mechanism, layers) -> None:
        """Validate and keep the SP prefill's knobs, as the reference does:
        a paged engine, a mechanism it knows, an axis of the mesh of a
        power-of-two size, and for Ulysses a head count that axis
        divides."""
        if sp_prefill is not None:
            if not self.paged:
                raise ValueError(
                    "sp_prefill requires paged=True — the SP prefill "
                    "lands K/V into the block pool (the fixed arena "
                    "has no block-granular landing path)"
                )
            if sp_mechanism not in ("ring", "ulysses"):
                raise ValueError(
                    f"sp_mechanism must be 'ring' or 'ulysses', got "
                    f"{sp_mechanism!r}"
                )
            if sp_axis not in sp_prefill.shape:
                raise ValueError(
                    f"sp_axis {sp_axis!r} not in the SP mesh axes "
                    f"{tuple(sp_prefill.shape)}"
                )
            sp_w = int(sp_prefill.shape[sp_axis])
            if sp_w & (sp_w - 1):
                # pad lengths are powers of two (sp_pad_len), which a
                # non-power-of-two shard count divides none of: fail here,
                # not on the first long prompt
                raise ValueError(
                    f"sp_prefill axis {sp_axis!r} has size {sp_w} — "
                    f"SP prefill pads prompts to power-of-two "
                    f"lengths, which only tile over a power-of-two "
                    f"shard count; reshape the mesh"
                )
            if sp_mechanism == "ulysses":
                bad = [(name, int(attn.num_heads)) for name, attn in layers
                       if int(attn.num_heads) % sp_w]
                if bad:
                    raise ValueError(
                        f"ulysses SP prefill needs num_heads divisible "
                        f"by the seq axis size ({sp_w}); offending "
                        f"layers: {bad} — use sp_mechanism='ring'"
                    )
            if sp_threshold is not None and int(sp_threshold) < 1:
                raise ValueError(
                    f"sp_threshold={sp_threshold} < 1"
                )
        elif sp_threshold is not None or sp_axis != "seq" or sp_mechanism != "ring":
            raise ValueError(
                "sp_threshold/sp_axis/sp_mechanism require sp_prefill= "
                "(an SP mesh) — silently ignoring them would misreport "
                "how long prompts prefill"
            )
        self.sp_mesh = sp_prefill
        self.sp_axis = sp_axis
        self.sp_mechanism = sp_mechanism
        # prompts at or above the threshold prefill over the SP mesh;
        # default: half the model's context
        self.sp_threshold = (
            int(sp_threshold) if sp_threshold is not None else max(1, self.maxlen // 2)
        ) if sp_prefill is not None else None

    def _sp_eligible(self, a) -> bool:
        """Does this fresh admission take the sequence-parallel prefill?
        Long cold prompts only (a prefix hit's shared blocks already paid
        most of its prefill), and only when the SP pad length fits the
        model: else the single-device path, with a warning (silence would
        hide that the knob the caller reached for is not engaging)."""
        if self.sp_mesh is None or a.shared_len:
            return False
        p = len(a.req.prompt)
        if p < self.sp_threshold:
            return False
        if sp_pad_len(p, self.sp_mesh.shape[self.sp_axis], self.maxlen) is None:
            logger.warning(
                "sp_prefill: prompt of %d tokens has no power-of-two "
                "pad length inside maxlen=%d — falling back to the "
                "single-device prefill path for request %d",
                p, self.maxlen, a.req.rid,
            )
            return False
        return True

    @torch.inference_mode()
    def _sp_prefill(self, a) -> list[tuple[Request, int, bool]]:
        """Prefill one long prompt over the SP mesh: one sharded forward
        computes every position's K/V and logits, the rows land in the
        slot's own blocks (the preemption resume's scatter; quantized on
        the way for an int8 / int4 pool), and the first token samples from
        the prompt-end logits. Decode then goes on unmeshed, as after a
        chunk prefill (token-exact at temperature 0)."""
        req = a.req
        p = len(req.prompt)
        sp_w = int(self.sp_mesh.shape[self.sp_axis])
        s = sp_pad_len(p, sp_w, self.maxlen)
        bs = self.block_size
        n_res = blocks_for(p, bs)
        dev = self.device
        with self._tracer.span("serve.sp_prefill", rid=req.rid, prompt=p, padded=s,
                               shards=sp_w, mechanism=self.sp_mechanism) as sp:
            rec = self._fr(req.rid)
            if rec is not None:
                rec["sp_prefill"] = {"padded": int(s), "shards": sp_w,
                                     "mechanism": self.sp_mechanism,
                                     "step": self.scheduler._steps, "seq": sp.begin_seq}
            tokens = torch.zeros((1, s), dtype=torch.long)
            tokens[0, :p] = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long)
            logits, kv = sp_prefill_forward(self.model, tokens.to(dev), self.sp_mesh,
                                            self.sp_axis, self.sp_mechanism)
            # the rows of the reserved blocks: the prompt's, then rows the
            # request's own later writes cover before any read
            span = n_res * bs
            rows = {}
            for name, (k, v) in kv.items():
                if span <= s:
                    k, v = k[:span], v[:span]
                else:
                    pad = (0, 0, 0, 0, 0, span - s)
                    k, v = F.pad(k, pad), F.pad(v, pad)
                k, v = k.reshape(n_res, bs, *k.shape[1:]), v.reshape(n_res, bs, *v.shape[1:])
                if self.kv_dtype == "fp":
                    rows[name] = (k, v)
                else:
                    (kq, ks), (vq, vs) = (quantize_rows(z, self.kv_dtype) for z in (k, v))
                    rows[name] = (kq, vq, ks, vs)
            ids = torch.tensor(a.blocks[:n_res], dtype=torch.long, device=dev)
            scatter_blocks(self.arena, ids, rows)
            temps = torch.full((1,), req.temperature, dtype=torch.float32, device=dev)
            first = _sample_dynamic(logits[:, p - 1], self._generator, temps, self.top_k,
                                    self.top_p)
            self._lengths[a.slot] = p
            self._last[a.slot] = first[0]
            self._temps[a.slot] = temps[0]
            tok = int(first.cpu()[0])
        self.scheduler.on_prefill_complete(req)
        self._set_active(a.slot, True)
        self._note_prefill(req, f"sp{s}")
        self._emit(req, tok)
        return [(req, req.tokens[-1], req.done)]

    def _admit_wave_paged(self, plan) -> list[tuple[Request, int, bool]]:
        """Execute one paged admission wave: resumes restore their offloaded
        state, fresh admissions prefill their unshared suffix through the
        paged chunk pass: the whole suffix in one pass per prompt bucket, or
        budgeted chunks under ``prefill_chunk``. A prefix hit needs no copy:
        its shared blocks already sit in its table. Long cold prompts take
        the sequence-parallel path when ``sp_prefill`` is armed
        (:meth:`_sp_prefill`); chunk budgets do not apply to them (the SP
        forward is the bounded unit of work)."""
        emitted: list[tuple[Request, int, bool]] = []
        for a in plan:
            if a.resume is not None:
                self._resume(a)
        fresh = []
        for a in plan:
            if a.resume is not None:
                continue
            if self._sp_eligible(a):
                emitted.extend(self._sp_prefill(a))
            else:
                fresh.append(a)
        if self.prefill_chunk:
            for a in fresh:
                self._prefilling[a.slot] = [a, a.shared_len]
            return emitted
        by_width: dict[int, list] = {}
        for a in fresh:
            suffix = len(a.req.prompt) - a.shared_len
            by_width.setdefault(self.scheduler.bucket_for(suffix), []).append(
                (a, a.shared_len, suffix))
        for width in sorted(by_width):
            emitted.extend(self._run_chunk(by_width[width], width))
        return emitted

    def _prefill_progress(self):
        """Spend this step's prefill token budget on chunk passes: each
        mid-prefill slot advances by up to ``prefill_chunk`` tokens a pass,
        lowest slot first, until the budget (total tokens, not per slot)
        is spent or no slot is mid-prefill. Decode windows run between
        these slices."""
        emitted: list[tuple[Request, int, bool]] = []
        budget = self._prefill_budget
        served: set[int] = set()
        while self._prefilling and budget > 0:
            items = []
            for slot in sorted(self._prefilling):
                if budget <= 0:
                    break
                adm, progress = self._prefilling[slot]
                take = min(self.prefill_chunk, len(adm.req.prompt) - progress)
                items.append((adm, progress, take))
                served.add(slot)
                budget -= take
            emitted.extend(self._run_chunk(items, self.prefill_chunk))
            for adm, progress, take in items:
                if adm.slot in self._prefilling:
                    self._prefilling[adm.slot][1] = progress + take
        # slots that got no chunk this step wait for the next one
        stalled = sum(1 for s in self._prefilling if s not in served)
        if stalled:
            self._m_prefill_stalls.inc(stalled)
        return emitted

    def step(self) -> list[tuple[Request, int, bool]]:
        """One engine iteration: admission of waiting requests into free
        slots (prefix copies and prefill: whole-wave, or budgeted chunks),
        then one arena-wide decode window of ``steps_per_sync`` steps over
        the slots whose prefill is complete. Returns ``(request, token,
        done)`` triples in generation order; ``done`` is per TOKEN, True
        only on a request's final token. Runs under :attr:`lock`, so
        :meth:`load_weights` lands before or after it, never inside; a load
        already waiting goes first."""
        self.lock.yield_to_waiters()
        with self.lock:
            return self._step()

    def _step(self) -> list[tuple[Request, int, bool]]:
        emitted: list[tuple[Request, int, bool]] = []
        if self.paged:
            plan, preempts = self.scheduler.admit_paged(prefilling=frozenset(self._prefilling))
            # offloads first: the victims' rows are read before any resume
            # or prefill of this step writes the pool
            for pre in preempts:
                self._offload(pre)
            if plan:
                self._note_admissions(plan)
                self._trace_admissions(plan)
                emitted.extend(self._admit_wave_paged(plan))
        else:
            plan = self.scheduler.admit()
            if plan:
                self._note_admissions(plan)
                self._trace_admissions(plan)
                emitted.extend(self._admit_wave(plan))
        emitted.extend(self._prefill_progress())
        if any(slot not in self._prefilling for slot in self.scheduler.active):
            self._m_decode_windows.inc()
            if self.speculative:
                emitted.extend(self._spec_decode_phase())
            else:
                emitted.extend(self._decode_window())
        return emitted

    def _note_admissions(self, plan) -> None:
        """Per-tenant admitted counts: fresh admissions only (a resume
        was counted when it first took a slot)."""
        if self.policy is None:
            return
        for a in plan:
            if a.resume is None:
                self._count(a.req.tenant, "admitted")

    def _decode_window(self):
        """One arena-wide decode window of ``steps_per_sync`` steps; the
        host reads its tokens once, at the end. Paged, every step attends
        through the staged block tables. The speculative engine's fallback
        when no slot drafted."""
        if self._spec_dirty:
            self._refresh_decode_state()
        with self._tracer.span("serve.decode_window", steps=self.steps_per_sync,
                               active=len(self.scheduler.active)):
            return self._decode_window_inner()

    @torch.inference_mode()
    def _decode_window_inner(self):
        tables = self._staged_tables() if self.paged else None
        span = None if self.paged else self._decode_span()
        active = self._sync_active()
        maxlen = self.maxlen
        lengths, last = self._lengths, self._last
        window = torch.empty(self.steps_per_sync, self.num_slots, dtype=torch.long,
                             device=self.device)
        for i in range(self.steps_per_sync):
            positions = torch.clamp(lengths, max=maxlen - 1)
            if self.paged:
                logits = paged_token_decode_step(self.model, last, positions, self.arena,
                                                 tables, active, self.attention)
            else:
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
                if slot in self._prefilling:
                    continue  # mid-prefill: no decode tokens yet
                done = self._emit(req, int(toks[i, slot]))
                emitted.append((req, req.tokens[-1], done))
        return emitted

    # -- speculative decoding ---------------------------------------------

    def _refresh_decode_state(self) -> None:
        """Restage the device cursors and last tokens from the host's
        truth: verify rounds advance positions on the host only (resident
        length = prompt + generated - 1). Mid-prefill and idle slots get
        zeros; the active mask excludes them, and a chunk's finish sets
        their state on the device."""
        lengths = np.zeros((self.num_slots,), np.int32)
        last = np.zeros((self.num_slots,), np.int64)
        for slot, req in self.scheduler.active.items():
            if slot in self._prefilling or not req.tokens:
                continue
            lengths[slot] = len(req.prompt) + len(req.tokens) - 1
            last[slot] = req.tokens[-1]
        self._lengths = torch.from_numpy(lengths).to(self.device)
        self._last = torch.from_numpy(last).to(self.device)
        self._spec_dirty = False

    def _spec_decode_phase(self):
        """One speculative decode phase: drafts for every decoding slot
        (throttle- and budget-capped), then one verify round over the whole
        window, or, when nobody drafted, one plain decode window."""
        items = []
        for slot in sorted(self.scheduler.active):
            if slot in self._prefilling:
                continue
            req = self.scheduler.active[slot]
            remaining = req.max_new_tokens - len(req.tokens)
            cursor = len(req.prompt) + len(req.tokens) - 1
            # the window writes positions cursor .. cursor + drafts and
            # emits at most drafts + 1 tokens: cap the drafts to the row and
            # the budget (and, paged, the blocks reserved for them)
            k_cap = min(self.spec_k, remaining - 1, self.maxlen - 1 - cursor)
            if k_cap >= 1 and self._spec_throttle.should_draft(req.rid):
                items.append((slot, req, k_cap))
        proposals = self._drafter.propose_batch(items) if items else {}
        # a drafter may return more than its k, or drafts for a slot it was
        # not asked about: clip to each item's cap, drop the others
        caps = {slot: k for slot, _req, k in items}
        proposals = {slot: list(d)[: caps[slot]] for slot, d in proposals.items()
                     if slot in caps and d}
        drafted = sum(len(d) for d in proposals.values())
        if drafted == 0:
            return self._decode_window()
        return self._verify_round(proposals, drafted)

    def _verify_round(self, proposals, drafted: int):
        """One batched verify pass and its verdict: for each decoding slot,
        the longest draft prefix equal to the model's own tokens is accepted
        and emitted with the bonus token, and its cursor rolls back over the
        rejected tail on the host (the rejected rows' K/V is rewritten
        before any query sees it; paged, they lie in reserved blocks)."""
        slots = sum(1 for slot in self.scheduler.active if slot not in self._prefilling)
        with self._tracer.span("serve.verify", slots=slots, drafted=drafted,
                               k=self.spec_k) as span:
            emitted, accepted_total = self._verify_round_inner(proposals)
            span.set(accepted=accepted_total)
        self.spec_drafted += drafted
        self.spec_accepted += accepted_total
        self.spec_rounds += 1
        self._m_spec_drafted.inc(drafted)
        self._m_spec_accepted.inc(accepted_total)
        self._m_spec_rounds.inc()
        self._spec_dirty = True
        return emitted

    @torch.inference_mode()
    def _verify_round_inner(self, proposals):
        w = self.spec_k + 1
        # tokens | offset | n_fed | active, one upload
        packed = np.zeros((self.num_slots, w + 3), np.int64)
        verifying = []
        for slot in sorted(self.scheduler.active):
            if slot in self._prefilling:
                continue
            req = self.scheduler.active[slot]
            drafts = proposals.get(slot, [])
            packed[slot, 0] = req.tokens[-1]
            packed[slot, 1:1 + len(drafts)] = drafts
            packed[slot, w] = len(req.prompt) + len(req.tokens) - 1
            packed[slot, w + 1] = 1 + len(drafts)
            packed[slot, w + 2] = 1
            verifying.append((slot, req, drafts))
        dev = self.device
        staged = torch.from_numpy(packed).to(dev)
        tokens, offs = staged[:, :w], staged[:, w].to(torch.int32)
        n_fed, act = staged[:, w + 1].to(torch.int32), staged[:, w + 2] != 0
        if self.paged:
            logits = paged_verify_forward(self.model, tokens, self.arena, self._staged_tables(),
                                          offs, n_fed, act, self.attention)
        else:
            # the attended span covers the window's deepest write
            span = self._fixed_span(max(int(packed[s, w] + packed[s, w + 1])
                                        for s, _r, _d in verifying))
            logits = verify_forward(self.model, tokens, self.arena, offs, n_fed, act,
                                    self.attention, span)
        # one draw of the generator for the whole [num_slots * W] window
        sampled = _sample_dynamic(logits.reshape(self.num_slots * w, -1), self._generator,
                                  torch.repeat_interleave(self._temps, w), self.top_k,
                                  self.top_p)
        toks = sampled.view(self.num_slots, w).cpu().numpy()
        self.scheduler.note_step()
        emitted: list[tuple[Request, int, bool]] = []
        accepted_total = 0
        for slot, req, drafts in verifying:
            t = toks[slot]
            a = 0
            while a < len(drafts) and drafts[a] == int(t[a]):
                a += 1
            # the accepted drafts and the bonus token, in order; an EOS
            # inside the window ends the request there
            n_emitted = 0
            for j in range(a + 1):
                done = self._emit(req, int(t[j]))
                emitted.append((req, req.tokens[-1], done))
                n_emitted += 1
                if done:
                    break
            # only accepted drafts that were emitted saved a step
            a = min(a, n_emitted)
            accepted_total += a
            req.spec_drafted += len(drafts)
            req.spec_accepted += a
            if self._spec_throttle.note(req.rid, len(drafts), a):
                self.spec_throttled += 1
                self._m_spec_throttled.inc()
            throttled = self._spec_throttle.throttled(req.rid)
            seq = self._tracer.emit(
                "serve.spec_verify", rid=req.rid, drafted=len(drafts), accepted=a,
                throttled=throttled, step=self.scheduler._steps,
            )
            rec = self._fr(req.rid)
            if rec is not None:
                rec["spec_rounds"].append({"drafted": len(drafts), "accepted": a,
                                           "throttled": throttled,
                                           "step": self.scheduler._steps, "seq": seq})
                # a request that finished inside this round was filed before
                # these increments: the totals follow its own rounds
                rec["spec_drafted"] = req.spec_drafted
                rec["spec_accepted"] = req.spec_accepted
        return emitted, accepted_total

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
        leaves the queue (a preempted one drops its host offload), an active
        one frees its slot and, paged, its blocks (host bookkeeping only). Returns True when the rid was live (``req.done`` flips True
        with ``req.error`` a :class:`RequestCancelled`; tokens so far are
        kept, and a live ``on_token`` gets ``(None, True)``), False when it
        was unknown or already finished."""
        rid = int(rid)
        sched = self.scheduler
        req = sched.remove_waiting(rid)
        if req is not None:
            self._offloaded.pop(rid, None)
        else:
            slot = next((s for s, r in sched.active.items() if r.rid == rid), None)
            if slot is None:
                return False
            self._prefilling.pop(slot, None)
            self._stale_prefill.discard(slot)
            req = sched.reclaim(slot)
            self._set_active(slot, False)
        req.done = True
        req.error = RequestCancelled(f"request {rid} cancelled")
        # a live stream gets the end sentinel: cancel delivers no last token
        self._notify_stream_end(req)
        self.cancelled += 1
        self._m_cancelled.inc()
        self._tracer.emit("serve.cancel", rid=rid, tokens=len(req.tokens), step=sched._steps)
        self._detach(req, "cancelled")
        self.finished[rid] = req
        self._evict_finished()
        return True

    def _notify_stream_end(self, req: Request) -> None:
        """``on_token(None, True)``: the request's live stream ended with no
        final engine token (cancelled, or exported away), so a consumer
        blocking on it ends instead of waiting forever."""
        cb = req.on_token
        if cb is not None:
            try:
                cb(None, True)
            except BaseException:
                logger.warning("request %d stream-end callback failed", req.rid,
                               exc_info=True)

    def _find_slot(self, rid: int) -> int | None:
        return next((s for s, r in self.scheduler.active.items() if r.rid == rid), None)

    # -- migration ---------------------------------------------------------

    def export_request(self, rid: int, *, notify_stream: bool = False) -> dict:
        """Freeze one live request and return its migration record: prompt,
        generated tokens, budget, sampling and tenant knobs and, warm, the
        preemption offload rows (per-layer K/V blocks at the stored dtype)
        with the cursor, which :meth:`import_request` on another engine
        resumes bit-exact at temperature 0. The request leaves this engine
        (policy accounting dropped, record filed as ``migrated``; it is not
        in ``finished``). Encode it with
        :func:`~elephas_tpu_torch.fleet.migration.encode_record`.

        A warm export needs a paged engine and a request holding a generated
        token; waiting, mid-prefill and tokenless requests export cold (the
        target re-prefills). An in-flight fixed-arena request with tokens
        is refused (``ValueError``); an rid not live here raises
        ``KeyError``. ``notify_stream=True`` sends the request's live
        ``on_token`` the ``(None, True)`` end sentinel (the wire shape, where
        no callback travels)."""
        rid = int(rid)
        sched = self.scheduler
        store = self._offloaded.pop(rid, None)
        if store is not None:
            # preempted: its offload record is the payload (victims wait in
            # the queue)
            req = sched.remove_waiting(rid)
            return self._export_payload(req, store, notify_stream=notify_stream)
        slot = self._find_slot(rid)
        if slot is not None:
            req = sched.active[slot]
            if slot not in self._prefilling and req.tokens:
                if not self.paged:
                    raise ValueError(
                        f"cannot warm-export in-flight request {rid} "
                        f"from a fixed-arena engine — block offload "
                        f"needs paged=True (cancel it or let it finish)"
                    )
                # preempt whatever the priorities: the rows go to the host,
                # then the record detaches through the branch above
                self._offload(sched._preempt(req))
                return self.export_request(rid, notify_stream=notify_stream)
            # mid-prefill or tokenless: partial rows do not resume, export cold
            self._prefilling.pop(slot, None)
            self._stale_prefill.discard(slot)
            sched.reclaim(slot)
            self._set_active(slot, False)
            return self._export_payload(req, None, notify_stream=notify_stream)
        req = sched.remove_waiting(rid)
        if req is None:
            raise KeyError(f"request {rid} is not live on this engine")
        return self._export_payload(req, None, notify_stream=notify_stream)

    def _export_payload(self, req: Request, store, *, notify_stream: bool = False) -> dict:
        rows = {}
        if store is not None:
            if self.device.type == "cuda":
                # the offload's copies to the host were issued without a sync
                torch.cuda.current_stream(self.device).synchronize()
            rows = {name: tuple(t.numpy() for t in leaves) for name, leaves in store.rows.items()}
        self._detach(req, "migrated")
        if notify_stream:
            self._notify_stream_end(req)
        nbytes = 0 if store is None else store.nbytes()
        self.migrated_out += 1
        self.kv_quant_export_bytes += nbytes
        self._m_migrated_out.inc()
        self._m_export_bytes.inc(nbytes)
        self._tracer.emit(
            "serve.export", rid=req.rid, warm=store is not None,
            n_blocks=0 if store is None else store.n_blocks,
            tokens=len(req.tokens), step=self.scheduler._steps,
        )
        return {
            "version": 3,
            "kv_dtype": self.kv_dtype,
            "weight_ver": self.weight_version,
            "rid": int(req.rid),
            "prompt": [int(t) for t in req.prompt],
            "tokens": [int(t) for t in req.tokens],
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "eos_id": None if req.eos_id is None else int(req.eos_id),
            "priority": int(req.priority),
            "tenant": req.tenant,
            "ttft_deadline_ms": req.ttft_deadline_ms,
            # the trace context rides the record, so the migrated half of
            # the lifecycle joins the same story
            "trace": telemetry.current_trace(),
            "block_size": self.block_size,
            "cur_len": 0 if store is None else store.cur_len,
            "n_blocks": 0 if store is None else store.n_blocks,
            "rows": rows,
        }

    def import_request(self, record: dict, on_token=None) -> Request:
        """Adopt a migration record exported by another engine (of either
        package). A warm record (``n_blocks > 0``) re-enters through the
        preemption resume: its rows park as a host offload record, the
        request waits at the queue's front, and the next admission scatters
        the rows into a fresh block table, bit-exact at temperature 0 when
        both engines serve the same weights. A cold record is an ordinary
        submission. ``on_token`` re-attaches the caller's stream.

        Validated as the reference validates it: version, maxlen fit, rid not
        already live or served here, tenant known to this engine's policy,
        and, warm: a paged target, the same block size, ``kv_dtype`` and
        layers, matching non-zero weight generations, the stored arity, and
        ``cur_len == prompt + generated - 1``."""
        if int(record.get("version", -1)) not in (1, 2, 3):
            raise ValueError(
                f"unknown migration record version "
                f"{record.get('version')!r} (this engine speaks "
                f"v1..v3)"
            )
        sched = self.scheduler
        rid = int(record["rid"])
        prompt = tuple(int(t) for t in record["prompt"])
        tokens = [int(t) for t in record["tokens"]]
        max_new = int(record["max_new_tokens"])
        if not prompt:
            raise ValueError("migration record has an empty prompt")
        if len(prompt) + max_new > self.maxlen:
            raise ValueError(
                f"record needs prompt ({len(prompt)}) + budget "
                f"({max_new}) <= maxlen ({self.maxlen})"
            )
        if (rid in self._offloaded or rid in self.finished
                or any(r.rid == rid for r in sched.waiting)
                or any(r.rid == rid for r in sched.active.values())):
            raise ValueError(
                f"request {rid} is already live (or was already "
                f"served) on this engine — a record must be imported "
                f"exactly once"
            )
        tenant = record.get("tenant")
        if tenant is not None and (self.policy is None or not self.policy.knows(tenant)):
            raise ValueError(
                f"record carries tenant {tenant!r} unknown to this "
                f"engine's policy — fleet replicas must declare "
                f"identical tenants"
            )
        rows = record.get("rows") or {}
        n_blocks = int(record.get("n_blocks") or 0)
        warm = n_blocks > 0
        if not warm and tokens:
            raise ValueError(
                f"cold record (n_blocks=0) carries {len(tokens)} "
                f"generated tokens — token-holding requests must "
                f"export WARM (K/V travels) or not at all"
            )
        if warm:
            self._check_warm_record(record, rows, prompt, tokens, max_new, n_blocks)
        req = Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new,
            temperature=float(record.get("temperature") or 0.0),
            eos_id=None if record.get("eos_id") is None else int(record["eos_id"]),
            priority=int(record.get("priority") or 0),
            tenant=tenant,
            ttft_deadline_ms=record.get("ttft_deadline_ms"),
            tokens=tokens,
            on_token=on_token,
        )
        req.submit_step = sched._steps
        # submit_time stays None: the TTFT was observed where the request
        # first ran
        req.exemplar = {"rid": str(rid)}
        rec = self._fr_new(req)
        seq = self._tracer.emit(
            "serve.import", rid=rid, warm=warm, n_blocks=n_blocks,
            tokens=len(tokens), step=sched._steps,
        )
        if rec is not None:
            rec["submit_seq"] = seq
        if warm:
            self._offloaded[rid] = _OffloadRecord(
                rows={name: tuple(self._host_rows(a) for a in leaves)
                      for name, leaves in rows.items()},
                n_blocks=n_blocks, cur_len=int(record["cur_len"]),
            )
            sched.adopt_preempted(req, int(record["cur_len"]))
        else:
            sched.submit(req)
        self.migrated_in += 1
        self._m_migrated_in.inc()
        return req

    def _check_warm_record(self, record, rows, prompt, tokens, max_new, n_blocks) -> None:
        """The reference's refusals of a warm record this engine cannot
        resume bit-exact."""
        if not self.paged:
            raise ValueError("warm migration record needs a paged target engine")
        if int(record["block_size"]) != self.block_size:
            raise ValueError(
                f"record block_size {record['block_size']} != this "
                f"engine's {self.block_size} — K/V blocks are not "
                f"geometry-portable"
            )
        rec_dtype = record.get("kv_dtype", "fp")
        if rec_dtype != self.kv_dtype:
            raise ValueError(
                f"record kv_dtype {rec_dtype!r} != this engine's "
                f"{self.kv_dtype!r} — quantized KV blocks are "
                f"bit-portable only between arenas storing the "
                f"same dtype (re-drive the request cold instead)"
            )
        rec_wver = int(record.get("weight_ver", 0))
        if rec_wver and self.weight_version and rec_wver != self.weight_version:
            raise ValueError(
                f"record weight_ver {rec_wver} != this engine's "
                f"weight_version {self.weight_version} — warm K/V "
                f"from another weight generation cannot resume "
                f"bit-exact (re-drive the request cold instead)"
            )
        arity = 2 if self.kv_dtype == "fp" else 4
        bad_arity = {name: len(leaves) for name, leaves in rows.items() if len(leaves) != arity}
        if bad_arity:
            raise ValueError(
                f"record rows carry {bad_arity} arrays per layer "
                f"— a {self.kv_dtype!r} arena stores {arity} "
                f"(torn or mis-encoded record)"
            )
        if not tokens:
            raise ValueError(
                "warm record without generated tokens — the resume "
                "cursor math (last token re-arm) would be wrong"
            )
        cur_len = int(record["cur_len"])
        if cur_len != len(prompt) + len(tokens) - 1:
            raise ValueError(
                f"corrupt record: cur_len {cur_len} != prompt "
                f"({len(prompt)}) + generated ({len(tokens)}) - 1"
            )
        if n_blocks != blocks_for(cur_len, self.block_size):
            raise ValueError(
                f"corrupt record: {n_blocks} blocks cannot cover "
                f"cur_len {cur_len} at block_size {self.block_size}"
            )
        expected = {name for name, _h, _d in self.arena.specs}
        if set(rows) != expected:
            raise ValueError(
                f"record layers {sorted(rows)} != this engine's "
                f"{sorted(expected)} — different model architecture"
            )
        if blocks_for(len(prompt) + max_new, self.block_size) > self.num_blocks:
            raise ValueError(
                f"record can never fit this pool ({self.num_blocks}"
                f" blocks) — route it to a larger replica"
            )

    def _host_rows(self, a) -> torch.Tensor:
        """One imported row array as a host tensor of its own (pinned when
        the engine is on a card, so the resume's copy is asynchronous)."""
        t = a.clone() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    # -- introspection -------------------------------------------------

    def scrape(self, openmetrics: bool = False, full: bool = True) -> str:
        """The port's registry as Prometheus exposition text (empty for an
        engine built under null mode). ``openmetrics=True`` renders the
        OpenMetrics flavor, whose histogram buckets carry rid exemplars;
        ``full=False`` narrows the 0.0.4 text to this engine's own series
        (its ``engine=`` and its scheduler's ``scheduler=`` labels)."""
        reg = self._telemetry_registry
        if openmetrics:
            if not full:
                raise ValueError(
                    "full=False is a 0.0.4-flavor filter — the "
                    "OpenMetrics surface renders the whole registry"
                )
            return telemetry.render_openmetrics(reg)
        if not full:
            return (telemetry.render(reg, only={"engine": self.telemetry_label})
                    + telemetry.render(reg, only={"scheduler": self.scheduler.telemetry_label}))
        return telemetry.render(reg)

    def explain(self, rid: int) -> dict:
        """The lifecycle record of one request (a copy): admission verdict,
        queue wait, admission kind and reuse, prefill chunks, preemptions
        and resumes, verify rounds, the step of every token, the first token
        and the finish, each stamped with the scheduler step and tracer
        sequence number it happened at. An in-flight request's record has
        ``finish`` None. Raises ``RuntimeError`` when the recorder is off
        and ``KeyError`` for an unknown or evicted rid. The gateway serves it
        as ``GET /v1/requests/{rid}/trace``."""
        if self._flight is None:
            raise RuntimeError(
                "flight recorder is off (flight_recorder=0/None, or "
                "the engine was built under telemetry null mode) — "
                "explain() has no lifecycle records to read"
            )
        rec = self._fr(int(rid))
        if rec is None:
            raise KeyError(
                f"no lifecycle record for request {rid} — never "
                f"submitted to this engine, or evicted from the "
                f"{self._flight.capacity}-record flight ring"
            )
        return copy.deepcopy(rec)

    def debug_snapshot(self) -> dict:
        """Live engine state in one dict (the gateway's ``GET
        /debug/engine``): slot map, waiting queue with each request's debt,
        block-pool occupancy, offloaded requests, prefix cache or index
        summary, policy state and the flight recorder's occupancy. Host
        reads only. The reference's ``compile_stats`` has no counterpart
        (the port compiles no programs) and ``backend_fallback`` is always
        None (the port has no fallback)."""
        sched = self.scheduler
        slots = {}
        for slot, req in sorted(sched.active.items()):
            pre = self._prefilling.get(slot)
            slots[str(slot)] = {
                "rid": req.rid,
                "tenant": req.tenant,
                "prompt_tokens": len(req.prompt),
                "generated": len(req.tokens),
                "prefilling": pre is not None,
                "prefill_progress": pre[1] if pre is not None else None,
                "table_blocks": len(sched.tables.get(slot, ())) if self.paged else None,
            }
        out = {
            "engine": self.telemetry_label,
            "steps": sched._steps,
            "num_slots": self.num_slots,
            "attention": self.attention,
            "kv_dtype": self.kv_dtype,
            "weight_version": self.weight_version,
            "backend_fallback": None,
            "slots": slots,
            "waiting": sched.queue_snapshot(),
            "queued_tokens": sched.queued_tokens,
            "offloaded": {str(rid): {"blocks": r.n_blocks, "cur_len": r.cur_len}
                          for rid, r in sorted(self._offloaded.items())},
            "policy": self.policy.stats() if self.policy is not None else None,
            "flight_recorder": None if self._flight is None else {
                "capacity": self._flight.capacity,
                "finished_resident": len(self._flight),
                "in_flight": len(self._flight_live),
            },
        }
        if self.paged:
            out["blocks_total"] = self.num_blocks
            out["blocks_free"] = sched.allocator.free_count
            idx = sched.prefix_index
            out["prefix_index"] = idx.stats() if idx is not None else None
        elif sched.prefix_cache is not None:
            out["prefix_cache"] = sched.prefix_cache.stats()
        return out

    def release_telemetry(self) -> None:
        """Retire this engine's labeled series, its scheduler's and its
        prefix cache's, from the registry. Never called implicitly: a
        finished engine's counters stay scrapeable until a host that builds
        engines in a loop retires them. The plain counts keep reading."""
        telemetry.remove_series(engine=self.telemetry_label)
        self.scheduler.release_telemetry()

    def refresh_weights(self, version: int | None = None) -> None:
        """Take note that the model's weights changed (further training, or
        :meth:`load_weights`). ``version`` stamps the new weight generation;
        ``None`` keeps the current stamp. The engine reads the module's
        parameters at every step, so nothing is re-uploaded; what the old
        weights computed is dropped instead: the prefix cache (a donor's
        K/V would splice stale rows into a new request), the donation of
        every prefill now in progress (its rows mix generations) and a draft
        model's committed frontiers. In-flight requests keep their slots and
        finish on mixed weights, as in the reference. Runs under
        :attr:`lock`, between two steps."""
        with self.lock:
            if version is not None:
                self.weight_version = int(version)
            # the push that ends here carries the caller's trace id: the
            # deployment is one story on the merged timeline
            self._tracer.emit(
                "serve.refresh_weights", engine=self.telemetry_label,
                weight_version=self.weight_version,
            )
            self._g_weight_version.set(self.weight_version)
            self.scheduler.flush_prefix_cache()
            self._stale_prefill = set(self._prefilling)
            if self._drafter is not None:
                self._drafter.refresh_weights()
                self._drafter.weight_version = self.weight_version

    def load_weights(self, weights, version: int | None = None) -> None:
        """Serve a weight list in Keras's ``model.weights`` order (what the
        parameter server's wire carries) and stamp it as ``version``.

        The values go to the device first, outside any lock; then, between
        two steps, one device-to-device copy a tensor puts them in and
        :meth:`refresh_weights` runs, so no step reads two generations."""
        from elephas_tpu_torch.utils.weights import commit_staged, stage_weights

        staged = stage_weights(self.model, weights)
        with self.lock:
            commit_staged(staged)
            self.refresh_weights(version=version)

    def release_arena(self) -> None:
        """Drop the KV arena and every host record of the K/V it held: an
        engine abandoned by a crash (the fleet router's ``kill_replica``)
        gives its device memory back before a successor is built. The
        engine serves nothing afterwards."""
        with self.lock:
            self.arena = None
            self._offloaded.clear()
            self._tables_cache = None
            if self._drafter is not None:
                self._drafter.release()

    def prefix_warm_probe(self, prompt) -> int:
        """How many leading tokens of ``prompt`` the prefix cache would
        serve without recompute (0 without a prefix cache). Pure: no hit,
        recency or pin moves, and equal to the reuse admission would then
        commit."""
        cache = self.scheduler.prefix_index or self.scheduler.prefix_cache
        if cache is None:
            return 0
        return cache.match_len(np.asarray(prompt).reshape(-1))

    def score(self, prompt, completion) -> dict:
        """Log-probabilities of ``completion`` given ``prompt`` in one
        teacher-forced forward: ``prompt + completion[:-1]`` goes through the
        arena's chunk pass on one row, whose logits row ``j`` scores the
        token at position ``j + 1``. The pass writes into scratch storage of
        its own (a pool of the scored positions' blocks, or a one-slot
        arena), so serving state is untouched: no block, cursor or generator
        moves. The row sees only its own positions, as the reference's
        scoring lane does over its discarded copy of the arena.

        Returns ``{"logprobs", "total_logprob", "greedy_tokens",
        "agreement"}`` (``agreement``: the fraction of completion tokens
        equal to the argmax). ``prompt`` and ``completion`` must be non-empty
        and fit ``maxlen`` together. Runs under :attr:`lock`: one
        generation a pass."""
        with self.lock:
            return self._score(prompt, completion)

    @torch.inference_mode()
    def _score(self, prompt, completion) -> dict:
        """The body of :meth:`score`."""
        prompt = [int(t) for t in prompt]
        completion = [int(t) for t in completion]
        if not prompt:
            raise ValueError("score() needs a non-empty prompt")
        if not completion:
            raise ValueError("score() needs a non-empty completion")
        total = len(prompt) + len(completion)
        if total > self.maxlen:
            raise ValueError(
                f"prompt ({len(prompt)}) + completion "
                f"({len(completion)}) exceeds maxlen ({self.maxlen})"
            )
        seq = prompt + completion
        n = total - 1  # fed positions; row j scores seq[j + 1]
        width = self.scheduler.bucket_for(n)
        dev = self.device
        tokens = torch.zeros(1, width, dtype=torch.long, device=dev)
        tokens[0, :n] = torch.tensor(seq[:n], device=dev)
        offs = torch.zeros(1, dtype=torch.int32, device=dev)
        clens = torch.full((1,), n, dtype=torch.int32, device=dev)
        if self.paged:
            nb = blocks_for(n, self.block_size)
            if nb > self.num_blocks:
                raise ValueError(
                    f"scoring {n} positions needs {nb} blocks — more "
                    f"than the pool's {self.num_blocks}"
                )
            tb = table_bucket_for(nb, self._tbuckets)
            scratch = PagedKVPool(self._layers, nb, self.block_size, dev, self.kv_dtype)
            table = torch.full((1, tb), nb, dtype=torch.int32)
            table[0, :nb] = torch.arange(nb, dtype=torch.int32)
            logits = paged_chunk_forward(self.model, tokens, scratch, table.to(dev), offs,
                                         clens, attention=self.attention)
        else:
            span = span_bucket_for(n, self._sbuckets) if self.attention == "flash" else None
            scratch = SlotKVCache(self._layers, 1, self.maxlen, dev)
            logits = chunked_prefill_forward(self.model, tokens, scratch, offs, clens,
                                             attention=self.attention, span=span)
        row = logits[0, :n]
        targets = torch.tensor(seq[1:], device=dev)
        tlp = torch.log_softmax(row, dim=-1).gather(1, targets[:, None])[:, 0].cpu().numpy()
        greedy = row.argmax(dim=-1).cpu().numpy()
        p = len(prompt)
        lps = [float(x) for x in tlp[p - 1:n]]
        g = [int(t) for t in greedy[p - 1:n]]
        agreed = sum(1 for a, b in zip(g, completion) if a == b)
        self.score_requests += 1
        self._m_score_requests.inc()
        self._tracer.emit("serve.score", prompt_tokens=p, completion_tokens=len(completion),
                          agreement=agreed / len(completion))
        return {
            "logprobs": lps,
            "total_logprob": float(sum(lps)),
            "greedy_tokens": g,
            "agreement": agreed / len(completion),
        }

    def _tenant_stats(self) -> dict:
        """Per-tenant queue depth, admitted and rejected requests, tokens
        and SLO attainment; empty without a policy."""
        if self.policy is None:
            return {}
        out = {}
        for t in self.policy.tenant_names:
            c = self._tenant_counts.get(t, {})
            met, missed = c.get("slo_met", 0), c.get("slo_missed", 0)
            out[t] = {
                "queue_depth": self.scheduler.waiting_count(t),
                "admitted": c.get("admitted", 0),
                "rejected": c.get("rejected", 0),
                "tokens": c.get("tokens", 0),
                "slo_met": met,
                "slo_missed": missed,
                "slo_attainment": met / (met + missed) if met + missed else None,
            }
        return out

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
        inter-token percentiles of the finished requests, decode-only
        tokens/s (each request's first-to-last token window), the paged
        arena's counters (preemptions, resumes, rejections, offloaded blocks
        and, quantized, their bytes; blocks free, leased and shared), the
        stored ``kv_dtype``, :meth:`score` calls, and the prefix cache's hit
        and eviction counters when it is on; speculative decoding's drafted
        and accepted tokens, verify rounds and throttle trips (zero on an
        engine without it), the policy's refusals, per-tenant counts and
        state."""
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
        out = {
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
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "rejected": self.rejected,
            "kv_dtype": self.kv_dtype,
            "kv_quant_offload_bytes": self.kv_quant_offload_bytes,
            "score_requests": self.score_requests,
            "spec_draft_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_acceptance_rate": (
                self.spec_accepted / self.spec_drafted if self.spec_drafted else None
            ),
            "spec_verify_rounds": self.spec_rounds,
            "spec_throttled": self.spec_throttled,
            "admission_rejected": self.admission_rejected,
            "tenants": self._tenant_stats(),
            "migrated_out": self.migrated_out,
            "migrated_in": self.migrated_in,
            "kv_quant_export_bytes": self.kv_quant_export_bytes,
            "weight_version": self.weight_version,
        }
        if self.policy is not None:
            out["policy"] = self.policy.stats()
        if self.paged:
            alloc = self.scheduler.allocator
            idx = self.scheduler.prefix_index
            out["blocks_total"] = self.num_blocks
            out["blocks_free"] = alloc.free_count
            out["blocks_leased"] = alloc.leased_count
            out["offloaded_blocks"] = self.offloaded_blocks
            out["prefix_blocks_shared"] = idx.shared_blocks if idx is not None else 0
            if idx is not None:
                out["prefix_cache"] = idx.stats()
        if self.scheduler.prefix_cache is not None:
            out["prefix_cache"] = self.scheduler.prefix_cache.stats()
        return out
