"""Speculative decoding: drafters and the acceptance throttle.

Counterpart of ``elephas_tpu/serving/speculative.py`` (the same classes,
defaults and messages). Plain decode advances every slot one token a target
forward. Draft-and-verify decoding (Leviathan et al. 2023) gets several: a
cheap **drafter** proposes up to ``k`` continuation tokens a slot, the
engine scores all of them in one batched verify pass
(:func:`~elephas_tpu_torch.serving.kv_cache.verify_forward` /
:func:`~elephas_tpu_torch.serving.paged_kv.paged_verify_forward`, the
span-chunk kernels on the card), and accepts the longest draft prefix that
matches the model's own tokens plus the model's "bonus" token at the first
mismatch. At temperature 0 the accepted tokens are those plain decode
would have produced: speculation changes latency, never output.

- :class:`Drafter` — the interface: ``propose(req, k)`` for one request,
  ``propose_batch`` once a verify round for every drafting slot.
- :class:`NgramDrafter` — prompt lookup (Saxena 2023): the continuation of
  the most recent earlier occurrence of the request's token suffix in its
  own prompt and generated stream. Host code, no device work.
- :class:`DraftModelDrafter` — a second, smaller LM drafts in its own fixed
  KV slot arena on its device (one slot an engine slot): catch-up
  in fixed-width chunks through the span-chunk kernel, then ``k`` greedy
  decode steps through the span-decode kernel with one host read.
- :class:`AcceptanceThrottle` — per request: stop drafting when the
  measured acceptance collapses, re-probe later, so unpredictable text
  never makes speculation a sustained loss.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Drafter",
    "NgramDrafter",
    "DraftModelDrafter",
    "AcceptanceThrottle",
    "resolve_drafter",
]


class Drafter:
    """Interface: guess the next tokens of a request, cheaply.

    The engine calls :meth:`propose_batch` once a verify round with every
    slot eligible to draft; implementations return ``{slot: [token, ...]}``
    with at most the item's ``k`` tokens each. A wrong guess costs only
    verify compute (the acceptance rule discards it); a missing guess costs
    nothing (the slot rides the round as a one-token decode)."""

    # the weight generation this drafter's state was built under: the
    # engine's refresh_weights() stamps it. 0 = unversioned.
    weight_version: int = 0

    def propose(self, req, k: int) -> list[int]:
        """Up to ``k`` guessed continuation tokens for ``req`` (which
        exposes ``prompt``, ``tokens`` and ``full_sequence``). Return ``[]``
        to skip drafting this round."""
        raise NotImplementedError

    def propose_batch(self, items) -> dict[int, list[int]]:
        """``items`` is ``[(slot, req, k), ...]``; returns ``{slot:
        drafts}``. Default: :meth:`propose` for each item."""
        return {slot: self.propose(req, k) for slot, req, k in items}

    def refresh_weights(self) -> None:
        """Re-read model state after the weights changed; stateless
        drafters do nothing."""

    def release(self) -> None:
        """Drop device and host resources: the engine's ``release_arena``
        calls it, and owners of a drafter built directly may, to free a
        draft arena early."""


class NgramDrafter(Drafter):
    """Prompt-lookup / n-gram drafting: propose the continuation of the most
    recent earlier occurrence of the request's current token suffix inside
    its own prompt and generated stream.

    Longest suffix first (``max_ngram`` down to ``min_ngram``), most recent
    match first within a length. Matching runs over ``full_sequence``, so a
    match may span the prompt / generated boundary. No match, no drafts:
    the slot decodes plainly this round."""

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1):
        max_ngram, min_ngram = int(max_ngram), int(min_ngram)
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram}, max_ngram={max_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, req, k: int) -> list[int]:
        seq = req.full_sequence
        n_seq = len(seq)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            # the suffix plus at least one earlier position (the terminal
            # occurrence is the query)
            if n_seq < n + 1:
                continue
            suffix = seq[n_seq - n:]
            for i in range(n_seq - n - 1, -1, -1):
                if seq[i:i + n] == suffix:
                    # i + n <= n_seq - 1: one continuation token at least
                    return [int(t) for t in seq[i + n: i + n + int(k)]]
        return []


class DraftModelDrafter(Drafter):
    """Draft with a second (small) causal LM in its own fixed KV slot arena,
    the classic two-model setup.

    Slot ``s`` of the draft arena shadows engine slot ``s``. Each
    :meth:`propose_batch` (1) **catches up**: feeds the true token stream
    committed since the drafter last saw the slot, in ``CATCHUP_CHUNK``
    -token chunks through
    :func:`~elephas_tpu_torch.serving.kv_cache.chunked_prefill_forward` (the
    span-chunk kernel on the card), then (2) **drafts** ``k`` tokens with
    ``k`` greedy :func:`~elephas_tpu_torch.serving.kv_cache.\
token_decode_step` calls (the span-decode kernel), the tokens staying on
    the device until one read of the ``[k, num_slots]`` block. Rows written
    past the committed frontier are scratch that the next catch-up rewrites
    before any query can see them. The frontier is keyed by ``(slot,
    rid)``: a new occupant of a slot is re-ingested from its first token.

    The draft model must be a port :func:`~elephas_tpu_torch.transformer_lm`
    in float32 with the target's vocabulary and at least its ``maxlen``; its
    arena and passes run on the draft model's device."""

    #: catch-up chunk width, clipped to the draft maxlen; long prompts loop
    CATCHUP_CHUNK = 32

    def __init__(self, model, num_slots: int,
                 target_maxlen: int | None = None,
                 target_vocab: int | None = None):
        from elephas_tpu_torch.models.transformer import validate_token_decode_model
        from elephas_tpu_torch.ops.flash_serving import span_buckets
        from elephas_tpu_torch.serving.kv_cache import SlotKVCache

        layers = validate_token_decode_model(
            model, what="the draft-model drafter", hint="draft with NgramDrafter instead",
        )
        self.model = model
        self.maxlen = int(model.maxlen)
        self.vocab = int(model.vocab_size)
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError(f"num_slots={num_slots} < 1")
        self.validate_for(
            self.num_slots,
            self.maxlen if target_maxlen is None else target_maxlen,
            self.vocab if target_vocab is None else target_vocab,
        )
        self.device = model.device
        self.arena = SlotKVCache(layers, self.num_slots, self.maxlen, self.device)
        self._chunk = min(self.CATCHUP_CHUNK, self.maxlen)
        self._sbuckets = span_buckets(self.maxlen)
        # committed frontier a slot: (rid, tokens of the TRUE stream whose
        # K/V is resident); scratch draft rows never count
        self._frontier: dict[int, tuple[int, int]] = {}
        # catch-up chunk passes and greedy draft steps run so far
        self.catchup_passes = 0
        self.draft_steps = 0

    def refresh_weights(self) -> None:
        """Invalidate every committed frontier: the resident rows were
        computed under the old weights. The port's drafter reads its
        module's parameters at every call, so nothing is re-uploaded."""
        self._frontier.clear()

    def _span(self, n: int) -> int:
        from elephas_tpu_torch.ops.flash_serving import span_bucket_for

        return span_bucket_for(max(1, min(self.maxlen, int(n))), self._sbuckets)

    @torch.inference_mode()
    def _ingest(self, batch, seqs) -> None:
        """One catch-up pass: ``(slot, seen, take)`` items feed ``take``
        true tokens from position ``seen`` into their slots' rows."""
        from elephas_tpu_torch.serving.kv_cache import chunked_prefill_forward

        dev = self.device
        rows = np.zeros((len(batch), self._chunk), np.int64)
        offs = np.zeros((len(batch),), np.int32)
        clens = np.zeros((len(batch),), np.int32)
        for i, (slot, seen, take) in enumerate(batch):
            rows[i, :take] = seqs[slot][seen:seen + take]
            offs[i], clens[i] = seen, take
        slots = torch.tensor([slot for slot, _s, _t in batch], dtype=torch.long, device=dev)
        chunked_prefill_forward(self.model, torch.from_numpy(rows).to(dev), self.arena,
                                torch.from_numpy(offs).to(dev),
                                torch.from_numpy(clens).to(dev),
                                span=self._span(int((offs + clens).max())), slots=slots)
        self.catchup_passes += 1

    @torch.inference_mode()
    def _draft(self, last, positions, active, k: int):
        """``k`` greedy decode steps over the whole draft arena from each
        active slot's last true token; returns ``[k, num_slots]`` tokens on
        the host (one read)."""
        from elephas_tpu_torch.serving.kv_cache import token_decode_step

        dev, maxlen = self.device, self.maxlen
        last = torch.from_numpy(last).to(dev)
        positions = torch.from_numpy(positions).to(dev)
        act = torch.from_numpy(active).to(dev)
        span = self._span(int(positions.max()) + k)
        toks = torch.empty(k, self.num_slots, dtype=torch.long, device=dev)
        for i in range(k):
            logits = token_decode_step(self.model, last, torch.clamp(positions, max=maxlen - 1),
                                       self.arena, act, span=span)
            last = torch.argmax(logits, dim=-1)
            toks[i] = last
            positions = positions + 1
        self.draft_steps += k
        return toks.cpu().numpy()

    def propose_batch(self, items) -> dict[int, list[int]]:
        if not items:
            return {}
        seqs = {}
        for slot, req, _k in items:
            seqs[slot] = req.full_sequence
            rid, seen = self._frontier.get(slot, (None, 0))
            if rid != req.rid:
                seen = 0  # a new occupant: full re-ingest
            self._frontier[slot] = (req.rid, seen)
        # catch-up: commit the true stream up to (not including) its last
        # token, whose K/V lands while drafting (the engine's own cursor
        # convention)
        while True:
            batch = []
            for slot, _req, _k in items:
                _rid, seen = self._frontier[slot]
                deficit = len(seqs[slot]) - 1 - seen
                if deficit > 0:
                    batch.append((slot, seen, min(self._chunk, deficit)))
            if not batch:
                break
            self._ingest(batch, seqs)
            for slot, seen, take in batch:
                rid, _seen = self._frontier[slot]
                self._frontier[slot] = (rid, seen + take)
        k_max = max(int(k) for _s, _r, k in items)
        if k_max < 1:
            return {slot: [] for slot, _r, _k in items}
        last = np.zeros((self.num_slots,), np.int64)
        positions = np.zeros((self.num_slots,), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for slot, _req, k in items:
            if k < 1:
                continue
            last[slot] = seqs[slot][-1]
            positions[slot] = len(seqs[slot]) - 1
            active[slot] = True
        toks = self._draft(last, positions, active, k_max)
        return {
            slot: [int(t) for t in toks[: int(k), slot]] if k >= 1 else []
            for slot, _req, k in items
        }

    def validate_for(self, num_slots: int, maxlen: int, vocab: int) -> None:
        """Check this drafter fits a target engine (``resolve_drafter`` calls
        it for a pre-built instance too, so a drafter sized for another
        engine fails at construction, not mid-serve)."""
        if self.num_slots < int(num_slots):
            raise ValueError(
                f"draft arena has {self.num_slots} slots but the "
                f"engine serves {num_slots} — the drafter shadows "
                f"engine slots one-to-one"
            )
        if self.maxlen < int(maxlen):
            raise ValueError(
                f"draft model maxlen {self.maxlen} < target maxlen "
                f"{maxlen} — the drafter could not represent "
                f"positions the target decodes at"
            )
        if self.vocab != int(vocab):
            raise ValueError(
                f"draft model vocab {self.vocab} != target vocab "
                f"{vocab} — drafted token ids would not mean the "
                f"same tokens"
            )

    def release(self) -> None:
        self.arena = None
        self._frontier.clear()


class AcceptanceThrottle:
    """Per-request drafting governor: measure acceptance over a probe
    window, stop drafting when it collapses, re-probe later.

    Draft for ``probe_window`` proposed tokens; if the acceptance rate is
    below ``min_rate``, stop drafting for ``reprobe_rounds`` decode rounds
    (the engine decodes this request plainly), then probe again. The
    defaults probe short and back off long (8 tokens, 16 rounds), which
    bounds the tax under total collapse. Host bookkeeping keyed by request
    id."""

    def __init__(self, probe_window: int = 8, min_rate: float = 0.25,
                 reprobe_rounds: int = 16):
        if probe_window < 1:
            raise ValueError(f"probe_window={probe_window} < 1")
        if not 0.0 <= min_rate <= 1.0:
            raise ValueError(f"min_rate={min_rate} outside [0, 1]")
        if reprobe_rounds < 1:
            raise ValueError(f"reprobe_rounds={reprobe_rounds} < 1")
        self.probe_window = int(probe_window)
        self.min_rate = float(min_rate)
        self.reprobe_rounds = int(reprobe_rounds)
        # rid -> [proposed_in_window, accepted_in_window, cooldown]
        self._state: dict[int, list] = {}

    def should_draft(self, rid: int) -> bool:
        """Consult (and advance) the governor for one decode round: True =
        draft; False = throttled (the cooldown ticks down, and reaching
        zero re-arms a fresh probe window)."""
        st = self._state.setdefault(int(rid), [0, 0, 0])
        if st[2] > 0:
            st[2] -= 1
            if st[2] == 0:
                st[0] = st[1] = 0  # a fresh probe window on re-entry
            return False
        return True

    def note(self, rid: int, proposed: int, accepted: int) -> bool:
        """Record one round's outcome; True when this round tripped the
        throttle."""
        if proposed <= 0:
            return False
        st = self._state.setdefault(int(rid), [0, 0, 0])
        st[0] += int(proposed)
        st[1] += int(accepted)
        if st[0] >= self.probe_window:
            if st[1] / st[0] < self.min_rate:
                st[2] = self.reprobe_rounds
                return True
            st[0] = st[1] = 0  # healthy: slide the window
        return False

    def throttled(self, rid: int) -> bool:
        st = self._state.get(int(rid))
        return bool(st) and st[2] > 0

    def forget(self, rid: int) -> None:
        """Drop a finished request's state (bounded memory)."""
        self._state.pop(int(rid), None)


def resolve_drafter(spec, num_slots: int, maxlen: int, vocab: int):
    """The engine's ``spec_drafter`` knob: ``None`` / ``"ngram"`` →
    :class:`NgramDrafter`; a :class:`Drafter` instance passes through (a
    :class:`DraftModelDrafter` checked against the engine); a port
    causal-LM module wraps into a :class:`DraftModelDrafter` sized to the
    engine. Anything else raises."""
    if spec is None or (isinstance(spec, str) and spec == "ngram"):
        return NgramDrafter()
    if isinstance(spec, DraftModelDrafter):
        spec.validate_for(num_slots, maxlen, vocab)
        return spec
    if isinstance(spec, Drafter):
        return spec
    if isinstance(spec, torch.nn.Module):
        return DraftModelDrafter(spec, num_slots=num_slots, target_maxlen=maxlen,
                                 target_vocab=vocab)
    raise ValueError(
        f"spec_drafter={spec!r} is not a drafter: pass 'ngram', a "
        f"serving.Drafter instance, or a causal-LM keras model to "
        f"draft with"
    )
