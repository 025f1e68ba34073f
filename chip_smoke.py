#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (elephas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --times-only [--package DIR]

Phases, each printing one JSON line and raising on failure:

1. card   — device name and count, nvidia-smi's name and power limit;
2. build  — nvcc builds every kernel from the sources in this checkout
            (time, and what -Xptxas -v reports); each flash instantiation's
            registers and spills, and its tensor-core (HMMA), async-copy
            (LDGSTS) and ldmatrix (LDSM) instruction counts from
            cuobjdump --dump-sass, and the span chunk's; each LayerNorm
            forward instantiation's 16-byte loads and stores and block
            barriers; fails on a spill, a flash, span-chunk or paged
            span-chunk kernel (every stored type) without HMMA or LDGSTS,
            a paged span-decode kernel without
            LDGSTS (its cp.async ring), a one-warp-a-row
            LayerNorm forward with a block barrier or a vector one without
            16-byte loads and stores;
3. kernel — each kernel against its plain PyTorch version on the card,
            at the main paths' shapes, fp32 and bf16: the flash forward
            (causal and not; also at the tensor-parallel shards' heads,
            T's 4 of 8 and config A's 2 of 4) and the LayerNorm forward and backward (at
            the engine's, generate's and the training rows, an odd width
            and rows off 16-byte alignment, each on the route it should
            take, the serving route's y bit for bit the training route's,
            on a second call and from a CUDA-graph replay); and
            the span decode (fp32) at the engine's slots and heads, at
            tp_generate's shards (1 and 4 rows of 2 heads) and at
            a shape whose slots and heads fill the card, over every span
            bucket and head dim, with ragged positions and a stale cursor,
            repeating bit for bit eagerly and from a CUDA-graph replay; and the span
            chunk (fp32) at 16 slots of 4 heads of 128 with chunk widths 1,
            64, 100 and 512 over spans 128-512, with ragged offsets and rows
            past the span, at the engine's launch (one slot of its 16-slot
            arena through the slot map, 64 rows, every span bucket) and at a
            prefix-hit pass (4 slots through the slot map, 32 rows),
            repeating bit for bit eagerly and from a CUDA-graph replay; and
            the paged span decode and span chunk in fp, int8 and int4 at
            E's decode shape (16 slots, 4 heads of 128, blocks of 16, and
            both also at blocks of 1) over
            tables of 8-32 blocks with shuffled ids, sentinel padding and
            stale cursors, at 16 slots of 64 rows and of 5 (the verify
            window), at the paged engine's
            one-row launch, at one row over 1,024 keys (16 splits: the
            merge kernel) and at a 512-row chunk from 0: within 1e-5 of
            max(1, |out|) of their plain versions, bit-equal to the arena
            kernels over the gathered, dequantized span, on a second call
            and from a CUDA-graph replay, the paged chunk launching its
            merge kernel only past 8 splits; and moe_ffn (the Switch
            layer's index route, PyTorch ops: no TPU kernel) against its dense
            plain version at SW-A's decode and prefill and a 4,096-token
            slice of an SW-T layer with and without drops: the kept routing
            equal, outputs within 1e-6 of max(1, |out|), gradients within
            1e-5 of each tensor's largest;
4. serve  — the serving path: generate() on transformer_lm at full width
            (config A with and without rope, config B), and one
            transformer_classifier forward, with launch counts of the
            flash and LayerNorm kernels; then a teacher-forced check of
            the emitted tokens and logits against the plain path (plain
            attention and LayerNorm) on the card;
5. train  — the training path: SparkModel.fit of transformer_classifier
            at the reference's headline training widths (bench.py
            --preset full --model transformer, fp32) with launch counts
            per step, finite losses, tokens/s and peak memory; and the
            gradients of one batch through the kernels against those of
            the plain path;
5b. train_bf16 — the same fit in the bench's mixed_bfloat16 (bf16
            compute on float32 variables): the gradient check at 2e-2 of
            each tensor's largest gradient, launches per step with the
            bf16 route's share (every flash forward; every LayerNorm but the first of a
            step, which normalises the float32 sum of the embeddings and
            the position table, as the reference's does), float32
            variables after the fit, a finite history, tokens/s and peak
            memory beside the fp32 run's;
5c. train_resnet50 — SparkModel.fit of resnet50 at 224x224, 1000 classes,
            mixed_bfloat16, batch 256 (halved while it does not fit), 4
            batches of the bench's synthetic images, 2 epochs: images/s
            after the first step, peak memory, BatchNorm's moving
            statistics moved and finite, and the first step's
            probabilities against the same weights under float32, for
            two seeds' weights (KL divergence, beside the KL against
            another row's output and the float32 forward of the input
            rounded to bf16);
5d. zoo    — one fit each of mnist_mlp, cifar10_cnn and imdb_lstm at
            their defaults on synthetic data of their shapes;
5e. train_workers — the train phase's fp32 fit of T on 4 workers of the
            one card (force_devices(4), 32 rows a worker step, the same
            global batch): synchronous/epoch with the workers' mean
            first-step gradient against one model's on their 128 rows,
            replicas bit-identical to the master, 4x the train phase's
            launches, tokens/s over all workers, the median global step,
            the device time of one averaging, peak memory;
            asynchronous/batch and hogwild/epoch with identical replicas
            and the master equal to the replicas' mean before the last
            average; a 1-epoch fit with checkpoints resumed to 2 epochs by
            a fresh wrapper against the uninterrupted fit, bit for bit;
            save -> load_spark_model -> predict, bit for bit; and
            validation_split=0.25;
5f. train_stream — SparkModel.fit streaming into the card: T in
            mixed_bfloat16 from a memmap (S-T), bit-equal to the staged
            fit at 1 and 4 workers with equal launches, a streamed resume
            bit-equal, streamed validation, frequency='fit' refused; and
            ResNet-50 on 1.23 GB of images streamed by the size threshold
            (S-R50) against the same rows staged, in turns: images/s, H2D
            copy GB/s and gather ms per block, idle share of a profiled
            streamed epoch, peak device memory and pinned host bytes, the
            loss history within 1e-3 of the staged fit's;
5g. ml_pipeline — examples/ml_pipeline.py's configuration through
            Pipeline(ElephasEstimator) on the card: its test accuracy
            against the example's bar of 0.7;
5h. hyperparam — examples/hyperparam_optimization.py's search through
            HyperParamModel on the card (synthetic MNIST, 8 evals, 2 epochs,
            batch 64, seed 0): at the card's one worker (adaptive), and at
            force_devices(4) with devices_per_trial=2 (random): every
            trial's loss finite, the best trial the least loss, the
            returned module evaluating to that loss bit for bit, the
            random strategy's params the numpy sampler's; seconds a trial;
5i. train_ps — the parameter-server path: SparkModel.fit of T in
            mixed_bfloat16 (TRAIN_ROWS rows, batch TRAIN_BATCH, 2 epochs)
            with mode='asynchronous', parameter_server_mode='socket', port
            0 and a journal in build/train_ps: a SocketClient pull after
            the fit (before the store stops) bit-equal to the master's host
            weights, the journal bit-equal too; the same fit shortened (256
            rows, 1 epoch) with the native and the HTTP store, each pulled
            bit-equal; a fresh T's fit(resume=True) adopting the journal bit
            for bit; run_chaos_training with its worker on the card under a
            PSKiller (kill after 2 updates, a quarter of the pushes sent
            twice) beside the fault-free run: the same applied count,
            every duplicate skipped, nothing lost, the loss down by 5 % and
            within 5 % of the fault-free run's. Recorded: the store's fixed
            costs (its start, each publication, its stop split into the
            terminal journal write and the shutdown poll) and the pull's
            bytes and seconds; the epoch's seconds with and without the
            store, at T's 4-step epochs, show those fixed costs, not a
            share of a real epoch.
            Printed: the fit's seconds an epoch with and without the store
            (in turns), each publication's milliseconds on the fit thread,
            the pull's bytes and GB/s, the card's name and power limit. Its
            launches (the three stores' fits) join the launch check;
6. engine — the continuous-batching InferenceEngine at config A's full
            width (16 slots, 16 steps a decode window, 48 requests as the
            reference's serving bench sends them), after a warm-up pass:
            generated tokens/s, TTFT and inter-token percentiles, peak
            memory and the launches of the span-decode, flash and
            LayerNorm kernels; then (a) every emitted token against the
            plain full forward's argmax, (b) generate(kv_cache=True)
            against generate(kv_cache=False), both where the top-2 margin
            is at least 1e-3, and (c) one decode window's logits against
            the plain full forward's;
6b. engine_long — the same engine on 16 requests of 200-440 prompt
            tokens and 48 new tokens each, so decode spans reach 512:
            tokens/s, TTFT, ITL, the spans the decode windows ran at,
            check (a), and one profiled decode window at the longest
            prompts with the span decode's share of the device time;
6c. engine_chunked — the same engine with prefill_chunk=64 and
            prefix_cache=True on requests whose prompts share a 64-256-token
            prefix and on engine_long's prompts, beside the same requests
            without the options: tokens at temperature 0 equal to theirs
            and to the plain path's (check (a)), prefix hits, the span
            chunk, span decode and LayerNorm launches; TTFT, ITL and
            tokens/s of both;
6d. engine_paged — E's engine on the paged arena (blocks of 16, the
            fixed arena's 512 blocks) in turns with the fixed engine: tokens
            equal (margin rule) and check (a), tokens/s, TTFT and ITL, the
            paged kernels and K3 launched and no flash forward; E-chunked's
            prefix workload with paged=True (hits, shared blocks, tokens as
            without options); one profiled decode window; a preemption at
            config A (both requests as their runs alone, the pool whole
            after); bench.py:643-700's equal-bytes concurrency >= 1.5x;
6e. engine_quant — int8 and int4 engines on config A: flash tokens as
            naive's (margin rule on the quantized oracle), one profiled int8
            decode window, one prompt's
            layer-0 codes and scales bit-equal to quantize_rows_np of the
            fp engine's rows, the int8 preemption identical to the runs
            alone, equal-bytes concurrency >= 2x for int8
            (bench.py:825-900), and score() agreement of int8 with the fp
            engine >= 0.95 on a d128L4 stand-in trained through the port's
            SparkModel on the bench's periodic data (int4 reported);
6f. engine_chunk_shapes — the (B, C, table span) shapes the paged chunk
            was launched at in engine_paged and engine_quant, with counts;
            fails on a merge-kernel launch there (at config A's spans the
            splits merge in a thread-block cluster);
6g. engine_spec — speculative decoding and the SLO policy at config A's
            width: config A trained through the port's SparkModel on the
            reference bench's periodic sequences until its greedy
            continuations are periodic (bench.py:1145-1196), then the
            bench's lookup-friendly workload (32 requests, 16-token
            prompts, 48 new tokens, spec_k 4, 8 slots) through engines in
            turns (2 warm-up runs, 3 timed rounds each): speculation off,
            n-gram on the fixed arena, on the paged arena in fp and int8,
            an adversarial drafter, self-speculation through
            DraftModelDrafter, and FairSharePolicy over two tenants with
            two deadline classes. Gates: every engine's tokens equal the
            off engine's (margin rule), acceptance >= 0.5 on n-gram
            (bench.py:1265), the adversarial engine throttled with its
            tokens unchanged, self-speculation accepting drafts, the pools
            whole, one span-chunk launch a layer for every verify round
            (and every catch-up chunk of the draft model), and a submit
            burst past max_queue_tokens refused for the heavy tenant
            only. Printed: decode-only tokens/s of each engine, the
            on / off and adversarial / off ratios, acceptance rates and
            TTFT p50 per tenant;
6h. gateway — the serving front door at config A's full width: the
            engine phase's engine (16 slots, windows of 16) behind a
            Gateway, E's 48 requests from 16 client threads over
            http.client (half SSE, half JSON, 4 in one batch-form POST) in
            turns with the same engine in process, 3 rounds: tokens over
            HTTP equal to the in-process tokens (margin rule), X-Request-Id
            equal to the body's rid, /healthz 200 "ok" with the watchdog's
            report, /debug/engine and a request's trace parsing, and
            /metrics' tokens, finished and admission counters equal to
            stats(); tokens/s over the wire and in process and the wire's
            TTFT p50 (medians). Then request migration on the paged arena
            in fp and int8: two engines (E's options, blocks of 16, 512
            blocks) behind their own gateways, 8 of E-long's prompts
            streaming from A, 4 exported through
            POST /v1/requests/{rid}/export once they hold 8 tokens and
            POSTed to B's /v1/migrate: every stream's tokens equal an
            unmigrated run's (margin rule), A's stored rows, the record's
            and B's resumed rows the same bytes, both pools whole, an fp
            record refused by the int8 engine; record bytes and export /
            import milliseconds. Then telemetry's host cost: E's engine
            with the registry on and built under null mode in turns, 3
            rounds: tokens/s, and the synchronizing CUDA calls of one run
            (torch.cuda.set_sync_debug_mode's warnings) equal in both
            modes. Its launches (the served runs, not the checks) are
            printed by kernel;
6i. fleet — the serving fleet at config A's full width: two paged
            replicas of E's engine (blocks of 16, 512 blocks, preemption,
            the prefix cache) on the one card behind a Router; E's 48
            requests behind 3 system prompts of 32 tokens (a group's first
            request alone, then the rest at once). In turns with one engine,
            2 rounds: tokens equal the one engine's (margin rule), router
            and one-engine tokens/s and TTFT p50 printed; a round-robin
            router on the same prompts (prefix hits at most the affinity
            router's); a drain in the middle of the streams (migrated,
            none dropped or doubled, tokens equal); a ReplicaKiller kill in
            the middle of the streams (re-driven token-exact, delivered =
            generated less stale, replica_down fired then cleared on
            restore_replica, the dead replica's arena freed);
6j. deploy — train-while-serving at the same width, two replicas on their
            own copies of the weights: a VersionLedger publishes the
            weights 3 times (same content) over a socket store of one
            shard, then two, while the router serves pass after pass and
            each replica's WeightSubscriber polls over the wire (each
            generation applied exactly once, tokens equal steady state's,
            p99 ITL during pushes against steady printed); a
            CanaryController with a noisy candidate and an EngineStaller on
            the canary past its requests' TTFT deadlines (slo_burn fires,
            rollback, tokens equal the baseline's, the watchdog fired once
            and cleared once), then a clean window (promoted fleet-wide,
            tokens equal a fresh engine's on those weights); a ShardKiller
            on one of two journaled shards during a publication through a
            DeployChaosStore (both replicas converge, no generation applied
            twice); a warm record refused across generations and accepted
            once re-stamped. Publication, pull and apply ms printed;
6k. switch_serve — SW-A, the Switch LM at config A's widths (8 experts
            of 2,048, top-2, capacity factor 4.0 so that nothing drops):
            generate with and without the KV cache on serve's prompts, then
            E's 48 requests through E's engine on the fixed arena, the paged
            arena (blocks of 16, 512 blocks) in fp and int8, chunked prefill
            with the prefix cache on E-chunked's workload, and n-gram
            speculative decoding; E's engine over config A and SW-A's in
            turns. Gates: the kernels' launches, teacher-forced logits within
            1e-3 of the plain path (plain attention and LayerNorm, the dense
            moe_ffn_reference), every emitted token as the plain argmax
            and every engine's tokens as generate(kv_cache=True)'s (the
            chunked engine's as the fixed engine's on its workload, the int8
            engine's as its naive twin's on the quantized oracle) where the
            top-2 margin is >= 1e-3, and the synchronizing calls of one E run
            line for line those of config A's. Printed: launches, tokens/s
            and TTFT against E's, the MoE layers' share of one profiled
            decode window's device time;
6l. switch_train — SW-T, the Switch classifier at T's widths (8 experts,
            top-2, capacity factor 1.5): the first-step gradients (task loss
            plus load-balance losses, 16 rows) within 1e-3 of the plain
            path's; SparkModel.fit as T (batch 128, 512 rows, 2 epochs,
            fp32) with every layer's load-balance loss added each step and
            a finite, descending loss; step time, tokens/s against T's, peak
            memory, first-choice expert fractions, the MoE layers' share of
            a profiled training step; then one epoch on 4 workers of the
            card: synchronous replicas bit-identical to the master,
            asynchronous/batch's master the mean of the replicas;
6m. gang   — T trained by gangs of processes through
            ``python -m elephas_tpu_torch.launch`` on the card, 2 worker
            slots a rank (128 rows, 32 a worker step, 3 epochs), each in
            turn with the same fit in this process over force_devices of
            the same worker count: a world of one rank over NCCL; two
            ranks sharing the card over gloo (its collectives staged
            through host memory), rank 1 exiting 17 after the first
            epoch's snapshot and the launcher restarting the gang from it
            (--max-restarts 1 --restart-from). Gates: the ranks' weight
            digests and histories equal, each gang's final digest
            bit-equal to the in-process fit's, its history (both
            generations' epochs) equal, the flash and LayerNorm kernels
            launched on every rank. Printed: seconds of each epoch after a
            fit's first, gang and in-process, and each rank's start,
            import, join, build and fit seconds;
6n. sp_prefill — config A's paged engine (E's options) with sp_prefill
            over meshes naming cuda:0 2 and 4 times, ring and Ulysses,
            prompts of 300-500 tokens padded to 512, in turns with the
            engine without it: ring_attention_sharded and
            ulysses_attention_sharded within 1e-5 of max(1, |out|) of the
            plain flash forward over the whole sequence (causal and not),
            the ring's gradients within 1e-5; tokens equal the paged
            engine's (margin rule), the paged engine's checked by (a); each
            long prompt's flash-forward launches exactly W·(W+1)/2 (ring)
            or W (Ulysses) a layer; TTFT p50 of each engine printed;
6o. tp_train — T through SparkModel(model_parallel=2) on a 2 x 2
            ('data', 'model') mesh naming cuda:0 four times
            (force_devices(4)), synchronous/epoch then hogwild/batch (256
            rows, batch 128, 2 epochs, fp32), each in turn with the
            ShardedTrainer on 2 data replicas at model_parallel=1 and with
            the data-parallel runner at 2 workers (the same rows a step),
            from the same weights. Gates: history and every final weight
            within 1e-4 of each of those fits'; the flash forward launched
            once a shard (4 heads of 8) a layer a copy a step, the
            LayerNorm kernels once a norm a copy a step; a sharded
            checkpoint (one file a shard, none holding a sharded variable
            whole) restored after one more epoch bit-equal to what was
            saved. Printed: the second epoch's seconds of each fit (the
            same synchronized epoch callback), peak memory, bytes a shard
            against the whole model's;
6p. tp_generate — config A's generate over dp_tp_mesh(2,
            data_parallel=2) naming cuda:0 four times (2 heads of 4 a
            shard), kv_cache False and True, serve's 8 prompts one a call
            and the 8 cut to 8 tokens in one call, 32 steps at temperature
            0, in turns with unmeshed generate. Gates: tokens equal; a
            sharded copy's first-step logits within 1e-4 of max(1,
            |logit|) of the whole model's; the flash forward (kv_cache
            False) and the span decode (True) launched once a shard a layer
            a data copy a step. Printed: seconds meshed and unmeshed,
            and of building the sharded copies (every meshed call does);
7. profile — one more training step (fp32, then bf16, then ResNet-50),
            generate() at config A batch 1
            with rope off and on, and one engine decode window, under
            torch.profiler: device time by kernel class (GEMMs, flash,
            span decode, LayerNorm, elementwise, ...) and the device's
            idle share; for generate and the engine also an unprofiled run
            with the host time spent in each kernel wrapper;
8. times  — kernel, plain version and the PyTorch library call (a
            yardstick the port never calls: scaled_dot_product_attention,
            with a boolean mask for the span decode, and
            torch.nn.functional.layer_norm and its backward) at the main
            paths' shapes, beside the card's bound. ``ms``, ``plain_ms``
            and ``library_ms`` are eager: CUDA events around 50 calls
            made from Python (what a caller waits, host included).
            ``device_ms``, ``plain_device_ms`` and ``library_device_ms``
            time the replay of a CUDA graph of the 50 calls: device time,
            no host gaps (the LayerNorm rows graph the kernel and the
            library). At the training shape also the plain flash backward
            per layer and SDPA's forward + autograd backward. The span
            decode also at each split count of SPLIT_SWEEP, with the
            host time of its workspace allocation. The span chunk at 16
            slots of 64 rows (where the first design was timed), at the engine's launch
            (one slot through the slot map, every span bucket) and at a
            512-row chunk from position 0, beside a masked SDPA over [B, H,
            C, span], its bound at the 3xTF32 rate, and at each split
            count of CHUNK_SPLIT_SWEEP. LayerNorm also as the
            serving paths call it: the entry layer_norm against
            torch.nn.functional.layer_norm, both under inference_mode, at
            the engine's, generate's and the training rows; and a sweep of
            the forward's rows per block (printed on a line of its own);
            the paged kernels in every stored type at their gated shapes
            (the paged chunk also at the engine's most frequent launch
            shape, with the positions the engine gave it) beside their
            plain versions, masked SDPA over the span gathered
            beforehand and the gather-and-dequantize time; and K1b at T's
            tensor-parallel shard (B128 S256 H4 D128) and the span decode
            at config A's (B4 H2 D128, span 128);
8b. ln_host_breakdown — where a LayerNorm call's host time goes (the
            entry, the autograd Function, checks, allocations, device
            guard, stream query, ctypes marshalling, the launch) beside
            torch.nn.functional.layer_norm's.

Then the card's nvidia-smi line, the {"kernels": [...]} line (launches
summed over the serve, train, train_bf16, train_workers, train_stream,
engine, engine_chunked, engine_paged, engine_quant, engine_spec, gateway,
fleet, deploy, switch_serve, switch_train, gang, sp_prefill, tp_train and
tp_generate paths, the flash forward's on the last four also apart in
``launches_by_path``, as the LayerNorm kernels' and the span decode's on
the last two, with the flash forward's and the span decode's times at
the tensor-parallel shard shapes in ``tp_shard``,
times at config A's
attention shape, at the training rows, at the engine's decode shape and
its chunk launch at span 256, fp32; the paged decode at span 128 and the
paged chunk's one-row launch at span 256, fp), and last {"ok": true, "device": {...}}. Exits non-zero with no result when CUDA is
not available or the package is not beside this script (the reason on
standard error); its first line, printed before torch is imported, names
the interpreter and the script, and an uncaught exception prints its
traceback and exits 1.

``--times-only`` runs the card, serve, engine, engine_long, engine_chunked,
engine_paged,
the engine and generate profiles, the flash, span-decode, span-chunk and
LayerNorm times phases (and the paged ones) and the LayerNorm host
breakdown alone (the span-chunk and paged phases where the package has
those kernels), for the elephas_tpu_torch package in
DIR (default: beside this script), building its kernels as that package
builds them: run it for two checkouts in turns on one card to compare
them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter

if __name__ == "__main__":
    # before torch loads: a run that dies importing it still says where it ran
    print(f"chip_smoke: python {sys.version.split()[0]}, {os.path.abspath(__file__)}",
          flush=True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the flash kernel runs fp32 as 3xTF32: three TF32 products per product
PEAK_3XTF32_S = 495e12 / 3

# config A: the serving bench's on-chip LM (bench.py, --preset serving);
# config B: transformer_lm()'s defaults
CONFIGS = {
    "A": dict(vocab_size=8192, maxlen=512, d_model=512, num_heads=4, num_layers=6),
    "B": dict(vocab_size=32000, maxlen=256, d_model=256, num_heads=4, num_layers=4),
}
STEPS = 32
PROMPT_LENS = np.linspace(8, 40, 8).astype(int)  # 8 prompts, 8..40 tokens

# kernel vs plain version: (layout, B, S, H, D)
KERNEL_CASES = [
    ("packed", 8, 512, 4, 128),
    ("packed", 8, 256, 4, 64),
    ("packed", 8, 256, 3, 64),
    ("bhsd", 8, 512, 4, 128),
    ("packed", 8, 256, 8, 32),
    ("packed", 8, 256, 16, 16),
    ("packed", 1, 512, 4, 128),  # config A at generate's batch 1
    ("packed", 128, 256, 8, 128),  # the training shape
    # tensor-parallel shards (tp_train, tp_generate): T's heads over a 2-way
    # model axis, the one copy's global batch and a replica's half; config
    # A's over it, at a generate call's rows of one data copy
    ("packed", 128, 256, 4, 128),
    ("packed", 64, 256, 4, 128),
    ("packed", 1, 512, 2, 128),
    ("packed", 4, 512, 2, 128),
]
TOL_OUT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_LSE = 1e-4
TOL_LOGITS = 1e-3
MARGIN = 1e-3

# LayerNorm kernels vs plain version: rows N, width d and the offset in
# elements of x's start from an aligned allocation (a contiguous view that
# is not 16-byte aligned takes the scalar route): the training path (batch
# 128 x 256 tokens at d 1024), generate's rows for configs A and B (one
# prompt: maxlen rows), the engine's decode rows (16 slots), a ragged case,
# an odd width and A's and E's rows off alignment
LN_CASES = [(32768, 1024, 0), (512, 512, 0), (16, 512, 0), (256, 256, 0), (1000, 200, 0),
            (37, 333, 0), (16, 512, 1), (512, 512, 1)]
LN_EPS = 1e-6
# y and dx: absolute in fp32 (summation order); in bf16 relative to
# max(1, |value|), since one bf16 rounding of a value in [4, 8) is
# already 0.03; mean/rstd relative; dgamma/dbeta relative to their
# largest magnitude (summation order only)
TOL_LN_Y = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_LN_STATS = 1e-5
TOL_LN_DX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_LN_DPARAM = 1e-4

# the reference's headline training configuration (bench.py, --preset full
# --model transformer): d_model 1024, 8 heads of 128, 4 layers, S 256,
# vocab 8192, 2 classes, batch 128, 4 batches; trained here in fp32
TRAIN = dict(vocab_size=8192, maxlen=256, num_classes=2, d_model=1024, num_heads=8,
             num_layers=4, dropout=0.0)
TRAIN_ROWS, TRAIN_BATCH, TRAIN_EPOCHS = 512, 128, 2
# T again on WORKERS workers of the one card (force_devices): the same
# global batch, WORKER_BATCH rows a worker step. The workers' mean
# first-step gradient against one model's on their 128 rows, relative to
# each tensor's largest; the master against the float64 mean of the
# replicas before the last average, the same way; predictions on
# PREDICT_ROWS rows before and after save/load
WORKERS = 4
WORKER_BATCH = TRAIN_BATCH // WORKERS
TOL_MEAN_GRAD = 1e-4
TOL_MASTER_MEAN = 1e-6
PREDICT_ROWS = 256
# kernel vs plain gradients, relative to each tensor's largest plain
# gradient: fp32, and bf16 (the train_bf16 phase: the same configuration
# in the bench's mixed_bfloat16)
TOL_GRAD = 1e-3
TOL_GRAD_BF16 = 2e-2

# the reference bench's ResNet-50 cell (bench.py:4523-4529, --preset full):
# 224x224x3, 1000 classes, mixed_bfloat16, batch 256, 4 batches of
# _synthetic (bench.py:130, seed 0); 2 epochs here. Its first step's
# probabilities against the same weights under the float32 policy, for
# the weights of seed 0 and of a second seed (_r50_agreement): the mean
# KL(float32 || bf16) within R50_KL. Read (H100): 9.2e-3 and 9.4e-3; the
# float32 forward of the input rounded to bf16 reads 1.7e-3 (the untrained
# network carries a rounding far), another row's output 3.5e-2 (its output
# hardly depends on the input). The floor fails a forward that does not
# compute in bf16, the ceiling one that answers for another input.
R50 = dict(input_shape=(224, 224, 3), num_classes=1000)
R50_BATCH, R50_BATCHES, R50_EPOCHS = 256, 4, 2
R50_SEEDS = (0, 1)
R50_KL = (3e-3, 2e-2)

# train_stream: T in mixed_bfloat16 (S-T) streamed from a memmap of
# STREAM_T_ROWS rows in blocks of STREAM_BLOCK_STEPS worker steps, held bit
# for bit to the staged fit at W = 1 and at W = WORKERS (WORKER_BATCH rows
# a worker step); ResNet-50 (S-R50) streamed in blocks of STREAM_BLOCK_STEPS
# steps from STREAM_R50_ROWS images in a float32 ndarray (1.23 GB, over the
# 1 GiB threshold, so the default fit would stream it too), its
# loss history within TOL_STREAM_R50 (relative) of the staged fit from the
# same weights (cuDNN's backward may sum in another order), timed in turns
# against the staged fit STREAM_R50_ROUNDS times
STREAM_T_ROWS, STREAM_BLOCK_STEPS, STREAM_EPOCHS = 1024, 2, 2
STREAM_R50_ROWS, STREAM_R50_ROUNDS = 2048, 2
TOL_STREAM_R50 = 1e-3
# ml_pipeline: examples/ml_pipeline.py's configuration (rows, features,
# hidden units, batch, epochs, Adam's learning rate) and its accuracy bar
PIPELINE = dict(rows=3000, features=20, hidden=32, batch=64, epochs=5, lr=1e-2)
PIPELINE_BAR = 0.7

# hyperparam: examples/hyperparam_optimization.py's configuration (its
# synthetic MNIST rows, evals, epochs, batch, seed) and the worker slots and
# slots a trial of the second run
HYPER = dict(rows=3000, max_evals=8, epochs=2, batch=64, seed=0)
HYPER_SLOTS, HYPER_PER_TRIAL = 4, 2

# one fit each of the smaller zoo models at their builders' defaults, on
# synthetic data of their shapes (rows, batch, epochs)
ZOO_ROWS, ZOO_BATCH, ZOO_EPOCHS = 2048, 128, 1

# span decode vs plain version, over every span bucket of A's maxlen: the
# engine's 16 slots and 4 heads at every head dim (config A's 128, B's 64),
# where the span is split over several blocks, and 64 slots of 8 heads,
# where B·H alone fills the card (one split)
SPAN_CASES = [(16, 4, 128), (16, 4, 64), (16, 4, 32), (16, 4, 16), (64, 8, 64),
              (1, 2, 128), (4, 2, 128)]  # tp_generate's shards: config A's heads over 2
SPAN_MAXLEN = 512
# relative to max(1, |out|): the same online softmax in another order
TOL_SPAN = 1e-5

# the engine at config A's full width as the reference's serving bench runs
# it (bench.py:1915-1990): 16 slots, prompt lengths and budgets cycling
ENGINE = dict(num_slots=16, steps_per_sync=16)
ENGINE_PROMPT_LENS = (8, 12, 16, 24, 40)
ENGINE_BUDGETS = (16, 32)
ENGINE_REQUESTS = 48
# the long-span pass: the same engine and model, 16 requests from
# np.random.default_rng(1), all at once, prompts of a few hundred tokens
# against a 512-token context, so decode spans reach the 512 bucket
# (440 + 48 - 1 + 16 <= 512)
ENGINE_LONG_PROMPT_LENS = (200, 280, 360, 440)
ENGINE_LONG_BUDGET = 48
ENGINE_LONG_REQUESTS = 16

# span chunk vs plain version, within TOL_SPAN: 16 slots of 4 heads of 128
# with 64 rows a slot (slots, heads, head dim, rows a slot) over the spans
# the engine's chunks attend, also at chunk widths 1, 5 (a speculative verify
# window: VERIFY_W = spec_k + 1 rows for every slot), 100 (two ragged row
# groups) and 512 (a suffix bucket of A's maxlen); the engine's
# own launch, one prefilling slot of its 16-slot arena through the slot map
# (CHUNK_ENGINE: rows, heads, head dim, rows a slot) at every span bucket;
# and a prefix-hit pass, 4 slots through the slot map with 32 suffix rows
CHUNK_CASE = (16, 4, 128, 64)
CHUNK_SPANS = (128, 256, 512)
VERIFY_W = 5
CHUNK_WIDTHS = (1, VERIFY_W, 64, 100, 512)
CHUNK_ENGINE = (1, 4, 128, 64)
CHUNK_PREFIX_HIT = (4, 4, 128, 32)
# engine_chunked: config A's engine with these options, on prompts that
# share a prefix of each CHUNKED_PREFIX_LENS length (CHUNKED_PER_PREFIX
# requests each, suffixes of 8-40 tokens, ENGINE_BUDGETS) and on
# engine_long's prompts
CHUNKED = dict(prefill_chunk=64, prefix_cache=True)
CHUNKED_PREFIX_LENS = (64, 128, 192, 256)
CHUNKED_PER_PREFIX = 4

# the paged kernels vs their plain versions and the arena kernels, every
# stored type: the engine's decode shape (slots, heads, head dim, block) over
# tables of 8, 16 and 32 blocks (shuffled ids, sentinel padding, stale
# cursors), its chunk launches (rows, C: 16 slots of 64 rows, the paged
# engine's one-row chunk pass) and a 512-row chunk from position 0
PAGED_CASE = (16, 4, 128, 16)
PAGED_SPANS = (128, 256, 512)
# the decode also at a block of one position, where every key has its own
# table entry
PAGED_DECODE_BLOCKS = (16, 1)
PAGED_DTYPES = ("fp", "int8", "int4")
PAGED_CHUNKS = ((16, 64), (16, VERIFY_W), (1, 64))
PAGED_C512 = (1, 512)
# the paged chunk also at blocks of one position over spans 128-512, and at
# one row of 64 over a table span of PAGED_OVER_CLUSTER keys (16 splits: past
# the 8 a cluster merges, so the workspace and the merge kernel)
PAGED_CHUNK_BLOCK1 = (1, 64, 1)
PAGED_OVER_CLUSTER = 1024
# engine_paged: E's engine on the paged arena, its pool the fixed arena's
# rows (16 slots x 32 blocks of 16, as bench.py:2775-2780 sizes fleet
# engines); fixed and paged passes in turns, PAGED_ROUNDS each
ENGINE_PAGED = dict(paged=True, block_size=16, num_blocks=512)
PAGED_ROUNDS = 3
# a preemption at config A: a low-priority request of PREEMPT_LOW prompt
# tokens decoding when one of PREEMPT_HIGH arrives at priority 1, in a pool
# of PREEMPT_BLOCKS blocks that cannot hold both
PREEMPT_ENGINE = dict(num_slots=4, steps_per_sync=4, paged=True, block_size=16,
                      num_blocks=20, preemption=True)
PREEMPT_LOW, PREEMPT_HIGH, PREEMPT_BUDGET = 200, 120, 48
# engine_quant: the agreement stand-in (bench.py:825-900): d128L4, trained on
# the periodic data of bench.py:868-880 through the port's SparkModel on
# QUANT_WORKERS worker slots; QUANT_PROMPTS prompts of QUANT_P_LEN tokens,
# QUANT_COMPLETION tokens scored
QUANT_MODEL = dict(vocab_size=512, maxlen=128, d_model=128, num_heads=4, num_layers=4,
                   dropout=0.0, lr=1e-2, seed=0)
QUANT_WORKERS, QUANT_EPOCHS, QUANT_BATCH = 4, 4, 32
QUANT_PROMPTS, QUANT_P_LEN, QUANT_COMPLETION = 6, 16, 48
QUANT_AGREEMENT = 0.95
# engine_spec: config A trained on the reference bench's periodic
# sequences (bench.py:1189-1196: rng 29, 512 rows of tokens 2..5, period
# 4), an epoch at a time up to SPEC_EPOCHS_MAX, until greedy continuations
# of its prompts are periodic (at batch 32 and lr 1e-3 it stalls near
# log 4, uniform over the alphabet; batch 8 at lr 1e-4 took 3 epochs on
# the H100); its workload (bench.py:1201-1206):
# SPEC_REQUESTS requests of SPEC_P_LEN-token periodic prompts, SPEC_BUDGET
# new tokens, spec_k SPEC_K, SPEC_SLOTS slots; SPEC_ROUNDS timed rounds
# after 2 warm-up runs; the policy engine's tenants and deadline classes,
# and a burst past SPEC_MAX_QUEUE_TOKENS (SPEC_BURST requests of tenants
# "a" and "b")
SPEC_TRAIN = dict(rows=512, batch=8, lr=1e-4)
SPEC_EPOCHS_MAX = 8
SPEC_REQUESTS, SPEC_P_LEN, SPEC_BUDGET, SPEC_K, SPEC_SLOTS = 32, 16, 48, 4, 8
SPEC_ROUNDS = 3
SPEC_ACCEPTANCE = 0.5
SPEC_TENANTS = {"a": 1.0, "b": 3.0}
SPEC_DEADLINES_MS = (200.0, 2000.0)
SPEC_MAX_QUEUE_TOKENS = 640
SPEC_BURST = (24, 4)

# the Switch mixture-of-experts family (switch_serve, switch_train and the
# MoE rows of kernel). SW-A: config A's widths with 8 experts, top-2
# (docs/API.md:757) and capacity factor 4.0 (the docs' 2.0 raised so that
# k·cf = E: nothing drops, and every serving path routes to the same
# tokens), experts of 4·d_model = 2,048 units, about 115 M parameters,
# fp32, seed 0. SW-T: T's widths with 8 experts, top-2 and the builder's
# capacity factor 1.5 (tokens drop), fp32, Adam at 1e-5, TRAIN_ROWS rows
# of _labelled_tokens, batch TRAIN_BATCH, TRAIN_EPOCHS epochs: at the
# builders' 1e-3 the loss rises at these widths (T's own on its random
# labels from 6.32 to 7.87, SW-T's on labelled rows from 6.95 to 9.01), and
# at 1e-4 SW-T's still (6.88 to 8.85, H100), the mean-pooled head
# saturating; a descending loss shows that the training works. Its gradient
# check on SWITCH_GRAD_ROWS
# rows (4,096 tokens: the plain path's dense routing tensors [T, E, C]
# grow as T², 12.9 GB each at the batch's 32,768 tokens); then
# SWITCH_WORKER_EPOCHS epoch on WORKERS workers. Plain teacher-forced
# forwards take SWITCH_PLAIN_ROWS rows at a time for the same reason. SW-A
# and E's engines are timed in turns, SWITCH_ROUNDS rounds after a warm-up.
SWITCH_A = dict(CONFIGS["A"], num_experts=8, k=2, capacity_factor=4.0, dropout=0.0)
SWITCH_T = dict(TRAIN, num_experts=8, k=2, lr=1e-5)
SWITCH_GRAD_ROWS = 16
SWITCH_WORKER_EPOCHS = 1
SWITCH_PLAIN_ROWS = 8
SWITCH_ROUNDS = 2
# moe_ffn against its dense plain version: (case, tokens T, d_model, expert
# hidden, capacity factor) at SW-A's decode (16 slots) and prefill (a
# 512-token forward), and a 4,096-token slice of an SW-T layer with and
# without drops; 8 experts, top-2, exact GELU. Outputs within TOL_MOE_OUT
# of max(1, |out|), gradients within TOL_MOE_GRAD of each tensor's largest,
# the kept (token, expert, place) routing equal
MOE_CASES = (("SW-A_decode", 16, 512, 2048, 4.0), ("SW-A_prefill", 512, 512, 2048, 4.0),
             ("SW-T_slice_cf1.5", 4096, 1024, 4096, 1.5),
             ("SW-T_slice_cf0.5", 4096, 1024, 4096, 0.5))
MOE_EXPERTS, MOE_K = 8, 2
TOL_MOE_OUT = 1e-6
TOL_MOE_GRAD = 1e-5

TIMING = "CUDA events, mean of 50 launches after 5 warm-up, median of 3 rounds in turns"
GRAPH_TIMING = ("*device_ms: CUDA events around the replay of a CUDA graph of 50 calls "
                "(captured after 3 warm-up calls), median of 3 rounds in turns; the rest: "
                + TIMING)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card():
    emit({
        "phase": "card",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })


def _instantiation(mangled):
    """A kernel's mangled name, shortened: '..flash_fwd_kernelIfLi128EE..'
    -> 'flash_fwd_kernel<float32, 128>', '..ln_fwd_kernelIfLi4EE..' ->
    'ln_fwd_kernel<float32, 4>', '..span_decode_kernelILi64ELi8EE..' ->
    'span_decode_kernel<64, 8>', '..span_decode_merge_kernelILi64EE..' ->
    'span_decode_merge_kernel<64>', '..paged_span_chunk_kernelILi64ELi1EE..' ->
    'paged_span_chunk_kernel<64, 1>'."""
    m = re.search(r"\d((?:flash|ln|span|paged_span)_\w*?kernel)I(f|13__nv_bfloat16)?"
                  r"((?:Li\d+E)*)", mangled)
    if not m:
        m = re.search(r"\d((?:flash|ln|span|paged_span)_\w*?kernel)", mangled)
        return m.group(1) if m else mangled
    dtype = [] if m.group(2) is None else ["float32" if m.group(2) == "f" else "bfloat16"]
    ints = re.findall(r"Li(\d+)E", m.group(3))
    return f"{m.group(1)}<{', '.join([*dtype, *ints])}>"


def _ptxas_report(log):
    """{instantiation: {registers, spill_stores, spill_loads}} from -Xptxas -v."""
    report, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            current = report.setdefault(_instantiation(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return report


# SASS instructions counted: op -> pattern. The flash kernels' tensor-core
# (HMMA), async-copy (LDGSTS) and ldmatrix (LDSM) instructions; in the
# LayerNorm forward, 16-byte global loads and stores and block barriers
SASS_OPS = {"HMMA": r"\bHMMA\b", "LDGSTS": r"\bLDGSTS\b", "LDSM": r"\bLDSM\b"}
LN_SASS_OPS = {"ldg128": r"\bLDG\.E\.(?:\w+\.)*128\b", "stg128": r"\bSTG\.E\.(?:\w+\.)*128\b",
               "bar": r"\bBAR\.SYNC"}


def _sass_counts(library, kernel="flash_fwd_kernel", ops=SASS_OPS):
    """{instantiation: {op: count}} of the ``ops`` patterns in the
    instantiations of a built library whose name starts with ``kernel``,
    from cuobjdump --dump-sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, current = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = _instantiation(m.group(1))
            current = counts.setdefault(name, dict.fromkeys(ops, 0)) \
                if name.startswith(kernel) else None
            continue
        if current is not None:
            for op, pattern in ops.items():
                if re.search(pattern, ln):
                    current[op] += 1
    return counts


def _ln_sass_faults(ln_sass):
    """The forward's design checks: every one-warp-a-row instantiation
    (ln_fwd_vec_kernel, ln_fwd_kernel<T, VPT, 1>) has no block barrier,
    and every vector one moves x and y in 16-byte loads and stores."""
    faults = []
    one_warp = {k: c for k, c in ln_sass.items()
                if k.startswith("ln_fwd_vec_kernel") or k.endswith(", 1>")}
    vec = [k for k in one_warp if k.startswith("ln_fwd_vec_kernel")]
    if len(vec) != 7 or len(one_warp) != 19:
        faults.append(f"{len(vec)} vector and {len(one_warp)} one-warp forward "
                      f"instantiations, want 7 and 19")
    faults += [f"{k} has {c['bar']} block barriers" for k, c in one_warp.items() if c["bar"]]
    faults += [f"{k} lacks 16-byte loads or stores" for k in vec
               if not (ln_sass[k]["ldg128"] and ln_sass[k]["stg128"])]
    return faults


def phase_build():
    from elephas_tpu_torch.ops import _native

    t0 = time.perf_counter()
    targets = _native.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: _ptxas_report(log["ptxas"]) for name, log in _native.build_log.items()}
    sass = _sass_counts(targets["flash_fwd"])
    span = sorted(_sass_counts(targets["span_decode"], "span_decode"))
    chunk_sass = _sass_counts(targets["span_chunk"], "span_chunk")
    chunk = sorted(chunk_sass)
    paged_decode_sass = _sass_counts(targets["span_decode"], "paged_span_decode")
    paged_decode = sorted(paged_decode_sass)
    paged_sass = _sass_counts(targets["span_chunk"], "paged_span_chunk")
    ln_sass = _sass_counts(targets["layer_norm"], "ln_fwd", LN_SASS_OPS)
    emit({"phase": "build", "seconds": seconds, "sources": sorted(_native.SOURCES),
          "ptxas": ptxas, "flash_sass": sass, "span_decode_instantiations": span,
          "span_chunk_sass": chunk_sass, "paged_span_decode_sass": paged_decode_sass,
          "paged_span_chunk_sass": paged_sass, "layer_norm_fwd_sass": ln_sass})
    spills = [f"{name}: {r}" for log in ptxas.values() for name, r in log.items()
              if r.get("spill_stores") or r.get("spill_loads")]
    missing = [name for name, c in sass.items() if not (c["HMMA"] and c["LDGSTS"])]
    # the span chunk's split kernels (not its merge) run on the tensor cores
    # from a cp.async ring
    missing += [name for name, c in chunk_sass.items()
                if name.startswith("span_chunk_kernel") and not (c["HMMA"] and c["LDGSTS"])]
    # the paged chunk's run on the tensor cores too, and fill their stages
    # by cp.async in every stored type (fp rows, int8 / int4 codes and scales)
    missing += [name for name, c in paged_sass.items() if not (c["HMMA"] and c["LDGSTS"])]
    # the paged decode fills its ring by cp.async in every stored type
    missing += [name for name, c in paged_decode_sass.items()
                if name.startswith("paged_span_decode_kernel") and not c["LDGSTS"]]
    ln_faults = _ln_sass_faults(ln_sass)
    # the span decodes' split kernels come in blocks of 4 and of 8 warps
    if spills or missing or len(sass) != 8 or len(span) != 12 or len(chunk) != 8 or ln_faults \
            or len(paged_decode) != 24 or len(paged_sass) != 12:
        raise AssertionError(f"build: spills {spills}; flash, span chunk or paged chunk "
                             f"kernels without HMMA or LDGSTS, or paged decode kernels "
                             f"without LDGSTS "
                             f"{missing}; {len(sass)} flash instantiations, "
                             f"want 8; span decode instantiations {span}, want 12 (split "
                             f"kernels at 4 head dims x 4 or 8 warps, merge kernels at 4 "
                             f"head dims), and span chunk "
                             f"instantiations {chunk}, want 8 (split and merge "
                             f"kernels at 4 head dims); paged decode {paged_decode}, want 24 "
                             f"(4 head dims x 3 stored types x 4 or 8 warps), and "
                             f"chunk {sorted(paged_sass)}, want 12 (4 head dims x 3 "
                             f"stored types); LayerNorm forward {ln_faults}")


def _synthetic_tokens(n, maxlen, vocab, classes, seed=0):
    """The reference bench's training data (bench.py, _synthetic_tokens)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, size=(n, maxlen)).astype(np.int32)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    return x, y


def _case_inputs(layout, b, s, h, d, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "packed":
        qkv = torch.randn(b, s, 3, h, d, generator=g, device=dev).to(dtype)
        return qkv, [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    return None, [q, k, v]


def _run_kernel(layout, qkv, qkv_views, scale, causal):
    from elephas_tpu_torch.ops import flash_attention as fa

    if layout == "packed":
        out, lse = fa._flash_forward_packed(qkv, scale, causal, 128, 128)
        return out.transpose(1, 2), lse
    return fa._flash_forward(*qkv_views, scale, causal, 128, 128)


def _kernel_flash(dev):
    from elephas_tpu_torch.ops.flash_attention import flash_forward_reference

    results, failures = [], []
    for n, (layout, b, s, h, d) in enumerate(KERNEL_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                qkv, views = _case_inputs(layout, b, s, h, d, dtype, dev, n)
                scale = d ** -0.5
                out, lse = _run_kernel(layout, qkv, views, scale, causal)
                ref_out, ref_lse = flash_forward_reference(*views, scale, causal)
                torch.cuda.synchronize()
                err_out = (out.float() - ref_out.float()).abs().max().item()
                err_lse = (lse - ref_lse.reshape(b * h, s)).abs().max().item()
                ok = err_out <= TOL_OUT[dtype] and err_lse <= TOL_LSE
                row = {"layout": layout, "B": b, "S": s, "H": h, "D": d,
                       "dtype": str(dtype).split(".")[-1], "causal": causal,
                       "err_out": err_out, "err_lse": err_lse, "ok": ok}
                results.append(row)
                if not ok:
                    failures.append(row)
    return results, failures


def _ln_inputs(n, d, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, d, generator=g, device=dev) * 3 + 1.5).to(dtype)
    gamma = torch.randn(d, generator=g, device=dev)
    beta = torch.randn(d, generator=g, device=dev)
    dy = torch.randn(n, d, generator=g, device=dev).to(dtype)
    return x, gamma, beta, dy


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _err(got, want):
    """fp32: the largest absolute difference; bf16: the largest difference
    relative to max(1, |want|)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp_min(1.0)
    return diff.max().item()


def _ln_route_want(d, offset, dtype):
    """The forward route a case should take: rows up to 1024 wide get one
    warp; 16-byte accesses need whole 16-byte rows and an aligned start."""
    if d > 1024:
        return "multi_warp"
    item = torch.finfo(dtype).bits // 8
    return "vector" if offset == 0 and d * item % 16 == 0 else "scalar"


def _kernel_layer_norm(dev):
    """Forward and backward against the plain versions on every LN_CASES
    case; the forward's route; and the serving route's y (no statistics,
    under inference_mode) bit for bit the training route's, on a second
    call and from a CUDA-graph replay."""
    from elephas_tpu_torch.ops import layer_norm as ln

    results, failures = [], []
    for n, d, offset in LN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, gamma, beta, dy = _ln_inputs(n, d, dtype, dev, n + d)
            if offset:
                buf = torch.empty(n * d + offset, dtype=dtype, device=dev)
                x = buf[offset:].view(n, d).copy_(x)
            y, mean, rstd = ln.layer_norm_forward(x, gamma, beta, LN_EPS)
            with torch.inference_mode():
                served = ln.layer_norm(x, gamma, beta, LN_EPS)
                again = ln.layer_norm(x, gamma, beta, LN_EPS)
                replayed = _graph_replay(lambda: ln.layer_norm(x, gamma, beta, LN_EPS))  # noqa: B023
            dx, dg, db = ln.layer_norm_backward(x, gamma, dy, mean, rstd)
            ry, rmean, rrstd = ln.layer_norm_forward_reference(x, gamma, beta, LN_EPS)
            rdx, rdg, rdb = ln.layer_norm_backward_reference(x, gamma, dy, rmean, rrstd)
            torch.cuda.synchronize()
            route = ln.forward_route(x, gamma, beta)
            bits = torch.equal(served, y) and torch.equal(again, y) \
                and torch.equal(replayed, y)
            row = {
                "N": n, "d": d, "offset": offset, "dtype": str(dtype).split(".")[-1],
                "route": route, "route_want": _ln_route_want(d, offset, dtype),
                "served_bits_equal_training_repeat_replay": bits,
                "err_y": _err(y, ry),
                "rel_err_mean": _rel(mean, rmean), "rel_err_rstd": _rel(rstd, rrstd),
                "err_dx": _err(dx, rdx),
                "rel_err_dgamma": _rel(dg, rdg), "rel_err_dbeta": _rel(db, rdb),
            }
            row["ok"] = (row["err_y"] <= TOL_LN_Y[dtype] and row["err_dx"] <= TOL_LN_DX[dtype]
                         and bits and route == row["route_want"]
                         and max(row["rel_err_mean"], row["rel_err_rstd"]) <= TOL_LN_STATS
                         and max(row["rel_err_dgamma"], row["rel_err_dbeta"]) <= TOL_LN_DPARAM)
            results.append(row)
            if not row["ok"]:
                failures.append(row)
    return results, failures


def _span_inputs(b, h, d, span, dev, seed):
    """q and a [b, SPAN_MAXLEN, h, d] arena pair cut to ``span``, with
    ragged int32 positions: 0 on lane 0, the span's last row on lane 1 and
    a stale cursor past the span on lane 2 (STALE_LANE)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=dev)
    arena = torch.randn(2, b, SPAN_MAXLEN, h, d, generator=g, device=dev)
    pos = torch.randint(0, span, (b,), generator=g, device=dev, dtype=torch.int32)
    pos[:3] = torch.tensor([0, span - 1, span + 7], dtype=torch.int32)[:b]
    return q, arena[0, :, :span], arena[1, :, :span], pos


STALE_LANE = 2


def _graph_replay(fn):
    """The output of one call of ``fn`` captured in a CUDA graph (after a
    warm-up call on a side stream) and replayed twice."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _kernel_span_decode(dev):
    """The span decode against flash_span_chunk on every SPAN_CASES shape
    and span bucket (splits and chunk as the wrapper picks them on this
    card); a second call and a CUDA-graph replay must give the same bits."""
    from elephas_tpu_torch.ops import flash_serving as fs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results, failures = [], []
    for b, h, d in SPAN_CASES:
        for span in fs.span_buckets(SPAN_MAXLEN):
            q, k, v, pos = _span_inputs(b, h, d, span, dev, span + d)
            out = fs.flash_span_decode(q, k, v, pos)
            again = fs.flash_span_decode(q, k, v, pos)
            replayed = _graph_replay(lambda: fs.flash_span_decode(q, k, v, pos))  # noqa: B023
            ref = fs.span_chunk_reference(q[:, :, None], k, v, pos[:, None])[:, :, 0]
            torch.cuda.synchronize()
            lanes = torch.arange(b, device=dev) != STALE_LANE
            diff = (out - ref).abs()[lanes]
            err = (diff / ref.abs().clamp_min(1.0)[lanes]).max().item()
            finite = bool(torch.isfinite(out).all())
            repeats = torch.equal(out, again) and torch.equal(out, replayed)
            splits, chunk = fs.span_splits(span, b * h, sms)
            row = {"B": b, "H": h, "D": d, "span": span, "splits": splits, "chunk": chunk,
                   "rel_err": err, "abs_err": diff.max().item(),
                   "stale_lane_finite": finite, "repeats_bit_for_bit": repeats,
                   "ok": err <= TOL_SPAN and finite and repeats}
            results.append(row)
            if not row["ok"]:
                failures.append(row)
    return results, failures


def _chunk_inputs(b, h, d, c, span, dev, seed, slots=None, offset=None):
    """Chunk queries ``[b, h, c, d]`` and an arena pair of ``slots`` (default
    ``b``) slots of SPAN_MAXLEN rows cut to ``span``, with int32 positions
    ``offset + 0..c-1``: at ``offset`` for every row, or at ragged offsets,
    0 on row 0, the chunk ending on the span's last row on row 1, and rows
    past the span (an engine's padded tail) on row 2."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, c, d, generator=g, device=dev)
    arena = torch.randn(2, slots or b, SPAN_MAXLEN, h, d, generator=g, device=dev)
    offs = torch.randint(0, max(1, span - c), (b,), generator=g, device=dev)
    if offset is None:
        special = torch.tensor([0, max(0, span - c), span - c // 2])[:b]
        offs[:len(special)] = special
    else:
        offs[:] = offset
    pos = (offs[:, None] + torch.arange(c, device=dev)[None, :]).to(torch.int32).contiguous()
    return q, arena[0, :, :span], arena[1, :, :span], pos


def _chunk_slot_map(b, slots, dev):
    """Rows ``b`` of an arena of ``slots`` slots, off its first ones (the
    last slots, in reverse), or None for an arena of ``b`` slots."""
    return None if slots is None else torch.arange(slots - 1, slots - 1 - b, -1, device=dev)


def _chunk_cases():
    """The gated span-chunk shapes: (name, (B, H, D, C), span, arena slots
    or None for B, offset or None for ragged offsets). The engine's chunk
    ends on its span bucket's last row (the bucket covers the chunk)."""
    b, h, d, _ = CHUNK_CASE
    c_engine = CHUNK_ENGINE[3]
    cases = [(f"C{c}", (b, h, d, c), span, None, None)
             for c in CHUNK_WIDTHS for span in CHUNK_SPANS]
    cases += [("engine", CHUNK_ENGINE, span, ENGINE["num_slots"], span - c_engine)
              for span in SPAN_TIMES]
    cases += [("prefix_hit", CHUNK_PREFIX_HIT, span, ENGINE["num_slots"], None)
              for span in CHUNK_SPANS]
    return cases


def _kernel_span_chunk(dev):
    """The span chunk against its plain version at every _chunk_cases shape
    (splits and chunk as the wrapper picks them); a second call and a
    CUDA-graph replay must give the same bits."""
    from elephas_tpu_torch.ops import flash_serving as fs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results, failures = [], []
    for name, (rows, h, d, c), span, slots, offset in _chunk_cases():
        q, k, v, pos = _chunk_inputs(rows, h, d, c, span, dev, span + rows + c, slots, offset)
        slot_map = _chunk_slot_map(rows, slots, dev)
        out = fs.flash_span_chunk(q, k, v, pos, slots=slot_map)
        again = fs.flash_span_chunk(q, k, v, pos, slots=slot_map)
        replayed = _graph_replay(
            lambda: fs.flash_span_chunk(q, k, v, pos, slots=slot_map))  # noqa: B023
        kk, vv = (k, v) if slot_map is None else (k[slot_map], v[slot_map])
        ref = fs.span_chunk_reference(q, kk, vv, pos)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = (diff / ref.abs().clamp_min(1.0)).max().item()
        repeats = torch.equal(out, again) and torch.equal(out, replayed)
        splits, chunk = fs.span_chunk_splits(span, rows * h, c, d, sms)
        row = {"case": name, "B": rows, "H": h, "D": d, "C": c, "span": span,
               "slot_map": slots is not None, "splits": splits, "chunk": chunk,
               "rel_err": err, "abs_err": diff.max().item(), "repeats_bit_for_bit": repeats,
               "ok": err <= TOL_SPAN and repeats and bool(torch.isfinite(out).all())}
        results.append(row)
        if not row["ok"]:
            failures.append(row)
    return results, failures


def phase_kernel(dev):
    """Each kernel against its plain version; returns each kernel's
    largest fp32 error (flash out, LayerNorm y, LayerNorm dx, span decode
    out)."""
    flash, flash_failures = _kernel_flash(dev)
    ln_rows, ln_failures = _kernel_layer_norm(dev)
    span_rows, span_failures = _kernel_span_decode(dev)
    chunk_rows, chunk_failures = _kernel_span_chunk(dev)
    paged_rows, paged_failures = _kernel_paged(dev)
    moe_rows, moe_failures = _kernel_moe(dev)
    emit({"phase": "kernel",
          "tol": {"flash_out": {"float32": TOL_OUT[torch.float32],
                                "bfloat16": TOL_OUT[torch.bfloat16]},
                  "flash_lse": TOL_LSE,
                  "ln_y": {"float32": TOL_LN_Y[torch.float32],
                           "bfloat16_of_max_1_abs_y": TOL_LN_Y[torch.bfloat16]},
                  "ln_mean_rstd_relative": TOL_LN_STATS,
                  "ln_dx": {"float32": TOL_LN_DX[torch.float32],
                            "bfloat16_of_max_1_abs_dx": TOL_LN_DX[torch.bfloat16]},
                  "ln_dgamma_dbeta_relative": TOL_LN_DPARAM,
                  "span_decode_of_max_1_abs_out": TOL_SPAN,
                  "span_chunk_of_max_1_abs_out": TOL_SPAN,
                  "paged_of_max_1_abs_out": TOL_SPAN,
                  "paged_against_arena_kernel": "bit-equal",
                  "moe_ffn_out_of_max_1_abs": TOL_MOE_OUT,
                  "moe_ffn_grad_of_largest": TOL_MOE_GRAD, "moe_ffn_routing": "equal"},
          "flash": flash, "layer_norm": ln_rows, "span_decode": span_rows,
          "span_chunk": chunk_rows, "paged": paged_rows, "moe_ffn": moe_rows})
    failures = (flash_failures + ln_failures + span_failures + chunk_failures + paged_failures
                + moe_failures)
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    f32 = [r for r in ln_rows if r["dtype"] == "float32"]
    return {
        "flash_fwd": max(r["err_out"] for r in flash if r["dtype"] == "float32"),
        "layer_norm_fwd": max(r["err_y"] for r in f32),
        "layer_norm_bwd": max(r["err_dx"] for r in f32),
        "span_decode": max(r["abs_err"] for r in span_rows),
        "span_chunk": max(r["abs_err"] for r in chunk_rows),
        "paged_span_decode": max(r["abs_err"] for r in paged_rows
                                 if r["kernel"] == "paged_span_decode"),
        "paged_span_chunk": max(r["abs_err"] for r in paged_rows
                                if r["kernel"] == "paged_span_chunk"),
    }


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32) for n in PROMPT_LENS]


def _launches():
    from elephas_tpu_torch.ops import flash_attention as fa
    from elephas_tpu_torch.ops import flash_serving as fs
    from elephas_tpu_torch.ops import layer_norm as ln

    return {"flash_fwd": fa.launches, "layer_norm_fwd": ln.fwd_launches,
            "layer_norm_bwd": ln.bwd_launches, "span_decode": fs.launches,
            "span_chunk": getattr(fs, "chunk_launches", 0),
            "paged_span_decode": getattr(fs, "paged_launches", 0),
            "paged_span_chunk": getattr(fs, "paged_chunk_launches", 0),
            "flash_fwd_bf16": fa.bf16_launches, "layer_norm_fwd_bf16": ln.fwd_bf16_launches,
            "layer_norm_bwd_bf16": ln.bwd_bf16_launches}


def _reset_launches():
    from elephas_tpu_torch.ops import flash_attention as fa
    from elephas_tpu_torch.ops import flash_serving as fs
    from elephas_tpu_torch.ops import layer_norm as ln

    fa.launches = ln.fwd_launches = ln.bwd_launches = fs.launches = fs.chunk_launches = 0
    fs.paged_launches = fs.paged_chunk_launches = 0
    fa.bf16_launches = ln.fwd_bf16_launches = ln.bwd_bf16_launches = 0


def _check_launches(what, before, want):
    """Launches since ``before`` against ``want`` (kernel → count)."""
    now = _launches()
    got = {k: now[k] - before[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")


def drive_main_path(dev):
    """generate() on config A (rope off and on) and config B, one prompt
    per call, and one classifier forward; asserts each call's launches:
    the flash kernel once per layer and the LayerNorm forward once per
    norm (two per layer and the final one), every step."""
    from elephas_tpu_torch import generate, transformer_classifier, transformer_lm

    runs = []
    for name, rope in (("A", False), ("A", True), ("B", False)):
        cfg = CONFIGS[name]
        layers = cfg["num_layers"]
        model = transformer_lm(**cfg, rope=rope, seed=0, device=dev)
        outs, seconds = [], 0.0
        for prompt in _prompts(cfg["vocab_size"]):
            before = _launches()
            t0 = time.perf_counter()
            out = generate(model, prompt[None], steps=STEPS)
            seconds += time.perf_counter() - t0
            _check_launches(f"config {name} rope={rope} generate", before, {
                "flash_fwd": layers * STEPS,
                "layer_norm_fwd": (2 * layers + 1) * STEPS,
                "layer_norm_bwd": 0, "span_decode": 0,
            })
            outs.append(out[0])
        runs.append({"config": name, "rope": rope, "model": model,
                     "tokens": outs, "seconds": seconds})

    cfg = CONFIGS["A"]
    clf = transformer_classifier(
        vocab_size=cfg["vocab_size"], maxlen=cfg["maxlen"], num_classes=2,
        d_model=cfg["d_model"], num_heads=cfg["num_heads"],
        num_layers=cfg["num_layers"], seed=0, device=dev,
    )
    x = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg["vocab_size"], (8, cfg["maxlen"]))
    ).to(dev)
    before = _launches()
    with torch.inference_mode():
        probs = clf(x)
    _check_launches("classifier forward", before, {
        "flash_fwd": cfg["num_layers"], "layer_norm_fwd": 2 * cfg["num_layers"] + 1,
    })
    return runs, (clf, x, probs)


def check_main_path(runs, classifier):
    """Emitted tokens and logits against the plain path (plain attention
    and plain LayerNorm)."""
    report, failures = [], []
    for run in runs:
        model, cfg = run["model"], CONFIGS[run["config"]]
        prompts = _prompts(cfg["vocab_size"])
        rows = torch.zeros(len(prompts), cfg["maxlen"], dtype=torch.long,
                           device=model.device)
        for i, (prompt, out) in enumerate(zip(prompts, run["tokens"])):
            if out.shape != (len(prompt) + STEPS,) or not (out[: len(prompt)] == prompt).all():
                failures.append(f"{run['config']}: bad output row {i}")
            if out.min() < 0 or out.max() >= cfg["vocab_size"]:
                failures.append(f"{run['config']}: token out of vocab in row {i}")
            rows[i, : len(out)] = torch.from_numpy(out.astype(np.int64))
        with torch.inference_mode():
            kern = model(rows)
            plain = model(rows, plain=True)
        err, mismatches, close = 0.0, 0, 0
        for i, prompt in enumerate(prompts):
            p = len(prompt)
            pos = slice(p - 1, p + STEPS - 1)
            err = max(err, (kern[i, : p + STEPS] - plain[i, : p + STEPS]).abs().max().item())
            top2 = plain[i, pos].topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu()
            emitted = rows[i, p : p + STEPS].cpu()
            wrong = plain[i, pos].argmax(dim=-1).cpu() != emitted
            mismatches += int((wrong & (margin >= MARGIN)).sum())
            close += int((wrong & (margin < MARGIN)).sum())
        if not torch.isfinite(kern).all():
            failures.append(f"{run['config']}: non-finite logits")
        if err > TOL_LOGITS or mismatches:
            failures.append(f"config {run['config']} rope={run['rope']}: "
                            f"logit err {err}, {mismatches} token mismatches")
        report.append({"config": run["config"], "rope": run["rope"],
                       "logits_max_abs_err": err, "token_mismatches": mismatches,
                       "within_margin": close,
                       "tokens_s": len(prompts) * STEPS / run["seconds"]})
    clf, x, probs = classifier
    with torch.inference_mode():
        plain_probs = clf(x, plain=True)
    clf_err = (probs - plain_probs).abs().max().item()
    sums = (probs.sum(-1) - 1).abs().max().item()
    if probs.shape != (x.shape[0], 2) or not torch.isfinite(probs).all() \
            or sums > 1e-5 or clf_err > 1e-4:
        failures.append(f"classifier: shape {tuple(probs.shape)}, err {clf_err}")
    return report, {"probs_max_abs_err": clf_err, "row_sum_err": sums}, failures


def phase_serve(dev):
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    runs, classifier = drive_main_path(dev)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    report, clf, failures = check_main_path(runs, classifier)
    emit({"phase": "serve", "steps": STEPS, "prompt_lens": PROMPT_LENS.tolist(),
          "launches": launches, "runs": report, "classifier": clf,
          "max_memory_allocated": peak, "failures": failures})
    if failures:
        raise AssertionError(f"main path check failed: {failures}")
    return launches


def _gradient_check(model, x, y):
    """Every parameter's gradient of one batch through the kernels against
    the gradient through the plain path (plain=True), from the same
    weights; returns {name: error} and {name: the largest plain gradient's
    magnitude}. The error is the largest difference relative to that
    tensor's largest plain gradient, in fp32 and bf16 alike, so a tensor
    whose gradient the kernels lost reads 1. The loss is the training
    step's: the task loss plus the auxiliary losses the layers add (the
    Switch models' load-balance losses)."""
    from elephas_tpu_torch.training import auxiliary_losses

    spec = model.training_spec
    grads = {}
    model.train()
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        with auxiliary_losses() as aux:
            out = model(x, plain=plain)
        loss = spec.loss(y, out).mean()
        (loss + torch.stack(aux).sum() if aux else loss).backward()
        grads[plain] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.eval()
    errs = {n: _rel(grads[False][n], g) for n, g in grads[True].items()}
    scales = {n: g.abs().max().item() for n, g in grads[True].items()}
    return errs, scales


def _timed_fit(sm, model, data, epochs, batch, dev, **kwargs):
    """``sm.fit`` with a stamp at the start of every step's forward (after
    the previous step's work has finished) and one at the end; returns
    the history and the seconds of each step. With several workers the
    master is worker 0, whose forward starts each global step (the
    replicas copy the hook, and skip it)."""
    stamps = []

    def stamp(module, _inputs):
        if module is model:
            torch.cuda.synchronize(dev)
            stamps.append(time.perf_counter())

    hook = model.register_forward_pre_hook(stamp)
    try:
        history = sm.fit(data, epochs=epochs, batch_size=batch, **kwargs)
        torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())
    finally:
        hook.remove()
    return history, np.diff(stamps)


def _float32_state(model):
    """The names of parameters, buffers and optimizer state that are not
    float32 (Keras keeps every variable float32 under mixed_bfloat16)."""
    bad = [n for n, t in model.state_dict().items() if t.dtype != torch.float32]
    opt = getattr(model, "training_spec", None)
    if opt is not None:
        bad += [f"optimizer state {k}" for st in opt.optimizer.state.values()
                for k, v in st.items() if torch.is_tensor(v) and v.dtype != torch.float32]
    return bad


def phase_train(dev, dtype_policy=None, fp32=None):
    """The kernel-vs-plain gradient check on the first batch from the
    initial weights (where no gradient is zero: after the fit, random
    labels saturate the softmax into the loss's clip, where every
    gradient is 0); then SparkModel.fit of the classifier at the training
    widths under ``dtype_policy``: launches per step (layers flash
    forwards, 2·layers+1 LayerNorm forwards and as many backwards, each
    of those two launches; under mixed_bfloat16 every flash forward and
    all but one LayerNorm a step on the bf16 route: the first norm takes
    the float32 sum of the embeddings and the position table, as the
    reference's does), finite losses, a history with loss and accuracy,
    float32 variables. ``fp32`` is the float32 run's line, to print the
    ratio of tokens/s beside it."""
    from elephas_tpu_torch import SparkModel, transformer_classifier

    mixed = dtype_policy == "mixed_bfloat16"
    x, y = _synthetic_tokens(TRAIN_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"],
                             TRAIN["num_classes"])
    model = transformer_classifier(**TRAIN, seed=0, dtype_policy=dtype_policy, device=dev)
    layers = TRAIN["num_layers"]
    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_BATCH)
    failures = []
    xb = torch.from_numpy(x[:TRAIN_BATCH]).long().to(dev)
    yb = torch.from_numpy(y[:TRAIN_BATCH]).long().to(dev)
    grad_err, grad_scale = _gradient_check(model, xb, yb)
    worst = max(grad_err, key=grad_err.get)
    tol = TOL_GRAD_BF16 if mixed else TOL_GRAD
    if grad_err[worst] > tol:
        failures.append(f"gradient of {worst}: kernel vs plain {grad_err[worst]}")
    vanished = [n for n, v in grad_scale.items() if not v > 0]
    if vanished:
        failures.append(f"all-zero gradients, the check is vacuous for {vanished}")

    sm = SparkModel(model, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    history, step_s = _timed_fit(sm, model, (x, y), TRAIN_EPOCHS, TRAIN_BATCH, dev)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    norms = 2 * layers + 1
    # the bf16 route: every flash forward, every LayerNorm but the first
    bf16_norms = norms - 1 if mixed else 0
    want = {"flash_fwd": layers * steps, "layer_norm_fwd": norms * steps,
            "layer_norm_bwd": 2 * norms * steps, "span_decode": 0, "span_chunk": 0,
            "paged_span_decode": 0, "paged_span_chunk": 0,
            "flash_fwd_bf16": layers * steps if mixed else 0,
            "layer_norm_fwd_bf16": bf16_norms * steps,
            "layer_norm_bwd_bf16": 2 * bf16_norms * steps}
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if sorted(history) != ["accuracy", "loss"] or \
            any(len(v) != TRAIN_EPOCHS or not np.all(np.isfinite(v)) for v in history.values()):
        failures.append(f"bad history {history}")
    not_f32 = _float32_state(model)
    if not_f32:
        failures.append(f"not float32 after the fit: {not_f32[:5]}")
    if len(step_s) != steps:
        failures.append(f"{len(step_s)} steps timed, expected {steps}")
    tokens_s = (steps - 1) * TRAIN_BATCH * TRAIN["maxlen"] / float(np.sum(step_s[1:]))
    out = {"phase": "train_bf16" if mixed else "train", "config": TRAIN,
           "dtype_policy": dtype_policy or "float32", "rows": TRAIN_ROWS, "batch": TRAIN_BATCH,
           "epochs": TRAIN_EPOCHS, "steps": steps, "launches": launches,
           "launches_expected": want, "history": history,
           "step_seconds": step_s.tolist(),
           "median_step_s_after_first": float(np.median(step_s[1:])),
           "tokens_s_after_first": tokens_s, "max_memory_allocated": peak,
           "grad_tol": tol, "grad_max_err": grad_err[worst],
           "grad_worst_param": worst,
           "grad_smallest_scales": dict(sorted(grad_scale.items(), key=lambda kv: kv[1])[:4]),
           "failures": failures}
    if fp32 is not None:
        out["tokens_s_over_fp32"] = tokens_s / fp32["tokens_s_after_first"]
        out["fp32_median_step_s_after_first"] = fp32["median_step_s_after_first"]
    emit(out)
    if failures:
        raise AssertionError(f"training path check failed ({out['phase']}): {failures}")
    return launches, model, (xb, yb), out


def _synthetic_images(n, img, classes, seed=0):
    """The reference bench's image data (bench.py:130, _synthetic)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, img, img, 3)).astype(np.float32)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    return x, y


def _kl_rows(p, q):
    """KL(p ‖ q) of each row of two probability tensors, in float64."""
    p, q = p.double(), q.double()
    return (p * (p.clamp_min(1e-300).log() - q.clamp_min(1e-300).log())).sum(dim=1)


def _centred_log(p):
    """Row-centred log-probabilities: the logits, their row's common
    shift aside."""
    log_p = p.double().clamp_min(1e-300).log()
    return log_p - log_p.mean(dim=1, keepdim=True)


def _r50_agreement(dev, xb):
    """The first step's forward (train mode: batch statistics) of
    ResNet-50 under mixed_bfloat16 against the same weights under float32,
    for the weights of each seed of R50_SEEDS. Per seed: the bf16
    probabilities' dtype and finiteness; the mean KL(float32 ‖ bf16), the
    same against the bf16 output of the next row (``kl_other_row``: what
    an output of the right kind but for another input reads) and against
    the uniform distribution (``kl_uniform``); each
    row's largest difference over its largest float32 probability; top-1
    agreement; the median of the rows' largest float32 probability; the
    largest error of the row-centred logits beside their largest
    magnitude; and, to show how far the untrained network carries a bf16
    rounding, the float32 forward of the input rounded to bf16 against
    the float32 forward (``input_rounding_*``)."""
    from elephas_tpu_torch import keras_weights, load_keras_weights, resnet50

    out = {}
    for seed in R50_SEEDS:
        weights = None
        probs = []
        for policy, x in (("mixed_bfloat16", xb), (None, xb), (None, xb.bfloat16().float())):
            m = resnet50(**R50, dtype_policy=policy, compile_model=False, seed=seed,
                         device=dev)
            if weights is None:
                weights = keras_weights(m)
            load_keras_weights(m, weights)
            m.train()
            with torch.no_grad():
                probs.append(m(x))
            del m
        bf16, f32, f32_rounded_in = probs
        row_max = f32.max(dim=1).values
        out[seed] = {
            "float32_out": bf16.dtype == torch.float32,
            "finite": bool(torch.isfinite(bf16).all()),
            "kl_mean": _kl_rows(f32, bf16).mean().item(),
            "kl_other_row": _kl_rows(f32, bf16.roll(1, dims=0)).mean().item(),
            "kl_uniform": _kl_rows(f32, torch.full_like(f32, 1 / f32.shape[1])).mean().item(),
            "row_rel_err": ((bf16 - f32).abs().max(dim=1).values / row_max).max().item(),
            "max_abs_err": (bf16 - f32).abs().max().item(),
            "top1_agree": (bf16.argmax(dim=1) == f32.argmax(dim=1)).double().mean().item(),
            "median_row_max_prob": row_max.median().item(),
            "logit_err": (_centred_log(bf16) - _centred_log(f32)).abs().max().item(),
            "max_abs_centred_logit": _centred_log(f32).abs().max().item(),
            "input_rounding_kl_mean": _kl_rows(f32, f32_rounded_in).mean().item(),
            "input_rounding_logit_err":
                (_centred_log(f32_rounded_in) - _centred_log(f32)).abs().max().item()}
    return out


def phase_train_resnet50(dev):
    """SparkModel.fit of ResNet-50 as the reference bench trains it
    (mixed_bfloat16, batch 256, 4 batches, here 2 epochs): images/s after
    the first step, peak memory, finite history, BatchNorm's moving
    statistics moved and finite, variables float32; the first step's
    probabilities against the same weights under float32. Batch 256 is
    halved while it runs out of memory (printed as a cut)."""
    from elephas_tpu_torch import SparkModel, resnet50

    batch, cut = R50_BATCH, None
    while True:
        x, y = _synthetic_images(batch * R50_BATCHES, R50["input_shape"][0],
                                 R50["num_classes"])
        model = resnet50(**R50, dtype_policy="mixed_bfloat16", device=dev)
        xb = torch.from_numpy(x[:batch]).to(dev)
        try:
            agreement = _r50_agreement(dev, xb)
            moving = {n: b.clone() for n, b in model.named_buffers()}
            torch.cuda.reset_peak_memory_stats(dev)
            history, step_s = _timed_fit(SparkModel(model, device=dev), model, (x, y),
                                         R50_EPOCHS, batch, dev)
            break
        except torch.cuda.OutOfMemoryError:
            del model
            torch.cuda.empty_cache()
            if batch == 1:
                raise
            cut = f"batch {batch} ran out of memory; halved"
            batch //= 2
    peak = torch.cuda.max_memory_allocated(dev)
    steps = R50_EPOCHS * R50_BATCHES
    failures = []
    for seed, a in agreement.items():
        if not (a["float32_out"] and a["finite"] and R50_KL[0] <= a["kl_mean"] <= R50_KL[1]):
            failures.append(f"first step probabilities, weights of seed {seed}: "
                            f"bf16 vs float32 {a}")
    stale = [n for n, b in model.named_buffers() if torch.equal(b, moving[n])]
    bad = [n for n, b in model.named_buffers() if not torch.isfinite(b).all()]
    if stale or bad:
        failures.append(f"moving statistics unmoved {stale[:4]}, not finite {bad[:4]}")
    if sorted(history) != ["accuracy", "loss"] or \
            any(len(v) != R50_EPOCHS or not np.all(np.isfinite(v)) for v in history.values()):
        failures.append(f"bad history {history}")
    not_f32 = _float32_state(model)
    if not_f32:
        failures.append(f"not float32 after the fit: {not_f32[:5]}")
    if len(step_s) != steps:
        failures.append(f"{len(step_s)} steps timed, expected {steps}")
    images_s = (steps - 1) * batch / float(np.sum(step_s[1:]))
    out = {"phase": "train_resnet50", "config": {**R50, "dtype_policy": "mixed_bfloat16"},
           "batch": batch, "batch_cut": cut, "batches": R50_BATCHES, "epochs": R50_EPOCHS,
           "steps": steps, "history": history, "step_seconds": step_s.tolist(),
           "median_step_s_after_first": float(np.median(step_s[1:])),
           "images_s_after_first": images_s, "max_memory_allocated": peak,
           "moving_statistics": len(moving), "moving_statistics_moved": len(moving) - len(stale),
           "first_step_probs_bf16_vs_float32": agreement,
           "kl_mean_limits": R50_KL, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"ResNet-50 training check failed: {failures}")
    return model, (xb, torch.from_numpy(y[:batch]).long().to(dev))


def phase_zoo(dev):
    """One SparkModel.fit each of mnist_mlp, cifar10_cnn and imdb_lstm at
    their builders' defaults on synthetic data of their shapes
    (np.random.default_rng(0)): a finite history, samples/s, and finite
    predictions of the right shape."""
    from elephas_tpu_torch import SparkModel, cifar10_cnn, imdb_lstm, mnist_mlp

    rng = np.random.default_rng(0)
    n = ZOO_ROWS
    cases = (
        ("mnist_mlp", mnist_mlp, rng.normal(size=(n, 784)).astype(np.float32), 10),
        ("cifar10_cnn", cifar10_cnn, rng.normal(size=(n, 32, 32, 3)).astype(np.float32), 10),
        ("imdb_lstm", imdb_lstm, rng.integers(1, 20000, (n, 80)).astype(np.int32), 1),
    )
    out, failures = {}, []
    for name, build, x, classes in cases:
        y = rng.integers(0, max(classes, 2), n).astype(np.int32)
        model = build(device=dev)
        sm = SparkModel(model, device=dev)
        sm.fit((x[:ZOO_BATCH], y[:ZOO_BATCH]), epochs=1, batch_size=ZOO_BATCH)  # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        history = sm.fit((x, y), epochs=ZOO_EPOCHS, batch_size=ZOO_BATCH)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        pred = sm.predict(x[:64], batch_size=ZOO_BATCH)
        if not all(np.all(np.isfinite(v)) for v in history.values()) or \
                pred.shape != (64, classes) or not np.isfinite(pred).all():
            failures.append(f"{name}: history {history}, predictions {pred.shape}")
        out[name] = {"history": history, "seconds": seconds,
                     "samples_s": ZOO_EPOCHS * n / seconds}
    emit({"phase": "zoo", "rows": ZOO_ROWS, "batch": ZOO_BATCH, "epochs": ZOO_EPOCHS,
          "note": "samples_s after a one-batch warm-up fit", **out, "failures": failures})
    if failures:
        raise AssertionError(f"zoo fits failed: {failures}")


def _state_equal(a, b, optimizer=True):
    """Names of the state_dict entries (and, with ``optimizer``, the
    optimizer-state entries) on which two compiled modules differ, bit for
    bit."""
    sa, sb = a.state_dict(), b.state_dict()
    bad = [n for n in sa if not torch.equal(sa[n], sb[n])]
    if not optimizer:
        return bad
    oa = a.training_spec.optimizer.state_dict()["state"]
    ob = b.training_spec.optimizer.state_dict()["state"]
    bad += [f"optimizer {i}/{k}" for i in oa for k, v in oa[i].items()
            if not (torch.equal(v, ob[i][k]) if torch.is_tensor(v) else v == ob[i][k])]
    return bad


def _rel_state_err(got, want):
    """Per state_dict entry: the largest difference relative to the
    largest magnitude of ``want``'s tensor; the worst entry and its error."""
    errs = {n: _rel(got[n].double(), w.double().to(got[n].device)) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _time_call_ms(fn, iters=10):
    """Median device time of ``fn()`` over ``iters`` calls, each between
    two CUDA events."""
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_train_workers(dev):
    """SparkModel.fit of T on WORKERS workers on the one card
    (force_devices): fp32, TRAIN_ROWS rows, WORKER_BATCH rows a worker
    step, TRAIN_EPOCHS epochs. synchronous/epoch: the workers' mean
    first-step gradient against one model's gradient on their
    concatenated first batches (TOL_MEAN_GRAD of each tensor's largest),
    replicas bit-identical to the master afterwards (weights, buffers,
    optimizer state), launches WORKERS x phase_train's, a finite history,
    tokens/s over all workers after the first global step, the median
    global step, the device time of one gradient and one weight averaging
    (CUDA events, median of 10), peak memory. asynchronous/batch and
    hogwild/epoch: replicas bit-identical after the fit, the master the
    mean of the replicas' weights taken just before the last average
    (float64, TOL_MASTER_MEAN of each tensor's largest). Then checkpoints:
    fit(1 epoch, checkpoint_dir) and a fresh wrapper's fit(2 epochs,
    resume=True) against the synchronous 2-epoch fit, bit for bit; save ->
    load_spark_model -> predict on PREDICT_ROWS rows against predict
    before saving, bit for bit; a fit with validation_split=0.25 gives
    finite val_loss and val_accuracy per epoch."""
    from elephas_tpu_torch import SparkModel, load_spark_model, transformer_classifier, worker
    from elephas_tpu_torch.device import force_devices

    x, y = _synthetic_tokens(TRAIN_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"],
                             TRAIN["num_classes"])
    layers = TRAIN["num_layers"]
    per_worker = TRAIN_ROWS // WORKERS
    global_steps = TRAIN_EPOCHS * -(-per_worker // WORKER_BATCH)
    failures = []
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_workers")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    previous = force_devices(WORKERS)
    real_mean_gradients, real_mean_weights = worker.mean_gradients, worker.mean_weights
    kept, first_grad, expected = [], {}, {}

    def spy_gradients(replicas):
        real_mean_gradients(replicas)
        if not first_grad:
            first_grad.update({n: p.grad.clone() for n, p in replicas[0].named_parameters()})
        kept[:] = replicas

    def spy_weights(replicas):
        states = [r.state_dict() for r in replicas]
        expected.clear()
        expected.update({n: torch.stack([st[n].double() for st in states]).mean(0)
                         for n, t in states[0].items() if t.is_floating_point()})
        real_mean_weights(replicas)
        kept[:] = replicas

    def build():
        return transformer_classifier(**TRAIN, seed=0, device=dev)

    try:
        worker.mean_gradients, worker.mean_weights = spy_gradients, spy_weights
        out = {"phase": "train_workers", "config": TRAIN, "dtype_policy": "float32",
               "workers": WORKERS, "rows": TRAIN_ROWS, "worker_batch": WORKER_BATCH,
               "global_batch": WORKERS * WORKER_BATCH, "epochs": TRAIN_EPOCHS,
               "global_steps": global_steps}

        # synchronous / epoch: the north-star path
        model = build()
        first = np.concatenate([x[w * per_worker:w * per_worker + WORKER_BATCH]
                                for w in range(WORKERS)])
        first_y = np.concatenate([y[w * per_worker:w * per_worker + WORKER_BATCH]
                                  for w in range(WORKERS)])
        spec = model.training_spec
        model.train()
        # what one worker step at WORKER_BATCH rows adds to the memory held
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        spec.loss(torch.from_numpy(y[:WORKER_BATCH]).long().to(dev),
                  model(torch.from_numpy(x[:WORKER_BATCH]).long().to(dev))).mean().backward()
        one_step_bytes = torch.cuda.max_memory_allocated(dev) - held
        model.zero_grad(set_to_none=True)
        spec.loss(torch.from_numpy(first_y).long().to(dev),
                  model(torch.from_numpy(first).long().to(dev))).mean().backward()
        want_grad = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        model.eval()
        # weights, gradients and Adam's m and v of every replica
        state_bytes = 4 * WORKERS * sum(p.numel() * p.element_size()
                                        for p in model.parameters())
        sm = SparkModel(model, num_workers=WORKERS, device=dev)
        # earlier phases' models stay allocated (the profiles reuse them)
        held_before_fit = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        history, step_s = _timed_fit(sm, model, (x, y), TRAIN_EPOCHS, WORKER_BATCH, dev)
        launches = _launches()
        peak = torch.cuda.max_memory_allocated(dev)
        norms = 2 * layers + 1
        worker_steps = WORKERS * global_steps
        want = {"flash_fwd": layers * worker_steps, "layer_norm_fwd": norms * worker_steps,
                "layer_norm_bwd": 2 * norms * worker_steps, "span_decode": 0,
                "span_chunk": 0, "paged_span_decode": 0, "paged_span_chunk": 0,
                "flash_fwd_bf16": 0, "layer_norm_fwd_bf16": 0, "layer_norm_bwd_bf16": 0}
        if launches != want:
            failures.append(f"launches {launches}, expected {want}")
        grad_err = {n: _rel(first_grad[n], g) for n, g in want_grad.items()}
        worst = max(grad_err, key=grad_err.get)
        if grad_err[worst] > TOL_MEAN_GRAD:
            failures.append(f"mean first-step gradient of {worst}: {grad_err[worst]}")
        if len(kept) != WORKERS or kept[0] is not model:
            failures.append(f"{len(kept)} replicas seen, worker 0 the master: "
                            f"{bool(kept) and kept[0] is model}")
        diverged = {i: _state_equal(r, model)[:3] for i, r in enumerate(kept[1:], 1)}
        if any(diverged.values()):
            failures.append(f"synchronous replicas differ from the master: {diverged}")
        if sorted(history) != ["accuracy", "loss"] or \
                any(len(v) != TRAIN_EPOCHS or not np.all(np.isfinite(v))
                    for v in history.values()):
            failures.append(f"bad history {history}")
        if len(step_s) != global_steps:
            failures.append(f"{len(step_s)} global steps timed, expected {global_steps}")
        replicas = list(kept)
        grad_ms = _time_call_ms(lambda: real_mean_gradients(replicas))
        weights_ms = _time_call_ms(lambda: real_mean_weights(replicas))
        del replicas
        kept.clear()
        tokens = WORKERS * WORKER_BATCH * TRAIN["maxlen"]
        out["synchronous_epoch"] = {
            "launches": launches, "launches_expected": want, "history": history,
            "global_step_seconds": step_s.tolist(),
            "median_global_step_s_after_first": float(np.median(step_s[1:])),
            "tokens_s_after_first": (global_steps - 1) * tokens / float(np.sum(step_s[1:])),
            "max_memory_allocated": peak, "allocated_before_fit": held_before_fit,
            "replica_state_bytes": state_bytes,
            "one_worker_step_bytes": one_step_bytes, "mean_gradients_ms": grad_ms,
            "mean_weights_ms": weights_ms,
            "averaging_timing": "CUDA events around one call on the fit's replicas, median "
                                "of 10",
            "mean_grad_tol": TOL_MEAN_GRAD, "mean_grad_max_err": grad_err[worst],
            "mean_grad_worst_param": worst}
        uninterrupted = {n: t.detach().cpu().clone() for n, t in model.state_dict().items()}
        predict_before = sm.predict(x[:PREDICT_ROWS])
        sm.save(os.path.join(scratch, "model.pt"))
        loaded = load_spark_model(os.path.join(scratch, "model.pt"), device=dev)
        predict_after = loaded.predict(x[:PREDICT_ROWS])
        out["save_load"] = {"rows": PREDICT_ROWS,
                            "predictions_equal": bool(np.array_equal(predict_before,
                                                                     predict_after)),
                            "num_workers": loaded.num_workers}
        if not out["save_load"]["predictions_equal"] or loaded.num_workers != WORKERS:
            failures.append(f"save/load: {out['save_load']}")
        del sm, model, loaded, want_grad

        for mode, frequency in (("asynchronous", "batch"), ("hogwild", "epoch")):
            model = build()
            history = SparkModel(model, mode=mode, frequency=frequency, num_workers=WORKERS,
                                 device=dev).fit((x, y), epochs=TRAIN_EPOCHS,
                                                 batch_size=WORKER_BATCH)
            # optimizer state is never averaged here: weights and buffers
            diverged = {i: _state_equal(r, model, optimizer=False)[:3]
                        for i, r in enumerate(kept[1:], 1)}
            got = model.state_dict()
            worst, err = _rel_state_err(got, expected)
            key = f"{mode}_{frequency}"
            out[key] = {"history": history, "master_vs_replica_mean_err": err,
                        "worst_tensor": worst, "tol": TOL_MASTER_MEAN,
                        "replicas_identical": not any(diverged.values())}
            if len(kept) != WORKERS or any(diverged.values()) or err > TOL_MASTER_MEAN or \
                    not all(np.all(np.isfinite(v)) for v in history.values()):
                failures.append(f"{key}: {len(kept)} replicas, differ {diverged}, "
                                f"master vs mean {worst} {err}, history {history}")
            kept.clear()
            expected.clear()
            del model, got

        # checkpoints and resume against the uninterrupted synchronous fit
        ckpt_dir = os.path.join(scratch, "ckpt")
        SparkModel(build(), num_workers=WORKERS, device=dev).fit(
            (x, y), epochs=1, batch_size=WORKER_BATCH, checkpoint_dir=ckpt_dir)
        resumed = build()
        history = SparkModel(resumed, num_workers=WORKERS, device=dev).fit(
            (x, y), epochs=TRAIN_EPOCHS, batch_size=WORKER_BATCH, checkpoint_dir=ckpt_dir,
            resume=True)
        state = resumed.state_dict()
        differ = [n for n, t in uninterrupted.items() if not torch.equal(state[n].cpu(), t)]
        worst, err = _rel_state_err(state, uninterrupted)
        out["resume"] = {"epochs_run": len(history["loss"]), "bit_equal": not differ,
                         "differing_tensors": len(differ), "max_rel_err": err,
                         "worst_tensor": worst, "checkpoints": sorted(os.listdir(ckpt_dir))}
        if differ or len(history["loss"]) != TRAIN_EPOCHS - 1:
            failures.append(f"resume: {out['resume']}")
        del resumed, state, uninterrupted

        model = build()
        history = SparkModel(model, num_workers=WORKERS, device=dev).fit(
            (x, y), epochs=TRAIN_EPOCHS, batch_size=WORKER_BATCH, validation_split=0.25)
        out["validation"] = {"split": 0.25, "history": history}
        if any(len(history.get(k, [])) != TRAIN_EPOCHS or not np.all(np.isfinite(history[k]))
               for k in ("val_loss", "val_accuracy")):
            failures.append(f"validation history {history}")
        del model
    finally:
        worker.mean_gradients, worker.mean_weights = real_mean_gradients, real_mean_weights
        force_devices(previous)
        shutil.rmtree(scratch, ignore_errors=True)
    out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError(f"train_workers check failed: {failures}")
    return launches


def _engine_workload(vocab, n):
    """The reference serving bench's requests (bench.py:1946-1961): prompts
    from np.random.default_rng(0), lengths and budgets cycling."""
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, size=ENGINE_PROMPT_LENS[i % len(ENGINE_PROMPT_LENS)])
             .astype(np.int32), ENGINE_BUDGETS[i % len(ENGINE_BUDGETS)]) for i in range(n)]


def _first_divergence(got, want, logits_of):
    """Token lists ``got`` and ``want`` agree, or first differ where the
    plain path's top-2 margin is below MARGIN: None then, else a
    description. ``logits_of(i)`` gives the plain logits that predict
    token ``i``."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        return None
    top2 = logits_of(i).topk(2).values
    margin = (top2[0] - top2[1]).item()
    return None if margin < MARGIN else f"token {i}: {got[i]} vs {want[i]}, margin {margin}"


def _check_emitted(model, reqs, dev):
    """Check (a): every emitted token against the plain full forward's
    argmax, where its top-2 margin is >= MARGIN. Returns the mismatches,
    the differences within the margin, the failures and the plain logits
    ``[requests, maxlen, vocab]``."""
    maxlen, vocab = model.maxlen, model.vocab_size
    failures = []
    rows = torch.zeros(len(reqs), maxlen, dtype=torch.long, device=dev)
    for i, r in enumerate(reqs):
        seq = r.full_sequence
        if len(r.tokens) != r.max_new_tokens or min(seq) < 0 or max(seq) >= vocab:
            failures.append(f"request {i}: {len(r.tokens)} tokens, range {min(seq)}..{max(seq)}")
        rows[i, : len(seq)] = torch.tensor(seq, device=dev)
    with torch.inference_mode():
        plain = model(rows, plain=True)  # [requests, maxlen, vocab]
    mismatches = close = 0
    for i, r in enumerate(reqs):
        p = len(r.prompt)
        pos = slice(p - 1, p - 1 + len(r.tokens))
        top2 = plain[i, pos].topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        wrong = plain[i, pos].argmax(dim=-1) != rows[i, p: p + len(r.tokens)]
        mismatches += int((wrong & (margin >= MARGIN)).sum())
        close += int((wrong & (margin < MARGIN)).sum())
    if mismatches:
        failures.append(f"(a) {mismatches} emitted tokens differ from the plain argmax")
    return mismatches, close, failures, plain


def _engine_checks(model, reqs, dev):
    """(a) as _check_emitted; (b) generate(kv_cache=True) against
    generate(kv_cache=False) on one prompt of each length, under the same
    rule; (c) one decode window (steps_per_sync steps) of the first
    num_slots requests through a fresh arena, logits against the plain
    full forward's."""
    from elephas_tpu_torch import generate
    from elephas_tpu_torch.models.transformer import validate_token_decode_model
    from elephas_tpu_torch.ops.flash_serving import span_bucket_for, span_buckets
    from elephas_tpu_torch.serving.kv_cache import SlotKVCache, prefill_forward, token_decode_step

    maxlen, vocab = model.maxlen, model.vocab_size
    mismatches, close, failures, plain = _check_emitted(model, reqs, dev)
    generate_report = []
    for prompt, budget in _engine_workload(vocab, len(ENGINE_PROMPT_LENS)):
        cached = generate(model, prompt[None], budget, kv_cache=True)[0].tolist()
        full = generate(model, prompt[None], budget)[0].tolist()
        p = len(prompt)

        def logits_of(i, seq=full, p=p):
            x = torch.tensor([seq[: p + i]], device=dev)
            with torch.inference_mode():
                return model(x, plain=True)[0, -1]

        bad = _first_divergence(cached[p:], full[p:], logits_of)
        generate_report.append({"prompt_len": p, "steps": budget,
                                "identical": cached == full, "fault": bad})
        if bad:
            failures.append(f"(b) generate kv_cache=True vs False, prompt {p}: {bad}")

    window = reqs[: ENGINE["num_slots"]]
    steps = ENGINE["steps_per_sync"]
    cache = SlotKVCache(validate_token_decode_model(model), len(window), maxlen, dev)
    p_lens = [len(r.prompt) for r in window]
    span = span_bucket_for(max(p_lens) + steps, span_buckets(maxlen))
    err = 0.0
    with torch.inference_mode():
        for i, r in enumerate(window):
            prefill_forward(model, torch.tensor([r.prompt], device=dev), cache,
                            torch.tensor([i], device=dev))
        positions = torch.tensor(p_lens, dtype=torch.int32, device=dev)
        for j in range(steps):
            tok = torch.tensor([r.tokens[j] for r in window], device=dev)
            logits = token_decode_step(model, tok, positions, cache, span=span)
            want = torch.stack([plain[i, p + j] for i, p in enumerate(p_lens)])
            err = max(err, (logits - want).abs().max().item())
            positions = positions + 1
    if not err <= TOL_LOGITS:
        failures.append(f"(c) decode-window logits differ from the plain forward by {err}")
    return {"a_token_mismatches": mismatches, "a_within_margin": close,
            "b_generate": generate_report, "c_window_logits_max_abs_err": err,
            "c_window": {"slots": len(window), "steps": steps, "span": span}}, failures


PS_SHORT_ROWS = 256
# run_chaos_training's run on the card (the reference test's sizes)
PS_CHAOS = dict(rows=256, epochs=2, batch_size=64, seed=0)


def _fit_pull(sm, client_of, data, epochs, batch):
    """``sm.fit`` with a pull through ``client_of(endpoint)`` after the
    final publication, before the fit stops its store; returns the
    history, the fit's wall seconds, the pulled weights, the client's
    bytes received and the pull's seconds, the milliseconds each
    publication held the fit thread, and those of the store's start and
    stop (its terminal journal write)."""
    out = {}
    start, stop = sm.start_server, sm.stop_server
    publish = sm._publish_weights
    publish_ms = []

    def timed_start(restore_journal=True):
        t0 = time.perf_counter()
        start(restore_journal)
        out["start_ms"] = (time.perf_counter() - t0) * 1e3

    def timed_publish(final=False):
        t0 = time.perf_counter()
        publish(final)
        publish_ms.append((time.perf_counter() - t0) * 1e3)

    def pull_then_stop():
        client = client_of(sm.ps_endpoints)
        t0 = time.perf_counter()
        out["weights"] = client.get_parameters()
        out["pull_s"] = time.perf_counter() - t0
        out["pull_bytes"] = getattr(client, "bytes_received", None)
        client.close()
        # the stop's terminal journal write, timed apart from the rest of
        # the stop (the accept loop's shutdown poll, closing the socket)
        server, journal_ms = sm._parameter_server, []
        write_journal = getattr(server, "write_journal", None)
        if write_journal is not None:
            def timed_journal():
                t1 = time.perf_counter()
                try:
                    return write_journal()
                finally:
                    journal_ms.append((time.perf_counter() - t1) * 1e3)
            server.write_journal = timed_journal
        t0 = time.perf_counter()
        stop()
        out["stop_ms"] = (time.perf_counter() - t0) * 1e3
        out["stop_journal_ms"] = sum(journal_ms)
        out["stop_other_ms"] = out["stop_ms"] - out["stop_journal_ms"]

    sm.start_server, sm.stop_server = timed_start, pull_then_stop
    sm._publish_weights = timed_publish
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["history"] = sm.fit(data, epochs=epochs, batch_size=batch)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["publish_ms"] = publish_ms
    return out


def _arrays_bit_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def phase_train_ps(dev):
    """T in mixed_bfloat16 with a live weight store (see the module
    docstring, 5i). Returns the launches of the three stores' fits."""
    from elephas_tpu_torch import SparkModel, transformer_classifier
    from elephas_tpu_torch.fault import FaultPlan, run_chaos_training
    from elephas_tpu_torch.fault.harness import _chaos_data, _chaos_model
    from elephas_tpu_torch.parameter import HttpClient, SocketClient, journal
    from elephas_tpu_torch.parameter.native import NativeClient, _Flattener
    from elephas_tpu_torch.utils.weights import get_weights, set_weights
    from elephas_tpu_torch.worker import Runner

    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_ps")
    shutil.rmtree(scratch, ignore_errors=True)
    failures = []
    try:
        x, y = _synthetic_tokens(TRAIN_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"],
                                 TRAIN["num_classes"])
        model = transformer_classifier(**TRAIN, seed=0, dtype_policy="mixed_bfloat16",
                                       device=dev)
        layers, norms = TRAIN["num_layers"], 2 * TRAIN["num_layers"] + 1
        jdir = os.path.join(scratch, "journal")

        def socket_client(endpoint):
            return SocketClient(master=endpoint)

        def fit_without_store():
            sm = SparkModel(model, mode="asynchronous", device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sm.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        # in turns: without the store, with it (the main path), without
        no_ps_s = [fit_without_store()]
        _reset_launches()
        sm = SparkModel(model, mode="asynchronous", parameter_server_mode="socket", port=0,
                        ps_journal_dir=jdir, device=dev)
        main = _fit_pull(sm, socket_client, (x, y), TRAIN_EPOCHS, TRAIN_BATCH)
        master = get_weights(model)
        if not _arrays_bit_equal(main["weights"], master):
            failures.append("socket: the post-fit pull is not the master's host weights")
        journaled = journal.load_journal(jdir)[0]
        if not _arrays_bit_equal(journaled, master):
            failures.append("socket: the journal is not the master's host weights")
        hist = main["history"]
        if any(len(v) != TRAIN_EPOCHS or not np.all(np.isfinite(v)) for v in hist.values()):
            failures.append(f"socket: bad history {hist}")

        shortened = {}
        xs, ys = x[:PS_SHORT_ROWS], y[:PS_SHORT_ROWS]
        def native_client(endpoint):
            host, port = endpoint.rsplit(":", 1)
            return NativeClient(host, int(port), _Flattener(get_weights(model)))

        for store, client_of in (("native", native_client),
                                 ("http", lambda endpoint: HttpClient(master=endpoint))):
            sm_s = SparkModel(model, mode="asynchronous", parameter_server_mode=store, port=0,
                              device=dev)
            got = _fit_pull(sm_s, client_of, (xs, ys), 1, TRAIN_BATCH)
            if not _arrays_bit_equal(got["weights"], get_weights(model)):
                failures.append(f"{store}: the post-fit pull is not the master's host weights")
            shortened[store] = {"fit_s": got["fit_s"], "publish_ms": got["publish_ms"],
                                "start_ms": got["start_ms"], "stop_ms": got["stop_ms"],
                                "stop_journal_ms": got["stop_journal_ms"],
                                "pull_s": got["pull_s"], "pull_bytes": got["pull_bytes"],
                                "loss": got["history"]["loss"]}
        launches = _launches()
        no_ps_s.append(fit_without_store())
        steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_BATCH) + 2 * -(-PS_SHORT_ROWS // TRAIN_BATCH)
        want = {"flash_fwd": layers * steps, "layer_norm_fwd": norms * steps,
                "layer_norm_bwd": 2 * norms * steps, "span_decode": 0, "span_chunk": 0,
                "paged_span_decode": 0, "paged_span_chunk": 0,
                "flash_fwd_bf16": layers * steps, "layer_norm_fwd_bf16": (norms - 1) * steps,
                "layer_norm_bwd_bf16": 2 * (norms - 1) * steps}
        if launches != want:
            failures.append(f"launches {launches}, expected {want}")

        # resume: a fresh T adopts the socket store's journal
        fresh = transformer_classifier(**TRAIN, seed=1, dtype_policy="mixed_bfloat16", device=dev)
        resumed = SparkModel(fresh, mode="asynchronous", parameter_server_mode="socket", port=0,
                             ps_journal_dir=jdir, device=dev)
        if resumed.fit((x, y), epochs=0, batch_size=TRAIN_BATCH, resume=True)["loss"] != []:
            failures.append("resume: a fit of 0 epochs left trained")
        resume_equal = _arrays_bit_equal(get_weights(fresh), journaled)
        if not resume_equal:
            failures.append("resume: the master is not the journal")
        del fresh, resumed

        # chaos: the worker trains on the card while its store is killed
        clean = run_chaos_training("socket", plan=None, device=dev, **PS_CHAOS)
        plan = FaultPlan(seed=0, kill_ps_after_updates=2, restart_delay_s=0.4,
                         duplicate_fraction=0.25)
        faulted = run_chaos_training("socket", plan=plan, journal_dir=os.path.join(
            scratch, "chaos"), journal_every=1, device=dev, **PS_CHAOS)
        periods = PS_CHAOS["epochs"] * -(-PS_CHAOS["rows"] // PS_CHAOS["batch_size"])
        cx, cy, d, k = _chaos_data(PS_CHAOS["seed"], PS_CHAOS["rows"])
        probe, _ = _chaos_model(PS_CHAOS["seed"], d, k, device=dev)
        runner = Runner(probe, "synchronous", "epoch", 1)
        losses = {}
        for name, weights in (("initial", get_weights(probe)),
                              ("clean", clean["final_weights"]),
                              ("faulted", faulted["final_weights"])):
            set_weights(probe, weights)
            losses[name] = runner.evaluate([(cx, cy)], PS_CHAOS["batch_size"])["loss"]
        chaos = {k: faulted[k] for k in ("kills", "restarts", "updates_applied",
                                         "duplicates_sent", "duplicates_skipped",
                                         "updates_resent", "updates_lost_final", "recovery_s",
                                         "journal_restored", "samples_per_s")}
        chaos.update(clean_updates_applied=clean["updates_applied"],
                     clean_samples_per_s=clean["samples_per_s"], losses=losses)
        if not (faulted["kills"] == 1 and faulted["restarts"] == 1
                and faulted["journal_restored"]):
            failures.append(f"chaos: the store was not killed and restored once: {chaos}")
        if not faulted["updates_applied"] == clean["updates_applied"] == periods:
            failures.append(f"chaos: updates lost or doubled: {chaos}")
        if faulted["updates_lost_final"] or not (
                faulted["duplicates_skipped"] >= faulted["duplicates_sent"] >= 1):
            failures.append(f"chaos: duplicates applied or updates lost: {chaos}")
        if not losses["faulted"] < losses["initial"] * 0.95:
            failures.append(f"chaos: the faulted run did not converge: {losses}")
        if not losses["faulted"] < losses["clean"] * 1.05:
            failures.append(f"chaos: the faulted run ended 5 % above the clean run: {losses}")
        pub = main["publish_ms"]
        out = {"phase": "train_ps", "config": TRAIN, "dtype_policy": "mixed_bfloat16",
               "rows": TRAIN_ROWS, "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS,
               "launches": launches, "launches_expected": want, "history": hist,
               "epoch_s_without_store": [t / TRAIN_EPOCHS for t in no_ps_s],
               "epoch_s_with_store": main["fit_s"] / TRAIN_EPOCHS,
               "publish_ms_mid_fit": pub[:-1], "publish_ms_final": pub[-1],
               "store_start_ms": main["start_ms"], "store_stop_ms": main["stop_ms"],
               "store_stop_journal_ms": main["stop_journal_ms"],
               "store_stop_other_ms": main["stop_other_ms"],
               "weight_bytes": int(sum(w.nbytes for w in master)),
               "pull_bytes": main["pull_bytes"], "pull_s": main["pull_s"],
               "pull_gb_s": main["pull_bytes"] / main["pull_s"] / 1e9,
               "shortened": shortened, "resume_bit_equal": resume_equal, "chaos": chaos,
               "card": nvidia_smi(), "failures": failures}
        emit(out)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if failures:
        raise AssertionError(f"parameter-server path check failed: {failures}")
    return launches


def phase_engine(dev):
    """InferenceEngine at config A's full width: a warm-up pass over the
    workload's first num_slots requests (every length and budget), then
    the timed pass of ENGINE_REQUESTS submitted at once; tokens/s, TTFT,
    inter-token latency and peak memory, the kernels' launches in the
    timed pass, and the checks of _engine_checks. Returns the launches
    and the model."""
    from elephas_tpu_torch import InferenceEngine, transformer_lm

    cfg = CONFIGS["A"]
    layers = cfg["num_layers"]
    model = transformer_lm(**cfg, seed=0, device=dev)
    workload = _engine_workload(cfg["vocab_size"], ENGINE_REQUESTS)
    engine = InferenceEngine(model, **ENGINE)
    engine.run(workload[: ENGINE["num_slots"]])
    steps0 = engine.scheduler._steps
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.submit(prompt, budget) for prompt, budget in workload]
    engine.run()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    failures = []
    idle = [k for k in ("span_decode", "flash_fwd", "layer_norm_fwd") if not launches[k] > 0]
    if idle:
        failures.append(f"the engine path never launched {idle}")
    # one flash forward a layer per prefill, one span decode a layer per
    # decode step, and 2·layers+1 LayerNorms each
    forwards = (launches["flash_fwd"] + launches["span_decode"]) / layers
    if launches["layer_norm_fwd"] != (2 * layers + 1) * forwards or launches["layer_norm_bwd"]:
        failures.append(f"launches {launches} do not add up over {layers} layers")
    tokens = sum(len(r.tokens) for r in reqs)
    ttfts = [r.ttft for r in reqs]
    itls = [d for r in reqs for d in r.inter_token_times]
    checks, check_failures = _engine_checks(model, reqs, dev)
    failures += check_failures
    emit({"phase": "engine", "config": cfg, "options": ENGINE, "requests": len(reqs),
          "prompt_lens": ENGINE_PROMPT_LENS, "budgets": ENGINE_BUDGETS,
          "generated_tokens": tokens, "seconds": seconds, "tokens_s": tokens / seconds,
          "ttft_s": {"p50": float(np.percentile(ttfts, 50)),
                     "p99": float(np.percentile(ttfts, 99))},
          "inter_token_s": {"p50": float(np.percentile(itls, 50)),
                            "p99": float(np.percentile(itls, 99))},
          "decode_steps": engine.scheduler._steps - steps0,
          "arena_bytes": engine.arena.nbytes(), "max_memory_allocated": peak,
          "launches": launches, "checks": checks, "nvidia_smi": nvidia_smi(),
          "failures": failures})
    if failures:
        raise AssertionError(f"engine path check failed: {failures}")
    return launches, model


def _long_workload(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=ENGINE_LONG_PROMPT_LENS[i % len(ENGINE_LONG_PROMPT_LENS)])
             .astype(np.int32), ENGINE_LONG_BUDGET) for i in range(ENGINE_LONG_REQUESTS)]


def phase_engine_long(dev, model):
    """The engine of phase ``engine`` (config A, fp32, 16 slots, windows of
    16, flash) on the long-span workload: a warm-up pass, then the timed
    pass with every request submitted at once; tokens/s, TTFT, ITL, the
    span buckets the decode windows ran at and the launches, check (a) on
    every emitted token; then one decode window of 16 busy slots at the
    longest prompts under the profiler, with the span decode's share of
    the step's device time."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.ops import flash_serving as fs

    layers = CONFIGS["A"]["num_layers"]
    workload = _long_workload(model.vocab_size)
    engine = InferenceEngine(model, **ENGINE)
    engine.run(workload)
    spans = {}
    inner = fs._forward

    def counted(q, gk, *args):
        spans[gk.shape[1]] = spans.get(gk.shape[1], 0) + 1
        return inner(q, gk, *args)

    steps0 = engine.scheduler._steps
    torch.cuda.synchronize(dev)
    _reset_launches()
    fs._forward = counted
    try:
        t0 = time.perf_counter()
        reqs = [engine.submit(prompt, budget) for prompt, budget in workload]
        engine.run()
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        fs._forward = inner
    launches = _launches()
    steps = engine.scheduler._steps - steps0
    failures = []
    # every decode step of a window launches the span decode once a layer
    # (a window's tail runs on when its last request has finished)
    calls = sum(spans.values())
    forwards = (launches["flash_fwd"] + launches["span_decode"]) / layers
    if launches["span_decode"] != calls or calls % layers or calls < layers * steps \
            or launches["layer_norm_fwd"] != (2 * layers + 1) * forwards \
            or max(spans) != SPAN_MAXLEN:
        failures.append(f"launches {launches} for {calls} span-decode calls over {steps} "
                        f"decode steps of {layers} layers, spans {spans}")
    mismatches, close, check_failures, _ = _check_emitted(model, reqs, dev)
    failures += check_failures
    tokens = sum(len(r.tokens) for r in reqs)
    ttfts = [r.ttft for r in reqs]
    itls = [d for r in reqs for d in r.inter_token_times]
    emit({"phase": "engine_long", "config": CONFIGS["A"], "options": ENGINE,
          "requests": len(reqs), "prompt_lens": ENGINE_LONG_PROMPT_LENS,
          "budget": ENGINE_LONG_BUDGET, "generated_tokens": tokens, "seconds": seconds,
          "tokens_s": tokens / seconds,
          "ttft_s": {"p50": float(np.percentile(ttfts, 50)),
                     "p99": float(np.percentile(ttfts, 99))},
          "inter_token_s": {"p50": float(np.percentile(itls, 50)),
                            "p99": float(np.percentile(itls, 99))},
          "decode_steps": steps, "span_decode_calls_by_span": spans, "launches": launches,
          "a_token_mismatches": mismatches, "a_within_margin": close,
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"long-span engine check failed: {failures}")
    prompts = sorted((p for p, _ in workload), key=len)[-ENGINE["num_slots"]:]
    phase_profile_engine(dev, model, prompts, "long-span prompts "
                         f"{ENGINE_LONG_PROMPT_LENS}")


def _chunked_workload(vocab):
    """``(warm-up passes, timed)`` requests. For each CHUNKED_PREFIX_LENS
    length a prefix (a system prompt) from np.random.default_rng(2), and
    1 + CHUNKED_PER_PREFIX requests of it, each with its own suffix of 8-40
    tokens and ENGINE_BUDGETS: the first warms up (its prompt stays
    resident, as on a server that has run), the others are timed. Then
    engine_long's requests are timed. The warm-up runs long prompts of
    another seed, then the system prompts' requests in a pass of their
    own, so that they stay resident."""
    rng = np.random.default_rng(2)
    warm, timed = [], []
    for n in CHUNKED_PREFIX_LENS:
        prefix = rng.integers(1, vocab, size=n)
        for i in range(CHUNKED_PER_PREFIX + 1):
            suffix = rng.integers(1, vocab, size=int(rng.integers(8, 41)))
            (timed if i else warm).append((np.concatenate([prefix, suffix]).astype(np.int32),
                                           ENGINE_BUDGETS[i % len(ENGINE_BUDGETS)]))
    return (_long_workload(vocab, seed=3), warm), timed + _long_workload(vocab)


def _serve_pass(engine, workload, dev):
    """One timed pass: every request submitted at once, run to the end."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    reqs = [engine.submit(prompt, budget) for prompt, budget in workload]
    engine.run()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in reqs)
    ttfts = [r.ttft for r in reqs]
    itls = [d for r in reqs for d in r.inter_token_times]
    return reqs, {"seconds": seconds, "tokens_s": tokens / seconds, "generated_tokens": tokens,
                  "ttft_s": {"p50": float(np.percentile(ttfts, 50)),
                             "p99": float(np.percentile(ttfts, 99))},
                  "inter_token_s": {"p50": float(np.percentile(itls, 50)),
                                    "p99": float(np.percentile(itls, 99))}}


def phase_engine_chunked(dev, model):
    """The engine of phase ``engine`` (config A, fp32, 16 slots, windows of
    16, flash) with CHUNKED's prefill_chunk and prefix_cache, and the same
    engine without them, on _chunked_workload: for each its warm-up
    requests (which leave the chunked engine's system prompts resident),
    then the timed pass; tokens/s, TTFT and ITL of both, the chunked pass's launches and
    prefix-cache counters. Gates: every request's tokens equal the plain
    engine's and the plain path's argmax (check (a)) wherever the plain
    path's top-2 margin is >= MARGIN; prefix hits; the span chunk, span
    decode and LayerNorm kernels launched. Returns the chunked pass's
    launches."""
    from elephas_tpu_torch import InferenceEngine

    warm, workload = _chunked_workload(model.vocab_size)
    plain_engine = InferenceEngine(model, **ENGINE)
    for requests in warm:
        plain_engine.run(requests)
    plain_reqs, plain_row = _serve_pass(plain_engine, workload, dev)
    engine = InferenceEngine(model, **ENGINE, **CHUNKED)
    for requests in warm:
        engine.run(requests)
    hits0 = engine.stats()["prefix_cache"]["hits"]
    _reset_launches()
    reqs, row = _serve_pass(engine, workload, dev)
    launches = _launches()
    cache = engine.stats()["prefix_cache"]
    failures = []
    idle = [k for k in ("span_chunk", "span_decode", "layer_norm_fwd") if not launches[k] > 0]
    if idle:
        failures.append(f"the chunked engine path never launched {idle}")
    if not cache["hits"] > hits0:
        failures.append(f"no prefix hit in the timed pass: {cache}")
    mismatches, close, check_failures, plain = _check_emitted(model, reqs, dev)
    failures += check_failures
    differ = []
    for i, (r, pr) in enumerate(zip(reqs, plain_reqs)):
        p = len(r.prompt)

        def logits_of(j, i=i, p=p):
            return plain[i, p - 1 + j]

        bad = _first_divergence(r.tokens, pr.tokens, logits_of)
        if r.tokens != pr.tokens:
            differ.append(i)
        if bad:
            failures.append(f"request {i} against the engine without the options: {bad}")
    emit({"phase": "engine_chunked", "config": CONFIGS["A"], "options": {**ENGINE, **CHUNKED},
          "requests": len(reqs), "prefix_lens": CHUNKED_PREFIX_LENS,
          "per_prefix": CHUNKED_PER_PREFIX, "long_prompt_lens": ENGINE_LONG_PROMPT_LENS,
          "chunked": row, "without_options": plain_row,
          "reused_tokens": sum(r.reused_tokens for r in reqs), "prefix_cache": cache,
          "prefix_hits_timed_pass": cache["hits"] - hits0, "launches": launches,
          "a_token_mismatches": mismatches, "a_within_margin": close,
          "requests_differing_from_without_options": differ,
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"chunked engine check failed: {failures}")
    _profile_chunked_step(dev, model, max((p for p, _ in workload), key=len))
    return launches


def _profile_chunked_step(dev, model, long_prompt):
    """One step of the chunked engine under torch.profiler: 15 slots
    decoding (E's prompts) while ``long_prompt`` prefills, i.e. one chunk
    pass of prefill_chunk tokens and one decode window; after a warm-up
    step, with the span chunk's share of the device time."""
    from elephas_tpu_torch import InferenceEngine

    steps = ENGINE["steps_per_sync"]
    engine = InferenceEngine(model, **ENGINE, **CHUNKED)
    for prompt, _ in _engine_workload(model.vocab_size, ENGINE["num_slots"] - 1):
        engine.submit(prompt, 8 * steps)
    while engine._prefilling or engine.scheduler.waiting:
        engine.step()
    engine.submit(long_prompt, steps)
    engine.step()  # admission, the first chunk and a window
    progress = next(iter(engine._prefilling.values()))[1]
    out = _profile(dev, engine.step, f"chunked engine step at config A: one chunk of "
                   f"{CHUNKED['prefill_chunk']} tokens of a {len(long_prompt)}-token prompt "
                   f"(from {progress}) and one window of {steps} steps over "
                   f"{ENGINE['num_slots'] - 1} decoding slots")
    by_class = out.get("by_class_ms", {})
    if out["device_ms"] > 0:
        share = (by_class.get("span_chunk", 0.0) + by_class.get("span_chunk_merge", 0.0)) \
            / out["device_ms"]
        emit({"phase": "profile", "what": "span chunk share of the chunked engine step",
              "span_chunk_share_of_device": share,
              "span_chunk_ms": by_class.get("span_chunk", 0.0),
              "span_chunk_merge_ms": by_class.get("span_chunk_merge", 0.0)})
        if not by_class.get("span_chunk", 0.0) > 0:
            raise AssertionError("the chunked engine profile shows no span_chunk_kernel time")


# kernel name fragment → class, first match wins
KERNEL_CLASSES = (
    ("flash_fwd_kernel", "flash_fwd"),
    ("paged_span_decode_kernel", "paged_span_decode"),
    ("paged_span_chunk_kernel", "paged_span_chunk"),
    ("span_decode_merge_kernel", "span_decode_merge"),
    ("span_decode_kernel", "span_decode"),
    ("span_chunk_merge_kernel", "span_chunk_merge"),
    ("span_chunk_kernel", "span_chunk"),
    ("ln_fwd", "layer_norm_fwd"),
    ("ln_bwd", "layer_norm_bwd"),
    ("fprop", "conv"), ("dgrad", "conv"), ("wgrad", "conv"), ("conv", "conv"),
    ("batch_norm", "batch_norm"), ("bn_fw", "batch_norm"), ("bn_bw", "batch_norm"),
    ("gemm", "gemm"), ("nvjet", "gemm"), ("xmma", "gemm"), ("cutlass", "gemm"),
    ("softmax", "softmax"),
    ("reduce", "reduction"),
    ("elementwise", "elementwise"),
    ("Memcpy", "memcpy"), ("Memset", "memset"),
)


def _kernel_class(name):
    for fragment, cls in KERNEL_CLASSES:
        if fragment.lower() in name.lower():
            return cls
    return "other"


def _profile(dev, fn, what, per=1, extra=None, annotation=None):
    """``fn`` once under torch.profiler (after the caller's warm-up):
    device time by kernel class and the top kernels beside the wall time,
    each divided by ``per`` (steps in the call), with ``extra`` in the
    printed line, and with ``annotation`` the device time of the
    record_function ranges of that name (:func:`_annotation_ms`). Reports,
    and does not fail, when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
    device_events = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    # a user annotation (Optimizer.step#Adam.step) spans kernels counted
    # on their own
    annotations = [ev.key for ev in device_events if ev.is_user_annotation]
    kernels = [ev for ev in device_events if not ev.is_user_annotation]
    by_class, top = {}, []
    for ev in kernels:
        ms = ev.self_device_time_total / 1e3 / per
        cls = _kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.append((ms, ev.count / per, ev.key[:120]))
    device_ms = sum(by_class.values())
    out = {"phase": "profile", "what": what, "wall_ms": wall_ms, "device_ms": device_ms,
           "annotations_excluded": annotations, **(extra or {})}
    if device_ms > 0:
        out.update({
            "idle_share": 1 - device_ms / wall_ms,
            "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "count": n, "name": name}
                            for ms, n, name in sorted(top, reverse=True)[:12]],
        })
        if annotation:
            out["annotation"] = _annotation_ms(prof, annotation, per)
    else:
        out["note"] = "the profiler recorded no device time: not measured"
    emit(out)
    return out


def phase_profile(dev, model, batch, what="one training step, TRAIN config"):
    """One training step of a trained model (forward, loss, backward, the
    optimizer) under torch.profiler, after one warm-up step."""
    spec = model.training_spec
    xb, yb = batch

    def step():
        loss = spec.loss(yb, model(xb)).mean()
        spec.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        spec.optimizer.step()

    model.train()
    step()
    _profile(dev, step, what)
    model.eval()


PROFILE_STEPS = 8
# the kernel wrappers whose host time the generate and engine profiles
# read: (module, function) -> the kernel it launches. For LayerNorm this is
# the entry the model calls (models.transformer's layer_norm: the route
# choice, any autograd Function, the checks, allocations and the launch),
# so two packages compare whatever path each takes.
WRAPPERS = {("elephas_tpu_torch.ops.flash_attention", "_forward"): "flash_fwd",
            ("elephas_tpu_torch.models.transformer", "layer_norm"): "layer_norm_fwd",
            ("elephas_tpu_torch.ops.flash_serving", "_forward"): "span_decode"}


def _wrapper_host_ms(dev, fn, per):
    """``fn`` once with each kernel wrapper of WRAPPERS timed on the host
    (perf_counter around the call: checks, allocation and the ctypes
    launch); returns the wall ms and, per kernel, the calls and host ms,
    each divided by ``per``."""
    import importlib

    totals = {}
    saved = []
    for (module, name), kernel in WRAPPERS.items():
        mod = importlib.import_module(module)
        inner = getattr(mod, name)
        saved.append((mod, name, inner))

        def timed(*args, _inner=inner, _kernel=kernel, **kwargs):
            t0 = time.perf_counter()
            try:
                return _inner(*args, **kwargs)
            finally:
                calls, ms = totals.get(_kernel, (0, 0.0))
                totals[_kernel] = (calls + 1, ms + (time.perf_counter() - t0) * 1e3)

        setattr(mod, name, timed)
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    hosts = {k: {"calls": calls / per, "host_ms": ms / per, "host_ms_per_call": ms / calls}
             for k, (calls, ms) in totals.items()}
    return {"unprofiled_wall_ms": wall_ms, "wrapper_host": hosts,
            "wrapper_host_share": sum(h["host_ms"] for h in hosts.values()) / wall_ms}


def phase_profile_generate(dev):
    """generate() at config A, batch 1, one 40-token prompt, rope off
    (packed qkv path) and on (bhsd path): after a warm-up call,
    PROFILE_STEPS steps with the wrappers' host time, then the same under
    torch.profiler; every figure per step."""
    from elephas_tpu_torch import generate, transformer_lm

    prompt = _prompts(CONFIGS["A"]["vocab_size"])[-1][None]
    for rope in (False, True):
        model = transformer_lm(**CONFIGS["A"], rope=rope, seed=0, device=dev)
        generate(model, prompt, steps=2)

        def run():
            generate(model, prompt, steps=PROFILE_STEPS)

        host = _wrapper_host_ms(dev, run, PROFILE_STEPS)
        out = _profile(dev, run, f"generate at config A rope={rope}, batch 1, per step "
                       f"of {PROFILE_STEPS}", per=PROFILE_STEPS, extra=host)
        flash = out.get("by_class_ms", {}).get("flash_fwd", 0.0)
        if out["device_ms"] > 0 and not flash > 0:
            raise AssertionError("the generate profile shows no flash_fwd_kernel time")
        del model


def phase_profile_engine(dev, model, prompts=None, what="E's prompts"):
    """One decode window of the engine at config A (16 busy slots, 16
    steps; ``prompts``, one a slot, default the first of E's workload),
    after a warm-up window: the wrappers' host time, then the same under
    torch.profiler; every figure per decode step, with the span decode's
    share of the device time (its two kernels)."""
    from elephas_tpu_torch import InferenceEngine

    steps = ENGINE["steps_per_sync"]
    engine = InferenceEngine(model, **ENGINE)
    if prompts is None:
        prompts = [p for p, _ in _engine_workload(model.vocab_size, ENGINE["num_slots"])]
    for prompt in prompts:
        engine.submit(prompt, 4 * steps)  # busy through the three windows below
    engine.step()  # prefill and the warm-up window
    span = engine._decode_span()
    host = _wrapper_host_ms(dev, engine.step, steps)
    out = _profile(dev, engine.step, f"engine decode window at config A, "
                   f"{ENGINE['num_slots']} slots ({what}), per step of {steps}", per=steps,
                   extra={**host, "span": span})
    by_class = out.get("by_class_ms", {})
    share = (by_class.get("span_decode", 0.0) + by_class.get("span_decode_merge", 0.0)) \
        / out["device_ms"] if out["device_ms"] > 0 else None
    emit({"phase": "profile", "what": f"span decode share of the engine step ({what})",
          "span": span, "span_decode_share_of_device": share})
    if out["device_ms"] > 0 and not by_class.get("span_decode", 0.0) > 0:
        raise AssertionError("the engine profile shows no span_decode_kernel time")
    if len(engine.scheduler.active) != ENGINE["num_slots"]:
        raise AssertionError("a request of the profiled window finished early")


def _time_ms(fn, iters=50):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph(fn, iters=50):
    """A CUDA graph of ``iters`` calls of ``fn``, captured after three
    warm-up calls on a side stream. The kernel wrappers launch on the
    current stream, so the graph holds their kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph


def _graph_ms(graph, iters=50):
    """Device time per call of a graph of ``iters`` calls: no host gaps."""
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _flash_row(qkv, views, scale, causal, dtype):
    """The flash forward kernel (packed layout), its plain version and
    scaled_dot_product_attention on one input, timed in turns: eager
    (``ms``, ``plain_ms``, ``library_ms``) and from CUDA graphs
    (``device_ms``, ``plain_device_ms``, ``library_device_ms``); with the
    bound of the work (operations at ``_flash_peak``)."""
    from torch.nn.functional import scaled_dot_product_attention

    from elephas_tpu_torch.ops.flash_attention import (
        _flash_forward_packed, flash_forward_reference,
    )

    q, k, v = views
    fns = {
        "ms": lambda: _flash_forward_packed(qkv, scale, causal, 128, 128),
        "plain_ms": lambda: flash_forward_reference(q, k, v, scale, causal),
        "library_ms": lambda: scaled_dot_product_attention(q, k, v, is_causal=causal),
    }
    samples = _time_in_turns(fns)
    graphs = _time_in_turns(fns, graphs=True)
    samples.update({key[:-2] + "device_ms": v for key, v in graphs.items()})
    b, h, s, d = q.shape
    # causal: half the score matrix (the diagonal counted once)
    flops = 4 * b * h * s * s * d // (2 if causal else 1)
    nbytes = 4 * b * h * s * d * qkv.element_size() + 4 * b * h * s
    return {**_summary(samples, nbytes, flops, dtype, _flash_peak(dtype)),
            "shape": {"B": b, "S": s, "H": h, "D": d}, "causal": causal}


def _flash_peak(dtype):
    """The flash kernel's operation rate: bf16 on the tensor cores; fp32
    as 3xTF32, a third of the TF32 rate."""
    return PEAK_3XTF32_S if dtype == torch.float32 else PEAK_FLOPS_S[dtype]


# the flash rows of phase_times: (config, batch, causal); T is the
# training shape (not causal)
FLASH_TIMES = (("A", 8, True), ("A", 1, True), ("B", 8, True), ("T", TRAIN_BATCH, False))


def phase_times(dev):
    """Kernel, plain and library times at the attention shapes of the
    main paths (the packed layout of the default path), in turns: config
    A at batch 8 and at batch 1 (as each generate() call here runs it)
    and config B (head_dim 64) at batch 8, causal; the training shape,
    not causal. fp32 rows also give the FMA bound of the design the
    kernel replaced."""
    rows = {}
    for name, b, causal in FLASH_TIMES:
        cfg = TRAIN if name == "T" else CONFIGS[name]
        s, h = cfg["maxlen"], cfg["num_heads"]
        d = cfg["d_model"] // h
        for dtype in (torch.float32, torch.bfloat16):
            qkv, views = _case_inputs("packed", b, s, h, d, dtype, dev, 7)
            rows[f"{name}_B{b}_{str(dtype).split('.')[-1]}"] = _flash_row(
                qkv, views, d ** -0.5, causal, dtype)
            del qkv, views
    emit({"phase": "times", "kernel": "flash_fwd", "layout": "packed",
          "timing": GRAPH_TIMING, **rows})
    return rows


def _time_in_turns(fns, graphs=False, rounds=3, iters=50):
    """Each function's time, ``rounds`` rounds in turns: eager calls
    (``iters`` a round), or the replay of a CUDA graph of 50 calls
    (``graphs``)."""
    if graphs:
        graphs = {key: _graph(fn) for key, fn in fns.items()}
    samples = {key: [] for key in fns}
    for _ in range(rounds):
        for key, fn in fns.items():
            samples[key].append(_graph_ms(graphs[key]) if graphs else _time_ms(fn, iters))
    return samples


def _summary(samples, nbytes, flops, dtype, peak_flops=None):
    """Median times, and the bound: the larger of bytes over the card's
    memory rate and operations over ``peak_flops`` (default: the card's
    peak for the type). fp32 flash rows add the FMA bound (operations
    over the 67 TFLOP/s of fp32 FMA) of the design the kernel replaced."""
    peak = peak_flops or PEAK_FLOPS_S[dtype]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    out = {
        **{key: float(np.median(v)) for key, v in samples.items()},
        "samples": samples,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "peak_flops_s": peak, "flops": flops, "bytes": nbytes,
    }
    if peak_flops and dtype == torch.float32:
        out["fma_bound_ms"] = max(t_bytes, flops / PEAK_FLOPS_S[dtype]) * 1e3
    return out


def _with_device_ms(fns, library_graph):
    """Eager times of ``fns`` in turns, and from CUDA graphs in turns
    ``device_ms`` (the kernel, ``fns["ms"]``) and ``library_device_ms``
    (``library_graph``)."""
    samples = _time_in_turns(fns)
    samples.update(_time_in_turns({"device_ms": fns["ms"], "library_device_ms": library_graph},
                                  graphs=True))
    return samples


def phase_times_layer_norm(dev):
    """The LayerNorm kernels at the training rows (batch x maxlen rows of
    d_model: 32768 x 1024), at config A's generate rows (maxlen rows of
    d_model: 512 x 512) and at the engine's decode rows (one a slot: 16 x
    512), fp32 and bf16; the kernel's device time from a
    CUDA graph beside the eager times. Library: the
    forward of torch.nn.functional.layer_norm and its autograd backward
    (dx, dgamma, dbeta), eager; on the device from CUDA graphs, the
    forward and aten.native_layer_norm_backward, the operator that
    backward runs (the autograd engine itself does not capture on the
    graph's stream). Bytes: each input read once and each output written
    once; operations: about 8 (forward) and 12 (backward) per element.

    The entry rows time what the serving paths call: ``layer_norm(x, γ,
    β)`` against ``torch.nn.functional.layer_norm``, both under
    torch.inference_mode(), eager and from CUDA graphs (the bound counts
    no statistics). They use only functions every package of the port
    has, so --times-only times an earlier checkout's path the same way.
    Then the rows-per-block sweep (_ln_rows_sweep), where the package
    has that choice."""
    from torch.nn.functional import layer_norm as torch_layer_norm

    from elephas_tpu_torch.ops import layer_norm as ln

    rows = {}
    shapes = {"train": (TRAIN_BATCH * TRAIN["maxlen"], TRAIN["d_model"]),
              "A": (CONFIGS["A"]["maxlen"], CONFIGS["A"]["d_model"]),
              "E": (ENGINE["num_slots"], CONFIGS["A"]["d_model"])}
    for name, (n, d) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, gamma, beta, dy = _ln_inputs(n, d, dtype, dev, 11)
            _, mean, rstd = ln.layer_norm_forward(x, gamma, beta, LN_EPS)
            # the library call takes gamma/beta in x's dtype (copies: the
            # kernel's operands stay free of autograd)
            xl = x.detach().clone().requires_grad_()
            gl = gamma.to(dtype, copy=True).requires_grad_()
            bl = beta.to(dtype, copy=True).requires_grad_()
            yl = torch_layer_norm(xl, (d,), gl, bl, LN_EPS)
            g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
            _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [d], g_lib, b_lib, LN_EPS)
            item = x.element_size()
            fwd = {
                "ms": lambda: ln.layer_norm_forward(x, gamma, beta, LN_EPS),
                "plain_ms": lambda: ln.layer_norm_forward_reference(x, gamma, beta, LN_EPS),
                "library_ms": lambda: torch_layer_norm(x, (d,), gl, bl, LN_EPS),
            }
            bwd = {
                "ms": lambda: ln.layer_norm_backward(x, gamma, dy, mean, rstd),
                "plain_ms": lambda: ln.layer_norm_backward_reference(x, gamma, dy, mean, rstd),
                "library_ms": lambda: torch.autograd.grad(yl, (xl, gl, bl), dy,
                                                          retain_graph=True),
            }
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            fwd_graph = lambda: torch_layer_norm(x, (d,), g_lib, b_lib, LN_EPS)  # noqa: E731
            bwd_graph = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa: E731
                dy, x, [d], lmean, lrstd, g_lib, b_lib, [True, True, True])
            rows[f"layer_norm_fwd_{tag}"] = {"N": n, "d": d, **_summary(
                _with_device_ms(fwd, fwd_graph), 2 * n * d * item + 2 * d * 4 + 2 * n * 4,
                8 * n * d, dtype)}
            rows[f"layer_norm_bwd_{tag}"] = {"N": n, "d": d, **_summary(
                _with_device_ms(bwd, bwd_graph),
                3 * n * d * item + d * 4 + 2 * n * 4 + 2 * d * 4, 12 * n * d, dtype)}
            entry = {
                "ms": lambda: ln.layer_norm(x, gamma, beta, LN_EPS),
                "library_ms": lambda: torch_layer_norm(x, (d,), g_lib, b_lib, LN_EPS),
            }
            with torch.inference_mode():
                samples = _time_in_turns(entry, rounds=ENTRY_ROUNDS, iters=ENTRY_ITERS)
                graphs = _time_in_turns(entry, graphs=True)
            samples.update({key[:-2] + "device_ms": t for key, t in graphs.items()})
            rows[f"layer_norm_entry_{tag}"] = {
                "N": n, "d": d, "under": "torch.inference_mode()",
                "eager_timing": f"{ENTRY_ROUNDS} rounds in turns of {ENTRY_ITERS} calls",
                **_summary(samples, 2 * n * d * item + 2 * d * 4, 8 * n * d, dtype)}
    emit({"phase": "times", "kernel": "layer_norm", "timing": GRAPH_TIMING, **rows})
    if hasattr(ln, "rows_per_block"):
        _ln_rows_sweep(dev, ln)
    return rows


# the entry rows' eager timing: the host's clock spreads more than the
# device's, so more rounds of more calls than the kernel rows
ENTRY_ROUNDS, ENTRY_ITERS = 9, 200

# rows x width of the rows-per-block sweep: E's decode rows, A's generate
# rows and the training rows
LN_SWEEP_SHAPES = ((16, 512), (512, 512), (32768, 1024))


def _ln_rows_sweep(dev, ln):
    """Device ms of the serving route (layer_norm under inference_mode,
    from CUDA graphs, median of 3 replays) with ln.rows_per_block replaced
    by each count of ln.ROWS_PER_BLOCK, at LN_SWEEP_SHAPES in fp32 and
    bf16, beside the rule's pick; every count must give the same bits.
    Printed on a line of its own."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pick = ln.rows_per_block
    out, faults = {}, []
    try:
        for n, d in LN_SWEEP_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                x, gamma, beta, _ = _ln_inputs(n, d, dtype, dev, 23)
                fn = lambda: ln.layer_norm(x, gamma, beta, LN_EPS)  # noqa: E731
                times, first = {}, None
                with torch.inference_mode():
                    for rows in ln.ROWS_PER_BLOCK:
                        ln.rows_per_block = lambda *_, r=rows: r
                        y = fn()
                        first = y if first is None else first
                        if not torch.equal(y, first):
                            faults.append(f"{n} x {d} {dtype}: {rows} rows a block "
                                          "changes the bits")
                        graph = _graph(fn)
                        times[rows] = float(np.median([_graph_ms(graph) for _ in range(3)]))
                        del graph
                out[f"{n}x{d}_{str(dtype).split('.')[-1]}"] = {
                    "device_ms_by_rows_per_block": times, "pick": pick(n, sms)}
    finally:
        ln.rows_per_block = pick
    emit({"phase": "times", "kernel": "layer_norm_rows_per_block_sweep", "sms": sms,
          "timing": "CUDA-graph replay of 50 calls, median of 3", **out, "faults": faults})
    if faults:
        raise AssertionError(f"rows-per-block sweep: {faults}")


LN_HOST_ITERS, LN_HOST_ROUNDS = 1000, 7


def _host_us(fns):
    """Host µs per call of each of ``fns``: perf_counter around
    LN_HOST_ITERS calls (no synchronise inside), LN_HOST_ROUNDS rounds
    with the functions in turns, the median round."""
    for fn in fns.values():
        fn()
    rounds = {key: [] for key in fns}
    for _ in range(LN_HOST_ROUNDS):
        for key, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LN_HOST_ITERS):
                fn()
            rounds[key].append((time.perf_counter() - t0) * 1e6 / LN_HOST_ITERS)
    torch.cuda.synchronize()
    return {key: float(np.median(v)) for key, v in rounds.items()}


def phase_ln_host_breakdown(dev):
    """Where a LayerNorm call's host time goes, at E's decode rows (16 x
    512) and A's generate rows (512 x 512), fp32, under
    torch.inference_mode() as the serving paths call it, γ/β requiring
    grad as the model's parameters do: the entry (layer_norm), and each
    piece of the path timed alone: the autograd Function around the
    forward, the forward wrapper with statistics, its checks, its three
    allocations, the float casts of γ/β, the device guard, the Stream
    object for the current stream, six data_ptr calls, the ctypes call
    that marshals the arguments and returns before launching (n = 0), the
    same call launching the kernel, and torch.nn.functional.layer_norm as
    the yardstick; for a package with the inference route also the route
    predicate, the raw stream handle, the current-device test, one
    allocation and the route itself."""
    from torch.nn.functional import layer_norm as torch_layer_norm

    from elephas_tpu_torch.ops import layer_norm as ln

    lib = ln._kernel()
    routes = hasattr(ln, "layer_norm_inference")
    out = {}
    for n, d in ((ENGINE["num_slots"], CONFIGS["A"]["d_model"]),
                 (CONFIGS["A"]["maxlen"], CONFIGS["A"]["d_model"])):
        x, gamma, beta, _ = _ln_inputs(n, d, torch.float32, dev, 19)
        gamma.requires_grad_()
        beta.requires_grad_()
        y, mean, rstd = (t.detach() for t in ln.layer_norm_forward(x, gamma, beta, LN_EPS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the C entry's arguments: PR 6's eleven, or twelve with the rows a block
        extra = [1] if len(lib.elephas_ln_fwd.argtypes) == 12 else []
        args = [x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), 0, n, d, LN_EPS, *extra, stream]
        no_launch = [*args[:7], 0, *args[8:]]

        def guard(x=x):
            with torch.cuda.device(x.device):
                pass

        pieces = {
            "entry": lambda: ln.layer_norm(x, gamma, beta, LN_EPS),
            "autograd_function_with_forward": lambda: ln._LayerNorm.apply(x, gamma, beta,
                                                                          LN_EPS),
            "forward_wrapper_with_stats": lambda: ln.layer_norm_forward(x, gamma, beta, LN_EPS),
            "checks": lambda: (ln._check_cuda_rows(x), ln._check_vector("gamma", gamma, x),
                               ln._check_vector("beta", beta, x)),
            "three_allocations": lambda: (
                torch.empty_like(x), torch.empty(n, dtype=torch.float32, device=x.device),
                torch.empty(n, dtype=torch.float32, device=x.device)),
            "float_casts": lambda: (gamma.float(), beta.float()),
            "device_guard": guard,
            "stream_object": lambda: torch.cuda.current_stream(x.device).cuda_stream,
            "six_data_ptrs": lambda: (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                      y.data_ptr(), mean.data_ptr(), rstd.data_ptr()),
            "ctypes_call_no_launch": lambda: lib.elephas_ln_fwd(*no_launch),
            "ctypes_call_with_launch": lambda: lib.elephas_ln_fwd(*args),
            "library_entry": lambda: torch_layer_norm(x, (d,), gamma.detach(),
                                                      beta.detach(), LN_EPS),
        }
        if routes:
            index = x.get_device()
            pieces.update({
                "route_predicate": lambda: ln.needs_grad(x, gamma, beta),
                "raw_stream": lambda: ln._current_raw_stream(index),
                "current_device_test": lambda: index == torch._C._cuda_getDevice(),
                "one_allocation": lambda: torch.empty_like(x),
                "inference_route": lambda: ln.layer_norm_inference(x, gamma, beta, LN_EPS),
            })
        with torch.inference_mode():
            out[f"{n}x{d}"] = _host_us(pieces)
    emit({"phase": "ln_host_breakdown", "unit": "host µs per call",
          "timing": f"perf_counter around {LN_HOST_ITERS} calls, median of {LN_HOST_ROUNDS} "
                    "rounds in turns, under torch.inference_mode()", **out})
    return out


def phase_times_train(dev):
    """At the training shape (packed qkv B128 S256 H8 D128, not causal,
    fp32): the plain flash backward of one layer (the recomputed scores,
    then four products: about 2.5x the forward's operations) beside SDPA's
    autograd backward and its forward + backward, eager (device-bound at
    this size)."""
    from torch.nn.functional import scaled_dot_product_attention

    from elephas_tpu_torch.ops.flash_attention import _flash_forward_packed, flash_backward

    b, s, h = TRAIN_BATCH, TRAIN["maxlen"], TRAIN["num_heads"]
    d = TRAIN["d_model"] // h
    scale = d ** -0.5
    qkv, (q, k, v) = _case_inputs("packed", b, s, h, d, torch.float32, dev, 13)
    out, lse = _flash_forward_packed(qkv, scale, False, 128, 128)
    g = torch.randn_like(out)
    o, gg = out.transpose(1, 2), g.transpose(1, 2)
    lse = lse.view(b, h, s)
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
    ol = scaled_dot_product_attention(ql, kl, vl)

    def library_fwd_bwd():
        torch.autograd.grad(scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), gg)

    fwd_flops = 4 * b * h * s * s * d
    row = _summary(
        _time_in_turns({
            "plain_ms": lambda: flash_backward(q, k, v, o, lse, gg, scale, False),
            "library_ms": lambda: torch.autograd.grad(ol, (ql, kl, vl), gg, retain_graph=True),
            "library_fwd_bwd_ms": library_fwd_bwd,
        }),
        8 * b * h * s * d * 4 + 4 * b * h * s, fwd_flops * 5 // 2, torch.float32)
    emit({"phase": "times", "kernel": "train_attention_backward",
          "shape": {"B": b, "S": s, "H": h, "D": d}, "timing": TIMING,
          "flash_bwd_plain_train": row})
    return row


# the span-decode rows of phase_times: every span bucket of A's maxlen
# (E's decode windows run at 64 and 128, the long-span pass up to 512)
SPAN_TIMES = (64, 128, 256, 512)
# split counts timed beside the wrapper's own pick, at each span
SPLIT_SWEEP = (1, 2, 4, 8, 16)


def _split_sweep(fs, q, k, v, pos):
    """{splits: [device ms, eager ms]} of the span decode with span_splits
    replaced by each split count of SPLIT_SWEEP that leaves every split at
    least fs.SPLIT_MIN_KEYS positions; medians of 3 graph replays and of 3
    eager runs (the eager time shows the host cost of a split: the
    workspace and the second launch)."""
    span, pick = k.shape[1], fs.span_splits
    out = {}
    try:
        for n in SPLIT_SWEEP:
            if n > 1 and span < n * fs.SPLIT_MIN_KEYS:
                continue
            chunk = -(-span // n)
            fs.span_splits = lambda *_, c=chunk: (-(-span // c), c)
            fn = lambda: fs.flash_span_decode(q, k, v, pos)  # noqa: E731
            graph = _graph(fn)
            out[n] = [float(np.median([_graph_ms(graph) for _ in range(3)])),
                      float(np.median([_time_ms(fn) for _ in range(3)]))]
    finally:
        fs.span_splits = pick
    return out


def _alloc_host_ms(numel, dev, iters=1000):
    """Host ms of one torch.empty of ``numel`` float32 on ``dev`` (the
    wrapper's workspace), freed at once: the caching allocator's path."""
    torch.empty(numel, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        torch.empty(numel, dtype=torch.float32, device=dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_times_span_decode(dev):
    """The span-decode kernel at the engine's decode shape (16 slots, 4
    heads of 128, fp32) with the ragged positions of _span_inputs, beside
    its plain version and SDPA with a boolean mask over [B, H, 1, span]
    (the library yardstick, never called by the port), eager and from
    CUDA graphs. Bytes: the visible K and V rows, q, out and the
    positions; operations: 4 per visible key and dim. Each span also
    times the kernel at each split count of SPLIT_SWEEP (span_splits
    replaced for the sweep), and the host time of the workspace
    allocation the wrapper makes per call; both are skipped for a package
    whose span decode does not split (an earlier checkout, with
    --times-only)."""
    b, h = ENGINE["num_slots"], CONFIGS["A"]["num_heads"]
    d = CONFIGS["A"]["d_model"] // h
    rows = {f"span{span}": _span_row(dev, b, h, d, span) for span in SPAN_TIMES}
    emit({"phase": "times", "kernel": "span_decode", "timing": GRAPH_TIMING, **rows})
    return rows


def _span_row(dev, b, h, d, span, sweep=True):
    """One row of phase_times_span_decode: the kernel, its plain version
    and masked SDPA on _span_inputs(b, h, d, span), eager and from CUDA
    graphs, with the bound; ``sweep`` adds the split sweep and the
    workspace's host time."""
    from torch.nn.functional import scaled_dot_product_attention

    from elephas_tpu_torch.ops import flash_serving as fs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q, k, v, pos = _span_inputs(b, h, d, span, dev, 17)
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    cols = torch.arange(span, device=dev)
    mask = (cols[None, :] <= pos[:, None])[:, None, None, :].expand(b, h, 1, span)
    fns = {
        "ms": lambda: fs.flash_span_decode(q, k, v, pos),
        "plain_ms": lambda: fs.span_chunk_reference(q4, k, v, pos[:, None]),
        "library_ms": lambda: scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
    }
    lib_err = (fns["library_ms"]()[:, :, 0] - fns["ms"]()).abs().max().item()
    samples = _time_in_turns(fns)
    graphs = _time_in_turns(fns, graphs=True)
    samples.update({key[:-2] + "device_ms": t for key, t in graphs.items()})
    visible = int(torch.clamp(pos.long() + 1, max=span).sum())
    nbytes = 2 * visible * h * d * 4 + 2 * b * h * d * 4 + b * 4
    row = {**_summary(samples, nbytes, 4 * visible * h * d, torch.float32),
           "shape": {"B": b, "H": h, "D": d, "span": span}, "visible_keys": visible,
           "library_max_abs_diff": lib_err}
    if sweep and hasattr(fs, "span_splits"):
        splits, chunk = fs.span_splits(span, b * h, sms)
        row.update({"splits": splits, "chunk": chunk,
                    "split_sweep_device_ms_eager_ms": _split_sweep(fs, q, k, v, pos),
                    "workspace_alloc_host_ms": _alloc_host_ms(
                        b * h * splits * (d + 2), dev) if splits > 1 else 0.0})
    return row


# the span-chunk rows of phase_times beside the CHUNK_CASE rows: the
# engine's launch at every span bucket and a cold 512-row chunk from 0
CHUNK_C512 = (1, 4, 128, 512)
# split counts timed beside span_chunk_splits' own pick, at each row
CHUNK_SPLIT_SWEEP = (1, 2, 4, 8)


def _chunk_split_sweep(fs, fn, span):
    """{splits: device ms} of ``fn`` (a span-chunk call) with
    span_chunk_splits replaced by each count of CHUNK_SPLIT_SWEEP that
    leaves every split whole tiles; medians of 3 graph replays."""
    pick, out = fs.span_chunk_splits, {}
    tiles = -(-span // fs.CHUNK_TILE)
    try:
        for n in CHUNK_SPLIT_SWEEP:
            if n > tiles:
                continue
            chunk = fs.CHUNK_TILE * -(-tiles // n)
            fs.span_chunk_splits = lambda *_, c=chunk: (-(-span // c), c)
            graph = _graph(fn)
            out[-(-span // chunk)] = float(np.median([_graph_ms(graph) for _ in range(3)]))
    finally:
        fs.span_chunk_splits = pick
    return out


def _chunk_row(fs, q, k, v, pos, slot_map, sms):
    """The span chunk, its plain version and SDPA with a boolean mask over
    [B, H, C, span] (the library yardstick, never called by the port) on one
    input, eager and from CUDA graphs, with the bound of the work: bytes of
    each slot's visible K and V rows (up to its deepest row's position), q,
    out, the positions and the slot map; operations, 4 per visible key and
    dim of every row, at the 3xTF32 rate (also at fp32 FMA's,
    ``fma_bound_ms``)."""
    from torch.nn.functional import scaled_dot_product_attention

    b, h, c, d = q.shape
    span = k.shape[1]
    kk, vv = (k, v) if slot_map is None else (k[slot_map], v[slot_map])
    k4, v4 = kk.transpose(1, 2), vv.transpose(1, 2)
    cols = torch.arange(span, device=q.device)
    mask = (cols[None, None, :] <= pos[:, :, None])[:, None].expand(b, h, c, span)
    fns = {
        "ms": lambda: fs.flash_span_chunk(q, k, v, pos, slots=slot_map),
        "plain_ms": lambda: fs.span_chunk_reference(q, kk, vv, pos),
        "library_ms": lambda: scaled_dot_product_attention(q, k4, v4, attn_mask=mask),
    }
    lib_err = (fns["library_ms"]() - fns["ms"]()).abs().max().item()
    samples = _time_in_turns(fns)
    graphs = _time_in_turns(fns, graphs=True)
    samples.update({key[:-2] + "device_ms": t for key, t in graphs.items()})
    visible = torch.clamp(pos.long() + 1, min=0, max=span)  # [B, C]
    keys_read = int(visible.amax(dim=1).sum())
    nbytes = (2 * keys_read * h * d * 4 + 2 * b * h * c * d * 4 + b * c * 4
              + (0 if slot_map is None else b * 8))
    flops = 4 * int(visible.sum()) * h * d
    row = {**_summary(samples, nbytes, flops, torch.float32, PEAK_3XTF32_S),
           "shape": {"B": b, "H": h, "D": d, "C": c, "span": span,
                     "slot_map": slot_map is not None},
           "library_max_abs_diff": lib_err}
    if hasattr(fs, "span_chunk_splits"):
        row["splits_chunk"] = fs.span_chunk_splits(span, b * h, c, d, sms)
        row["split_sweep_device_ms"] = _chunk_split_sweep(fs, fns["ms"], span)
    else:  # an earlier package split as the decode does
        row["splits_chunk"] = fs.span_splits(span, b * h, sms)
    return row


def phase_times_span_chunk(dev):
    """The span-chunk kernel, its plain version and masked SDPA, eager and
    from CUDA graphs (_chunk_row), at the shapes the main path launches:
    CHUNK_CASE with the ragged offsets of _chunk_inputs over CHUNK_SPANS
    (``span<n>``, where the first design was timed); the verify window, VERIFY_W
    rows on each of CHUNK_CASE's slots at the same offsets (``verify_span<n>``);
    the engine's launch, one slot of its
    16-slot arena through the slot map with the chunk ending on the span's
    last row, at every span bucket (``engine_span<n>``); and CHUNK_C512, a
    512-row chunk from position 0 through the slot map (``c512_offset0``).
    Each row also times the kernel at each split count of
    CHUNK_SPLIT_SWEEP (span_chunk_splits replaced for the sweep). Works
    for a package whose span chunk predates span_chunk_splits (the splits
    are then the decode's rule, as that package took them; no sweep)."""
    from elephas_tpu_torch.ops import flash_serving as fs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, h, d, c = CHUNK_CASE
    rows = {}
    for span in CHUNK_SPANS:
        q, k, v, pos = _chunk_inputs(b, h, d, c, span, dev, 19)
        rows[f"span{span}"] = _chunk_row(fs, q, k, v, pos, None, sms)
    for span in CHUNK_SPANS:  # a speculative verify window on every slot
        q, k, v, pos = _chunk_inputs(b, h, d, VERIFY_W, span, dev, 23)
        rows[f"verify_span{span}"] = _chunk_row(fs, q, k, v, pos, None, sms)
    slots = ENGINE["num_slots"]
    for name, (b, h, d, c), spans, offset in (
            ("engine_span", CHUNK_ENGINE, SPAN_TIMES, None),
            ("c512_offset", CHUNK_C512, (SPAN_MAXLEN,), 0)):
        for span in spans:
            off = span - c if offset is None else offset
            q, k, v, pos = _chunk_inputs(b, h, d, c, span, dev, 19, slots, off)
            key = f"{name}{span}" if offset is None else f"{name}{offset}"
            rows[key] = _chunk_row(fs, q, k, v, pos, _chunk_slot_map(b, slots, dev), sms)
    emit({"phase": "times", "kernel": "span_chunk", "timing": GRAPH_TIMING, **rows})
    return rows


def _memmap(path, a):
    """``a`` written to an ``.npy`` memmap at ``path``, opened read-only."""
    m = np.lib.format.open_memmap(path, mode="w+", dtype=a.dtype, shape=a.shape)
    m[:] = a
    m.flush()
    del m
    return np.load(path, mmap_mode="r")


def _optimizer_state(model):
    """Every optimizer state tensor of a compiled module, on the host."""
    state = model.training_spec.optimizer.state_dict()["state"]
    return {f"{i}/{k}": v.detach().cpu().clone() for i, st in state.items()
            for k, v in st.items() if torch.is_tensor(v)}


def _fit_state(model):
    """Weights, buffers and optimizer state of a module, on the host."""
    return ({n: t.detach().cpu().clone() for n, t in model.state_dict().items()},
            _optimizer_state(model))


def _bit_equal(a, b):
    """The names of the tensors on which two ``_fit_state``s differ."""
    return [n for part_a, part_b in zip(a, b) for n in part_a
            if not torch.equal(part_a[n], part_b[n])]


def _event_timed_fit(sm, model, data, dev, **kwargs):
    """``sm.fit`` with a CUDA event recorded (no synchronize) at the start
    of every step's forward of the master and one at the end: device-side
    step times, which keep the copy-compute overlap a synchronizing stamp
    would remove. Returns the history, the step times (s) and the wall
    seconds of the whole fit (synchronized at its start and end)."""
    events = []

    def stamp(module, _inputs):
        if module is model:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    hook = model.register_forward_pre_hook(stamp)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        history = sm.fit(data, **kwargs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events.append(end)
        torch.cuda.synchronize(dev)
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    steps = np.array([a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])])
    return history, steps, wall


def _stream_t(dev, x, y, xm, ym, workers, batch, failures, out):
    """S-T at ``workers`` workers: the staged fit from the arrays, then the
    streamed fit from the memmaps, from the same weights: history,
    weights, buffers and Adam state bit for bit, and equal launches.
    Returns the streamed fit's launches."""
    from elephas_tpu_torch import SparkModel, transformer_classifier

    runs = {}
    for name, data, kwargs in (("staged", (x, y), {}),
                               ("streamed", (xm, ym), {"stream_block_steps": STREAM_BLOCK_STEPS})):
        model = transformer_classifier(**TRAIN, seed=0, dtype_policy="mixed_bfloat16", device=dev)
        sm = SparkModel(model, num_workers=workers, device=dev)
        _reset_launches()
        history, step_s = _timed_fit(sm, model, data, STREAM_EPOCHS, batch, dev, **kwargs)
        runs[name] = (history, _launches(), _fit_state(model), step_s)
        del model, sm
    (h1, l1, s1, t1), (h2, l2, s2, t2) = runs["staged"], runs["streamed"]
    differ = _bit_equal(s1, s2)
    key = f"W{workers}"
    out[key] = {"workers": workers, "worker_batch": batch, "history_staged": h1,
                "history_streamed": h2, "history_equal": h1 == h2,
                "state_bit_equal": not differ, "differing_tensors": differ[:5],
                "launches_staged": l1, "launches_streamed": l2,
                "median_step_s_staged": float(np.median(t1[1:])),
                "median_step_s_streamed": float(np.median(t2[1:]))}
    if h1 != h2 or differ or l1 != l2:
        failures.append(f"S-T {key}: streamed differs from staged: {out[key]}")
    return l2


def _stream_r50_round(dev, x, y, batch, streamed):
    """One S-R50 fit of ResNet-50 from seed 0's weights: streamed in blocks
    of STREAM_BLOCK_STEPS steps (copies logged), or staged by raising the
    instance's threshold."""
    from elephas_tpu_torch import SparkModel, resnet50

    model = resnet50(**R50, dtype_policy="mixed_bfloat16", seed=0, device=dev)
    sm = SparkModel(model, device=dev)
    blocks = {"stream_block_steps": STREAM_BLOCK_STEPS} if streamed else {}
    if not streamed:
        sm.STREAM_THRESHOLD_BYTES = 1 << 62
    sm._runner.h2d_log = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    history, step_s, wall = _event_timed_fit(sm, model, (x, y), dev, epochs=R50_EPOCHS,
                                             batch_size=batch, **blocks)
    steps = len(step_s)
    log = sm._runner.h2d_log
    run = {"history": history, "steps": steps, "wall_s": wall,
           "images_s_fit": R50_EPOCHS * len(x) / wall,
           "images_s_after_first": (steps - 1) * batch / float(np.sum(step_s[1:])),
           "median_step_s": float(np.median(step_s[1:])),
           "step_s": step_s.tolist(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "pinned_bytes": sm._runner.pinned_bytes, "blocks_copied": len(log)}
    if log:
        copy_ms = [e["start"].elapsed_time(e["end"]) for e in log]
        run.update(h2d_bytes_per_block=log[0]["bytes"], copy_ms_per_block=copy_ms,
                   copy_gb_s=[e["bytes"] / (ms * 1e6) for e, ms in zip(log, copy_ms)],
                   gather_ms_per_block=[e["gather_ms"] for e in log],
                   gather_threads=sorted({e["gather_thread"] for e in log}),
                   gather_gb_s=[e["bytes"] / (e["gather_ms"] * 1e6) for e in log])
    return run, sm, model


def _stream_r50(dev, card, failures):
    """S-R50 of phase_train_stream: the rounds in turns, the profiled
    streamed epoch and the gates; returns the report."""
    from elephas_tpu_torch import SparkModel, resnet50
    from elephas_tpu_torch.data import streaming

    x, y = _synthetic_images(STREAM_R50_ROWS, R50["input_shape"][0], R50["num_classes"])
    nbytes = streaming.estimate_nbytes(x, y)
    r50 = {"rows": STREAM_R50_ROWS, "batch": R50_BATCH, "epochs": R50_EPOCHS,
           "dataset_bytes": nbytes, "threshold_bytes": SparkModel.STREAM_THRESHOLD_BYTES,
           "order": [], "streamed": [], "staged": []}
    if nbytes <= SparkModel.STREAM_THRESHOLD_BYTES:
        failures.append(f"S-R50's {nbytes} bytes do not cross the threshold")
    # the process's first ResNet-50 steps pay cuDNN's and cuBLAS's set-up:
    # not the first round's to carry
    warm = resnet50(**R50, dtype_policy="mixed_bfloat16", seed=0, device=dev)
    SparkModel(warm, device=dev).fit((x[:R50_BATCH], y[:R50_BATCH]), epochs=1,
                                     batch_size=R50_BATCH)
    del warm
    order = [True, False] * STREAM_R50_ROUNDS
    for i in range(1, len(order), 2):  # streamed, staged, staged, streamed, ...
        if (i // 2) % 2:
            order[i - 1], order[i] = order[i], order[i - 1]
    for streamed in order:
        run, sm, model = _stream_r50_round(dev, x, y, R50_BATCH, streamed)
        r50["order"].append("streamed" if streamed else "staged")
        r50["streamed" if streamed else "staged"].append(run)
        del sm, model
    # one streamed epoch under the profiler, after the rounds' warm-up
    model = resnet50(**R50, dtype_policy="mixed_bfloat16", seed=0, device=dev)
    sm = SparkModel(model, device=dev)
    steps = -(-STREAM_R50_ROWS // R50_BATCH)
    prof = _profile(dev, lambda: sm.fit((x, y), epochs=1, batch_size=R50_BATCH,
                                        stream_block_steps=STREAM_BLOCK_STEPS),
                    "one streamed epoch, S-R50", per=steps,
                    extra={"card": card, "steps": steps})
    if prof.get("device_ms"):
        copies = prof["by_class_ms"].get("memcpy", 0.0)
        r50["profile"] = {"wall_ms_per_step": prof["wall_ms"],
                          "device_ms_per_step": prof["device_ms"],
                          "idle_share": prof["idle_share"],
                          "memcpy_ms_per_step": copies,
                          "idle_share_without_copies":
                              1 - (prof["device_ms"] - copies) / prof["wall_ms"]}
    del sm, model
    first_streamed, first_staged = r50["streamed"][0], r50["staged"][0]
    for run in r50["streamed"] + r50["staged"]:
        if not all(np.all(np.isfinite(v)) for v in run["history"].values()):
            failures.append(f"S-R50: non-finite history {run['history']}")
    for run in r50["streamed"]:
        if run["blocks_copied"] != R50_EPOCHS * -(-STREAM_R50_ROWS // (
                R50_BATCH * STREAM_BLOCK_STEPS)) or set(run.get("gather_threads", [])) \
                != {"block-prefetch"}:
            failures.append(f"S-R50: {run['blocks_copied']} blocks copied, gathered in "
                            f"{run.get('gather_threads')}")
    if any(run["blocks_copied"] for run in r50["staged"]):
        failures.append("S-R50: a staged round streamed")
    loss_rel = float(np.max(np.abs(np.subtract(first_streamed["history"]["loss"],
                                               first_staged["history"]["loss"]))
                            / np.abs(first_staged["history"]["loss"])))
    r50["loss_rel_err_streamed_vs_staged"] = loss_rel
    r50["loss_tol"] = TOL_STREAM_R50
    if loss_rel > TOL_STREAM_R50:
        failures.append(f"S-R50: streamed loss parts from staged by {loss_rel}")
    for metric in ("images_s_after_first", "images_s_fit"):
        med = {k: float(np.median([r[metric] for r in r50[k]])) for k in ("streamed",
                                                                          "staged")}
        r50[f"{metric}_median"] = med
        r50[f"{metric}_streamed_over_staged"] = med["streamed"] / med["staged"]
    return r50


def phase_train_stream(dev):
    """Streaming into the card (SparkModel.fit's out-of-core path).

    S-T: T in mixed_bfloat16 from a memmap of STREAM_T_ROWS
    _synthetic_tokens rows (under build/, removed after), blocks of
    STREAM_BLOCK_STEPS steps, STREAM_EPOCHS epochs: history, weights and
    Adam state bit for bit and launches equal to the staged fit of the same
    rows, at W = 1 (batch TRAIN_BATCH) and W = WORKERS (force_devices,
    WORKER_BATCH rows a worker step); a 1-epoch streamed fit with
    checkpoints resumed to STREAM_EPOCHS by a fresh wrapper bit-equal to
    the uninterrupted streamed fit; validation_split=0.25 over the memmap
    with finite val_loss and val_accuracy each epoch; frequency="fit"
    refused with the reference's message.

    S-R50: ResNet-50 as phase_train_resnet50 trains it, on
    STREAM_R50_ROWS _synthetic_images rows in a float32 ndarray (over
    STREAM_THRESHOLD_BYTES, checked), streamed in blocks of
    STREAM_BLOCK_STEPS steps against the same instance staged by raising
    its STREAM_THRESHOLD_BYTES, STREAM_R50_ROUNDS rounds in turns
    (streamed, staged, staged, streamed, ...), each from seed 0's weights:
    images/s (device step times after the first, CUDA events without
    synchronizing; and the whole fit's wall time, staging and gathers
    included), their ratio, H2D bytes, copy ms and GB/s per block on the
    copy stream, the host gather ms per block in the reader thread, peak
    device memory and pinned host bytes; the loss history of the first
    streamed fit within TOL_STREAM_R50 of the first staged one; and one
    streamed epoch under torch.profiler (device idle share, with and
    without the copies). Returns the launches of the S-T streamed fits."""
    from elephas_tpu_torch import SparkModel, transformer_classifier
    from elephas_tpu_torch.device import force_devices

    card = nvidia_smi()
    failures = []
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_stream")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    launches = {k: 0 for k in _launches()}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    out = {"phase": "train_stream", "card": card, "config": TRAIN,
           "dtype_policy": "mixed_bfloat16", "rows": STREAM_T_ROWS,
           "block_steps": STREAM_BLOCK_STEPS, "epochs": STREAM_EPOCHS}
    previous = None
    try:
        x, y = _synthetic_tokens(STREAM_T_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"],
                                 TRAIN["num_classes"])
        xm = _memmap(os.path.join(scratch, "x.npy"), x)
        ym = _memmap(os.path.join(scratch, "y.npy"), y)
        add(_stream_t(dev, x, y, xm, ym, 1, TRAIN_BATCH, failures, out))
        previous = force_devices(WORKERS)
        add(_stream_t(dev, x, y, xm, ym, WORKERS, WORKER_BATCH, failures, out))
        force_devices(previous)
        previous = None

        def streamed_fit(epochs, **kwargs):
            model = transformer_classifier(**TRAIN, seed=0, dtype_policy="mixed_bfloat16",
                                           device=dev)
            history = SparkModel(model, device=dev).fit(
                (xm, ym), epochs=epochs, batch_size=TRAIN_BATCH,
                stream_block_steps=STREAM_BLOCK_STEPS, **kwargs)
            return model, history

        whole, _ = streamed_fit(STREAM_EPOCHS)
        want = _fit_state(whole)
        del whole
        ckpt = os.path.join(scratch, "ckpt")
        streamed_fit(1, checkpoint_dir=ckpt)
        resumed, history = streamed_fit(STREAM_EPOCHS, checkpoint_dir=ckpt, resume=True)
        differ = _bit_equal(want, _fit_state(resumed))
        out["resume"] = {"epochs_run": len(history["loss"]), "bit_equal": not differ,
                         "differing_tensors": differ[:5]}
        if differ or len(history["loss"]) != STREAM_EPOCHS - 1:
            failures.append(f"S-T resume: {out['resume']}")
        del resumed, want
        _, history = streamed_fit(STREAM_EPOCHS, validation_split=0.25)
        out["validation"] = {"split": 0.25, "history": history}
        if any(len(history.get(k, [])) != STREAM_EPOCHS or not np.all(np.isfinite(history[k]))
               for k in ("val_loss", "val_accuracy")):
            failures.append(f"S-T validation history {history}")
        model = transformer_classifier(**TRAIN, seed=0, dtype_policy="mixed_bfloat16",
                                       device=dev)
        try:
            SparkModel(model, frequency="fit", device=dev).fit(
                (xm, ym), epochs=1, batch_size=TRAIN_BATCH)
            failures.append("frequency='fit' streamed instead of refusing")
        except ValueError as err:
            out["frequency_fit_refused"] = str(err)
        del model

        out["S-R50"] = _stream_r50(dev, card, failures)
    finally:
        if previous is not None:
            force_devices(previous)
        shutil.rmtree(scratch, ignore_errors=True)
    out["launches_streamed"] = launches
    out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError(f"train_stream check failed: {failures}")
    return launches


def _pipeline_json(features, hidden, classes):
    """examples/ml_pipeline.py's model as ``keras.Sequential.to_json()``
    writes it: Input(features) → Dense(hidden, relu) → Dense(classes,
    softmax)."""
    policy = {"module": "keras", "class_name": "DTypePolicy", "config": {"name": "float32"},
              "registered_name": None}

    def dense(name, units, activation):
        return {"module": "keras.layers", "class_name": "Dense", "config": {
            "name": name, "trainable": True, "dtype": policy, "units": units,
            "activation": activation, "use_bias": True, "kernel_regularizer": None,
            "bias_regularizer": None, "kernel_constraint": None, "bias_constraint": None}}

    return json.dumps({"module": "keras", "class_name": "Sequential", "config": {
        "name": "sequential", "trainable": True, "dtype": policy, "layers": [
            {"module": "keras.layers", "class_name": "InputLayer",
             "config": {"batch_shape": [None, features], "dtype": "float32",
                        "name": "input_layer"}},
            dense("dense", hidden, "relu"), dense("dense_1", classes, "softmax")]}})


def phase_ml_pipeline(dev):
    """examples/ml_pipeline.py's configuration through the port on the card:
    its synthetic tabular data (PIPELINE rows and features, seed 0) in a
    DataFrame, randomSplit([0.8, 0.2], seed=1), Pipeline(ElephasEstimator)
    of Dense(hidden, relu) → Dense(2, softmax), Adam(lr) from its
    serialized config, categorical cross-entropy, batch and epochs as
    there; the test accuracy of the fitted PipelineModel's prediction
    column against the example's bar."""
    from elephas_tpu_torch import ElephasEstimator
    from elephas_tpu_torch.data.dataframe import SparkSession
    from elephas_tpu_torch.ml import Pipeline

    n, d = PIPELINE["rows"], PIPELINE["features"]
    rng = np.random.default_rng(0)
    w = rng.normal(size=d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ w + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    df = SparkSession().createDataFrame([(row, float(label)) for row, label in zip(x, y)],
                                        schema=["features", "label"])
    train_df, test_df = df.randomSplit([0.8, 0.2], seed=1)
    estimator = ElephasEstimator(
        keras_model_config=_pipeline_json(d, PIPELINE["hidden"], 2),
        optimizer_config={"class_name": "Adam", "config": {"learning_rate": PIPELINE["lr"]}},
        loss="categorical_crossentropy", metrics=["accuracy"], categorical_labels=True,
        nb_classes=2, epochs=PIPELINE["epochs"], batch_size=PIPELINE["batch"],
        mode="synchronous", predict_classes=True, device=dev)
    t0 = time.perf_counter()
    fitted = Pipeline(stages=[estimator]).fit(train_df)
    fit_s = time.perf_counter() - t0
    rows = fitted.transform(test_df).collect()
    accuracy = float(np.mean([r.prediction == r.label for r in rows]))
    out = {"phase": "ml_pipeline", "card": nvidia_smi(), "config": PIPELINE,
           "train_rows": train_df.count(), "test_rows": len(rows), "fit_s": fit_s,
           "test_accuracy": accuracy, "bar": PIPELINE_BAR}
    emit(out)
    if not accuracy > PIPELINE_BAR:
        raise AssertionError(f"ml_pipeline accuracy {accuracy} <= {PIPELINE_BAR}")


def _synthetic_mnist(n, seed=0):
    """examples/_datasets.py's synthetic_mnist: (n, 784) float32 in [0, 1],
    10 classes, per-class blob templates."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0.0, 1.0, size=(10, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    x = templates[y] + rng.normal(0, 0.35, size=(n, 784)).astype(np.float32)
    return np.clip(x, 0.0, 1.0), y


def phase_hyperparam(dev):
    """examples/hyperparam_optimization.py's search through the port on the
    card: its synthetic MNIST (HYPER rows, the last fifth held out), a
    builder of Dense(units, relu) → Dropout(dropout) → Dense(10, softmax)
    compiled with Adam(lr), sparse categorical cross-entropy and accuracy,
    its search space, evals, epochs, batch and seed. Run once at the card's
    one worker (the example's adaptive strategy) and once at
    force_devices(HYPER_SLOTS) with devices_per_trial=HYPER_PER_TRIAL
    (strategy "random"). Gates: every trial's loss finite; best_trial() the
    least loss; the returned module, evaluated again, gives that loss bit
    for bit; the random run's params the numpy sampler's for the seed."""
    from torch import nn
    from torch.nn import functional as F

    from elephas_tpu_torch import HyperParamModel
    from elephas_tpu_torch import hyperparam as hp
    from elephas_tpu_torch.device import force_devices
    from elephas_tpu_torch.models.layers import Dense, Dropout
    from elephas_tpu_torch.optimizers import Adam
    from elephas_tpu_torch.training import compile_model
    from elephas_tpu_torch.worker import Runner

    class Net(nn.Module):
        def __init__(self, units, rate):
            super().__init__()
            self.dense = Dense(784, units)
            self.drop = Dropout(rate, HYPER["seed"])
            self.dense_1 = Dense(units, 10)

        def forward(self, x):
            return torch.softmax(self.dense_1(self.drop(F.relu(self.dense(x)))), dim=-1)

    def build(params):
        model = Net(int(params["units"]), params["dropout"]).to(dev)
        return compile_model(model, Adam(model.parameters(), lr=params["lr"]),
                             "sparse_categorical_crossentropy", ["accuracy"])

    def space():
        return {"units": hp.quniform(32, 128, 32), "dropout": hp.choice([0.0, 0.2, 0.5]),
                "lr": hp.loguniform(1e-4, 1e-2)}

    x, y = _synthetic_mnist(HYPER["rows"])
    n_test = int(len(x) * 0.2)
    data = (x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:])
    torch.manual_seed(HYPER["seed"])
    runs, failures = [], []
    for slots, per_trial, strategy in ((None, 1, "adaptive"),
                                       (HYPER_SLOTS, HYPER_PER_TRIAL, "random")):
        previous = force_devices(slots)
        try:
            search = HyperParamModel(seed=HYPER["seed"], device=dev)
            t0 = time.perf_counter()
            best = search.minimize(build, data, max_evals=HYPER["max_evals"],
                                   search_space=space(), epochs=HYPER["epochs"],
                                   batch_size=HYPER["batch"], strategy=strategy,
                                   devices_per_trial=per_trial)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
        finally:
            force_devices(previous)
        losses = [t.loss for t in search.trials]
        again = Runner(best, "synchronous", "epoch").evaluate([(data[2], data[3])],
                                                              HYPER["batch"])["loss"]
        run = {"workers": search.num_workers, "devices_per_trial": per_trial,
               "strategy": strategy, "seconds": seconds,
               "seconds_a_trial": seconds / HYPER["max_evals"], "losses": losses,
               "best_params": search.best_model_params(), "best_loss": search.best_trial().loss,
               "best_accuracy": search.best_trial().metrics.get("accuracy"),
               "evaluated_again": again}
        if not all(np.isfinite(losses)) or len(losses) != HYPER["max_evals"]:
            failures.append(f"{strategy}: trial losses {losses}")
        if search.best_trial().loss != min(losses):
            failures.append(f"{strategy}: best trial {search.best_trial().loss} is not the "
                            f"least loss {min(losses)}")
        if again != search.best_trial().loss:
            failures.append(f"{strategy}: the returned module evaluates to {again}, its "
                            f"trial to {search.best_trial().loss}")
        if strategy == "random":
            rng = np.random.default_rng(HYPER["seed"] * 1009)
            want = [hp.sample_space(space(), rng) for _ in range(HYPER["max_evals"])]
            run["params_equal_numpy_sampler"] = [t.params for t in search.trials] == want
            if not run["params_equal_numpy_sampler"]:
                failures.append(f"random params {[t.params for t in search.trials]} are not "
                                f"the numpy sampler's {want}")
        runs.append(run)
    emit({"phase": "hyperparam", "config": HYPER, "runs": runs, "nvidia_smi": nvidia_smi(),
          "failures": failures})
    if failures:
        raise AssertionError(f"hyperparam check failed: {failures}")


# -- the paged arena ------------------------------------------------------------------

def _paged_pool(b, h, d, bs, t, kv_dtype, dev, seed):
    """A pool of ``b·t + 7`` blocks and the sink, its rows random (their
    codes and scales when quantized), and ``[b, t]`` tables of shuffled
    block ids, the last two rows' second halves sentinel-padded. Returns
    ``(pool_k, pool_v, kv_scales, tables)``."""
    from elephas_tpu_torch.serving.kv_quant import quantize_rows

    g = torch.Generator(device=dev).manual_seed(seed)
    n = b * t + 7
    ids = torch.randperm(n, generator=torch.Generator().manual_seed(seed))[: b * t]
    tables = ids.view(b, t).to(torch.int32)
    tables[-2:, t // 2:] = n
    rows = torch.randn(2, n + 1, bs, h, d, generator=g, device=dev)
    if kv_dtype == "fp":
        return rows[0].contiguous(), rows[1].contiguous(), None, tables.to(dev)
    (kq, ks), (vq, vs) = (quantize_rows(r, kv_dtype) for r in rows)
    return kq, vq, (ks, vs), tables.to(dev)


def _paged_decode_inputs(kv_dtype, span, dev, seed, bs=PAGED_CASE[3]):
    """The engine's decode shape over a paged pool of blocks of ``bs``: q,
    the pool, tables of span / bs blocks, and int32 positions: 0 on lane 0,
    the span's last row on lane 1, stale cursors past the span (inactive
    lanes) on lanes 2 and 3, the rest ragged."""
    b, h, d, _ = PAGED_CASE
    pk, pv, scales, tables = _paged_pool(b, h, d, bs, span // bs, kv_dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn(b, h, d, generator=g, device=dev)
    pos = torch.randint(0, span, (b,), generator=g, device=dev, dtype=torch.int32)
    pos[:4] = torch.tensor([0, span - 1, span + 7, 3 * span], dtype=torch.int32)
    return q, pk, pv, scales, tables, pos


def _paged_chunk_inputs(kv_dtype, rows, c, span, dev, seed, offset=None, bs=PAGED_CASE[3]):
    """Chunk queries ``[rows, H, c, D]`` over a paged pool of blocks of
    ``bs`` with tables of span / bs blocks at int32 positions ``offset +
    0..c-1`` (every row), or ragged: 0 on row 0, ending on the span's last
    row on row 1, rows past the span on row 2."""
    _, h, d, _ = PAGED_CASE
    pk, pv, scales, tables = _paged_pool(rows, h, d, bs, span // bs, kv_dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn(rows, h, c, d, generator=g, device=dev)
    offs = torch.randint(0, max(1, span - c), (rows,), generator=g, device=dev)
    if offset is None:
        special = torch.tensor([0, max(0, span - c), span - c // 2])[:rows]
        offs[:len(special)] = special
    else:
        offs[:] = offset
    pos = (offs[:, None] + torch.arange(c, device=dev)[None, :]).to(torch.int32).contiguous()
    return q, pk, pv, scales, tables, pos


def _paged_cases():
    """(kernel, case name, inputs function) of every gated paged shape."""
    cases = []
    for dt in PAGED_DTYPES:
        for span in PAGED_SPANS:
            for bs in PAGED_DECODE_BLOCKS:
                block = "" if bs == PAGED_CASE[3] else f"block{bs}_"
                cases.append(("paged_span_decode", f"{dt}_{block}span{span}", dt,
                              lambda dev, dt=dt, span=span, bs=bs:
                              _paged_decode_inputs(dt, span, dev, span, bs)))
            for rows, c in PAGED_CHUNKS:
                off = span - c if rows == 1 else None
                cases.append(("paged_span_chunk", f"{dt}_B{rows}_C{c}_span{span}", dt,
                              lambda dev, dt=dt, rows=rows, c=c, span=span, off=off:
                              _paged_chunk_inputs(dt, rows, c, span, dev, span + c, off)))
            rows, c, bs = PAGED_CHUNK_BLOCK1
            cases.append(("paged_span_chunk", f"{dt}_block{bs}_B{rows}_C{c}_span{span}", dt,
                          lambda dev, dt=dt, rows=rows, c=c, span=span, bs=bs:
                          _paged_chunk_inputs(dt, rows, c, span, dev, span + bs, span - c, bs)))
        span = PAGED_OVER_CLUSTER
        cases.append(("paged_span_chunk", f"{dt}_B1_C64_span{span}", dt,
                      lambda dev, dt=dt, span=span:
                      _paged_chunk_inputs(dt, 1, 64, span, dev, 9, span - 64)))
        rows, c = PAGED_C512
        cases.append(("paged_span_chunk", f"{dt}_C{c}_offset0", dt,
                      lambda dev, dt=dt, rows=rows, c=c:
                      _paged_chunk_inputs(dt, rows, c, SPAN_MAXLEN, dev, 5, 0)))
    return cases


def _kernel_paged(dev):
    """Each paged kernel, every stored type, at every _paged_cases shape:
    within TOL_SPAN of max(1, |out|) of its plain version; bit-equal to the
    arena kernel over the gathered, dequantized span (the same split and
    order: only the addressing differs); bit-equal on a second call and on
    a CUDA-graph replay; the paged chunk launching its merge kernel only
    past fs.CHUNK_CLUSTER_MAX splits (up to it, the splits merge in a
    thread-block cluster)."""
    from elephas_tpu_torch.ops import flash_serving as fs

    results, failures = [], []
    for kernel, name, dt, inputs in _paged_cases():
        q, pk, pv, scales, tables, pos = inputs(dev)
        decode = kernel == "paged_span_decode"
        fn = fs.flash_paged_span_decode if decode else fs.flash_paged_span_chunk
        plain = fs.paged_span_decode_reference if decode else fs.paged_span_chunk_reference
        arena_fn = fs.flash_span_decode if decode else fs.flash_span_chunk
        kw = dict(kv_dtype=dt, kv_scales=scales)
        merges = fs.paged_chunk_merge_launches()
        out = fn(q, pk, pv, tables, pos, **kw)
        merges = fs.paged_chunk_merge_launches() - merges
        again = fn(q, pk, pv, tables, pos, **kw)
        replayed = _graph_replay(lambda: fn(q, pk, pv, tables, pos, **kw))  # noqa: B023
        ref = plain(q, pk, pv, tables, pos, **kw)
        gk, gv = fs.paged_dense_span(pk, pv, tables, dt, scales, q.shape[-1])
        arena = arena_fn(q, gk.contiguous(), gv.contiguous(), pos)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = (diff / ref.abs().clamp_min(1.0)).max().item()
        span = gk.shape[1]
        row = {"kernel": kernel, "case": name, "shape": list(q.shape), "span": span,
               "rel_err": err, "abs_err": diff.max().item(),
               "arena_kernel_bit_equal": torch.equal(out, arena),
               "repeats_bit_for_bit": torch.equal(out, again) and torch.equal(out, replayed)}
        merges_ok = True
        if not decode:
            b, h, c, d = q.shape
            splits = fs.span_chunk_splits(span, b * h, c, d, fs._sm_count(q.device.index))[0]
            row.update(splits=splits, merge_launches=merges)
            merges_ok = merges == int(splits > fs.CHUNK_CLUSTER_MAX)
        row["ok"] = err <= TOL_SPAN and row["arena_kernel_bit_equal"] and merges_ok \
            and row["repeats_bit_for_bit"] and bool(torch.isfinite(out).all())
        results.append(row)
        if not row["ok"]:
            failures.append(row)
        del q, pk, pv, scales, tables, pos, gk, gv
    return results, failures


def _quant_logits(model, seq, kv_dtype, dev):
    """Teacher-forced logits of ``seq`` on a scratch paged pool of
    ``kv_dtype`` through the naive attention (written first, then attended:
    position i sees the quantized rows 0..i, as decode does): the oracle a
    quantized engine's near ties are read against. ``[len(seq), vocab]``."""
    from elephas_tpu_torch.models.transformer import validate_token_decode_model
    from elephas_tpu_torch.serving.paged_kv import PagedKVPool, blocks_for, paged_chunk_forward

    bs = ENGINE_PAGED["block_size"]
    n = len(seq)
    nb = blocks_for(n, bs)
    pool = PagedKVPool(validate_token_decode_model(model), nb, bs, dev, kv_dtype)
    table = torch.arange(nb, dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        return paged_chunk_forward(
            model, torch.tensor([list(seq)], device=dev), pool, table,
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.full((1,), n, dtype=torch.int32, device=dev), attention="naive")[0]


def _tokens_agree(reqs, want_reqs, logits_of_seq):
    """Indices of requests whose tokens differ from ``want_reqs``' where the
    oracle's top-2 margin (``logits_of_seq(prefix)[-1]``) is >= MARGIN, and
    of those that differ at all."""
    faults, differ = [], []
    for i, (r, w) in enumerate(zip(reqs, want_reqs)):
        if r.tokens == w.tokens:
            continue
        differ.append(i)
        bad = _first_divergence(
            r.tokens, w.tokens,
            lambda j, w=w: logits_of_seq(list(w.prompt) + w.tokens[:j])[-1])
        if bad:
            faults.append(f"request {i}: {bad}")
    return faults, differ


def _paged_launch_faults(what, launches, layers):
    """The paged path's launches: both paged kernels, LayerNorm (2·layers+1)
    a forward (a forward = layers paged launches), and no arena kernel or
    flash forward."""
    faults = []
    idle = [k for k in ("paged_span_decode", "paged_span_chunk", "layer_norm_fwd")
            if not launches[k] > 0]
    if idle:
        faults.append(f"{what} never launched {idle}")
    forwards = (launches["paged_span_decode"] + launches["paged_span_chunk"]) / layers
    if launches["layer_norm_fwd"] != (2 * layers + 1) * forwards or any(
            launches[k] for k in ("flash_fwd", "span_decode", "span_chunk", "layer_norm_bwd")):
        faults.append(f"{what}: launches {launches} are not the paged path's over "
                      f"{layers} layers")
    return faults


def _median_row(rows):
    """Medians over rounds of _serve_pass rows."""
    out = {"rounds": rows}
    for key in ("seconds", "tokens_s"):
        out[key] = float(np.median([r[key] for r in rows]))
    for key in ("ttft_s", "inter_token_s"):
        out[key] = {q: float(np.median([r[key][q] for r in rows])) for q in ("p50", "p99")}
    return out


def _peak_concurrency(engine, workload):
    """Peak requests in flight over a drive of ``workload`` (the reference
    bench's admitted-concurrency measure), and the requests."""
    reqs = [engine.submit(p, mn) for p, mn in workload]
    peak = 0
    while engine.scheduler.has_work:
        engine.step()
        peak = max(peak, len(engine.scheduler.active))
    return peak, reqs


def _longctx(model):
    """bench.py:643-700's equal-bytes construction: 4 fixed slots against a
    paged pool of the same 4 · maxlen rows in blocks of 16 over 16 lanes, on
    its mixed workload (32 prompts of maxlen / 5 tokens and 2 of 0.6 ·
    maxlen, 6 new tokens each). Peak admitted concurrency of both."""
    from elephas_tpu_torch import InferenceEngine

    maxlen, vocab, fixed_slots, bs = model.maxlen, model.vocab_size, 4, 16
    rng = np.random.default_rng(17)
    pool_rows = fixed_slots * maxlen
    lanes = fixed_slots * 4
    short_p, long_p = max(4, maxlen // 5), min(int(maxlen * 0.6), maxlen - 6)
    mixed = [(rng.integers(1, vocab, size=short_p).astype(np.int32), 6)
             for _ in range(lanes * 2)] + \
        [(rng.integers(1, vocab, size=long_p).astype(np.int32), 6) for _ in range(2)]
    engines = {"fixed": InferenceEngine(model, num_slots=fixed_slots),
               "paged": InferenceEngine(model, num_slots=lanes, paged=True, block_size=bs,
                                        num_blocks=pool_rows // bs)}
    peaks = {name: _peak_concurrency(e, mixed)[0] for name, e in engines.items()}
    return {"kv_rows_fixed": pool_rows, "kv_rows_paged": engines["paged"].num_blocks * bs,
            "arena_bytes_fixed": engines["fixed"].arena.nbytes(),
            "pool_bytes_paged": engines["paged"].arena.nbytes(), "lanes": lanes,
            "mixed_requests": len(mixed), "short_prompt": short_p, "long_prompt": long_p,
            "admitted_concurrency_fixed": peaks["fixed"],
            "admitted_concurrency_paged": peaks["paged"],
            "concurrency_ratio": peaks["paged"] / max(1, peaks["fixed"])}


def _preemption(model, dev, kv_dtype="fp"):
    """PREEMPT_ENGINE at config A: the low-priority request decodes three
    steps, the priority-1 arrival cannot fit beside it and preempts it; both
    requests' tokens against their runs alone in a fresh engine of the same
    options (no preemption there), and the pool whole at the end."""
    from elephas_tpu_torch import InferenceEngine

    rng = np.random.default_rng(5)
    vocab = model.vocab_size
    low_p = rng.integers(1, vocab, size=PREEMPT_LOW).astype(np.int32)
    high_p = rng.integers(1, vocab, size=PREEMPT_HIGH).astype(np.int32)
    opts = dict(PREEMPT_ENGINE, kv_dtype=kv_dtype)
    alone = []
    for prompt in (low_p, high_p):
        solo = InferenceEngine(model, **opts)
        alone.append(solo.submit(prompt, PREEMPT_BUDGET))
        solo.run()
    engine = InferenceEngine(model, **opts)
    low = engine.submit(low_p, PREEMPT_BUDGET)
    for _ in range(3):
        engine.step()
    high = engine.submit(high_p, PREEMPT_BUDGET, priority=1)
    while engine.scheduler.has_work:
        engine.step()
    st = engine.stats()
    out = {"kv_dtype": kv_dtype, "options": opts, "prompts": [PREEMPT_LOW, PREEMPT_HIGH],
           "budget": PREEMPT_BUDGET, "preemptions": st["preemptions"], "resumes": st["resumes"],
           "offloaded_blocks": st["offloaded_blocks"],
           "kv_quant_offload_bytes": st["kv_quant_offload_bytes"],
           "blocks_free": st["blocks_free"], "blocks_total": st["blocks_total"],
           "victim_identical": low.tokens == alone[0].tokens,
           "preemptor_identical": high.tokens == alone[1].tokens}
    faults = []
    if not (st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
            and st["blocks_free"] == st["blocks_total"]):
        faults.append(f"preemption ({kv_dtype}): {out}")
    return out, faults, ([low, high], alone)


def _profile_paged_window(dev, model, kv_dtype):
    """One decode window of the paged engine (E's options on ENGINE_PAGED's
    pool, ``kv_dtype``; 16 busy slots on E's first prompts) under
    torch.profiler after a warm-up window, per step: device time by kernel
    class, with the paged span decode's share and the top kernels, where
    the pool writes (``index_put``, the quantizer's elementwise passes)
    show."""
    from elephas_tpu_torch import InferenceEngine

    steps = ENGINE["steps_per_sync"]
    engine = InferenceEngine(model, **ENGINE, **ENGINE_PAGED, kv_dtype=kv_dtype)
    for prompt, _ in _engine_workload(model.vocab_size, ENGINE["num_slots"]):
        engine.submit(prompt, 4 * steps)  # busy through the windows below
    engine.step()  # prefill and the warm-up window
    out = _profile(dev, engine.step, f"paged engine decode window at config A, kv_dtype "
                   f"{kv_dtype}, {ENGINE['num_slots']} slots (E's prompts), per step of {steps}",
                   per=steps)
    by_class = out.get("by_class_ms", {})
    if out["device_ms"] > 0:
        emit({"phase": "profile", "what": f"paged span decode share ({kv_dtype})",
              "paged_span_decode_share_of_device":
                  (by_class.get("paged_span_decode", 0.0)
                   + by_class.get("span_decode_merge", 0.0)) / out["device_ms"]})
        if not by_class.get("paged_span_decode", 0.0) > 0:
            raise AssertionError("the paged engine profile shows no paged_span_decode_kernel")
    if len(engine.scheduler.active) != ENGINE["num_slots"]:
        raise AssertionError("a request of the profiled paged window finished early")
    return out


# the paged chunk's launches in engine_paged and engine_quant by (B, C,
# table span), and a device copy of the positions of each shape's first
ENGINE_CHUNK_SHAPES = Counter()
ENGINE_CHUNK_POSITIONS = {}


@contextlib.contextmanager
def _recording_chunk_shapes():
    """While the block runs, count the model's paged chunk launches by (B,
    C, table span) into ENGINE_CHUNK_SHAPES (models.transformer calls
    flash_paged_span_chunk by its module name)."""
    from elephas_tpu_torch.models import transformer

    fn = transformer.flash_paged_span_chunk

    def recorded(q, pool_k, pool_v, tables, pos, *args, **kwargs):
        key = (q.shape[0], q.shape[2], tables.shape[1] * pool_k.shape[1])
        ENGINE_CHUNK_SHAPES[key] += 1
        ENGINE_CHUNK_POSITIONS.setdefault(key, pos.clone())
        return fn(q, pool_k, pool_v, tables, pos, *args, **kwargs)

    transformer.flash_paged_span_chunk = recorded
    try:
        yield
    finally:
        transformer.flash_paged_span_chunk = fn


def phase_engine_chunk_shapes(merges_before):
    """The shapes the paged engines launched the paged chunk at, most
    frequent first, and the merge-kernel launches since ``merges_before``
    (none where the package merges up to 8 splits in a cluster: every span
    of config A)."""
    from elephas_tpu_torch.ops import flash_serving as fs

    counter = getattr(fs, "paged_chunk_merge_launches", None)
    merges = None if counter is None else counter() - merges_before
    emit({"phase": "engine_chunk_shapes",
          "shapes": [{"B": b, "C": c, "span": span, "launches": n}
                     for (b, c, span), n in ENGINE_CHUNK_SHAPES.most_common()],
          "merge_launches": merges})
    if merges:
        raise AssertionError(f"the paged engines launched the chunk's merge kernel {merges} "
                             f"times at config A's spans")


def _engine_merges():
    from elephas_tpu_torch.ops import flash_serving as fs

    counter = getattr(fs, "paged_chunk_merge_launches", None)
    return 0 if counter is None else counter()


def phase_engine_paged(dev, model):
    """E's engine on the paged arena (ENGINE_PAGED) beside the fixed arena,
    PAGED_ROUNDS passes of E's workload each, in turns (fixed, paged, ...),
    after a warm-up pass each: tokens/s, TTFT and ITL, the paged pass's
    launches (the paged span chunk for every prefill, the paged span decode
    for every decode step, K3 at every norm; no flash forward, no arena
    kernel). Gates: every paged request's tokens equal the fixed engine's
    and the plain argmax wherever the plain top-2 margin is >= MARGIN
    (check (a)). Then E-chunked's prefix workload on paged=True with
    CHUNKED's options (shared blocks and hits, tokens as the fixed engine
    without options), a preemption scenario at config A (_preemption), and
    bench.py:643-700's equal-bytes concurrency (>= 1.5x). Returns the
    launches of the paged passes."""
    from elephas_tpu_torch import InferenceEngine

    layers = CONFIGS["A"]["num_layers"]
    workload = _engine_workload(model.vocab_size, ENGINE_REQUESTS)
    engines = {"fixed": InferenceEngine(model, **ENGINE),
               "paged": InferenceEngine(model, **ENGINE, **ENGINE_PAGED)}
    for e in engines.values():
        e.run(workload[: ENGINE["num_slots"]])
    rows, reqs = {name: [] for name in engines}, {}
    launches = dict.fromkeys(_launches(), 0)
    for _ in range(PAGED_ROUNDS):
        for name, e in engines.items():
            before = _launches()
            rq, row = _serve_pass(e, workload, dev)
            if name == "paged":
                now = _launches()
                launches = {k: launches[k] + now[k] - before[k] for k in launches}
            rows[name].append(row)
            reqs.setdefault(name, rq)
    failures = _paged_launch_faults("the paged engine path", launches, layers)
    mismatches, close, check_failures, plain = _check_emitted(model, reqs["paged"], dev)
    failures += check_failures
    differ = []
    for i, (r, f) in enumerate(zip(reqs["paged"], reqs["fixed"])):
        p = len(r.prompt)
        bad = _first_divergence(r.tokens, f.tokens, lambda j, i=i, p=p: plain[i, p - 1 + j])
        if r.tokens != f.tokens:
            differ.append(i)
        if bad:
            failures.append(f"request {i} against the fixed engine: {bad}")
    summary = {name: _median_row(r) for name, r in rows.items()}

    # E-chunked's prefix workload on the paged arena, against the fixed
    # engine without the options
    warm, chunked_load = _chunked_workload(model.vocab_size)
    plain_engine = InferenceEngine(model, **ENGINE)
    chunked = InferenceEngine(model, **ENGINE, **ENGINE_PAGED, **CHUNKED)
    for requests in warm:
        plain_engine.run(requests)
        chunked.run(requests)
    plain_reqs, plain_row = _serve_pass(plain_engine, chunked_load, dev)
    before = _launches()
    st0 = chunked.stats()
    c_reqs, c_row = _serve_pass(chunked, chunked_load, dev)
    now = _launches()
    c_launches = {k: now[k] - before[k] for k in now}
    launches = {k: launches[k] + c_launches[k] for k in launches}
    st = chunked.stats()
    hits = st["prefix_cache"]["hits"] - st0["prefix_cache"]["hits"]
    shared = st["prefix_blocks_shared"] - st0["prefix_blocks_shared"]
    if not (hits > 0 and shared > 0):
        failures.append(f"paged prefix workload: {hits} hits, {shared} shared blocks")
    failures += _paged_launch_faults("the paged prefix path", c_launches, layers)
    c_mis, c_close, c_fail, c_plain = _check_emitted(model, c_reqs, dev)
    failures += c_fail
    c_differ = []
    for i, (r, pr) in enumerate(zip(c_reqs, plain_reqs)):
        p = len(r.prompt)
        bad = _first_divergence(r.tokens, pr.tokens, lambda j, i=i, p=p: c_plain[i, p - 1 + j])
        if r.tokens != pr.tokens:
            c_differ.append(i)
        if bad:
            failures.append(f"prefix request {i} against the engine without options: {bad}")
    del c_plain

    before = _launches()
    preempt, faults, (got, alone) = _preemption(model, dev)
    now = _launches()
    launches = {k: launches[k] + now[k] - before[k] for k in launches}
    failures += faults
    logits = {}

    def plain_logits(seq):
        key = tuple(seq)
        if key not in logits:
            with torch.inference_mode():
                logits[key] = model(torch.tensor([list(seq)], device=dev), plain=True)[0]
        return logits[key]

    p_faults, p_differ = _tokens_agree(got, alone, plain_logits)
    failures += [f"preemption: {f}" for f in p_faults]
    _profile_paged_window(dev, model, "fp")
    longctx = _longctx(model)
    if not longctx["concurrency_ratio"] >= 1.5:
        failures.append(f"equal-bytes concurrency {longctx}")
    emit({"phase": "engine_paged", "config": CONFIGS["A"], "options": {**ENGINE, **ENGINE_PAGED},
          "requests": len(workload), "rounds_in_turns": PAGED_ROUNDS,
          "fixed": summary["fixed"], "paged": summary["paged"],
          "paged_over_fixed_tokens_s": summary["paged"]["tokens_s"]
          / summary["fixed"]["tokens_s"],
          "pool_bytes": engines["paged"].arena.nbytes(),
          "arena_bytes": engines["fixed"].arena.nbytes(),
          "launches": launches, "a_token_mismatches": mismatches, "a_within_margin": close,
          "requests_differing_from_fixed": differ,
          "prefix_workload": {"options": {**ENGINE, **ENGINE_PAGED, **CHUNKED},
                              "paged": c_row, "fixed_without_options": plain_row,
                              "prefix_hits": hits, "prefix_blocks_shared": shared,
                              "launches": c_launches, "a_token_mismatches": c_mis,
                              "a_within_margin": c_close, "requests_differing": c_differ},
          "preemption": {**preempt, "requests_differing_from_alone": p_differ},
          "longctx": longctx, "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"paged engine check failed: {failures}")
    return launches


def _train_quant_standin(dev):
    """The reference bench's agreement stand-in (bench.py:860-880): d128L4
    trained 4 epochs at batch 32 on 256 periodic sequences (rng 19), here
    through the port's SparkModel on QUANT_WORKERS worker slots of the
    card. Returns the model and the final loss."""
    from elephas_tpu_torch import SparkModel, transformer_lm
    from elephas_tpu_torch.device import force_devices

    maxlen = QUANT_MODEL["maxlen"]
    model = transformer_lm(**QUANT_MODEL, device=dev)
    rng = np.random.default_rng(19)
    starts = rng.integers(2, 6, size=256)
    seq = (starts[:, None] + np.arange(maxlen + 1)) % 4 + 2
    x, y = seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)
    prev = force_devices(QUANT_WORKERS)
    try:
        hist = SparkModel(model, num_workers=QUANT_WORKERS, device=dev).fit(
            (x, y), epochs=QUANT_EPOCHS, batch_size=QUANT_BATCH)
    finally:
        force_devices(prev)
    return model, rng, float(hist["loss"][-1])


def phase_engine_quant(dev, model):
    """int8 and int4 engines on config A (E's options on ENGINE_PAGED's
    pool): E's workload through the flash and the naive attention of each
    (tokens equal wherever the quantized oracle's top-2 margin is >=
    MARGIN, _quant_logits), with tokens/s; one prompt's stored layer-0 codes
    and scales, read back from the card, bit-equal to quantize_rows_np of
    the fp engine's rows (layer 0 only: deeper layers' inputs already carry
    the quantized attention); the int8 preemption scenario (_preemption)
    identical to the runs alone; peak admitted concurrency at equal pool
    bytes (bench.py:825-900's construction: 32 lanes, the fp pool 16
    blocks, the quantized pools its bytes rounded down) >= 2x for int8; and
    score()-based token agreement against the fp engine's greedy
    completions on the trained stand-in (_train_quant_standin) >= 0.95 for
    int8, int4 reported. Returns the launches of the quantized passes."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.serving.kv_quant import pool_bytes_per_pos, quantize_rows_np

    layers = CONFIGS["A"]["num_layers"]
    workload = _engine_workload(model.vocab_size, ENGINE_REQUESTS)
    failures, passes = [], {}
    launches = dict.fromkeys(_launches(), 0)
    for dt in ("int8", "int4"):
        got = {}
        for attention in ("flash", "naive"):
            engine = InferenceEngine(model, **ENGINE, **ENGINE_PAGED, kv_dtype=dt,
                                     attention=attention)
            engine.run(workload[: ENGINE["num_slots"]])
            before = _launches()
            got[attention], row = _serve_pass(engine, workload, dev)
            now = _launches()
            if attention == "flash":
                delta = {k: now[k] - before[k] for k in now}
                failures += _paged_launch_faults(f"the {dt} engine path", delta, layers)
                launches = {k: launches[k] + delta[k] for k in launches}
            passes[f"{dt}_{attention}"] = row
        cache = {}

        def oracle(seq, dt=dt, cache=cache):
            key = tuple(seq)
            if key not in cache:
                cache[key] = _quant_logits(model, seq, dt, dev)
            return cache[key]

        faults, differ = _tokens_agree(got["flash"], got["naive"], oracle)
        failures += [f"{dt} flash vs naive: {f}" for f in faults]
        passes[f"{dt}_requests_differing_flash_naive"] = differ

    _profile_paged_window(dev, model, "int8")

    # stored codes against the codec of the fp engine's rows (layer 0)
    prompt = workload[4][0]  # 40 tokens
    name = None
    rows = {}
    for dt in ("fp", "int8", "int4"):
        engine = InferenceEngine(model, **ENGINE, **ENGINE_PAGED, kv_dtype=dt)
        req = engine.submit(prompt, 64)
        engine.step()
        table = engine.scheduler.tables[req.slot]
        name = engine.arena.specs[0][0]
        pos = np.arange(len(prompt))
        blk = np.asarray(table)[pos // ENGINE_PAGED["block_size"]]
        off = pos % ENGINE_PAGED["block_size"]
        rows[dt] = [z.cpu().numpy()[blk, off] for z in engine.arena.caches[name]]
    codes = {}
    for dt in ("int8", "int4"):
        ok = True
        for i in range(2):
            q, sc = quantize_rows_np(rows["fp"][i], dt)
            ok = ok and np.array_equal(q, rows[dt][i]) and np.array_equal(sc, rows[dt][2 + i])
        codes[dt] = ok
        if not ok:
            failures.append(f"{dt}: layer {name}'s stored codes or scales differ from "
                            f"quantize_rows_np of the fp rows")

    before = _launches()
    preempt, faults, (got, alone) = _preemption(model, dev, "int8")
    now = _launches()
    launches = {k: launches[k] + now[k] - before[k] for k in launches}
    failures += faults
    if not (preempt["victim_identical"] and preempt["preemptor_identical"]):
        failures.append(f"int8 preemption stream differs from the runs alone: {preempt}")

    # admitted concurrency at equal pool bytes (bench.py:825-900, gate 1)
    bs, lanes, nb_fp = 16, 32, 16
    specs = InferenceEngine(model, num_slots=1, paged=True, block_size=bs,
                            num_blocks=1).arena.specs
    fp_bytes = nb_fp * bs * pool_bytes_per_pos(specs, "fp")
    rng = np.random.default_rng(19)
    mixed = [(((int(rng.integers(2, 6)) + np.arange(QUANT_P_LEN)) % 4 + 2).astype(np.int32), 16)
             for _ in range(lanes)]
    conc = {}
    for dt in ("fp", "int8", "int4"):
        nb = nb_fp if dt == "fp" else max(nb_fp, fp_bytes // (bs * pool_bytes_per_pos(specs, dt)))
        engine = InferenceEngine(model, num_slots=lanes, paged=True, block_size=bs,
                                 num_blocks=nb, kv_dtype=dt)
        if engine.arena.nbytes() > fp_bytes:
            failures.append(f"{dt} pool {engine.arena.nbytes()} B over the fp budget {fp_bytes}")
        conc[dt] = {"num_blocks": nb, "pool_bytes": engine.arena.nbytes(),
                    "peak": _peak_concurrency(engine, mixed)[0]}
    ratio = {dt: conc[dt]["peak"] / max(1, conc["fp"]["peak"]) for dt in ("int8", "int4")}
    if not ratio["int8"] >= 2.0:
        failures.append(f"int8 admitted concurrency {ratio['int8']}x fp at equal bytes")

    # score agreement on the trained stand-in
    t0 = time.perf_counter()
    standin, rng, loss = _train_quant_standin(dev)
    train_s = time.perf_counter() - t0
    engines = {dt: InferenceEngine(standin, num_slots=32, paged=True, block_size=bs,
                                   num_blocks=64, kv_dtype=dt) for dt in ("fp", "int8", "int4")}
    prompts = [[int(t) for t in (int(rng.integers(2, 6)) + np.arange(QUANT_P_LEN)) % 4 + 2]
               for _ in range(QUANT_PROMPTS)]
    subs = [engines["fp"].submit(p, QUANT_COMPLETION) for p in prompts]
    engines["fp"].run()
    oracle_tokens = [[int(t) for t in r.tokens] for r in subs]
    agreement = {dt: float(np.mean([engines[dt].score(p, c)["agreement"]
                                    for p, c in zip(prompts, oracle_tokens)]))
                 for dt in ("int8", "int4")}
    if not agreement["int8"] >= QUANT_AGREEMENT:
        failures.append(f"int8 token agreement {agreement['int8']} under {QUANT_AGREEMENT}")
    emit({"phase": "engine_quant", "config": CONFIGS["A"], "options": {**ENGINE, **ENGINE_PAGED},
          "passes": passes, "launches": launches,
          "stored_codes_bit_equal_layer0": codes, "layer": name,
          "preemption_int8": preempt,
          "equal_bytes_concurrency": {"lanes": lanes, "fp_pool_bytes": fp_bytes, **conc,
                                      "ratio": ratio},
          "agreement": {"model": QUANT_MODEL, "workers": QUANT_WORKERS,
                        "final_loss": loss, "train_s": train_s,
                        "prompts": QUANT_PROMPTS, "completion": QUANT_COMPLETION,
                        **agreement, "gate_int8": QUANT_AGREEMENT},
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"quantized engine check failed: {failures}")
    return launches


def _periodic(rng, n, length):
    """``n`` rows of ``length`` tokens of the reference bench's periodic
    sequences: tokens 2..5, period 4, from a random phase."""
    starts = rng.integers(2, 6, size=n)
    return ((starts[:, None] + np.arange(length)) % 4 + 2).astype(np.int32)


def _train_spec_standin(dev):
    """Config A trained through the port's SparkModel on bench.py:1189-1196's
    periodic data (rng 29), an epoch at a time, until its greedy
    continuation of each of the four phases' SPEC_P_LEN-token prompts is
    periodic for SPEC_BUDGET tokens (an untrained model's argmax is noise no
    drafter predicts: bench.py:1145-1148). Returns the model, the rng (to
    draw the workload from, as the bench does), the epochs, the final loss
    and the fit's seconds."""
    from elephas_tpu_torch import SparkModel, generate, transformer_lm

    cfg = CONFIGS["A"]
    maxlen = cfg["maxlen"]
    model = transformer_lm(**cfg, dropout=0.0, lr=SPEC_TRAIN["lr"], seed=0, device=dev)
    rng = np.random.default_rng(29)
    seq = _periodic(rng, SPEC_TRAIN["rows"], maxlen + 1)
    x, y = seq[:, :-1], seq[:, 1:]
    sm = SparkModel(model, device=dev)
    probes = _periodic(np.random.default_rng(0), 1, SPEC_P_LEN + SPEC_BUDGET)
    probes = np.stack([(probes[0] + i) % 4 + 2 for i in range(4)]).astype(np.int32)
    t0, loss = time.perf_counter(), None
    for epoch in range(1, SPEC_EPOCHS_MAX + 1):
        loss = float(sm.fit((x, y), epochs=1, batch_size=SPEC_TRAIN["batch"])["loss"][-1])
        out = generate(model, probes[:, :SPEC_P_LEN], SPEC_BUDGET, kv_cache=True)
        if (out == probes).all():
            torch.cuda.synchronize(dev)
            return model, rng, epoch, loss, time.perf_counter() - t0
    raise AssertionError(f"config A's greedy continuations are not periodic after "
                         f"{SPEC_EPOCHS_MAX} epochs (loss {loss})")


@contextlib.contextmanager
def _counting_chunk_widths(counts):
    """While the block runs, count the model's span-chunk calls (arena and
    paged) by (kernel, C) into ``counts``."""
    from elephas_tpu_torch.models import transformer

    saved = {name: getattr(transformer, name)
             for name in ("flash_span_chunk", "flash_paged_span_chunk")}

    def counting(name, fn):
        def call(q, *args, **kwargs):
            counts[(name, q.shape[2])] += 1
            return fn(q, *args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(transformer, name, counting(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(transformer, name, fn)


def _decode_tok_s(reqs):
    """Decode-only tokens/s of ``reqs`` (bench.py:1224-1233): tokens after
    each request's first over its first-to-last token window."""
    toks = sum(len(r.token_times) - 1 for r in reqs if len(r.token_times) > 1)
    secs = sum(r.token_times[-1] - r.token_times[0] for r in reqs if len(r.token_times) > 1)
    return toks / secs


def phase_engine_spec(dev):
    """Speculative decoding and the fair-share policy at config A's width on
    the bench's lookup-friendly workload (see the module docstring, 6g).
    Returns the timed rounds' kernel launches."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.serving import (
        AdmissionRejected,
        DraftModelDrafter,
        Drafter,
        FairSharePolicy,
    )

    class AdversarialDrafter(Drafter):
        """bench.py:1173-1182: token 1, which the trained model never emits."""

        def propose(self, req, k):
            return [1] * int(k)

    model, rng, epochs, loss, fit_s = _train_spec_standin(dev)
    layers = len(model.blocks)
    friendly = [(_periodic(rng, 1, SPEC_P_LEN)[0], SPEC_BUDGET) for _ in range(SPEC_REQUESTS)]
    spec = dict(speculative=True, spec_k=SPEC_K)
    draft = DraftModelDrafter(model, num_slots=SPEC_SLOTS)
    engines = {
        "off": InferenceEngine(model, num_slots=SPEC_SLOTS),
        "on": InferenceEngine(model, num_slots=SPEC_SLOTS, **spec),
        "paged": InferenceEngine(model, num_slots=SPEC_SLOTS, **spec, **ENGINE_PAGED),
        "paged_int8": InferenceEngine(model, num_slots=SPEC_SLOTS, **spec, **ENGINE_PAGED,
                                      kv_dtype="int8"),
        "adversarial": InferenceEngine(model, num_slots=SPEC_SLOTS, **spec,
                                       spec_drafter=AdversarialDrafter()),
        "self": InferenceEngine(model, num_slots=SPEC_SLOTS, **spec, spec_drafter=draft),
        "policy": InferenceEngine(model, num_slots=SPEC_SLOTS,
                                  policy=FairSharePolicy(SPEC_TENANTS)),
    }

    def submit(label, eng):
        if label != "policy":
            return [eng.submit(p, n) for p, n in friendly]
        return [eng.submit(p, n, tenant="ab"[i % 2],
                           ttft_deadline_ms=SPEC_DEADLINES_MS[(i // 2) % 2])
                for i, (p, n) in enumerate(friendly)]

    failures = []
    for label, eng in engines.items():  # warm-up: every program and bucket
        for _ in range(2):
            submit(label, eng)
            eng.run()
    tps = {label: [] for label in engines}
    last = {}
    counts = Counter()
    s0 = {label: eng.stats() for label, eng in engines.items()}
    catchup0 = draft.catchup_passes
    torch.cuda.synchronize(dev)
    _reset_launches()
    launches_by = {label: Counter() for label in engines}
    with _counting_chunk_widths(counts):
        for _ in range(SPEC_ROUNDS):
            for label, eng in engines.items():  # in turns
                before = _launches()
                reqs = submit(label, eng)
                eng.run()
                torch.cuda.synchronize(dev)
                after = _launches()
                launches_by[label].update({k: after[k] - before[k] for k in after})
                tps[label].append(_decode_tok_s(reqs))
                last[label] = reqs
                if eng.paged and eng.stats()["blocks_free"] != eng.num_blocks:
                    failures.append(f"{label}: the pool is not whole after a run")
    launches = _launches()
    med = {k: float(np.median(v)) for k, v in tps.items()}

    def delta(label, key):
        return engines[label].stats()[key] - s0[label][key]

    # tokens: every engine's equal the off engine's (margin rule), per request
    off = [r.tokens for r in last["off"]]
    mismatch = {}
    for label, reqs in last.items():
        bad = []
        for i, (r, want) in enumerate(zip(reqs, off)):
            p = list(r.prompt)

            def logits_of(j, p=p, want=want):
                with torch.inference_mode():
                    return model(torch.tensor([p + want[:j]], device=dev), plain=True)[0, -1]

            fault = _first_divergence(r.tokens, want, logits_of)
            if fault or len(r.tokens) != len(want):
                bad.append((i, fault or f"{len(r.tokens)} tokens, want {len(want)}"))
        mismatch[label] = len(bad)
        if bad:
            failures.append(f"{label}: tokens differ from the off engine's: {bad[:3]}")
    rates = {}
    for label in ("on", "paged", "paged_int8", "adversarial", "self"):
        drafted, accepted = delta(label, "spec_draft_tokens"), delta(label, "spec_accepted_tokens")
        rates[label] = accepted / drafted if drafted else None
    if not (rates["on"] or 0) >= SPEC_ACCEPTANCE:
        failures.append(f"n-gram acceptance {rates['on']} below {SPEC_ACCEPTANCE}")
    if not delta("adversarial", "spec_throttled") >= 1:
        failures.append("the adversarial drafter never tripped the throttle")
    if not delta("self", "spec_accepted_tokens") > 0:
        failures.append("self-speculation accepted no draft")
    # one span-chunk launch a layer for every verify round (and every draft
    # model catch-up chunk), counted at the wrappers and by the kernels
    rounds = {label: delta(label, "spec_verify_rounds")
              for label in ("on", "paged", "paged_int8", "adversarial", "self")}
    catchup = draft.catchup_passes - catchup0
    chunk = DraftModelDrafter.CATCHUP_CHUNK
    want_arena = (rounds["on"] + rounds["adversarial"] + rounds["self"]) * layers
    want_paged = (rounds["paged"] + rounds["paged_int8"]) * layers
    verify_counts = {"arena": counts[("flash_span_chunk", VERIFY_W)],
                     "paged": counts[("flash_paged_span_chunk", VERIFY_W)],
                     "catchup": counts[("flash_span_chunk", chunk)]}
    if verify_counts != {"arena": want_arena, "paged": want_paged, "catchup": catchup * layers}:
        failures.append(f"verify-window launches {verify_counts}, want arena {want_arena}, "
                        f"paged {want_paged}, catch-up {catchup * layers}")
    arena_calls = sum(n for (name, _c), n in counts.items() if name == "flash_span_chunk")
    paged_calls = sum(n for (name, _c), n in counts.items() if name == "flash_paged_span_chunk")
    if (launches["span_chunk"], launches["paged_span_chunk"]) != (arena_calls, paged_calls):
        failures.append(f"kernel launches {launches} differ from the wrappers' calls "
                        f"{arena_calls} / {paged_calls}")
    for label in ("on", "self", "adversarial"):
        if launches_by[label]["span_chunk"] == 0 or launches_by[label]["flash_fwd"] == 0:
            failures.append(f"{label}: launches {dict(launches_by[label])}")
    for label in ("paged", "paged_int8"):
        if launches_by[label]["paged_span_chunk"] == 0 or launches_by[label]["flash_fwd"]:
            failures.append(f"{label}: launches {dict(launches_by[label])}")
    # TTFT p50 a tenant in the policy engine's last round
    ttft = {t: float(np.percentile([r.ttft for r in last["policy"] if r.tenant == t], 50))
            for t in SPEC_TENANTS}
    # a burst past max_queue_tokens: refused for the heavy tenant only
    burst = InferenceEngine(model, num_slots=SPEC_SLOTS, policy=FairSharePolicy(
        SPEC_TENANTS, max_queue_tokens=SPEC_MAX_QUEUE_TOKENS))
    submitted = {"a": SPEC_BURST[0], "b": SPEC_BURST[1]}
    reqs = [burst.submit(p, n, tenant=t) for t in submitted
            for p, n in friendly[: submitted[t]]]
    refused = Counter(r.tenant for r in reqs if isinstance(r.error, AdmissionRejected))
    burst.run()
    counted = {t: burst.stats()["tenants"][t] for t in submitted}
    if set(refused) != {"a"} or any(
            counted[t]["admitted"] + counted[t]["rejected"] != submitted[t] for t in submitted):
        failures.append(f"burst: refused {dict(refused)}, counted {counted}")
    emit({"phase": "engine_spec", "config": CONFIGS["A"], "fit_epochs": epochs,
          "fit_loss": loss, "fit_seconds": fit_s, "requests": SPEC_REQUESTS,
          "prompt_len": SPEC_P_LEN, "budget": SPEC_BUDGET, "spec_k": SPEC_K,
          "num_slots": SPEC_SLOTS, "rounds": SPEC_ROUNDS,
          "decode_tok_s_median": med, "decode_tok_s_rounds": tps,
          "on_off": med["on"] / med["off"], "paged_off": med["paged"] / med["off"],
          "paged_int8_off": med["paged_int8"] / med["off"],
          "adversarial_off": med["adversarial"] / med["off"],
          "self_off": med["self"] / med["off"], "policy_off": med["policy"] / med["off"],
          "acceptance": rates, "verify_rounds": rounds,
          "throttled": delta("adversarial", "spec_throttled"),
          "draft_catchup_passes": catchup, "chunk_calls_by_width":
              {f"{name}_C{c}": n for (name, c), n in sorted(counts.items())},
          "token_mismatches": mismatch, "ttft_p50_s_by_tenant": ttft,
          "ttft_deadlines_ms": SPEC_DEADLINES_MS, "tenants": SPEC_TENANTS,
          "burst": {"max_queue_tokens": SPEC_MAX_QUEUE_TOKENS, "submitted": submitted,
                    "refused": dict(refused), "counted": counted},
          "launches": launches, "launches_by_engine": {k: dict(v) for k, v in
                                                        launches_by.items()},
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"engine_spec check failed: {failures}")
    del engines, burst, draft, model
    return launches


# -- the serving front door (gateway, migration, telemetry's host cost) --------

GATEWAY_CLIENTS = 16
GATEWAY_BATCH = 4  # E's requests sent as one batch-form POST (one budget)
GATEWAY_ROUNDS = 3
MIGRATE_REQUESTS = 8  # E-long's first prompts, started on engine A
MIGRATE_EXPORTS = 4  # of them exported to engine B
MIGRATE_AFTER = 8  # generated tokens seen before an export
MIGRATE_DTYPES = ("fp", "int8")
HTTP_TIMEOUT_S = 300


def _http(port, method, path, body=None):
    """One request on a fresh connection: ``(status, X-Request-Id, body)``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        headers = {}
        if body is not None and not isinstance(body, bytes):
            body = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.getheader("X-Request-Id"), resp.read()
    finally:
        conn.close()


def _sse_generate(port, prompt, budget, on_event=None):
    """``POST /v1/generate`` as an SSE stream: the header's and the opening
    event's rids, the tokens, the client-side TTFT (send to first token
    event) and the closing event; ``on_event(result so far)`` after every
    token."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": [int(t) for t in prompt], "max_new_tokens": int(budget)}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = {"status": resp.status, "header_rid": resp.getheader("X-Request-Id"),
               "rid": None, "tokens": [], "ttft_s": None, "done": None}
        for line in resp:
            if not line.startswith(b"data: "):
                continue
            event = json.loads(line[len(b"data: "):])
            if "token" in event:
                if out["ttft_s"] is None:
                    out["ttft_s"] = time.perf_counter() - t0
                out["tokens"].append(event["token"])
                if on_event is not None:
                    on_event(out)
            elif "n_tokens" in event:
                out["done"] = event
            else:
                out["rid"] = event["rid"]
        return out
    finally:
        conn.close()


def _closed_loop(jobs, run_one, clients=GATEWAY_CLIENTS):
    """``run_one(job)`` for every job from ``clients`` threads, each taking
    the next job when its last one is answered (a closed loop of ``clients``
    users; as many as jobs: every job at once). Returns the wall seconds;
    raises if a job did."""
    import threading

    jobs, errors, lock = iter(jobs), [], threading.Lock()

    def client():
        while True:
            with lock:
                job = next(jobs, None)
            if job is None:
                return
            try:
                run_one(job)
            except Exception as e:  # reported below, failing the phase
                with lock:
                    errors.append(f"{job}: {e!r}")

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"requests failed: {errors}")
    return seconds


def _wire_pass(port, workload, batch, clients=GATEWAY_CLIENTS):
    """E's requests over HTTP in a closed loop of ``clients`` client threads:
    the requests of ``batch`` as one batch-form POST (``stream: false``), the
    others one a request, every other one as SSE and the rest as JSON. Runs
    in the client process. Returns the results by request index and the
    wall seconds."""
    singles = [i for i in range(len(workload)) if i not in batch]
    stream = {i: k % 2 == 0 for k, i in enumerate(singles)}
    results = [None] * len(workload)

    def one(job):
        if job == "batch":
            t0 = time.perf_counter()
            status, _, body = _http(port, "POST", "/v1/generate", {
                "prompts": [[int(t) for t in workload[i][0]] for i in batch],
                "max_new_tokens": int(workload[batch[0]][1]), "stream": False})
            if status != 200:
                raise AssertionError(f"batch POST answered {status}: {body[:200]!r}")
            for i, entry in zip(batch, json.loads(body)["results"]):
                results[i] = {"rid": entry["rid"], "header_rid": entry["rid"],
                              "tokens": entry["tokens"], "ttft_s": None,
                              "seconds": time.perf_counter() - t0,
                              "error": entry["error"], "stream": "batch"}
            return
        prompt, budget = workload[job]
        t0 = time.perf_counter()
        if stream[job]:
            r = _sse_generate(port, prompt, budget)
            if r["status"] != 200 or r["done"] is None:
                raise AssertionError(f"SSE request {job}: status {r['status']}, end {r['done']}")
            results[job] = {**r, "error": r["done"]["error"], "stream": "sse",
                            "seconds": time.perf_counter() - t0}
            return
        status, rid_hdr, body = _http(port, "POST", "/v1/generate", {
            "prompt": [int(t) for t in prompt], "max_new_tokens": int(budget),
            "stream": False})
        if status != 200:
            raise AssertionError(f"JSON request {job} answered {status}: {body[:200]!r}")
        doc = json.loads(body)
        results[job] = {"rid": doc["rid"], "header_rid": rid_hdr, "tokens": doc["tokens"],
                        "ttft_s": None, "error": doc["error"], "stream": "json",
                        "seconds": time.perf_counter() - t0}

    seconds = _closed_loop((["batch"] if batch else []) + singles, one, clients)
    return results, seconds


def _in_process_closed_loop(gw, workload, batch):
    """The same closed loop in process: GATEWAY_CLIENTS threads submit
    straight to the gateway's engine (under its lock, as the gateway's
    handlers do) and wait for each request's last token; the gateway's
    driver steps. The wire's baseline without HTTP. Returns the requests by
    index, each one's client-side TTFT (from before it waits for the
    engine lock, as the wire's clients measure theirs) and the wall
    seconds."""
    import threading

    engine, reqs, ttft = gw.engine, [None] * len(workload), {}

    def one(job):
        idx = batch if job == "batch" else [job]
        done = [threading.Event() for _ in idx]
        t0 = time.perf_counter()
        with gw.engine.lock:
            for i, ev in zip(idx, done):
                reqs[i] = engine.submit(*workload[i], on_token=lambda t, d, ev=ev: d and ev.set())
        gw._work.set()
        for ev in done:
            if not ev.wait(HTTP_TIMEOUT_S):
                raise AssertionError(f"request {job} never finished")
        for i in idx:
            ttft[i] = reqs[i].token_times[0] - t0

    singles = [i for i in range(len(workload)) if i not in batch]
    seconds = _closed_loop((["batch"] if batch else []) + singles, one)
    return reqs, ttft, seconds


def _client_process():
    """One spawned process for the HTTP clients: they parse the SSE streams
    and JSON bodies on a GIL of their own, not the server's."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))


def _metric(text, name, labels):
    """The value of series ``name`` whose labels include every
    ``label="value"`` of ``labels``, summed over the matching lines of a
    Prometheus exposition."""
    total, found = 0.0, False
    for line in text.splitlines():
        if line.startswith(name + "{") and all(f'{k}="{v}"' in line for k, v in labels.items()):
            total += float(line.rsplit(" ", 1)[1])
            found = True
    return total if found else None


def _percentiles(xs):
    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99))}


def _gateway_over_e(dev, model, clients, failures):
    """A Gateway over E's engine, GATEWAY_ROUNDS rounds in turns of: E's
    workload in process all at once (the engine phase's measure, the
    gateway's driver parked on its engine lock), over HTTP all at once (one
    client thread a request, from the ``clients`` process), in a closed loop
    of GATEWAY_CLIENTS in-process submitters, and over HTTP in the same
    closed loop. All at once, the two differ by the gateway's own work a
    request and a token; in the closed loop, a client over the wire also
    resubmits after the driver started its next window. Gates: the wire's
    tokens equal the in-process tokens (margin rule), the rid echo,
    /healthz, /debug/engine, a request's trace, and /metrics against
    stats(). Returns the row and the rounds' launches."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.serving import Gateway

    workload = _engine_workload(model.vocab_size, ENGINE_REQUESTS)
    batch = [i for i, (_p, b) in enumerate(workload) if b == ENGINE_BUDGETS[0]][-GATEWAY_BATCH:]
    engine = InferenceEngine(model, **ENGINE)
    engine.run(workload[: ENGINE["num_slots"]])
    rows = {"in_process": [], "wire_all_at_once": [], "in_process_closed_loop": [],
            "wire": []}
    launches = dict.fromkeys(_launches(), 0)
    wire_results, inproc = [], None
    with Gateway(engine) as gw:
        clients.submit(_wire_pass, gw.port, workload[:GATEWAY_CLIENTS], []).result()  # warm
        for _ in range(GATEWAY_ROUNDS):
            before = _launches()
            with gw.engine.lock:
                reqs, row = _serve_pass(engine, workload, dev)
            inproc = inproc or reqs
            rows["in_process"].append(row)
            for name, n in (("wire_all_at_once", len(workload)), ("wire", GATEWAY_CLIENTS)):
                results, seconds = clients.submit(_wire_pass, gw.port, workload, batch,
                                                  n).result()
                tokens = sum(len(r["tokens"]) for r in results)
                rows[name].append({
                    "seconds": seconds, "tokens_s": tokens / seconds, "generated_tokens": tokens,
                    "ttft_s": _percentiles([r["ttft_s"] for r in results
                                            if r["ttft_s"] is not None]),
                    "request_s": _percentiles([r["seconds"] for r in results])})
                wire_results.append(results)
                if name == "wire_all_at_once":
                    loop_reqs, ttft, seconds = _in_process_closed_loop(gw, workload, batch)
                    tokens = sum(len(r.tokens) for r in loop_reqs)
                    rows["in_process_closed_loop"].append({
                        "seconds": seconds, "tokens_s": tokens / seconds,
                        "ttft_s": _percentiles(list(ttft.values()))})
            torch.cuda.synchronize(dev)
            now = _launches()
            launches = {k: launches[k] + now[k] - before[k] for k in launches}
        status, _, body = _http(gw.port, "GET", "/healthz")
        health = json.loads(body)
        if status != 200 or health.get("status") != "ok" or "anomalies" not in health:
            failures.append(f"/healthz answered {status}: {health}")
        status, _, body = _http(gw.port, "GET", "/debug/engine")
        debug = json.loads(body)
        if status != 200 or debug.get("engine") != engine.telemetry_label:
            failures.append(f"/debug/engine answered {status}")
        rid = wire_results[-1][0]["rid"]
        status, rid_hdr, body = _http(gw.port, "GET", f"/v1/requests/{rid}/trace")
        trace = json.loads(body)
        if (status != 200 or rid_hdr != str(rid) or trace["finish"]["reason"] != "budget"
                or trace["tokens"] != len(wire_results[-1][0]["tokens"])):
            failures.append(f"trace of {rid}: {status}, {trace.get('finish')}")
        status, _, body = _http(gw.port, "GET", "/metrics")
        text = body.decode()
        stats = engine.stats()
        eid, sid = engine.telemetry_label, engine.scheduler.telemetry_label
        scraped = {
            "tokens_generated": _metric(text, "elephas_serving_tokens_generated_total",
                                        {"engine": eid}),
            "requests_finished": _metric(text, "elephas_serving_requests_finished_total",
                                         {"engine": eid}),
            "admissions": _metric(text, "elephas_serving_admissions_total", {"scheduler": sid}),
        }
        want = {"tokens_generated": stats["total_generated"],
                "requests_finished": stats["finished"], "admissions": stats["finished"]}
        if status != 200 or scraped != want:
            failures.append(f"/metrics {scraped} against stats() {want}")
    if gw._driver_thread.is_alive() or gw._loop_thread.is_alive():
        failures.append("the gateway's threads outlived stop()")
    _, close, check_failures, plain = _check_emitted(model, inproc, dev)
    failures += check_failures
    exact = differ = 0
    for results in wire_results:
        for i, (r, w) in enumerate(zip(results, inproc)):
            if str(r["rid"]) != str(r["header_rid"]) or r["error"] is not None:
                failures.append(f"request {i}: rid {r['rid']} header {r['header_rid']}, "
                                f"error {r['error']}")
            p = len(w.prompt)
            bad = _first_divergence(r["tokens"], w.tokens, lambda j, i=i, p=p: plain[i, p - 1 + j])
            exact += r["tokens"] == w.tokens
            differ += r["tokens"] != w.tokens
            if bad:
                failures.append(f"request {i} over the wire ({r['stream']}): {bad}")
    med = {name: float(np.median([x["tokens_s"] for x in r])) for name, r in rows.items()}
    ttft = {name: float(np.median([x["ttft_s"]["p50"] for x in r])) for name, r in rows.items()}
    return {"requests": len(workload), "batch_requests": batch, "clients": GATEWAY_CLIENTS,
            "rounds": GATEWAY_ROUNDS, "tokens_s_median": med, "ttft_p50_s_median": ttft,
            "wire_over_in_process_all_at_once": med["wire_all_at_once"] / med["in_process"],
            "wire_over_in_process_closed_loop": med["wire"] / med["in_process_closed_loop"],
            "exact_token_streams": exact, "within_margin_streams": differ,
            "plain_within_margin": close, "metrics": scraped, "healthz": health,
            "rows": rows}, launches


def _migration_client(a_port, b_port, workload):
    """Runs in the client process: ``workload``'s requests stream from A as
    SSE; each of the first MIGRATE_EXPORTS is exported through A's
    /v1/requests/{rid}/export from the thread reading it as soon as it holds
    MIGRATE_AFTER tokens (A's gateway hands its engine lock to the export
    before its next step) and the bytes POSTed to B's /v1/migrate. Returns
    the rids, streams, record bytes and milliseconds."""
    import threading

    out = {"rids": {}, "streams": {}, "bodies": {}, "export_ms": [], "import_ms": [],
           "errors": []}

    def migrate(rid):
        t0 = time.perf_counter()
        status, _, body = _http(a_port, "POST", f"/v1/requests/{rid}/export")
        out["export_ms"].append((time.perf_counter() - t0) * 1e3)
        if status != 200:
            raise AssertionError(f"export of {rid} answered {status}: {body[:200]!r}")
        out["bodies"][rid] = body
        t0 = time.perf_counter()
        status, rid_hdr, reply = _http(b_port, "POST", "/v1/migrate", body)
        out["import_ms"].append((time.perf_counter() - t0) * 1e3)
        if status != 200 or rid_hdr != str(rid) or not json.loads(reply)["warm"]:
            raise AssertionError(f"migrate of {rid} answered {status}: {reply[:200]!r}")

    def stream(i):
        def seen(res):
            rid = out["rids"][i] = int(res["header_rid"])
            if i < MIGRATE_EXPORTS and len(res["tokens"]) >= MIGRATE_AFTER \
                    and rid not in out["bodies"]:
                migrate(rid)

        try:
            out["streams"][i] = _sse_generate(a_port, *workload[i], on_event=seen)
        except Exception as e:  # reported by the caller, failing the phase
            out["errors"].append(f"stream {i}: {e!r}")

    threads = [threading.Thread(target=stream, args=(i,)) for i in range(len(workload))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT_S)
    return out


def _migrate_dtype(dev, model, kv_dtype, clients, failures, foreign=None):
    """Two paged engines A and B (E's options with ENGINE_PAGED and
    ``kv_dtype``), each behind its own gateway, MIGRATE_REQUESTS of
    E-long's prompts streaming from A through _migration_client. Gates:
    every stream's tokens equal an unmigrated run's (margin rule on the
    kv_dtype's oracle), A's stored rows, the record's and B's resumed rows
    the same bytes, both pools whole, and ``foreign`` (a record of another
    kv_dtype) refused. Returns the row, the first record's bytes and the
    engines' launches (the unmigrated run's included, the oracle's not)."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.fleet.migration import decode_record
    from elephas_tpu_torch.serving import Gateway
    from elephas_tpu_torch.serving.paged_kv import blocks_for, gather_blocks

    opts = dict(ENGINE, **ENGINE_PAGED, kv_dtype=kv_dtype)
    workload = _long_workload(model.vocab_size)[:MIGRATE_REQUESTS]
    before = _launches()
    ref = InferenceEngine(model, **opts)
    want = [ref.submit(p, b) for p, b in workload]
    ref.run()
    a, b = InferenceEngine(model, **opts), InferenceEngine(model, **opts)

    def rows_of(engine, blocks):
        ids = torch.tensor(list(blocks), dtype=torch.long, device=dev)
        return {name: tuple(z.cpu() for z in leaves)
                for name, leaves in gather_blocks(engine.arena, ids).items()}

    held, resumed = {}, {}
    engine_ms = {"offload": [], "payload": [], "import": []}
    offload, payload, adopt, resume = a._offload, a._export_payload, b.import_request, b._resume

    def timed(key, fn, *args, **kwargs):  # the engine's own time, under its lock
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        engine_ms[key].append((time.perf_counter() - t0) * 1e3)
        return out

    def snapshot_offload(pre):  # A's stored rows of a request about to leave
        held[pre.req.rid] = rows_of(a, pre.blocks)
        timed("offload", offload, pre)

    def snapshot_resume(adm):  # B's rows of the migrated blocks, right after the scatter
        resume(adm)
        req = adm.req
        resumed[req.rid] = rows_of(b, adm.blocks[:blocks_for(
            len(req.prompt) + len(req.tokens) - 1, b.block_size)])

    a._offload, b._resume = snapshot_offload, snapshot_resume
    a._export_payload = lambda *args, **kw: timed("payload", payload, *args, **kw)
    b.import_request = lambda *args, **kw: timed("import", adopt, *args, **kw)
    with Gateway(a) as ga, Gateway(b) as gb:
        out = clients.submit(_migration_client, ga.port, gb.port,
                             [([int(t) for t in p], n) for p, n in workload]).result()
        records = {rid: decode_record(body) for rid, body in out["bodies"].items()}
        if out["errors"] or len(records) != MIGRATE_EXPORTS:
            raise AssertionError(f"{kv_dtype}: {len(records)} requests migrated: {out['errors']}")
        deadline = time.monotonic() + HTTP_TIMEOUT_S
        while any(rid not in b.finished for rid in records):
            if time.monotonic() > deadline:
                raise AssertionError("a migrated request never finished on B")
            time.sleep(0.01)
        if foreign is not None:
            status, _, reply = _http(gb.port, "POST", "/v1/migrate", foreign)
            if status != 409 or b"kv_dtype" not in reply:
                failures.append(f"a foreign-kv_dtype record answered {status}: {reply[:200]!r}")
    torch.cuda.synchronize(dev)
    now = _launches()
    launches = {k: now[k] - before[k] for k in now}
    rids = out["rids"]
    got = [b.finished[rids[i]] if rids[i] in records else a.finished[rids[i]]
           for i in range(len(workload))]
    faults, differ = _tokens_agree(got, want, lambda seq: _quant_logits(model, seq, kv_dtype, dev))
    failures += [f"{kv_dtype}: {f}" for f in faults]
    for i in range(len(workload)):
        if rids[i] not in records and out["streams"][i]["tokens"] != got[i].tokens:
            failures.append(f"{kv_dtype}: stream {i}'s SSE tokens are not its request's")
    for rid, record in records.items():
        mine = resumed.get(rid)
        if mine is None or rid not in held:
            failures.append(f"{kv_dtype}: migrated request {rid} never offloaded or resumed")
            continue
        for name, leaves in record["rows"].items():
            for j, (sent, a_rows, b_rows) in enumerate(zip(leaves, held[rid][name],
                                                          mine[name])):
                if not (np.asarray(sent).tobytes() == a_rows.numpy().tobytes()
                        == b_rows.numpy().tobytes()):
                    failures.append(f"{kv_dtype}: request {rid} layer {name} array {j}: "
                                    f"A's stored rows, the record's and B's resumed rows "
                                    f"are not the same bytes")
        if len(record["tokens"]) < MIGRATE_AFTER:
            failures.append(f"{kv_dtype}: request {rid} exported at "
                            f"{len(record['tokens'])} tokens")
    for name, e in (("A", a), ("B", b)):
        if e.scheduler.allocator.free_count != e.num_blocks or e.scheduler.has_work:
            held_blocks = e.num_blocks - e.scheduler.allocator.free_count
            failures.append(f"{kv_dtype}: pool {name} holds {held_blocks} blocks after the run")
    sizes = [len(body) for body in out["bodies"].values()]
    return {"kv_dtype": kv_dtype, "requests": len(workload), "exported": len(records),
            "exported_at_tokens": [len(r["tokens"]) for r in records.values()],
            "record_bytes": sizes, "export_ms": out["export_ms"], "import_ms": out["import_ms"],
            "export_ms_median": float(np.median(out["export_ms"])),
            "import_ms_median": float(np.median(out["import_ms"])),
            "engine_ms": engine_ms,
            "engine_ms_median": {k: float(np.median(v)) for k, v in engine_ms.items()},
            "streams_within_margin": differ,
            "stats_a": {k: a.stats()[k] for k in ("migrated_out", "kv_quant_export_bytes")},
            "stats_b": {k: b.stats()[k] for k in ("migrated_in", "resumes")}}, \
        next(iter(out["bodies"].values())), launches


def _count_syncs(fn, dev):
    """The synchronizing CUDA calls ``fn()`` makes, counted by the warnings
    of torch.cuda.set_sync_debug_mode("warn"), by the Python line that made
    each."""
    import warnings

    torch.cuda.synchronize(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                   if "synchroniz" in str(w.message))


def _prime_sync_count(dev):
    """The first switch to the "warn" mode of a process itself reports one
    synchronizing call (torch/cuda/__init__.py, seen in one mode's count
    only when it is counted first): make it before counting."""
    _count_syncs(lambda: None, dev)


def _telemetry_cost(dev, model, failures):
    """E's engine with the registry on and built under null mode, each warmed
    up on E's whole workload, then GATEWAY_ROUNDS timed rounds in turns:
    tokens/s (not gated: the host's spread is wider than the cost), and the
    synchronizing CUDA calls of one more E run in each mode, which must be
    equal line for line (telemetry reads no device value). Returns the row
    and the runs' launches."""
    from elephas_tpu_torch import InferenceEngine, telemetry

    workload = _engine_workload(model.vocab_size, ENGINE_REQUESTS)
    before = _launches()
    was = telemetry.set_null(True)
    try:
        null = InferenceEngine(model, **ENGINE)
    finally:
        telemetry.set_null(was)
    engines = {"on": InferenceEngine(model, **ENGINE), "null": null}
    for e in engines.values():
        e.run(workload)
    _prime_sync_count(dev)
    syncs = {name: _count_syncs(lambda e=e: e.run(workload), dev)
             for name, e in engines.items()}
    total = {name: sum(c.values()) for name, c in syncs.items()}
    if syncs["on"] != syncs["null"] or not total["on"] > 0:
        diff = {site: (syncs["on"][site], syncs["null"][site])
                for site in set(syncs["on"]) | set(syncs["null"])
                if syncs["on"][site] != syncs["null"][site]}
        failures.append(f"synchronizing calls on / null: {total}, by line {diff}")
    if null.scrape() != "" or null._flight is not None:
        failures.append("the null-mode engine registered series or records")
    rows = {name: [] for name in engines}
    for _ in range(GATEWAY_ROUNDS):
        for name, e in engines.items():
            rows[name].append(_serve_pass(e, workload, dev)[1])
    tps = {name: float(np.median([r["tokens_s"] for r in rs])) for name, rs in rows.items()}
    now = _launches()
    return {"syncs_per_run": total, "sync_lines": dict(syncs["on"]),
            "tokens_s_median": tps, "on_over_null": tps["on"] / tps["null"],
            "tokens_s_rounds": {n: [r["tokens_s"] for r in rs] for n, rs in rows.items()},
            "series_on": sum(1 for line in engines["on"].scrape(full=False).splitlines()
                             if not line.startswith("#"))}, {k: now[k] - before[k] for k in now}


def phase_gateway(dev, model):
    """The serving front door at config A's full width (``model``, the
    engine phase's): E's engine behind a Gateway (_gateway_over_e), request
    migration between two paged engines behind their own gateways in fp and
    int8 (_migrate_dtype, the int8 pair also refusing the fp record), and
    telemetry's host cost (_telemetry_cost). The launches are counted over
    the served, migrated and telemetry runs only, not the checks. Returns
    them."""
    failures = []
    with _client_process() as clients:
        wire, parts = _gateway_over_e(dev, model, clients, failures)
        parts = {"wire": parts}
        migrate, foreign = [], None
        for kv_dtype in MIGRATE_DTYPES:
            row, foreign_next, parts[f"migrate_{kv_dtype}"] = _migrate_dtype(
                dev, model, kv_dtype, clients, failures, foreign)
            migrate.append(row)
            foreign = foreign or foreign_next
    cost, parts["telemetry_cost"] = _telemetry_cost(dev, model, failures)
    # the checks between the runs launch too: count the served runs only
    launches = {k: sum(p[k] for p in parts.values()) for k in parts["wire"]}
    emit({"phase": "gateway", "config": CONFIGS["A"], "options": ENGINE, "wire": wire,
          "migrate": migrate, "telemetry_cost": cost, "launches": launches,
          "launches_by_part": parts, "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"gateway check failed: {failures}")
    return launches


# -- the serving fleet and weight deployment ---------------------------------------------

# fleet: two paged replicas of E's engine (E's 16 slots and windows of 16,
# blocks of 16, E-paged's 512 blocks, preemption, the prefix cache) on the
# one card behind a Router. E's 48 requests sit behind FLEET_GROUPS system
# prompts of FLEET_SYSTEM tokens (two blocks), so a group's requests share
# a prefix the affinity stage can see (FLEET_MIN_AFFINITY: one block); an odd
# number of groups, so a round-robin walk spreads each group over both
FLEET_ENGINE = dict(ENGINE, **ENGINE_PAGED, preemption=True, prefix_cache=True)
FLEET_SYSTEM = 32
FLEET_GROUPS = 3
FLEET_MIN_AFFINITY = 16
FLEET_ROUNDS = 2
FLEET_DRAIN_AFTER = 96  # tokens the fleet delivered before the drain starts
FLEET_KILL_AFTER = 96  # and before the ReplicaKiller fires
# the killed replica's arena back to the allocator, less this much of the
# survivor's state that may have grown between the two idle readings
FLEET_ARENA_SLACK = 4 << 20
# deploy: config A's weights in a socket store (one shard, then two);
# DEPLOY_GENERATIONS publications of the same content while the router
# serves, subscribers polling every DEPLOY_POLL_S; canary candidates are the
# weights plus seeded noise of DEPLOY_NOISE; the burn holds the canary for
# DEPLOY_STALL_S under TTFT deadlines of DEPLOY_DEADLINE_MS, the clean
# window is DEPLOY_WINDOW evaluations (share 0.5 as the reference's bench)
DEPLOY_GENERATIONS = 3
DEPLOY_POLL_S = 0.02
DEPLOY_NOISE = 0.02
DEPLOY_STALL_S = 1.0
DEPLOY_DEADLINE_MS = 250.0
DEPLOY_GENEROUS_MS = 60_000.0
DEPLOY_WINDOW = 2
DEPLOY_SHARDS = (1, 2)
DEPLOY_RESTART_S = 1.5  # the shard killed mid-deployment stays down this long
DEPLOY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "deploy")


def _fleet_workload(vocab):
    """E's requests, each behind one of FLEET_GROUPS seeded system prompts."""
    rng = np.random.default_rng(7)
    systems = [rng.integers(1, vocab, size=FLEET_SYSTEM).astype(np.int32)
               for _ in range(FLEET_GROUPS)]
    return [(np.concatenate([systems[i % FLEET_GROUPS], prompt]), budget)
            for i, (prompt, budget) in enumerate(_engine_workload(vocab, ENGINE_REQUESTS))]


def _counting(dev):
    """A tally of launches by kernel, and ``counted(fn)``: ``fn()``'s result,
    its launches added to the tally (the served runs of a phase, not its
    checks)."""
    launches = dict.fromkeys(_launches(), 0)

    def counted(fn):
        before = _launches()
        out = fn()
        torch.cuda.synchronize(dev)
        now = _launches()
        for k in launches:
            launches[k] += now[k] - before[k]
        return out

    return launches, counted


def _allocated(dev):
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def _pass_row(seconds, reqs, stamps):
    """tokens/s, TTFT and inter-token percentiles of one pass; ``stamps``
    maps a request's index to its tokens' arrival times."""
    tokens = sum(len(r.tokens) for r in reqs)
    itls = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
    return {"seconds": seconds, "tokens_s": tokens / seconds, "generated_tokens": tokens,
            "ttft_s": _percentiles([r.ttft for r in reqs]),
            "inter_token_s": _percentiles(itls) if itls else None}


def _router_pass(router, workload, dev, **submit):
    """The first request of each group alone (each warms a replica's prefix
    cache), then the rest all at once; returns the handles in workload order
    and the pass's row."""
    stamps = {i: [] for i in range(len(workload))}

    def submit_one(i):
        prompt, budget = workload[i]
        return router.submit(prompt, budget, on_token=lambda t, d, i=i: (
            stamps[i].append(time.perf_counter()) if t is not None else None), **submit)

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    first = [submit_one(i) for i in range(FLEET_GROUPS)]
    if not all(r.wait(HTTP_TIMEOUT_S) for r in first):
        raise AssertionError("a group's first request did not finish")
    reqs = first + [submit_one(i) for i in range(FLEET_GROUPS, len(workload))]
    if not all(r.wait(HTTP_TIMEOUT_S) for r in reqs):
        raise AssertionError("router requests did not finish")
    torch.cuda.synchronize(dev)
    return reqs, _pass_row(time.perf_counter() - t0, reqs, stamps)


def _engine_pass(engine, workload, dev):
    """The same pass on one engine: the groups' first requests, then the rest."""
    stamps = {i: [] for i in range(len(workload))}

    def submit_one(i):
        prompt, budget = workload[i]
        return engine.submit(prompt, budget, on_token=lambda t, d, i=i: (
            stamps[i].append(time.perf_counter()) if t is not None else None))

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    reqs = [submit_one(i) for i in range(FLEET_GROUPS)]
    engine.run()
    reqs += [submit_one(i) for i in range(FLEET_GROUPS, len(workload))]
    engine.run()
    torch.cuda.synchronize(dev)
    return reqs, _pass_row(time.perf_counter() - t0, reqs, stamps)


def _same_tokens(what, got, want, plain, failures):
    """Each of ``got`` (handles) against ``want`` (handles of the one-engine
    pass on the same weights), the margin rule on ``plain`` (the plain
    logits of ``want``'s sequences): returns (exact, within margin)."""
    exact = close = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.error is not None or len(g.tokens) != w.max_new_tokens:
            failures.append(f"{what} request {i}: {len(g.tokens)} of {w.max_new_tokens} "
                            f"tokens, error {g.error}")
            continue
        p = len(w.prompt)
        bad = _first_divergence(g.tokens, w.tokens, lambda j, i=i, p=p: plain[i, p - 1 + j])
        exact += g.tokens == w.tokens
        close += g.tokens != w.tokens
        if bad:
            failures.append(f"{what} request {i}: {bad}")
    return exact, close


class _RouterView:
    """A watchdog source reading one router's replica-up gauge only."""

    def __init__(self, router):
        self.gauge, self.label = router._mf_up, router.telemetry_label

    def series(self, name):
        if name != "elephas_router_replica_up":
            return []
        return [({"router": self.label, "replica": replica}, child.value)
                for (router, replica), child in self.gauge.series() if router == self.label]


def _fleet_reference(dev, model, workload, failures):
    """One engine serving the fleet workload: its handles, the plain logits
    of their sequences and the row (the reference every router pass is held
    to)."""
    from elephas_tpu_torch import InferenceEngine

    engine = InferenceEngine(model, **FLEET_ENGINE)
    reqs, row = _engine_pass(engine, workload, dev)
    _, _, check_failures, plain = _check_emitted(model, reqs, dev)
    failures += check_failures
    engine.release_telemetry()
    return reqs, plain, row


def phase_fleet(dev, model):
    """The serving fleet at config A's full width (``model``, the engine
    phase's): two paged replicas behind a Router. Rounds in turns of one
    engine and the router on the grouped workload (tokens equal, margin
    rule; tokens/s and TTFT printed); the same prompts through a
    round-robin router (the affinity router's prefix hits at least its);
    a drain in the middle of the streams (requests migrated, none dropped
    or doubled, tokens equal); a ReplicaKiller kill in the middle of the
    streams (re-driven token-exact, delivered = generated less stale,
    replica_down fired then cleared on restore, the dead arena freed).
    Returns the launches of the routed runs."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.fault import ReplicaKiller
    from elephas_tpu_torch.fleet import Router
    from elephas_tpu_torch.telemetry.watch import ReplicaDownRule, Watchdog

    failures = []
    workload = _fleet_workload(model.vocab_size)
    ref, plain, _ = _fleet_reference(dev, model, workload, failures)
    launches, counted = _counting(dev)

    def pair():
        return {f"replica-{i}": InferenceEngine(model, **FLEET_ENGINE) for i in range(2)}

    def release(router, engines):
        router.release_telemetry()
        for e in engines.values():
            e.release_telemetry()

    rows = {"one_engine": [], "router": []}
    exact = close = 0
    hits = {}
    for _ in range(FLEET_ROUNDS):
        engine = InferenceEngine(model, **FLEET_ENGINE)
        rows["one_engine"].append(_engine_pass(engine, workload, dev)[1])
        engine.release_telemetry()
        engines = pair()
        router = Router(engines, min_affinity_tokens=FLEET_MIN_AFFINITY)
        with router:
            reqs, row = counted(lambda: _router_pass(router, workload, dev))
        rows["router"].append(row)
        e, c = _same_tokens("router", reqs, ref, plain, failures)
        exact, close = exact + e, close + c
        hits["affinity"] = sum(e.stats()["prefix_cache"]["hits"] for e in engines.values())
        placements = router.stats()["placements"]
        release(router, engines)
    engines = pair()
    router = Router(engines, placement="round_robin")
    with router:
        reqs, rr_row = counted(lambda: _router_pass(router, workload, dev))
    _same_tokens("round-robin", reqs, ref, plain, failures)
    hits["round_robin"] = sum(e.stats()["prefix_cache"]["hits"] for e in engines.values())
    release(router, engines)
    if hits["affinity"] < hits["round_robin"]:
        failures.append(f"prefix hits: affinity {hits['affinity']} < round-robin "
                        f"{hits['round_robin']}")

    # a drain in the middle of the streams
    engines = pair()
    router = Router(engines, min_affinity_tokens=FLEET_MIN_AFFINITY)
    with router:
        def drained():
            reqs = [router.submit(p, b) for p, b in workload[:FLEET_GROUPS]]
            if not all(r.wait(HTTP_TIMEOUT_S) for r in reqs):
                raise AssertionError("drain pass: a group's first request did not finish")
            delivered = router.tokens_delivered
            reqs += [router.submit(p, b) for p, b in workload[FLEET_GROUPS:]]
            while router.tokens_delivered < delivered + FLEET_DRAIN_AFTER:
                time.sleep(0.0005)
            counts = Counter(r.replica for r in reqs if not r.done)
            victim = max(sorted(counts), key=lambda n: counts[n])
            t0 = time.perf_counter()
            moved = router.drain(victim, timeout=HTTP_TIMEOUT_S)
            drain_s = time.perf_counter() - t0
            if not all(r.wait(HTTP_TIMEOUT_S) for r in reqs):
                raise AssertionError("drain pass: requests did not finish")
            router.undrain(victim)
            return reqs, victim, moved, drain_s

        reqs, victim, moved, drain_s = counted(drained)
        stats = router.stats()
    d_exact, d_close = _same_tokens("drain", reqs, ref, plain, failures)
    delivered = sum(len(r.tokens) for r in reqs)
    drain = {"victim": victim, "migrated": moved, "seconds": drain_s,
             "delivered": stats["tokens_delivered"], "tokens": delivered,
             "stale_tokens_dropped": stats["stale_tokens_dropped"],
             "exact_streams": d_exact, "within_margin_streams": d_close}
    if not moved >= 1 or stats["migrated"] != moved:
        failures.append(f"drain migrated {moved} (stats {stats['migrated']})")
    if stats["tokens_delivered"] != delivered or stats["stale_tokens_dropped"]:
        failures.append(f"drain: delivered {stats['tokens_delivered']}, streams hold "
                        f"{delivered}, stale {stats['stale_tokens_dropped']}")
    release(router, engines)

    # a replica killed in the middle of the streams
    engines = pair()
    router = Router(engines, min_affinity_tokens=FLEET_MIN_AFFINITY)
    watchdog = Watchdog(source=_RouterView(router), rules=[ReplicaDownRule()])
    with router:
        idle_before = _allocated(dev)
        generated0 = {n: e.total_generated for n, e in engines.items()}

        def killed():
            reqs = [router.submit(p, b) for p, b in workload[:FLEET_GROUPS]]
            if not all(r.wait(HTTP_TIMEOUT_S) for r in reqs):
                raise AssertionError("kill pass: a group's first request did not finish")
            victim = reqs[0].replica
            arena = engines[victim].arena.nbytes()
            after = router.tokens_delivered + FLEET_KILL_AFTER
            reqs += [router.submit(p, b) for p, b in workload[FLEET_GROUPS:]]
            killer = ReplicaKiller(router, victim, after_tokens=after)
            killer.start()
            if not killer.killed.wait(HTTP_TIMEOUT_S):
                raise AssertionError("the ReplicaKiller never fired")
            if not all(r.wait(HTTP_TIMEOUT_S) for r in reqs):
                raise AssertionError("kill pass: requests did not finish")
            killer.cancel()
            return reqs, victim, killer.redriven, arena

        reqs, victim, redriven, arena = counted(killed)
        fired = [(a.rule, a.labels.get("replica")) for a in watchdog.evaluate()]
        stats = router.stats()
        generated = sum(e.total_generated - generated0[n] for n, e in engines.items())
        idle_after = _allocated(dev)
        released = engines[victim].arena is None
        router.restore_replica(victim, InferenceEngine(model, **FLEET_ENGINE))
        cleared = watchdog.evaluate()
        seen = set()
        # prompts no replica holds warm: placed by load, the fresh replica first
        for prompt, budget in _engine_workload(model.vocab_size, FLEET_GROUPS):
            r = router.submit(prompt, budget)
            r.wait(HTTP_TIMEOUT_S)
            seen.add(r.replica)
        report = watchdog.report()
    k_exact, k_close = _same_tokens("kill", reqs, ref, plain, failures)
    kill = {"victim": victim, "redriven_by_kill": redriven, "redriven": stats["redriven"],
            "delivered": stats["tokens_delivered"],
            "generated": generated, "stale_tokens_dropped": stats["stale_tokens_dropped"],
            "fired": fired, "cleared": [a.rule for a in cleared],
            "fired_total": report["fired_total"], "cleared_total": report["cleared_total"],
            "freed_bytes": idle_before - idle_after, "arena_bytes": arena,
            "restored_serves": victim in seen,
            "exact_streams": k_exact, "within_margin_streams": k_close}
    if not stats["redriven"] >= 1:
        failures.append(f"the kill re-drove nothing ({redriven} from kill_replica, "
                        f"{stats['redriven']} in all)")
    if stats["tokens_delivered"] != generated - stats["stale_tokens_dropped"]:
        failures.append(f"kill: delivered {stats['tokens_delivered']} != generated "
                        f"{generated} less stale {stats['stale_tokens_dropped']}")
    if fired != [("replica_down", victim)] or cleared or \
            (report["fired_total"], report["cleared_total"]) != (1, 1):
        failures.append(f"replica_down fired {fired}, then {cleared}: {report}")
    if not released or idle_before - idle_after < arena - FLEET_ARENA_SLACK:
        failures.append(f"the killed replica freed {idle_before - idle_after} bytes, "
                        f"its arena held {arena}")
    if victim not in seen:
        failures.append(f"the restored {victim} took no placement")
    watchdog.release_telemetry()
    release(router, engines)

    med = {name: float(np.median([x["tokens_s"] for x in r])) for name, r in rows.items()}
    ttft = {name: float(np.median([x["ttft_s"]["p50"] for x in r])) for name, r in rows.items()}
    emit({"phase": "fleet", "config": CONFIGS["A"], "options": FLEET_ENGINE,
          "requests": len(workload), "groups": FLEET_GROUPS, "system_tokens": FLEET_SYSTEM,
          "min_affinity_tokens": FLEET_MIN_AFFINITY, "rounds": FLEET_ROUNDS,
          "tokens_s_median": med, "ttft_p50_s_median": ttft,
          "router_over_one_engine": med["router"] / med["one_engine"], "rows": rows,
          "round_robin": rr_row, "prefix_hits": hits, "placements": placements,
          "exact_streams": exact, "within_margin_streams": close,
          "drain": drain, "kill": kill, "launches": launches,
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"fleet check failed: {failures}")
    return launches


def _timed(obj, name, into):
    """Wrap ``obj.name`` to append each call's milliseconds to ``into``."""
    real = getattr(obj, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, call)


def _noisy(content, seed):
    rng = np.random.default_rng(seed)
    return [w + rng.normal(0.0, DEPLOY_NOISE, w.shape).astype(w.dtype) for w in content]


def _live_pushes(dev, models, shards, workload, ref, plain, counted, failures):
    """DEPLOY_GENERATIONS publications of the same content through a
    VersionLedger over a socket store of ``shards`` shards while the router
    serves the workload pass after pass, each replica's WeightSubscriber
    polling over the wire on its own thread. Gates: each replica applies
    each generation exactly once, every pass's tokens equal the one-engine
    reference (margin rule). Returns the row."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.deploy import VersionLedger, WeightSubscriber
    from elephas_tpu_torch.fleet import Router
    from elephas_tpu_torch.parameter.client import ShardedClient, SocketClient
    from elephas_tpu_torch.parameter.server import SocketServer
    from elephas_tpu_torch.parameter.sharding import ShardedServerGroup
    from elephas_tpu_torch.utils.weights import get_weights

    content = get_weights(models[0])
    journal = os.path.join(DEPLOY_DIR, f"shards{shards}")
    if shards == 1:
        store = SocketServer(content, mode="asynchronous", port=0, journal_dir=journal)
        store.start()
        clients = [SocketClient(master=f"127.0.0.1:{store.port}") for _ in models]
    else:
        store = ShardedServerGroup(SocketServer, content, shards, journal_dir=journal)
        store.start()
        clients = [ShardedClient(store.endpoints, store.shard_map, transport="socket")
                   for _ in models]
    engines = {f"replica-{i}": InferenceEngine(m, **FLEET_ENGINE) for i, m in enumerate(models)}
    pull_ms, apply_ms, publish_ms, applied = [], [], [], {n: [] for n in engines}
    for c in clients:
        _timed(c, "get_parameters", pull_ms)
    for name, e in engines.items():
        real = e.load_weights

        def load(weights, version=None, real=real, name=name):
            t0 = time.perf_counter()
            real(weights, version=version)
            apply_ms.append((time.perf_counter() - t0) * 1e3)
            applied[name].append(version)

        e.load_weights = load
    ledger = VersionLedger(store)
    subs = {n: WeightSubscriber(e, c) for (n, e), c in zip(engines.items(), clients)}
    router = Router(engines, min_affinity_tokens=FLEET_MIN_AFFINITY)
    passes, steady = [], None
    try:
        with router:
            reqs, steady = counted(lambda: _router_pass(router, workload, dev))
            _same_tokens(f"steady ({shards} shard(s))", reqs, ref, plain, failures)
            for s in subs.values():
                s.start(interval_s=DEPLOY_POLL_S)
            errors = []

            def publish():
                try:
                    for g in range(1, DEPLOY_GENERATIONS + 1):
                        t0 = time.perf_counter()
                        if ledger.publish(content) != g:
                            raise AssertionError(f"the ledger minted {ledger.version}, not {g}")
                        publish_ms.append((time.perf_counter() - t0) * 1e3)
                        deadline = time.monotonic() + HTTP_TIMEOUT_S
                        while any(s.applied_version < g for s in subs.values()):
                            if time.monotonic() > deadline:
                                raise AssertionError(f"generation {g} not applied: "
                                                     f"{[s.status() for s in subs.values()]}")
                            time.sleep(0.001)
                except BaseException as e:  # noqa: BLE001 — reported by the phase
                    errors.append(e)

            publisher = threading.Thread(target=publish, name="chip-smoke-publisher")
            publisher.start()
            while publisher.is_alive() or not passes:
                reqs, row = counted(lambda: _router_pass(router, workload, dev))
                passes.append(row)
                _same_tokens(f"during pushes ({shards} shard(s))", reqs, ref, plain, failures)
            publisher.join()
            for s in subs.values():
                s.stop()
            failures += [f"publisher ({shards} shard(s)): {e!r}" for e in errors]
    finally:
        for c in clients:
            c.close()
        store.stop()
        shutil.rmtree(journal, ignore_errors=True)
    for name, s in subs.items():
        want = list(range(1, DEPLOY_GENERATIONS + 1))
        if applied[name] != want or s.applies != DEPLOY_GENERATIONS or \
                engines[name].weight_version != DEPLOY_GENERATIONS:
            failures.append(f"{name} ({shards} shard(s)) applied {applied[name]} "
                            f"({s.status()}), want {want} once each")
    row = {"shards": shards, "generations": DEPLOY_GENERATIONS, "passes_during": len(passes),
           "publish_ms": publish_ms, "pull_ms": pull_ms, "apply_ms": apply_ms,
           "applied": applied, "skips": {n: s.skips for n, s in subs.items()},
           "steady": steady, "during": passes,
           "itl_p99_steady_s": steady["inter_token_s"]["p99"],
           "itl_p99_during_s": max(r["inter_token_s"]["p99"] for r in passes)}
    row["itl_p99_ratio"] = row["itl_p99_during_s"] / row["itl_p99_steady_s"]
    for obj in (router, ledger, *subs.values(), *engines.values()):
        obj.release_telemetry()
    return row


def _canary(dev, models, workload, ref, plain, counted, failures):
    """Two canary cycles through a CanaryController over the router's
    scraper (the slo_burn watchdog). The burn: a candidate of the weights
    plus seeded noise on the canary replica, an EngineStaller holding it
    past the requests' TTFT deadlines; gates: automatic rollback, every
    replica's tokens equal the baseline's after it, the watchdog fired once
    and cleared once. The clean window: a second noisy candidate promoted
    fleet-wide, its tokens equal a fresh engine's on those weights."""
    from elephas_tpu_torch import InferenceEngine, transformer_lm
    from elephas_tpu_torch.deploy import CanaryController, VersionLedger, WeightSubscriber
    from elephas_tpu_torch.fault import EngineStaller
    from elephas_tpu_torch.fleet import Router
    from elephas_tpu_torch.parameter.client import SocketClient
    from elephas_tpu_torch.parameter.server import SocketServer
    from elephas_tpu_torch.serving.policy import FairSharePolicy
    from elephas_tpu_torch.utils.weights import get_weights, set_weights

    content = get_weights(models[0])
    store = SocketServer(content, mode="asynchronous", port=0)
    store.start()
    clients = [SocketClient(master=f"127.0.0.1:{store.port}") for _ in models]
    engines = {name: InferenceEngine(m, **FLEET_ENGINE, policy=FairSharePolicy())
               for name, m in zip(("stable", "canary"), models)}
    ledger = VersionLedger(store)
    subs = {n: WeightSubscriber(e, c) for (n, e), c in zip(engines.items(), clients)}
    router = Router(engines, min_affinity_tokens=FLEET_MIN_AFFINITY)
    split = workload[:2 * FLEET_GROUPS]
    out = {}
    try:
        with router:
            ctrl = CanaryController(router, ledger, subs, canary=["canary"], share=0.5,
                                    window=DEPLOY_WINDOW)
            router.scraper.poll()
            ctrl.watchdog.evaluate()  # the burn rule's first look
            out["burn_candidate"] = ctrl.begin(_noisy(content, 1))
            reqs, _ = counted(lambda: _router_pass(router, split, dev,
                                                   ttft_deadline_ms=DEPLOY_GENEROUS_MS))
            out["canary_differs"] = sum(r.tokens != w.tokens for r, w in zip(reqs, ref)
                                        if r.replica == "canary")
            if not out["canary_differs"]:
                failures.append("the noisy candidate's tokens equal the baseline's")
            router.scraper.poll()
            if ctrl.evaluate() != "canary":
                failures.append(f"met deadlines concluded the canary: {ctrl.status()}")
            router.set_canary(["canary"], 1.0)
            with EngineStaller(engines["canary"]):
                burn = [router.submit(p, b, ttft_deadline_ms=DEPLOY_DEADLINE_MS)
                        for p, b in split]
                time.sleep(DEPLOY_STALL_S)
            if not all(r.wait(HTTP_TIMEOUT_S) for r in burn):
                failures.append("the burn's requests did not finish")
            router.scraper.poll()
            state = ctrl.evaluate()
            router.scraper.poll()
            ctrl.watchdog.evaluate()
            report = ctrl.watchdog.report()
            out["burn"] = {"state": state, "outcome": ctrl.last_outcome,
                           "fired_total": report["fired_total"],
                           "cleared_total": report["cleared_total"],
                           "rollback_generation": ledger.version,
                           "applied": {n: s.applied_version for n, s in subs.items()}}
            if state != "idle" or ctrl.last_outcome != "rolled_back" or \
                    (report["fired_total"], report["cleared_total"]) != (1, 1) or \
                    any(s.applied_version != ledger.version for s in subs.values()):
                failures.append(f"the burn: {out['burn']}")
            reqs, _ = counted(lambda: _router_pass(router, workload, dev))
            out["after_rollback"] = _same_tokens("after the rollback", reqs, ref, plain,
                                                 failures)

            clean = _noisy(content, 2)
            out["clean_candidate"] = ctrl.begin(clean)
            reqs, _ = counted(lambda: _router_pass(router, split, dev,
                                                   ttft_deadline_ms=DEPLOY_GENEROUS_MS))
            for _ in range(DEPLOY_WINDOW):
                router.scraper.poll()
                ctrl.evaluate()
            out["clean"] = {"outcome": ctrl.last_outcome, "state": ctrl.state,
                            "applied": {n: s.applied_version for n, s in subs.items()}}
            if ctrl.last_outcome != "promoted" or any(
                    e.weight_version != out["clean_candidate"] for e in engines.values()):
                failures.append(f"the clean window: {out['clean']}")
            promoted, _ = counted(lambda: _router_pass(router, workload, dev))
    finally:
        for c in clients:
            c.close()
        store.stop()
    fresh = transformer_lm(**CONFIGS["A"], seed=0, device=dev)
    set_weights(fresh, clean)
    want, fresh_plain, _ = _fleet_reference(dev, fresh, workload, failures)
    out["promoted_tokens"] = _same_tokens("promoted", promoted, want, fresh_plain, failures)
    del fresh, fresh_plain
    for obj in (ctrl, ctrl.watchdog, router, ledger, *subs.values(), *engines.values()):
        obj.release_telemetry()
    return out


def _shard_kill_mid_deployment(dev, models, failures):
    """A ShardKiller kills one of two journaled shards between two
    publications through a DeployChaosStore: the publication past the dead
    shard lands on the live one, subscribers skip (a wire error, then the
    mixed cut of the restarted shard), and the next publication converges
    both replicas; each applies each generation it applies once."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.deploy import VersionLedger, WeightSubscriber
    from elephas_tpu_torch.fault import DeployChaosStore, ShardedRestartablePS, ShardKiller
    from elephas_tpu_torch.parameter.client import ShardedClient
    from elephas_tpu_torch.parameter.server import SocketServer
    from elephas_tpu_torch.utils.weights import get_weights

    content = get_weights(models[0])
    journal = os.path.join(DEPLOY_DIR, "chaos")
    ps = ShardedRestartablePS(SocketServer, content, 2, journal_dir=journal, journal_every=1)
    clients, subs, out = {}, {}, {}
    engines = {f"replica-{i}": InferenceEngine(m, **FLEET_ENGINE) for i, m in enumerate(models)}
    applied = {n: [] for n in engines}
    try:
        store = DeployChaosStore(ps)
        ledger = VersionLedger(store)
        for name, e in engines.items():
            real = e.load_weights
            e.load_weights = (lambda w, version=None, real=real, name=name: (
                applied[name].append(version), real(w, version=version)))
            clients[name] = ShardedClient(ps.endpoints, ps.shard_map, transport="socket",
                                          client_id=name, retries=1)
            subs[name] = WeightSubscriber(e, clients[name])
        g1 = ledger.publish(content)
        polls = {"g1": [s.poll_once() for s in subs.values()]}
        killer = ShardKiller(ps, 0, after_updates=0, restart_delay_s=DEPLOY_RESTART_S)
        killer.start()
        deadline = time.monotonic() + HTTP_TIMEOUT_S
        while not ps.kills[0]:
            if time.monotonic() > deadline:
                raise AssertionError("the ShardKiller never fired")
            time.sleep(0.001)
        g2 = ledger.publish(_noisy(content, 3))
        polls["outage"] = [s.poll_once() for s in subs.values()]
        while not ps.restarts[0]:
            if time.monotonic() > deadline:
                raise AssertionError("the killed shard never restarted")
            time.sleep(0.005)
        polls["mixed"] = [s.poll_once() for s in subs.values()]
        converged_before = ledger.status()["converged"]
        g3 = ledger.publish(content)
        polls["g3"] = [s.poll_once() for s in subs.values()]
        polls["again"] = [s.poll_once() for s in subs.values()]
        killer.cancel()
        killer.join(timeout=30)
        out = {"generations": [g1, g2, g3], "polls": polls, "applied": applied,
               "skips": {n: s.skips for n, s in subs.items()},
               "kills": list(ps.kills), "restarts": list(ps.restarts),
               "converged_before": converged_before,
               "converged": ledger.status()["converged"],
               "updates_duplicate": ps.counters()["updates_duplicate"]}
        want = {"g1": [g1, g1], "outage": [None, None], "mixed": [None, None],
                "g3": [g3, g3], "again": [None, None]}
        if polls != want or any(v != [g1, g3] for v in applied.values()) or \
                converged_before or not out["converged"] or out["updates_duplicate"] or \
                any(s.skips["wire_error"] < 1 or s.skips["mixed_cut"] < 1
                    for s in subs.values()):
            failures.append(f"shard kill mid-deployment: {out}")
        for obj in (ledger, *subs.values()):
            obj.release_telemetry()
    finally:
        for c in clients.values():
            c.close()
        ps.stop()
        shutil.rmtree(journal, ignore_errors=True)
    for e in engines.values():
        e.release_telemetry()
    return out


def _migration_across_generations(dev, model, workload, ref, plain, failures):
    """A warm record exported from a paged engine at generation 5 is refused
    by one at 7, and accepted (continuing token-exact) once it is re-stamped
    at 5."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.fleet import decode_record, encode_record

    a, b = InferenceEngine(model, **FLEET_ENGINE), InferenceEngine(model, **FLEET_ENGINE)
    a.refresh_weights(version=5)
    b.refresh_weights(version=7)
    # a request of the second wave with the longer budget: still decoding
    # after the first step's window
    i = next(j for j in range(FLEET_GROUPS, len(workload))
             if workload[j][1] == max(ENGINE_BUDGETS))
    prompt, budget = workload[i]
    req = a.submit(prompt, budget)
    while len(req.tokens) < 2:
        a.step()
    record = decode_record(encode_record(a.export_request(req.rid)))
    out = {"record_weight_ver": record["weight_ver"], "warm_blocks": record["n_blocks"]}
    try:
        b.import_request(record)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    b.refresh_weights(version=5)
    moved = b.import_request(record)
    b.run()
    out["accepted_tokens"] = len(moved.tokens)
    exact, close = _same_tokens("migrated across generations", [moved], [ref[i]],
                                plain[i:i + 1], failures)
    out["exact"], out["within_margin"] = exact, close
    if record["weight_ver"] != 5 or not record["n_blocks"] or \
            "weight_ver" not in (out["refused"] or ""):
        failures.append(f"migration across generations: {out}")
    a.release_telemetry()
    b.release_telemetry()
    return out


def phase_deploy(dev, model):
    """Train-while-serving at config A's full width: two paged replicas on
    their own copies of ``model``'s weights behind a Router. Live pushes
    through a VersionLedger over a socket store of one shard, then two
    (_live_pushes); a canary rolled back by an slo_burn, then one promoted
    (_canary); a shard killed mid-deployment (_shard_kill_mid_deployment);
    a warm record across generations (_migration_across_generations).
    Prints publication, pull and apply milliseconds and p99 ITL during
    pushes against steady state. Returns the launches of the routed runs."""
    from elephas_tpu_torch import transformer_lm
    from elephas_tpu_torch.utils.weights import get_weights, set_weights

    failures = []
    launches, counted = _counting(dev)
    content = get_weights(model)
    second = transformer_lm(**CONFIGS["A"], seed=0, device=dev)
    set_weights(second, content)
    models = [model, second]
    workload = _fleet_workload(model.vocab_size)
    ref, plain, _ = _fleet_reference(dev, model, workload, failures)
    os.makedirs(DEPLOY_DIR, exist_ok=True)
    pushes = [_live_pushes(dev, models, n, workload, ref, plain, counted, failures)
              for n in DEPLOY_SHARDS]
    canary = _canary(dev, models, workload, ref, plain, counted, failures)
    # the canary left its promoted candidate in both modules: back to the content
    for m in models:
        set_weights(m, content)
    chaos = _shard_kill_mid_deployment(dev, models, failures)
    migration = _migration_across_generations(dev, model, workload, ref, plain, failures)
    emit({"phase": "deploy", "config": CONFIGS["A"], "options": FLEET_ENGINE,
          "pushes": pushes, "canary": canary, "shard_kill": chaos, "migration": migration,
          "launches": launches, "nvidia_smi": nvidia_smi(), "failures": failures})
    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    if failures:
        raise AssertionError(f"deploy check failed: {failures}")
    return launches


def _paged_row(fs, decode, q, pk, pv, scales, tables, pos, dt):
    """One paged kernel, its plain version and SDPA with a boolean mask over
    the span gathered and dequantized beforehand (the library yardstick:
    no one PyTorch call reads through a table), eager and from CUDA graphs,
    beside the gather-and-dequantize time (``gather_ms``, ``gather_device_ms``)
    and the bound: bytes of the visible keys' codes (or fp rows) and scales
    read once (each table row up to its deepest position), the tables, q,
    out and the positions; operations, 4 per visible key and dim of every
    row (the decode at fp32 FMA's rate, the chunk at 3xTF32's)."""
    from torch.nn.functional import scaled_dot_product_attention

    fn = fs.flash_paged_span_decode if decode else fs.flash_paged_span_chunk
    plain = fs.paged_span_decode_reference if decode else fs.paged_span_chunk_reference
    kw = dict(kv_dtype=dt, kv_scales=scales)
    d = q.shape[-1]
    b, h = q.shape[:2]
    c = 1 if decode else q.shape[2]
    gk, gv = fs.paged_dense_span(pk, pv, tables, dt, scales, d)
    span = gk.shape[1]
    q4 = q[:, :, None] if decode else q
    pm = pos[:, None] if decode else pos
    k4, v4 = gk.transpose(1, 2), gv.transpose(1, 2)
    mask = (torch.arange(span, device=q.device)[None, None, :] <= pm[:, :, None])[:, None] \
        .expand(b, h, c, span)
    fns = {
        "ms": lambda: fn(q, pk, pv, tables, pos, **kw),
        "plain_ms": lambda: plain(q, pk, pv, tables, pos, **kw),
        "library_ms": lambda: scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
        "gather_ms": lambda: fs.paged_dense_span(pk, pv, tables, dt, scales, d),
    }
    samples = _time_in_turns(fns)
    graphs = _time_in_turns({k: fns[k] for k in ("ms", "library_ms", "gather_ms")}, graphs=True)
    samples.update({key[:-2] + "device_ms": t for key, t in graphs.items()})
    visible = torch.clamp(pm.long() + 1, min=0, max=span)  # [B, C]
    keys_read = int(visible.amax(dim=1).sum())
    stored = pk.shape[-1] * pk.element_size()  # bytes of a stored head row
    per_key = 2 * h * (stored + (0 if scales is None else 4))
    nbytes = keys_read * per_key + tables.numel() * 4 + 2 * b * h * c * d * 4 + pm.numel() * 4
    flops = 4 * int(visible.sum()) * h * d
    peak = PEAK_FLOPS_S[torch.float32] if decode else PEAK_3XTF32_S
    return {**_summary(samples, nbytes, flops, torch.float32, peak),
            "shape": {"B": b, "H": h, "D": d, "C": c, "span": span,
                      "block": pk.shape[1], "kv_dtype": dt},
            "keys_read": keys_read,
            "splits_chunk": (fs.span_splits(span, b * h, fs._sm_count(q.device.index))
                             if decode else fs.span_chunk_splits(
                                 span, b * h, c, d, fs._sm_count(q.device.index)))}


def phase_times_paged(dev):
    """Each paged kernel and stored type at the shapes of _paged_cases
    (_paged_row): the decode at the engine's shape over spans 128-512, the
    chunk at the paged engine's one-row launch (64 rows ending on the span's
    last row) and at the verify window (VERIFY_W rows on 16 slots) over spans
    128-512, at a 512-row chunk from position 0 and,
    once engine_paged has run, at the engines' most frequent launch shape
    (ENGINE_CHUNK_SHAPES) with the positions they gave it."""
    from elephas_tpu_torch.ops import flash_serving as fs

    rows = {}
    for kernel, name, dt, inputs in _paged_cases():
        # the chunk's 16-slot, block-1 and 16-split cases are gated, not
        # timed; its verify window is timed
        timed = kernel == "paged_span_decode" or name.endswith("offset0") or (
            name.startswith(f"{dt}_B1_C64_span")
            and not name.endswith(f"span{PAGED_OVER_CLUSTER}")) or (
            name.startswith(f"{dt}_B16_C{VERIFY_W}_span"))
        if not timed:
            continue
        q, pk, pv, scales, tables, pos = inputs(dev)
        rows[f"{kernel}_{name}"] = _paged_row(fs, kernel == "paged_span_decode", q, pk, pv,
                                              scales, tables, pos, dt)
        del q, pk, pv, scales, tables, pos
    if ENGINE_CHUNK_SHAPES:
        # the engines' most frequent chunk launch, at the positions it was
        # first given, over a pool of random rows
        (b, c, span), n = ENGINE_CHUNK_SHAPES.most_common(1)[0]
        _, h, d, bs = PAGED_CASE
        for dt in PAGED_DTYPES:
            pk, pv, scales, tables = _paged_pool(b, h, d, bs, span // bs, dt, dev, span + c)
            g = torch.Generator(device=dev).manual_seed(c)
            q = torch.randn(b, h, c, d, generator=g, device=dev)
            pos = ENGINE_CHUNK_POSITIONS[(b, c, span)].to(dev)
            row = _paged_row(fs, False, q, pk, pv, scales, tables, pos, dt)
            rows[f"paged_span_chunk_{dt}_engine_B{b}_C{c}_span{span}"] = {
                **row, "engine_launches": n, "positions": [int(pos.min()), int(pos.max())]}
            del q, pk, pv, scales, tables, pos
    emit({"phase": "times", "kernel": "paged_span_decode, paged_span_chunk",
          "timing": GRAPH_TIMING, **rows})
    return rows


# -- the Switch mixture-of-experts family ----------------------------------------


def _moe_case(dev, t, d, h, cf, seed=0):
    """One MOE_CASES input: ``x`` ``[t, d]``, the reference initializer's
    weights with biases drawn too (the reference's are zero), and the
    capacity."""
    from elephas_tpu_torch.ops import moe

    gen = torch.Generator(device=dev).manual_seed(seed)
    gate, w1, _, w2, _ = moe.init_moe_params(gen, d, h, MOE_EXPERTS)
    b1 = 0.1 * torch.randn(MOE_EXPERTS, h, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(MOE_EXPERTS, d, generator=gen, device=dev)
    x = torch.randn(t, d, generator=gen, device=dev)
    return x, (gate, w1, b1, w2, b2), moe.capacity_for(t, MOE_EXPERTS, cf, MOE_K)


def _kept_keys(experts, positions, capacity):
    """The kept routings of topk_route as sorted keys (token·E + expert)·C +
    place."""
    tok = torch.arange(experts.shape[1], device=experts.device).expand_as(experts)
    keys = (tok * MOE_EXPERTS + experts.long()) * capacity + positions.long()
    return torch.sort(keys[positions < capacity]).values


def _kernel_moe(dev):
    """moe_ffn (the main path's index route) against moe_ffn_reference (the
    dense plain version) at MOE_CASES: the kept routing equal, outputs and
    aux within TOL_MOE_OUT of max(1, |·|), the gradients of sum(out²) + aux
    in x and every weight within TOL_MOE_GRAD of each tensor's largest."""
    from elephas_tpu_torch.ops import moe

    gelu = torch.nn.functional.gelu
    rows, failures = [], []
    for name, t, d, h, cf in MOE_CASES:
        x, params, capacity = _moe_case(dev, t, d, h, cf)
        xs = [a.clone().requires_grad_() for a in (x, *params)]
        out, aux = moe.moe_ffn(*xs, capacity, MOE_K, gelu, return_aux=True)
        ref, ref_aux = moe.moe_ffn_reference(*xs, cf, gelu, k=MOE_K, return_aux=True)
        grads = torch.autograd.grad((out ** 2).sum() + aux, xs)
        want = torch.autograd.grad((ref ** 2).sum() + ref_aux, xs)
        with torch.no_grad():
            experts, positions, _, _ = moe.topk_route(x, params[0], MOE_EXPERTS, capacity,
                                                      MOE_K)
            dense = torch.nonzero(moe._topk_dispatch(x, params[0], MOE_EXPERTS, capacity,
                                                     MOE_K)[0])
            want_keys = torch.sort((dense[:, 0] * MOE_EXPERTS + dense[:, 1]) * capacity
                                   + dense[:, 2]).values
            got_keys = _kept_keys(experts, positions, capacity)
        row = {"case": name, "tokens": t, "d_model": d, "expert_hidden": h,
               "capacity_factor": cf, "capacity": capacity, "kept": got_keys.numel(),
               "dropped": MOE_K * t - got_keys.numel(),
               "routing_equal": torch.equal(got_keys, want_keys),
               "out_err_of_max_1_abs": ((out - ref).abs().max()
                                        / ref.abs().max().clamp_min(1.0)).item(),
               "aux_err": abs(aux.item() - ref_aux.item()),
               "grad_max_rel_err": max(_rel(g, w) for g, w in zip(grads, want))}
        rows.append(row)
        if not row["routing_equal"] or row["out_err_of_max_1_abs"] > TOL_MOE_OUT or \
                row["aux_err"] > TOL_MOE_OUT or row["grad_max_rel_err"] > TOL_MOE_GRAD:
            failures.append(f"moe_ffn {name}: {row}")
        del x, params, xs, out, ref, grads, want, dense
    return rows, failures


@contextlib.contextmanager
def _annotated_moe():
    """Every MoeFFN forward inside a ``moe_ffn`` record_function range, for
    the profiler."""
    from elephas_tpu_torch.models.switch import MoeFFN

    inner = MoeFFN.forward

    def forward(self, *args, **kwargs):
        with torch.profiler.record_function("moe_ffn"):
            return inner(self, *args, **kwargs)

    MoeFFN.forward = forward
    try:
        yield
    finally:
        MoeFFN.forward = inner


def _device_us(ev):
    dt = getattr(ev, "device_time_total", None)
    return ev.cuda_time_total if dt is None else dt


def _annotation_ms(prof, name, per):
    """Device ms, each divided by ``per``, of the kernels launched inside the
    record_function ranges called ``name`` (forward), and of the backward
    of the ops made there (the autograd nodes with those ops' sequence
    numbers)."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = [ev for ev in events if ev.name == name and ev.device_type == DeviceType.CPU]
    seqs = set()

    def walk(ev):
        for child in ev.cpu_children:
            if getattr(child, "sequence_nr", -1) >= 0:
                seqs.add(child.sequence_nr)
            walk(child)

    for ev in ranges:
        walk(ev)
    backward = [ev for ev in events if ev.name.startswith("autograd::engine::evaluate_function")
                and getattr(ev, "sequence_nr", -1) in seqs]
    return {"name": name, "calls": len(ranges) / per,
            "forward_device_ms": sum(_device_us(ev) for ev in ranges) / 1e3 / per,
            "backward_device_ms": sum(_device_us(ev) for ev in backward) / 1e3 / per,
            "backward_nodes": len(backward) / per}


def _moe_share(out):
    """The MoE layers' share of a profile's device time (forward and, in a
    training step, backward), or None where the profiler saw no device
    time."""
    ann = out.get("annotation")
    if not out["device_ms"] > 0 or not ann:
        return None
    return (ann["forward_device_ms"] + ann["backward_device_ms"]) / out["device_ms"]


def _switch_logits(model, rows, plain):
    """Teacher-forced logits of ``rows`` through the kernels or the plain
    path, SWITCH_PLAIN_ROWS rows a forward."""
    with torch.inference_mode():
        return torch.cat([model(rows[i:i + SWITCH_PLAIN_ROWS], plain=plain)
                          for i in range(0, len(rows), SWITCH_PLAIN_ROWS)])


def _sequence_rows(seqs, maxlen, dev):
    rows = torch.zeros(len(seqs), maxlen, dtype=torch.long, device=dev)
    for i, seq in enumerate(seqs):
        rows[i, :len(seq)] = torch.tensor([int(t) for t in seq], device=dev)
    return rows


def _check_a_rows(plain, prompt_lens, seqs):
    """Check (a) over plain logits ``[n, maxlen, vocab]``: the emitted tokens
    of ``seqs`` (prompt + generated) that differ from the plain argmax where
    its top-2 margin is >= MARGIN, and those within it."""
    mismatches = close = 0
    for i, (p, seq) in enumerate(zip(prompt_lens, seqs)):
        pos = slice(p - 1, len(seq) - 1)
        top2 = plain[i, pos].topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        emitted = torch.tensor([int(t) for t in seq[p:]], device=plain.device)
        wrong = plain[i, pos].argmax(dim=-1) != emitted
        mismatches += int((wrong & (margin >= MARGIN)).sum())
        close += int((wrong & (margin < MARGIN)).sum())
    return mismatches, close


def _cached_generate(model, workload):
    """generate(kv_cache=True)'s new tokens for each request of
    ``workload``, the requests of one prompt length and budget in one call."""
    from elephas_tpu_torch import generate

    groups = {}
    for i, (prompt, budget) in enumerate(workload):
        groups.setdefault((len(prompt), budget), []).append(i)
    out = [None] * len(workload)
    for (p, budget), idx in groups.items():
        tokens = generate(model, np.stack([workload[i][0] for i in idx]), budget, kv_cache=True)
        for i, row in zip(idx, tokens):
            out[i] = row[p:].tolist()
    return out


def _against(reqs, want, plain):
    """Requests whose tokens differ from ``want`` (token lists) where the
    plain path's top-2 margin is >= MARGIN (faults), and those that differ
    at all."""
    faults, differ = [], []
    for i, (r, w) in enumerate(zip(reqs, want)):
        if r.tokens == w:
            continue
        differ.append(i)
        p = len(r.prompt)
        bad = _first_divergence(r.tokens, w, lambda j, i=i, p=p: plain[i, p - 1 + j])
        if bad:
            faults.append(f"request {i}: {bad}")
    return faults, differ


def _profile_moe_window(dev, model, what):
    """One decode window of E's engine over ``model`` (16 busy slots, 16
    steps) under torch.profiler after a warm-up window, the MoE layers
    annotated: per step, the device time by class and the MoE layers'."""
    from elephas_tpu_torch import InferenceEngine

    steps = ENGINE["steps_per_sync"]
    engine = InferenceEngine(model, **ENGINE)
    for prompt, _ in _engine_workload(model.vocab_size, ENGINE["num_slots"]):
        engine.submit(prompt, 4 * steps)
    engine.step()  # prefill and the warm-up window
    with _annotated_moe():
        out = _profile(dev, engine.step, f"engine decode window at {what}, "
                       f"{ENGINE['num_slots']} slots, per step of {steps}", per=steps,
                       annotation="moe_ffn")
    if len(engine.scheduler.active) != ENGINE["num_slots"]:
        raise AssertionError("a request of the profiled window finished early")
    return out


def phase_switch_serve(dev, dense):
    """SW-A, the Switch LM's serving path (see the module docstring, 6k).
    ``dense`` is config A's LM (the engine phase's), E's engine over which
    runs in turns with SW-A's. Returns the launches of the served runs."""
    from elephas_tpu_torch import InferenceEngine, generate, switch_transformer_lm

    model = switch_transformer_lm(**SWITCH_A, seed=0, device=dev)
    layers, vocab, maxlen = SWITCH_A["num_layers"], SWITCH_A["vocab_size"], SWITCH_A["maxlen"]
    prompts = _prompts(vocab)
    workload = _engine_workload(vocab, ENGINE_REQUESTS)
    warm, chunked_workload = _chunked_workload(vocab)
    options = {"fixed": {}, "paged": ENGINE_PAGED, "paged_int8": dict(ENGINE_PAGED, kv_dtype="int8"),
               "chunked": CHUNKED, "speculative": dict(speculative=True, spec_k=SPEC_K)}
    engines = {name: InferenceEngine(model, **ENGINE, **kw) for name, kw in options.items()}
    naive_int8 = InferenceEngine(model, **ENGINE, **options["paged_int8"], attention="naive")
    dense_engine = InferenceEngine(dense, **ENGINE)
    for name, engine in [*engines.items(), ("naive", naive_int8), ("dense", dense_engine)]:
        engine.run(workload[: ENGINE["num_slots"]])
        if name == "chunked":
            for requests in warm:
                engine.run(requests)
    failures = []

    # the main path, counted: generate with and without the cache, then
    # each engine's pass and the rounds in turns with E
    _reset_launches()
    launches, counted = _counting(dev)
    gen = {}
    for name, kw in (("full", {}), ("cached", {"kv_cache": True})):
        outs, seconds = [], 0.0
        for prompt in prompts:
            steps = STEPS if not kw else len(prompt) + STEPS - 1
            before = _launches()
            t0 = time.perf_counter()
            outs.append(counted(lambda p=prompt, kw=kw: generate(model, p[None], STEPS, **kw))[0])
            seconds += time.perf_counter() - t0
            _check_launches(f"SW-A generate {name}", before, {
                "flash_fwd": 0 if kw else layers * STEPS,
                "span_decode": layers * steps if kw else 0,
                "layer_norm_fwd": (2 * layers + 1) * steps, "layer_norm_bwd": 0})
        gen[name] = {"tokens": outs, "seconds": seconds}
    served = {name: counted(lambda e=engine, n=name: _serve_pass(
        e, chunked_workload if n == "chunked" else workload, dev))
        for name, engine in engines.items()}
    turns = {"A": [], "SW-A": []}
    for _ in range(SWITCH_ROUNDS):
        turns["A"].append(_serve_pass(dense_engine, workload, dev)[1])
        turns["SW-A"].append(counted(lambda: _serve_pass(engines["fixed"], workload, dev))[1])
    launches = dict(launches)
    for path, kernels in (("generate", ("flash_fwd", "span_decode")),
                          ("engines", ("span_chunk", "paged_span_chunk", "paged_span_decode",
                                       "layer_norm_fwd"))):
        idle = [k for k in kernels if not launches[k] > 0]
        if idle:
            failures.append(f"the SW-A {path} path never launched {idle}")

    # checks: generate against the plain path and the cache
    rows = _sequence_rows(gen["full"]["tokens"], maxlen, dev)
    kern, plain = _switch_logits(model, rows, False), _switch_logits(model, rows, True)
    checks = {"generate_logits_max_abs_err": (kern - plain).abs().max().item()}
    if not checks["generate_logits_max_abs_err"] <= TOL_LOGITS or not torch.isfinite(kern).all():
        failures.append(f"generate logits vs plain: {checks['generate_logits_max_abs_err']}")
    lens = [len(p) for p in prompts]
    checks["generate_a"] = _check_a_rows(plain, lens, gen["full"]["tokens"])
    cached_faults = [
        bad for i, (p, full, cached) in enumerate(zip(lens, gen["full"]["tokens"],
                                                       gen["cached"]["tokens"]))
        if (bad := _first_divergence(cached[p:].tolist(), full[p:].tolist(),
                                     lambda j, i=i, p=p: plain[i, p - 1 + j]))]
    checks["cached_vs_full_faults"] = cached_faults
    if checks["generate_a"][0] or cached_faults:
        failures.append(f"generate: check (a) {checks['generate_a']}, cache {cached_faults}")
    del kern, plain

    # every engine against generate(kv_cache=True) and check (a); the int8
    # engine's flash against its naive twin on the quantized oracle, as E-quant
    want = _cached_generate(model, workload)
    for name, (reqs, _row) in served.items():
        seqs = [r.full_sequence for r in reqs]
        rows = _sequence_rows(seqs, maxlen, dev)
        plain = _switch_logits(model, rows, True)
        if name == "fixed":
            kern = _switch_logits(model, rows, False)
            checks["engine_logits_max_abs_err"] = (kern - plain).abs().max().item()
            if not checks["engine_logits_max_abs_err"] <= TOL_LOGITS:
                failures.append(f"engine logits vs plain: {checks['engine_logits_max_abs_err']}")
            del kern
        if name == "paged_int8":
            naive, _ = _serve_pass(naive_int8, workload, dev)
            cache = {}

            def oracle(seq, cache=cache):
                key = tuple(seq)
                if key not in cache:
                    cache[key] = _quant_logits(model, seq, "int8", dev)
                return cache[key]

            faults, differ = _tokens_agree(reqs, naive, oracle)
            checks["paged_int8_vs_naive"] = {"faults": faults, "differ": differ}
            failures += [f"SW-A int8 flash vs naive: {f}" for f in faults]
            continue
        if name == "chunked":
            base, _ = _serve_pass(engines["fixed"], chunked_workload, dev)
            faults, differ = _against(reqs, [r.tokens for r in base], plain)
        else:
            faults, differ = _against(reqs, want, plain)
        a = _check_a_rows(plain, [len(r.prompt) for r in reqs], seqs)
        checks[name] = {"a_token_mismatches": a[0], "a_within_margin": a[1],
                        "faults": faults, "differ": differ}
        failures += [f"SW-A {name}: {f}" for f in faults]
        if a[0]:
            failures.append(f"SW-A {name}: check (a) {a[0]} emitted tokens differ")
        del plain

    # synchronizing calls of one E run: SW-A's against config A's
    _prime_sync_count(dev)
    syncs = {"SW-A": _count_syncs(lambda: engines["fixed"].run(workload), dev),
             "A": _count_syncs(lambda: dense_engine.run(workload), dev)}
    if syncs["SW-A"] != syncs["A"]:
        failures.append(f"synchronizing calls a run: SW-A {dict(syncs['SW-A'])}, "
                        f"A {dict(syncs['A'])}")

    window = _profile_moe_window(dev, model, "SW-A")
    tps = {k: float(np.median([r["tokens_s"] for r in rs])) for k, rs in turns.items()}
    ttft = {k: float(np.median([r["ttft_s"]["p50"] for r in rs])) for k, rs in turns.items()}
    out = {"phase": "switch_serve", "config": SWITCH_A,
           "parameters": sum(p.numel() for p in model.parameters()),
           "launches": launches,
           "generate_tokens_s": {k: len(prompts) * STEPS / g["seconds"] for k, g in gen.items()},
           "engines": {name: row for name, (_reqs, row) in served.items()},
           "turns": turns, "tokens_s_median": tps, "ttft_p50_median": ttft,
           "sw_a_over_a_tokens_s": tps["SW-A"] / tps["A"],
           "sw_a_over_a_ttft_p50": ttft["SW-A"] / ttft["A"],
           "syncs_per_run": {k: sum(c.values()) for k, c in syncs.items()},
           "sync_lines": {k: dict(c) for k, c in syncs.items()},
           "moe_share_of_decode_window": _moe_share(window),
           "decode_window": {k: window.get(k) for k in ("wall_ms", "device_ms", "idle_share",
                                                        "annotation")},
           "checks": checks, "nvidia_smi": nvidia_smi(), "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"switch_serve check failed: {failures}")
    return launches


def _expert_fractions(model, x):
    """Each layer's first-choice expert fractions over ``x``'s tokens (the
    routers' real inputs, read by forward pre-hooks on the MoE layers)."""
    from elephas_tpu_torch.ops.moe import topk_route

    inputs = []
    hooks = [blk.moe.register_forward_pre_hook(lambda _m, args: inputs.append(args[0]))
             for blk in model.blocks]
    fractions = []
    try:
        with torch.inference_mode():
            model(x)
            for blk, h in zip(model.blocks, inputs):
                moe = blk.moe
                tokens = h.reshape(-1, h.shape[-1])
                first = topk_route(tokens, moe.gate_kernel, moe.num_experts, 1, moe.k)[0][0]
                counts = torch.bincount(first.long(), minlength=moe.num_experts)
                fractions.append((counts.float() / tokens.shape[0]).tolist())
    finally:
        for hook in hooks:
            hook.remove()
    return fractions


def _labelled_tokens(n, maxlen, vocab, seed=0):
    """tests/test_moe.py's ``_token_blobs`` at ``vocab`` and ``maxlen``: a
    row of label 1 draws 80 % of its tokens from the upper half of the
    vocabulary, a row of label 0 20 %."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    half = vocab // 2
    hi = rng.integers(half, vocab, size=(n, maxlen))
    lo = rng.integers(1, half, size=(n, maxlen))
    mask = rng.random((n, maxlen)) < np.where(y[:, None] == 1, 0.8, 0.2)
    return np.where(mask, hi, lo).astype(np.int32), y


def _switch_gradient_check(model, x, y):
    """:func:`_gradient_check` for a Switch model, three passes: through the
    kernels, through the plain path routing on its own, and through the
    plain path with every layer's expert choices pinned to the kernel
    pass's (its gates from its own router). Routing is an argmax: where the
    kernels' last-bit differences move a token across a near tie, the two
    paths compute a different function of the weights, so the gate reads
    the pinned pass; the free pass's error and the tokens whose choices
    differ are reported beside it. Returns (pinned errors, scales, free
    errors, choices that differ per layer)."""
    from elephas_tpu_torch.ops import moe
    from elephas_tpu_torch.training import auxiliary_losses

    spec = model.training_spec
    real = moe._choose
    grads, choices = {}, {}

    def recording(probs, num_experts, k):
        out = real(probs, num_experts, k)
        choices[current].append(torch.stack(out[0]))
        return out

    def pinned(probs, num_experts, k):
        picks = list(choices["kernel"][len(choices["pinned"])])
        choices["pinned"].append(torch.stack(picks))
        return picks, moe._gates(probs, picks)

    model.train()
    try:
        for current, plain, choose in (("kernel", False, recording), ("free", True, recording),
                                       ("pinned", True, pinned)):
            choices[current] = []
            moe._choose = choose
            model.zero_grad(set_to_none=True)
            with auxiliary_losses() as aux:
                out = model(x, plain=plain)
            (spec.loss(y, out).mean() + torch.stack(aux).sum()).backward()
            grads[current] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    finally:
        moe._choose = real
        model.zero_grad(set_to_none=True)
        model.eval()
    differ = [int((a != b).any(dim=0).sum()) for a, b in zip(choices["kernel"], choices["free"])]

    def errs(other):
        return {n: _rel(grads["kernel"][n], g) for n, g in grads[other].items()}

    scales = {n: g.abs().max().item() for n, g in grads["pinned"].items()}
    return errs("pinned"), scales, errs("free"), differ


def phase_switch_train(dev, t_line):
    """SW-T, the Switch classifier's training path (see the module
    docstring, 6l). ``t_line`` is phase train's fp32 line (T's tokens/s).
    Returns the launches of the fits."""
    from elephas_tpu_torch import SparkModel, switch_transformer_classifier, worker
    from elephas_tpu_torch.device import force_devices
    from elephas_tpu_torch.models import switch as sw
    from elephas_tpu_torch.training import auxiliary_losses

    x, y = _labelled_tokens(TRAIN_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"])
    layers = SWITCH_T["num_layers"]
    norms = 2 * layers + 1
    failures = []

    def build():
        return switch_transformer_classifier(**SWITCH_T, seed=0, device=dev)

    model = build()
    grad_err, grad_scale, free_err, flips = _switch_gradient_check(
        model, torch.from_numpy(x[:SWITCH_GRAD_ROWS]).long().to(dev),
        torch.from_numpy(y[:SWITCH_GRAD_ROWS]).long().to(dev))
    worst = max(grad_err, key=grad_err.get)
    free_worst = max(free_err, key=free_err.get)
    if grad_err[worst] > TOL_GRAD:
        failures.append(f"gradient of {worst}: kernel vs plain {grad_err[worst]}")
    vanished = [n for n, v in grad_scale.items() if not v > 0]
    if vanished:
        failures.append(f"all-zero gradients, the check is vacuous for {vanished}")

    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_BATCH)
    real_add_loss, added = sw.add_loss, []

    def recording(value):
        added.append(value.detach())
        real_add_loss(value)

    sm = SparkModel(model, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    launches, counted = _counting(dev)
    sw.add_loss = recording
    try:
        history, step_s = counted(lambda: _timed_fit(sm, model, (x, y), TRAIN_EPOCHS,
                                                     TRAIN_BATCH, dev))
    finally:
        sw.add_loss = real_add_loss
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"flash_fwd": layers * steps, "layer_norm_fwd": norms * steps,
            "layer_norm_bwd": 2 * norms * steps}
    got = {k: launches[k] for k in want}
    if got != want:
        failures.append(f"launches {got}, expected {want}")
    aux = torch.stack(added).view(steps, layers).sum(1).tolist() if added else []
    loss = history.get("loss", [])
    if len(added) != layers * steps or not all(np.isfinite(aux)) or not min(aux, default=0) > 0:
        failures.append(f"{len(added)} load-balance losses added ({layers * steps} expected), "
                        f"{aux}")
    if len(loss) != TRAIN_EPOCHS or not np.all(np.isfinite(loss)) or not loss[-1] < loss[0]:
        failures.append(f"the loss is not finite and descending: {history}")
    tokens_s = (steps - 1) * TRAIN_BATCH * TRAIN["maxlen"] / float(np.sum(step_s[1:]))
    xb = torch.from_numpy(x[:TRAIN_BATCH]).long().to(dev)
    fractions = _expert_fractions(model, xb)

    spec = model.training_spec
    yb = torch.from_numpy(y[:TRAIN_BATCH]).long().to(dev)

    def step():
        with auxiliary_losses() as added_losses:
            out = model(xb)
        loss = spec.loss(yb, out).mean() + torch.stack(added_losses).sum()
        spec.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        spec.optimizer.step()

    model.train()
    step()
    with _annotated_moe():
        prof = _profile(dev, step, "one training step, SW-T config", annotation="moe_ffn")
    model.eval()
    del sm, model

    # W = WORKERS: replicas bit-identical under synchronous, the master the
    # mean of the replicas before the last average under asynchronous
    previous = force_devices(WORKERS)
    real_g, real_w = worker.mean_gradients, worker.mean_weights
    kept, expected, workers = [], {}, {}

    def spy_gradients(replicas):
        real_g(replicas)
        kept[:] = replicas

    def spy_weights(replicas):
        states = [r.state_dict() for r in replicas]
        expected.clear()
        expected.update({n: torch.stack([st[n].double() for st in states]).mean(0)
                         for n, t in states[0].items() if t.is_floating_point()})
        real_w(replicas)
        kept[:] = replicas

    w_steps = WORKERS * SWITCH_WORKER_EPOCHS * -(-(TRAIN_ROWS // WORKERS) // WORKER_BATCH)
    try:
        worker.mean_gradients, worker.mean_weights = spy_gradients, spy_weights
        for mode, frequency in (("synchronous", "epoch"), ("asynchronous", "batch")):
            m = build()
            before = _launches()
            t0 = time.perf_counter()
            hist = counted(lambda m=m, mode=mode, frequency=frequency: SparkModel(
                m, mode=mode, frequency=frequency, num_workers=WORKERS, device=dev).fit(
                (x, y), epochs=SWITCH_WORKER_EPOCHS, batch_size=WORKER_BATCH))
            seconds = time.perf_counter() - t0
            now = _launches()
            delta = {k: now[k] - before[k] for k in want}
            w_want = {"flash_fwd": layers * w_steps, "layer_norm_fwd": norms * w_steps,
                      "layer_norm_bwd": 2 * norms * w_steps}
            synchronous = mode == "synchronous"
            diverged = {i: _state_equal(r, m, optimizer=synchronous)[:3]
                        for i, r in enumerate(kept[1:], 1)}
            row = {"history": hist, "seconds": seconds,
                   "tokens_s": SWITCH_WORKER_EPOCHS * TRAIN_ROWS * TRAIN["maxlen"] / seconds,
                   "launches": delta, "replicas_identical": not any(diverged.values())}
            if not synchronous:
                row["master_vs_replica_mean_tensor"], row["master_vs_replica_mean_err"] = \
                    _rel_state_err(m.state_dict(), expected)
            if len(kept) != WORKERS or any(diverged.values()) or delta != w_want or \
                    row.get("master_vs_replica_mean_err", 0.0) > TOL_MASTER_MEAN or \
                    not all(np.all(np.isfinite(v)) for v in hist.values()):
                failures.append(f"W={WORKERS} {mode}: {len(kept)} replicas, differ {diverged}, "
                                f"launches {delta} (expected {w_want}), {row}")
            workers[f"{mode}_{frequency}"] = row
            kept.clear()
            expected.clear()
            del m
    finally:
        worker.mean_gradients, worker.mean_weights = real_g, real_w
        force_devices(previous)
    out = {"phase": "switch_train", "config": SWITCH_T, "dtype_policy": "float32",
           "rows": TRAIN_ROWS, "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS, "steps": steps,
           "launches": dict(launches), "history": history, "aux_per_step": aux,
           "step_seconds": step_s.tolist(),
           "median_step_s_after_first": float(np.median(step_s[1:])),
           "tokens_s_after_first": tokens_s,
           "tokens_s_over_T": tokens_s / t_line["tokens_s_after_first"],
           "T_tokens_s_after_first": t_line["tokens_s_after_first"],
           "max_memory_allocated": peak, "grad_check_rows": SWITCH_GRAD_ROWS,
           "grad_tol": TOL_GRAD, "grad_max_err": grad_err[worst], "grad_worst_param": worst,
           "grad_free_routing_max_err": free_err[free_worst],
           "grad_free_routing_worst_param": free_worst,
           "tokens_whose_choices_differ_per_layer": flips,
           "first_choice_fractions": fractions,
           "moe_share_of_training_step": _moe_share(prof),
           "training_step": {k: prof.get(k) for k in ("wall_ms", "device_ms", "idle_share",
                                                      "annotation")},
           "workers": WORKERS, "worker_batch": WORKER_BATCH, "worker_epochs":
               SWITCH_WORKER_EPOCHS, "w4": workers, "nvidia_smi": nvidia_smi(),
           "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"switch_train check failed: {failures}")
    return launches


# -- the process gang and the sequence-parallel prefill -------------------

HERE = os.path.dirname(os.path.abspath(__file__))
GANG_DIR = os.path.join(HERE, "build", "gang")
# T through the launcher: GANG_ROWS rows, GANG_BATCH rows a worker step,
# GANG_EPOCHS epochs (the last one's seconds printed), GANG_SLOTS workers a
# rank; the restarted gang's rank 1 dies after GANG_DIE_AFTER epochs
GANG_ROWS, GANG_BATCH, GANG_EPOCHS, GANG_SLOTS, GANG_DIE_AFTER = 128, 32, 3, 2, 1
GANG_TIMEOUT_S = 300
# the launcher's switch for the ranks' worker slots, and the gangs: (name,
# ranks, the launcher's other arguments, the backend the ranks must report,
# whether a rank dies after its GANG_DIE_AFTER-epoch snapshot and the
# launcher restarts the gang from it)
GANG_SLOT_FLAG = "--cuda-slots-per-process"
GANG_RUNS = (("nccl_1rank", 1, (), "nccl", False),
             ("gloo_2ranks_restarted", 2, ("--ranks-per-card", "2", "--backend", "gloo"),
              "gloo", True))
# the gang's child: the same T, data and fit on every rank (the SPMD
# contract); prints its digest, history, launch counts and timeline
GANG_CHILD = """
import json, os, sys, time
t0 = time.time()
from elephas_tpu_torch.parallel import distributed
import torch
import chip_smoke as cs
import elephas_tpu_torch as et
t_import = time.time()
assert distributed.initialize(), "not in a gang"
t_init = time.time()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg = json.loads(sys.argv[1])
rank = distributed.process_index()
attempt = int(os.environ["ELEPHAS_RESTART_COUNT"])
t = cfg["model"]
x, y = cs._synthetic_tokens(cfg["rows"], t["maxlen"], t["vocab_size"], t["num_classes"])
model = et.transformer_classifier(**t, seed=0)
sm = et.SparkModel(model)  # the rank's card, every rank's workers
t_model = time.time()
cs._reset_launches()
fit = dict(batch_size=cfg["batch"], checkpoint_dir=cfg.get("ckpt"), history_log=cfg["log"])
if cfg.get("die_after"):
    first = sm.fit((x, y), epochs=cfg["die_after"], resume=attempt > 0, **fit)
    print("GANG_FIRST " + json.dumps({"rank": rank, "attempt": attempt, "history": first}),
          flush=True)
    if attempt == 0 and rank == 1:
        os._exit(17)  # a rank dies after its snapshot: the launcher restarts the gang
history = sm.fit((x, y), epochs=cfg["epochs"], resume=bool(cfg.get("die_after")), **fit)
if sm.device.type == "cuda":
    torch.cuda.synchronize()
print("GANG " + json.dumps({
    "rank": rank, "attempt": attempt, "device": str(sm.device),
    "backend": distributed.backend(), "workers": sm.num_workers,
    "digest": cs._digest(model), "history": history, "launches": cs._launches(),
    "timeline_s": {"start": t0 - cfg["launched"], "imports": t_import - t0,
                   "join": t_init - t_import, "build": t_model - t_init,
                   "fit": time.time() - t_model}}), flush=True)
"""


def _digest(model):
    """sha256 of every tensor of the module's state, in order, on the host."""
    import hashlib

    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _epoch_seconds(log):
    """The seconds of each epoch after the first of a history log (the
    first of each fit is not timed: it pays the warm-up)."""
    seconds, last = [], None
    with open(log) as f:
        for line in map(json.loads, f):
            if "elapsed_s" not in line:
                last = None  # a fit's final line: the next fit has its own clock
                continue
            if last is not None:
                seconds.append(line["elapsed_s"] - last)
            last = line["elapsed_s"]
    return seconds


def _tagged(out, tag):
    return sorted((json.loads(line.split(tag + " ", 1)[1])
                   for line in out.splitlines() if tag + " " in line),
                  key=lambda r: (r["attempt"], r["rank"]))


def _gang_run(what, ranks, cfg, failures, *launch_args):
    """``python -m elephas_tpu_torch.launch`` of GANG_CHILD over ``ranks``
    ranks with ``launch_args``; returns the launcher's output and seconds."""
    script = os.path.join(GANG_DIR, "gang_fit.py")
    with open(script, "w") as f:
        f.write(GANG_CHILD)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    cfg = dict(cfg, launched=time.time())
    proc = subprocess.run(
        [sys.executable, "-m", "elephas_tpu_torch.launch", "--num-processes", str(ranks),
         GANG_SLOT_FLAG, str(GANG_SLOTS), "--timeout", str(GANG_TIMEOUT_S),
         *launch_args, script, json.dumps(cfg)],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=GANG_TIMEOUT_S * 2 + 60)
    if proc.returncode != 0:
        failures.append(f"{what}: launcher exit {proc.returncode}; output tail: "
                        f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return proc.stdout, time.perf_counter() - t0


def _in_process_gang_twin(dev, workers, log):
    """The gang's fit in this process: ``workers`` forced worker slots on the
    card, the same T, data and batch: (digest, history)."""
    from elephas_tpu_torch import SparkModel, transformer_classifier
    from elephas_tpu_torch.device import force_devices

    x, y = _synthetic_tokens(GANG_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"],
                             TRAIN["num_classes"])
    previous = force_devices(workers)
    try:
        model = transformer_classifier(**TRAIN, seed=0, device=dev)
        sm = SparkModel(model, device=dev)
        history = sm.fit((x, y), epochs=GANG_EPOCHS, batch_size=GANG_BATCH, history_log=log)
        torch.cuda.synchronize(dev)
    finally:
        force_devices(previous)
    digest = _digest(model)
    del model, sm
    torch.cuda.empty_cache()
    return digest, history


def phase_gang(dev):
    """T (the train phase's widths) trained by gangs of processes started
    with ``python -m elephas_tpu_torch.launch`` on the card, 2 worker slots
    a rank, each in turn with the same fit in this process over
    force_devices of the same worker count: a world of one rank over NCCL;
    and two ranks sharing the one card over gloo (NCCL refuses two ranks on
    one device; the collectives' CUDA tensors are staged through host
    memory for gloo), whose rank 1 exits 17 after the first epoch's
    snapshot, so that the launcher (``--max-restarts 1 --restart-from``)
    kills the gang and starts it again, resuming from the snapshot. Gates:
    the ranks' weight digests and histories equal; each gang's final
    digest bit-equal to the in-process fit's and its history equal (the
    restarted gang's first generation's epochs and the second's); the
    flash and LayerNorm kernels launched on every rank. Prints the seconds
    of each epoch after a fit's first, gang and in-process, and where each
    rank's wall time went (start, imports, joining, building T, fitting)."""
    if os.path.isdir(GANG_DIR):
        shutil.rmtree(GANG_DIR)
    os.makedirs(GANG_DIR)
    failures, runs = [], {}
    launches = Counter()
    for name, ranks, args, backend, restarted in GANG_RUNS:
        workers = ranks * GANG_SLOTS
        own_log = os.path.join(GANG_DIR, f"{name}-in-process.jsonl")
        want_digest, want = _in_process_gang_twin(dev, workers, own_log)
        log = os.path.join(GANG_DIR, f"{name}.jsonl")
        cfg = dict(model=TRAIN, rows=GANG_ROWS, batch=GANG_BATCH, epochs=GANG_EPOCHS, log=log)
        if restarted:
            ckpt = os.path.join(GANG_DIR, f"{name}-ckpt")
            cfg.update(die_after=GANG_DIE_AFTER, ckpt=ckpt)
            args = (*args, "--max-restarts", "1", "--restart-from", ckpt)
        out, wall = _gang_run(name, ranks, cfg, failures, *args)
        results = [r for r in _tagged(out, "GANG") if r["attempt"] == int(restarted)]
        if len(results) != ranks:
            failures.append(f"{name}: {len(results)} of {ranks} ranks reported")
            continue
        history = {k: v[GANG_DIE_AFTER:] if restarted else v for k, v in want.items()}
        if restarted:
            if "exited rc=17; killing the gang" not in out or "restarting (1/1)" not in out:
                failures.append(f"{name}: no kill and restart in the launcher's output")
            first = [r for r in _tagged(out, "GANG_FIRST") if r["attempt"] == 0]
            want_first = {k: v[:GANG_DIE_AFTER] for k, v in want.items()}
            if len(first) != ranks or any(r["history"] != want_first for r in first):
                failures.append(f"{name}: first generation {first}, in-process {want_first}")
        if {r["digest"] for r in results} != {want_digest}:
            failures.append(f"{name}: rank digests {[r['digest'][:12] for r in results]}, "
                            f"in-process {want_digest[:12]}")
        if any(r["history"] != history for r in results):
            failures.append(f"{name}: histories {[r['history'] for r in results]}, "
                            f"in-process {history}")
        for r in results:
            if r["backend"] != backend:
                failures.append(f"{name} rank {r['rank']}: backend {r['backend']}, "
                                f"expected {backend}")
            if r["workers"] != workers or min(r["launches"][k] for k in
                                              ("flash_fwd", "layer_norm_fwd",
                                               "layer_norm_bwd")) == 0:
                failures.append(f"{name} rank {r['rank']}: {r['workers']} workers, "
                                f"launches {r['launches']}")
            launches.update(r["launches"])
        runs[name] = {"ranks": ranks, "workers": workers, "backend": results[0]["backend"],
                      "device": results[0]["device"], "restarted": restarted,
                      "gang_epoch_s": _epoch_seconds(log),
                      "in_process_epoch_s": _epoch_seconds(own_log),
                      "launcher_wall_s": wall,
                      "rank_timeline_s": [r["timeline_s"] for r in results],
                      "digest": want_digest[:16], "loss": want["loss"]}
    counted = {k: launches[k] for k in ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")}
    emit({"phase": "gang", "model": "T", "rows": GANG_ROWS, "worker_batch": GANG_BATCH,
          "epochs": GANG_EPOCHS, "runs": runs, "launches": counted,
          "epoch_s_order": "in-process then gang, for each run in turn",
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"gang: {failures}")
    out = dict.fromkeys(_launches(), 0)
    out.update(counted)
    return out


# the SP prefill: config A's engine on the paged arena (E's options), long
# prompts padded to 512, over meshes naming cuda:0 SP_WIDTHS times
SP_PROMPT_LENS = (300, 360, 440, 500)
SP_NEW_TOKENS = 8
SP_WIDTHS = (2, 4)
SP_MECHANISMS = ("ring", "ulysses")
SP_ROUNDS = 2
TOL_SP = 1e-5


def _sp_kernel_checks(dev, failures):
    """ring_attention_sharded and ulysses_attention_sharded against the plain
    flash forward over the whole sequence, at config A's attention shape
    (one prompt of 512, 4 heads of 128), causal and not, at each SP width;
    the ring's gradients against autograd through the plain version.
    Returns the largest errors, relative to max(1, |out|)."""
    from elephas_tpu_torch.ops.flash_attention import flash_forward_reference
    from elephas_tpu_torch.ops.ring_attention import ring_attention_sharded
    from elephas_tpu_torch.ops.ulysses import ulysses_attention_sharded
    from elephas_tpu_torch.parallel.mesh import Mesh

    a = CONFIGS["A"]
    h, d, s = a["num_heads"], a["d_model"] // a["num_heads"], a["maxlen"]
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, go = (torch.randn(1, h, s, d, generator=g, device=dev) for _ in range(4))
    scale = d ** -0.5
    errs = {}

    def rel(got, want):
        return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()

    for w in SP_WIDTHS:
        mesh = Mesh([dev] * w, ("seq",))
        for causal in (False, True):
            want = flash_forward_reference(q, k, v, scale, causal)[0]
            ring = ring_attention_sharded(q[0], k[0], v[0], mesh, "seq", causal, scale)
            uly = ulysses_attention_sharded(q, k, v, mesh, "seq", causal, scale)
            errs[f"ring_W{w}_causal{int(causal)}"] = rel(ring[None], want)
            errs[f"ulysses_W{w}_causal{int(causal)}"] = rel(uly, want)
            leaves = [t[0].clone().requires_grad_() for t in (q, k, v)]
            (ring_attention_sharded(*leaves, mesh, "seq", causal, scale) * go[0]).sum().backward()
            plain = [t[0].clone().requires_grad_() for t in (q, k, v)]
            (flash_forward_reference(*plain, scale, causal)[0] * go[0]).sum().backward()
            errs[f"ring_grad_W{w}_causal{int(causal)}"] = max(
                rel(a_.grad, b_.grad) for a_, b_ in zip(leaves, plain))
    bad = {key: e for key, e in errs.items() if not e <= TOL_SP}
    if bad:
        failures.append(f"sequence-parallel attention against the plain version: {bad}")
    return errs


def phase_sp_prefill(dev, model):
    """The engine's sequence-parallel prefill at config A's full width: E's
    engine on the paged arena (blocks of 16, 512 blocks) with
    ``sp_prefill`` over meshes naming cuda:0 2 and 4 times, ring and
    Ulysses, on prompts of 300-500 tokens (padded to 512), in turns with the
    same engine without it. Gates: the SP attention against its plain
    version (_sp_kernel_checks); every SP engine's tokens equal the paged
    engine's where the plain path's top-2 margin is >= 1e-3, the paged
    engine's checked against the plain argmax (check (a)); each long
    prompt's flash-forward launches exactly the ring's W·(W+1)/2 or
    Ulysses' W a layer, and its prefill observed as bucket sp512. Prints
    TTFT p50 of each engine a round (no claim)."""
    from elephas_tpu_torch import InferenceEngine
    from elephas_tpu_torch.ops import flash_attention as fa
    from elephas_tpu_torch.parallel.mesh import Mesh
    from elephas_tpu_torch.serving.sp_prefill import sp_pad_len

    failures = []
    errs = _sp_kernel_checks(dev, failures)
    padded = sp_pad_len(min(SP_PROMPT_LENS), max(SP_WIDTHS), model.maxlen)
    rng = np.random.default_rng(3)
    workload = [(rng.integers(1, model.vocab_size, size=n).astype(np.int32), SP_NEW_TOKENS)
                for n in SP_PROMPT_LENS]
    opts = dict(ENGINE, **ENGINE_PAGED)
    engines = {"paged": InferenceEngine(model, **opts)}
    for w in SP_WIDTHS:
        for mech in SP_MECHANISMS:
            engines[f"{mech}_W{w}"] = InferenceEngine(
                model, sp_prefill=Mesh([dev] * w, ("seq",)), sp_mechanism=mech, **opts)
    per_layer = {f"{m}_W{w}": (w * (w + 1) // 2 if m == "ring" else w)
                 for w in SP_WIDTHS for m in SP_MECHANISMS}
    for engine in engines.values():  # warm-up pass
        _serve_pass(engine, workload, dev)
    ttft = {name: [] for name in engines}
    handles = {}
    _reset_launches()
    sp_flash = 0
    for _ in range(SP_ROUNDS):
        for name, engine in engines.items():
            before = fa.launches
            reqs, row = _serve_pass(engine, workload, dev)
            ttft[name].append(row["ttft_s"]["p50"])
            handles[name] = reqs
            if name in per_layer:
                got = fa.launches - before
                want = len(workload) * len(model.blocks) * per_layer[name]
                sp_flash += got
                if got != want:
                    failures.append(f"{name}: {got} flash-forward launches, expected {want}")
    launches = _launches()
    _, _, check_failures, plain = _check_emitted(model, handles["paged"], dev)
    failures += check_failures
    exact = {}
    for name in per_layer:
        exact[name] = _same_tokens(name, handles[name], handles["paged"], plain, failures)
        if f'bucket="sp{padded}"' not in engines[name].scrape():
            failures.append(f"{name}: no sp{padded} prefill observation")
    for engine in engines.values():
        engine.release_telemetry()
    emit({"phase": "sp_prefill", "config": "A", "prompt_lens": list(SP_PROMPT_LENS),
          "padded": padded, "new_tokens": SP_NEW_TOKENS, "arena": ENGINE_PAGED,
          "attention_errors": errs, "tokens_exact_within_margin": exact,
          "ttft_p50_s": ttft, "ttft_order": "paged, then each SP engine, a round",
          "flash_fwd_launches": sp_flash, "launches": launches,
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"sp_prefill: {failures}")
    return launches


# tensor parallelism: T through SparkModel(model_parallel=2) on a
# 2 x 2 ('data', 'model') mesh naming cuda:0 four times (force_devices(4)),
# against the same weights at model_parallel=1 on 2 data replicas (the
# reference's contract between layouts, tests/test_tensor_parallel.py:92-108);
# config A's generate over dp_tp_mesh(2, data_parallel=2) against unmeshed
TP = 2
TP_ROWS, TP_BATCH, TP_EPOCHS = 256, 128, 2
TP_MODES = (("synchronous", "epoch"), ("hogwild", "batch"))
TOL_TP = 1e-4
TOL_TP_LOGITS = 1e-4
TP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tp")


def _state_copy(trainer):
    """The canonical single copy's shards (the trainer's checkpoint
    content) and the master's optimizer state, copied on the card."""
    shards = {name: [t.detach().clone() for t in trainer._canonical(name)]
              for name in trainer._replicas[0].variables}
    opt = trainer.model.training_spec.optimizer
    named = dict(trainer.model.named_parameters())
    state = {n: {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state[p].items()}
             for n, p in named.items() if p in opt.state}
    return shards, state


def _same_state(a, b):
    """Names whose shards or optimizer state differ between two _state_copy."""
    bad = [n for n, ts in a[0].items()
           if len(ts) != len(b[0][n]) or not all(torch.equal(x, y) for x, y in zip(ts, b[0][n]))]
    for n, st in a[1].items():
        for k, v in st.items():
            w = b[1].get(n, {}).get(k)
            if not (torch.equal(v, w) if torch.is_tensor(v) else v == w):
                bad.append(f"{n}#{k}")
    return bad


def _tp_fit(dev, x, y, mode, frequency, which):
    """One fit of T from seed 0's weights on 4 worker slots of the card:
    ``which`` "tp" through SparkModel(model_parallel=TP) on a 2 x TP mesh;
    "mp1" the ShardedTrainer on a 2 x 1 mesh (two data replicas, whole
    copies; the reference compares the layouts so,
    tests/test_tensor_parallel.py:92); "dp" the data-parallel runner
    (worker.Runner, held against the JAX package in the CPU tests) at 2
    workers, worker w given the w-th half of every global batch, so that
    its steps take the rows the trainer's replicas take. Every fit is
    timed by the same epoch callback, first in its list, after a
    synchronize. Returns (history, keras weights, launches, peak bytes,
    the trainer or None, the seconds of each epoch after the first)."""
    from elephas_tpu_torch import SparkModel, transformer_classifier
    from elephas_tpu_torch.parallel.tensor import ShardedTrainer, dp_tp_mesh
    from elephas_tpu_torch.utils.weights import keras_weights
    from elephas_tpu_torch.worker import Runner

    model = transformer_classifier(**TRAIN, seed=0, device=dev)
    stamps = []

    def stamp(_epoch, _loss):
        torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    trainer = None
    if which == "tp":
        sm = SparkModel(model, mode=mode, frequency=frequency, model_parallel=TP,
                        num_workers=2, device=dev)
        trainer = sm._runner.trainer
        run_epochs = sm._runner.run_epochs
        sm._runner.run_epochs = lambda parts, epochs, batch, verbose=0, callbacks=(): \
            run_epochs(parts, epochs, batch, verbose, [stamp, *callbacks])
    elif which == "mp1":
        trainer = ShardedTrainer(model, mesh=dp_tp_mesh(1, data_parallel=2, device=dev),
                                 mode=mode, frequency=frequency)
    else:
        half = TP_BATCH // 2
        rows = np.arange(len(x))
        parts = [(x[rows % TP_BATCH // half == w], y[rows % TP_BATCH // half == w])
                 for w in range(2)]
        runner = Runner(model, mode, frequency, num_workers=2)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    if which == "tp":
        history = sm.fit((x, y), epochs=TP_EPOCHS, batch_size=TP_BATCH)
    elif which == "mp1":
        history = trainer.fit(x, y, epochs=TP_EPOCHS, batch_size=TP_BATCH, callbacks=[stamp])
    else:
        history = runner.run_epochs(parts, TP_EPOCHS, TP_BATCH // 2, callbacks=[stamp])
    torch.cuda.synchronize(dev)
    return (history, keras_weights(model), _launches(), torch.cuda.max_memory_allocated(dev),
            trainer, np.diff(stamps).tolist())


def _close(a, b, tol):
    """The largest |a - b| - tol·|b| over two arrays (fails where > tol)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) - tol * np.abs(b)))


def phase_tp_train(dev):
    """T (the train phase's widths, fp32, TF32 off) through
    SparkModel(model_parallel=2) on a 2 x 2 mesh naming cuda:0 four times,
    synchronous/epoch then hogwild/batch (TP_ROWS rows, batch TP_BATCH,
    TP_EPOCHS epochs), each in turn with the same weights at
    model_parallel=1 on 2 data replicas and through the data-parallel
    runner at 2 workers. Gates: history and every final weight (by Keras
    path) within TOL_TP absolute plus TOL_TP relative of each of those two
    fits; the flash forward launched once a shard a
    layer a copy a step (at H/2 heads), the LayerNorm kernels once a norm
    a copy a step; a sharded checkpoint (one file a model-axis position,
    none holding a sharded variable whole) restored after another epoch
    bit-equal to the state that was saved. Printed: seconds of the second
    epoch of each fit, peak memory, bytes a shard against the whole
    model's."""
    from elephas_tpu_torch.device import force_devices

    if os.path.isdir(TP_DIR):
        shutil.rmtree(TP_DIR)
    os.makedirs(TP_DIR)
    x, y = _synthetic_tokens(TP_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"],
                             TRAIN["num_classes"])
    layers, norms = TRAIN["num_layers"], 2 * TRAIN["num_layers"] + 1
    steps = TP_EPOCHS * -(-TP_ROWS // TP_BATCH)
    failures, runs = [], {}
    total = dict.fromkeys(_launches(), 0)
    previous = force_devices(4)
    try:
        for mode, frequency in TP_MODES:
            name = f"{mode}_{frequency}"
            h_tp, w_tp, launches, peak_tp, trainer, s_tp = _tp_fit(dev, x, y, mode, frequency,
                                                                     "tp")
            h_one, w_one, _, peak_one, one, s_one = _tp_fit(dev, x, y, mode, frequency, "mp1")
            h_dp, w_dp, _, peak_dp, _, s_dp = _tp_fit(dev, x, y, mode, frequency, "dp")
            del one
            for k, v in launches.items():
                total[k] += v
            copies = 2 if trainer.per_replica else 1
            want = {"flash_fwd": TP * layers * steps * copies,
                    "layer_norm_fwd": norms * steps * copies,
                    "layer_norm_bwd": 2 * norms * steps * copies}
            got = {k: launches[k] for k in want}
            if got != want:
                failures.append(f"{name}: launches {got}, expected {want}")
            gates = {}
            for against, h_ref, w_ref in (("mp1", h_one, w_one), ("dp", h_dp, w_dp)):
                hist_err = max(_close(h_tp[k], h_ref[k], TOL_TP) for k in h_ref)
                weight_err = {p: _close(w_tp[p], w, TOL_TP) for p, w in w_ref.items()}
                worst = max(weight_err, key=weight_err.get)
                gates[against] = {"history_excess_over_tol": hist_err, "worst_weight": worst,
                                  "worst_weight_excess_over_tol": weight_err[worst]}
                if sorted(h_tp) != sorted(h_ref) or hist_err > TOL_TP or \
                        weight_err[worst] > TOL_TP:
                    failures.append(f"{name} against {against}: history {h_tp} against "
                                    f"{h_ref}; worst weight {worst} {weight_err[worst]}")
            if not all(np.all(np.isfinite(v)) for v in h_tp.values()):
                failures.append(f"{name}: non-finite history {h_tp}")
            shard_bytes = trainer.shard_bytes()
            whole = sum(t.numel() * t.element_size() for t in trainer.model.state_dict()
                        .values())
            runs[name] = {
                "history": h_tp, "history_mp1": h_one, "history_dp": h_dp,
                "against_mp1": gates["mp1"], "against_dp": gates["dp"],
                "epoch_s_mp2": s_tp, "epoch_s_mp1": s_one, "epoch_s_dp": s_dp,
                "max_memory_allocated_mp2": peak_tp, "max_memory_allocated_mp1": peak_one,
                "max_memory_allocated_dp": peak_dp,
                "shard_bytes": shard_bytes, "whole_model_bytes": whole,
                "launches": got}
            if mode == "synchronous":
                runs[name]["checkpoint"] = _tp_checkpoint(dev, trainer, x, y, failures)
            del trainer
            torch.cuda.empty_cache()
    finally:
        force_devices(previous)
    emit({"phase": "tp_train", "model": "T", "mesh": {"data": 2, "model": TP},
          "devices": "cuda:0 x 4 (force_devices(4))", "rows": TP_ROWS, "batch": TP_BATCH,
          "epochs": TP_EPOCHS, "tol": TOL_TP, "runs": runs, "launches": total,
          "epoch_s": "the second epoch's seconds, each fit's first epoch callback after a "
                     "synchronize",
          "epoch_s_order": "model_parallel=2, model_parallel=1, the data-parallel runner, "
                           "each mode in turn",
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"tp_train: {failures}")
    return total


def _tp_checkpoint(dev, trainer, x, y, failures):
    """The sharded checkpoint's round trip on the model_parallel fit: save,
    train one more epoch, restore: bit-equal to the saved state."""
    saved = _state_copy(trainer)
    t0 = time.perf_counter()
    path = trainer.save_checkpoint(os.path.join(TP_DIR, "ckpt"), TP_EPOCHS)
    save_s = time.perf_counter() - t0
    files = sorted(os.listdir(path))
    sizes = [os.path.getsize(os.path.join(path, f)) for f in files]
    whole = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    for f in files:
        held = torch.load(os.path.join(path, f), map_location="cpu", weights_only=True)
        for n, var in trainer._replicas[0].variables.items():
            if var.dim is not None and tuple(held[n].shape) == whole[n]:
                failures.append(f"checkpoint {f} holds the sharded {n} whole")
    trainer.fit(x, y, epochs=1, batch_size=TP_BATCH)
    moved = _same_state(saved, _state_copy(trainer))
    t0 = time.perf_counter()
    trainer.restore_checkpoint(os.path.join(TP_DIR, "ckpt"))
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    bad = _same_state(saved, _state_copy(trainer))
    if files != [f"shard-{j:03d}.pt" for j in range(TP)] or bad or not moved:
        failures.append(f"checkpoint: files {files}, differing after restore {bad[:5]}, "
                        f"{len(moved)} moved by the extra epoch")
    return {"files": files, "file_bytes": sizes, "save_s": save_s, "restore_s": restore_s,
            "restored_bit_equal": not bad}


def phase_tp_generate(dev, model):
    """Config A's generate over dp_tp_mesh(2, data_parallel=2) naming cuda:0
    four times, the weights sharded over 'model' (2 heads of 4 a shard), with
    kv_cache False and True: serve's 8 prompts of 8-40 tokens one a call
    (padded to 2 rows over 'data'), then the 8 cut to 8 tokens in one call
    (4 rows a data copy), STEPS steps at temperature 0, in turns with
    unmeshed generate. Gates: tokens equal to unmeshed generate's; a
    sharded copy's first-step logits within TOL_TP_LOGITS of max(1,
    |logit|) of the whole model's; the flash forward (kv_cache False) and
    the span decode (True) launched once a shard a layer a data copy a
    step. Printed: the seconds of each generate, meshed beside unmeshed,
    and the seconds of building the sharded copies, which every meshed
    call does."""
    from elephas_tpu_torch import generate
    from elephas_tpu_torch.device import force_devices
    from elephas_tpu_torch.parallel import tensor

    failures, seconds = [], {}
    layers = len(model.blocks)
    prompts = _prompts(model.vocab_size)
    batches = [p[None] for p in prompts] + [np.stack([p[:8] for p in prompts])]
    total = dict.fromkeys(_launches(), 0)
    previous = force_devices(4)
    try:
        mesh = tensor.dp_tp_mesh(TP, data_parallel=2, device=dev)
        for kv_cache in (False, True):
            key = f"kv_cache_{kv_cache}"
            seconds[key] = {"meshed": 0.0, "unmeshed": 0.0}
            for batch in batches:
                p, dp = batch.shape[1], 2
                t0 = time.perf_counter()
                want = generate(model, batch, STEPS, kv_cache=kv_cache)
                seconds[key]["unmeshed"] += time.perf_counter() - t0
                before = _launches()
                t0 = time.perf_counter()
                got = generate(model, batch, STEPS, kv_cache=kv_cache, mesh=mesh,
                               model_axis="model")
                seconds[key]["meshed"] += time.perf_counter() - t0
                now = _launches()
                for k in total:
                    total[k] += now[k] - before[k]
                calls = (p + STEPS - 1) if kv_cache else STEPS
                kernel = "span_decode" if kv_cache else "flash_fwd"
                if now[kernel] - before[kernel] != TP * dp * layers * calls:
                    failures.append(f"{key} batch {batch.shape}: {now[kernel] - before[kernel]} "
                                    f"{kernel} launches, expected {TP * dp * layers * calls}")
                if got.shape != want.shape or not np.array_equal(got, want):
                    failures.append(f"{key} batch {batch.shape}: meshed tokens differ")
        # the copies every meshed call builds (a deepcopy, then the shards)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        copy = tensor.decode_replicas(model, mesh, ("data",), "model")[0]
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        errs = []
        with torch.inference_mode():
            for batch in batches:
                tokens = torch.from_numpy(batch.astype(np.int64)).to(dev)
                a, b = copy(tokens)[:, -1], model(tokens)[:, -1]
                errs.append(((a - b).abs() / b.abs().clamp_min(1.0)).max().item())
        if max(errs) > TOL_TP_LOGITS:
            failures.append(f"first-step logits: {max(errs)} of max(1, |logit|)")
        del copy
    finally:
        force_devices(previous)
    emit({"phase": "tp_generate", "config": "A", "mesh": {"data": 2, "model": TP},
          "devices": "cuda:0 x 4 (force_devices(4))", "steps": STEPS,
          "batches": [list(b.shape) for b in batches],
          "first_step_logit_err_of_max_1_abs": max(errs), "tol_logits": TOL_TP_LOGITS,
          "seconds": seconds, "launches": total,
          "seconds_order": "unmeshed, then meshed, each batch in turn",
          "decode_replicas_s": build_s, "meshed_calls_per_setting": len(batches),
          "nvidia_smi": nvidia_smi(), "failures": failures})
    if failures:
        raise AssertionError(f"tp_generate: {failures}")
    return total


def phase_times_tp(dev):
    """The kernels at the tensor-parallel shard shapes, as phase_times and
    phase_times_span_decode time them: K1b at T's H/2 shard (B128 S256 H4
    D128, not causal, fp32), the span decode at config A's H/2 shard of the
    batched tp_generate call (B4 H2 D128, span 128)."""
    d = TRAIN["d_model"] // TRAIN["num_heads"]
    qkv, views = _case_inputs("packed", TP_BATCH, TRAIN["maxlen"], TRAIN["num_heads"] // TP, d,
                              torch.float32, dev, 7)
    rows = {"flash_fwd_T_shard": _flash_row(qkv, views, d ** -0.5, False, torch.float32)}
    del qkv, views
    a = CONFIGS["A"]
    rows["span_decode_A_shard_span128"] = _span_row(
        dev, 4, a["num_heads"] // TP, a["d_model"] // a["num_heads"], 128, sweep=False)
    emit({"phase": "times", "kernel": "tensor-parallel shards", "timing": GRAPH_TIMING, **rows})
    return rows


def _kernel_entry(name, source, replaces, launches, err, times, **extra):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times["ms"],
        "device_ms": times["device_ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"], **extra,
    }


def _shard_entry(times):
    """A kernel's times at a tensor-parallel shard shape, for its entry in
    the kernels line."""
    return {k: times[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}


def times_only(dev):
    """The phases that time the main path (serve, the engine, its
    long-span pass and, where the package has the span chunk, its chunked
    pass, with their decode-window profiles, the generate profiles, the
    flash, span-decode, span-chunk and LayerNorm rows, the LayerNorm host
    breakdown) for the package that ``elephas_tpu_torch`` imports, with its
    kernels built as that package builds them."""
    import elephas_tpu_torch
    from elephas_tpu_torch.ops import _native
    from elephas_tpu_torch.ops import flash_serving as fs

    t0 = time.perf_counter()
    _native.build()
    emit({"phase": "build", "package": os.path.dirname(elephas_tpu_torch.__file__),
          "seconds": time.perf_counter() - t0})
    phase_serve(dev)
    _, lm = phase_engine(dev)
    phase_engine_long(dev, lm)
    chunking = hasattr(fs, "chunk_launches")
    if chunking:
        phase_engine_chunked(dev, lm)
    paging = hasattr(fs, "paged_launches")
    if paging:
        merges = _engine_merges()
        with _recording_chunk_shapes():
            phase_engine_paged(dev, lm)
        phase_engine_chunk_shapes(merges)
    phase_profile_engine(dev, lm)
    del lm
    phase_profile_generate(dev)
    phase_times(dev)
    phase_times_span_decode(dev)
    if chunking:
        phase_times_span_chunk(dev)
    if paging:
        phase_times_paged(dev)
    phase_times_layer_norm(dev)
    phase_ln_host_breakdown(dev)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--times-only", action="store_true",
                        help="run only the serve, engine, engine_long, engine_chunked, "
                             "profile, times and LayerNorm host breakdown phases")
    parser.add_argument("--package", metavar="DIR",
                        help="the directory holding the elephas_tpu_torch to drive "
                             "(with --times-only; default: beside this script)")
    args = parser.parse_args(argv)
    if args.package and not args.times_only:
        parser.error("--package goes with --times-only")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    try:
        import elephas_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the elephas_tpu_torch package is not beside this script "
              f"(or in --package): {err}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    _reset_launches()

    if args.times_only:
        phase_card()
        times_only(dev)
        print(nvidia_smi(), flush=True)
        emit({"ok": True, "times_only": True})
        return 0
    phase_card()
    phase_build()
    errs = phase_kernel(dev)
    serve = phase_serve(dev)
    train, model, batch, fp32_line = phase_train(dev)
    train_bf16, model_bf16, batch_bf16, _ = phase_train(dev, "mixed_bfloat16", fp32_line)
    r50, r50_batch = phase_train_resnet50(dev)
    phase_zoo(dev)
    train_workers = phase_train_workers(dev)
    train_stream = phase_train_stream(dev)
    phase_ml_pipeline(dev)
    phase_hyperparam(dev)
    train_ps = phase_train_ps(dev)
    engine, lm = phase_engine(dev)
    phase_engine_long(dev, lm)
    chunked = phase_engine_chunked(dev, lm)
    merges = _engine_merges()
    with _recording_chunk_shapes():
        paged = phase_engine_paged(dev, lm)
        quant = phase_engine_quant(dev, lm)
    phase_engine_chunk_shapes(merges)
    spec = phase_engine_spec(dev)
    _reset_launches()
    gateway = phase_gateway(dev, lm)
    _reset_launches()
    fleet = phase_fleet(dev, lm)
    _reset_launches()
    deploy = phase_deploy(dev, lm)
    switch_serve = phase_switch_serve(dev, lm)
    switch_train = phase_switch_train(dev, fp32_line)
    _reset_launches()
    gang = phase_gang(dev)
    _reset_launches()
    sp = phase_sp_prefill(dev, lm)
    _reset_launches()
    tp_train = phase_tp_train(dev)
    _reset_launches()
    tp_generate = phase_tp_generate(dev, lm)
    for path, launches, kernels in (
        ("serve", serve, ("flash_fwd", "layer_norm_fwd")),
        ("train", train, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("train_bf16", train_bf16, ("flash_fwd_bf16", "layer_norm_fwd_bf16",
                                    "layer_norm_bwd_bf16")),
        ("train_workers", train_workers, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("train_stream", train_stream, ("flash_fwd_bf16", "layer_norm_fwd_bf16",
                                        "layer_norm_bwd_bf16")),
        ("train_ps", train_ps, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("engine", engine, ("span_decode", "flash_fwd", "layer_norm_fwd")),
        ("engine_chunked", chunked, ("span_chunk", "span_decode", "layer_norm_fwd")),
        ("engine_paged", paged, ("paged_span_chunk", "paged_span_decode", "layer_norm_fwd")),
        ("engine_quant", quant, ("paged_span_chunk", "paged_span_decode", "layer_norm_fwd")),
        ("engine_spec", spec, ("span_chunk", "paged_span_chunk", "span_decode", "flash_fwd",
                               "layer_norm_fwd")),
        ("gateway", gateway, ("span_decode", "flash_fwd", "paged_span_chunk",
                              "paged_span_decode", "layer_norm_fwd")),
        ("fleet", fleet, ("paged_span_chunk", "paged_span_decode", "layer_norm_fwd")),
        ("deploy", deploy, ("paged_span_chunk", "paged_span_decode", "layer_norm_fwd")),
        ("switch_serve", switch_serve, ("flash_fwd", "span_decode", "span_chunk",
                                        "paged_span_chunk", "paged_span_decode",
                                        "layer_norm_fwd")),
        ("switch_train", switch_train, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("gang", gang, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("sp_prefill", sp, ("flash_fwd", "paged_span_chunk", "paged_span_decode",
                            "layer_norm_fwd")),
        ("tp_train", tp_train, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("tp_generate", tp_generate, ("flash_fwd", "span_decode", "layer_norm_fwd")),
    ):
        idle = [k for k in kernels if launches[k] == 0]
        if idle:
            raise AssertionError(f"the {path} path never launched {idle}")
    phase_profile(dev, model, batch)
    phase_profile(dev, model_bf16, batch_bf16, "one training step, TRAIN config, "
                  "mixed_bfloat16")
    phase_profile(dev, r50, r50_batch, "one training step, ResNet-50 mixed_bfloat16, "
                  f"batch {len(r50_batch[0])}")
    del model, batch, model_bf16, batch_bf16, r50, r50_batch
    phase_profile_generate(dev)
    phase_profile_engine(dev, lm)
    del lm
    flash = phase_times(dev)["A_B8_float32"]
    ln_times = phase_times_layer_norm(dev)
    phase_ln_host_breakdown(dev)
    phase_times_train(dev)
    span_times = phase_times_span_decode(dev)
    chunk_times = phase_times_span_chunk(dev)
    paged_times = phase_times_paged(dev)
    tp_times = phase_times_tp(dev)

    print(nvidia_smi(), flush=True)
    total = {k: serve[k] + train[k] + train_bf16[k] + train_workers[k] + train_stream[k]
             + train_ps[k] + engine[k] + chunked[k] + paged[k] + quant[k] + spec[k] + gateway[k]
             + fleet[k] + deploy[k] + switch_serve[k] + switch_train[k] + gang[k] + sp[k]
             + tp_train[k] + tp_generate[k] for k in serve}
    emit({"kernels": [
        _kernel_entry(
            "flash_fwd", "elephas_tpu_torch/csrc/flash_fwd.cu",
            "elephas_tpu/ops/flash_attention.py:41 (_fwd_kernel via "
            "_flash_forward :122 and _flash_forward_packed :250); "
            "elephas_tpu/ops/flash_attention.py:164 (_fwd_kernel_grouped via "
            "_flash_forward_packed_grouped :319)",
            total["flash_fwd"], errs["flash_fwd"], flash,
            launches_by_path={"gang": gang["flash_fwd"], "sp_prefill": sp["flash_fwd"],
                              "tp_train": tp_train["flash_fwd"],
                              "tp_generate": tp_generate["flash_fwd"]},
            tp_shard=_shard_entry(tp_times["flash_fwd_T_shard"])),
        _kernel_entry(
            "layer_norm_fwd", "elephas_tpu_torch/csrc/layer_norm.cu",
            "elephas_tpu/ops/layer_norm.py:52 (_fwd_kernel via _fwd_call :96)",
            total["layer_norm_fwd"], errs["layer_norm_fwd"],
            ln_times["layer_norm_fwd_train_float32"],
            launches_by_path={"tp_train": tp_train["layer_norm_fwd"],
                              "tp_generate": tp_generate["layer_norm_fwd"]}),
        _kernel_entry(
            "layer_norm_bwd", "elephas_tpu_torch/csrc/layer_norm.cu",
            "elephas_tpu/ops/layer_norm.py:66 (_bwd_kernel via _ln_bwd_rule :128)",
            total["layer_norm_bwd"], errs["layer_norm_bwd"],
            ln_times["layer_norm_bwd_train_float32"],
            launches_by_path={"tp_train": tp_train["layer_norm_bwd"]}),
        _kernel_entry(
            "span_decode", "elephas_tpu_torch/csrc/span_decode.cu",
            "elephas_tpu/ops/flash_serving.py:153 (flash_span_decode: flash_span_chunk :93 "
            "with one query row; plain XLA in the reference, not a Pallas kernel)",
            total["span_decode"], errs["span_decode"], span_times["span128"],
            launches_by_path={"tp_generate": tp_generate["span_decode"]},
            tp_shard=_shard_entry(tp_times["span_decode_A_shard_span128"])),
        _kernel_entry(
            "span_chunk", "elephas_tpu_torch/csrc/span_chunk.cu",
            "elephas_tpu/ops/flash_serving.py:93 (flash_span_chunk, run by "
            "chunked_prefill_forward and verify_forward, elephas_tpu/serving/kv_cache.py:476, "
            ":603; plain XLA in the reference, not a Pallas kernel)",
            total["span_chunk"], errs["span_chunk"], chunk_times["engine_span256"]),
        _kernel_entry(
            "paged_span_decode", "elephas_tpu_torch/csrc/span_decode.cu",
            "elephas_tpu/serving/paged_kv.py:246 (paged_token_decode_step: the table gather "
            "and flash_span_decode with kv_dtype / kv_scales, "
            "elephas_tpu/ops/flash_serving.py:153-167; plain XLA in the reference, not a "
            "Pallas kernel)",
            total["paged_span_decode"], errs["paged_span_decode"],
            paged_times["paged_span_decode_fp_span128"]),
        _kernel_entry(
            "paged_span_chunk", "elephas_tpu_torch/csrc/span_chunk.cu",
            "elephas_tpu/serving/paged_kv.py:479 (paged_chunk_forward: the table gather and "
            "flash_span_chunk with kv_dtype / kv_scales, dequantizing in the tile loop at "
            "elephas_tpu/ops/flash_serving.py:132-141; plain XLA in the reference, not a "
            "Pallas kernel)",
            total["paged_span_chunk"], errs["paged_span_chunk"],
            paged_times["paged_span_chunk_fp_B1_C64_span256"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
