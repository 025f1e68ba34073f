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
            cuobjdump --dump-sass; each LayerNorm forward instantiation's
            16-byte loads and stores and block barriers; fails on a spill,
            a flash kernel without HMMA or LDGSTS, a one-warp-a-row
            LayerNorm forward with a block barrier or a vector one without
            16-byte loads and stores;
3. kernel — each kernel against its plain PyTorch version on the card,
            at the main paths' shapes, fp32 and bf16: the flash forward
            (causal and not) and the LayerNorm forward and backward (at
            the engine's, generate's and the training rows, an odd width
            and rows off 16-byte alignment, each on the route it should
            take, the serving route's y bit for bit the training route's,
            on a second call and from a CUDA-graph replay); and
            the span decode (fp32) at the engine's slots and heads and at
            a shape whose slots and heads fill the card, over every span
            bucket and head dim, with ragged positions and a stale cursor,
            repeating bit for bit eagerly and from a CUDA-graph replay;
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
            host time of its workspace allocation. LayerNorm also as the
            serving paths call it: the entry layer_norm against
            torch.nn.functional.layer_norm, both under inference_mode, at
            the engine's, generate's and the training rows; and a sweep of
            the forward's rows per block (printed on a line of its own);
8b. ln_host_breakdown — where a LayerNorm call's host time goes (the
            entry, the autograd Function, checks, allocations, device
            guard, stream query, ctypes marshalling, the launch) beside
            torch.nn.functional.layer_norm's.

Then the card's nvidia-smi line, the {"kernels": [...]} line (launches
summed over the serve, train, train_bf16, train_workers, train_stream and
engine paths,
times at config A's
attention shape, at the training rows and at the engine's decode shape,
fp32), and last {"ok": true, "device": {...}}. Exits non-zero with no result when CUDA is
not available or the package is not beside this script.

``--times-only`` runs the card, serve, engine, engine_long, the engine and
generate profiles, the flash, span-decode and LayerNorm times phases and
the LayerNorm host breakdown alone, for the elephas_tpu_torch package in
DIR (default: beside this script), building its kernels as that package
builds them: run it for two checkouts in turns on one card to compare
them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

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

# one fit each of the smaller zoo models at their builders' defaults, on
# synthetic data of their shapes (rows, batch, epochs)
ZOO_ROWS, ZOO_BATCH, ZOO_EPOCHS = 2048, 128, 1

# span decode vs plain version, over every span bucket of A's maxlen: the
# engine's 16 slots and 4 heads at every head dim (config A's 128, B's 64),
# where the span is split over several blocks, and 64 slots of 8 heads,
# where B·H alone fills the card (one split)
SPAN_CASES = [(16, 4, 128), (16, 4, 64), (16, 4, 32), (16, 4, 16), (64, 8, 64)]
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
    'ln_fwd_kernel<float32, 4>', '..span_decode_kernelILi64EE..' ->
    'span_decode_kernel<64>', '..span_decode_merge_kernelILi64EE..' ->
    'span_decode_merge_kernel<64>'."""
    m = re.search(r"\d((?:flash|ln|span)_\w*?kernel)I(f|13__nv_bfloat16)?((?:Li\d+E)*)",
                  mangled)
    if not m:
        m = re.search(r"\d((?:flash|ln|span)_\w*?kernel)", mangled)
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
    ln_sass = _sass_counts(targets["layer_norm"], "ln_fwd", LN_SASS_OPS)
    emit({"phase": "build", "seconds": seconds, "sources": sorted(_native.SOURCES),
          "ptxas": ptxas, "flash_sass": sass, "span_decode_instantiations": span,
          "layer_norm_fwd_sass": ln_sass})
    spills = [f"{name}: {r}" for log in ptxas.values() for name, r in log.items()
              if r.get("spill_stores") or r.get("spill_loads")]
    missing = [name for name, c in sass.items() if not (c["HMMA"] and c["LDGSTS"])]
    ln_faults = _ln_sass_faults(ln_sass)
    if spills or missing or len(sass) != 8 or len(span) != 8 or ln_faults:
        raise AssertionError(f"build: spills {spills}; flash kernels without HMMA or "
                             f"LDGSTS {missing}; {len(sass)} flash instantiations, want 8; "
                             f"span decode instantiations {span}, want 8 (split and merge "
                             f"kernels at 4 head dims); LayerNorm forward {ln_faults}")


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
    pos[:3] = torch.tensor([0, span - 1, span + 7], dtype=torch.int32)
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
            ref = fs.flash_span_chunk(q[:, :, None], k, v, pos[:, None])[:, :, 0]
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


def phase_kernel(dev):
    """Each kernel against its plain version; returns each kernel's
    largest fp32 error (flash out, LayerNorm y, LayerNorm dx, span decode
    out)."""
    flash, flash_failures = _kernel_flash(dev)
    ln_rows, ln_failures = _kernel_layer_norm(dev)
    span_rows, span_failures = _kernel_span_decode(dev)
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
                  "span_decode_of_max_1_abs_out": TOL_SPAN},
          "flash": flash, "layer_norm": ln_rows, "span_decode": span_rows})
    failures = flash_failures + ln_failures + span_failures
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    f32 = [r for r in ln_rows if r["dtype"] == "float32"]
    return {
        "flash_fwd": max(r["err_out"] for r in flash if r["dtype"] == "float32"),
        "layer_norm_fwd": max(r["err_y"] for r in f32),
        "layer_norm_bwd": max(r["err_dx"] for r in f32),
        "span_decode": max(r["abs_err"] for r in span_rows),
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
            "flash_fwd_bf16": fa.bf16_launches, "layer_norm_fwd_bf16": ln.fwd_bf16_launches,
            "layer_norm_bwd_bf16": ln.bwd_bf16_launches}


def _reset_launches():
    from elephas_tpu_torch.ops import flash_attention as fa
    from elephas_tpu_torch.ops import flash_serving as fs
    from elephas_tpu_torch.ops import layer_norm as ln

    fa.launches = ln.fwd_launches = ln.bwd_launches = fs.launches = 0
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
    whose gradient the kernels lost reads 1."""
    spec = model.training_spec
    grads = {}
    model.train()
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        spec.loss(y, model(x, plain=plain)).mean().backward()
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
            "layer_norm_bwd": 2 * norms * steps, "span_decode": 0,
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


def _long_workload(vocab):
    rng = np.random.default_rng(1)
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


# kernel name fragment → class, first match wins
KERNEL_CLASSES = (
    ("flash_fwd_kernel", "flash_fwd"),
    ("span_decode_merge_kernel", "span_decode_merge"),
    ("span_decode_kernel", "span_decode"),
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


def _profile(dev, fn, what, per=1, extra=None):
    """``fn`` once under torch.profiler (after the caller's warm-up):
    device time by kernel class and the top kernels beside the wall time,
    each divided by ``per`` (steps in the call), with ``extra`` in the
    printed line. Reports, and does not fail, when the profiler records
    no device time."""
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
    from torch.nn.functional import scaled_dot_product_attention

    from elephas_tpu_torch.ops import flash_serving as fs

    b, h = ENGINE["num_slots"], CONFIGS["A"]["num_heads"]
    d = CONFIGS["A"]["d_model"] // h
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splitting = hasattr(fs, "span_splits")
    rows = {}
    for span in SPAN_TIMES:
        q, k, v, pos = _span_inputs(b, h, d, span, dev, 17)
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        cols = torch.arange(span, device=dev)
        mask = (cols[None, :] <= pos[:, None])[:, None, None, :].expand(b, h, 1, span)
        fns = {
            "ms": lambda: fs.flash_span_decode(q, k, v, pos),
            "plain_ms": lambda: fs.flash_span_chunk(q4, k, v, pos[:, None]),
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
        if splitting:
            splits, chunk = fs.span_splits(span, b * h, sms)
            row.update({"splits": splits, "chunk": chunk,
                        "split_sweep_device_ms_eager_ms": _split_sweep(fs, q, k, v, pos),
                        "workspace_alloc_host_ms": _alloc_host_ms(
                            b * h * splits * (d + 2), dev) if splits > 1 else 0.0})
        rows[f"span{span}"] = row
    emit({"phase": "times", "kernel": "span_decode", "timing": GRAPH_TIMING, **rows})
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


def _kernel_entry(name, source, replaces, launches, err, times):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times["ms"],
        "device_ms": times["device_ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"],
    }


def times_only(dev):
    """The phases that time the main path (serve, the engine and its
    long-span pass with their decode-window profiles, the generate
    profiles, the flash, span-decode and LayerNorm rows, the LayerNorm
    host breakdown) for the package that
    ``elephas_tpu_torch`` imports, with its kernels built as that package
    builds them."""
    import elephas_tpu_torch
    from elephas_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.build()
    emit({"phase": "build", "package": os.path.dirname(elephas_tpu_torch.__file__),
          "seconds": time.perf_counter() - t0})
    phase_serve(dev)
    _, lm = phase_engine(dev)
    phase_engine_long(dev, lm)
    phase_profile_engine(dev, lm)
    del lm
    phase_profile_generate(dev)
    phase_times(dev)
    phase_times_span_decode(dev)
    phase_times_layer_norm(dev)
    phase_ln_host_breakdown(dev)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--times-only", action="store_true",
                        help="run only the serve, engine, engine_long, profile, "
                             "times and LayerNorm host breakdown phases")
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
    engine, lm = phase_engine(dev)
    phase_engine_long(dev, lm)
    for path, launches, kernels in (
        ("serve", serve, ("flash_fwd", "layer_norm_fwd")),
        ("train", train, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("train_bf16", train_bf16, ("flash_fwd_bf16", "layer_norm_fwd_bf16",
                                    "layer_norm_bwd_bf16")),
        ("train_workers", train_workers, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
        ("train_stream", train_stream, ("flash_fwd_bf16", "layer_norm_fwd_bf16",
                                        "layer_norm_bwd_bf16")),
        ("engine", engine, ("span_decode", "flash_fwd", "layer_norm_fwd")),
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

    print(nvidia_smi(), flush=True)
    total = {k: serve[k] + train[k] + train_bf16[k] + train_workers[k] + train_stream[k]
             + engine[k] for k in serve}
    emit({"kernels": [
        _kernel_entry(
            "flash_fwd", "elephas_tpu_torch/csrc/flash_fwd.cu",
            "elephas_tpu/ops/flash_attention.py:41 (_fwd_kernel via "
            "_flash_forward :122 and _flash_forward_packed :250); "
            "elephas_tpu/ops/flash_attention.py:164 (_fwd_kernel_grouped via "
            "_flash_forward_packed_grouped :319)",
            total["flash_fwd"], errs["flash_fwd"], flash),
        _kernel_entry(
            "layer_norm_fwd", "elephas_tpu_torch/csrc/layer_norm.cu",
            "elephas_tpu/ops/layer_norm.py:52 (_fwd_kernel via _fwd_call :96)",
            total["layer_norm_fwd"], errs["layer_norm_fwd"],
            ln_times["layer_norm_fwd_train_float32"]),
        _kernel_entry(
            "layer_norm_bwd", "elephas_tpu_torch/csrc/layer_norm.cu",
            "elephas_tpu/ops/layer_norm.py:66 (_bwd_kernel via _ln_bwd_rule :128)",
            total["layer_norm_bwd"], errs["layer_norm_bwd"],
            ln_times["layer_norm_bwd_train_float32"]),
        _kernel_entry(
            "span_decode", "elephas_tpu_torch/csrc/span_decode.cu",
            "elephas_tpu/ops/flash_serving.py:153 (flash_span_decode: flash_span_chunk :93 "
            "with one query row; plain XLA in the reference, not a Pallas kernel)",
            total["span_decode"], errs["span_decode"], span_times["span128"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
