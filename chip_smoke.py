#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (elephas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

1. card   — device name and count, nvidia-smi's name and power limit;
2. build  — nvcc builds every kernel from the sources in this checkout
            (time, and what -Xptxas -v reports);
3. kernel — each kernel against its plain PyTorch version on the card,
            at the main paths' shapes, fp32 and bf16: the flash forward
            (causal and not) and the LayerNorm forward and backward;
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
6. profile — one more training step under torch.profiler: device time
            by kernel class (GEMMs, flash, LayerNorm, elementwise, ...) and
            the device's idle share of the step;
7. times  — kernel, plain version and the PyTorch library call (a
            yardstick the port never calls: scaled_dot_product_attention,
            torch.nn.functional.layer_norm and its autograd backward)
            from CUDA events at the main paths' shapes, beside the card's
            bound; the plain flash backward per layer at the training
            shape.

Then the card's nvidia-smi line, the {"kernels": [...]} line (launches
summed over the serve and train paths, times at config A's attention
shape and at the training rows, fp32), and last
{"ok": true, "device": {...}}. Exits non-zero with no result when CUDA is
not available or the package is not beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

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
]
TOL_OUT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_LSE = 1e-4
TOL_LOGITS = 1e-3
MARGIN = 1e-3

# LayerNorm kernels vs plain version: rows N and width d of the training
# path (batch 128 x 256 tokens at d 1024), of generate's rows for configs
# A and B (one prompt: maxlen rows), and one ragged case
LN_CASES = [(32768, 1024), (512, 512), (256, 256), (1000, 200)]
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
# kernel vs plain gradients, relative to each tensor's largest gradient
TOL_GRAD = 1e-3

TIMING = "CUDA events, mean of 50 launches after 5 warm-up, median of 3 rounds in turns"


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


def phase_build():
    from elephas_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.build()
    ptxas = {
        name: [ln.strip() for ln in log["ptxas"].splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in _native.build_log.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(_native.SOURCES), "ptxas": ptxas})


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


def _kernel_layer_norm(dev):
    from elephas_tpu_torch.ops import layer_norm as ln

    results, failures = [], []
    for n, d in LN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, gamma, beta, dy = _ln_inputs(n, d, dtype, dev, n + d)
            y, mean, rstd = ln.layer_norm_forward(x, gamma, beta, LN_EPS)
            dx, dg, db = ln.layer_norm_backward(x, gamma, dy, mean, rstd)
            ry, rmean, rrstd = ln.layer_norm_forward_reference(x, gamma, beta, LN_EPS)
            rdx, rdg, rdb = ln.layer_norm_backward_reference(x, gamma, dy, rmean, rrstd)
            torch.cuda.synchronize()
            row = {
                "N": n, "d": d, "dtype": str(dtype).split(".")[-1],
                "err_y": _err(y, ry),
                "rel_err_mean": _rel(mean, rmean), "rel_err_rstd": _rel(rstd, rrstd),
                "err_dx": _err(dx, rdx),
                "rel_err_dgamma": _rel(dg, rdg), "rel_err_dbeta": _rel(db, rdb),
            }
            row["ok"] = (row["err_y"] <= TOL_LN_Y[dtype] and row["err_dx"] <= TOL_LN_DX[dtype]
                         and max(row["rel_err_mean"], row["rel_err_rstd"]) <= TOL_LN_STATS
                         and max(row["rel_err_dgamma"], row["rel_err_dbeta"]) <= TOL_LN_DPARAM)
            results.append(row)
            if not row["ok"]:
                failures.append(row)
    return results, failures


def phase_kernel(dev):
    """Each kernel against its plain version; returns each kernel's
    largest fp32 error (flash out, LayerNorm y, LayerNorm dx)."""
    flash, flash_failures = _kernel_flash(dev)
    ln_rows, ln_failures = _kernel_layer_norm(dev)
    emit({"phase": "kernel",
          "tol": {"flash_out": {"float32": TOL_OUT[torch.float32],
                                "bfloat16": TOL_OUT[torch.bfloat16]},
                  "flash_lse": TOL_LSE,
                  "ln_y": {"float32": TOL_LN_Y[torch.float32],
                           "bfloat16_of_max_1_abs_y": TOL_LN_Y[torch.bfloat16]},
                  "ln_mean_rstd_relative": TOL_LN_STATS,
                  "ln_dx": {"float32": TOL_LN_DX[torch.float32],
                            "bfloat16_of_max_1_abs_dx": TOL_LN_DX[torch.bfloat16]},
                  "ln_dgamma_dbeta_relative": TOL_LN_DPARAM},
          "flash": flash, "layer_norm": ln_rows})
    failures = flash_failures + ln_failures
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    f32 = [r for r in ln_rows if r["dtype"] == "float32"]
    return {
        "flash_fwd": max(r["err_out"] for r in flash if r["dtype"] == "float32"),
        "layer_norm_fwd": max(r["err_y"] for r in f32),
        "layer_norm_bwd": max(r["err_dx"] for r in f32),
    }


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32) for n in PROMPT_LENS]


def _launches():
    from elephas_tpu_torch.ops import flash_attention as fa
    from elephas_tpu_torch.ops import layer_norm as ln

    return {"flash_fwd": fa.launches, "layer_norm_fwd": ln.fwd_launches,
            "layer_norm_bwd": ln.bwd_launches}


def _reset_launches():
    from elephas_tpu_torch.ops import flash_attention as fa
    from elephas_tpu_torch.ops import layer_norm as ln

    fa.launches = ln.fwd_launches = ln.bwd_launches = 0


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
                "layer_norm_bwd": 0,
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
    weights; returns {name: error relative to the tensor's largest
    plain gradient} and {name: that largest magnitude}."""
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


def phase_train(dev):
    """The kernel-vs-plain gradient check on the first batch from the
    initial weights (where no gradient is zero: after the fit, random
    labels saturate the softmax into the loss's clip, where every
    gradient is 0); then SparkModel.fit of the classifier at the training
    widths: launches per step (layers flash forwards, 2·layers+1
    LayerNorm forwards and as many backwards, each of those two
    launches), finite losses, a history with loss and accuracy."""
    from elephas_tpu_torch import SparkModel, transformer_classifier

    x, y = _synthetic_tokens(TRAIN_ROWS, TRAIN["maxlen"], TRAIN["vocab_size"],
                             TRAIN["num_classes"])
    model = transformer_classifier(**TRAIN, seed=0, device=dev)
    layers = TRAIN["num_layers"]
    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_BATCH)
    failures = []
    xb = torch.from_numpy(x[:TRAIN_BATCH]).long().to(dev)
    yb = torch.from_numpy(y[:TRAIN_BATCH]).long().to(dev)
    grad_err, grad_scale = _gradient_check(model, xb, yb)
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > TOL_GRAD:
        failures.append(f"gradient of {worst}: kernel vs plain {grad_err[worst]}")
    vanished = [n for n, v in grad_scale.items() if not v > 0]
    if vanished:
        failures.append(f"all-zero gradients, the check is vacuous for {vanished}")

    sm = SparkModel(model, device=dev)
    # a stamp at the start of every step's forward (after the previous
    # step's work has finished) times the steps
    stamps = []

    def stamp(_module, _inputs):
        torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    hook = model.register_forward_pre_hook(stamp)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    try:
        history = sm.fit((x, y), epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())
    finally:
        hook.remove()
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"flash_fwd": layers * steps, "layer_norm_fwd": (2 * layers + 1) * steps,
            "layer_norm_bwd": 2 * (2 * layers + 1) * steps}
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if sorted(history) != ["accuracy", "loss"] or \
            any(len(v) != TRAIN_EPOCHS or not np.all(np.isfinite(v)) for v in history.values()):
        failures.append(f"bad history {history}")
    step_s = np.diff(stamps)
    if len(step_s) != steps:
        failures.append(f"{len(step_s)} steps timed, expected {steps}")
    tokens_s = (steps - 1) * TRAIN_BATCH * TRAIN["maxlen"] / float(np.sum(step_s[1:]))
    emit({"phase": "train", "config": TRAIN, "rows": TRAIN_ROWS, "batch": TRAIN_BATCH,
          "epochs": TRAIN_EPOCHS, "steps": steps, "launches": launches,
          "launches_expected": want, "history": history,
          "step_seconds": step_s.tolist(), "median_step_s_after_first": float(np.median(step_s[1:])),
          "tokens_s_after_first": tokens_s, "max_memory_allocated": peak,
          "grad_tol_relative": TOL_GRAD, "grad_max_rel_err": grad_err[worst],
          "grad_worst_param": worst, "grad_min_scale": min(grad_scale.values()),
          "failures": failures})
    if failures:
        raise AssertionError(f"training path check failed: {failures}")
    return launches, model, (xb, yb)


# kernel name fragment → class, first match wins
KERNEL_CLASSES = (
    ("flash_fwd_kernel", "flash_fwd"),
    ("ln_fwd_kernel", "layer_norm_fwd"),
    ("ln_bwd", "layer_norm_bwd"),
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


def phase_profile(dev, model, batch):
    """One training step of the trained classifier (forward, loss,
    backward, Adam) under torch.profiler, after one warm-up step: device
    time by kernel class and the top kernels, beside the step's wall
    time. Reports, and does not fail, when the profiler records no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = model.training_spec
    xb, yb = batch

    def step():
        loss = spec.loss(yb, model(xb)).mean()
        spec.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        spec.optimizer.step()

    model.train()
    step()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    model.eval()
    device_events = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    # a user annotation (Optimizer.step#Adam.step) spans kernels counted
    # on their own
    annotations = [ev.key for ev in device_events if ev.is_user_annotation]
    kernels = [ev for ev in device_events if not ev.is_user_annotation]
    by_class, top = {}, []
    for ev in kernels:
        ms = ev.self_device_time_total / 1e3
        cls = _kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.append((ms, ev.count, ev.key[:120]))
    device_ms = sum(by_class.values())
    out = {"phase": "profile", "what": "one training step, TRAIN config",
           "wall_ms": wall_ms, "device_ms": device_ms,
           "annotations_excluded": annotations}
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


def phase_times(dev):
    """Kernel, plain and library times at the attention shapes of the
    main path (the packed layout of the default path, causal), in turns:
    config A at batch 8 and at batch 1 (as each generate() call here runs
    it), and config B (head_dim 64) at batch 8."""
    from torch.nn.functional import scaled_dot_product_attention

    from elephas_tpu_torch.ops.flash_attention import (
        _flash_forward_packed, flash_forward_reference,
    )

    rows = {}
    for name, b in (("A", 8), ("A", 1), ("B", 8)):
        cfg = CONFIGS[name]
        s, h = cfg["maxlen"], cfg["num_heads"]
        d = cfg["d_model"] // h
        for dtype in (torch.float32, torch.bfloat16):
            qkv, (q, k, v) = _case_inputs("packed", b, s, h, d, dtype, dev, 7)
            scale = d ** -0.5
            fns = {
                "ms": lambda: _flash_forward_packed(qkv, scale, True, 128, 128),
                "plain_ms": lambda: flash_forward_reference(q, k, v, scale, True),
                "library_ms": lambda: scaled_dot_product_attention(q, k, v, is_causal=True),
            }
            samples = _time_in_turns(fns)
            flops = 2 * b * h * s * s * d
            nbytes = 4 * b * h * s * d * qkv.element_size() + 4 * b * h * s
            rows[f"{name}_B{b}_{str(dtype).split('.')[-1]}"] = {
                **_summary(samples, nbytes, flops, dtype),
                "shape": {"B": b, "S": s, "H": h, "D": d},
            }
    emit({"phase": "times", "kernel": "flash_fwd", "layout": "packed", "causal": True,
          "timing": TIMING, **rows})
    return rows


def _time_in_turns(fns):
    samples = {key: [] for key in fns}
    for _ in range(3):
        for key, fn in fns.items():
            samples[key].append(_time_ms(fn))
    return samples


def _summary(samples, nbytes, flops, dtype):
    """Median times, and the bound: the larger of bytes over the card's
    memory rate and operations over its peak for the type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S[dtype]
    return {
        **{key: float(np.median(v)) for key, v in samples.items()},
        "samples": samples,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "flops": flops, "bytes": nbytes,
    }


def phase_times_layer_norm(dev):
    """The LayerNorm kernels at the training rows (batch x maxlen rows of
    d_model: 32768 x 1024) and at config A's generate rows (maxlen rows of
    d_model: 512 x 512), fp32 and bf16. Library: the
    forward of torch.nn.functional.layer_norm and its autograd backward
    (dx, dgamma, dbeta). Bytes: each input read once and each output
    written once; operations: about 8 (forward) and 12 (backward) per
    element."""
    from torch.nn.functional import layer_norm as torch_layer_norm

    from elephas_tpu_torch.ops import layer_norm as ln

    rows = {}
    shapes = {"train": (TRAIN_BATCH * TRAIN["maxlen"], TRAIN["d_model"]),
              "A": (CONFIGS["A"]["maxlen"], CONFIGS["A"]["d_model"])}
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
            rows[f"layer_norm_fwd_{tag}"] = {"N": n, "d": d, **_summary(
                _time_in_turns(fwd), 2 * n * d * item + 2 * d * 4 + 2 * n * 4,
                8 * n * d, dtype)}
            rows[f"layer_norm_bwd_{tag}"] = {"N": n, "d": d, **_summary(
                _time_in_turns(bwd), 3 * n * d * item + d * 4 + 2 * n * 4 + 2 * d * 4,
                12 * n * d, dtype)}
    emit({"phase": "times", "kernel": "layer_norm", "timing": TIMING, **rows})
    return rows


def phase_times_train(dev):
    """At the training shape (packed qkv B128 S256 H8 D128, not causal,
    fp32): the flash forward kernel, and the plain flash backward of one
    layer (the recomputed scores, then four products: about 2.5x the
    forward's operations)."""
    from elephas_tpu_torch.ops.flash_attention import _flash_forward_packed, flash_backward

    b, s, h = TRAIN_BATCH, TRAIN["maxlen"], TRAIN["num_heads"]
    d = TRAIN["d_model"] // h
    qkv, (q, k, v) = _case_inputs("packed", b, s, h, d, torch.float32, dev, 13)
    scale = d ** -0.5
    out, lse = _flash_forward_packed(qkv, scale, False, 128, 128)
    g = torch.randn_like(out)
    o, gg = out.transpose(1, 2), g.transpose(1, 2)
    lse = lse.view(b, h, s)
    fwd_flops = 4 * b * h * s * s * d
    rows = {
        "flash_fwd_train": _summary(
            _time_in_turns({"ms": lambda: _flash_forward_packed(qkv, scale, False, 128, 128)}),
            4 * b * h * s * d * 4 + 4 * b * h * s, fwd_flops, torch.float32),
        "flash_bwd_plain_train": _summary(
            _time_in_turns({"plain_ms": lambda: flash_backward(q, k, v, o, lse, gg, scale,
                                                                False)}),
            8 * b * h * s * d * 4 + 4 * b * h * s, fwd_flops * 5 // 2, torch.float32),
    }
    emit({"phase": "times", "kernel": "train_attention",
          "shape": {"B": b, "S": s, "H": h, "D": d}, "timing": TIMING, **rows})
    return rows


def _kernel_entry(name, source, replaces, launches, err, times):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times["ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    phase_card()
    phase_build()
    errs = phase_kernel(dev)
    serve = phase_serve(dev)
    train, model, batch = phase_train(dev)
    for path, launches, kernels in (
        ("serve", serve, ("flash_fwd", "layer_norm_fwd")),
        ("train", train, ("flash_fwd", "layer_norm_fwd", "layer_norm_bwd")),
    ):
        idle = [k for k in kernels if launches[k] == 0]
        if idle:
            raise AssertionError(f"the {path} path never launched {idle}")
    phase_profile(dev, model, batch)
    del model, batch
    flash = phase_times(dev)["A_B8_float32"]
    ln_times = phase_times_layer_norm(dev)
    phase_times_train(dev)

    print(nvidia_smi(), flush=True)
    total = {k: serve[k] + train[k] for k in serve}
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
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
