#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (elephas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

1. card   — device name and count, nvidia-smi's name and power limit;
2. build  — nvcc builds every kernel from the sources in this checkout
            (time, and what -Xptxas -v reports);
3. kernel — each kernel against its plain PyTorch version on the card,
            at the slice's shapes, fp32 and bf16, causal and not;
4. serve  — the main path: generate() on transformer_lm at full width
            (config A with and without rope, config B), and one
            transformer_classifier forward, with launch counts; then a
            teacher-forced check of the emitted tokens and logits
            against the plain attention path on the card;
5. times  — kernel, plain version and the PyTorch library call
            (scaled_dot_product_attention, a yardstick the port never
            calls) from CUDA events at config A's attention shapes,
            beside the card's bound; generate tokens/s and peak memory.

Then the card's nvidia-smi line, the {"kernels": [...]} line, and last
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


def phase_kernel(dev):
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
    emit({"phase": "kernel", "tol_out": {"float32": TOL_OUT[torch.float32],
          "bfloat16": TOL_OUT[torch.bfloat16]}, "tol_lse": TOL_LSE,
          "cases": results})
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")
    return max(r["err_out"] for r in results if r["dtype"] == "float32")


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32) for n in PROMPT_LENS]


def drive_main_path(dev):
    """generate() on config A (rope off and on) and config B, one prompt
    per call, and one classifier forward; asserts each call's launches."""
    from elephas_tpu_torch import generate, transformer_classifier, transformer_lm
    from elephas_tpu_torch.ops import flash_attention as fa

    runs = []
    for name, rope in (("A", False), ("A", True), ("B", False)):
        cfg = CONFIGS[name]
        model = transformer_lm(**cfg, rope=rope, seed=0, device=dev)
        outs, seconds = [], 0.0
        for prompt in _prompts(cfg["vocab_size"]):
            before = fa.launches
            t0 = time.perf_counter()
            out = generate(model, prompt[None], steps=STEPS)
            seconds += time.perf_counter() - t0
            got = fa.launches - before
            if got != cfg["num_layers"] * STEPS:
                raise AssertionError(
                    f"config {name} rope={rope}: {got} kernel launches, "
                    f"expected layers x steps = {cfg['num_layers'] * STEPS}"
                )
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
    before = fa.launches
    with torch.inference_mode():
        probs = clf(x)
    if fa.launches - before != cfg["num_layers"]:
        raise AssertionError("classifier forward did not launch the kernel per layer")
    return runs, (clf, x, probs)


def check_main_path(runs, classifier):
    """Emitted tokens and logits against the plain attention path."""
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
    from elephas_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = 0
    runs, classifier = drive_main_path(dev)
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated(dev)
    report, clf, failures = check_main_path(runs, classifier)
    emit({"phase": "serve", "steps": STEPS, "prompt_lens": PROMPT_LENS.tolist(),
          "launches": launches, "runs": report, "classifier": clf,
          "max_memory_allocated": peak, "failures": failures})
    if failures:
        raise AssertionError(f"main path check failed: {failures}")
    return launches


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
            samples = {key: [] for key in fns}
            for _ in range(3):
                for key, fn in fns.items():
                    samples[key].append(_time_ms(fn))
            flops = 2 * b * h * s * s * d
            nbytes = 4 * b * h * s * d * qkv.element_size() + 4 * b * h * s
            t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S[dtype]
            rows[f"{name}_B{b}_{str(dtype).split('.')[-1]}"] = {
                **{key: float(np.median(v)) for key, v in samples.items()},
                "samples": samples,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "flops": flops, "bytes": nbytes,
                "shape": {"B": b, "S": s, "H": h, "D": d},
            }
    emit({"phase": "times", "layout": "packed", "causal": True,
          "timing": "CUDA events, mean of 50 launches after 5 warm-up, "
          "median of 3 rounds in turns", **rows})
    return rows


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
    err = phase_kernel(dev)
    launches = phase_serve(dev)
    times = phase_times(dev)["A_B8_float32"]

    print(nvidia_smi(), flush=True)
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "elephas_tpu_torch/csrc/flash_fwd.cu",
        "replaces": (
            "elephas_tpu/ops/flash_attention.py:41 (_fwd_kernel via "
            "_flash_forward :122 and _flash_forward_packed :250); "
            "elephas_tpu/ops/flash_attention.py:164 (_fwd_kernel_grouped via "
            "_flash_forward_packed_grouped :319)"
        ),
        "launches": launches,
        "max_abs_err": err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
