#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each:

1. card: the device, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the serve paths, compiled from ``src/``, one
   ``nvcc`` per source, all at once;
3. kernel checks: each kernel against its plain PyTorch version on the card,
   at the test shapes and at the serving shape, then timed at the serving
   shape beside the plain version and, where there is one, a PyTorch
   library call (flash attention: K2; SSD chunk scan: K3);
4. for each served model, qwen3-14b (K2) and then mamba2-1.3b (K3):
   - depth2: the model at full width cut to 2 layers; prefill logits through
     the kernel against the same model with the kernel's plain version;
   - serve: the full model (bf16, random weights from a seed) serves 4
     requests of 1024 prompt tokens + 32 greedy tokens through
     ``repro_torch.launch.serve.generate``; every kernel's launch count is
     zeroed just before and read just after;
   - profile: a ``torch.profiler`` pass over one prefill and 8 decode steps
     gives the device's busy share.

Then the ``kernels`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (dtype, (bh, sq, sk, hd, g), causal, window, q_offset)
CHECKS = [(dt, s, s[1] == s[2], None, 0) for dt in ("float32", "bfloat16") for s in (
    (2, 128, 128, 64, 1), (4, 256, 256, 128, 2), (2, 100, 100, 64, 1), (3, 64, 192, 32, 3))] + [
    ("float32", (2, 256, 256, 64, 1), True, 64, 0),
    ("bfloat16", (2, 256, 256, 64, 1), True, 64, 0),
    ("float32", (1, 32, 128, 64, 1), True, None, 96),
    ("float32", (2, 16, 40, 32, 1), True, None, -8),          # fully masked rows
    ("bfloat16", (160, 1024, 1024, 128, 5), True, None, 0),   # serving shape
    ("bfloat16", (160, 1000, 1000, 128, 5), True, None, 0),   # ragged serving shape
]
SERVING = ("bfloat16", (160, 1024, 1024, 128, 5), True, None, 0)
# (dtype, (bh, s, p, n, chunk, heads_per_group, initial state)): the test
# shapes, a chunk that is no power of two, the warm-up's chunk 16 at the
# serving widths, a carried-in state, and the serving shape (4 requests x 64
# heads of one group, so heads_per_group 64)
SSD_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SSD_SERVING = ("bfloat16", (256, 1024, 64, 128, 128, 64, False))
SSD_CHECKS = [(dt, s) for dt in ("float32", "bfloat16") for s in (
    (2, 64, 32, 16, 16, 1, False), (4, 128, 64, 32, 32, 1, False),
    (2, 128, 64, 128, 64, 1, False))] + [
    ("float32", (2, 200, 64, 128, 100, 1, False)),
    ("bfloat16", (256, 100, 64, 128, 100, 64, False)),
    ("bfloat16", (256, 16, 64, 128, 16, 64, False)),
    ("float32", (8, 256, 64, 128, 128, 4, True)),
    SSD_SERVING,
]
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn) -> dict:
    """Kernel time on the device (``torch.profiler``) against the host clock
    for one call of ``fn``; the profiler's own host cost inflates the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernel_launches":
            sum(e.count for e in kernels),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]}


def attention_bound_ms(dtype: str, shape, causal: bool, window, q_offset: int):
    """Least time for the work of these inputs: unmasked (q, k) pairs × 4·hd
    operations, and q, k, v read once and the output written once."""
    import torch
    bh, sq, sk, hd, g = shape
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    flops = 4.0 * hd * bh * float(keep.sum())
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * hd * (2 * bh * sq + 2 * (bh // g) * sk)
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def ssd_bound_ms(dtype: str, shape):
    """Least time for the SSD scan's work: per (row, chunk) 2·Q²·N (C·Bᵀ),
    2·Q²·P (W·X) and 2·Q·N·P each for C·state and Bᵀ·(decay·X); x, dt, A,
    B and C (once per group) read once, y and the final state written once."""
    bh, s, p, n, chunk, g, with_state = shape
    flops = float(bh * (s // chunk)) * (2 * chunk * chunk * (n + p) + 4 * chunk * n * p)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (size * (2 * bh * s * p + 2 * (bh // g) * s * n) + 4 * (bh * s + bh)
              + 4 * bh * n * p * (2 if with_state else 1))
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def ssd_inputs(dtype: str, shape, gen):
    """Inputs on the card. The serving shape takes the model's A (-1 … -16
    per head), where exp(cum_i - cum_j) overflows above the diagonal."""
    import torch
    bh, s, p, n, chunk, g, with_state = shape
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)
    x = randn(bh, s, p).to(tdt)
    dt = torch.nn.functional.softplus(randn(bh, s))
    if g == 64:
        A = -torch.linspace(1.0, 16.0, 64, device=dev).repeat(bh // 64)
    else:
        A = -torch.exp(randn(bh) * 0.3)
    Bm, Cm = (randn(bh // g, s, n) * 0.3).to(tdt), (randn(bh // g, s, n) * 0.3).to(tdt)
    kw = dict(chunk=chunk, heads_per_group=g,
              initial_state=randn(bh, n, p) if with_state else None)
    return (x, dt, A, Bm, Cm), kw


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward_decode, forward_prefill, init_params
    ops = importlib.import_module("repro_torch.kernels.ops")

    # 1. card -----------------------------------------------------------------
    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "card", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build(["flash_attention", "ssd_scan"])
    regs = sorted({line.split("Used ")[1].split(",")[0]
                   for log in logs.values() for line in log.splitlines() if "Used " in line})
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(logs),
          "registers": regs})

    # 3. kernel against plain --------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    serving_err = None
    for dtype, shape, causal, window, q_offset in CHECKS:
        bh, sq, sk, hd, g = shape
        tdt = getattr(torch, dtype)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(tdt)
                   for s in ((bh, sq, hd), (bh // g, sk, hd), (bh // g, sk, hd)))
        kw = dict(q_heads_per_kv=g, causal=causal, window=window, q_offset=q_offset)
        got = flash_attention(q, k, v, **kw).float()
        want = flash_attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL[dtype]
        ok = bool(torch.allclose(got, want, **tol))
        emit({"phase": "kernel_check", "kernel": "flash_attention", "dtype": dtype,
              "shape": shape, "causal": causal, "window": window, "q_offset": q_offset,
              "max_abs_err": err, "tol": tol, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention differs from its plain version: {err}")
        if (dtype, shape, causal, window, q_offset) == SERVING:
            serving_err = err
            serving_inputs = (q, k, v, kw)
        del got, want

    q, k, v, kw = serving_inputs
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=5)
    bh, sq, hd = q.shape
    b, g = 4, kw["q_heads_per_kv"]
    q4, k4, v4 = (t.view(b, t.shape[0] // b, t.shape[1], hd) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                            enable_gqa=True), iters=20)
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(*SERVING)
    emit({"phase": "kernel_time", "kernel": "flash_attention", "shape": SERVING[1],
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "flops": flops, "bytes": nbytes,
          "tflops": flops / ms / 1e9, "smi": smi})
    del q, k, v, q4, k4, v4, serving_inputs
    timings = {"flash_attention": dict(max_abs_err=serving_err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=lib_ms)}

    for dtype, shape in SSD_CHECKS:
        args, kw = ssd_inputs(dtype, shape, gen)
        y, st = ssd_scan(*args, **kw)
        want_y, want_st = ssd_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(float((y.float() - want_y.float()).abs().max()),
                  float((st - want_st).abs().max()))
        tol = SSD_TOL[dtype]
        ok = (bool(torch.allclose(y.float(), want_y.float(), **tol))
              and bool(torch.allclose(st, want_st, **tol)))
        emit({"phase": "kernel_check", "kernel": "ssd_scan", "dtype": dtype, "shape": shape,
              "max_abs_err": err, "tol": tol, "ok": ok})
        if not ok:
            raise AssertionError(f"ssd_scan differs from its plain version: {err}")
        if (dtype, shape) == SSD_SERVING:
            serving_err, serving_inputs = err, (args, kw)
        del y, st, want_y, want_st
    args, kw = serving_inputs
    ms = cuda_ms(lambda: ssd_scan(*args, **kw), iters=20)
    plain_ms = cuda_ms(lambda: ssd_scan_plain(*args, **kw), iters=5)
    bound_ms, bound_by, flops, nbytes = ssd_bound_ms(*SSD_SERVING)
    emit({"phase": "kernel_time", "kernel": "ssd_scan", "shape": SSD_SERVING[1],
          "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
          "bound_by": bound_by, "flops": flops, "bytes": nbytes,
          "tflops": flops / ms / 1e9, "smi": smi})
    del args, kw, serving_inputs
    timings["ssd_scan"] = dict(max_abs_err=serving_err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    # 4. each served model: depth-2 check, serve, profile ----------------------
    counters = {"flash_attention": flash_attention, "ssd_scan": ssd_scan}
    plain = {"flash_attention": flash_attention_plain, "ssd_scan": ssd_scan_plain}
    launches = {}
    for arch, kernel in (("qwen3-14b", "flash_attention"), ("mamba2-1.3b", "ssd_scan")):
        cfg = get_config(arch)
        model = init_params(dataclasses.replace(cfg, num_layers=2), seed=0, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                               device=dev)
        with torch.inference_mode():
            lk = forward_prefill(model, tokens, SERVE_PROMPT + 1)[0].float()
            with mock.patch.object(ops, kernel, plain[kernel]):
                lp = forward_prefill(model, tokens, SERVE_PROMPT + 1)[0].float()
        err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
        ok = bool(torch.isfinite(lk).all()) and err <= 2e-2 * scale
        emit({"phase": "depth2", "arch": cfg.name, "kernel": kernel, "layers": 2,
              "max_abs_err": err, "max_abs_logit": scale, "tol": 2e-2 * scale, "ok": ok})
        if not ok:
            raise AssertionError(f"{arch}: depth-2 prefill through {kernel} differs from plain")
        del model, lk, lp
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        model = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        warm = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device=dev)
        generate(model, warm, 2)                   # warm-up: library handles, allocator
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        res = generate(model, tokens, SERVE_NEW)
        counts = {k: c.launches for k, c in counters.items()}
        launches[kernel] = counts[kernel]
        peak = torch.cuda.max_memory_allocated()
        want = {k: cfg.num_layers if k == kernel else 0 for k in counters}
        ok = (counts == want
              and tuple(res.ids.shape) == (SERVE_BATCH, SERVE_NEW + 1)
              and bool(((res.ids >= 0) & (res.ids < cfg.vocab_size)).all())
              and bool(torch.isfinite(res.prefill_logits).all())
              and bool(torch.isfinite(res.last_logits).all()))
        emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
              "params": n_params, "param_count": cfg.param_count(),
              "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
              "init_s": init_s, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
              "decode_tok_s": SERVE_BATCH * SERVE_NEW / res.decode_s,
              "prefill_tok_s": SERVE_BATCH * SERVE_PROMPT / res.prefill_s,
              "peak_mem_gb": peak / 1e9, "launches": counts,
              "sample_ids": res.ids[0, :8].tolist(), "device": name, "smi": smi, "ok": ok})
        if not ok:
            raise AssertionError(f"{arch}: serve check failed: launches {counts}, want {want}")

        # where the time goes: device kernel time per phase (outside the counted run)
        with torch.inference_mode():
            _, caches, clen = forward_prefill(model, tokens, SERVE_PROMPT + 9)
            prefill_prof = device_profile(
                lambda: forward_prefill(model, tokens, SERVE_PROMPT + 1))

            def decode_steps():
                c, n = caches, clen
                for _ in range(8):
                    _, c, n = forward_decode(model, tokens[:, -1:], c, n)
            decode_prof = device_profile(decode_steps)
        emit({"phase": "profile", "arch": cfg.name, "prefill": prefill_prof,
              "decode_8_steps": decode_prof,
              "unprofiled_prefill_ms": res.prefill_s * 1e3,
              "unprofiled_decode_step_ms": res.decode_s / SERVE_NEW * 1e3,
              "prefill_device_share": prefill_prof["device_busy_ms"] / (res.prefill_s * 1e3),
              "decode_device_share":
                  decode_prof["device_busy_ms"] / 8 / (res.decode_s / SERVE_NEW * 1e3),
              "smi": smi})
        del model, caches, res
        torch.cuda.empty_cache()

    emit({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:91",
         "launches": launches["flash_attention"], **timings["flash_attention"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:87",
         "launches": launches["ssd_scan"], **timings["ssd_scan"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
