#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each:

1. card: the device, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the port, compiled from ``src/``, one
   ``nvcc`` per source, all at once;
3. kernel checks: each kernel against its plain PyTorch version on the card,
   at the test shapes and at the shapes its paths give it, then timed at
   those shapes beside the plain version and, where there is one, a PyTorch
   library call (flash attention: K2, whose bf16 cases take the ``sm90``
   route and f32 cases the ``simt`` route, timed in turns with the ``simt``
   kernel at bf16 beside it, at qwen3-14b's serving shape, at kimi-k2's
   head_dim 112 and at every shape of ``SERVED_K2``: olmoe, kimi-k2 and
   jamba at batch 4, whisper's encoder, self- and cross-attention (Sk 1500),
   llama-3.2-vision's self- and cross-attention (Sk 6404); SSD chunk scan:
   K3, likewise, bf16 on the ``sm90`` route and f32 on the ``simt`` route,
   timed in turns with the ``simt`` kernel at bf16, at mamba2's and jamba's
   serving shapes (64 and 256 heads a group); int8 row quantizer: K1, which
   must equal its plain version exactly on either route, with and without
   the dequantized ``out``, timed with ``out`` beside the two launches it
   replaces, with its host cost per call; K2's backward
   (``flash_attention_bwd``: bf16 on the ``sm90`` route, wgmma + TMA, f32 on
   the ``simt`` route, CUDA cores), from the forward kernel's output and
   log-sum-exp (both held to the plain forward's), at phi4-mini-3.8b's
   training shape, the 100M demo's f32 shape and the mask cases of
   ``BWD_CHECKS``, every bf16 case on both routes (the ``simt`` kernel
   through ``_flash_attention_bwd_simt``), then timed at the first two in
   turns with the ``simt`` kernel at bf16, the autograd backward of SDPA and
   the plain version);
4. models: for each of ``SERVED_MODELS`` (qwen3-14b, mamba2-1.3b,
   olmoe-1b-7b, kimi-k2 cut to one layer, jamba cut to the first three
   positions of its pattern, whisper-medium, llama-3.2-vision-11b), bf16,
   random weights from a seed (``serve_model``):
   - depth_check: the model at full width cut to one layer of each block
     kind, every ``attn_gate`` at 2.0, a random modality input; prefill
     logits through the kernels against the same model with the kernels'
     plain versions, and the launches the config gives;
   - serve: the served model serves 4 requests of 1024 prompt tokens + 32
     greedy tokens through ``repro_torch.launch.serve.generate``, with the
     reference's stub modality input; every kernel's launch count is
     zeroed just before and read just after: K2 and K3 launch as the config
     gives (``expected_launches``), all on the ``sm90`` route; an MoE
     model's prefill, run twice more, equals the served one bit for bit;
   - profile (qwen3-14b, mamba2-1.3b, olmoe-1b-7b): a ``torch.profiler``
     pass over one prefill and 8 decode steps gives the device's busy
     share; olmoe's device time split into K2, the expert and router
     products, the MoE dispatch, the other products and the rest
     (``moe_profile``);
   then training (``train_check``, ``train_phase``, ``train_ckpt_phase``):
   - train_check: phi4-mini-3.8b at full width cut to one layer; the loss
     and every parameter's gradient through K2's forward and backward
     kernels against the plain forward differentiated by autograd, and the
     same limits rejecting a backward whose dQ and dK are zeroed;
   - train: phi4-mini-3.8b at full width and depth (32 layers, d 3072,
     vocab 200064), bf16, AdamW, remat on, batch 4 x 1024 tokens from
     ``MarkovDataset`` through ``repro_torch.train.train_step``: 2 warm-up
     steps, then 8 with every kernel's count zeroed just before and read
     just after (K2's forward 2 x 32 a step, all ``sm90``; its backward
     32, all ``sm90``), the loss per step, step seconds, tokens/s, peak memory,
     and one more step under the profiler split into K2's forward and
     backward, cuBLAS, the optimizer and the rest;
   - train_ckpt: the f32 100M demo of ``examples/train_100m_torch.py``
     through ``repro_torch.train.train``, 60 steps with a checkpoint at 40,
     then resumed from it: the resumed first loss equals the uninterrupted
     run's at step 40 bit for bit, and the loss falls; K2's forward and
     backward all on the ``simt`` route;
   then the launch tools of ``repro_torch.launch`` (``steps_phase``,
   ``dryrun_phase``, ``lanes_phase``):
   - steps: ``make_train_step``, ``make_prefill_step`` and
     ``make_decode_step`` on ``make_host_mesh()``, the card's 1×1 mesh:
     phi4-mini-3.8b at full width and depth (train 4 x 1024, bf16, AdamW,
     remat; prefill and 8 decode steps at batch 4 with 1024 prompt tokens)
     and mamba2-1.3b's prefill, each held first to the direct path it
     wraps (``train_step``'s losses, ``generate``'s logits and ids), then
     timed with every kernel's count zeroed just before and read just after
     (K2 forward and backward, K3, all ``sm90``), seconds, tokens/s and peak
     memory beside the dry run's three roofline terms for the same shape on
     the 1×1 mesh and the time's multiple of the largest;
   - dryrun: ``run_one`` of every config at the 16×16 mesh and
     ``prefill_32k`` on the meta device: ok or failed, the bottleneck and
     the seconds;
   - lanes: the per-card figures of ``gpu_lanes``: a bf16 cuBLAS product's
     rate at 256³–8192³, a device copy's bandwidth, an empty launch's and a
     CUDA graph replay's host time, beside the values in the code;
5. runtime: Puzzle's ``PuzzleRuntime`` on the card, three zoo networks at
   the paper's input resolution (yolov8n int8 on the ``default`` engine,
   fast_scnn fp16 on ``xnnpack``, pose_det fp32 on ``nnapi``), each split in
   two halves on two of the three Workers; 12 periodic requests of all
   three networks in each of three runs: the reference's dtype boundary,
   ``int8_staging`` (K1 on every boundary input of yolov8n's second half,
   all on its ``sm90`` route; every kernel's launch count zeroed just before
   the requests and read just after), and ``int8_staging`` with K1 swapped
   for its plain version.
   Then a ``torch.profiler`` pass over one request, the output differences
   between the runs, and the profiler backend's times beside the runtime's
   measured costs;
6. search: Puzzle's scheduler on the card, the paper's multiple-group
   protocol (Fig. 15): the first composition of
   ``random_scenarios(MODEL_NAMES, count=1, models_per_scenario=6,
   num_groups=2, seed=2025)`` at the paper's input resolutions, profiled by
   ``TorchExecBackend`` on the card; ``StaticAnalyzer.run_ga()`` with a
   measurement round on ``PuzzleRuntime`` (``int8_staging``) every second
   generation; then four schedules (the GA's, Best Mapping's, NPU Only and
   every network split in two int8 halves) each serve 12 requests per group
   at α = 1 on the runtime, beside the analyzer's prediction. Every kernel's
   launch count is zeroed just before the search and read after the last
   schedule; K1's launches must equal what the placements give, on the route
   ``_route`` gives each boundary shape;
7. conformance: the four schedules of ``search``, each through
   ``StaticAnalyzer.validate_on_runtime`` twice: replayed on the
   virtual-clock runtime, which must equal the simulator exactly (every
   timestamp, makespan and busy time, the same release order), then run
   on the card (``int8_staging``; every kernel's launch count zeroed just
   before and read just after; K1's launches must equal what the placement
   gives, K2's and K3's 0; both traces must hold the same task set, every
   makespan finite). Printed: each report's summary (its ``passed`` at
   ``rel_tol`` 0.35 is a finding), the per-task gap between the card's
   trace and the simulator's per processor (execution time, queueing wait,
   release time), and the static linter's codes. Then K1 is held against
   its plain version at every boundary shape phases 6 and 7 staged;
8. sweep: the paper's evaluation (§6) with the compiled batch engine on the
   card: the first 8 seed-0 scenarios of ``generate_scenario_specs`` (1-3
   groups x 1-4 models, the default ``SweepConfig``) through ``run_sweep``
   with ``use_batch`` and ``batch_engine="compiled"`` (the event-loop
   kernel, every kernel's launch count zeroed just before and read just
   after: more than 0 launches of ``batchsim_advance``, none of the others,
   no fallback), then with the numpy engine. Per scenario and method α*,
   satisfaction and seconds, both aggregates; α*, satisfaction and the
   geo-means must be equal. Every batch of the first two scenarios is held
   to ``BatchSimulator`` within ``COMPILED_REL_TOL``/``COMPILED_ABS_TOL``;
   the widest α*-search batch of the second to the kernel's plain version
   on the card (every output equal, per-lane events and ring pushes too)
   and to the thread-per-lane kernel the warp-per-lane design replaced
   (``_batchsim_advance_thread``, equal outputs; never launched by the
   sweep), the two kernels timed in turns, with the bytes, operations and
   latency bounds (the longest lane's events x the frontier's compares, one
   cycle each at the top SM clock), the time per event of the longest lane
   and ptxas's registers and spills; then that batch tiled to 16, 64, 256
   and 1024 lanes: both kernels' device time in turns, the host
   preparation, the whole compiled call, the numpy tier and the scalar
   ``FastSimulator`` loop, and the FIFO rings' bytes;
9. paper: the paper's evaluation harness (``repro_torch.experiments.paper``,
   the port of ``benchmarks/run.py``), every one of its 15 sections in this
   process at ``--smoke`` sizing on the card, one line each with its rows,
   seconds and launches (every kernel's count zeroed just before a section
   and read just after): ``simspeed``'s compiled legs launch B1 with no
   fallback and hold the numpy tier's objectives; ``kernels``' K1, K2 and K3
   rows equal their plain versions within ``TOL``/``SSD_TOL`` (K1 exactly),
   every launch on the route ``_route`` gives its row; every other section
   launches no K1, K2 or K3; the prescreen's false prunes are 0, the
   conformance diff 0, the sweep deterministic and table5's makespans
   finite. Then ``examples/serve_multimodel_torch.py`` and
   ``examples/device_in_loop_torch.py`` run on the card as subprocesses and
   must exit 0.

Then the ``kernels`` line (K2's and K3's launches summed over the served
models, the two training runs, the mesh steps and ``paper``,
``launches_by_path`` one count per path, K1's and B1's with a ``paper``
entry too; K2's backward with its launches in the two training runs, both sources and
its launches by route), the
``nvidia-smi`` line,
and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (dtype, (bh, sq, sk, hd, g), causal, window, q_offset): bf16 takes the
# sm90 kernel, f32 the simt kernel
CHECKS = [(dt, s, s[1] == s[2], None, 0) for dt in ("float32", "bfloat16") for s in (
    (2, 128, 128, 64, 1), (4, 256, 256, 128, 2), (2, 100, 100, 64, 1), (3, 64, 192, 32, 3))] + [
    ("float32", (2, 256, 256, 64, 1), True, 64, 0),
    ("bfloat16", (2, 256, 256, 64, 1), True, 64, 0),
    ("float32", (1, 32, 128, 64, 1), True, None, 96),
    ("bfloat16", (1, 32, 128, 64, 1), True, None, 96),
    ("float32", (2, 16, 40, 32, 1), True, None, -8),          # fully masked rows
    ("bfloat16", (2, 16, 40, 64, 1), True, None, -8),
    ("bfloat16", (2, 16, 40, 128, 1), True, None, -8),
    ("bfloat16", (4, 130, 300, 128, 4), False, 100, 170),     # window, no causal, ragged
    ("bfloat16", (160, 1024, 1024, 128, 5), True, None, 0),   # serving shape
    ("bfloat16", (160, 1000, 1000, 128, 5), True, None, 0),   # ragged serving shape
    # head_dim 112: kimi-k2's attention (64 query heads, 8 kv heads, batch 1)
    ("float32", (64, 1024, 1024, 112, 8), True, None, 0),
    ("bfloat16", (8, 130, 300, 112, 8), False, 100, 170),
    ("bfloat16", (2, 16, 40, 112, 1), True, None, -8),
    ("bfloat16", (64, 1024, 1024, 112, 8), True, None, 0),
]
SERVING = ("bfloat16", (160, 1024, 1024, 128, 5), True, None, 0)
KIMI = ("bfloat16", (64, 1024, 1024, 112, 8), True, None, 0)
# the shapes that the served model families give K2 at batch 4 (1024-token
# prompts): each is checked, then timed beside SDPA and the plain version
SERVED_K2 = {
    "olmoe-1b-7b": ("bfloat16", (64, 1024, 1024, 128, 1), True, None, 0),
    "kimi-k2-1t-a32b": ("bfloat16", (256, 1024, 1024, 112, 8), True, None, 0),
    "jamba-1.5-large-398b": ("bfloat16", (256, 1024, 1024, 128, 8), True, None, 0),
    "whisper-medium encoder": ("bfloat16", (64, 1500, 1500, 64, 1), False, None, 0),
    "whisper-medium self": ("bfloat16", (64, 1024, 1024, 64, 1), True, None, 0),
    "whisper-medium cross": ("bfloat16", (64, 1024, 1500, 64, 1), False, None, 0),
    "llama-3.2-vision-11b self": ("bfloat16", (128, 1024, 1024, 128, 4), True, None, 0),
    "llama-3.2-vision-11b cross": ("bfloat16", (128, 1024, 6404, 128, 4), False, None, 0),
}
CHECKS += list(SERVED_K2.values())
# (dtype, (bh, s, p, n, chunk, heads_per_group, initial state)): the test
# shapes, a chunk that is no power of two, the warm-up's chunk 16, chunks 1
# and 64 and a carried-in state at the serving widths, P 96 with N 24, and
# the serving shape (4 requests x 64 heads of one group, so heads_per_group
# 64); bf16 takes the sm90 kernel, f32 the simt kernel, and bf16 at P 100
# with N 24 (no multiples of 8) the simt kernel by its shape
SSD_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
SSD_SERVING = ("bfloat16", (256, 1024, 64, 128, 128, 64, False))
# jamba-1.5-large's Mamba layers at batch 4: 256 heads of one group
SSD_JAMBA = ("bfloat16", (1024, 1024, 64, 128, 128, 256, False))
SSD_CHECKS = [(dt, s) for dt in ("float32", "bfloat16") for s in (
    (2, 64, 32, 16, 16, 1, False), (4, 128, 64, 32, 32, 1, False),
    (2, 128, 64, 128, 64, 1, False))] + [
    ("float32", (2, 200, 64, 128, 100, 1, False)),
    ("bfloat16", (256, 100, 64, 128, 100, 64, False)),
    ("bfloat16", (256, 16, 64, 128, 16, 64, False)),
    ("float32", (8, 256, 64, 128, 128, 4, True)),
    ("bfloat16", (256, 64, 64, 128, 1, 64, False)),
    ("bfloat16", (256, 256, 64, 128, 64, 64, False)),
    ("bfloat16", (256, 256, 64, 128, 128, 64, True)),
    ("bfloat16", (8, 256, 96, 24, 128, 4, False)),
    ("bfloat16", (8, 256, 100, 24, 128, 4, False)),
    SSD_SERVING, SSD_JAMBA,
]
# (dtype, (rows, cols), values): the test shapes, a ragged shape (the simt
# route), rows of zeros and of values below the 1e-8 scale floor, values on
# exact .5 steps (half to even), rows with a NaN or an inf (a block per row
# and a warp per row, on each route), rows of one whole 48 KB stage, many
# rows (several to a tile), and the runtime's boundary shape: yolov8n's
# (1, 640, 640, 8) activation as (N·H, W·C) rows
QUANT_BOUNDARY = ("bfloat16", (640, 5120), "randn")
QUANT_CHECKS = [("float32", s, "randn") for s in ((16, 64), (100, 128), (256, 32))] + [
    ("float32", (1000, 333), "randn"), ("bfloat16", (1000, 333), "randn"),
    ("float32", (64, 128), "zeros"), ("bfloat16", (64, 128), "zeros"),
    ("float32", (96, 4096), "ties"), ("bfloat16", (96, 4096), "ties"),
    ("float32", (64, 4096), "nonfinite"), ("bfloat16", (100, 333), "nonfinite"),
    ("bfloat16", (100, 336), "nonfinite"), ("bfloat16", (96, 4096), "nonfinite"),
    ("float32", (8, 12288), "randn"), ("bfloat16", (8, 24576), "ties"),
    ("bfloat16", (20000, 512), "randn"), ("bfloat16", (8000, 2048), "randn"),
    ("float32", (640, 5120), "randn"), QUANT_BOUNDARY,
]
# runtime: three zoo networks at the paper's input resolution, the zoo's 8
# channels; (first half, second half) processors of each; 12 requests of
# all three, one every RUNTIME_PERIOD seconds
RUNTIME_NETS = ("yolov8n", "fast_scnn", "pose_det")
RUNTIME_HOMES = ((0, 1), (1, 2), (2, 0))
RUNTIME_DTYPE, RUNTIME_BACKEND = (2, 1, 0), (0, 1, 2)   # int8/fp16/fp32; default/xnnpack/nnapi
RUNTIME_PERIOD, RUNTIME_REQUESTS = 0.05, 12
# search: the Fig. 15 protocol's first two-group composition, the GA, and
# the requests per group each chosen schedule serves at α = 1
SEARCH_SEED, SEARCH_REQUESTS = 2025, 12
SEARCH_GA = dict(pop_size=12, max_generations=8, min_generations=4, patience=3, seed=0,
                 device_in_loop_interval=2)
# sweep: the first 8 seed-0 scenarios of the paper's §6 protocol; the
# α*-search batch widths of the timing table
SWEEP_SCENARIOS, SWEEP_SEED = 8, 0
SWEEP_WIDTHS = (16, 64, 256, 1024)
# the served models, in order: (arch, the cut of the kernel-vs-plain check,
# the cut served); a cut keeps every width and cuts depth only. The check
# takes one layer of each block kind (whisper: two encoder and two decoder
# layers; llama-3.2-vision: one period of its pattern); kimi-k2 serves one
# layer of 61 (one is 38.8 GB of bf16 weights) and jamba the first three
# positions of its pattern, one of each kind (a whole period is ~88 GB)
SERVED_MODELS = (
    ("qwen3-14b", dict(num_layers=2), {}),
    ("mamba2-1.3b", dict(num_layers=2), {}),
    ("olmoe-1b-7b", dict(num_layers=2), {}),
    ("kimi-k2-1t-a32b", dict(num_layers=2), dict(num_layers=1)),
    ("jamba-1.5-large-398b", "first3", "first3"),
    ("whisper-medium", dict(num_layers=2, encoder_layers=2), {}),
    ("llama-3.2-vision-11b", "period", {}),
)
PROFILED = ("qwen3-14b", "mamba2-1.3b", "olmoe-1b-7b")
# K2's backward, (dtype, (bh, sq, sk, hd, g), causal, window, q_offset):
# phi4-mini-3.8b's training shape (batch 4 x 24 heads, GQA 3, hd 128), the
# f32 100M demo's (batch 8 x 8 heads, GQA 4, hd 64, seq 128), then a sliding
# window, a q_offset continuation, Sq != Sk without causal, fully masked rows
# and hd 112, each in f32 and bf16. Tolerance: of the largest gradient
BWD_PHI4 = ("bfloat16", (96, 1024, 1024, 128, 3), True, None, 0)
BWD_DEMO = ("float32", (64, 128, 128, 64, 4), True, None, 0)
BWD_CHECKS = [BWD_PHI4, BWD_DEMO] + [(dt, *c) for dt in ("float32", "bfloat16") for c in (
    ((6, 256, 256, 64, 3), True, 32, 0),
    ((2, 32, 128, 64, 1), True, None, 96),
    ((4, 130, 300, 128, 4), False, None, 0),
    ((2, 16, 40, 64, 1), True, None, -8),
    ((16, 256, 256, 112, 8), True, None, 0))]
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# train: phi4-mini-3.8b at full width and depth, bf16, AdamW, remat on; warm-up
# steps, then the counted and timed steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = "phi4-mini-3.8b", 4, 1024, 2, 8
TRAIN_LR = 1e-3            # the launcher's default (repro_torch.launch.train)
# train_check: phi4-mini-3.8b at full width cut to one layer; the loss through
# the kernels within TRAIN_LOSS_TOL of the plain path's (relative), every
# parameter's gradient within TRAIN_GRAD_TOL of the plain one's norm (bf16
# rounding gives well under 1%; a lost dQ or dK gives 100% on wq or wk)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-3, 5e-2
# train_ckpt: the 100M demo (f32) of examples/train_100m_torch.py at its batch
# and sequence, a checkpoint at CKPT_AT of CKPT_STEPS, then the resume
CKPT_STEPS, CKPT_AT, CKPT_BATCH, CKPT_SEQ = 60, 40, 8, 128
# steps: the mesh steps of repro_torch.launch.steps on the card's 1×1 mesh,
# phi4-mini-3.8b at full width and depth (train 4 × 1024, then prefill and
# decode at batch 4, 1024 prompt tokens) and mamba2-1.3b's prefill
STEPS_TRAIN = 3            # make_train_step's steps (the first held to train_step)
STEPS_HELD = 2             # steps held to train_step, loss for loss
# after STEPS_HELD steps, the mesh step's parameters (embed, the first wq, the
# last w_down) differ from train_step's by at most this share of the distance
# train_step moved them from their initial values (norms): a skipped or
# botched update differs by about the whole distance
STEPS_PARAM_TOL = 0.1
STEPS_DECODE = 8           # decode steps (held to generate's greedy ids)
STEPS_REPS = 3             # timed prefills
# lanes: bf16 cuBLAS products n×n×n, a device copy, empty launches
LANE_GEMM_SIZES = (256, 512, 1024, 2048, 4096, 8192)
LANE_COPY_BYTES = 1 << 30
LANE_LAUNCHES = 2000
# paper: the examples run on the card after the harness's sections, each a
# subprocess with this many seconds to finish
PAPER_EXAMPLES = ("examples/serve_multimodel_torch.py", "examples/device_in_loop_torch.py")
PAPER_EXAMPLE_TIMEOUT = 420
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3; set in main from repro_torch.launch.roofline
PEAK_BF16_FLOPS = PEAK_F32_FLOPS = PEAK_BYTES = None


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


# K2's backward: the simt route's three kernels, then the sm90 route's
BWD_KERNELS = ("dot_kernel", "dkdv_kernel", "dq_kernel", "bwd_prep_sm90_kernel",
               "dkdv_sm90_kernel", "dq_sm90_kernel")
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel", "ssd_scan_sm90_kernel",
                "ssd_scan_kernel", "quant_rows_sm90_kernel", "quant_rows_kernel") + BWD_KERNELS


def device_profile(fn) -> dict:
    """Kernel time on the device (``torch.profiler``) against the host clock
    for one call of ``fn``, with the port's own kernels apart; the
    profiler's own host cost inflates the wall."""
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
    port = {}
    for e in kernels:
        for k in PORT_KERNELS:
            if k + "<" in e.key:
                ms, n = port.get(k, (0.0, 0))
                port[k] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernel_launches":
            sum(e.count for e in kernels),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top],
            "port_kernels_ms_launches": port}


def time_attention(case, inputs, batch: int, smi: str, path: str) -> dict:
    """K2 at ``case`` (``batch`` sequences): the sm90 kernel, the simt kernel
    at bf16, SDPA and the plain version in turns (a, b, c, d, d, c, b, a);
    each keeps its least."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_flash_attention_simt, flash_attention,
                                                     flash_attention_plain)
    q, k, v, kw = inputs
    hd = q.shape[2]
    q4, k4, v4 = (t.view(batch, t.shape[0] // batch, t.shape[1], hd) for t in (q, k, v))
    contenders = {
        "sm90": (lambda: flash_attention(q, k, v, **kw), 50),
        "simt": (lambda: _flash_attention_simt(q, k, v, **kw), 10),
        "sdpa": (lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=case[2],
                                                        enable_gqa=True), 50),
        "plain": (lambda: flash_attention_plain(q, k, v, **kw), 5)}
    turns = {who: [] for who in contenders}
    for who in list(contenders) + list(reversed(contenders)):
        fn, iters = contenders[who]
        turns[who].append(cuda_ms(fn, iters=iters))
    ms, simt_ms, lib_ms, plain_ms = (min(turns[n]) for n in ("sm90", "simt", "sdpa", "plain"))
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(*case)
    emit({"phase": "kernel_time", "kernel": "flash_attention", "route": "sm90", "path": path,
          "shape": case[1], "causal": case[2], "ms": ms, "simt_ms": simt_ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "turns_ms": turns, "bound_ms": bound_ms, "bound_by": bound_by,
          "flops": flops, "bytes": nbytes,
          "tflops": {n: flops / min(t) / 1e9 for n, t in turns.items()},
          "share_of_bound": bound_ms / ms, "speedup_over_simt": simt_ms / ms, "smi": smi})
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


def time_ssd(case, args, kw, smi: str, path: str) -> dict:
    """K3 at ``case``: the sm90 kernel, the simt kernel at bf16 and the plain
    version in turns (a, b, c, c, b, a); each keeps its least."""
    from repro_torch.kernels.ssd_scan import _ssd_scan_simt, ssd_scan, ssd_scan_plain
    contenders = {"sm90": (lambda: ssd_scan(*args, **kw), 50),
                  "simt": (lambda: _ssd_scan_simt(*args, **kw), 10),
                  "plain": (lambda: ssd_scan_plain(*args, **kw), 5)}
    turns = {who: [] for who in contenders}
    for who in list(contenders) + list(reversed(contenders)):
        fn, iters = contenders[who]
        turns[who].append(cuda_ms(fn, iters=iters))
    ms, simt_ms, plain_ms = (min(turns[n]) for n in ("sm90", "simt", "plain"))
    bound_ms, bound_by, flops, nbytes = ssd_bound_ms(*case)
    emit({"phase": "kernel_time", "kernel": "ssd_scan", "route": "sm90", "path": path,
          "shape": case[1], "ms": ms, "simt_ms": simt_ms, "plain_ms": plain_ms,
          "library_ms": None, "turns_ms": turns, "bound_ms": bound_ms, "bound_by": bound_by,
          "flops": flops, "bytes": nbytes,
          "tflops": {n: flops / min(t) / 1e9 for n, t in turns.items()},
          "share_of_bound": {n: bound_ms / min(t) for n, t in turns.items()},
          "speedup_over_simt": simt_ms / ms, "smi": smi})
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


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


def quant_bound_ms(dtype: str, shape, out_dtype=None):
    """Least time for the quantizer's work: x read once, q and scale (and
    ``out``) written once; 6 f32 operations an element (abs, max; divide,
    round, 2 clamps), and one more (the product) with ``out``."""
    rows, cols = shape
    size = {"bfloat16": 2, "float32": 4, None: 0}
    nbytes = rows * cols * (size[dtype] + 1 + size[out_dtype]) + 4 * rows
    flops = (6.0 + (out_dtype is not None)) * rows * cols
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def quant_inputs(dtype: str, shape, values: str, gen):
    """x on the card. ``zeros``: a quarter of the rows zero and a quarter
    below 1e-8 (the scale floor); ``ties``: each row holds 127·m (so the
    scale is m, a power of two) and odd multiples of m/2, every one an exact
    .5 step of round(x / scale); ``nonfinite``: a NaN in every fourth row
    and an inf of either sign in the row after it."""
    import torch
    rows, cols = shape
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)
    x = torch.randn(rows, cols, generator=gen, device=dev) * 3.0
    if values == "nonfinite":
        at = torch.randint(0, cols, (rows,), generator=gen, device=dev)
        sign = torch.randint(0, 2, (rows,), generator=gen, device=dev).float() * 2 - 1
        r = torch.arange(rows, device=dev)
        x[r[0::4], at[0::4]] = float("nan")
        x[r[1::4], at[1::4]] = float("inf") * sign[1::4]
    elif values == "zeros":
        x[: rows // 4] = 0.0
        x[rows // 4: rows // 2] *= 1e-10
    elif values == "ties":
        m = 2.0 ** torch.randint(-3, 4, (rows, 1), generator=gen, device=dev).float()
        k = torch.randint(-127, 127, (rows, cols), generator=gen, device=dev).float()
        x = (k + 0.5) * m
        x[:, 0] = 127.0 * m[:, 0]
    return x.to(tdt)


def device_ms_per_call(fn, iters: int = 50):
    """Device time per call of ``fn`` from ``torch.profiler``: (all its
    kernels, K1's kernels alone), or None where the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    runs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    k1 = [e for e in runs if "quant_rows_" in e.key]
    if not k1:
        return None, None
    return (sum(e.self_device_time_total for e in runs) / iters / 1e3,
            sum(e.self_device_time_total for e in k1) / iters / 1e3)


def host_ms_per_call(fn, calls: int = 200) -> float:
    """Host time to make one call of ``fn``, back to back: the wrapper's
    own work, since the device keeps up."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def hold_k1(x, values: str, path: str) -> float:
    """K1 against its plain version on ``x``, without ``out`` and with a
    bf16 and an f32 ``out``: scale equal bit for bit where finite and NaN or
    inf where the plain version's is, q and ``out`` equal on the rows whose
    scale is finite (elsewhere both cast a NaN to int8), each launch counted
    on the route its shape picks. Raises on a difference; returns the
    largest error of the dequantized rows."""
    import torch
    from repro_torch.kernels.int8_quant import ROUTES, _route, quantize_int8, quantize_int8_plain
    dtype, shape = str(x.dtype).removeprefix("torch."), tuple(x.shape)
    want_q, want_scale = quantize_int8_plain(x)
    fin = torch.isfinite(want_scale)
    for out_dtype in (None, "bfloat16", "float32"):
        out = (None if out_dtype is None else
               torch.full(shape, 7.0, device=x.device, dtype=getattr(torch, out_dtype)))
        route = _route(x, out)
        before = dict(quantize_int8.launches_by_route)
        q, scale = quantize_int8(x, out)
        took = {r: quantize_int8.launches_by_route[r] - before[r] for r in ROUTES}
        torch.cuda.synchronize()
        scale_equal = bool(torch.equal(torch.isnan(scale), torch.isnan(want_scale))
                           and torch.equal(torch.isinf(scale), torch.isinf(want_scale))
                           and torch.equal(scale[fin].view(torch.int32),
                                           want_scale[fin].view(torch.int32)))
        q_equal = bool(torch.equal(q[fin], want_q[fin]))
        out_equal = True
        if out is not None:
            want_out = torch.empty_like(out)
            quantize_int8_plain(x, want_out)
            out_equal = bool(torch.equal(out[fin].float().view(torch.int32),
                                         want_out[fin].float().view(torch.int32)))
        err = float((q[fin].float() * scale[fin, None]
                     - want_q[fin].float() * want_scale[fin, None]).abs().max())
        ok = (q_equal and scale_equal and out_equal
              and took == {r: int(r == route) for r in ROUTES}
              and (route == "sm90" or (dtype, shape, values) != QUANT_BOUNDARY))
        emit({"phase": "kernel_check", "kernel": "int8_quant", "path": path, "route": route,
              "dtype": dtype, "shape": shape, "values": values, "out": out_dtype,
              "q_equal": q_equal, "scale_bits_equal": scale_equal,
              "out_bits_equal": out_equal, "nonfinite_rows": int((~fin).sum()),
              "q_mismatches": int((q[fin] != want_q[fin]).sum()), "max_abs_err": err,
              "launches": took, "ok": ok})
        if not ok:
            raise AssertionError(f"int8_quant {route} differs from its plain version at "
                                 f"{shape} {dtype} out={out_dtype}, launches {took}")
    return err


def check_int8_quant(gen, smi: str) -> dict:
    """K1 against its plain version (``hold_k1``) at QUANT_CHECKS; then timed
    at the runtime's boundary shape, with and without ``out``, beside the
    two launches (K1, then ``torch.mul`` into a bf16 buffer) that ``out``
    replaces."""
    import torch
    from repro_torch.kernels.int8_quant import _route, quantize_int8, quantize_int8_plain
    for dtype, shape, values in QUANT_CHECKS:
        x = quant_inputs(dtype, shape, values, gen)
        err = hold_k1(x, values, "checks")
        if (dtype, shape, values) == QUANT_BOUNDARY:
            boundary = (x, err)
        del x

    # the boundary shape: K1 alone, K1 writing the Worker's bf16 buffer, and
    # the two launches that replaces, in turns (a, b, c, c, b, a); each keeps
    # its least device time (profiler), back-to-back time (CUDA events, paced
    # by the host) and host time per call
    x, err = boundary
    out, buf = torch.empty_like(x), torch.empty_like(x)

    def two_launches():
        q, scale = quantize_int8(x)
        torch.mul(q, scale[:, None], out=buf)
    contenders = {"k1": lambda: quantize_int8(x), "k1_out": lambda: quantize_int8(x, out),
                  "two_launches": two_launches}
    turns = {who: {"device_ms": [], "k1_device_ms": [], "ms": [], "host_ms": []}
             for who in contenders}
    for who in list(contenders) + list(reversed(contenders)):
        fn = contenders[who]
        total, k1 = device_ms_per_call(fn)
        turns[who]["device_ms"].append(total)
        turns[who]["k1_device_ms"].append(k1)
        turns[who]["ms"].append(cuda_ms(fn, iters=200))
        turns[who]["host_ms"].append(host_ms_per_call(fn))
    least = {who: {k: (None if None in v else min(v)) for k, v in t.items()}
             for who, t in turns.items()}
    plain_ms = cuda_ms(lambda: quantize_int8_plain(x), iters=50)
    dtype, shape = QUANT_BOUNDARY[:2]
    bound_ms, bound_by, flops, nbytes = quant_bound_ms(dtype, shape)
    out_bound_ms, out_bound_by, out_flops, out_nbytes = quant_bound_ms(dtype, shape, dtype)

    def share(bound, t):
        return None if t is None else bound / t
    k1, k1_out, two = least["k1"], least["k1_out"], least["two_launches"]
    emit({"phase": "kernel_time", "kernel": "int8_quant", "route": _route(x), "out": None,
          "shape": shape, "dtype": dtype, "ms": k1["ms"], "device_ms": k1["device_ms"],
          "host_ms_per_call": k1["host_ms"], "plain_ms": plain_ms, "library_ms": None,
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
          "share_of_bound": share(bound_ms, k1["device_ms"]), "turns": turns["k1"], "smi": smi})
    emit({"phase": "kernel_time", "kernel": "int8_quant", "route": _route(x, out),
          "out": dtype, "shape": shape, "dtype": dtype, "ms": k1_out["ms"],
          "device_ms": k1_out["device_ms"], "host_ms_per_call": k1_out["host_ms"],
          "bound_ms": out_bound_ms, "bound_by": out_bound_by, "flops": out_flops,
          "bytes": out_nbytes, "share_of_bound": share(out_bound_ms, k1_out["device_ms"]),
          "turns": turns["k1_out"], "smi": smi})
    emit({"phase": "kernel_time", "kernel": "int8_quant", "variant": "k1_then_torch_mul",
          "out": dtype, "shape": shape, "dtype": dtype, "ms": two["ms"],
          "device_ms": two["device_ms"], "k1_device_ms": two["k1_device_ms"],
          "host_ms_per_call": two["host_ms"], "bound_ms": out_bound_ms,
          "share_of_bound": share(out_bound_ms, two["device_ms"]),
          "fused_over_two_launches": (None if None in (k1_out["device_ms"], two["device_ms"])
                                      else k1_out["device_ms"] / two["device_ms"]),
          "turns": turns["two_launches"], "smi": smi})
    emit({"phase": "kernel_time", "kernel": "int8_quant", "variant": "host_cost",
          "host_ms_per_call": {who: least[who]["host_ms"] for who in least},
          "device_ms": {who: least[who]["device_ms"] for who in least}, "smi": smi})
    return dict(max_abs_err=err, ms=k1["ms"], device_ms=k1["device_ms"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def halves_solution(graphs, homes, dtype, backend):
    """Each network cut after layer ``num_layers // 2`` (every edge across
    that point, so skip edges too), its halves on the processors ``homes[i]``."""
    from repro_torch.core import Solution
    partition, mapping = [], []
    for g, (first, second) in zip(graphs, homes):
        h = g.num_layers // 2
        partition.append([1 if e.src <= h < e.dst else 0 for e in g.edges])
        mapping.append([first] * (h + 1) + [second] * (g.num_layers - h - 1))
    return Solution(partition=partition, mapping=mapping, priority=list(range(len(graphs))),
                    dtype=list(dtype), backend=list(backend))


def k1_staging(zoo, graphs, placed, networks):
    """The boundary inputs that one request of ``networks`` stages through
    K1: those of every int8 subgraph with a producer, replicated to its
    arity. Returns their count by K1's route for their shape as the Worker
    hands them over, and the (rows, cols) shapes."""
    import torch
    from repro_torch.kernels.int8_quant import ROUTES, _route
    routes, shapes = dict.fromkeys(ROUTES, 0), set()
    for n in networks:
        for p in placed[n]:
            if p.dtype != "int8" or not p.subgraph.in_cut_edges():
                continue
            for a in zoo[graphs[n].name].build_subgraph_fn(p.subgraph.layer_ids, p.dtype)[1]:
                rows = (a.shape[0] * a.shape[1], math.prod(a.shape[2:]))
                probe = torch.empty(rows, dtype=a.dtype, device=a.device)
                routes[_route(probe, torch.empty_like(probe))] += 1
                shapes.add(rows)
    return routes, sorted(shapes)


def percentile(values, p: float) -> float:
    """Nearest-rank percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(p / 100 * len(ordered)) - 1)]


def runtime_phase(smi: str, counters: dict):
    """Puzzle's runtime on the card in three runs; returns K1's launches in
    the int8-staging run, and their split by route."""
    import torch
    from repro_torch.core import TorchExecBackend, decode_solution, mobile_processors
    from repro_torch.kernels.int8_quant import ROUTES, quantize_int8, quantize_int8_plain
    from repro_torch.runtime import PuzzleRuntime, RuntimeConfig
    from repro_torch.zoo import MODEL_SPECS, ExecutableMobileModel
    ops = importlib.import_module("repro_torch.kernels.ops")
    torch.backends.cudnn.deterministic = True
    zoo = {n: ExecutableMobileModel(n, channels=8, spatial=MODEL_SPECS[n]["input"][1], seed=0)
           for n in RUNTIME_NETS}
    graphs = [zoo[n].graph for n in RUNTIME_NETS]
    sol = halves_solution(graphs, RUNTIME_HOMES, RUNTIME_DTYPE, RUNTIME_BACKEND)
    placed = decode_solution(sol, graphs)
    procs = mobile_processors()
    macs = {n: sum(zoo[n].spatial ** 2 * 9 * 8 * 8 for layer in zoo[n].graph.layers
                   if layer.op_type != "add_merge") for n in RUNTIME_NETS}
    want_k1 = RUNTIME_REQUESTS * sum(k1_staging(zoo, graphs, placed, range(len(graphs)))[0]
                                     .values())
    emit({"phase": "runtime_setup", "networks": RUNTIME_NETS,
          "spatial": [zoo[n].spatial for n in RUNTIME_NETS], "channels": 8,
          "conv_gmac": {n: macs[n] / 1e9 for n in RUNTIME_NETS},
          "placement": [[{"layers": [p.subgraph.layer_ids[0], p.subgraph.layer_ids[-1]],
                          "processor": p.processor, "dtype": p.dtype, "backend": p.backend}
                         for p in plist] for plist in placed],
          "period_s": RUNTIME_PERIOD, "requests": RUNTIME_REQUESTS, "want_k1_launches": want_k1})

    runs = {}
    for label, staging, plain in (("default", False, False), ("int8", True, False),
                                  ("int8_plain_k1", True, True)):
        swap = (mock.patch.object(ops, "quantize_rows", quantize_int8_plain) if plain
                else contextlib.nullcontext())
        with swap, PuzzleRuntime(graphs, sol, procs, zoo,
                                 RuntimeConfig(int8_staging=staging)) as rt:
            rt.infer_sync([0, 1, 2])          # warm-up: eager algorithms, allocator
            for c in counters.values():
                c.launches = 0
            quantize_int8.launches_by_route = dict.fromkeys(ROUTES, 0)
            states = rt.run_periodic([[0, 1, 2]], [RUNTIME_PERIOD],
                                     num_requests=RUNTIME_REQUESTS)[0]
            counts = {k: c.launches for k, c in counters.items()}
            k1_routes = dict(quantize_int8.launches_by_route)
            torch.cuda.synchronize()
            spans = [st.makespan for st in states]
            finals = [[st.outputs[(n, len(plist) - 1)] for n, plist in enumerate(placed)]
                      for st in states]
            costs = rt.measured_costs()
            stats = rt.stats()
            want = {k: (want_k1 if k == "int8_quant" and staging and not plain else 0)
                    for k in counters}
            # every boundary shape of the run takes K1's sm90 route
            want_k1_routes = {"sm90": want["int8_quant"], "simt": 0}
            ok = (len(states) == RUNTIME_REQUESTS and all(s is not None for s in spans)
                  and counts == want and k1_routes == want_k1_routes
                  and len(costs) == sum(len(pl) for pl in placed)
                  and all(tuple(o.shape) == zoo[RUNTIME_NETS[n]].input_shape()
                          and bool(torch.isfinite(o).all())
                          for outs in finals for n, o in enumerate(outs)))
            emit({"phase": "runtime", "run": label, "int8_staging": staging,
                  "k1": "plain" if plain else "kernel",
                  "makespan_mean_ms": sum(spans) / len(spans) * 1e3,
                  "makespan_median_ms": percentile(spans, 50) * 1e3,
                  "makespan_p95_ms": percentile(spans, 95) * 1e3,
                  "makespans_ms": [s * 1e3 for s in spans], "stats": stats,
                  "measured_cost_keys": len(costs), "placed_subgraphs":
                      sum(len(pl) for pl in placed), "launches": counts, "want_launches": want,
                  "k1_routes": k1_routes,
                  "max_abs_output": [float(max(float(outs[n].float().abs().max())
                                                 for outs in finals))
                                     for n in range(len(placed))],
                  "smi": smi, "ok": ok})
            if not ok:
                raise AssertionError(f"runtime run {label} failed: launches {counts}, "
                                     f"want {want}, K1 routes {k1_routes}, "
                                     f"{len(costs)} measured keys")
            if label == "int8":
                costs_int8, k1_launches = costs, (counts["int8_quant"], k1_routes)
                mean_ms = sum(spans) / len(spans) * 1e3
                prof = device_profile(lambda: rt.infer_sync([0, 1, 2]))
                emit({"phase": "runtime_profile", "run": label, "profile": prof,
                      "unprofiled_makespan_mean_ms": mean_ms,
                      "device_busy_share": prof["device_busy_ms"] / mean_ms, "smi": smi})
            runs[label] = finals

    def max_diff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    scale = max(float(o.float().abs().max()) for outs in runs["int8"] for o in outs)
    err_plain = max_diff(runs["int8"], runs["int8_plain_k1"])
    err_staging = max_diff(runs["default"], runs["int8"])
    ok = err_plain <= 1e-6 * scale
    emit({"phase": "runtime_compare", "int8_vs_int8_plain_k1": err_plain,
          "tol": 1e-6 * scale, "default_vs_int8": err_staging, "max_abs_output": scale,
          "ok": ok})
    if not ok:
        raise AssertionError(f"runtime outputs through K1 differ from plain K1: {err_plain}")

    backend = TorchExecBackend(zoo, repeats=5)
    rows = [{"net": p.subgraph.graph.name, "sg": k, "processor": p.processor,
             "dtype": p.dtype, "backend": p.backend,
             "torch_exec_ms": backend.measure(p) * 1e3,
             "measured_cost_ms": costs_int8[p.profile_key()] * 1e3}
            for plist in placed for k, p in enumerate(plist)]
    emit({"phase": "runtime_costs", "subgraphs": rows, "smi": smi})
    torch.backends.cudnn.deterministic = False
    return k1_launches


def search_phase(smi: str, counters: dict):
    """Puzzle's scheduler on the card: profile, search with measurement
    rounds on the runtime, then serve four schedules; returns K1's launches
    in this phase, their split by route, and what the conformance phase
    takes: the analyzer, the zoo, the four schedules and the boundary
    shapes staged through K1."""
    import torch
    from repro_torch.core import (PAPER_COMM_MODEL, AnalyzerConfig, GAConfig, Profiler,
                                  StaticAnalyzer, TorchExecBackend, build_scenario,
                                  deadline_satisfaction, decode_solution, mobile_processors,
                                  percentile as interpolated, random_scenarios)
    from repro_torch.kernels.int8_quant import ROUTES, quantize_int8
    from repro_torch.runtime import PuzzleRuntime, RuntimeConfig
    from repro_torch.zoo import MODEL_NAMES, MODEL_SPECS, ExecutableMobileModel
    torch.backends.cudnn.deterministic = True
    groups = random_scenarios(MODEL_NAMES, count=1, models_per_scenario=6, num_groups=2,
                              seed=SEARCH_SEED)[0]
    names = [n for g in groups for n in g]
    zoo = {n: ExecutableMobileModel(n, channels=8, spatial=MODEL_SPECS[n]["input"][1], seed=0)
           for n in names}
    scenario = build_scenario("fig15-multi-group", groups, {n: zoo[n].graph for n in names})
    graphs, procs = scenario.graphs, mobile_processors()
    staging = RuntimeConfig(int8_staging=True)

    profiled = {"entries": 0, "seconds": 0.0}

    class TimedExecBackend(TorchExecBackend):
        def measure(self, placed):
            t0 = time.perf_counter()
            try:
                return super().measure(placed)
            finally:
                profiled["entries"] += 1
                profiled["seconds"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    analyzer = StaticAnalyzer(
        scenario, procs, Profiler(TimedExecBackend(zoo, repeats=3)), PAPER_COMM_MODEL,
        AnalyzerConfig(ga=GAConfig(**SEARCH_GA), device_in_loop_topk=1,
                       device_in_loop_requests=3),
        executables=zoo, runtime_config=staging)
    setup = {"seconds": time.perf_counter() - t0, "profile_entries": profiled["entries"],
             "profile_seconds": profiled["seconds"]}
    emit({"phase": "search_setup", "groups": groups,
          "spatial": {n: zoo[n].spatial for n in names}, "channels": 8,
          "layers": {n: zoo[n].graph.num_layers for n in names},
          "base_periods_ms": [p * 1e3 for p in analyzer.base_periods],
          "best_model_ms": {n: {pid: t * 1e3 for pid, (t, _, _) in analyzer.best_times[i].items()}
                            for i, n in enumerate(names)},
          "best_model_times": setup, "smi": smi})

    staged = set()      # every (rows, cols) the phase stages through K1

    def want_k1(sol, requests: int):
        placed = decode_solution(sol, graphs)
        routes = dict.fromkeys(ROUTES, 0)
        shapes = set()
        for g in scenario.groups:
            got, sh = k1_staging(zoo, graphs, placed, g)
            shapes.update(sh)
            staged.update(sh)
            for r in ROUTES:
                routes[r] += requests * got[r]
        return placed, routes, sorted(shapes)

    def k1_since(before):
        return {r: quantize_int8.launches_by_route[r] - before[r] for r in ROUTES}

    # measurement rounds: what each ran, how far it moved the profile, K1
    rounds = []
    measure_inner, round_inner = analyzer.measure_on_runtime, analyzer._device_in_loop

    def measure(sol, *args, **kw):
        placed, want, shapes = want_k1(sol, analyzer.cfg.device_in_loop_requests)
        before = dict(quantize_int8.launches_by_route)
        t0 = time.perf_counter()
        got = measure_inner(sol, *args, **kw)
        seconds = time.perf_counter() - t0
        ratios = sorted(t / analyzer.profiler.db.get(k) for k, t in got.items()
                        if analyzer.profiler.db.get(k))
        keys = {p.profile_key() for plist in placed for p in plist}
        took = k1_since(before)
        rounds.append({"seconds": seconds, "subgraphs": len(keys), "k1": took, "want_k1": want,
                       "k1_shapes": shapes, "measured_over_profiled": {
                           "min": ratios[0], "median": ratios[len(ratios) // 2],
                           "max": ratios[-1]}})
        if set(got) != keys or took != want:
            raise AssertionError(f"measurement round: {len(got)} of {len(keys)} keys, "
                                 f"K1 {took}, want {want}")
        return got

    round_seconds = []

    def device_round(front):
        t0 = time.perf_counter()
        changed = round_inner(front)
        round_seconds.append(time.perf_counter() - t0)
        rounds[-1]["changed"] = changed
        return changed
    analyzer.measure_on_runtime, analyzer._device_in_loop = measure, device_round

    # the main path: counts zeroed here, read after the last schedule
    for c in counters.values():
        c.launches = 0
    quantize_int8.launches_by_route = dict.fromkeys(ROUTES, 0)
    prof0 = dict(profiled)
    t0 = time.perf_counter()
    result = analyzer.run_ga()
    ga_seconds = time.perf_counter() - t0
    ga_profile_s = profiled["seconds"] - prof0["seconds"]
    emit({"phase": "search", "generations": result.generations,
          "evaluations": result.evaluations, "pareto": len(result.pareto),
          "history": result.history, "device_updates": result.device_updates,
          "measurement_rounds": len(round_seconds), "rounds": rounds,
          "spec_cache": [analyzer.spec_cache_hits, analyzer.spec_cache_misses],
          "objective_cache": [analyzer.objective_cache_hits, analyzer.objective_cache_misses],
          "profile_entries": {"best_model_times": setup["profile_entries"],
                              "search": profiled["entries"] - prof0["entries"]},
          "seconds": {"ga_total": ga_seconds, "profiling_on_card": ga_profile_s,
                      "measurement_rounds_on_card": sum(round_seconds),
                      "ga_on_host": ga_seconds - ga_profile_s - sum(round_seconds),
                      "best_model_times_profiling": setup["profile_seconds"]},
          "smi": smi})
    if not round_seconds:
        raise AssertionError("the search ran no measurement round on the card")

    def by_fitness(sols):
        return min(sols, key=lambda s: sum(s.fitness))
    schedules = {
        "puzzle": by_fitness(result.pareto),
        "best_mapping": by_fitness(analyzer.best_mapping(max_evals=120)),
        "npu_only": analyzer.npu_only(),
        "split": halves_solution(graphs, [(i % 3, (i + 1) % 3) for i in range(len(graphs))],
                                 [2] * len(graphs), [0] * len(graphs)),
    }
    k1_search = {r: sum(rd["k1"][r] for rd in rounds) for r in ROUTES}
    periods = analyzer.base_periods
    for label, sol in schedules.items():
        pred = analyzer.objectives(sol, measured=True, num_requests=SEARCH_REQUESTS)
        alpha_star = analyzer.saturation(sol).alpha_star
        placed, want, shapes = want_k1(sol, SEARCH_REQUESTS + 1)
        before = dict(quantize_int8.launches_by_route)
        with PuzzleRuntime(graphs, sol, procs, zoo, staging) as rt:
            for g, nets in enumerate(scenario.groups):     # warm-up: graphs captured
                rt.infer(list(nets), group=g).future.result(timeout=120)
            states = rt.run_periodic([list(g) for g in scenario.groups], periods,
                                     num_requests=SEARCH_REQUESTS)
            torch.cuda.synchronize()
            costs = rt.measured_costs()
            stats = rt.stats()
        took = k1_since(before)
        for r in ROUTES:
            k1_search[r] += took[r]
        spans = [[st.makespan for st in gs] for gs in states]
        done = all(m is not None for gs in spans for m in gs)
        outputs_ok = all(
            all(tuple(o.shape) == zoo[graphs[net].name].input_shape()
                and bool(torch.isfinite(o).all())
                for o in (out if isinstance(out, tuple) else (out,)))
            for gs in states for st in gs for (net, _), out in st.outputs.items())
        keys = {p.profile_key() for plist in placed for p in plist}
        measured = [{"mean_ms": sum(ms) / len(ms) * 1e3,
                     "median_ms": interpolated(ms, 50.0) * 1e3,
                     "p90_ms": interpolated(ms, 90.0) * 1e3} for ms in spans] if done else None
        predicted = [{"mean_ms": pred[2 * g] * 1e3, "p90_ms": pred[2 * g + 1] * 1e3}
                     for g in range(scenario.num_groups)]
        ok = (done and outputs_ok and set(costs) >= keys and took == want
              and all(len(gs) == SEARCH_REQUESTS for gs in states)
              and (label != "split" or sum(took.values())
                   >= (SEARCH_REQUESTS + 1) * scenario.num_groups))
        emit({"phase": "search_serve", "schedule": label,
              "placement": [[{"layers": len(p.subgraph.layer_ids), "processor": p.processor,
                              "dtype": p.dtype, "backend": p.backend} for p in plist]
                            for plist in placed],
              "predicted": predicted,
              "predicted_alpha_star": "inf" if math.isinf(alpha_star) else alpha_star,
              "measured": measured,
              "measured_over_predicted": None if not done else [
                  {"mean": m["mean_ms"] / p["mean_ms"], "p90": m["p90_ms"] / p["p90_ms"]}
                  for m, p in zip(measured, predicted)],
              "deadline_satisfaction": deadline_satisfaction(spans, periods) if done else None,
              "makespans_ms": [[None if m is None else m * 1e3 for m in gs] for gs in spans],
              "requests_per_group": SEARCH_REQUESTS, "measured_cost_keys": len(costs),
              "placed_subgraphs": len(keys), "k1": took, "want_k1": want, "k1_shapes": shapes,
              "stats": stats, "smi": smi, "ok": ok})
        if not ok:
            raise AssertionError(f"search schedule {label} failed: complete {done}, outputs "
                                 f"{outputs_ok}, {len(costs)} measured keys of {len(keys)}, "
                                 f"K1 {took}, want {want}")
    counts = {k: c.launches for k, c in counters.items()}
    routes = dict(quantize_int8.launches_by_route)
    if routes != k1_search or counts != {k: (sum(routes.values()) if k == "int8_quant" else 0)
                                          for k in counters}:
        raise AssertionError(f"search phase launches {counts}, K1 routes {routes}, "
                             f"want K1 {k1_search}")
    torch.backends.cudnn.deterministic = False
    return counts["int8_quant"], routes, dict(analyzer=analyzer, zoo=zoo,
                                              schedules=schedules, staged=staged)


def task_gap(report) -> dict:
    """Per processor, the card's trace against the simulator's, task by task
    (keyed by group, request, network, subgraph): measured over predicted
    execution time, the queueing wait ``started - released`` and the release
    time on each side (ms), each as median and max, and their sums, over
    all tasks and over the requests after each group's first (which pays
    the engines' CUDA-graph captures)."""
    sim = {tuple(t[:4]): t for t in report.sim_trace["tasks"]}
    rows = {}
    for t in report.runtime_trace["tasks"]:
        p = sim[tuple(t[:4])]
        rows.setdefault(t[4], []).append((t, p))

    def stats(values):
        ordered = sorted(values)
        return {"median": ordered[(len(ordered) - 1) // 2], "max": ordered[-1]}

    def sums(pairs):
        return {"exec_measured": sum(t[10] for t, _ in pairs) * 1e3,
                "exec_predicted": sum(p[10] for _, p in pairs) * 1e3,
                "wait_measured": sum(t[6] - t[5] for t, _ in pairs) * 1e3,
                "wait_predicted": sum(p[6] - p[5] for _, p in pairs) * 1e3}
    out = {}
    for pid, pairs in sorted(rows.items()):
        out[str(pid)] = {
            "tasks": len(pairs),
            "exec_measured_over_predicted": stats([t[10] / p[10] for t, p in pairs]),
            "exec_ms": {"measured": stats([t[10] * 1e3 for t, _ in pairs]),
                        "predicted": stats([p[10] * 1e3 for _, p in pairs])},
            "wait_ms": {"measured": stats([(t[6] - t[5]) * 1e3 for t, _ in pairs]),
                        "predicted": stats([(p[6] - p[5]) * 1e3 for _, p in pairs])},
            "release_ms": {"measured": stats([t[5] * 1e3 for t, _ in pairs]),
                           "predicted": stats([p[5] * 1e3 for _, p in pairs]),
                           "late_by": stats([(t[5] - p[5]) * 1e3 for t, p in pairs])},
            "quant_ms": {"measured": stats([t[9] * 1e3 for t, _ in pairs]),
                         "predicted": stats([p[9] * 1e3 for _, p in pairs])},
            "sum_ms": sums(pairs),
            "sum_ms_after_first_request": sums([(t, p) for t, p in pairs if t[1] > 0]),
        }
    return out


def conformance_phase(smi: str, counters: dict, analyzer, zoo, schedules, staged):
    """Each schedule of ``search`` replayed on the virtual-clock runtime
    (must equal the simulator exactly), then run on the card through the
    same ``validate_on_runtime``, with the per-task gap between the two
    traces and the linter's codes; then K1 held against its plain version
    at every staged boundary shape. Returns K1's launches in the real runs,
    their split by route, and K1's largest error."""
    import torch
    from repro_torch.core import decode_solution
    from repro_torch.kernels.int8_quant import ROUTES, quantize_int8
    torch.backends.cudnn.deterministic = True
    graphs = analyzer.scenario.graphs
    total = dict.fromkeys(ROUTES, 0)
    for label, sol in schedules.items():
        t0 = time.perf_counter()
        virtual = analyzer.validate_on_runtime(sol, mode="virtual", measured=True,
                                               num_requests=SEARCH_REQUESTS)
        virtual_s = time.perf_counter() - t0
        if not virtual.passed:
            raise AssertionError(f"conformance {label}: the virtual replay differs from "
                                 f"the simulator: {virtual.summary()}")
        placed = decode_solution(sol, graphs)
        want = dict.fromkeys(ROUTES, 0)
        for g in analyzer.scenario.groups:
            got, shapes = k1_staging(zoo, graphs, placed, g)
            staged.update(shapes)
            for r in ROUTES:
                want[r] += SEARCH_REQUESTS * got[r]
        for c in counters.values():
            c.launches = 0
        quantize_int8.launches_by_route = dict.fromkeys(ROUTES, 0)
        t0 = time.perf_counter()
        real = analyzer.validate_on_runtime(sol, mode="real", num_requests=SEARCH_REQUESTS)
        real_s = time.perf_counter() - t0
        counts = {k: c.launches for k, c in counters.items()}
        routes = dict(quantize_int8.launches_by_route)
        torch.cuda.synchronize()
        for r in ROUTES:
            total[r] += routes[r]
        want_counts = {k: (sum(want.values()) if k == "int8_quant" else 0) for k in counters}
        same_tasks = ({tuple(t[:4]) for t in real.runtime_trace["tasks"]}
                      == {tuple(t[:4]) for t in real.sim_trace["tasks"]})
        finite = all(m is not None and math.isfinite(m)
                     for trace in (real.runtime_trace, real.sim_trace)
                     for m in trace["makespans"])
        lint = analyzer.lint(sol, alpha=1.0)
        ok = counts == want_counts and routes == want and same_tasks and finite
        emit({"phase": "conformance", "schedule": label,
              "virtual": virtual.summary(), "virtual_seconds": virtual_s,
              "real": real.summary(), "real_seconds": real_s,
              "requests_per_group": SEARCH_REQUESTS,
              "makespans_ms": {"measured": [None if m is None else m * 1e3
                                            for m in real.runtime_trace["makespans"]],
                               "predicted": [None if m is None else m * 1e3
                                             for m in real.sim_trace["makespans"]]},
              "task_gap": task_gap(real) if same_tasks else None,
              "lint": {"counts": lint.counts(), "alpha_lower_bound": lint.alpha_lower_bound,
                       "infeasible": lint.infeasible},
              "launches": counts, "want_launches": want_counts, "k1": routes, "want_k1": want,
              "same_tasks": same_tasks, "finite_makespans": finite, "smi": smi, "ok": ok})
        if not ok:
            raise AssertionError(f"conformance {label} on the card failed: launches {counts}, "
                                 f"want {want_counts}; K1 {routes}, want {want}; same tasks "
                                 f"{same_tasks}; finite makespans {finite}")
    analyzer.close()
    torch.backends.cudnn.deterministic = False
    # the dtype gene is one per network, so an int8 subgraph's producer is
    # int8 too and hands the Worker bf16 rows; these launches come after the
    # path's counts were read
    gen = torch.Generator(device="cuda").manual_seed(SEARCH_SEED)
    err = max(hold_k1(quant_inputs("bfloat16", shape, "randn", gen), "randn", "staged")
              for shape in sorted(staged))
    return sum(total.values()), total, err


def batch_diff(ref, got) -> tuple:
    """Largest absolute and relative difference between two BatchResults,
    lane by lane, over every request's timestamps and makespan and every
    busy time; whether each value is within the compiled tier's tolerance
    (done counts exact, inf only against inf)."""
    from repro_torch.core import COMPILED_ABS_TOL, COMPILED_REL_TOL
    worst_abs = worst_rel = 0.0
    ok = ref.width == got.width
    for i in range(ref.width):
        a, b = ref.result(i), got.result(i)
        pairs = [(a.busy_time[p], b.busy_time[p]) for p in a.busy_time]
        ok = ok and len(a.requests) == len(b.requests)
        for qa, qb in zip(a.requests, b.requests):
            ok = ok and qa.done_tasks == qb.done_tasks and qa.total_tasks == qb.total_tasks
            pairs += [(getattr(qa, f), getattr(qb, f))
                      for f in ("arrival", "first_start", "last_finish", "makespan")]
        for x, y in pairs:
            if math.isinf(x) or math.isinf(y):
                ok = ok and x == y
                continue
            d = abs(x - y)
            worst_abs = max(worst_abs, d)
            worst_rel = max(worst_rel, d / max(abs(x), abs(y), 1e-300))
            ok = ok and d <= COMPILED_ABS_TOL + COMPILED_REL_TOL * max(abs(x), abs(y))
    return worst_abs, worst_rel, ok


def in_turns(first, second, iters: int, rounds: int = 3):
    """Device ms per call of two functions, timed in turns (first, second,
    second, first) ``rounds`` times: every time of each."""
    a, b = [], []
    for _ in range(rounds):
        a.append(cuda_ms(first, iters=iters, warmup=1))
        b.append(cuda_ms(second, iters=iters, warmup=1))
        b.append(cuda_ms(second, iters=iters, warmup=1))
        a.append(cuda_ms(first, iters=iters, warmup=1))
    return a, b


def ptxas_by_function(log: str) -> dict:
    """Registers, stack and spill bytes per entry function of one ``nvcc
    -Xptxas -v`` log."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            found[name] = {}
        elif name and "bytes spill" in line:
            found[name]["stack_bytes"] = int(re.search(r"(\d+) bytes stack frame", line).group(1))
            found[name]["spill_bytes"] = sum(
                int(w) for w in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
        elif name and "Used " in line:
            found[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def sweep_phase(smi: str, counters: dict, ptxas: dict) -> dict:
    """8. the paper's sweep with the compiled batch engine on the card.

    The first SWEEP_SCENARIOS seed-0 scenarios (1-3 groups x 1-4 models, the
    default SweepConfig) through ``run_sweep`` with ``use_batch`` on the
    card's kernel and then on the numpy tier; their α*, satisfaction and
    geo-means must be equal. Every batch of the first two scenarios is held
    to ``BatchSimulator``; the widest α*-search batch of the second is held
    to the kernel's plain version on the card, timed, and tiled to
    SWEEP_WIDTHS lanes for the timing table. Returns the kernels-line entry.
    """
    import shutil

    import torch

    import repro_torch.core.batchsim_compiled as bsc
    from repro_torch.core import BatchSimulator, FastSimulator
    from repro_torch.experiments import (METHODS, SweepConfig, generate_scenario_specs,
                                         run_sweep)
    from repro_torch.kernels import batchsim_advance as kb

    dev = torch.device("cuda")
    specs = generate_scenario_specs(SWEEP_SCENARIOS, seed=SWEEP_SEED)
    finished = []               # the sweep's log lines, one per finished scenario
    captured = []               # (scenario, lanes, groups, processors, result)
    real_run = bsc.run_batch_compiled

    def capture(lanes, groups, processors, **kw):
        res = real_run(lanes, groups, processors, **kw)
        if len(finished) < 2 and res is not None:
            captured.append((len(finished), list(lanes), groups, processors, res))
        return res

    def sweep(engine: str):
        run_dir = ROOT / "build" / f"chip_smoke_sweep_{engine}"
        shutil.rmtree(run_dir, ignore_errors=True)
        finished.clear()
        t0 = time.perf_counter()
        doc = run_sweep(specs, SweepConfig(use_batch=True, batch_engine=engine),
                        run_dir=str(run_dir), workers=1, force=True, log=finished.append)
        return doc, time.perf_counter() - t0

    fallbacks0 = dict(bsc.fallbacks)
    for c in (*counters.values(), kb._batchsim_advance_thread):
        c.launches = 0
    with mock.patch.object(bsc, "run_batch_compiled", capture):
        compiled, compiled_s = sweep("compiled")
    counts = {k: c.launches for k, c in counters.items()}
    counts["batchsim_advance_thread"] = kb._batchsim_advance_thread.launches
    fallbacks = {r: bsc.fallbacks[r] - fallbacks0[r] for r in bsc.fallbacks}
    numpy_doc, numpy_s = sweep("numpy")

    keys = ("alpha_star", "alpha_star_best", "ratios", "satisfaction")
    same = True
    for rc, rn in zip(compiled["scenarios"], numpy_doc["scenarios"]):
        eq = all(rc[k] == rn[k] for k in keys)
        same = same and eq
        emit({"phase": "sweep_scenario", "scenario": rc["spec"]["name"],
              "groups": [len(g) for g in rc["spec"]["groups"]],
              "alpha_star": {"compiled": rc["alpha_star"], "numpy": rn["alpha_star"]},
              "satisfaction": {"compiled": rc["satisfaction"], "numpy": rn["satisfaction"]},
              "seconds": {"compiled": rc["wall_s"], "numpy": rn["wall_s"]}, "equal": eq})
    agg_keys = ("alpha_star", "speedup_geomean", "speedup_geomean_best", "speedup_mean",
                "satisfaction_rate")
    agg_same = all(compiled["aggregate"][k] == numpy_doc["aggregate"][k] for k in agg_keys)
    emit({"phase": "sweep", "scenarios": len(specs), "seed": SWEEP_SEED,
          "aggregate": {"compiled": {k: compiled["aggregate"][k] for k in agg_keys},
                        "numpy": {k: numpy_doc["aggregate"][k] for k in agg_keys}},
          "seconds": {"compiled": compiled_s, "numpy": numpy_s},
          "launches": counts, "fallbacks": fallbacks, "methods": list(METHODS),
          "scenarios_equal": same, "aggregates_equal": agg_same, "smi": smi})
    if not (same and agg_same):
        raise AssertionError("sweep: the kernel's run differs from the numpy engine's")
    if counts["batchsim_advance"] <= 0 or any(fallbacks.values()) or any(
            n for k, n in counts.items() if k != "batchsim_advance"):
        raise AssertionError(f"sweep: launches {counts}, fallbacks {fallbacks}")

    # every batch of the first two scenarios against the numpy tier
    worst_abs = worst_rel = 0.0
    for scenario, lanes, groups, procs, res in captured:
        a, r, ok = batch_diff(BatchSimulator(lanes, groups, procs).run(), res)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        if not ok:
            raise AssertionError(f"sweep scenario {scenario}: a batch of {len(lanes)} lanes "
                                 f"is outside the tolerance ({a}, {r})")
    emit({"phase": "sweep_check", "batches": len(captured),
          "lanes": sum(len(c[1]) for c in captured), "max_abs_err": worst_abs,
          "max_rel_err": worst_rel, "tol": {"rel": bsc.COMPILED_REL_TOL,
                                            "abs": bsc.COMPILED_ABS_TOL}})

    # the widest α*-search batch of the second scenario: kernel against its
    # plain version on the card, both timed
    _, lanes, groups, procs, _ = max((c for c in captured if c[0] == 1),
                                     key=lambda c: len(c[1]))
    prep = bsc.prepare_batch(lanes, groups, procs)
    buf = prep.packed.to(dev)
    got = kb.batchsim_advance(buf, prep.sizes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sizes, tab = kb.unpack_tables(buf)
    tab["itercap"] = torch.tensor(sizes["itercap"])
    want_out = kb.advance_plain(kb.flags_of(sizes), tab)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_err = max(float((a.double() - b.double()).nan_to_num(posinf=0.0).abs().max())
                    for a, b in zip(got[:5], want_out[:5]))
    plain_same = all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want_out))
    # the thread-per-lane kernel the warp design replaced: the same outputs,
    # then both timed in turns on the same buffer
    thread_same = all(torch.equal(a, b) for a, b in
                      zip(got, kb._batchsim_advance_thread(buf, prep.sizes)))
    ms, thread_ms = in_turns(lambda: kb.batchsim_advance(buf, prep.sizes),
                             lambda: kb._batchsim_advance_thread(buf, prep.sizes), iters=5)
    events, longest = int(got[6].sum()), int(got[6].max())
    C = sizes["G"] + sizes["P"] + 1
    # bytes: the packed tables in, the outputs out, one ring word written and
    # one read per pushed task, and S int32 pending counters written per
    # arrived request (a request with a finished task; the decrements are
    # left out, so this is a floor)
    pushes = int(got[7].sum())
    arrived = int((got[3] > 0).sum())
    nbytes = (buf.numel() * 8 + sum(t.numel() * t.element_size() for t in got)
              + 2 * 8 * pushes + 4 * sizes["S"] * arrived)
    ops = 2 * C * events               # the frontier scan's compares, per event
    # compares priced at the float32 rate, the guide's nearest: fp64 and int64
    # run no faster, so the time is a floor
    bound_ms = max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_F32_FLOPS else "operations"
    # latency: the longest lane's events, each C dependent compares of the
    # frontier scan, at no less than one cycle each at the card's top SM clock
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True, timeout=60).stdout.split()[0])
    latency_bound_ms = longest * C / (mhz * 1e6) * 1e3

    def per_event(t):
        return {"ms": min(t), "ms_range": [min(t), max(t)],
                "us_per_event_longest_lane": min(t) * 1e3 / max(longest, 1),
                "cycles_per_event_longest_lane": min(t) * 1e-3 * mhz * 1e6 / max(longest, 1),
                "x_latency_bound": min(t) / latency_bound_ms}
    warp, thread = per_event(ms), per_event(thread_ms)
    emit({"phase": "kernel_check", "kernel": "batchsim_advance", "lanes": len(lanes),
          "padded_lanes": sizes["W"], "events": events, "max_lane_events": longest,
          "ring_pushes": pushes, "arrived_requests": arrived,
          "max_abs_err": plain_err, "equal": plain_same, "thread_kernel_equal": thread_same,
          "warp_per_lane": warp, "thread_per_lane": thread,
          "thread_over_warp": thread["ms"] / warp["ms"], "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops,
          "latency_bound_ms": latency_bound_ms, "sm_clock_max_mhz": mhz,
          "shared_bytes_per_block": kb.shared_bytes(sizes),
          "lanes_per_block": kb.LANES_PER_BLOCK, "ptxas": ptxas, "smi": smi})
    if not (plain_same and thread_same):
        raise AssertionError(f"batchsim_advance differs from its plain version ({plain_err}) "
                             f"or from the thread-per-lane kernel ({thread_same})")

    # the timing table: the same batch tiled to each width
    for width in SWEEP_WIDTHS:
        tiled = [lanes[i % len(lanes)] for i in range(width)]
        t0 = time.perf_counter()
        tprep = bsc.prepare_batch(tiled, groups, procs)
        host_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tbuf = tprep.packed.to(dev)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        out = kb.batchsim_advance(tbuf, tprep.sizes)
        kernel_ms, old_ms = in_turns(lambda: kb.batchsim_advance(tbuf, tprep.sizes),
                                     lambda: kb._batchsim_advance_thread(tbuf, tprep.sizes),
                                     iters=3)
        t0 = time.perf_counter()
        res = bsc.run_batch_compiled(tiled, groups, procs)
        call_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = BatchSimulator(tiled, groups, procs).run()
        numpy_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for ln in tiled:
            FastSimulator(ln.spec, groups=groups, periods=ln.periods,
                          num_requests=ln.num_requests, noise=ln.noise,
                          dispatch_overhead=ln.dispatch_overhead, arrivals=ln.arrivals,
                          faults=ln.faults).run()
        scalar_ms = (time.perf_counter() - t0) * 1e3
        a, r, ok = batch_diff(ref, res)
        ts = tprep.sizes
        emit({"phase": "sweep_timing", "lanes": width, "padded_lanes": ts["W"],
              "kernel_ms": min(kernel_ms), "thread_kernel_ms": min(old_ms),
              "host_prep_ms": host_ms, "h2d_ms": h2d_ms,
              "compiled_call_ms": call_ms, "numpy_ms": numpy_ms, "scalar_ms": scalar_ms,
              "lane_events_max": int(out[6].max()), "ring_bytes":
                  ts["W"] * ts["P"] * ts["NP"] * ts["CAP"] * 8,
              "scratch_bytes": kb.scratch_words(ts) * 8, "packed_bytes": tbuf.numel() * 8,
              "max_abs_err": a, "ok": ok, "smi": smi})
        if not ok:
            raise AssertionError(f"sweep timing at {width} lanes: outside the tolerance")
        del tbuf, out
    torch.cuda.empty_cache()
    return {"design": "one warp per lane, the lane's event state in shared memory",
            "launches": counts["batchsim_advance"], "max_abs_err": max(worst_abs, plain_err),
            "ms": warp["ms"], "thread_kernel_ms": thread["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "latency_bound_ms": latency_bound_ms,
            "us_per_event_longest_lane": warp["us_per_event_longest_lane"],
            "thread_kernel_us_per_event_longest_lane": thread["us_per_event_longest_lane"],
            "library_ms": None}


def paper_phase(smi: str, counters: dict) -> dict:
    """9. the paper's evaluation harness on the card: every section of
    ``repro_torch.experiments.paper`` in this process at ``--smoke`` sizing,
    every kernel's launch count zeroed just before a section and read just
    after, then the two card examples as subprocesses. Returns each
    kernel's launches in the phase and K1's by route."""
    import io

    import torch

    import repro_torch.core.batchsim_compiled as bsc
    from repro_torch.experiments import paper
    from repro_torch.kernels.int8_quant import ROUTES as K1_ROUTES
    from repro_torch.kernels.int8_quant import quantize_int8

    dev = torch.device("cuda")
    args = paper.parse_args(["--smoke", "--json"])
    total = dict.fromkeys(counters, 0)
    k1_routes = dict.fromkeys(K1_ROUTES, 0)
    tol = {"flash_attention": TOL, "ssd_scan": SSD_TOL}
    for name, fn in paper.SECTIONS.items():
        zero_counts(counters)
        quantize_int8.launches_by_route = dict.fromkeys(K1_ROUTES, 0)
        fallbacks0 = dict(bsc.fallbacks)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = fn(args, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counted = read_counts(counters)
        counts = counted["launches"]
        fallbacks = {r: bsc.fallbacks[r] - fallbacks0[r] for r in bsc.fallbacks}
        rows = [line.split(",", 2) for line in out.getvalue().splitlines()]
        derived = {r[0]: r[2] for r in rows}
        for k, n in counts.items():
            total[k] += n
        for r in K1_ROUTES:
            k1_routes[r] += quantize_int8.launches_by_route[r]
        gates = {}
        if name == "simspeed":
            gates["b1_launched"] = counts["batchsim_advance"] > 0
            gates["no_fallback"] = not any(fallbacks.values())
            gates["launched_by_compiled_legs"] = (result["compiled_launches"]
                                                  == counts["batchsim_advance"])
        elif name == "kernels":
            # each row against its plain version (K1 exactly), and every
            # launch of a kernel on the route ``_route`` gives its row
            want_routes = {"flash_attention": {}, "ssd_scan": {}, "int8_quant": {}}
            for row in result:
                kernel = row["name"].split(".")[1]
                if kernel == "quantize_int8":
                    kernel = "int8_quant"
                    ok = all(torch.equal(a, b) for a, b in row["outputs"])
                else:
                    ok = all(torch.allclose(a.float(), b.float(), **tol[kernel][row["dtype"]])
                             for a, b in row["outputs"])
                gates[row["name"]] = ok and row["launches"] > 0
                routes = want_routes[kernel]
                routes[row["route"]] = routes.get(row["route"], 0) + row["launches"]
            took = {"int8_quant": dict(quantize_int8.launches_by_route), **counted["routes"]}
            gates["routes"] = all({r: n for r, n in took[k].items() if n} == want
                                  for k, want in want_routes.items())
            gates["launches"] = all(counts[k] == sum(want_routes[k].values())
                                    for k in want_routes)
        else:
            gates["no_k1_k2_k3"] = not any(
                counts[k] for k in ("flash_attention", "ssd_scan", "int8_quant"))
        if name == "prescreen":
            gates["false_prunes_0"] = derived["prescreen.false_prunes"].startswith("0 ")
        elif name == "conformance":
            gates["zero_diff"] = "max_abs_diff=0.0;" in derived["conformance.zero_diff"]
        elif name == "sweep":
            gates["deterministic"] = derived["sweep.deterministic"] == "ok=True"
        elif name == "table5":
            gates["finite_makespans"] = all(math.isfinite(m) and m > 0 for m in result)
        emit({"phase": "paper", "section": name, "seconds": seconds, "rows": rows,
              "launches": counts, "routes": counted["routes"],
              "k1_routes": dict(quantize_int8.launches_by_route), "fallbacks": fallbacks,
              "gates": gates, "smi": smi})
        if not all(gates.values()):
            raise AssertionError(f"paper section {name}: gates {gates}, launches {counts}")

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for script in PAPER_EXAMPLES:
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, script], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=PAPER_EXAMPLE_TIMEOUT)
        emit({"phase": "paper_example", "script": script, "returncode": done.returncode,
              "seconds": time.perf_counter() - t0, "stdout_tail": done.stdout[-3000:],
              "stderr_tail": done.stderr[-3000:], "smi": smi})
        if done.returncode != 0:
            raise AssertionError(f"{script} exited {done.returncode}")
    return {"launches": total, "k1_routes": k1_routes}


def cut_config(cfg, cut):
    """``cfg`` cut in depth only: a dict of fields, ``"first3"`` (the first
    three positions of the pattern, one layer each) or ``"period"`` (one
    period of the pattern)."""
    if cut == "first3":
        return dataclasses.replace(cfg, layout_pattern=cfg.layout_pattern[:3], num_layers=3)
    if cut == "period":
        return dataclasses.replace(cfg, num_layers=len(cfg.layout_pattern))
    return dataclasses.replace(cfg, **cut)


def expected_launches(cfg) -> dict:
    """Kernel launches of one prefill, from the config: K2 once in every
    self-attention, cross-attention and encoder layer, K3 once in every
    Mamba2 layer; decode launches neither."""
    from repro_torch.models.config import ATTN, ATTN_MOE, CROSS
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    self_attn = sum(k in (ATTN, ATTN_MOE) for k in kinds)
    k2 = self_attn + sum(k == CROSS for k in kinds)
    if cfg.is_encoder_decoder:
        k2 += self_attn + cfg.encoder_layers         # cross-attention, then the encoder
    return {"flash_attention": k2, "ssd_scan": sum(k.startswith("ssm") for k in kinds),
            "int8_quant": 0, "batchsim_advance": 0, "flash_attention_bwd": 0}


def random_cross_src(cfg, batch: int, gen):
    """Random modality input (image or frame embeddings) in the model's
    dtype, where the model takes one."""
    import torch
    from repro_torch.launch.serve import stub_cross_src
    stub = stub_cross_src(cfg, batch, torch.device("cuda"))
    if stub is None:
        return None
    return torch.randn(stub.shape, generator=gen, device=stub.device).to(
        getattr(torch, cfg.dtype))


def open_gates(model) -> None:
    """Every cross-attention gate at 2.0 (zero at init, which would hide
    the cross path from the logits)."""
    for blk in model.blocks:
        if blk.xattn is not None:
            blk.xattn["attn_gate"].fill_(2.0)


GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
MOE_RANGES = ("moe_ffn", "moe_experts")


def moe_profile(fn) -> dict:
    """Device ms of one call of ``fn`` split by what runs: K2, the expert
    products (the GEMMs under ``expert_swiglu``), the router product (the
    other GEMM under ``moe_ffn``), the dispatch (the rest of ``moe_ffn``:
    top-k, sort, gathers, scatter, SiLU·up, the combine), the other GEMMs
    (projections, LM head) and the rest (norms, RoPE, decode attention,
    residuals, copies). ``moe_ffn`` and ``expert_swiglu`` run inside
    ``record_function`` ranges for this call only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    moe = importlib.import_module("repro_torch.models.moe")
    transformer = importlib.import_module("repro_torch.models.transformer")

    def ranged(name, f):
        def call(*args, **kw):
            with record_function(name):
                return f(*args, **kw)
        return call
    torch.cuda.synchronize()
    with mock.patch.object(transformer, "moe_ffn", ranged("moe_ffn", moe.moe_ffn)), \
            mock.patch.object(moe, "expert_swiglu", ranged("moe_experts", moe.expert_swiglu)), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in MOE_RANGES]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k2 = sum(e.self_device_time_total for e in kernels if "flash_fwd" in e.key) / 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def inside(e, name):
        p = e.cpu_parent
        while p is not None:
            if p.name == name:
                return True
            p = p.cpu_parent
        return False
    gemms = [e for e in events if e.name in GEMM_OPS]
    experts = sum(e.device_time_total for e in gemms if inside(e, "moe_experts")) / 1e3
    router = sum(e.device_time_total for e in gemms
                 if inside(e, "moe_ffn") and not inside(e, "moe_experts")) / 1e3
    other_gemm = sum(e.device_time_total for e in gemms if not inside(e, "moe_ffn")) / 1e3
    moe_ms = sum(e.device_time_total for e in events if e.name == "moe_ffn") / 1e3
    split = {"flash_attention": k2, "expert_products": experts, "router_product": router,
             "dispatch": moe_ms - experts - router, "other_gemm": other_gemm,
             "elementwise_and_other": busy - k2 - moe_ms - other_gemm}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "moe_ffn_ms": moe_ms,
            "moe_calls": sum(e.name == "moe_ffn" for e in events), "split_ms": split,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]]}


def routing(mode: str, chosen: list):
    """Pins an MoE model's expert choices across two prefills: ``record``
    keeps ``router_topk``'s expert ids call by call, ``replay`` takes them
    back in the same order, with the gates recomputed from this run's
    router probabilities as ``router_topk`` normalises them. A top-k
    near-tie or an expert at its capacity would otherwise turn a bf16
    rounding difference into another expert for a token."""
    import torch
    moe = importlib.import_module("repro_torch.models.moe")
    real = moe.router_topk

    def record(x2d, router_w, k):
        gates, idx, probs = real(x2d, router_w, k)
        chosen.append(idx)
        return gates, idx, probs

    def replay(x2d, router_w, k):
        probs = torch.softmax(x2d.float() @ router_w, dim=-1)
        idx = chosen.pop(0)
        gates = probs.gather(1, idx)
        return gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9), idx, probs
    return mock.patch.object(moe, "router_topk", record if mode == "record" else replay)


def serve_model(arch: str, check_cut, serve_cut, gen, smi: str, counters: dict) -> dict:
    """One served model on the card; returns each kernel's launches in its
    serve run.

    - check: the model cut to ``check_cut`` (full width), every
      ``attn_gate`` at 2.0 (zero at init, which would hide the cross
      path), a random modality input; a prefill through the kernels
      against the same prefill with ``ops.flash_attention`` and
      ``ops.ssd_scan`` swapped for their plain versions, with the same
      expert choices (``routing``), within 2e-2 of the largest logit;
      launches as the config gives;
    - serve: the model cut to ``serve_cut``, random weights from seed 0,
      the reference's stub modality input; ``generate`` of 4 requests of
      1024 prompt tokens + 32 greedy tokens, every kernel's count zeroed
      just before and read just after: K2's and K3's launches as the
      config gives, all on the ``sm90`` route; then an MoE model's
      prefill twice more, bit for bit equal to the served one;
    - profile (``PROFILED`` only): device time of one prefill and of 8
      decode steps, split by kernel for an MoE model (``moe_profile``).
    """
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ROUTES, flash_attention, flash_attention_plain
    from repro_torch.kernels.ssd_scan import ROUTES as SSD_ROUTES
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.launch.serve import generate, stub_cross_src
    from repro_torch.models import forward_decode, forward_prefill, init_params
    ops = importlib.import_module("repro_torch.kernels.ops")
    dev = torch.device("cuda")
    full = get_config(arch)

    def zero():
        for c in counters.values():
            c.launches = 0
        flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
        ssd_scan.launches_by_route = dict.fromkeys(SSD_ROUTES, 0)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    tokens = torch.randint(0, full.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                           device=dev)
    # check: kernels against their plain versions, at full width
    cfg = cut_config(full, check_cut)
    model = init_params(cfg, seed=0, device=dev)
    open_gates(model)
    cross = random_cross_src(cfg, SERVE_BATCH, gen)
    chosen = []
    with torch.inference_mode():
        zero()
        with routing("record", chosen):
            lk = forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)[0].float()
        counts = {k: c.launches for k, c in counters.items()}
        with mock.patch.object(ops, "flash_attention", flash_attention_plain), \
                mock.patch.object(ops, "ssd_scan", ssd_scan_plain), routing("replay", chosen):
            lp = forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)[0].float()
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    want = expected_launches(cfg)
    ok = bool(torch.isfinite(lk).all()) and err <= 2e-2 * scale and counts == want
    emit({"phase": "depth_check", "arch": cfg.name, "layers": cfg.num_layers,
          "encoder_layers": cfg.encoder_layers,
          "pattern": cfg.layout_pattern, "gates": 2.0 if cfg.arch_type == "vlm" else None,
          "routing_pinned": cfg.uses_moe,
          "cross_len": None if cross is None else cross.shape[1],
          "max_abs_err": err, "max_abs_logit": scale, "tol": 2e-2 * scale,
          "launches": counts, "want_launches": want, "ok": ok})
    if not ok:
        raise AssertionError(f"{arch}: the prefill through the kernels differs from the plain "
                             f"one ({err} > {2e-2 * scale}) or launches {counts} != {want}")
    del model, lk, lp, cross
    free()

    # serve
    cfg = cut_config(full, serve_cut)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    dtype = getattr(torch, cfg.dtype)
    cross = stub_cross_src(cfg, SERVE_BATCH, dev, dtype)
    warm = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device=dev)
    generate(model, warm, 2, stub_cross_src(cfg, 1, dev, dtype))   # library handles, allocator
    torch.cuda.reset_peak_memory_stats()
    zero()
    res = generate(model, tokens, SERVE_NEW, cross)
    counts = {k: c.launches for k, c in counters.items()}
    routes = {"flash_attention": dict(flash_attention.launches_by_route),
              "ssd_scan": dict(ssd_scan.launches_by_route)}
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg)
    want_routes = {k: {"sm90": want[k], "simt": 0} for k in routes}
    same_bits = None
    if cfg.uses_moe:               # the MoE combine is deterministic: equal bits
        with torch.inference_mode():
            again = [forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)[0]
                     for _ in range(2)]
        same_bits = all(torch.equal(res.prefill_logits.view(torch.int16), a.view(torch.int16))
                        for a in again)
        del again
    ok = (counts == want and routes == want_routes and same_bits in (None, True)
          and tuple(res.ids.shape) == (SERVE_BATCH, SERVE_NEW + 1)
          and bool(((res.ids >= 0) & (res.ids < cfg.vocab_size)).all())
          and bool(torch.isfinite(res.prefill_logits).all())
          and bool(torch.isfinite(res.last_logits).all()))
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "encoder_layers": cfg.encoder_layers, "pattern": cfg.layout_pattern,
          "cut": serve_cut or None, "params": n_params, "param_count": cfg.param_count(),
          "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
          "cross_len": None if cross is None else cross.shape[1],
          "init_s": init_s, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
          "decode_tok_s": SERVE_BATCH * SERVE_NEW / res.decode_s,
          "prefill_tok_s": SERVE_BATCH * SERVE_PROMPT / res.prefill_s,
          "peak_mem_gb": peak / 1e9, "launches": counts, "routes": routes,
          "prefills_bit_equal": same_bits,
          "sample_ids": res.ids[0, :8].tolist(), "device": torch.cuda.get_device_name(0),
          "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"{arch}: serve check failed: launches {counts}, want {want}; "
                             f"routes {routes}, want {want_routes}; equal bits {same_bits}")

    if arch in PROFILED:
        # where the time goes: device kernel time per phase, and the prefill
        # on the host clock a few more times (outside the counted run)
        with torch.inference_mode():
            prefill_s = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)
                torch.cuda.synchronize()
                prefill_s.append(time.perf_counter() - t0)
            _, caches, clen = forward_prefill(model, tokens, SERVE_PROMPT + 9, cross)
            prof = moe_profile if cfg.uses_moe else device_profile
            prefill_prof = prof(lambda: forward_prefill(model, tokens, SERVE_PROMPT + 1, cross))

            def decode_steps():
                c, n = caches, clen
                for _ in range(8):
                    _, c, n = forward_decode(model, tokens[:, -1:], c, n)
            decode_prof = prof(decode_steps)
        emit({"phase": "profile", "arch": cfg.name, "prefill": prefill_prof,
              "decode_8_steps": decode_prof,
              "unprofiled_prefill_ms": res.prefill_s * 1e3,
              "prefill_s_again": prefill_s,
              "unprofiled_decode_step_ms": res.decode_s / SERVE_NEW * 1e3,
              "prefill_device_share": prefill_prof["device_busy_ms"] / (res.prefill_s * 1e3),
              "decode_device_share":
                  decode_prof["device_busy_ms"] / 8 / (res.decode_s / SERVE_NEW * 1e3),
              "smi": smi})
        del caches
    del model, res, cross
    free()
    return {k: counts[k] for k in ("flash_attention", "ssd_scan")}


def attention_bwd_bound_ms(dtype: str, shape, causal: bool, window, q_offset: int):
    """Least time for the backward of these inputs: 2.5x the forward's
    operations (dQ, dK, dV and the recomputed S and dP: 10·hd per unmasked
    (q, k) pair), and q, k, v, o, dO, lse read once and dq, dk, dv written
    once."""
    bh, sq, sk, hd, g = shape
    fwd_flops = attention_bound_ms(dtype, shape, causal, window, q_offset)[2]
    flops = 2.5 * fwd_flops
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * hd * (4 * bh * sq + 4 * (bh // g) * sk) + 4 * bh * sq
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def check_attention_bwd(gen, smi: str) -> dict:
    """K2's backward kernels against their plain version at ``BWD_CHECKS``:
    each takes the same o and log-sum-exp (from the forward kernel, whose
    output is held to the plain forward's within ``TOL``, as in ``CHECKS``,
    and to the serving call's bits, and whose lse to the plain one's) and the
    same dO. ``flash_attention_bwd`` launches once on the route ``_route``
    gives the dtype; a bf16 case also takes the ``simt`` kernel through
    ``_flash_attention_bwd_simt``. Each route within ``BWD_TOL`` of the
    largest gradient and the same bits on a second run; then timed at
    phi4-mini-3.8b's and the demo's shapes. The result's ``forward`` holds
    the forward's error at those two shapes."""
    import torch
    from repro_torch.kernels.flash_attention import (NEG_INF, ROUTES,
                                                     _flash_attention_bwd_simt, _route,
                                                     flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain)
    dev = torch.device("cuda")
    timed, worst, fwd_errs = {}, {}, {}
    for case in BWD_CHECKS:
        dtype, (bh, sq, sk, hd, g), causal, window, q_offset = case
        tdt = getattr(torch, dtype)
        q, do = (torch.randn((bh, sq, hd), generator=gen, device=dev).to(tdt) for _ in range(2))
        k, v = (torch.randn((bh // g, sk, hd), generator=gen, device=dev).to(tdt)
                for _ in range(2))
        kw = dict(q_heads_per_kv=g, causal=causal, window=window, q_offset=q_offset)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        want_out, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
        out_err = float((out.float() - want_out.float()).abs().max())
        out_ok = bool(torch.allclose(out.float(), want_out.float(), **TOL[dtype]))
        dead = want_lse == NEG_INF
        lse_err = float((lse - want_lse)[~dead].abs().max()) if bool((~dead).any()) else 0.0
        lse_ok = bool(torch.equal(lse == NEG_INF, dead)) and lse_err <= (
            2e-3 if dtype == "bfloat16" else 1e-4)
        same_out = bool(torch.equal(out, flash_attention(q, k, v, **kw)))
        route = _route(tdt, hd)
        before = dict(flash_attention_bwd.launches_by_route)
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        took = {r: flash_attention_bwd.launches_by_route[r] - before[r] for r in ROUTES}
        runs = {route: (got, flash_attention_bwd(q, k, v, out, lse, do, **kw))}
        if dtype == "bfloat16":
            runs["simt"] = tuple(_flash_attention_bwd_simt(q, k, v, out, lse, do, **kw)
                                 for _ in range(2))
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        scales = [float(b.float().abs().max()) for b in want]
        tol = BWD_TOL[dtype]
        for r, (first, second) in runs.items():
            errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(first, want)]
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            ok = (all(e <= tol * max(sc, 1e-6) for e, sc in zip(errs, scales)) and same
                  and took == {x: int(x == route) for x in ROUTES} and lse_ok and same_out
                  and out_ok and all(a.dtype == tdt for a in first))
            emit({"phase": "kernel_check", "kernel": "flash_attention_bwd", "route": r,
                  "dtype": dtype, "shape": case[1], "causal": causal, "window": window,
                  "q_offset": q_offset, "max_abs_err": dict(zip(("dq", "dk", "dv"), errs)),
                  "max_abs_grad": dict(zip(("dq", "dk", "dv"), scales)), "tol_of_largest": tol,
                  "same_bits_twice": same, "lse_max_abs_err": lse_err, "dead_rows": int(dead.sum()),
                  "forward_max_abs_err": out_err, "forward_tol": TOL[dtype],
                  "serving_output_bits_equal": same_out, "launches": took, "ok": ok})
            if not ok:
                raise AssertionError(
                    f"flash_attention_bwd {r} differs from its plain version at {case}: "
                    f"{errs} (of {scales}), same bits {same}, lse {lse_err}, forward {out_err}, "
                    f"launches {took}")
            worst[r] = max(worst.get(r, 0.0),
                           max(e / max(sc, 1e-6) for e, sc in zip(errs, scales)))
            if r == route and case in (BWD_PHI4, BWD_DEMO):
                timed[case] = (max(errs), (q, k, v, out, lse, do, kw))
                fwd_errs[case] = out_err
        del q, k, v, do, out, lse, got, runs, want, want_out
    err, inputs = timed.pop(BWD_PHI4)
    result = dict(max_abs_err=err, worst_err_over_largest_grad=worst,
                  **time_attention_bwd(BWD_PHI4, inputs, TRAIN_BATCH, smi, "phi4-mini-3.8b train"))
    result["forward"] = {path: dict(shape=case[1], dtype=case[0], max_abs_err=fwd_errs[case],
                                    tol=TOL[case[0]])
                         for path, case in (("phi4-mini-3.8b train", BWD_PHI4),
                                            ("demo-100m train", BWD_DEMO))}
    err, inputs = timed.pop(BWD_DEMO)
    t = time_attention_bwd(BWD_DEMO, inputs, CKPT_BATCH, smi, "demo-100m train")
    result["demo_shape"] = dict(shape=BWD_DEMO[1], dtype=BWD_DEMO[0], route="simt",
                                max_abs_err=err,
                                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
    return result


def time_attention_bwd(case, inputs, batch: int, smi: str, path: str) -> dict:
    """K2's backward at ``case``: the kernel of the dtype's route, the
    ``simt`` kernel at bf16 (a bf16 case only), the autograd backward of
    ``F.scaled_dot_product_attention`` at the same shape (a yardstick the port
    never calls) and the plain version in turns (a, b, c, d, d, c, b, a);
    each keeps its least. The forward with its log-sum-exp is timed beside
    them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_flash_attention_bwd_simt, _route,
                                                     flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_plain)
    q, k, v, out, lse, do, kw = inputs
    bh, sq, hd = q.shape
    route = _route(q.dtype, hd)
    q4, k4, v4 = (t.view(batch, t.shape[0] // batch, t.shape[1], hd).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=case[2], enable_gqa=True)
    do4 = do.view(batch, bh // batch, sq, hd)
    contenders = {"kernel": (lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw), 20)}
    if route != "simt":
        contenders["simt"] = (lambda: _flash_attention_bwd_simt(q, k, v, out, lse, do, **kw), 5)
    contenders.update({
        "sdpa_bwd": (lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), do4,
                                                 retain_graph=True), 20),
        "plain": (lambda: flash_attention_bwd_plain(q, k, v, out, lse, do, **kw), 3)})
    turns = {who: [] for who in contenders}
    for who in list(contenders) + list(reversed(contenders)):
        fn, iters = contenders[who]
        turns[who].append(cuda_ms(fn, iters=iters))
    fwd_lse_ms = cuda_ms(lambda: flash_attention(q, k, v, return_lse=True, **kw), iters=20)
    fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters=20)
    ms, lib_ms, plain_ms = (min(turns[n]) for n in ("kernel", "sdpa_bwd", "plain"))
    simt_ms = min(turns["simt"]) if "simt" in turns else ms
    bound_ms, bound_by, flops, nbytes = attention_bwd_bound_ms(*case)
    emit({"phase": "kernel_time", "kernel": "flash_attention_bwd", "route": route,
          "path": path, "dtype": case[0], "shape": case[1], "causal": case[2], "ms": ms,
          "simt_ms": simt_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "library": "sdpa autograd backward", "turns_ms": turns, "bound_ms": bound_ms,
          "bound_by": bound_by, "flops": flops, "bytes": nbytes,
          "tflops": {n: flops / min(t) / 1e9 for n, t in turns.items()},
          "share_of_bound": bound_ms / ms, "slower_than_sdpa_bwd": ms / lib_ms,
          "speedup_over_simt": simt_ms / ms, "forward_ms": fwd_ms,
          "forward_with_lse_ms": fwd_lse_ms, "smi": smi})
    del sdpa_out, q4, k4, v4
    return dict(ms=ms, simt_ms=simt_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


def train_profile(model, opt, state, tokens, labels) -> dict:
    """Device ms of one train step split by what runs: K2's forward, K2's
    backward (its three kernels on either route, also apart), cuBLAS, the
    optimizer's update (the kernels under its ``record_function`` range, for
    this call only) and the rest (norms, RoPE, SwiGLU, the loss, the
    embedding's gradient, copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.train import train_step

    def update(*args):
        with record_function("optimizer"):
            return opt[1](*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = train_step(model, (opt[0], update), state, tokens, labels, None,
                                 remat=True)
        float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key != "optimizer"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3

    def ms(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key)) / 1e3
    fwd = ms(lambda key: "flash_fwd" in key)
    bwd = ms(lambda key: any(n + "<" in key for n in BWD_KERNELS))
    bwd_by_kernel = {n: ms(lambda key, n=n: n + "<" in key) for n in BWD_KERNELS}
    gemm = ms(lambda key: any(n in key.lower() for n in ("gemm", "nvjet", "xmma", "cutlass")))
    def inside(e, name):
        p = e.cpu_parent
        while p is not None:
            if p.name == name:
                return True
            p = p.cpu_parent
        return False
    # each kernel once: the self device time of every op under the range
    optimizer = sum(e.self_device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CPU and inside(e, "optimizer")) / 1e3
    split = {"attention_forward": fwd, "attention_backward": bwd, "cublas": gemm,
             "optimizer": optimizer, "rest": busy - fwd - bwd - gemm - optimizer}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "split_ms": split,
            "attention_backward_ms": {n: t for n, t in bwd_by_kernel.items() if t},
            "device_share": busy / wall_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]]}, state


def train_check(counters: dict) -> None:
    """phi4-mini-3.8b at full width cut to one layer, bf16, random weights
    from seed 0, the first ``MarkovDataset`` batch of the train phase:
    ``forward_train`` (remat on) and the loss's backward through K2's forward
    and backward kernels (2 forward launches with remat, 1 backward, on the
    ``sm90`` route), against
    the same with ``ops.FlashAttentionFn`` swapped for the plain forward,
    which autograd differentiates. The loss within ``TRAIN_LOSS_TOL`` and
    every parameter's gradient within ``TRAIN_GRAD_TOL`` (relative L2).
    Then the kernels again with the backward kernel's dQ and dK zeroed: the
    same limits must reject that."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward_train, init_params
    from repro_torch.train import DataConfig, MarkovDataset, cross_entropy_loss
    ops = importlib.import_module("repro_torch.kernels.ops")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = torch.device("cuda")
    cfg = cut_config(get_config(TRAIN_ARCH), {"num_layers": 1})
    model = init_params(cfg, seed=0, device=dev)
    model.requires_grad_(True)
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    batch_size=TRAIN_BATCH, seed=0))
    tokens, labels = (torch.from_numpy(a).to(dev, torch.int64) for a in next(data.batches()))

    def run():
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(forward_train(model, tokens, None, remat=True), labels)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    class PlainAttention:      # in place of FlashAttentionFn: autograd through the plain forward
        @staticmethod
        def apply(q, k, v, g, causal, window, q_offset):
            return fa.flash_attention_plain(q, k, v, q_heads_per_kv=g, causal=causal,
                                            window=window, q_offset=q_offset)

    class LostDqDk(fa.FlashAttentionFn):     # the kernels, with the backward's dQ and dK zeroed
        @staticmethod
        def backward(ctx, do):
            dq, dk, *rest = fa.FlashAttentionFn.backward(ctx, do)
            return (torch.zeros_like(dq), torch.zeros_like(dk), *rest)

    def rel(got, want):
        return {n: float((got[n].float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
                for n, w in want.items()}

    for c in counters.values():
        c.launches = 0
    fa.flash_attention_bwd.launches_by_route = dict.fromkeys(fa.ROUTES, 0)
    loss_k, grads_k = run()
    counts = {k: c.launches for k, c in counters.items()}
    bwd_routes = dict(fa.flash_attention_bwd.launches_by_route)
    with mock.patch.object(ops, "FlashAttentionFn", PlainAttention):
        loss_p, grads_p = run()
    with mock.patch.object(ops, "FlashAttentionFn", LostDqDk):
        loss_z, grads_z = run()
    torch.cuda.synchronize()
    errs, errs_z = rel(grads_k, grads_p), rel(grads_z, grads_p)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    want = {k: 0 for k in counters}
    want.update(flash_attention=2, flash_attention_bwd=1)
    finite = math.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    rejects_lost = max(errs_z.values()) > TRAIN_GRAD_TOL
    ok = (finite and loss_err <= TRAIN_LOSS_TOL and max(errs.values()) <= TRAIN_GRAD_TOL
          and counts == want and rejects_lost and bwd_routes == {"sm90": 1, "simt": 0}
          and len(grads_p) == sum(1 for _ in model.parameters()))
    emit({"phase": "train_check", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "loss": loss_k, "plain_loss": loss_p, "loss_rel_err": loss_err,
          "loss_tol": TRAIN_LOSS_TOL, "grad_rel_err": errs, "grad_tol": TRAIN_GRAD_TOL,
          "lost_dq_dk_grad_rel_err": errs_z, "lost_dq_dk_rejected": rejects_lost,
          "launches": counts, "want_launches": want,
          "routes": {"flash_attention_bwd": bwd_routes}, "ok": ok})
    if not ok:
        raise AssertionError(f"train_check: loss {loss_k} vs {loss_p}, gradients {errs}, "
                             f"launches {counts} (want {want}), backward routes {bwd_routes}, "
                             f"lost dQ/dK rejected {rejects_lost}")
    del model, grads_k, grads_p, grads_z
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(smi: str, counters: dict) -> dict:
    """phi4-mini-3.8b at full width and depth (32 layers, d 3072, vocab
    200064), bf16, random weights from seed 0, the optimizer
    ``optimizer_for_config`` picks (AdamW) at ``TRAIN_LR``, remat on,
    batches of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` from ``MarkovDataset``:
    ``TRAIN_WARMUP`` steps, then ``TRAIN_STEPS`` through ``train_step`` with
    every kernel's count zeroed just before and read just after (K2's forward
    2 x 32 a step and its backward 32, all ``sm90``), each step on the host
    clock; the loss finite and falling (the last three steps' mean below the
    first three's); the peak memory; then one more step
    under the profiler. Returns the counted launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ROUTES, flash_attention, flash_attention_bwd
    from repro_torch.models import init_params, param_leaves
    from repro_torch.train import (DataConfig, MarkovDataset, make_optimizer,
                                   optimizer_for_config, train_step)
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    model.requires_grad_(True)
    opt_name = optimizer_for_config(cfg)
    opt = make_optimizer(opt_name, lr=TRAIN_LR)
    state = opt[0](param_leaves(model))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    state_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    batch_size=TRAIN_BATCH, seed=0))
    it = data.batches()
    batches = [tuple(torch.from_numpy(a).to(dev, torch.int64) for a in next(it))
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for tokens, labels in batches[:TRAIN_WARMUP]:
        state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
        losses.append(float(loss))
    for c in counters.values():
        c.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
    for tokens, labels in batches[TRAIN_WARMUP:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = {k: c.launches for k, c in counters.items()}
    routes = dict(flash_attention.launches_by_route)
    bwd_routes = dict(flash_attention_bwd.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    want = {k: 0 for k in counters}
    want.update(flash_attention=2 * layers * TRAIN_STEPS, flash_attention_bwd=layers * TRAIN_STEPS)
    prof, state = train_profile(model, opt, state, *batches[-1])
    mean_s = sum(step_s) / len(step_s)
    ok = (counts == want and routes == {"sm90": want["flash_attention"], "simt": 0}
          and bwd_routes == {"sm90": want["flash_attention_bwd"], "simt": 0}
          and all(math.isfinite(x) for x in losses) and sum(losses[-3:]) < sum(losses[:3]))
    emit({"phase": "train", "arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": n_params, "dtype": cfg.dtype,
          "optimizer": opt_name, "lr": TRAIN_LR, "remat": True, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "init_s": init_s, "state_gb_before_step": state_gb, "data_s": data_s,
          "losses": losses, "ln_vocab": math.log(cfg.vocab_size), "loss_floor": data.entropy(),
          "step_s": step_s, "mean_step_s": mean_s, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_s,
          "peak_mem_gb": peak / 1e9, "launches": counts, "want_launches": want,
          "routes": {"flash_attention": routes, "flash_attention_bwd": bwd_routes},
          "profile": prof,
          "device": torch.cuda.get_device_name(0), "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"train: launches {counts} (want {want}), routes {routes}, "
                             f"backward routes {bwd_routes}, losses {losses}")
    del model, state, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_ckpt_phase(smi: str, counters: dict) -> dict:
    """The 100M demo of ``examples/train_100m_torch.py`` (f32) through
    ``repro_torch.train.train``: ``CKPT_STEPS`` steps with a checkpoint at
    ``CKPT_AT``, then the same call again, which resumes from it. The
    resumed run's first loss must equal the uninterrupted run's at that
    step, bit for bit, and the loss must fall. Every kernel's count is zeroed
    before the two runs and read after: K2's forward and its backward once
    per layer and step, both on the ``simt`` route (f32). Returns the
    counted launches."""
    import importlib.util

    import torch
    from repro_torch.kernels.flash_attention import ROUTES, flash_attention, flash_attention_bwd
    from repro_torch.train import TrainConfig, train
    spec = importlib.util.spec_from_file_location("train_100m_torch",
                                                  ROOT / "examples" / "train_100m_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = example.model_100m()
    path = ROOT / "build" / "chip_smoke_train_100m.msgpack"
    path.unlink(missing_ok=True)
    tc = TrainConfig(steps=CKPT_STEPS, batch_size=CKPT_BATCH, seq_len=CKPT_SEQ, lr=1e-3,
                     log_every=0, checkpoint_path=str(path), checkpoint_every=CKPT_AT)
    for c in counters.values():
        c.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
    t0 = time.perf_counter()
    whole = train(cfg, tc)
    whole_s = time.perf_counter() - t0
    ckpt_bytes = path.stat().st_size
    t0 = time.perf_counter()
    resumed = train(cfg, tc)
    resumed_s = time.perf_counter() - t0
    counts = {k: c.launches for k, c in counters.items()}
    routes = dict(flash_attention.launches_by_route)
    bwd_routes = dict(flash_attention_bwd.launches_by_route)
    path.unlink()
    steps = CKPT_STEPS + CKPT_STEPS - CKPT_AT
    want = {k: 0 for k in counters}
    want.update(flash_attention=cfg.num_layers * steps, flash_attention_bwd=cfg.num_layers * steps)
    tail = whole.losses[CKPT_AT:]
    exact = resumed.losses[0] == whole.losses[CKPT_AT]
    falling = sum(whole.losses[-5:]) < sum(whole.losses[:5])
    ok = (exact and falling and len(resumed.losses) == CKPT_STEPS - CKPT_AT
          and counts == want and routes == {"sm90": 0, "simt": want["flash_attention"]}
          and bwd_routes == {"sm90": 0, "simt": want["flash_attention_bwd"]}
          and all(math.isfinite(x) for x in whole.losses + resumed.losses))
    emit({"phase": "train_ckpt", "model": cfg.name, "params": cfg.param_count(),
          "dtype": cfg.dtype, "batch": CKPT_BATCH, "seq": CKPT_SEQ, "steps": CKPT_STEPS,
          "checkpoint_at": CKPT_AT, "checkpoint_bytes": ckpt_bytes,
          "losses_first5": whole.losses[:5], "losses_last5": whole.losses[-5:],
          "loss_floor": whole.loss_floor, "loss_at_checkpoint": whole.losses[CKPT_AT],
          "resumed_first_loss": resumed.losses[0], "resume_exact": exact,
          "resumed_max_abs_diff": max(abs(a - b) for a, b in zip(resumed.losses, tail)),
          "whole_s": whole_s, "resumed_s": resumed_s, "tokens_per_s": whole.tokens_per_s,
          "launches": counts, "want_launches": want,
          "routes": {"flash_attention": routes, "flash_attention_bwd": bwd_routes},
          "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"train_ckpt: exact {exact}, falling {falling}, launches {counts} "
                             f"(want {want}), routes {routes}, backward routes {bwd_routes}")
    torch.cuda.empty_cache()
    return counts


def ssd_inputs(dtype: str, shape, gen):
    """Inputs on the card. The serving shapes (64 or 256 heads a group) take
    the model's A (-1 … -16 over the heads), where exp(cum_i - cum_j)
    overflows above the diagonal."""
    import torch
    bh, s, p, n, chunk, g, with_state = shape
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)
    x = randn(bh, s, p).to(tdt)
    dt = torch.nn.functional.softplus(randn(bh, s))
    if g >= 64:
        A = -torch.linspace(1.0, 16.0, g, device=dev).repeat(bh // g)
    else:
        A = -torch.exp(randn(bh) * 0.3)
    Bm, Cm = (randn(bh // g, s, n) * 0.3).to(tdt), (randn(bh // g, s, n) * 0.3).to(tdt)
    kw = dict(chunk=chunk, heads_per_group=g,
              initial_state=randn(bh, n, p) if with_state else None)
    return (x, dt, A, Bm, Cm), kw


def dry_terms(arch: str, cfg, kind: str, batch: int, seq: int) -> dict:
    """The dry run's roofline terms for one step at this shape on the 1×1
    mesh (plain meta tensors, one device's whole step)."""
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.shapes import InputShape
    rec = run_one(arch, InputShape(f"{kind}_{batch}x{seq}", seq, batch, kind), "host",
                  save=False, verbose=False, cfg=cfg)
    if not rec["ok"]:
        raise AssertionError(f"dry run of {arch} {kind} {batch}x{seq}: {rec['error']}")
    return {k: rec[k] for k in ("t_compute", "t_memory", "t_collective", "bottleneck",
                                "per_device_flops", "per_device_bytes", "t_memory_fused")}


def beside(seconds: float, terms: dict) -> dict:
    """A measured time beside the dry run's terms: its multiple of the largest
    (eager-op bounds: the memory term counts every unfused op's bytes), and
    of the larger of the compute term and the fused memory bound (every
    argument moved once)."""
    t_max = max(terms["t_compute"], terms["t_memory"], terms["t_collective"])
    t_fused = max(terms["t_compute"], terms["t_memory_fused"], terms["t_collective"])
    return {"seconds": seconds, **terms, "multiple_of_largest_term": seconds / t_max,
            "multiple_of_fused_bound": seconds / t_fused}


def zero_counts(counters: dict) -> None:
    from repro_torch.kernels.flash_attention import ROUTES, flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ROUTES as SSD_ROUTES, ssd_scan
    for c in counters.values():
        c.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
    ssd_scan.launches_by_route = dict.fromkeys(SSD_ROUTES, 0)


def read_counts(counters: dict) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"launches": {k: c.launches for k, c in counters.items()},
            "routes": {"flash_attention": dict(flash_attention.launches_by_route),
                       "flash_attention_bwd": dict(flash_attention_bwd.launches_by_route),
                       "ssd_scan": dict(ssd_scan.launches_by_route)}}


def steps_phase(smi: str, counters: dict) -> dict:
    """The reference's entry points on the card: ``make_train_step``,
    ``make_prefill_step`` and ``make_decode_step`` on ``make_host_mesh()``.

    phi4-mini-3.8b at full width and depth, bf16, random weights from seed
    0: the train step (AdamW at its default rate, remat) on the same batches as
    ``train_step`` from the same weights, its loss at each of the first
    ``STEPS_HELD`` steps within ``TRAIN_LOSS_TOL`` of the direct path's (the
    second loss reads the first update) and its parameters after them
    within ``STEPS_PARAM_TOL`` of the update's size, then ``STEPS_TRAIN``
    steps timed;
    the prefill and ``STEPS_DECODE`` decode steps at batch 4 with 1024
    prompt tokens against ``generate`` on the same weights and tokens
    (logits within the bf16 tolerance, greedy ids equal); mamba2-1.3b's
    prefill likewise, through K3. Every kernel's count is zeroed just
    before each timed run and read just after: K2 forward and backward and
    K3 launch, all ``sm90``. Beside each time, the dry run's three terms for
    the same shape on the 1×1 mesh. Returns the launches by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
    from repro_torch.models import init_params, param_leaves
    from repro_torch.train import (DataConfig, MarkovDataset, make_optimizer,
                                   optimizer_for_config, train_step)
    dev = torch.device("cuda")
    mesh = make_host_mesh()
    by_path = {"flash_attention": {}, "flash_attention_bwd": {}, "ssd_scan": {}}
    tol = TOL["bfloat16"]

    # train: the direct path's losses, then the mesh step's from the same start
    cfg = get_config(TRAIN_ARCH)
    opt_name = optimizer_for_config(cfg)
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    batch_size=TRAIN_BATCH, seed=0))
    it = data.batches()
    batches = [tuple(torch.from_numpy(a).to(dev, torch.int64) for a in next(it))
               for _ in range(STEPS_TRAIN + 1)]

    def fresh():                         # the optimizer at its default rate, as the step's
        model = init_params(cfg, seed=0, device=dev)
        model.requires_grad_(True)
        opt = make_optimizer(opt_name)
        return model, opt, opt[0](param_leaves(model))
    held = ("embed", "blocks.0.attn.wq", f"blocks.{cfg.num_layers - 1}.mlp.w_down")

    def snapshot(model):                 # on the host, out of the measured peak
        params = dict(model.named_parameters())
        return {k: params[k].detach().to("cpu", copy=True) for k in held}
    model, opt, state = fresh()
    initial = snapshot(model)
    direct = []
    for tokens, labels in batches[:STEPS_HELD]:
        state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
        direct.append(float(loss))
    direct_params = snapshot(model)
    del model, opt, state
    gc.collect()
    torch.cuda.empty_cache()
    shape = InputShape(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    step, _ = make_train_step(cfg, mesh, shape, optimizer=opt_name)
    model, opt, state = fresh()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i, (tokens, labels) in enumerate(batches[:STEPS_TRAIN]):
        if i == 1:                       # the first step warms up; the rest are counted
            zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, loss = step(model, state, tokens, labels)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == STEPS_HELD - 1:
            step_params = snapshot(model)
    counted = read_counts(counters)
    param_rel = {k: float((step_params[k].float() - direct_params[k].float()).norm()
                          / (direct_params[k].float() - initial[k].float()).norm())
                 for k in held}
    del initial, direct_params, step_params
    peak = torch.cuda.max_memory_allocated()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, direct))
    n = STEPS_TRAIN - 1
    want = {k: 0 for k in counters}
    want.update(flash_attention=2 * cfg.num_layers * n, flash_attention_bwd=cfg.num_layers * n)
    mean_s = sum(step_s[1:]) / n
    terms = dry_terms(TRAIN_ARCH, cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    ok = (loss_err <= TRAIN_LOSS_TOL and counted["launches"] == want
          and max(param_rel.values()) <= STEPS_PARAM_TOL
          and counted["routes"]["flash_attention"]["simt"] == 0
          and counted["routes"]["flash_attention_bwd"]["simt"] == 0
          and all(math.isfinite(x) for x in losses))
    emit({"phase": "steps", "step": "make_train_step", "arch": cfg.name, "mesh": "1x1",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "optimizer": opt_name, "remat": True,
          "losses": losses, "direct_losses": direct, "max_rel_loss_err": loss_err,
          "loss_tol": TRAIN_LOSS_TOL, "param_rel_err": param_rel,
          "param_tol": STEPS_PARAM_TOL, "step_s": step_s,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_s, "peak_mem_gb": peak / 1e9,
          "roofline": beside(mean_s, terms), **counted, "want_launches": want,
          "device": torch.cuda.get_device_name(0), "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"steps: train step {losses} vs {direct}, {param_rel}, {counted}")
    by_path["flash_attention"]["steps train"] = counted["launches"]["flash_attention"]
    by_path["flash_attention_bwd"]["steps train"] = counted["launches"]["flash_attention_bwd"]
    del model, opt, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()

    # serve: prefill and decode steps against generate, phi4 then mamba2's prefill
    for arch, with_decode in ((TRAIN_ARCH, True), ("mamba2-1.3b", False)):
        cfg = get_config(arch)
        model = init_params(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                               device=dev)
        want = generate(model, tokens, STEPS_DECODE)
        pshape = InputShape(f"prefill_{SERVE_BATCH}x{SERVE_PROMPT}", SERVE_PROMPT + STEPS_DECODE + 1,
                            SERVE_BATCH, "prefill")
        prefill, _ = make_prefill_step(cfg, mesh, pshape)
        logits, caches, clen = prefill(model, tokens)
        err = float((logits.float() - want.prefill_logits.float()).abs().max())
        ok = bool(torch.allclose(logits.float(), want.prefill_logits.float(), **tol))
        ids = [torch.argmax(logits[:, -1:], dim=-1)]
        decode_s = None
        if with_decode:
            dshape = InputShape(f"decode_{SERVE_BATCH}x{SERVE_PROMPT}", SERVE_PROMPT,
                                SERVE_BATCH, "decode")
            decode, _ = make_decode_step(cfg, mesh, dshape)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS_DECODE):
                out, caches, clen = decode(model, ids[-1], caches, clen)
                ids.append(torch.argmax(out, dim=-1))
            torch.cuda.synchronize()
            decode_s = (time.perf_counter() - t0) / STEPS_DECODE
            ok = ok and torch.equal(torch.cat(ids, dim=1), want.ids)
        del caches, logits
        zero_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        prefill_s = []
        for _ in range(STEPS_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, clen = prefill(model, tokens)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            del logits, caches
        counted = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        want_launches = {k: v * STEPS_REPS for k, v in expected_launches(cfg).items()}
        ssm = want_launches["ssd_scan"]
        ok = (ok and counted["launches"] == want_launches
              and counted["routes"]["flash_attention"]["simt"] == 0
              and counted["routes"]["ssd_scan"]["simt"] == 0)
        best = min(prefill_s)
        record = {"phase": "steps", "step": "make_prefill_step" + (
                      " + make_decode_step" if with_decode else ""),
                  "arch": cfg.name, "mesh": "1x1", "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
                  "max_abs_err_vs_generate": err, "tol": tol,
                  "prefill_equal_bits": err == 0.0, "prefill_s": prefill_s,
                  "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / best,
                  "prefill_roofline": beside(best, dry_terms(arch, cfg, "prefill", SERVE_BATCH,
                                                             SERVE_PROMPT)),
                  "peak_mem_gb": peak / 1e9, **counted, "want_launches": want_launches,
                  "device": torch.cuda.get_device_name(0), "smi": smi, "ok": ok}
        if with_decode:
            record.update(decode_s_per_token=decode_s, decode_tokens_per_s=SERVE_BATCH / decode_s,
                          decode_roofline=beside(decode_s, dry_terms(arch, cfg, "decode",
                                                                     SERVE_BATCH, SERVE_PROMPT)))
        emit(record)
        if not ok:
            raise AssertionError(f"steps: {arch} prefill/decode: err {err}, {counted}")
        if want_launches["flash_attention"]:
            by_path["flash_attention"][f"steps {arch} prefill"] = counted["launches"]["flash_attention"]
        if ssm:
            by_path["ssd_scan"][f"steps {arch} prefill"] = counted["launches"]["ssd_scan"]
        del model, prefill, want
        gc.collect()
        torch.cuda.empty_cache()
    return {k: v for k, v in by_path.items() if v}


def dryrun_phase(smi: str) -> None:
    """``run_one`` for every config at the 16×16 mesh and ``prefill_32k``,
    on the meta device over a fake process group: ok or failed (a failure is
    a record, as the reference keeps it), the bottleneck and the seconds."""
    from repro_torch.configs import ALIASES
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.mesh import release
    t0 = time.perf_counter()
    recs = [run_one(arch, "prefill_32k", "single", save=False, verbose=False)
            for arch in sorted(ALIASES)]
    release()
    emit({"phase": "dryrun", "mesh": "single", "shape": "prefill_32k",
          "records": [{k: r.get(k) for k in ("arch", "ok", "bottleneck", "t_compute", "t_memory",
                                             "t_collective", "seconds", "error")} for r in recs],
          "ok_count": sum(r["ok"] for r in recs), "failed": sum(not r["ok"] for r in recs),
          "seconds": time.perf_counter() - t0, "smi": smi})


def lanes_phase(smi: str) -> dict:
    """The per-card figures ``gpu_lanes`` and ``LaneRooflineBackend`` are fit
    from: a bf16 cuBLAS product's rate at each of ``LANE_GEMM_SIZES`` (and
    the backend's efficiency ramp fit to them over the datasheet peak), a
    device-to-device copy's bandwidth (read + write), an empty kernel's
    launch (``torch.cuda._sleep(0)``) back to back on the host clock, and
    one CUDA graph of that kernel replayed likewise; each the best of 5."""
    import torch
    from repro_torch.core import processors
    from repro_torch.core.profiler import fit_efficiency_ramp
    dev = torch.device("cuda")
    rates = []
    for n in LANE_GEMM_SIZES:
        a, b = (torch.randn((n, n), device=dev, dtype=torch.bfloat16) for _ in range(2))
        iters = max(3, int(2e11 // (2 * n ** 3)))
        ms = min(cuda_ms(lambda: a @ b, iters) for _ in range(5))
        rates.append((2.0 * n ** 3, 2.0 * n ** 3 / (ms / 1e3)))
        del a, b
    src = torch.empty(LANE_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = min(cuda_ms(lambda: dst.copy_(src), 20) for _ in range(5))
    copy_bw = 2 * LANE_COPY_BYTES / (ms / 1e3)
    del src, dst

    def host_per_launch(fn):
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LANE_LAUNCHES):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / LANE_LAUNCHES)
        return best
    launch = host_per_launch(lambda: torch.cuda._sleep(0))
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(0)
        with torch.cuda.graph(graph, stream=stream):
            torch.cuda._sleep(0)
    graph_launch = host_per_launch(graph.replay)
    ramp = fit_efficiency_ramp(rates, processors.H100_PEAK_FLOPS_BF16)
    measured = {"gemm_rates": rates, "copy_bw": copy_bw, "launch_s": launch,
                "graph_launch_s": graph_launch,
                "ramp_min_work_scale_floor": ramp}
    in_code = {"gemm_rates": list(processors.H100_GEMM_RATES), "copy_bw": processors.H100_COPY_BW,
               "launch_s": processors.H100_LAUNCH_OVERHEAD,
               "graph_launch_s": processors.H100_GRAPH_LAUNCH_OVERHEAD,
               "ramp_min_work_scale_floor": (processors.H100_MIN_WORK_PER_CARD,
                                             processors.H100_EFF_SCALE,
                                             processors.H100_EFF_FLOOR)}
    emit({"phase": "lanes", "measured": measured, "in_code": in_code,
          "nvlink_bw_datasheet": processors.H100_NVLINK_BW,
          "device": torch.cuda.get_device_name(0), "smi": smi})
    return measured


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES
    from repro_torch.launch.roofline import (H100_HBM_BW, H100_PEAK_FLOPS_BF16,
                                             H100_PEAK_FLOPS_F32)
    PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = (H100_PEAK_FLOPS_BF16, H100_PEAK_FLOPS_F32,
                                                   H100_HBM_BW)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (ROUTES, _route, flash_attention,
                                                     flash_attention_bwd, flash_attention_plain)
    from repro_torch.kernels.batchsim_advance import batchsim_advance
    from repro_torch.kernels.int8_quant import quantize_int8
    from repro_torch.kernels.ssd_scan import ROUTES as SSD_ROUTES
    from repro_torch.kernels.ssd_scan import _route as ssd_route
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

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
    logs = build.build(["flash_attention", "flash_attention_sm90", "flash_attention_bwd",
                        "flash_attention_bwd_sm90", "ssd_scan", "ssd_scan_sm90", "int8_quant", "int8_quant_sm90",
                        "batchsim_advance"])
    regs = sorted({line.split("Used ")[1].split(",")[0]
                   for log in logs.values() for line in log.splitlines() if "Used " in line})
    spills = {name: [sum(int(w) for w in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
                     for line in log.splitlines() if "bytes spill" in line]
              for name, log in logs.items()}
    # ptxas warnings, e.g. C7515: a wgmma serialized
    warnings = {name: [line.strip() for line in log.splitlines() if "warning" in line.lower()]
                for name, log in logs.items()}
    b1_ptxas = ptxas_by_function(logs.get("batchsim_advance", ""))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(logs),
          "registers": regs, "spill_bytes_per_kernel": spills,
          "ptxas_warnings": {name: w for name, w in warnings.items() if w},
          "batchsim_advance_ptxas": b1_ptxas})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timings = {}
    counters = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
                "int8_quant": quantize_int8, "batchsim_advance": batchsim_advance,
                "flash_attention_bwd": flash_attention_bwd}

    # 3. kernel against plain --------------------------------------------------
    timed = {}
    for dtype, shape, causal, window, q_offset in CHECKS:
        bh, sq, sk, hd, g = shape
        tdt = getattr(torch, dtype)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(tdt)
                   for s in ((bh, sq, hd), (bh // g, sk, hd), (bh // g, sk, hd)))
        kw = dict(q_heads_per_kv=g, causal=causal, window=window, q_offset=q_offset)
        route = _route(tdt, hd)
        before = dict(flash_attention.launches_by_route)
        got = flash_attention(q, k, v, **kw).float()
        took = {r: flash_attention.launches_by_route[r] - before[r] for r in ROUTES}
        want = flash_attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL[dtype]
        ok = (bool(torch.allclose(got, want, **tol))
              and took == {r: int(r == route) for r in ROUTES})
        emit({"phase": "kernel_check", "kernel": "flash_attention", "route": route,
              "dtype": dtype, "shape": shape, "causal": causal, "window": window,
              "q_offset": q_offset, "max_abs_err": err, "tol": tol, "launches": took, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention differs from its plain version: {err}")
        if (dtype, shape, causal, window, q_offset) in (SERVING, KIMI, *SERVED_K2.values()):
            timed[shape] = (err, (q, k, v, kw))
        del got, want

    # qwen3-14b's serving shape (batch 4), kimi-k2's hd 112 at batch 1, then
    # the shapes of the other served models (batch 4)
    serving_err, serving_inputs = timed.pop(SERVING[1])
    timings["flash_attention"] = dict(max_abs_err=serving_err, **time_attention(
        SERVING, serving_inputs, SERVE_BATCH, smi, "qwen3-14b"))
    time_attention(KIMI, timed.pop(KIMI[1])[1], 1, smi, "kimi-k2-1t-a32b, batch 1")
    served_ms = {}
    for path, case in SERVED_K2.items():
        err, inputs = timed.pop(case[1])
        t = time_attention(case, inputs, SERVE_BATCH, smi, path)
        served_ms[path] = dict(shape=case[1], causal=case[2], max_abs_err=err, **{
            k: t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
    timings["flash_attention"]["served_shapes"] = served_ms
    del q, k, v, serving_inputs, inputs

    for dtype, shape in SSD_CHECKS:
        args, kw = ssd_inputs(dtype, shape, gen)
        bh, s, p, n, chunk = shape[:5]
        route = ssd_route(getattr(torch, dtype), p, n, chunk)
        before = dict(ssd_scan.launches_by_route)
        y, st = ssd_scan(*args, **kw)
        took = {r: ssd_scan.launches_by_route[r] - before[r] for r in SSD_ROUTES}
        want_y, want_st = ssd_scan_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(float((y.float() - want_y.float()).abs().max()),
                  float((st - want_st).abs().max()))
        tol = SSD_TOL[dtype]
        ok = (bool(torch.allclose(y.float(), want_y.float(), **tol))
              and bool(torch.allclose(st, want_st, **tol))
              and took == {r: int(r == route) for r in SSD_ROUTES})
        emit({"phase": "kernel_check", "kernel": "ssd_scan", "route": route, "dtype": dtype,
              "shape": shape, "max_abs_err": err, "tol": tol, "launches": took, "ok": ok})
        if not ok:
            raise AssertionError(f"ssd_scan {route} differs from its plain version at {shape}: "
                                 f"{err}, launches {took}")
        if (dtype, shape) in (SSD_SERVING, SSD_JAMBA):
            timed[shape] = (err, (args, kw))
        del y, st, want_y, want_st
    # mamba2-1.3b's serving shape, then jamba's
    serving_err, serving_inputs = timed.pop(SSD_SERVING[1])
    timings["ssd_scan"] = dict(max_abs_err=serving_err,
                               **time_ssd(SSD_SERVING, *serving_inputs, smi, "mamba2-1.3b"))
    err, inputs = timed.pop(SSD_JAMBA[1])
    t = time_ssd(SSD_JAMBA, *inputs, smi, "jamba-1.5-large-398b")
    timings["ssd_scan"]["served_shapes"] = {"jamba-1.5-large-398b": dict(
        shape=SSD_JAMBA[1], max_abs_err=err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")})}
    del serving_inputs, inputs
    timings["int8_quant"] = check_int8_quant(gen, smi)
    timings["flash_attention_bwd"] = check_attention_bwd(gen, smi)
    timings["flash_attention"]["train_shapes"] = timings["flash_attention_bwd"].pop("forward")

    # 4. each served model: kernel-vs-plain check, serve, profile --------------
    by_path = {"flash_attention": {}, "ssd_scan": {}}
    for arch, check_cut, serve_cut in SERVED_MODELS:
        for kernel, n in serve_model(arch, check_cut, serve_cut, gen, smi, counters).items():
            if n:
                by_path[kernel][arch] = n

    # 4b. training: phi4-mini-3.8b at full width, then the demo's checkpoint
    t0 = time.perf_counter()
    train_check(counters)
    trained = train_phase(smi, counters)
    ckpt = train_ckpt_phase(smi, counters)
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0})
    by_path["flash_attention"]["phi4-mini-3.8b train"] = trained["flash_attention"]
    by_path["flash_attention"]["demo-100m train"] = ckpt["flash_attention"]
    by_path["flash_attention_bwd"] = {"phi4-mini-3.8b train": trained["flash_attention_bwd"],
                                      "demo-100m train": ckpt["flash_attention_bwd"]}

    # 4c. the mesh steps on the card's 1×1 mesh, the dry run, the lane figures
    t0 = time.perf_counter()
    for kernel, paths in steps_phase(smi, counters).items():
        by_path[kernel].update(paths)
    dryrun_phase(smi)
    lanes_phase(smi)
    emit({"phase": "steps_dryrun_lanes_done", "seconds": time.perf_counter() - t0})
    launches = {k: sum(v.values()) for k, v in by_path.items()}

    # 5. Puzzle's runtime -----------------------------------------------------
    k1_runtime, k1_runtime_routes = runtime_phase(smi, counters)

    # 6. Puzzle's scheduler: search with the card in the loop, then serve ------
    t0 = time.perf_counter()
    k1_search, k1_search_routes, searched = search_phase(smi, counters)
    emit({"phase": "search_done", "seconds": time.perf_counter() - t0})

    # 7. the searched schedules replayed exactly, then run on the card ---------
    t0 = time.perf_counter()
    k1_conf, k1_conf_routes, k1_staged_err = conformance_phase(smi, counters, **searched)
    emit({"phase": "conformance_done", "seconds": time.perf_counter() - t0})

    # 8. the paper's sweep, the batch engine on the card ------------------------
    t0 = time.perf_counter()
    timings["batchsim_advance"] = sweep_phase(smi, counters, b1_ptxas)
    emit({"phase": "sweep_done", "seconds": time.perf_counter() - t0})

    # 9. the paper's evaluation harness and the card examples -----------------
    t0 = time.perf_counter()
    paper = paper_phase(smi, counters)
    emit({"phase": "paper_done", "seconds": time.perf_counter() - t0})
    for kernel in ("flash_attention", "ssd_scan"):
        by_path[kernel]["paper"] = paper["launches"][kernel]
        launches[kernel] += paper["launches"][kernel]
    k1_paper = paper["launches"]["int8_quant"]
    b1_sweep = timings["batchsim_advance"]["launches"]
    timings["batchsim_advance"]["launches"] = b1_sweep + paper["launches"]["batchsim_advance"]
    timings["batchsim_advance"]["launches_by_path"] = {
        "sweep": b1_sweep, "paper": paper["launches"]["batchsim_advance"]}
    launches["int8_quant"] = k1_runtime + k1_search + k1_conf + k1_paper
    k1_routes = {r: k1_runtime_routes[r] + k1_search_routes[r] + k1_conf_routes[r]
                 + paper["k1_routes"][r] for r in k1_runtime_routes}
    timings["int8_quant"]["max_abs_err"] = max(timings["int8_quant"]["max_abs_err"],
                                               k1_staged_err)

    emit({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:91",
         "launches": launches["flash_attention"],
         "launches_by_path": by_path["flash_attention"], **timings["flash_attention"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_sm90.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:87",
         "launches": launches["ssd_scan"], "launches_by_path": by_path["ssd_scan"],
         **timings["ssd_scan"]},
        {"name": "int8_quant", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/int8_quant_sm90.cu",
         "replaces": "src/repro/kernels/int8_quant.py:29",
         "launches": launches["int8_quant"], "launches_by_route": k1_routes,
         "launches_by_path": {"runtime": k1_runtime, "search": k1_search,
                              "conformance": k1_conf, "paper": k1_paper},
         **timings["int8_quant"]},
        {"name": "batchsim_advance", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/batchsim_advance.cu",
         "replaces": "src/repro/core/batchsim_compiled.py:117",
         **timings["batchsim_advance"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
         "sources_by_route": {
             "sm90": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
             "simt": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"},
         "replaces": "src/repro/models/attention.py:58",
         "launches": launches["flash_attention_bwd"],
         "launches_by_route": {"sm90": by_path["flash_attention_bwd"]["phi4-mini-3.8b train"]
                               + by_path["flash_attention_bwd"]["steps train"],
                               "simt": by_path["flash_attention_bwd"]["demo-100m train"]},
         "launches_by_path": by_path["flash_attention_bwd"],
         **timings["flash_attention_bwd"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
