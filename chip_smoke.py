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
   the plain version); K3's backward (``ssd_scan_bwd``: bf16 of a shape the
   ``sm90`` forward takes on the ``sm90`` route, wgmma + TMA, the chunks in
   parallel; f32 and the other bf16 shapes on ``simt``, CUDA cores) at
   mamba2-1.3b's training shape in bf16 and f32, jamba-1.5-large's in bf16
   and the edge cases of ``SSD_BWD_CHECKS`` in both, the model's A with dt
   doubled (the masked half overflows), against ``ssd_scan_bwd_plain`` (and
   at the two training shapes against autograd through ``ssd_scan_plain``),
   then timed at those two shapes in turns with the ``simt`` kernel at bf16
   (``_ssd_scan_bwd_simt``) and the plain version; AdamW's update (B3,
   ``adamw_update``) against ``adamw_update_plain`` bit for bit for p, m and
   v at steps 1-3: bf16 and f32 parameters at sizes that are not whole
   vectors, an empty tensor, more tensors than one launch takes, tensors
   off 16-byte alignment, g from 1e-30 to 1e4 with zeros; then timed on
   phi4-mini-3.8b's parameter list in turns with the plain update and
   ``torch._fused_adamw_`` (m and v in bf16: a yardstick, never on the
   path), beside the bound by bytes and the TB/s reached; the MoE layer's
   dispatch and combine (B2, ``moe_fill`` and ``moe_combine``, over one
   route table) against ``moe_fill_plain`` and ``moe_combine_plain``, bits
   equal, one launch each on the route the width gives (``B2_CASES``:
   the prefill shapes of olmoe-1b-7b,
   kimi-k2 and jamba-1.5-large at 4 x 1024 tokens, olmoe's decode at 4
   tokens and capacity 1, f32 rows over the f32 witness's buffer,
   capacity factor 0.5, an expert without tokens, and a width of 2050 on
   the ``scalar`` route, and olmoe's training batch, the prefill's shape),
   the fill also against ``torch.index_select`` over the rows with a zero
   row appended and the combine against ``F.embedding_bag``, both built
   from the same table; the first four timed in turns with the plain
   versions and the library calls, beside the bound by bytes, with each
   kernel's own device time and each call's host µs; B2's adjoints
   (``moe_fill_bwd``, ``moe_combine_bwd``) at every case of ``B2_CASES``
   against ``moe_fill_bwd_plain`` and ``moe_combine_bwd_plain``: dx and
   dy bit for bit, dgate within ``b2_dgate_close``, one launch each on the
   route the width gives, the fill's adjoint also against
   ``F.embedding_bag``; timed at olmoe's training shape and the three
   prefill shapes (``B2_BWD_TIMED``) in turns with the plain versions and
   that library call (none computes the combine's adjoint); RMSNorm (B4:
   ``rms_norm_fwd``, ``gated_rms_norm_fwd`` and their adjoints) and
   Mamba2's causal convolution (B5: ``causal_conv1d_fwd`` and its adjoint)
   against their plain versions at the shapes the paths give them
   (``check_norm_conv``: the plain form at 128 over qwen3's 40 heads and at
   every trained and served d_model, the gated form at mamba2's and
   jamba's d_inner and mamba2's decode step with an f32 y, the convolution
   at mamba2's and jamba's channels over the projection's columns, with the
   cache's state at decode; f32 at the demo's and mamba2's shapes), one
   launch each on the ``vector`` route (B5's forward on ``staged``, its
   decode step on ``vector``): B5's forward and new state bit for bit, its
   SiLU equal to ``F.silu`` on every bf16 input (``silu_check``), B4's
   forward bit for bit on every row whose rstd equals the plain
   one (within an ulp elsewhere), the adjoints within ``norm_adj_tol``
   (and the bf16 control, ``narrow_adjoints``, beyond it);
   timed at mamba2-1.3b's training shape (and phi4-mini's plain form at
   3072, olmoe's q/k rows, B5's forward at jamba's shape and mamba2's
   decode step) in turns with the plain versions and, for the plain forward,
   ``F.rms_norm`` (a yardstick never on the path), beside the bound by
   bytes, with each kernel's own device time and each call's host µs; the
   training loss (B6: ``cross_entropy_fwd`` and its adjoint) and RoPE of q
   and k (B7: ``rope_qk_fwd`` and its adjoint) against their plain versions
   (``check_loss_rope``: the loss at phi4-mini's, mamba2's, olmoe's, the
   demo's and the smoke vocabularies and an odd width on the ``scalar``
   route, within ``LOSS_REL_TOL``, the logits' gradient within one ulp;
   RoPE at phi4's training shape, qwen3's prefill and decode step,
   kimi-k2's head_dim 112, whisper's encoder, the demo's f32, an unaligned
   layout and int32 positions, bit for bit or the differing count within
   one ulp), timed at the trained and served shapes in turns with the plain
   versions and, for the loss, ``F.cross_entropy`` (a yardstick never on
   the path); SwiGLU's gate (B8: ``swiglu_fwd`` and its adjoint) against
   ``F.silu(g) * u`` and the ops its autograd calls (``check_swiglu``: at
   phi4-mini's training MLP, olmoe's and kimi-k2's expert buffers, qwen3's
   prefill and decode step, the demo's f32 and an odd width on the
   ``scalar`` route, bit for bit; every bf16 g with eight gradients each in
   f32 and bf16, also against autograd, ``swiglu_sweep``), timed at the
   first five in turns with the plain versions (no one PyTorch call
   computes it); K2 and K3, forward and backward, in the model's (B, S, H,
   ·) layout (``check_layouts``: K2 at qwen3-14b's prefill, its backward at
   phi4-mini's training shape, K3 and its backward on mamba2's
   convolution views), bit for bit against the same kernels on flattened
   operands and against the parent's layout copies around them, all three
   timed in turns, the kernels' own device time apart;
4. models: for each of ``SERVED_MODELS`` (qwen3-14b, mamba2-1.3b,
   olmoe-1b-7b, kimi-k2 cut to one layer, jamba cut to the first three
   positions of its pattern, whisper-medium, llama-3.2-vision-11b), bf16,
   random weights from a seed (``serve_model``):
   - depth_check: the model at full width cut to one layer of each block
     kind, every ``attn_gate`` at 2.0, a random modality input; prefill
     logits through the kernels against the same model with the kernels'
     plain versions, B4's and B5's forwards included (``norm_conv_plain``)
     (olmoe-1b-7b and jamba: against an f32 witness of the same weights,
     ``witness_verdict``, with the witness's peak memory), and the launches
     the config gives;
   - serve: the served model serves 4 requests of 1024 prompt tokens + 32
     greedy tokens through ``repro_torch.launch.serve.generate``, with the
     reference's stub modality input; every kernel's launch count is
     zeroed just before and read just after: K2 and K3 launch as the config
     gives (``expected_launches``), all on the ``sm90`` route, B2's
     fill and combine once each in every MoE layer of the prefill and of
     every decode step, B4 once for every norm and B5 once in every Mamba2
     layer of the prefill and of every decode step (``norm_conv_counts``),
     all on the ``vector`` route; an MoE model's
     prefill, run twice more and once with B2's plain versions, equals the
     served one bit for bit (B4 and B5 on their kernels in every run: the
     check holds B2's bits); B7 once in every self-attention and encoder
     layer of the prefill and every self-attention layer of every decode
     step, on ``vector`` (``rope_counts``); B8 once in every MLP and MoE
     layer (and an encoder's) of the prefill and of every decode step, on
     ``vector`` (``swiglu_counts``);
   - profile (qwen3-14b, mamba2-1.3b, olmoe-1b-7b): a ``torch.profiler``
     pass over one prefill and 8 decode steps gives the device's busy
     share; olmoe's device time split into K2, the expert and router
     products, the MoE dispatch, the other products and the rest, the
     dispatch further into the router's softmax and top-k, the plan, B2's
     fill and combine kernels and the ops around them, and SiLU·up
     (``moe_profile``; SiLU·up B8's kernels launched inside
     ``expert_swiglu`` and any op there but its products), its prefill in
     turns with B2's plain versions;
   - moe_routes: olmoe-1b-7b at full width cut to two layers, 4 x 1024
     prompt tokens and 8 greedy tokens with B2's kernels, with their plain
     versions in their place and with the kernels again: logits and ids
     equal bit for bit;
   then training (``train_check``, ``adamw_route_check``, ``train_phase``,
   ``train_ckpt_phase``):
   - train_check: phi4-mini-3.8b at full width cut to one layer; the loss
     and every parameter's gradient through K2's forward and backward
     kernels against the plain forward differentiated by autograd, and the
     same limits rejecting a backward whose dQ and dK are zeroed; then
     mamba2-1.3b cut to one layer and jamba-1.5-large cut to one
     ``ssm_mlp`` layer (256 heads a group) likewise through K3's forward and
     backward kernels (``SsdScanFn``), the limits rejecting a backward whose
     dB and dC are zeroed; then olmoe-1b-7b cut to one layer through K2
     and B2's forward and adjoint kernels (``MoeFillFn``,
     ``MoeCombineFn``) against B2's plain forwards under autograd, the
     limits rejecting a combine adjoint whose dgate is zeroed (the
     router's gradient lost); then phi4-mini cut to one layer through B4's
     ``RmsNormFn`` against the plain norm under autograd, rejecting an
     adjoint whose scale gradient is zeroed, and mamba2-1.3b cut to one
     layer through ``RmsNormFn``, ``GatedRmsNormFn`` and B5's
     ``CausalConv1dFn`` against their plain forwards, rejecting a
     convolution adjoint whose dw is zeroed; then phi4-mini cut to one
     layer through B6's ``CrossEntropyFn`` and B7's ``RopeFn`` against the
     eager chains under autograd, rejecting a loss adjoint without its
     one-hot term and a RoPE adjoint that rotates by +angle; then
     phi4-mini and olmoe-1b-7b cut to one layer through B8's ``SwigluFn``
     against ``F.silu(g) * u`` under autograd, rejecting an adjoint whose
     SiLU derivative lacks its ``g·(1 − σ)`` term;
   - adamw_routes: phi4-mini-3.8b at full width cut to two layers, three
     steps from the same weights with B3, with ``adamw_update_plain`` in its
     place and with B3 again: every parameter and loss equal bit for bit
     (B4 on its kernels in all three runs: the check holds B3's bits);
   - train: phi4-mini-3.8b at full width and depth (32 layers, d 3072,
     vocab 200064), bf16, AdamW, remat on, batch 4 x 1024 tokens from
     ``MarkovDataset`` through ``repro_torch.train.train_step``: 2 warm-up
     steps, then 8 with every kernel's count zeroed just before and read
     just after (K2's forward 2 x 32 a step, all ``sm90``; its backward
     32, all ``sm90``; B4's forward 2 x 64 + 1 and its adjoint 65, all
     ``vector``; B6 and its adjoint once a step, B7 2 x 32 and its adjoint
     32, B8 2 x 32 and its adjoint 32, ``vector``; B3 once a step), the loss
     per step, step seconds, tokens/s, peak memory, and one more step under
     the profiler split into K2's forward and backward, K3's forward and
     backward, B4's to B8's
     forward and adjoint kernels, cuBLAS, the optimizer (B3's kernel by
     name and the ops under its range) and the rest, the rest also by op
     and input shapes (``rest_by_op``); then mamba2-1.3b at full width and
     depth (48 ssm layers, d 2048, vocab 50280) the same way with 6 counted steps (K3's forward 2 x 48 a
     step and its backward 48, all ``sm90``, K2 none); then olmoe-1b-7b at
     full width cut to 8 of its 16 layers (d 2048, 64 experts top-8,
     expert d_ff 1024, vocab 50304; AdamW's state is 83 GB at 16 layers)
     with 6 counted steps (K2's forward 2 x 8 a step and its backward 8,
     ``sm90``; B2's fill and combine 2 x 8 and each adjoint 8, ``vector``;
     B3 once a step), its profile with B2's forward and adjoint kernels
     apart;
   - train_ckpt: the f32 100M demo of ``examples/train_100m_torch.py``
     through ``repro_torch.train.train``, 60 steps with a checkpoint at 40,
     then resumed from it: the resumed first loss equals the uninterrupted
     run's at step 40 bit for bit, and the loss falls; K2's forward and
     backward all on the ``simt`` route;
   then the launch tools of ``repro_torch.launch`` (``steps_phase``,
   ``dryrun_phase``, ``moe_mesh_phase``, ``lanes_phase``):
   - steps: ``make_train_step``, ``make_prefill_step`` and
     ``make_decode_step`` on ``make_host_mesh()``, the card's 1×1 mesh:
     phi4-mini-3.8b at full width and depth (train 4 x 1024, bf16, AdamW,
     remat; prefill and 8 decode steps at batch 4 with 1024 prompt tokens)
     and mamba2-1.3b's train step (4 x 1024) and prefill, each held first to
     the direct path it wraps (``train_step``'s losses, ``generate``'s logits
     and ids), then timed with every kernel's count zeroed just before and
     read just after (K2 and K3 forward and backward, all on ``sm90``; phi4's
     decode steps B4's, B7's and B8's per-step launches), seconds, tokens/s and peak memory beside the dry run's three roofline terms for the same shape on
     the 1×1 mesh and the time's multiple of the largest;
   - dryrun: ``run_one`` of every config at the 16×16 mesh and
     ``prefill_32k`` and ``decode_32k`` on the meta device: all 20 ok, each
     with its bottleneck, terms, collective bytes by kind and seconds, an
     MoE config with its per-device FLOPs times the devices over the 1×1
     mesh's;
   - moe_mesh: the MoE layer's mesh path at olmoe-1b-7b's full width in
     bf16 (64 experts top-8, 4 x 1024 tokens, random weights from seed 0):
     ``moe_device_body`` for each rank of a 2x2 layout in turn, the
     collectives' results formed in the process, against ``moe_ffn`` on the
     whole batch (the kept assignments and slots equal, the output within
     the bf16 ``TOL`` of the largest), B2's fill and combine once each in
     every rank's body and in ``moe_ffn``; then the context-parallel decode
     softmax (``decode_device_body``) at phi4-mini-3.8b's decode, batch 4,
     a 1024-slot cache in 16 pieces, against ``decode_attention`` on the
     whole cache in bf16 and f32; no other kernel launches;
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
models, the two training runs, the mesh steps and ``paper``; B4's and
B5's over the served models, the training runs and the mesh steps,
``launches_by_path`` one count per path, K1's and B1's with a ``paper``
entry too; K2's backward with its launches in the two training runs, both sources and
its launches by route; K3's backward with its launches in mamba2's training
run and mesh step; B3's with its launches in the three training runs and
the two mesh train steps; B2's fill and combine with their launches in
the MoE serve runs, olmoe's training run and the ``moe_mesh`` phase, and
B2's two adjoints with theirs in olmoe's training run; B6's, B7's and
B8's with theirs in the served models, the training runs and the mesh
steps),
the ``nvidia-smi`` line,
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
# depth_check's f32 witness (``witness_verdict``). Over 8 token draws
# (examples/depth_margin_torch.py on the H100) olmoe's bf16 kernels lay
# 1.27-1.70% of the largest logit from the bf16 plain prefill, each bf16
# path 1.50-2.46% from the f32 prefill of the same weights, the f32 kernels
# within 3.8e-6 of f32 plain; jamba's kernels-against-plain ran 1.14-2.24%:
# the 2% limit of kernels against plain sits inside bf16's own spread. So
# these MoE models are held to the f32 witness instead (``witness_model``:
# every tensor but the experts' copied to f32, each expert cast to f32 only
# while its products run, so jamba's 43.9 GB cut fits beside it): their f32
# kernels (K2 and K3 on ``simt``) to the f32 plain prefill within
# WITNESS_F32_TOL of the largest logit (26x olmoe's measured 3.8e-6), and
# their bf16 kernels no further from the witness than the bf16 plain
# prefill lies, plus WITNESS_MARGIN (olmoe's kernels' excess over plain ran
# -3.9e-3 .. +2.8e-3 over the 8 draws). The bf16 kernels-against-plain
# distance is reported beside the 2% limit. kimi-k2 keeps the 2% check: its
# 8 draws stayed under it (1.36-1.58% with K2 and B2 swapped; 1.43-1.68%
# with B4 and B5 swapped too, examples/depth_margin_torch.py on the H100),
# and this check's own draw reads 1.92%.
WITNESSED = ("olmoe-1b-7b", "jamba-1.5-large-398b")
WITNESS_F32_TOL = 1e-4
WITNESS_MARGIN = 5e-3
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
# K3's backward, (dtype, (bh, s, p, n, chunk, heads_per_group, initial state
# and final-state gradient)): mamba2-1.3b's training shape (batch 4 x 64 heads
# of one group) in bf16 and f32, jamba-1.5-large's (256 heads a group) in
# bf16, then chunk 1, chunk 100 with a state in and out (one head a group),
# S == chunk, P 96 and P 100 with N 24 (two P-tiles, one ragged), a state
# in and out at 4 heads a group, and 16 chunks of 64 with a state, each in
# f32 and bf16; the model's A and dt
# doubled (ssd_bwd_inputs). Tolerance: BWD_TOL of the largest gradient, as K2's
SSD_BWD_MAMBA2 = ("bfloat16", (256, 1024, 64, 128, 128, 64, False))
SSD_BWD_JAMBA = ("bfloat16", (1024, 1024, 64, 128, 128, 256, False))
SSD_BWD_CHECKS = [SSD_BWD_MAMBA2, ("float32", SSD_BWD_MAMBA2[1]), SSD_BWD_JAMBA] + [
    (dt, s) for dt in ("float32", "bfloat16") for s in (
        (8, 64, 64, 32, 1, 4, False), (4, 200, 64, 128, 100, 1, True),
        (4, 128, 64, 128, 128, 1, False), (8, 256, 96, 24, 128, 4, True),
        (8, 256, 100, 24, 128, 4, False), (8, 256, 64, 128, 128, 4, True),
        (4, 1024, 64, 128, 64, 2, True))]
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# train: phi4-mini-3.8b at full width and depth, bf16, AdamW, remat on; warm-up
# steps, then the counted and timed steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = "phi4-mini-3.8b", 4, 1024, 2, 8
TRAIN_LR = 1e-3            # the launcher's default (repro_torch.launch.train)
# mamba2-1.3b at full width and depth (48 ssm layers), the same batch, after phi4
SSM_TRAIN_ARCH, SSM_TRAIN_STEPS = "mamba2-1.3b", 6
# olmoe-1b-7b at full width cut to 8 of its 16 layers, the same batch, after
# mamba2: AdamW's 12 bytes a parameter come to 83.0 GB at 16 layers and 42.8
# GB at 8, which leaves the card room for remat's activations
MOE_TRAIN_ARCH, MOE_TRAIN_STEPS, MOE_TRAIN_CUT = "olmoe-1b-7b", 6, {"num_layers": 8}
# train_check: (arch, its cut, the kernels swapped) at full width: phi4-mini
# one layer through K2; mamba2 one layer and jamba one ssm_mlp layer (256
# heads a group through the model; no optimizer) through K3. The loss through
# the kernels within TRAIN_LOSS_TOL of the plain path's (relative), every
# parameter's gradient within TRAIN_GRAD_TOL of the plain one's norm (bf16
# rounding gives well under 1%; a lost dQ or dK gives 100% on wq or wk)
TRAIN_CHECKS = (("phi4-mini-3.8b", {"num_layers": 1}, "attention"),
                ("mamba2-1.3b", {"num_layers": 1}, "ssd"),
                ("jamba-1.5-large-398b", {"layout_pattern": ("ssm_mlp",), "num_layers": 1}, "ssd"),
                ("olmoe-1b-7b", {"num_layers": 1}, "moe"),
                ("phi4-mini-3.8b", {"num_layers": 1}, "norm"),
                ("mamba2-1.3b", {"num_layers": 1}, "norm_conv"),
                ("phi4-mini-3.8b", {"num_layers": 1}, "loss_rope"),
                ("phi4-mini-3.8b", {"num_layers": 1}, "swiglu"),
                ("olmoe-1b-7b", {"num_layers": 1}, "swiglu"))
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
# K3's forward on either route, then its backward's: the simt route's two
# passes, the sm90 route's five
SSD_FWD_KERNELS = ("ssd_scan_sm90_kernel", "ssd_scan_kernel")
SSD_BWD_KERNELS = ("ssd_scan_bwd_kernel", "ssd_scan_bwd_sum_kernel", "ssd_bwd_terms_sm90_kernel",
                   "ssd_bwd_states_sm90_kernel", "ssd_bwd_dx_sm90_kernel",
                   "ssd_bwd_dbc_sm90_kernel", "ssd_bwd_sum_sm90_kernel")
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel", *SSD_FWD_KERNELS,
                "quant_rows_sm90_kernel", "quant_rows_kernel", "adamw_kernel") + BWD_KERNELS \
    + SSD_BWD_KERNELS


def named(name: str, key: str) -> bool:
    """Whether a profiler key is the kernel ``name`` (a template or not)."""
    return name + "<" in key or name + "(" in key


PROFILE_PAUSE_S = 0.005
INCOMPLETE_PROFILES = []     # each short profile that missed launches, and each fallback


@contextlib.contextmanager
def profiled(*activities, **kw):
    """``torch.profiler.profile`` over ``activities`` whose window opens and
    closes on an idle device, with a pause of ``PROFILE_PAUSE_S`` inside
    each end. The profiler drops launches of short windows without a word: of 40
    windows of 5 calls of B7's forward, 2 recorded some and 1 none without
    the pauses, all 80 every launch with pauses of 2 or 20 ms
    (``examples/profiler_window_probe_torch.py``, a fresh process); later in
    a long process it drops more (see ``kernel_split``)."""
    import torch
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=list(activities), **kw) as prof:
        time.sleep(PROFILE_PAUSE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)


def device_profile(fn) -> dict:
    """Kernel time on the device (``torch.profiler``) against the host clock
    for one call of ``fn``, with the port's own kernels apart; the
    profiler's own host cost inflates the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
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
            if named(k, e.key):
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
    from torch.profiler import ProfilerActivity
    with profiled(ProfilerActivity.CUDA) as prof:
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


def in_turns(*fns, iters, rounds: int = 3, warmup: int = 1):
    """Device ms per call of each function, timed in turns (each in order,
    then back: first, second, second, first for two) ``rounds`` times:
    every time of each. ``iters``, the calls a timing: one number, or one
    per function."""
    its = list(iters) if isinstance(iters, (list, tuple)) else [iters] * len(fns)
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(rounds):
        for i in order + order[::-1]:
            times[i].append(cuda_ms(fns[i], iters=its[i], warmup=warmup))
    return times


def timed_in_turns(contenders: dict, iters: dict, split: dict, host_calls: int) -> dict:
    """A kernel's call against its contenders (``kernel``, ``plain`` and,
    where there is one, ``library``): CUDA-event ms of each in turns
    (``in_turns``, one round, ``iters[who]`` calls a timing), the least of
    each; the kernel's own device time (``kernel_split`` over ``split``,
    summed) and each call's host µs (``host_ms_per_call``, the least of two
    turns: the launch enqueued, nothing synchronised)."""
    import torch
    names = list(contenders)
    turns = dict(zip(names, in_turns(*contenders.values(), iters=[iters[w] for w in names],
                                     rounds=1, warmup=2)))
    host = {who: [] for who in names}
    for who in names + names[::-1]:
        host[who].append(host_ms_per_call(contenders[who], calls=host_calls) * 1e3)
        torch.cuda.synchronize()
    return {"ms": min(turns["kernel"]), "plain_ms": min(turns["plain"]),
            "library_ms": min(turns["library"]) if "library" in turns else None,
            "kernel_device_ms": sum(kernel_split(contenders["kernel"], split, calls=5).values()),
            "turns_ms": turns, "host_us": {who: min(v) for who, v in host.items()}}


def bits(t):
    """A bf16 or f32 tensor's bits, to compare two tensors bit for bit."""
    import torch
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def rel_norm(a, b) -> float:
    """The norm of a - b over b's, in f32."""
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


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


def norm_conv_counts(cfg) -> dict:
    """B4's and B5's forward calls in one pass of the model, from the config:
    ``layers`` the prefill's plain RMSNorms inside the layers (ln1, ln2
    where the block has an FFN, the q and k norms of a self- or
    cross-attention with ``qk_norm``, an encoder-decoder's ``ln_cross``),
    ``outside`` those outside them (the final norm; an encoder-decoder's
    encoder layers and its final norm), ``decode`` a decode step's (its
    layers' ln1, ln2, ``ln_cross``, self-attention q and k norms, a cross
    layer's q norm, and the final norm), ``ssm`` the Mamba2 layers: one
    gated norm and one convolution each, in a prefill and in a decode
    step."""
    from repro_torch.models.config import ATTN, CROSS
    from repro_torch.models.transformer import (_kind_ffn, _kind_has_self_attn, _kind_has_ssm,
                                                layer_kinds)
    qk = int(cfg.qk_norm)
    layers = decode = 0
    for kind in layer_kinds(cfg):
        base = 1 + (_kind_ffn(kind, cfg) != "none")
        base += int(cfg.is_encoder_decoder and _kind_has_self_attn(kind))
        self_attn = _kind_has_self_attn(kind)
        layers += base + 2 * qk * (self_attn or kind == CROSS)
        decode += base + 2 * qk * self_attn + qk * (kind == CROSS)
    outside = 1
    if cfg.is_encoder_decoder:
        outside += cfg.encoder_layers * (1 + (_kind_ffn(ATTN, cfg) != "none") + 2 * qk) + 1
    return {"layers": layers, "outside": outside, "decode": decode + 1,
            "ssm": sum(_kind_has_ssm(k) for k in layer_kinds(cfg))}


def rope_counts(cfg) -> dict:
    """B7's calls (q and k in one) from the config: ``layers`` a prefill's
    self-attention layers (``attn``, ``attn_moe``; a ``cross`` layer
    applies no RoPE), ``outside`` an encoder-decoder's encoder layers
    (outside the decoder's remat'd repetitions in training), ``decode`` a
    decode step's (its self-attention layers)."""
    from repro_torch.models.transformer import _kind_has_self_attn, layer_kinds
    self_attn = sum(_kind_has_self_attn(k) for k in layer_kinds(cfg))
    return {"layers": self_attn, "outside": cfg.encoder_layers if cfg.is_encoder_decoder else 0,
            "decode": self_attn}


def swiglu_counts(cfg) -> dict:
    """B8's calls from the config: ``layers`` a prefill's layers with an
    MLP or an MoE FFN (``expert_swiglu`` once a MoE layer, its weights in
    the buffer's dtype), ``outside`` an encoder-decoder's encoder layers
    with one, ``decode`` a decode step's (the same layers as a prefill's)."""
    from repro_torch.models.config import ATTN
    from repro_torch.models.transformer import _kind_ffn, layer_kinds
    ffn = sum(_kind_ffn(k, cfg) != "none" for k in layer_kinds(cfg))
    outside = cfg.encoder_layers * (_kind_ffn(ATTN, cfg) != "none") if cfg.is_encoder_decoder \
        else 0
    return {"layers": ffn, "outside": outside, "decode": ffn}


def expected_launches(cfg, decode_steps: int = 0) -> dict:
    """Kernel launches of one prefill and ``decode_steps`` decode steps, from
    the config: K2 once in every self-attention, cross-attention and
    encoder layer, K3 once in every Mamba2 layer, both in the prefill only;
    B2's fill and combine once each in every MoE layer (``attn_moe``,
    ``ssm_moe``) of the prefill and of every decode step; B4's plain form
    once for every RMSNorm and its gated form and B5 once in every Mamba2
    layer, in the prefill and in every decode step (``norm_conv_counts``);
    B7 once in every self-attention and encoder layer of the prefill and in
    every self-attention layer of every decode step (``rope_counts``); B8
    once in every MLP and MoE layer and encoder layer of the prefill and in
    every MLP and MoE layer of every decode step (``swiglu_counts``); the
    loss (B6) never."""
    from repro_torch.models.config import ATTN, ATTN_MOE, CROSS, SSM_MOE
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    self_attn = sum(k in (ATTN, ATTN_MOE) for k in kinds)
    k2 = self_attn + sum(k == CROSS for k in kinds)
    if cfg.is_encoder_decoder:
        k2 += self_attn + cfg.encoder_layers         # cross-attention, then the encoder
    b2 = sum(k in (ATTN_MOE, SSM_MOE) for k in kinds) * (1 + decode_steps)
    nc = norm_conv_counts(cfg)
    rc = rope_counts(cfg)
    sc = swiglu_counts(cfg)
    ssm = nc["ssm"] * (1 + decode_steps)
    return {"flash_attention": k2, "ssd_scan": sum(k.startswith("ssm") for k in kinds),
            "int8_quant": 0, "batchsim_advance": 0, "flash_attention_bwd": 0, "ssd_scan_bwd": 0,
            "adamw": 0, "moe_fill": b2, "moe_combine": b2, "moe_fill_bwd": 0,
            "moe_combine_bwd": 0,
            "rms_norm_fwd": nc["layers"] + nc["outside"] + nc["decode"] * decode_steps,
            "gated_rms_norm_fwd": ssm, "causal_conv1d_fwd": ssm, "rms_norm_bwd": 0,
            "gated_rms_norm_bwd": 0, "causal_conv1d_bwd": 0, "cross_entropy_fwd": 0,
            "cross_entropy_bwd": 0,
            "rope_qk_fwd": rc["layers"] + rc["outside"] + rc["decode"] * decode_steps,
            "rope_qk_bwd": 0,
            "swiglu_fwd": sc["layers"] + sc["outside"] + sc["decode"] * decode_steps,
            "swiglu_bwd": 0}


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
MOE_RANGES = ("moe_ffn", "moe_experts", "moe_router", "moe_plan", "moe_fill", "moe_combine")
B2 = ("moe_fill", "moe_combine")
B2_KERNELS = {"moe_fill": ("moe_fill_kernel",), "moe_combine": ("moe_combine_kernel",)}
# B2's adjoints: the wrappers' names and their kernels'
B2_BWD = ("moe_fill_bwd", "moe_combine_bwd")
B2_BWD_KERNELS = {"moe_fill_bwd": "moe_fill_bwd_kernel", "moe_combine_bwd": "moe_combine_bwd_kernel"}
# B4 (RMSNorm, plain and gated) and B5 (the causal convolution): the
# wrappers' names, forward then adjoint, and their kernels (each adjoint's
# with its sum pass)
B4 = ("rms_norm_fwd", "gated_rms_norm_fwd")
B4_BWD = ("rms_norm_bwd", "gated_rms_norm_bwd")
B5, B5_BWD = ("causal_conv1d_fwd",), ("causal_conv1d_bwd",)
B4_GATED_B5 = ("gated_rms_norm_fwd", "causal_conv1d_fwd")
B4_GATED_B5_BWD = ("gated_rms_norm_bwd", "causal_conv1d_bwd")
NORM_CONV = B4 + B4_BWD + B5 + B5_BWD
# B6 (the loss) and B7 (RoPE of q and k): the wrappers' names, forward then
# adjoint, and the kernels of each part of a train step
B6, B7 = ("cross_entropy_fwd", "cross_entropy_bwd"), ("rope_qk_fwd", "rope_qk_bwd")
LOSS_ROPE = B6 + B7
# B8 (SwiGLU's gate): its wrappers' names, forward then adjoint, and its
# kernels in a train step; FUSED: every wrapper of B4 to B8
B8 = ("swiglu_fwd", "swiglu_bwd")
SWIGLU_KERNELS = {"swiglu_forward": ("swiglu_fwd_kernel",),
                  "swiglu_backward": ("swiglu_bwd_kernel",)}
FUSED = NORM_CONV + LOSS_ROPE + B8
LOSS_ROPE_KERNELS = {"loss_forward": ("ce_fwd_kernel",), "loss_backward": ("ce_bwd_kernel",),
                     "rope_forward": ("rope_qk_fwd_kernel",),
                     "rope_backward": ("rope_qk_bwd_kernel",)}
NORM_CONV_KERNELS = {"norm_forward": ("rms_norm_fwd_kernel",),
                     "norm_backward": ("rms_norm_bwd_kernel", "norm_sum_partials"),
                     "conv_forward": ("causal_conv_fwd_kernel", "causal_conv_fwd_window_kernel"),
                     "conv_backward": ("causal_conv_bwd_kernel", "causal_conv_sum_partials",
                                       "causal_conv_bwd_scalar_kernel", "causal_conv_sum_rows")}


# B5's forward launches by route over the paths the kernels line counts
# (``tally_conv_routes`` after each path's route check)
CONV_FWD_ROUTES = {"staged": 0, "vector": 0, "scalar": 0}


def nc_routes(want: dict, decode_convs: int = 0) -> dict:
    """B4's to B8's launches in ``want`` by route: the norms, B5's
    adjoint, the loss, RoPE and SwiGLU's gate on ``vector``; B5's forward on ``staged`` but for the
    ``decode_convs`` calls of decode steps (S = 1), which keep the register
    window's ``vector`` route."""
    routes = {k: {"vector": want[k], "scalar": 0} for k in FUSED}
    n = want["causal_conv1d_fwd"]
    routes["causal_conv1d_fwd"] = {"staged": n - decode_convs, "vector": decode_convs,
                                   "scalar": 0}
    return routes


def tally_conv_routes(routes: dict) -> None:
    for route, n in routes["causal_conv1d_fwd"].items():
        CONV_FWD_ROUTES[route] += n


@contextlib.contextmanager
def norm_conv_plain():
    """B4's and B5's plain forwards in place of their kernels (``ops``'
    forward wrappers, which the model's norms and convolution call outside
    grad)."""
    from repro_torch.kernels import causal_conv, rms_norm
    ops = importlib.import_module("repro_torch.kernels.ops")
    with mock.patch.object(ops, "rms_norm_fwd", rms_norm.rms_norm_fwd_plain), \
            mock.patch.object(ops, "gated_rms_norm_fwd", rms_norm.gated_rms_norm_fwd_plain), \
            mock.patch.object(ops, "causal_conv1d_fwd", causal_conv.causal_conv1d_plain):
        yield


@contextlib.contextmanager
def rope_plain_swap():
    """B7's plain forward in place of its kernel (``ops.rope_qk_fwd``, which
    ``ops.rope_qk`` calls outside grad)."""
    from repro_torch.kernels import rope
    ops = importlib.import_module("repro_torch.kernels.ops")

    def plain(q, k, positions, theta):
        return (rope.rope_plain(q, positions, theta),
                None if k is None else rope.rope_plain(k, positions, theta))
    with mock.patch.object(ops, "rope_qk_fwd", plain):
        yield


@contextlib.contextmanager
def swiglu_plain_swap():
    """B8's plain forward in place of its kernel (``ops.swiglu_fwd``, which
    ``ops.silu_mul`` calls outside grad)."""
    from repro_torch.kernels import swiglu
    ops = importlib.import_module("repro_torch.kernels.ops")
    with mock.patch.object(ops, "swiglu_fwd", swiglu.swiglu_plain):
        yield


@contextlib.contextmanager
def b2_plain():
    """B2's plain versions in place of its kernels (``ops.moe_fill``,
    ``ops.moe_combine``, which the MoE layer's entry points call)."""
    from repro_torch.kernels.moe_dispatch import moe_combine_plain, moe_fill_plain
    ops = importlib.import_module("repro_torch.kernels.ops")
    with mock.patch.object(ops, "moe_fill", moe_fill_plain), \
            mock.patch.object(ops, "moe_combine", moe_combine_plain):
        yield


def moe_profile(fn, tries: int = 3) -> dict:
    """Device ms of one call of ``fn`` split by what runs: K2, the expert
    products (the GEMMs under ``expert_swiglu``), the router product (the
    other GEMM under ``moe_ffn``), the dispatch (the rest of the MoE layer),
    the other GEMMs (projections, LM head) and the rest (norms, RoPE,
    decode attention, residuals, copies). The dispatch is split further
    (``dispatch_split_ms``): the router's softmax and top-k
    (``router_topk`` less its product), the plan and its route table
    (``dispatch_plan`` and ``route_table``; ``slot_sources`` in a checkout
    from before the table), B2's fill kernel and the ops around it, B2's
    combine kernel and the ops around it (with the plain versions swapped
    in, those ops are the whole plain fill and combine; in a checkout from
    before the table, the combine's ops are the argsort's inverse), SiLU·up
    (the rest of ``expert_swiglu``: its ops but the products, and B8's
    kernels, which no op launches, counted by name and given to the MoE
    layer in the share of B8's launches made inside ``expert_swiglu``) and
    what is left. Each step runs inside a
    ``record_function`` range for this call only; an op's device time is
    the kernels it launched itself (``self_device_time_total`` of the aten
    ops in the range), and B2's kernels, which no op launches, are counted
    by name. The profiler can drop a launch's record: a profile counts only
    where it recorded every B2 launch its wrappers' counters made during the
    call, one of each kernel an MoE layer on the kernels and none on the
    plain versions; after ``tries`` incomplete profiles it raises. A port
    from before B2 (``examples/moe_profile_turns_torch.py``) has no B2
    wrappers and no ``slot_sources``: its fill runs under ``rest``, its
    ``_combine`` under ``combine_ops``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    moe = importlib.import_module("repro_torch.models.moe")
    ops = importlib.import_module("repro_torch.kernels.ops")
    try:
        b2_wrappers = importlib.import_module("repro_torch.kernels.moe_dispatch")
    except ModuleNotFoundError:                   # a port from before B2
        b2_wrappers = None
    try:
        b8 = importlib.import_module("repro_torch.kernels.swiglu").swiglu_fwd
    except ModuleNotFoundError:                   # a port from before B8
        b8 = None
    transformer = importlib.import_module("repro_torch.models.transformer")
    b8_inside, depth = [0], [0]                   # B8 launches inside expert_swiglu

    def ranged(name, f):
        def call(*args, **kw):
            outer = name == "moe_experts" and not depth[0]
            depth[0] += name == "moe_experts"            # its per-expert recursion
            before = b8.launches if b8 else 0
            try:
                with record_function(name):
                    return f(*args, **kw)
            finally:
                depth[0] -= name == "moe_experts"
                if outer and b8:
                    b8_inside[0] += b8.launches - before
        return call
    patches = [(module, attr, name) for module, attr, name in (
        (transformer, "moe_ffn", "moe_ffn"), (moe, "expert_swiglu", "moe_experts"),
        (moe, "router_topk", "moe_router"), (moe, "dispatch_plan", "moe_plan"),
        (moe, "route_table", "moe_plan"), (moe, "slot_sources", "moe_plan"),
        (ops, "fill_expert_slots", "moe_fill"),
        (ops, "combine_expert_rows", "moe_combine"), (moe, "_combine", "moe_combine"))
        if hasattr(module, attr)]
    on_kernels = b2_wrappers is not None and ops.moe_fill is b2_wrappers.moe_fill
    for _ in range(tries):
        torch.cuda.synchronize()
        launched = {op: getattr(b2_wrappers, op).launches if b2_wrappers else 0 for op in B2}
        b8_before, b8_inside[0] = (b8.launches if b8 else 0), 0
        with contextlib.ExitStack() as stack:
            for module, attr, name in patches:
                stack.enter_context(mock.patch.object(module, attr,
                                                      ranged(name, getattr(module, attr))))
            prof = stack.enter_context(profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA))
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {op: (getattr(b2_wrappers, op).launches if b2_wrappers else 0) - n
                    for op, n in launched.items()}
        b8_launched = (b8.launches if b8 else 0) - b8_before
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in MOE_RANGES]
        recorded = {op: sum(e.count for e in kernels if any(named(n, e.key) for n in names))
                    for op, names in B2_KERNELS.items()}
        events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        calls = sum(e.name == "moe_ffn" for e in events)
        if recorded == launched == dict.fromkeys(B2, calls if on_kernels else 0):
            break
        INCOMPLETE_PROFILES.append(("moe_profile", recorded))
    else:
        raise AssertionError(f"moe_profile: the profiler recorded {recorded} of B2's "
                             f"{launched} launches in {calls} MoE layers, {tries} times")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k2 = sum(e.self_device_time_total for e in kernels if "flash_fwd" in e.key) / 1e3
    b2 = {op: sum(e.self_device_time_total for e in kernels
                  if any(named(n, e.key) for n in names)) / 1e3
          for op, names in B2_KERNELS.items()}

    def inside(e, name):
        p = e.cpu_parent
        while p is not None:
            if p.name == name:
                return True
            p = p.cpu_parent
        return False

    def ops_ms(name):
        return sum(e.self_device_time_total for e in events
                   if e.name.startswith("aten::") and inside(e, name)) / 1e3
    gemms = [e for e in events if e.name in GEMM_OPS]
    experts = sum(e.device_time_total for e in gemms if inside(e, "moe_experts")) / 1e3
    router = sum(e.device_time_total for e in gemms
                 if inside(e, "moe_ffn") and not inside(e, "moe_experts")) / 1e3
    other_gemm = sum(e.device_time_total for e in gemms if not inside(e, "moe_ffn")) / 1e3
    b8_ms = sum(e.self_device_time_total for e in kernels
                if named("swiglu_fwd_kernel", e.key)) / 1e3
    b8_moe = b8_ms * b8_inside[0] / b8_launched if b8_launched else 0.0
    moe_ms = ops_ms("moe_ffn") + sum(b2.values()) + b8_moe
    dispatch = moe_ms - experts - router
    parts = {"router_softmax_topk": ops_ms("moe_router") - router, "plan": ops_ms("moe_plan"),
             "fill_kernel": b2["moe_fill"], "fill_ops": ops_ms("moe_fill"),
             "combine_kernel": b2["moe_combine"], "combine_ops": ops_ms("moe_combine"),
             "silu_up": ops_ms("moe_experts") - experts + b8_moe}
    parts["rest"] = dispatch - sum(parts.values())
    split = {"flash_attention": k2, "expert_products": experts, "router_product": router,
             "dispatch": dispatch, "other_gemm": other_gemm,
             "elementwise_and_other": busy - k2 - moe_ms - other_gemm}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "moe_ffn_ms": moe_ms,
            "moe_calls": calls, "b2_launches": launched,
            "b8_launches": {"all": b8_launched, "in_moe": b8_inside[0], "ms": b8_ms},
            "split_ms": split,
            "dispatch_split_ms": parts,
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


def witness_verdict(kernel_vs_f32: float, plain_vs_f32: float,
                    f32_kernel_vs_plain: float) -> bool:
    """depth_check's decision for a model in ``WITNESSED``, from three
    distances, each the largest absolute logit difference over the largest
    logit of the bf16 plain prefill: the bf16 kernels and the bf16 plain
    path against the f32 witness (the same weights in f32, the plain
    attention and scan, the same expert choices), and the f32 kernels
    against the witness. The f32 check is the tight one; the bf16 kernels
    may lie no further from the witness than the bf16 plain path does, plus
    ``WITNESS_MARGIN``."""
    return (f32_kernel_vs_plain <= WITNESS_F32_TOL
            and kernel_vs_f32 <= plain_vs_f32 + WITNESS_MARGIN)


def witness_model(model):
    """depth_check's f32 witness of ``model``: the same weights, every
    tensor copied to f32 but the experts', which stay the model's own
    (bf16 to f32 is exact). Its ``moe_ffn`` then dispatches in f32 with
    the same routing and slots, and casts each expert's tensors to f32 only
    while that expert's products run (``expert_swiglu``)."""
    from repro_torch.models.transformer import Transformer, model_tensors

    def f32(tree, moe=False):
        if isinstance(tree, dict):
            return {k: f32(v, k == "moe") if isinstance(v, (dict, list)) else
                    v.detach() if moe and k != "router" else v.detach().float()
                    for k, v in tree.items()}
        return [f32(v) for v in tree]
    return Transformer(model.cfg, f32(model_tensors(model)))


def serve_model(arch: str, check_cut, serve_cut, gen, smi: str, counters: dict) -> dict:
    """One served model on the card; returns each kernel's launches in its
    serve run.

    - check: the model cut to ``check_cut`` (full width), every
      ``attn_gate`` at 2.0 (zero at init, which would hide the cross
      path), a random modality input; a prefill through the kernels
      against the same prefill with ``ops.flash_attention``,
      ``ops.ssd_scan`` and B2 (``b2_plain``) swapped for their plain
      versions, with the same expert choices (``routing``), within 2e-2 of
      the largest logit; for a model in ``WITNESSED`` that distance is
      reported and the check is ``witness_verdict`` against the same
      weights' f32 prefill, plain and through the kernels; launches as the
      config gives;
    - serve: the model cut to ``serve_cut``, random weights from seed 0,
      the reference's stub modality input; ``generate`` of 4 requests of
      1024 prompt tokens + 32 greedy tokens, every kernel's count zeroed
      just before and read just after: K2's and K3's launches as the
      config gives, all on the ``sm90`` route, B2's once a MoE layer in the
      prefill and in each decode step, all on the ``vector`` route; then an
      MoE model's prefill twice more, and once with B2's plain versions,
      each bit for bit equal to the served one;
    - profile (``PROFILED`` only): device time of one prefill and of 8
      decode steps, split by kernel for an MoE model (``moe_profile``),
      whose prefill is profiled in turns with B2's plain versions in
      place of its kernels (kernels, plain, plain, kernels).
    """
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.launch.serve import generate, stub_cross_src
    from repro_torch.models import forward_decode, forward_prefill, init_params
    ops = importlib.import_module("repro_torch.kernels.ops")
    dev = torch.device("cuda")
    full = get_config(arch)

    def zero():
        zero_counts(counters)

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

    def prefill(m, x, kernels: bool):
        with contextlib.ExitStack() as stack:
            if not kernels:
                stack.enter_context(mock.patch.object(ops, "flash_attention",
                                                      flash_attention_plain))
                stack.enter_context(mock.patch.object(ops, "ssd_scan", ssd_scan_plain))
                stack.enter_context(b2_plain())
                stack.enter_context(norm_conv_plain())
                stack.enter_context(rope_plain_swap())
                stack.enter_context(swiglu_plain_swap())
            stack.enter_context(routing("replay", list(chosen)))
            return forward_prefill(m, tokens, SERVE_PROMPT + 1, x)[0].float()

    with torch.inference_mode():
        zero()
        with routing("record", chosen):
            lk = forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)[0].float()
        counts = {k: c.launches for k, c in counters.items()}
        lp = prefill(model, cross, kernels=False)
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    want = expected_launches(cfg)
    witness = None
    if arch in WITNESSED:
        free()
        torch.cuda.reset_peak_memory_stats()
        model32 = witness_model(model)
        cross32 = None if cross is None else cross.float()
        with torch.inference_mode():
            lw = prefill(model32, cross32, kernels=False)
            lwk = prefill(model32, cross32, kernels=True)
        witness = {"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "kernel_vs_f32": float((lk - lw).abs().max()) / scale,
                   "plain_vs_f32": float((lp - lw).abs().max()) / scale,
                   "f32_kernel_vs_plain": float((lwk - lw).abs().max()) / scale,
                   "f32_tol": WITNESS_F32_TOL, "margin": WITNESS_MARGIN,
                   "f32_finite": bool(torch.isfinite(lwk).all())}
        witness["ok"] = witness["f32_finite"] and witness_verdict(
            witness["kernel_vs_f32"], witness["plain_vs_f32"], witness["f32_kernel_vs_plain"])
        del model32, cross32, lw, lwk
    close = witness["ok"] if witness is not None else err <= 2e-2 * scale
    ok = bool(torch.isfinite(lk).all()) and close and counts == want
    emit({"phase": "depth_check", "arch": cfg.name, "layers": cfg.num_layers,
          "encoder_layers": cfg.encoder_layers,
          "pattern": cfg.layout_pattern, "gates": 2.0 if cfg.arch_type == "vlm" else None,
          "routing_pinned": cfg.uses_moe,
          "cross_len": None if cross is None else cross.shape[1],
          "max_abs_err": err, "max_abs_logit": scale, "tol": 2e-2 * scale,
          "within_tol": err <= 2e-2 * scale, "witness": witness,
          "launches": counts, "want_launches": want, "ok": ok})
    if not ok:
        raise AssertionError(f"{arch}: the prefill through the kernels differs from the plain "
                             f"one ({err} against {2e-2 * scale}; witness {witness}) or "
                             f"launches {counts} != {want}")
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
    counted = read_counts(counters)
    counts = counted["launches"]
    routes = {k: counted["routes"][k]
              for k in ("flash_attention", "ssd_scan") + B2 + FUSED}
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, SERVE_NEW)
    want_routes = {k: {"sm90": want[k], "simt": 0} for k in ("flash_attention", "ssd_scan")}
    want_routes.update({k: {"vector": want[k], "scalar": 0} for k in B2})
    want_routes.update(nc_routes(want, norm_conv_counts(cfg)["ssm"] * SERVE_NEW))
    same_bits = b2_plain_bits = None
    if cfg.uses_moe:               # the MoE combine is deterministic: equal bits
        with torch.inference_mode():
            again = [forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)[0]
                     for _ in range(2)]
            with b2_plain():
                plain_b2 = forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)[0]
        same_bits = all(torch.equal(res.prefill_logits.view(torch.int16), a.view(torch.int16))
                        for a in again)
        b2_plain_bits = torch.equal(res.prefill_logits.view(torch.int16),
                                    plain_b2.view(torch.int16))
        del again, plain_b2
    ok = (counts == want and routes == want_routes and same_bits in (None, True)
          and b2_plain_bits in (None, True) and sm90_layout_copies(counted) == 0
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
          "layout_copies": counted["layout_copies"], "prefills_bit_equal": same_bits,
          "prefill_b2_plain_bit_equal": b2_plain_bits,
          "sample_ids": res.ids[0, :8].tolist(), "device": torch.cuda.get_device_name(0),
          "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"{arch}: serve check failed: launches {counts}, want {want}; "
                             f"routes {routes}, want {want_routes}; equal bits {same_bits}, "
                             f"under B2's plain versions {b2_plain_bits}")
    tally_conv_routes(routes)

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
            b2_turns = None
            if cfg.uses_moe:
                # the dispatch split with B2's kernels and with their plain
                # versions in their place, in turns (kernels, plain, plain, kernels)
                b2_turns = {"kernels": [prefill_prof], "plain": []}
                for who in ("plain", "plain", "kernels"):
                    with b2_plain() if who == "plain" else contextlib.nullcontext():
                        b2_turns[who].append(prof(
                            lambda: forward_prefill(model, tokens, SERVE_PROMPT + 1, cross)))

            def decode_steps():
                c, n = caches, clen
                for _ in range(8):
                    _, c, n = forward_decode(model, tokens[:, -1:], c, n)
            decode_prof = prof(decode_steps)
        emit({"phase": "profile", "arch": cfg.name, "prefill": prefill_prof,
              "decode_8_steps": decode_prof,
              "prefill_b2_turns": None if b2_turns is None else {
                  who: [{"device_busy_ms": p["device_busy_ms"], "split_ms": p["split_ms"],
                         "dispatch_split_ms": p["dispatch_split_ms"]} for p in ps]
                  for who, ps in b2_turns.items()},
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
    return {k: counts[k] for k in ("flash_attention", "ssd_scan") + B2 + FUSED}


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


def ssd_bwd_inputs(dtype: str, shape, gen):
    """K3's inputs, y's gradient and the final state's (or None) on the card:
    the model's A (-1 … -16 over a group's heads, over the rows for one head
    a group) and dt doubled, so that exp(cum_i - cum_j) overflows above the
    diagonal in every chunk longer than a few steps."""
    import torch
    bh, s, p, n, chunk, g, with_state = shape
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)
    x, dy = randn(bh, s, p).to(tdt), randn(bh, s, p).to(tdt)
    dt = torch.nn.functional.softplus(randn(bh, s)) * 2.0
    heads = g if g > 1 else bh
    A = -torch.linspace(1.0, 16.0, heads, device=dev).repeat(bh // heads)
    Bm, Cm = (randn(bh // g, s, n) * 0.3).to(tdt), (randn(bh // g, s, n) * 0.3).to(tdt)
    kw = dict(chunk=chunk, heads_per_group=g, initial_state=randn(bh, n, p) if with_state else None)
    return (x, dt, A, Bm, Cm), dy, randn(bh, n, p) if with_state else None, kw


def ssd_bwd_bound_ms(dtype: str, shape):
    """Least time for K3's backward from ``ssd_scan.bwd_least_work``: the
    Q×Q products over the kept pairs j ≤ i, C·Bᵀ and dG's two products once
    per group row (dG summed over a group's heads first), five Q·N·P
    products per row and chunk; each input read once, each gradient written
    once."""
    from repro_torch.kernels.ssd_scan import bwd_least_work
    flops, nbytes = bwd_least_work(*shape, 2 if dtype == "bfloat16" else 4)
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def check_ssd_bwd(gen, smi: str) -> dict:
    """K3's backward kernel (``ssd_scan_bwd``, one launch a call on the route
    ``_route`` gives: ``sm90`` for every bf16 shape it takes, ``simt`` for
    f32 and the others) against ``ssd_scan_bwd_plain`` on the same inputs at
    ``SSD_BWD_CHECKS``: every gradient finite, within ``BWD_TOL`` of the
    plain one's largest entry, the same bits on a second call; at mamba2's
    and jamba's training shapes also against autograd through
    ``ssd_scan_plain``. Then timed at those two shapes."""
    import torch
    from repro_torch.kernels.ssd_scan import ROUTES as SSD_ROUTES
    from repro_torch.kernels.ssd_scan import _route as ssd_route
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain
    timed, worst = {}, 0.0
    for dtype, shape in SSD_BWD_CHECKS:
        args, dy, dfinal, kw = ssd_bwd_inputs(dtype, shape, gen)
        route = ssd_route(getattr(torch, dtype), shape[2], shape[3], shape[4])
        before = dict(ssd_scan_bwd.launches_by_route)
        got = ssd_scan_bwd(*args, dy, dfinal, **kw)
        took = {r: ssd_scan_bwd.launches_by_route[r] - before[r] for r in SSD_ROUTES}
        again = ssd_scan_bwd(*args, dy, dfinal, **kw)
        want = ssd_scan_bwd_plain(*args, dy, dfinal, **kw)
        torch.cuda.synchronize()
        names = [nm for nm, t in zip(SSD_GRADS, want) if t is not None]
        got, again, want = ([t for t in r if t is not None] for r in (got, again, want))
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        scales = [float(b.float().abs().max()) for b in want]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        tol = BWD_TOL[dtype]
        ok = (len(got) == len(want) and all(e <= tol * max(sc, 1e-6) for e, sc in zip(errs, scales))
              and same and finite and took == {r: int(r == route) for r in SSD_ROUTES}
              and [a.dtype for a in got] == [b.dtype for b in want])
        record = {"phase": "kernel_check", "kernel": "ssd_scan_bwd", "route": route,
                  "dtype": dtype, "shape": shape, "max_abs_err": dict(zip(names, errs)),
                  "max_abs_grad": dict(zip(names, scales)), "tol_of_largest": tol,
                  "same_bits_twice": same, "finite": finite, "launches": took}
        serving = (dtype, shape) in (SSD_BWD_MAMBA2, SSD_BWD_JAMBA)
        if serving:                      # autograd through the plain forward, y alone
            leaves = [t.clone().requires_grad_() for t in args]
            y, _ = ssd_scan_plain(*leaves, **kw)
            grads = torch.autograd.grad(y, leaves, dy)
            a_errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, grads)]
            a_scales = [float(b.float().abs().max()) for b in grads]
            record["autograd_max_abs_err"] = dict(zip(names, a_errs))
            ok = ok and all(e <= tol * max(sc, 1e-6) for e, sc in zip(a_errs, a_scales))
            del leaves, y, grads
        record["ok"] = ok
        emit(record)
        if not ok:
            raise AssertionError(f"ssd_scan_bwd differs from its plain version at {shape} "
                                 f"{dtype}: {errs} (of {scales}), same bits {same}, finite "
                                 f"{finite}, launches {took}")
        worst = max(worst, max(e / max(sc, 1e-6) for e, sc in zip(errs, scales)))
        if serving:
            timed[shape] = (max(errs), (args, dy, dfinal, kw))
        del args, dy, dfinal, kw, got, again, want
    err, inputs = timed.pop(SSD_BWD_MAMBA2[1])
    result = dict(max_abs_err=err, worst_err_over_largest_grad=worst,
                  **time_ssd_bwd(SSD_BWD_MAMBA2, inputs, smi, "mamba2-1.3b train"))
    err, inputs = timed.pop(SSD_BWD_JAMBA[1])
    t = time_ssd_bwd(SSD_BWD_JAMBA, inputs, smi, "jamba-1.5-large-398b ssm layer")
    result["jamba_shape"] = dict(shape=SSD_BWD_JAMBA[1], max_abs_err=err,
                                 **{k: t[k] for k in ("ms", "simt_ms", "plain_ms", "bound_ms",
                                                      "library_ms", "forward_ms")})
    return result


# K2 and K3 in the model's (B, S, H, ·) layout: K2's forward at qwen3-14b's
# prefill (q, k, v as the projections and RoPE leave them), its backward at
# phi4-mini-3.8b's training shape, K3 forward and backward at mamba2-1.3b's
# (x, B and C views of the convolution's (4, 1024, 4352) output, dy in y's
# layout); (B, S, H, Kv or G, hd or P, N, chunk)
LAYOUT_K2 = ("qwen3-14b prefill", (4, 1024, 40, 8, 128))
LAYOUT_K2_BWD = ("phi4-mini-3.8b train", (4, 1024, 24, 8, 128))
LAYOUT_K3 = ("mamba2-1.3b", (4, 1024, 64, 1, 64, 128, 128))


def check_layouts(gen, smi: str) -> dict:
    """K2 and K3, forward and backward, reading and writing the model's
    layout in place (``in_place``), timed in turns (in_place, flattened,
    with_copies, with_copies, flattened, in_place, twice) against the same
    kernel plus the layout copies the wrappers made before (``with_copies``:
    q, k, v to (B·H, S, hd) and O back through the output projection's
    reshape; dO to (B·H, S, hd) and dq, dk, dv back; x, dt, B, C to their
    rows; dx, ddt, dB, dC back) and against the kernel alone on operands
    already flattened (``flattened``, the layout it read before). The
    results equal bit for bit across the three, the ``sm90`` route takes
    every call and no layout copy is counted on it."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    bf16 = torch.bfloat16

    def rnd(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def rows(t):                          # (B, S, n, w) -> contiguous (B·n, S, w)
        return t.transpose(1, 2).reshape(t.shape[0] * t.shape[2], t.shape[1],
                                         *t.shape[3:]).contiguous()

    def back(t, b):                       # (B·n, S, w) -> contiguous (B, S, n, w)
        return t.reshape(b, t.shape[0] // b, *t.shape[1:]).transpose(1, 2).contiguous()

    def measure(kernel, path, shape, fns, iters, flat, split):
        """``fns``: who -> a call; ``flat(result)`` gives the flattened call's
        result in the model's layout, to compare the three bit for bit;
        ``split``: the kernels of a call (``kernel_split``), whose device
        time is taken apart from the host's pace for the two layouts."""
        copies = dict(kernel.layout_copies)
        routes = dict(kernel.launches_by_route)
        got = {who: fn() for who, fn in fns.items()}
        torch.cuda.synchronize()
        took = {r: kernel.launches_by_route[r] - routes[r] for r in routes}
        got["flattened"] = flat(got["flattened"])
        same = all(all(torch.equal(a, c) for a, c in zip(got["in_place"], res))
                   for res in got.values())
        turns = dict(zip(fns, in_turns(*fns.values(), iters=iters, rounds=2)))
        best = {who: min(t) for who, t in turns.items()}
        device = {"in_place": [], "flattened": []}          # the kernels' own, in turns
        for who in ("in_place", "flattened", "flattened", "in_place"):
            device[who].append(sum(kernel_split(fns[who], split, calls=5).values()))
        rec = {"phase": "kernel_time", "kernel": kernel.__name__, "layout": "bshw",
               "route": "sm90", "path": path, "shape": shape,
               **{f"{who}_ms": t for who, t in best.items()}, "turns_ms": turns,
               **{f"{who}_kernel_ms": min(t) for who, t in device.items()},
               "kernel_turns_ms": device,
               "bits_equal": same, "launches": took,
               "sm90_layout_copies": kernel.layout_copies["sm90"] - copies["sm90"], "smi": smi}
        rec["ok"] = (same and took == {"sm90": 3, "simt": 0} and rec["sm90_layout_copies"] == 0)
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"{kernel.__name__} in the model's layout: {rec}")
        return {k: v for k, v in rec.items() if k.endswith("_ms") or k in ("path", "shape")}

    k2_bwd = {n: 1 for n in ("bwd_prep_sm90_kernel", "dkdv_sm90_kernel", "dq_sm90_kernel")}
    k3_bwd = {n: 1 for n in SSD_BWD_KERNELS if "sm90" in n}

    out = {}
    path, (b, s, h, kv, hd) = LAYOUT_K2
    q, k, v = rnd(b, s, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd)
    qf, kf, vf = rows(q), rows(k), rows(v)
    g = h // kv
    out["flash_attention"] = measure(flash_attention, path, (b, s, h, kv, hd), {
        "in_place": lambda: [flash_attention(q, k, v, q_heads_per_kv=g).reshape(b, s, h * hd)],
        "flattened": lambda: [flash_attention(qf, kf, vf, q_heads_per_kv=g)],
        "with_copies": lambda: [flash_attention(rows(q), rows(k), rows(v), q_heads_per_kv=g)
                                .reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)]},
        50, lambda res: [back(res[0], b).reshape(b, s, h * hd)], {"flash_fwd_sm90_kernel": 1})
    del q, k, v, qf, kf, vf
    path, (b, s, h, kv, hd) = LAYOUT_K2_BWD
    g = h // kv
    q, k, v, do = rnd(b, s, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd), rnd(b, s, h, hd)
    o, lse = flash_attention(q, k, v, q_heads_per_kv=g, return_lse=True)
    qf, kf, vf, of, dof = (rows(t) for t in (q, k, v, o, do))
    out["flash_attention_bwd"] = measure(flash_attention_bwd, path, (b, s, h, kv, hd), {
        "in_place": lambda: flash_attention_bwd(q, k, v, o, lse, do, q_heads_per_kv=g),
        "flattened": lambda: flash_attention_bwd(qf, kf, vf, of, lse, dof, q_heads_per_kv=g),
        "with_copies": lambda: [back(t, b) for t in flash_attention_bwd(
            qf, kf, vf, of, lse, rows(do), q_heads_per_kv=g)]},
        20, lambda grads: [back(t, b) for t in grads], k2_bwd)
    del q, k, v, do, o, lse, qf, kf, vf, of, dof
    path, (b, s, h, grp, p, n, chunk) = LAYOUT_K3
    xbc = rnd(b, s, h * p + 2 * grp * n)
    xs, bs, cs = torch.split(xbc, [h * p, grp * n, grp * n], -1)
    x, Bm, Cm = xs.unflatten(-1, (h, p)), bs.unflatten(-1, (grp, n)), cs.unflatten(-1, (grp, n))
    Bm.mul_(0.3), Cm.mul_(0.3)
    dt = torch.nn.functional.softplus(rnd(b, s, h, dtype=torch.float32)) * 2.0
    A = -torch.linspace(1.0, 16.0, h // grp, device="cuda").repeat(b * grp)
    kw = dict(chunk=chunk, heads_per_group=h // grp)
    xf, dtf, Bf, Cf = rows(x), rows(dt), rows(Bm), rows(Cm)

    def model_y(res):                      # y as (B, S, H, P) over its rows, the state's
        y, state = res
        return [y if y.dim() == 4 else y.view(b, h, s, p).transpose(1, 2),
                state.view(b, h, n, p)]
    out["ssd_scan"] = measure(ssd_scan, path, (b, s, h, grp, p, n, chunk), {
        "in_place": lambda: model_y(ssd_scan(x, dt, A, Bm, Cm, **kw)),
        "flattened": lambda: ssd_scan(xf, dtf, A, Bf, Cf, **kw),
        "with_copies": lambda: model_y(ssd_scan(rows(x), rows(dt), A, rows(Bm), rows(Cm),
                                                **kw))},
        50, model_y, {"ssd_scan_sm90_kernel": 1})
    dy = rnd(b, h, s, p).transpose(1, 2)              # y's own layout
    dyf = dy.transpose(1, 2).reshape(b * h, s, p)     # a view: y's rows

    def model_grads(grads):                # dx, ddt, dB, dC back to (B, S, ·), dA as it is
        return [t if t.dim() == 1 else back(t, b) for t in grads[:5]]
    out["ssd_scan_bwd"] = measure(ssd_scan_bwd, path + " train", (b, s, h, grp, p, n, chunk), {
        "in_place": lambda: ssd_scan_bwd(x, dt, A, Bm, Cm, dy, None, **kw)[:5],
        "flattened": lambda: ssd_scan_bwd(xf, dtf, A, Bf, Cf, dyf, None, **kw),
        "with_copies": lambda: model_grads(ssd_scan_bwd(rows(x), rows(dt), A, rows(Bm),
                                                        rows(Cm), dyf, None, **kw))},
        20, model_grads, k3_bwd)
    return out


def time_ssd_bwd(case, inputs, smi: str, path: str) -> dict:
    """K3's backward at ``case`` (bf16): the kernel on its route (``sm90``),
    the ``simt`` kernel at bf16 (``_ssd_scan_bwd_simt``) and the plain
    version in turns (a, b, c, c, b, a), each keeps its least; K3's forward
    on its route beside."""
    from repro_torch.kernels.ssd_scan import (_route, _ssd_scan_bwd_simt, ssd_scan,
                                              ssd_scan_bwd, ssd_scan_bwd_plain)
    args, dy, dfinal, kw = inputs
    route = _route(args[0].dtype, case[1][2], case[1][3], case[1][4])
    contenders = {"kernel": (lambda: ssd_scan_bwd(*args, dy, dfinal, **kw), 20),
                  "simt": (lambda: _ssd_scan_bwd_simt(*args, dy, dfinal, **kw), 5),
                  "plain": (lambda: ssd_scan_bwd_plain(*args, dy, dfinal, **kw), 3)}
    turns = {who: [] for who in contenders}
    for who in list(contenders) + list(reversed(contenders)):
        fn, iters = contenders[who]
        turns[who].append(cuda_ms(fn, iters=iters))
    fwd_ms = cuda_ms(lambda: ssd_scan(*args, **kw), iters=20)
    ms, simt_ms, plain_ms = min(turns["kernel"]), min(turns["simt"]), min(turns["plain"])
    bound_ms, bound_by, flops, nbytes = ssd_bwd_bound_ms(*case)
    passes = kernel_split(lambda: ssd_scan_bwd(*args, dy, dfinal, **kw),
                          {n: 1 for n in SSD_BWD_KERNELS if ("sm90" in n) == (route == "sm90")})
    emit({"phase": "kernel_time", "kernel": "ssd_scan_bwd", "route": route, "path": path,
          "dtype": case[0], "shape": case[1], "ms": ms, "simt_ms": simt_ms,
          "plain_ms": plain_ms, "library_ms": None, "turns_ms": turns, "bound_ms": bound_ms,
          "bound_by": bound_by, "flops": flops, "bytes": nbytes,
          "tflops": {n: flops / min(t) / 1e9 for n, t in turns.items()},
          "share_of_bound": bound_ms / ms, "simt_over_kernel": simt_ms / ms,
          "passes_ms": passes, "forward_ms": fwd_ms, "smi": smi})
    return dict(ms=ms, simt_ms=simt_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, forward_ms=fwd_ms)


# adamw: the kernel against adamw_update_plain, bit for bit, over sizes
# around the vector widths (4 f32, 8 bf16) and a work unit, an empty tensor
# and two large ones, steps 1-3; then more tensors than one launch takes, in
# both dtypes, and tensors one element off 16-byte alignment
ADAMW_SIZES = (0, 1, 3, 7, 8, 9, 31, 1000, 8191, 8193, 1 << 20, (1 << 22) + 5)
ADAMW_STEPS = (1, 2, 3)
ADAMW_ROUTE_LAYERS, ADAMW_ROUTE_STEPS = 2, 3     # phi4 cut to 2 layers, 3 steps each route


def adamw_inputs(sizes, dtype, gen, offset: int = 0):
    """p, g, m, v on the card for tensors of ``sizes``: p ~ N(0, 1), g from
    1e-30 to 1e4 in magnitude with a tenth zeros, m and v as after a few
    steps; ``offset`` elements into a buffer (1: not 16-byte aligned)."""
    import torch
    dev = torch.device("cuda")
    out = [[], [], [], []]
    for n in sizes:
        sign = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        g = sign * 10.0 ** (torch.rand(n, generator=gen, device=dev) * 34 - 30)
        g[torch.rand(n, generator=gen, device=dev) < 0.1] = 0.0
        vals = (torch.randn(n, generator=gen, device=dev).to(dtype), g.to(dtype),
                torch.randn(n, generator=gen, device=dev) * 1e-2,
                torch.rand(n, generator=gen, device=dev) * 1e-4)
        for lst, t in zip(out, vals):
            lst.append(t.new_empty(n + offset)[offset:].copy_(t) if offset else t)
    return out


def adamw_bias(step: int, cfg):
    """The optimizer's bias corrections at ``step``, 0-dim f32 on the card."""
    import torch
    t = torch.tensor(step, dtype=torch.int32, device="cuda").float()
    return 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t


def adamw_bytes(tensors) -> int:
    """Bytes one update must move: p and g read in their dtype, m and v
    read in f32, p, m and v written (22 B an element for bf16, 28 for f32)."""
    return sum(t.numel() * (3 * t.element_size() + 16) for t in tensors)


def adamw_per_step(cfg) -> int:
    """The kernel's launches in one update of ``cfg``'s parameters."""
    from repro_torch.kernels.adamw import plan_launches
    from repro_torch.launch.steps import param_shapes
    from repro_torch.models import param_leaves
    return len(plan_launches([(t.numel(), t.dtype) for leaf in param_leaves(param_shapes(cfg))
                              for t in leaf.tensors]))


def check_adamw(gen, smi: str) -> dict:
    """B3 against ``adamw_update_plain`` on the same tensors, p, m and v
    equal bit for bit after every one of ``ADAMW_STEPS``: bf16 and f32
    parameters at ``ADAMW_SIZES``, more tensors than one launch takes in
    both dtypes at once, and tensors one element off alignment; each call's
    launches as ``plan_launches`` gives. Then phi4-mini-3.8b's parameter
    list (bf16 p and g, f32 m and v) timed in turns with the plain update
    and with ``torch._fused_adamw_`` (a yardstick only: it keeps m and v in
    the parameters' dtype, bf16 here, and places eps and the decay
    otherwise), beside the bound by bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import (MAX_TENSORS, adamw_update, adamw_update_plain,
                                           plan_launches)
    from repro_torch.launch.steps import param_shapes
    from repro_torch.models import param_leaves
    from repro_torch.train import AdamWConfig
    cfg = AdamWConfig(lr=TRAIN_LR)
    bf16, f32 = torch.bfloat16, torch.float32

    def many():                       # two bf16 launches and an f32 one, empty tensors among them
        a = adamw_inputs([(i * 37) % 300 for i in range(MAX_TENSORS + 37)], bf16, gen)
        return [x + y for x, y in zip(a, adamw_inputs((5, 4096, 0, 77), f32, gen))]
    cases = {("ragged", "float32", 0): lambda: adamw_inputs(ADAMW_SIZES, f32, gen),
             ("ragged", "bfloat16", 0): lambda: adamw_inputs(ADAMW_SIZES, bf16, gen),
             ("many", "bfloat16+float32", 0): many,
             ("unaligned", "float32", 1): lambda: adamw_inputs((1025, 70001), f32, gen, 1),
             ("unaligned", "bfloat16", 1): lambda: adamw_inputs((1025, 70001), bf16, gen, 1)}
    worst = 0.0
    for (name, dtype, offset), make in cases.items():
        lists = make()
        plain = [[t.clone() for t in ts] for ts in lists]
        want_launches = len(plan_launches([(p.numel(), p.dtype) for p in lists[0]]))
        steps = []
        for step in ADAMW_STEPS:
            bc1, bc2 = adamw_bias(step, cfg)
            before = adamw_update.launches
            adamw_update(*lists, bc1, bc2, cfg)
            took = adamw_update.launches - before
            adamw_update_plain(*plain, bc1, bc2, cfg)
            torch.cuda.synchronize()
            equal = {k: all(torch.equal(x, y) for x, y in zip(lists[i], plain[i]))
                     for i, k in enumerate("pgmv") if k != "g"}
            err = max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
                      for i in (0, 2, 3) for x, y in zip(lists[i], plain[i]))
            steps.append({"step": step, "equal": equal, "max_abs_err": err, "launches": took})
            worst = max(worst, err)
        ok = all(all(r["equal"].values()) and r["launches"] == want_launches for r in steps)
        emit({"phase": "kernel_check", "kernel": "adamw", "case": name, "dtype": dtype,
              "tensors": len(lists[0]), "elements": sum(p.numel() for p in lists[0]),
              "offset": offset, "steps": steps, "want_launches": want_launches, "ok": ok})
        if not ok:
            raise AssertionError(f"adamw differs from its plain version ({name}, {dtype}): {steps}")
        del lists, plain

    # phi4-mini-3.8b's parameter list at full size
    gc.collect()
    torch.cuda.empty_cache()
    shapes = [t for leaf in param_leaves(param_shapes(get_config(TRAIN_ARCH))) for t in leaf.tensors]
    dev = torch.device("cuda")
    ps, gs, ms, vs = [], [], [], []
    for t in shapes:
        ps.append((torch.randn(t.shape, generator=gen, device=dev) * 0.02).to(t.dtype))
        gs.append((torch.randn(t.shape, generator=gen, device=dev) * 1e-3).to(t.dtype))
        ms.append(torch.randn(t.shape, generator=gen, device=dev) * 1e-4)
        vs.append(torch.rand(t.shape, generator=gen, device=dev) * 1e-7)
    m16, v16 = [m.to(torch.bfloat16) for m in ms], [v.to(torch.bfloat16) for v in vs]
    steps16 = [torch.full((), 3.0, device=dev) for _ in ps]
    bc1, bc2 = adamw_bias(3, cfg)
    n_params = sum(p.numel() for p in ps)
    contenders = {
        "kernel": (lambda: adamw_update(ps, gs, ms, vs, bc1, bc2, cfg), 5),
        "plain": (lambda: adamw_update_plain(ps, gs, ms, vs, bc1, bc2, cfg), 2),
        "library": (lambda: torch._fused_adamw_(
            ps, gs, m16, v16, [], steps16, lr=cfg.lr, beta1=cfg.b1, beta2=cfg.b2,
            weight_decay=cfg.weight_decay, eps=cfg.eps, amsgrad=False, maximize=False), 5)}
    turns = {who: [] for who in contenders}
    for who in list(contenders) + list(reversed(contenders)):
        fn, iters = contenders[who]
        turns[who].append(cuda_ms(fn, iters=iters, warmup=1))
    before = adamw_update.launches
    adamw_update(ps, gs, ms, vs, bc1, bc2, cfg)
    launches_per_call = adamw_update.launches - before
    passes = kernel_split(lambda: adamw_update(ps, gs, ms, vs, bc1, bc2, cfg),
                          {"adamw_kernel": launches_per_call})
    peak = torch.cuda.max_memory_allocated()
    nbytes = adamw_bytes(ps)
    lib_bytes = sum(p.numel() * 7 * p.element_size() for p in ps)    # p, g, m, v read; p, m, v written
    ms_k, ms_p, ms_l = min(turns["kernel"]), min(turns["plain"]), min(turns["library"])
    bound_ms = nbytes / PEAK_BYTES * 1e3
    # ~15 f32 operations an element (two divisions, a square root) on the CUDA cores
    flops = 15 * n_params
    bound_by = "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32_FLOPS else "operations"
    emit({"phase": "kernel_time", "kernel": "adamw", "path": f"{TRAIN_ARCH} parameters",
          "tensors": len(ps), "params": n_params, "launches_per_call": launches_per_call,
          "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l, "turns_ms": turns,
          "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "tb_per_s": nbytes / ms_k / 1e9, "share_of_bound": bound_ms / ms_k,
          "plain_over_kernel": ms_p / ms_k, "library_bytes": lib_bytes,
          "library_tb_per_s": lib_bytes / ms_l / 1e9, "library_layout": "m, v bf16",
          "kernel_device_ms": passes, "peak_mem_gb": peak / 1e9, "smi": smi})
    del ps, gs, ms, vs, m16, v16
    gc.collect()
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=ms_l, library_layout="torch._fused_adamw_, m and v bf16",
                tb_per_s=nbytes / ms_k / 1e9, launches_per_call=launches_per_call)


def adamw_route_check(smi: str, counters: dict) -> None:
    """phi4-mini-3.8b at full width cut to ``ADAMW_ROUTE_LAYERS`` layers, bf16,
    random weights from seed 0, ``ADAMW_ROUTE_STEPS`` steps of
    ``train_step`` (AdamW at ``TRAIN_LR``, remat) on the train phase's
    batches: with the kernel, with ``adamw_update_plain`` in its place, and
    with the kernel again. Every parameter after the last step must be equal
    bit for bit under the two routes (and the kernel's two runs), the losses
    too; the kernel runs launch it ``adamw_per_step`` times a step, the plain
    run never."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import adamw_update_plain
    from repro_torch.models import init_params, param_leaves
    from repro_torch.train import DataConfig, MarkovDataset, make_optimizer, train_step
    optimizer = importlib.import_module("repro_torch.train.optimizer")
    dev = torch.device("cuda")
    cfg = cut_config(get_config(TRAIN_ARCH), {"num_layers": ADAMW_ROUTE_LAYERS})
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    batch_size=TRAIN_BATCH, seed=0))
    it = data.batches()
    batches = [tuple(torch.from_numpy(a).to(dev, torch.int64) for a in next(it))
               for _ in range(ADAMW_ROUTE_STEPS)]
    per_step = adamw_per_step(cfg)

    def run(plain: bool):
        model = init_params(cfg, seed=0, device=dev)
        model.requires_grad_(True)
        opt = make_optimizer("adamw", lr=TRAIN_LR)
        state = opt[0](param_leaves(model))
        losses = []
        zero_counts(counters)
        swap = (mock.patch.object(optimizer, "adamw_update", adamw_update_plain) if plain
                else contextlib.nullcontext())
        with swap:
            for tokens, labels in batches:
                state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
                losses.append(float(loss))
        torch.cuda.synchronize()
        counted = read_counts(counters)["launches"]
        params = {n: p.detach() for n, p in model.named_parameters()}
        return params, losses, counted

    t0 = time.perf_counter()
    kernel, kernel_losses, kernel_counts = run(False)
    plain, plain_losses, plain_counts = run(True)
    differ = [n for n in kernel if not torch.equal(kernel[n], plain[n])]
    del plain
    again, again_losses, _ = run(False)
    differ_twice = [n for n in kernel if not torch.equal(kernel[n], again[n])]
    want = train_launches(cfg, ADAMW_ROUTE_STEPS, per_step)
    ok = (not differ and not differ_twice and kernel_losses == plain_losses == again_losses
          and kernel_counts == want and plain_counts == {**want, "adamw": 0}
          and all(math.isfinite(x) for x in kernel_losses))
    emit({"phase": "adamw_routes", "arch": cfg.name, "layers": cfg.num_layers,
          "steps": ADAMW_ROUTE_STEPS, "params": sum(p.numel() for p in kernel.values()),
          "tensors": len(kernel), "losses": kernel_losses, "plain_losses": plain_losses,
          "params_equal": not differ, "differ": differ[:8],
          "kernel_twice_equal": not differ_twice, "launches": kernel_counts,
          "plain_launches": plain_counts, "want_launches": want,
          "seconds": time.perf_counter() - t0, "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"adamw routes: {len(differ)} parameters differ ({differ[:4]}), "
                             f"kernel twice differs in {differ_twice[:4]}, losses "
                             f"{kernel_losses} / {plain_losses} / {again_losses}, launches "
                             f"{kernel_counts} / {plain_counts} (want {want})")
    del kernel, again
    gc.collect()
    torch.cuda.empty_cache()


# B2, the MoE layer's dispatch and combine: the fill and the combine against
# their plain versions, bit for bit, at the prefill shapes of the three MoE
# families (4 x 1024 tokens), olmoe's decode (4 tokens, capacity 1), the f32
# witness's buffer, heavy drops, an expert without tokens and a width that
# is no whole number of 16-byte vectors; the first four timed. Each case:
# (label, arch or (k, experts, d), tokens, capacity factor (None: the
# config's), dtype, expert 0 left without tokens, timed)
B2_CASES = (
    ("olmoe-1b-7b prefill", "olmoe-1b-7b", SERVE_BATCH * SERVE_PROMPT, None, "bfloat16", False,
     True),
    # the train phase's batch: the same shape as the prefill (C 640), another draw
    ("olmoe-1b-7b train", "olmoe-1b-7b", TRAIN_BATCH * TRAIN_SEQ, None, "bfloat16", False,
     False),
    ("kimi-k2-1t-a32b prefill", "kimi-k2-1t-a32b", SERVE_BATCH * SERVE_PROMPT, None, "bfloat16",
     False, True),
    ("jamba-1.5-large-398b prefill", "jamba-1.5-large-398b", SERVE_BATCH * SERVE_PROMPT, None,
     "bfloat16", False, True),
    ("olmoe-1b-7b decode", "olmoe-1b-7b", SERVE_BATCH, None, "bfloat16", False, True),
    ("olmoe-1b-7b prefill, f32 witness", "olmoe-1b-7b", SERVE_BATCH * SERVE_PROMPT, None,
     "float32", False, False),
    ("olmoe-1b-7b prefill, capacity factor 0.5", "olmoe-1b-7b", SERVE_BATCH * SERVE_PROMPT, 0.5,
     "bfloat16", False, False),
    ("olmoe-1b-7b prefill, expert 0 without tokens", "olmoe-1b-7b", SERVE_BATCH * SERVE_PROMPT,
     None, "bfloat16", True, False),
    ("d 2050 (scalar route)", (8, 64, 2050), 1024, 1.25, "bfloat16", False, False),
)
B2_ROUTE_LAYERS, B2_ROUTE_DECODE = 2, 8        # moe_routes: olmoe cut to 2 layers, 8 decode steps
# B2's adjoints are checked at every case and timed at these, the training
# shape first (its kernels line entry)
B2_BWD_TIMED = ("olmoe-1b-7b train", "olmoe-1b-7b prefill", "kimi-k2-1t-a32b prefill",
                "jamba-1.5-large-398b prefill")
# bytes of the route table a kernel reads: the combine a route's dest (int32)
# and gate (f32), the fill a route's dest and an expert's kept count (int32)
B2_COMBINE_ROUTE_BYTES, B2_FILL_ROUTE_BYTES, B2_KEPT_BYTES = 4 + 4, 4, 4


def b2_inputs(case, gen):
    """A case's plan, route table and inputs on the card: random router
    scores, top-k, gates normalised as ``router_topk`` does; rows (T, D)
    and the experts' output y (E, C, D) ~ N(0, 1) in the case's dtype."""
    import torch
    from repro_torch.configs import get_config
    moe = importlib.import_module("repro_torch.models.moe")
    label, arch, t, cf, dtype, empty, _ = case
    if isinstance(arch, str):
        cfg = get_config(arch)
        k, e, d = cfg.experts_per_token, cfg.num_experts, cfg.d_model
        cf = cfg.capacity_factor if cf is None else cf
    else:
        k, e, d = arch
    dev = torch.device("cuda")
    scores = torch.rand((t, e), generator=gen, device=dev)
    if empty:
        scores[:, 0] = -1.0
    gates, idx = torch.topk(scores, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    cap = moe.capacity(t, k, e, cf)
    plan = moe.dispatch_plan(idx, e, cap)
    tdt = getattr(torch, dtype)
    rows = torch.randn((t, d), generator=gen, device=dev).to(tdt)
    y = torch.randn((e, cap, d), generator=gen, device=dev).to(tdt)
    return dict(t=t, k=k, e=e, d=d, cap=cap, plan=plan, routes=moe.route_table(plan, gates, cap),
                rows=rows, y=y)


def b2_bounds(inp) -> dict:
    """Least time for each function's work on these inputs, by bytes (their
    operations, a multiply and an add an element, are ~1e-3 of it): the
    fill writes the buffer, reads the row of each token with a kept
    assignment once and the table's dest and kept counts; the combine
    reads each kept assignment's row of y and each route's dest and gate,
    and writes the output."""
    import torch
    routes, rows, y = inp["routes"], inp["rows"], inp["y"]
    elt, d, n = rows.element_size(), inp["d"], routes.dest.numel()
    kept_routes = routes.dest >= 0
    used = int(kept_routes.any(dim=1).sum())
    fill_bytes = (inp["e"] * inp["cap"] * d * elt + used * d * elt + n * B2_FILL_ROUTE_BYTES
                  + inp["e"] * B2_KEPT_BYTES)
    kept = int(kept_routes.sum())
    comb_bytes = (kept * d * y.element_size() + n * B2_COMBINE_ROUTE_BYTES
                  + inp["t"] * d * y.element_size())
    comb_flops = 2 * n * d
    peak = PEAK_F32_FLOPS
    out = {}
    for name, nbytes, flops in (("fill", fill_bytes, 0), ("combine", comb_bytes, comb_flops)):
        by_bytes, by_ops = nbytes / PEAK_BYTES, flops / peak
        out[name] = dict(bytes=nbytes, bound_ms=max(by_bytes, by_ops) * 1e3,
                         bound_by="bytes" if by_bytes >= by_ops else "operations")
    out["rows_read"], out["kept"], out["dropped"] = used, kept, n - kept
    return out


def b2_bwd_bounds(inp) -> dict:
    """Least time for each adjoint's work on these inputs, by bytes: the
    fill's adjoint reads each kept route's row of the buffer's gradient and
    the table's dest and writes T·D; the combine's adjoint writes dy
    (E·C·D) and dgate, reads grad_out (T·D), each kept route's row of y,
    the table's dest and gate and the kept counts. Their operations (an
    add an element; two products and an add) are counted against the f32
    peak."""
    routes, y = inp["routes"], inp["y"]
    elt, d, n, t = y.element_size(), inp["d"], routes.dest.numel(), inp["t"]
    kept = int((routes.dest >= 0).sum())
    fill = (kept * d * elt + t * d * elt + n * B2_FILL_ROUTE_BYTES, kept * d)
    comb = (inp["e"] * inp["cap"] * d * elt + t * d * elt + kept * d * elt
            + n * B2_COMBINE_ROUTE_BYTES + inp["e"] * B2_KEPT_BYTES + n * 4, 3 * kept * d)
    out = {}
    for name, (nbytes, flops) in (("moe_fill_bwd", fill), ("moe_combine_bwd", comb)):
        by_bytes, by_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
        out[name] = dict(bytes=nbytes, bound_ms=max(by_bytes, by_ops) * 1e3,
                         bound_by="bytes" if by_bytes >= by_ops else "operations")
    return out


def b2_dgate_close(got, want, grad_out, y, dest) -> bool:
    """The combine adjoint's dgate against the plain one's, which differ by
    the order of an f32 sum over D: in bf16 within one bf16 ulp of the
    plain value, plus 4e-6 of the sum of the products' magnitudes (where
    the dot cancels to near zero an ulp of the small result is less than
    the f32 order's difference); in f32 within 1e-5 of the largest |dgate|."""
    import torch
    if y.dtype == torch.float32:
        return bool(((got - want).abs() <= 1e-5 * float(want.abs().max())).all())
    e, cap, d = y.shape
    rows = y.reshape(e * cap, d)[torch.where(dest >= 0, dest, 0).long()]
    mag = (grad_out[:, None, :] * rows).abs().float().sum(dim=-1)
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
    return bool(((got - want).abs() <= ulp + 4e-6 * mag).all())


def check_moe_dispatch_bwd(inp, label: str, gen, smi: str) -> dict:
    """B2's adjoints at one case of ``B2_CASES``: ``moe_fill_bwd`` and
    ``moe_combine_bwd`` against ``moe_fill_bwd_plain`` and
    ``moe_combine_bwd_plain`` on the same table and N(0, 1) gradients, one
    launch each on the route the width gives: dx and dy bits equal, dgate
    within ``b2_dgate_close``, a dropped route's dgate +0.0; the fill's
    adjoint also within ``TOL`` of ``F.embedding_bag`` (sum, a dropped
    route at the padding index of a zero row appended to the buffer's
    gradient). At ``B2_BWD_TIMED`` both timed in turns with the plain
    versions and that library call (the combine's adjoint has none: no one
    PyTorch call writes dy and dgate), beside the bound by bytes, with each
    kernel's own device time and each call's host µs. Returns the timed
    entries (empty elsewhere) and each adjoint's largest error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_dispatch import (ROUTES as B2_ROUTES, moe_combine_bwd,
                                                  moe_combine_bwd_plain, moe_fill_bwd,
                                                  moe_fill_bwd_plain)
    t, k, d, e, cap = inp["t"], inp["k"], inp["d"], inp["e"], inp["cap"]
    routes, y = inp["routes"], inp["y"]
    dest, kept, gate = routes.dest, routes.kept, routes.gate
    grad_buf = torch.randn((e, cap, d), generator=gen, device=y.device).to(y.dtype)
    grad_out = torch.randn((t, d), generator=gen, device=y.device).to(y.dtype)
    gpad = torch.cat([grad_buf.reshape(e * cap, d), grad_buf.new_zeros((1, d))])
    bag = torch.where(dest >= 0, dest, e * cap).long()

    def fill_k():
        return moe_fill_bwd(grad_buf, dest)

    def fill_p():
        return moe_fill_bwd_plain(grad_buf, dest)

    def fill_l():
        return F.embedding_bag(bag, gpad, mode="sum", padding_idx=e * cap)

    def comb_k():
        return moe_combine_bwd(grad_out, y, dest, gate, kept)

    def comb_p():
        return moe_combine_bwd_plain(grad_out, y, dest, gate)

    route = "vector" if d * y.element_size() % 16 == 0 else "scalar"
    want_took = {r: int(r == route) for r in B2_ROUTES}
    took = {}
    for name, fn, call in (("moe_fill_bwd", moe_fill_bwd, fill_k),
                           ("moe_combine_bwd", moe_combine_bwd, comb_k)):
        before = (fn.launches, dict(fn.launches_by_route))
        got = call()
        took[name] = (fn.launches - before[0],
                      {r: fn.launches_by_route[r] - before[1][r] for r in B2_ROUTES})
        if name == "moe_fill_bwd":
            dx = got
        else:
            dy, dgate = got
    want_dx = fill_p()
    want_dy, want_dgate = comb_p()
    torch.cuda.synchronize()
    dropped = dest < 0
    lib = fill_l().float()
    record = {"phase": "kernel_check", "kernel": "moe_dispatch_bwd", "case": label,
              "dtype": str(y.dtype).split(".")[1], "tokens": t, "k": k, "experts": e, "d": d,
              "capacity": cap, "kept": int((~dropped).sum()), "dropped": int(dropped.sum()),
              "moe_fill_bwd": {
                  "bits_equal": bool(torch.equal(bits(dx), bits(want_dx))),
                  "max_abs_err": float((dx.float() - want_dx.float()).abs().max()),
                  "launches": took["moe_fill_bwd"][1], "want_launches": want_took,
                  "library_max_abs_err": float((lib - want_dx.float()).abs().max()),
                  "library_close": bool(torch.allclose(lib, want_dx.float(),
                                                       **TOL[str(y.dtype).split(".")[1]]))},
              "moe_combine_bwd": {
                  "dy_bits_equal": bool(torch.equal(bits(dy), bits(want_dy))),
                  "dy_max_abs_err": float((dy.float() - want_dy.float()).abs().max()),
                  "dgate_close": b2_dgate_close(dgate, want_dgate, grad_out, y, dest),
                  "dgate_max_abs_err": float((dgate - want_dgate).abs().max()),
                  "dgate_max_abs": float(want_dgate.abs().max()),
                  "dropped_dgate_zero": bool(not dgate[dropped].any()
                                             and not torch.signbit(dgate[dropped]).any()),
                  "launches": took["moe_combine_bwd"][1], "want_launches": want_took}}
    f, c = record["moe_fill_bwd"], record["moe_combine_bwd"]
    record["ok"] = (f["bits_equal"] and f["library_close"] and c["dy_bits_equal"]
                    and c["dgate_close"] and c["dropped_dgate_zero"]
                    and all(took[n] == (1, want_took) for n in took))
    emit(record)
    if not record["ok"]:
        raise AssertionError(f"moe_dispatch_bwd differs from its plain version ({label}): "
                             f"{record}")
    errs = {"moe_fill_bwd": f["max_abs_err"], "moe_combine_bwd": c["dgate_max_abs_err"]}
    del dx, dy, dgate, want_dx, want_dy, want_dgate, lib
    timed = {}
    if label in B2_BWD_TIMED:
        iters = {"kernel": 20, "plain": 5, "library": 20}
        bounds = b2_bwd_bounds(inp)
        row = {"phase": "kernel_time", "kernel": "moe_dispatch_bwd", "path": label,
               "dtype": record["dtype"], "tokens": t, "k": k, "experts": e, "d": d,
               "capacity": cap, "kept": record["kept"], "dropped": record["dropped"], "smi": smi}
        for name, contenders in (
                ("moe_fill_bwd", {"kernel": fill_k, "plain": fill_p, "library": fill_l}),
                ("moe_combine_bwd", {"kernel": comb_k, "plain": comb_p})):
            b, t = bounds[name], timed_in_turns(contenders, iters, {B2_BWD_KERNELS[name]: 1}, 20)
            entry = dict(**t, bound_ms=b["bound_ms"], bound_by=b["bound_by"], bytes=b["bytes"],
                         tb_per_s=b["bytes"] / t["ms"] / 1e9,
                         share_of_bound=b["bound_ms"] / t["ms"],
                         kernel_share_of_bound=b["bound_ms"] / t["kernel_device_ms"])
            row[name] = entry
            timed[name] = {k_: entry[k_] for k_ in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
                "share_of_bound", "host_us")}
        row["library"] = {"moe_fill_bwd": "F.embedding_bag, sum, a dropped route at the "
                                          "padding index of a zero row",
                          "moe_combine_bwd": None}
        emit(row)
    del grad_buf, grad_out, gpad, bag
    return {"timed": timed, "errs": errs}


def check_moe_dispatch(gen, smi: str) -> dict:
    """B2's fill and combine against ``moe_fill_plain`` and
    ``moe_combine_plain`` on the same route table, bits equal, one launch
    each on the route the width gives, at ``B2_CASES``; the fill also against
    ``torch.index_select`` over the rows with a zero row appended (each
    slot's token, a scatter of the table), and the combine within ``TOL``
    of ``F.embedding_bag`` (sum, the gates as per-sample weights, a dropped
    route at the padding index of a zero row appended to y): the library
    calls that compute them, built from the table the kernels read, the
    second adding in its own order, their tables built outside the timed
    call. Then the timed cases in turns (kernel, plain, library, then back;
    CUDA events), each beside its bound, with the kernels' own device time
    (``kernel_split``) and each call's host µs (``host_ms_per_call``, the
    least of two turns: the launch enqueued, nothing synchronised). Returns
    the kernels line's entries, olmoe's prefill shape first."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_dispatch import (ROUTES as B2_ROUTES, moe_combine,
                                                  moe_combine_plain, moe_fill, moe_fill_plain)

    def route_of(d, a):
        return "vector" if d * a.element_size() % 16 == 0 else "scalar"

    out = {name: {} for name in B2 + B2_BWD}
    worst = dict.fromkeys(B2 + B2_BWD, 0.0)
    for case in B2_CASES:
        label, timed = case[0], case[6]
        inp = b2_inputs(case, gen)
        t, k, d, e, cap = inp["t"], inp["k"], inp["d"], inp["e"], inp["cap"]
        routes, rows, y = inp["routes"], inp["rows"], inp["y"]
        dest, kept, gate = routes.dest, routes.kept, routes.gate
        padded = torch.cat([rows, rows.new_zeros((1, d))])
        live = dest >= 0
        src = torch.full((e * cap,), t, dtype=torch.long, device=y.device)
        src[dest[live].long()] = torch.arange(t, device=y.device)[:, None].expand(t, k)[live]
        ypad = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
        bag = torch.where(live, dest, e * cap).long()
        bag_gate = gate.to(y.dtype)

        def fill_k():
            return moe_fill(rows, dest, kept, cap)

        def fill_p():
            return moe_fill_plain(rows, dest, kept, cap)

        def fill_l():
            return torch.index_select(padded, 0, src)

        def comb_k():
            return moe_combine(y, dest, gate)

        def comb_p():
            return moe_combine_plain(y, dest, gate)

        def comb_l():
            return F.embedding_bag(bag, ypad, mode="sum", per_sample_weights=bag_gate,
                                   padding_idx=e * cap)

        record = {"phase": "kernel_check", "kernel": "moe_dispatch", "case": label,
                  "dtype": str(rows.dtype).split(".")[1], "tokens": t, "k": k,
                  "experts": e, "d": d, "capacity": cap,
                  "kept": int(live.sum()), "dropped": int((~live).sum()),
                  "empty_experts": int((kept == 0).sum()),
                  "tokens_all_dropped": int((~live).all(dim=1).sum())}
        ok = True
        for name, fk, fp, fn in (("moe_fill", fill_k, fill_p, moe_fill),
                                 ("moe_combine", comb_k, comb_p, moe_combine)):
            before = (fn.launches, dict(fn.launches_by_route))
            got = fk()
            took = {r: fn.launches_by_route[r] - before[1][r] for r in B2_ROUTES}
            want = fp()
            torch.cuda.synchronize()
            equal = got.shape == want.shape and bool(torch.equal(bits(got), bits(want)))
            err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
            worst[name] = max(worst[name], err)
            want_took = {r: int(r == route_of(d, rows)) for r in B2_ROUTES}
            record[name] = {"bits_equal": equal, "max_abs_err": err, "launches": took,
                            "want_launches": want_took}
            ok = ok and equal and took == want_took and fn.launches - before[0] == 1
            del got, want
        lib_equal = bool(torch.equal(bits(fill_l()).view(bits(fill_p()).shape), bits(fill_p())))
        record["moe_fill"]["library_bits_equal"] = lib_equal
        lib_c, want_c = comb_l().float(), comb_p().float()
        lib_close = bool(torch.allclose(lib_c, want_c, **TOL[record["dtype"]]))
        record["moe_combine"]["library_max_abs_err"] = (
            float((lib_c - want_c).abs().max()) if want_c.numel() else 0.0)
        record["moe_combine"]["library_close"] = lib_close
        del lib_c, want_c
        record["ok"] = ok and lib_equal and lib_close
        emit(record)
        if not record["ok"]:
            raise AssertionError(f"moe_dispatch differs from its plain version ({label}): "
                                 f"{record}")
        bwd = check_moe_dispatch_bwd(inp, label, gen, smi)
        for name in B2_BWD:
            worst[name] = max(worst[name], bwd["errs"][name])
            if name in bwd["timed"]:
                out[name][label] = bwd["timed"][name]
        if timed:
            prefill = t > SERVE_BATCH
            iters = {"kernel": 20 if prefill else 200, "plain": 5 if prefill else 100,
                     "library": 20 if prefill else 200}
            host_calls = 20 if prefill else 200
            bounds = b2_bounds(inp)
            row = {"phase": "kernel_time", "kernel": "moe_dispatch", "path": label,
                   "dtype": record["dtype"], "tokens": t, "k": k, "experts": e, "d": d,
                   "capacity": cap, "rows_read": bounds["rows_read"],
                   "kept": bounds["kept"], "dropped": bounds["dropped"], "smi": smi}
            for name, contenders in (
                    ("moe_fill", {"kernel": fill_k, "plain": fill_p, "library": fill_l}),
                    ("moe_combine", {"kernel": comb_k, "plain": comb_p, "library": comb_l})):
                b = bounds["fill" if name == "moe_fill" else "combine"]
                t = timed_in_turns(contenders, iters, {B2_KERNELS[name][0]: 1}, host_calls)
                entry = dict(**t, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                             bytes=b["bytes"], tb_per_s=b["bytes"] / t["ms"] / 1e9,
                             share_of_bound=b["bound_ms"] / t["ms"],
                             kernel_share_of_bound=b["bound_ms"] / t["kernel_device_ms"])
                row[name] = entry
                out[name][label] = {k_: entry[k_] for k_ in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
                    "share_of_bound", "host_us")}
            row["library"] = {"moe_fill": "torch.index_select over the rows with a zero row",
                              "moe_combine": "F.embedding_bag, sum, the gates as per-sample "
                                             "weights, y with a zero row at the padding index"}
            emit(row)
        del inp, routes, rows, y, dest, kept, gate, padded, src, ypad, bag, bag_gate, live
        gc.collect()
        torch.cuda.empty_cache()
    result = {}
    for name in ("moe_fill", "moe_combine"):
        first = out[name].pop(B2_CASES[0][0])
        result[name] = dict(max_abs_err=worst[name], **first, path=B2_CASES[0][0],
                            served_shapes=out[name],
                            library_layout=("torch.index_select, a zero row appended"
                                            if name == "moe_fill" else
                                            "F.embedding_bag (sum, per-sample gates, a zero row "
                                            "at the padding index); adds in its own order"))
    for name in B2_BWD:
        first = out[name].pop(B2_BWD_TIMED[0])
        result[name] = dict(max_abs_err=worst[name], **first, path=B2_BWD_TIMED[0],
                            other_shapes=out[name],
                            library_layout=("F.embedding_bag (sum, a zero row at the padding "
                                            "index); adds in its own order"
                                            if name == "moe_fill_bwd" else
                                            "none: no one PyTorch call writes dy and dgate"))
    return result


def moe_route_check(smi: str, counters: dict) -> None:
    """olmoe-1b-7b at full width cut to ``B2_ROUTE_LAYERS`` layers, bf16,
    random weights from seed 0: ``generate`` of 4 requests of 1024 prompt
    tokens and ``B2_ROUTE_DECODE`` greedy tokens with B2's kernels, with
    their plain versions in their place (``ops.moe_fill``,
    ``ops.moe_combine``), and with the kernels again. Prefill and last
    logits and every id must be equal bit for bit under both routes (and
    the kernels' two runs); the kernel runs launch each kernel once a
    layer per forward, all on the ``vector`` route, the plain run never."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = cut_config(get_config(MOE_MESH_ARCH), {"num_layers": B2_ROUTE_LAYERS})
    model = init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                           device=dev)

    def run(plain: bool):
        zero_counts(counters)
        with b2_plain() if plain else contextlib.nullcontext():
            res = generate(model, tokens, B2_ROUTE_DECODE)
        torch.cuda.synchronize()
        counted = read_counts(counters)
        return res, counted

    def same(a, b):
        return (torch.equal(a.prefill_logits.view(torch.int16), b.prefill_logits.view(torch.int16))
                and torch.equal(a.last_logits.view(torch.int16), b.last_logits.view(torch.int16))
                and torch.equal(a.ids, b.ids))
    t0 = time.perf_counter()
    kernel, kernel_counts = run(False)
    plain, plain_counts = run(True)
    again, _ = run(False)
    want = expected_launches(cfg, B2_ROUTE_DECODE)
    want_routes = {k: {"vector": want[k], "scalar": 0} for k in B2}
    ok = (same(kernel, plain) and same(kernel, again)
          and kernel_counts["launches"] == want
          and {k: kernel_counts["routes"][k] for k in want_routes} == want_routes
          and plain_counts["launches"] == {**want, "moe_fill": 0, "moe_combine": 0}
          and bool(torch.isfinite(kernel.prefill_logits).all()))
    emit({"phase": "moe_routes", "arch": cfg.name, "layers": cfg.num_layers,
          "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "decode_steps": B2_ROUTE_DECODE,
          "logits_and_ids_equal": same(kernel, plain), "kernel_twice_equal": same(kernel, again),
          "launches": kernel_counts["launches"], "routes": {
              k: kernel_counts["routes"][k] for k in want_routes},
          "plain_launches": plain_counts["launches"], "want_launches": want,
          "sample_ids": kernel.ids[0, :8].tolist(), "seconds": time.perf_counter() - t0,
          "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"moe routes: kernels and plain differ or launches "
                             f"{kernel_counts} / {plain_counts} (want {want})")
    del model, kernel, plain, again
    gc.collect()
    torch.cuda.empty_cache()


# B4 and B5's checks on the card (``check_norm_conv``), each against its
# plain version. (label, dtype, rows (B, S), width): the plain form at the
# widths the paths give it, the q/k norms' 128 over qwen3-14b's 40 heads,
# phi4-mini's 3072, mamba2/olmoe's 2048, qwen3's 5120, llama-vision's 4096,
# whisper's 1024, kimi-k2's 7168, jamba's 8192, the f32 demo's 512
NORM_CHECKS = (("qk_norm", "bfloat16", (4, 1024 * 40), 128),
               ("olmoe-1b-7b q/k", "bfloat16", (4, 1024 * 16), 128),
               ("phi4-mini-3.8b", "bfloat16", (4, 1024), 3072),
               ("mamba2-1.3b", "bfloat16", (4, 1024), 2048),
               ("qwen3-14b", "bfloat16", (4, 1024), 5120),
               ("llama-3.2-vision-11b", "bfloat16", (4, 1024), 4096),
               ("whisper-medium", "bfloat16", (4, 1024), 1024),
               ("kimi-k2-1t-a32b", "bfloat16", (4, 1024), 7168),
               ("jamba-1.5-large-398b", "bfloat16", (4, 1024), 8192),
               ("demo-100m", "float32", (8, 128), 512))
# the gated form (label, dtype, (B, S), H, P) and B5 (label, dtype, (B, S),
# C, the projection's width, with a state): mamba2-1.3b's training shape,
# jamba's d_inner 16384 (conv 16640), mamba2's decode step (y f32, the
# cache's state), and mamba2 in f32
GATED_CHECKS = (("mamba2-1.3b", "bfloat16", (4, 1024), 64, 64),
                ("jamba-1.5-large-398b", "bfloat16", (4, 1024), 256, 64),
                ("mamba2-1.3b decode", "bfloat16", (4, 1), 64, 64),
                ("mamba2-1.3b f32", "float32", (4, 1024), 64, 64))
CONV_CHECKS = (("mamba2-1.3b", "bfloat16", (4, 1024), 4352, 8512, False),
               ("jamba-1.5-large-398b", "bfloat16", (4, 1024), 16640, 33280, False),
               ("mamba2-1.3b decode", "bfloat16", (4, 1), 4352, 8512, True),
               ("mamba2-1.3b f32", "float32", (4, 1024), 4352, 8512, False))
# the timed shapes: mamba2-1.3b's training shape for the gated form, B5 and
# the plain form at 2048 (its ln1), phi4-mini's plain form at 3072 and
# olmoe-1b-7b's q/k norms (16 heads of 128 over 4 x 1024 tokens); B5's
# forward also at jamba's shape and mamba2's decode step
NORM_TIMED = ("mamba2-1.3b", "phi4-mini-3.8b", "olmoe-1b-7b q/k")
CONV_TIMED = NORM_TIMED + ("jamba-1.5-large-398b", "mamba2-1.3b decode")


def norm_adj_tol(dtype: str, n: int) -> float:
    """The limit on an adjoint's ``rel_norm`` against its plain version for a
    gradient of ``n`` elements. Both compute in f32 and differ only in the
    order of their sums. f32: 1e-5. bf16: each output is rounded once, and
    an f32 order difference moves a value across a rounding boundary now
    and then, one ulp (2^-8..2^-7 of it); the sound kernels read 0 to
    7.1e-5 at the checked shapes (on an H100, ``check_norm_conv``), and the plain
    adjoints with their arithmetic narrowed to bf16 (``narrow_adjoints``,
    the control) read ~4e-3 on every output. The limit is 2e-4, a few
    times the largest sound reading, raised to 2^-6 / sqrt(n) for short
    vectors (a scale's or D's gradient of 64 to 4096 elements), where a
    couple of one-ulp roundings of typical elements alone reach that; the
    control stays beyond it at every checked size."""
    return 1e-5 if dtype == "float32" else max(2e-4, 2.0 ** -6 / n ** 0.5)


@contextlib.contextmanager
def narrow_adjoints():
    """The control of ``norm_adj_tol``: B4's and B5's plain adjoints with
    their f32 arithmetic narrowed to their inputs' dtype (dn, dx, dpre and
    the products the column sums add, rounded to bf16), what an adjoint
    that kept them in bf16 would compute."""
    from repro_torch.kernels import causal_conv, rms_norm
    with mock.patch.object(rms_norm, "_wide", lambda dt: dt), \
            mock.patch.object(causal_conv, "_wide", lambda dt: dt):
        yield


def adjoint_readings(names, grads, wants, dtype: str, plain_bwd) -> dict:
    """Each named gradient (None where absent) against its plain version:
    its ``rel_norm`` and limit, in bf16 also the control's reading
    (``plain_bwd()`` under ``narrow_adjoints``); ``ok`` where every reading
    is within its limit and every control reading beyond it."""
    live = [i for i, a in enumerate(grads) if a is not None]
    errs = {names[i]: rel_norm(grads[i], wants[i]) for i in live}
    limits = {names[i]: norm_adj_tol(dtype, wants[i].numel()) for i in live}
    control = {}
    if dtype != "float32":
        with narrow_adjoints():
            narrow = plain_bwd()
        control = {names[i]: rel_norm(narrow[i], wants[i]) for i in live}
    ok = (all(errs[n] <= limits[n] for n in errs)
          and all(control[n] > limits[n] for n in control))
    return {"adjoint_rel_err": errs, "adjoint_tol": limits, "bf16_control_rel_err": control,
            "ok": ok}
# calls a timing of each contender (the plain chains, some 10-40 times the
# kernels' time, a quarter as many)
NC_ITERS = {"kernel": 50, "plain": 12, "library": 50}


def nc_bound(nbytes: int, flops: int) -> dict:
    """The least time for ``nbytes`` moved and ``flops`` f32 operations."""
    by_bytes, by_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return dict(bytes=nbytes, flops=flops, bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def nc_statistic(got, rstd, want, want_rstd, normed, scale) -> dict:
    """B4's forward against the plain one. The kernel sums a row's squares in
    its own order and rounds the rest as the eager chain does, so its output
    must equal the eager chain's at the kernel's own rstd bit for bit on
    every row (``normed``: what the norm takes, x or the gated product), the
    rows whose rstd equals the plain one must equal the plain output bit for
    bit, and the rstd must lie within 1e-5 of the plain one (relative);
    reported: the share of rows with equal rstd and the largest distance
    elsewhere in ulps of the dtype."""
    import torch
    again = (normed.float() * rstd[..., None]).to(got.dtype) * scale
    chain = bool(torch.equal(bits(got), bits(again.contiguous())))
    rstd_rel = float(((rstd - want_rstd).abs() / want_rstd).max())
    same = (rstd == want_rstd).reshape(-1)
    g, w = got.reshape(same.numel(), -1).float(), want.reshape(same.numel(), -1).float()
    eq = bool(torch.equal(bits(got).reshape(same.numel(), -1)[same],
                          bits(want).reshape(same.numel(), -1)[same]))
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - (8 if got.dtype == torch.bfloat16 else 24))
    off = (float(((g - w).abs() / ulp.clamp_min(torch.finfo(want.dtype).tiny))[~same].max())
           if (~same).any() else 0.0)
    return {"rows_same_rstd": float(same.float().mean()), "equal_where_same": eq,
            "chain_at_kernel_rstd_bits_equal": chain, "rstd_max_rel_diff": rstd_rel,
            "max_ulps_elsewhere": off, "max_abs_err": float((g - w).abs().max()),
            "ok": eq and chain and rstd_rel <= 1e-5}


def silu_check(cc) -> None:
    """The staged forward's SiLU (a fast form, the exact chain near bf16
    rounding boundaries) against ``F.silu`` on each of the 65,536 bf16 bit
    patterns as a pre-activation: w's last tap 1, the others and the bias 0,
    so the pre-activation is x itself. Width 1 takes every pattern, width 4
    the finite ones (a zero tap times an infinity is NaN). Every output must
    equal the plain version's bit for bit, NaN where it is NaN."""
    import torch
    pats = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    result = {}
    for width in (1, 4):
        x = (pats if width == 1 else torch.where(torch.isfinite(pats), pats,
                                                 torch.zeros_like(pats)))
        x = x.reshape(1, 256, 256).cuda()
        w = torch.zeros((width, 256), dtype=torch.bfloat16, device="cuda")
        w[-1] = 1
        bias = torch.zeros(256, dtype=torch.bfloat16, device="cuda")
        before = dict(cc.causal_conv1d_fwd.launches_by_route)
        out, _ = cc.causal_conv1d_fwd(x, w, bias)
        routes = {r: n - before[r] for r, n in cc.causal_conv1d_fwd.launches_by_route.items()}
        want, _ = cc.causal_conv1d_plain(x, w, bias)
        nan = torch.isnan(want)
        same = (bool(torch.equal(torch.isnan(out), nan))
                and bool(torch.equal(bits(out)[~nan], bits(want)[~nan])))
        result[width] = {"routes": routes, "inputs": int(x.numel()),
                         "differing": int((bits(out) != bits(want))[~nan].sum()), "ok": same}
    ok = all(r["ok"] and r["routes"]["staged"] == 1 for r in result.values())
    emit({"phase": "kernel_check", "kernel": "causal_conv1d_fwd silu", "widths": result,
          "ok": ok})
    if not ok:
        raise AssertionError(f"causal_conv1d_fwd's SiLU differs from F.silu: {result}")


def check_norm_conv(gen, smi: str) -> dict:
    """B4 (``rms_norm_fwd``, ``gated_rms_norm_fwd`` and their adjoints) and
    B5 (``causal_conv1d_fwd`` and its adjoint) against their plain versions
    on the card, one launch each on the ``vector`` route, at the shapes the
    paths give them (``NORM_CHECKS``, ``GATED_CHECKS``, ``CONV_CHECKS``): the
    gated form's y in the SSD kernel's (B, H, S, P) layout, xh and z inside
    the convolution's output and the projection, the convolution's x the
    projection's x|B|C columns. B5's forward and new state equal bit for
    bit; B4's forward by ``nc_statistic``; the adjoints within
    ``norm_adj_tol`` (relative error of the difference's norm), the bf16
    control beyond it (``adjoint_readings``). Then the
    ``NORM_TIMED`` shapes in turns with the plain versions and, for the
    plain form's forward,
    ``F.rms_norm`` (a yardstick never on the path: it scales before it
    casts, one rounding fewer), each beside its bound by bytes, with the
    kernels' own device time, each call's host µs and, for the adjoints,
    each kernel's registers and local memory (spills included) and the
    blocks an SM holds, as the runtime reports them. B5's staged adjoint
    recomputes the pre-activation with packed bf16 products and sums: it
    must equal the plain chain's bit for bit (``conv_preactivation``), and
    its SiLU the forward's output. Returns the kernels line's entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import rms_norm as rn

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def took(fn, before):
        return {r: fn.launches_by_route[r] - before[r] for r in fn.launches_by_route}

    one = {"vector": 1, "scalar": 0}
    worst = dict.fromkeys(NORM_CONV, 0.0)
    timed = {}
    for label, dt, (b, s), d in NORM_CHECKS:
        dtype = getattr(torch, dt)
        x, scale = randn((b, s, d), dtype), randn((d,), dtype, 0.5) + 1
        g = randn((b, s, d), dtype)
        before = dict(rn.rms_norm_fwd.launches_by_route)
        out, rstd = rn.rms_norm_fwd(x, scale, 1e-5, keep_rstd=True)
        fwd_took = took(rn.rms_norm_fwd, before)
        want, want_rstd = rn.rms_norm_fwd_plain(x, scale, 1e-5, keep_rstd=True)
        stat = nc_statistic(out, rstd, want, want_rstd, x, scale)
        before = dict(rn.rms_norm_bwd.launches_by_route)
        dx, ds = rn.rms_norm_bwd(g, x, scale, rstd)
        bwd_took = took(rn.rms_norm_bwd, before)
        wdx, wds = rn.rms_norm_bwd_plain(g, x, scale, rstd)
        adj = adjoint_readings(("dx", "dscale"), (dx, ds), (wdx, wds), dt,
                               lambda: rn.rms_norm_bwd_plain(g, x, scale, rstd))
        torch.cuda.synchronize()
        ok = stat["ok"] and fwd_took == one and bwd_took == one and adj.pop("ok")
        worst["rms_norm_fwd"] = max(worst["rms_norm_fwd"], stat["max_abs_err"])
        worst["rms_norm_bwd"] = max(worst["rms_norm_bwd"],
                                    float((dx.float() - wdx.float()).abs().max()))
        emit({"phase": "kernel_check", "kernel": "rms_norm", "path": label, "dtype": dt,
              "rows": b * s, "d": d, "forward": stat, **adj,
              "launches": {"fwd": fwd_took, "bwd": bwd_took}, "ok": ok})
        if not ok:
            raise AssertionError(f"rms_norm differs from its plain version at {label}: "
                                 f"{stat}, {adj}, launches {fwd_took} {bwd_took}")
        if label in NORM_TIMED:
            timed[label] = (x, scale, g, rstd)
        del out, rstd, want, want_rstd, dx, ds, wdx, wds
    gated = {}
    for label, dt, (b, s), h, p in GATED_CHECKS:
        dtype, d = getattr(torch, dt), h * p
        decode = s == 1
        y = (randn((b, h, p), torch.float32)[:, None] if decode
             else randn((b, h, s, p), dtype).transpose(1, 2))
        xh = randn((b, s, d + 256), dtype)[..., :d].reshape(b, s, h, p)
        z = randn((b, s, 2 * d + 320), dtype)[..., :d]
        D, scale = randn((h,), torch.float32), randn((d,), dtype, 0.5) + 1
        before = dict(rn.gated_rms_norm_fwd.launches_by_route)
        out, rstd = rn.gated_rms_norm_fwd(y, xh, D, z, scale, 1e-5, keep_rstd=True)
        fwd_took = took(rn.gated_rms_norm_fwd, before)
        want, want_rstd = rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5, keep_rstd=True)
        stat = nc_statistic(out, rstd, want, want_rstd, rn.gated_product_plain(y, xh, D, z),
                            scale)
        adj, bwd_took, in_y_layout = {"ok": True}, one, True
        if not decode:
            g = randn((b, s, d), dtype)
            before = dict(rn.gated_rms_norm_bwd.launches_by_route)
            grads = rn.gated_rms_norm_bwd(g, y, xh, D, z, scale, rstd)
            bwd_took = took(rn.gated_rms_norm_bwd, before)
            wants = rn.gated_rms_norm_bwd_plain(g, y, xh, D, z, scale, rstd)
            adj = adjoint_readings(("dy", "dxh", "dD", "dz", "dscale"), grads, wants, dt,
                                   lambda: rn.gated_rms_norm_bwd_plain(g, y, xh, D, z, scale,
                                                                       rstd))
            in_y_layout = grads[0].stride() == y.stride()
            worst["gated_rms_norm_bwd"] = max(worst["gated_rms_norm_bwd"], max(
                float((a.float() - w.float()).abs().max()) for a, w in zip(grads, wants)))
            if label in NORM_TIMED:
                gated[label] = (y, xh, D, z, scale, g, rstd)
            del grads, wants
        torch.cuda.synchronize()
        ok = (stat["ok"] and fwd_took == one and bwd_took == one and adj.pop("ok")
              and in_y_layout)
        worst["gated_rms_norm_fwd"] = max(worst["gated_rms_norm_fwd"], stat["max_abs_err"])
        emit({"phase": "kernel_check", "kernel": "gated_rms_norm", "path": label, "dtype": dt,
              "batch": b, "seq": s, "heads": h, "head_dim": p, "y_dtype": str(y.dtype),
              "forward": stat, **adj, "dy_in_y_layout": in_y_layout,
              "launches": {"fwd": fwd_took, "bwd": bwd_took}, "ok": ok})
        if not ok:
            raise AssertionError(f"gated_rms_norm differs from its plain version at {label}: "
                                 f"{stat}, {adj}, launches {fwd_took} {bwd_took}")
        del out, rstd, want, want_rstd
    conv = {}
    for label, dt, (b, s), c, width, with_state in CONV_CHECKS:
        dtype = getattr(torch, dt)
        d_inner = c - 256
        proj = randn((b, s, width), dtype)
        x = proj[..., d_inner:d_inner + c]                  # x|B|C, one slice
        w, bias = randn((4, c), dtype, 0.5), randn((c,), dtype, 0.1)
        state = randn((b, 3, c), dtype) if with_state else None
        before = dict(cc.causal_conv1d_fwd.launches_by_route)
        out, new_state = cc.causal_conv1d_fwd(x, w, bias, state)
        fwd_took = took(cc.causal_conv1d_fwd, before)
        fwd_route = "staged" if s > 1 else "vector"      # a decode step: the register window
        want, want_state = cc.causal_conv1d_plain(x, w, bias, state)
        g = randn((b, s, c), dtype)
        before = dict(cc.causal_conv1d_bwd.launches_by_route)
        grads = cc.causal_conv1d_bwd(g, x, w, bias, state, need_dstate=with_state)
        bwd_took = took(cc.causal_conv1d_bwd, before)
        wants = cc.causal_conv1d_bwd_plain(g, x, w, bias, state, need_dstate=with_state)
        adj = adjoint_readings(("dx", "dw", "db", "dstate"), grads, wants, dt,
                               lambda: cc.causal_conv1d_bwd_plain(g, x, w, bias, state,
                                                                  need_dstate=with_state))
        pre = cc.conv_preactivation(g, x, w, bias, state)
        xin = torch.cat([state if with_state else x.new_zeros((b, 3, c)), x], dim=1)
        want_pre = torch.zeros_like(pre)
        for i in range(4):
            want_pre = want_pre + xin[:, i:i + s] * w[i]
        want_pre = want_pre + bias
        torch.cuda.synchronize()
        same_bits = (bool(torch.equal(bits(out), bits(want)))
                     and bool(torch.equal(bits(new_state), bits(want_state.contiguous()))))
        pre_bits = (bool(torch.equal(bits(pre), bits(want_pre)))
                    and bool(torch.equal(bits(F.silu(pre)), bits(out))))
        ok = (same_bits and pre_bits and bwd_took == one and adj.pop("ok")
              and fwd_took == {r: int(r == fwd_route) for r in cc.FWD_ROUTES})
        worst["causal_conv1d_fwd"] = max(worst["causal_conv1d_fwd"],
                                         float((out.float() - want.float()).abs().max()))
        worst["causal_conv1d_bwd"] = max(worst["causal_conv1d_bwd"], max(
            float((a.float() - wv.float()).abs().max()) for a, wv in zip(grads, wants)
            if a is not None))
        emit({"phase": "kernel_check", "kernel": "causal_conv1d", "path": label, "dtype": dt,
              "batch": b, "seq": s, "channels": c, "row_stride": width, "state": with_state,
              "forward_route": fwd_route, "forward_bits_equal": same_bits,
              "adjoint_preactivation_bits_equal": pre_bits,
              **adj, "launches": {"fwd": fwd_took, "bwd": bwd_took}, "ok": ok})
        if not ok:
            raise AssertionError(f"causal_conv1d differs from its plain version at {label}: "
                                 f"bits {same_bits}, pre {pre_bits}, {adj}, launches {fwd_took} "
                                 f"{bwd_took}")
        if label in CONV_TIMED:
            conv[label] = (x, w, bias, g, state)
        del proj, out, new_state, want, want_state, grads, wants, pre, want_pre, xin
    silu_check(cc)
    gc.collect()
    torch.cuda.empty_cache()

    # timing, in turns
    entries = {name: {} for name in NORM_CONV}

    dev = torch.cuda.current_device()

    def norm_resources(d, dtype, gated):
        """The one-pass adjoint's registers and local memory, and the blocks
        an SM holds (the runtime's occupancy), at width d, 16-byte units."""
        nu, tpr, _ = rn.bwd_plan(d, True, 2 if dtype == torch.bfloat16 else 4, gated)
        mode = rn._mode(True, dtype, dev, gated=gated)
        return dict(rn.bwd_attributes(dtype, gated, dev, nu=nu), threads_a_row=tpr,
                    units_a_thread=nu, blocks_per_sm=rn._bwd_residency(dev, mode, nu, tpr, d))

    def conv_resources(dtype):
        bf16 = dtype == torch.bfloat16
        return dict(cc.bwd_attributes("vector", bf16, 4, dev),
                    blocks_per_sm=cc._residency(dev, "vector", bf16, 4))

    def conv_fwd_resources(dtype, route):
        """The forward kernel's registers and local memory on ``route`` and,
        on the staged route, the blocks an SM holds."""
        bf16 = dtype == torch.bfloat16
        extra = {"blocks_per_sm": cc._fwd_residency(dev, bf16, 4)} if route == "staged" else {}
        return dict(cc.fwd_attributes(route, bf16, 4, dev), route=route, **extra)

    def time_pair(label, shape, dtype, fwd, bwd):
        """The forward and the adjoint of one shape, each (name, contenders,
        kernels a call, bound[, resources]), in turns with their plain
        versions."""
        for name, contenders, split, bound, *resources in (fwd, bwd):
            t = timed_in_turns(contenders, NC_ITERS, split, 100)
            extra = {"resources": resources[0]} if resources else {}
            entries[name][label] = dict(shape=shape, dtype=str(dtype), **t, **bound,
                                        share_of_bound=bound["bound_ms"] / t["ms"], **extra)
    fwd_split, bwd_split = {"rms_norm_fwd_kernel": 1}, {"rms_norm_bwd_kernel": 1,
                                                        "norm_sum_partials": 1}
    for label, (x, scale, g, rstd) in timed.items():
        rows, d, es = x.numel() // x.shape[-1], x.shape[-1], x.element_size()
        n = rows * d
        time_pair(label, [rows, d], x.dtype, (
            "rms_norm_fwd",
            {"kernel": lambda: rn.rms_norm_fwd(x, scale, 1e-5, keep_rstd=True),
             "plain": lambda: rn.rms_norm_fwd_plain(x, scale, 1e-5, keep_rstd=True),
             "library": lambda: F.rms_norm(x, (d,), scale, 1e-5)},
            fwd_split, nc_bound(2 * n * es + d * es + rows * 4, 4 * n)), (
            "rms_norm_bwd",
            {"kernel": lambda: rn.rms_norm_bwd(g, x, scale, rstd),
             "plain": lambda: rn.rms_norm_bwd_plain(g, x, scale, rstd)},
            bwd_split, nc_bound(3 * n * es + d * es + rows * 4 + d * es, 10 * n),
            norm_resources(d, x.dtype, False)))
    for label, (y, xh, D, z, scale, g, rstd) in gated.items():
        (b, s, h, p), d = xh.shape, z.shape[-1]
        n, es = b * s * d, z.element_size()
        time_pair(label, [b, s, h, p], z.dtype, (
            "gated_rms_norm_fwd",
            {"kernel": lambda: rn.gated_rms_norm_fwd(y, xh, D, z, scale, 1e-5, keep_rstd=True),
             "plain": lambda: rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5,
                                                          keep_rstd=True)},
            fwd_split, nc_bound(4 * n * es + d * es + h * 4 + b * s * 4, 12 * n)), (
            "gated_rms_norm_bwd",
            {"kernel": lambda: rn.gated_rms_norm_bwd(g, y, xh, D, z, scale, rstd),
             "plain": lambda: rn.gated_rms_norm_bwd_plain(g, y, xh, D, z, scale, rstd)},
            bwd_split, nc_bound(7 * n * es + d * es + h * 4 + b * s * 4 + d * es + h * 4,
                                40 * n),
            norm_resources(d, z.dtype, True)))
    for label, (x, w, bias, g, state) in conv.items():
        (b, s, c), es = x.shape, x.element_size()
        n = b * s * c
        route = "staged" if s > 1 else "vector"
        # x read and the output written, w and b, the new state written and
        # the old one read where there is one
        fwd = ("causal_conv1d_fwd",
               {"kernel": lambda: cc.causal_conv1d_fwd(x, w, bias, state),
                "plain": lambda: cc.causal_conv1d_plain(x, w, bias, state)},
               {"causal_conv_fwd_kernel" if route == "staged" else
                "causal_conv_fwd_window_kernel": 1},
               nc_bound(2 * n * es + 5 * c * es + (6 if state is not None else 3) * b * c * es,
                        10 * n),
               conv_fwd_resources(x.dtype, route))
        if label not in NORM_TIMED:                # the forward alone at jamba's and decode
            t = timed_in_turns(fwd[1], NC_ITERS, fwd[2], 100)
            entries[fwd[0]][label] = dict(shape=[b, s, c], dtype=str(x.dtype), **t, **fwd[3],
                                          share_of_bound=fwd[3]["bound_ms"] / t["ms"],
                                          resources=fwd[4])
            continue
        time_pair(label, [b, s, c], x.dtype, fwd, (
            "causal_conv1d_bwd",
            {"kernel": lambda: cc.causal_conv1d_bwd(g, x, w, bias),
             "plain": lambda: cc.causal_conv1d_bwd_plain(g, x, w, bias)},
            {"causal_conv_bwd_kernel": 1, "causal_conv_sum_partials": 1},
            nc_bound(3 * n * es + 5 * c * es + 5 * c * es, 30 * n),
            conv_resources(x.dtype)))
    for name, rows in entries.items():
        for label, e in rows.items():
            emit({"phase": "kernel_time", "kernel": name, "path": label, "smi": smi,
                  **{k: v for k, v in e.items()}})
    del timed, gated, conv
    gc.collect()
    torch.cuda.empty_cache()
    libraries = {"rms_norm_fwd": "F.rms_norm (scales in f32 before its one rounding: the "
                                 "reference rounds, then scales)"}
    result = {}
    for name in NORM_CONV:
        first_label = "mamba2-1.3b" if "mamba2-1.3b" in entries[name] else next(iter(entries[name]))
        first = dict(entries[name].pop(first_label))
        extra = ("resources",)
        result[name] = {"max_abs_err": worst[name], "path": first_label,
                        **{k: first[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "kernel_device_ms",
                                                 "share_of_bound", "host_us", "shape") + extra
                           if k in first},
                        "other_shapes": {lb: {k: e[k] for k in (
                            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                            "kernel_device_ms", "share_of_bound", "shape") + extra if k in e}
                            for lb, e in entries[name].items()},
                        "library_layout": libraries.get(name, "none: no one PyTorch call "
                                                              "computes it")}
    return result


# B6, the loss: (label, dtype, (B, S), V): the trained vocabularies at 4 x
# 1024 tokens (phi4-mini-3.8b, mamba2-1.3b, olmoe-1b-7b), the demo's f32,
# the smoke width, and an odd width on the scalar route in both dtypes
LOSS_CHECKS = (("phi4-mini-3.8b", "bfloat16", (4, 1024), 200064),
               ("mamba2-1.3b", "bfloat16", (4, 1024), 50280),
               ("olmoe-1b-7b", "bfloat16", (4, 1024), 50304),
               ("demo-100m", "float32", (8, 128), 32768),
               ("smoke", "bfloat16", (2, 8), 512),
               ("odd width", "bfloat16", (3, 7), 1001),
               ("odd width f32", "float32", (3, 7), 1001))
LOSS_TIMED = ("phi4-mini-3.8b", "mamba2-1.3b", "olmoe-1b-7b", "demo-100m")
# the loss against the plain chain's, relative: both sum the row's exp in
# f32 (the kernel by ex2.approx in its own order), ~1e-7 apart
LOSS_REL_TOL = 1e-5
# B7, RoPE: (label, dtype, B, S, Hq, Hk, hd, theta, positions): phi4's
# training shape, qwen3's prefill, kimi-k2's head_dim 112, a decode step at
# position 1037, whisper's encoder (S 1500, hd 64), the demo's f32, q and k
# one element off 16-byte alignment (the scalar route), int32 positions
ROPE_CHECKS = (("phi4-mini-3.8b train", "bfloat16", 4, 1024, 24, 8, 128, 1e4, "arange"),
               ("qwen3-14b prefill", "bfloat16", 4, 1024, 40, 8, 128, 1e6, "arange"),
               ("kimi-k2 hd 112", "bfloat16", 4, 1024, 64, 8, 112, 5e4, "arange"),
               ("qwen3-14b decode", "bfloat16", 4, 1, 40, 8, 128, 1e6, "decode"),
               ("whisper-medium encoder", "bfloat16", 4, 1500, 16, 16, 64, 1e4, "arange"),
               ("demo-100m", "float32", 8, 128, 8, 2, 64, 1e4, "arange"),
               ("unaligned", "bfloat16", 2, 64, 8, 2, 128, 1e4, "unaligned"),
               ("int32 positions", "bfloat16", 2, 64, 8, 2, 128, 1e4, "int32"))
ROPE_TIMED = ("phi4-mini-3.8b train", "qwen3-14b prefill", "kimi-k2 hd 112",
              "qwen3-14b decode")


def ulps_apart(got, want) -> dict:
    """Elements of ``got`` whose bits differ from ``want``'s, and the largest
    distance in ulps of their dtype (bf16 or f32)."""
    import torch
    differ = bits(got) != bits(want)
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - (8 if got.dtype == torch.bfloat16 else 24))
    far = float(((g - w).abs() / ulp.clamp_min(torch.finfo(want.dtype).tiny))[differ].max()
                ) if bool(differ.any()) else 0.0
    return {"differing": int(differ.sum()), "elements": int(differ.numel()), "max_ulps": far}


def check_loss_rope(gen, smi: str) -> dict:
    """B6 (``cross_entropy_fwd``, ``cross_entropy_bwd``) and B7
    (``rope_qk_fwd``, ``rope_qk_bwd``) against their plain versions on the
    card, one launch each on the route the layout gives (``vector``; the
    odd widths and the unaligned q and k ``scalar``): the loss (the mean of
    the rows' nll) within ``LOSS_REL_TOL`` of the eager chain's, the rows'
    lse beside the plain ones, the logits' gradient against
    ``cross_entropy_bwd_plain`` at the kernel's lse bit for bit or within
    one ulp of the logits' dtype (``ulps_apart``); RoPE's outputs and its
    adjoint's against ``rope_plain`` and ``rope_bwd_plain``, bit for bit or
    the count of differing elements and their distance in ulps (at most
    one). Then ``LOSS_TIMED`` and ``ROPE_TIMED`` in turns with the plain
    versions and, for the loss, ``F.cross_entropy`` on the f32 logits
    (forward; its backward alone from a kept graph): a yardstick never on
    the path; none computes RoPE. Each beside its bound by bytes, with the
    kernels' own device time, each call's host µs, their registers and
    local memory. Returns the kernels line's entries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch.kernels import rope
    dev = torch.device("cuda")
    d = torch.cuda.current_device()

    def took(fn, before):
        return {r: fn.launches_by_route[r] - before[r] for r in fn.launches_by_route}

    worst = dict.fromkeys(LOSS_ROPE, 0.0)
    timed_loss, timed_rope = {}, {}
    for label, dt, (b, s), v in LOSS_CHECKS:
        dtype = getattr(torch, dt)
        route = "vector" if v * (2 if dt == "bfloat16" else 4) % 16 == 0 else "scalar"
        one = {r: int(r == route) for r in ce.ROUTES}
        logits = (torch.randn((b, s, v), generator=gen, device=dev) * 2).to(dtype)
        labels = torch.randint(0, v, (b, s), generator=gen, device=dev)
        before = dict(ce.cross_entropy_fwd.launches_by_route)
        lse, nll = ce.cross_entropy_fwd(logits, labels)
        fwd_took = took(ce.cross_entropy_fwd, before)
        loss = float(nll.mean())
        want = float(ce.cross_entropy_plain(logits, labels))
        want_lse, want_nll = ce.cross_entropy_fwd_plain(logits, labels)
        grad = torch.ones((), device=dev)
        before = dict(ce.cross_entropy_bwd.launches_by_route)
        dx = ce.cross_entropy_bwd(grad, logits, lse, labels)
        bwd_took = took(ce.cross_entropy_bwd, before)
        wdx = ce.cross_entropy_bwd_plain(grad, logits, lse, labels)
        torch.cuda.synchronize()
        rel = abs(loss - want) / abs(want)
        lse_rel = float(((lse - want_lse).abs() / want_lse.abs()).max())
        adj = ulps_apart(dx, wdx)
        ok = (rel <= LOSS_REL_TOL and adj["max_ulps"] <= 1 and fwd_took == one
              and bwd_took == one and math.isfinite(loss))
        worst["cross_entropy_fwd"] = max(worst["cross_entropy_fwd"],
                                         float((nll - want_nll).abs().max()))
        worst["cross_entropy_bwd"] = max(worst["cross_entropy_bwd"],
                                         float((dx.float() - wdx.float()).abs().max()))
        emit({"phase": "kernel_check", "kernel": "cross_entropy", "path": label, "dtype": dt,
              "rows": b * s, "vocab": v, "route": route, "loss": loss, "plain_loss": want,
              "loss_rel_diff": rel, "loss_tol": LOSS_REL_TOL, "lse_max_rel_diff": lse_rel,
              "dlogits_vs_plain": adj, "launches": {"fwd": fwd_took, "bwd": bwd_took},
              "ok": ok})
        if not ok:
            raise AssertionError(f"cross_entropy differs from its plain version at {label}: "
                                 f"loss {loss} vs {want}, dlogits {adj}, launches {fwd_took} "
                                 f"{bwd_took}")
        if label in LOSS_TIMED:
            timed_loss[label] = (logits, labels, lse)
        del dx, wdx, want_lse, want_nll, nll
    for label, dt, b, s, hq, hk, hd, theta, kind in ROPE_CHECKS:
        dtype = getattr(torch, dt)

        def draw(h):
            if kind == "unaligned":       # one element past a 16-byte boundary, at its strides
                return torch.randn((b, s, h, hd + 2), generator=gen, device=dev).to(
                    dtype)[..., 1:hd + 1]
            return torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        q, k, gq, gk = draw(hq), draw(hk), draw(hq), draw(hk)
        if kind == "decode":
            pos = torch.full((b, 1), 1037, dtype=torch.long, device=dev)
        elif kind == "int32":
            pos = torch.randint(0, 4096, (b, s), generator=gen, device=dev).int()
        else:
            pos = torch.arange(s, device=dev).expand(b, s)
        route = "scalar" if kind == "unaligned" else "vector"
        one = {r: int(r == route) for r in rope.ROUTES}
        before = dict(rope.rope_qk_fwd.launches_by_route)
        oq, ok_ = rope.rope_qk_fwd(q, k, pos, theta)
        fwd_took = took(rope.rope_qk_fwd, before)
        before = dict(rope.rope_qk_bwd.launches_by_route)
        dq, dk = rope.rope_qk_bwd(gq, gk, pos, theta)
        bwd_took = took(rope.rope_qk_bwd, before)
        fwd = [ulps_apart(oq, rope.rope_plain(q, pos, theta)),
               ulps_apart(ok_, rope.rope_plain(k, pos, theta))]
        bwd = [ulps_apart(dq, rope.rope_bwd_plain(gq, pos, theta)),
               ulps_apart(dk, rope.rope_bwd_plain(gk, pos, theta))]
        torch.cuda.synchronize()
        fwd_bits = all(r["differing"] == 0 for r in fwd)
        bwd_bits = all(r["differing"] == 0 for r in bwd)
        ok = (all(r["max_ulps"] <= 1 for r in fwd + bwd) and fwd_took == one
              and bwd_took == one)
        worst["rope_qk_fwd"] = max(worst["rope_qk_fwd"], max(
            float((a.float() - rope.rope_plain(x, pos, theta).float()).abs().max())
            for a, x in ((oq, q), (ok_, k))))
        worst["rope_qk_bwd"] = max(worst["rope_qk_bwd"], max(
            float((a.float() - rope.rope_bwd_plain(g, pos, theta).float()).abs().max())
            for a, g in ((dq, gq), (dk, gk))))
        emit({"phase": "kernel_check", "kernel": "rope_qk", "path": label, "dtype": dt,
              "batch": b, "seq": s, "q_heads": hq, "k_heads": hk, "head_dim": hd,
              "theta": theta, "positions": kind, "route": route,
              "forward_bits_equal": fwd_bits, "adjoint_bits_equal": bwd_bits,
              "forward_vs_plain": {"q": fwd[0], "k": fwd[1]},
              "adjoint_vs_plain": {"q": bwd[0], "k": bwd[1]},
              "launches": {"fwd": fwd_took, "bwd": bwd_took}, "ok": ok})
        if not ok:
            raise AssertionError(f"rope_qk differs from its plain version at {label}: "
                                 f"{fwd} {bwd}, launches {fwd_took} {bwd_took}")
        if label in ROPE_TIMED:
            timed_rope[label] = (q, k, gq, gk, pos, theta)
        del oq, ok_, dq, dk
    gc.collect()
    torch.cuda.empty_cache()

    # timing, in turns
    entries = {name: {} for name in LOSS_ROPE}

    def add(name, label, shape, dtype, contenders, split, bound, resources):
        t = timed_in_turns(contenders, NC_ITERS, split, 100)
        entries[name][label] = dict(shape=shape, dtype=str(dtype), **t, **bound,
                                    share_of_bound=bound["bound_ms"] / t["ms"],
                                    resources=resources)
    for label, (logits, labels, lse) in timed_loss.items():
        rows, v = labels.numel(), logits.shape[-1]
        es, n = logits.element_size(), logits.numel()
        grad = torch.ones((), device=dev)
        x32 = logits.float().requires_grad_(True)
        lib_loss = F.cross_entropy(x32.view(-1, v), labels.view(-1))
        add("cross_entropy_fwd", label, [rows, v], logits.dtype,
            {"kernel": lambda: ce.cross_entropy_fwd(logits, labels)[1].mean(),
             "plain": lambda: ce.cross_entropy_plain(logits, labels),
             "library": lambda: F.cross_entropy(logits.float().view(-1, v), labels.view(-1))},
            {"ce_fwd_kernel": 1}, nc_bound(n * es + rows * (8 + 4 + 4), 4 * n),
            ce.attributes(logits.dtype, False, d))
        add("cross_entropy_bwd", label, [rows, v], logits.dtype,
            {"kernel": lambda: ce.cross_entropy_bwd(grad, logits, lse, labels),
             "plain": lambda: ce.cross_entropy_bwd_plain(grad, logits, lse, labels),
             "library": lambda: torch.autograd.grad(lib_loss, x32, retain_graph=True)},
            {"ce_bwd_kernel": 1}, nc_bound(2 * n * es + rows * (8 + 4) + 4, 5 * n),
            ce.attributes(logits.dtype, True, d))
        del x32, lib_loss
    for label, (q, k, gq, gk, pos, theta) in timed_rope.items():
        es, n = q.element_size(), q.numel() + k.numel()
        b, s, hq, hd = q.shape
        pos_bytes = pos.untyped_storage().nbytes() if pos.stride(0) == 0 else pos.numel() * 8
        nbytes = 2 * n * es + pos_bytes + hd // 2 * 4
        shape = [b, s, hq, k.shape[2], hd]
        add("rope_qk_fwd", label, shape, q.dtype,
            {"kernel": lambda: rope.rope_qk_fwd(q, k, pos, theta),
             "plain": lambda: (rope.rope_plain(q, pos, theta), rope.rope_plain(k, pos, theta))},
            {"rope_qk_fwd_kernel": 1}, nc_bound(nbytes, 3 * n),
            rope.attributes(q.dtype, False, d))
        add("rope_qk_bwd", label, shape, q.dtype,
            {"kernel": lambda: rope.rope_qk_bwd(gq, gk, pos, theta),
             "plain": lambda: (rope.rope_bwd_plain(gq, pos, theta),
                               rope.rope_bwd_plain(gk, pos, theta))},
            {"rope_qk_bwd_kernel": 1}, nc_bound(nbytes, 3 * n),
            rope.attributes(q.dtype, True, d))
    for name, rows in entries.items():
        for label, e in rows.items():
            emit({"phase": "kernel_time", "kernel": name, "path": label, "smi": smi, **e})
    del timed_loss, timed_rope
    gc.collect()
    torch.cuda.empty_cache()
    libraries = {"cross_entropy_fwd": "F.cross_entropy of the f32 logits (its forward)",
                 "cross_entropy_bwd": "F.cross_entropy's backward alone, from a kept graph, "
                                      "to f32 logits (no cast back)"}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
            "share_of_bound", "host_us", "shape", "resources")
    result = {}
    for name in LOSS_ROPE:
        first_label = next(iter(entries[name]))
        first = entries[name].pop(first_label)
        result[name] = {"max_abs_err": worst[name], "path": first_label,
                        **{k: first[k] for k in keys},
                        "other_shapes": {lb: {k: e[k] for k in keys if k != "host_us"}
                                         for lb, e in entries[name].items()},
                        "library_layout": libraries.get(name, "none: no one PyTorch call "
                                                              "computes it")}
    return result


# B8, SwiGLU's gate: (label, dtype, the shape of g and u): phi4-mini's
# training MLP (4 x 1024 tokens, d_ff 8192), olmoe's expert buffer (64
# experts x 640 slots, moe_d_ff 1024), qwen3-14b's prefill and decode step
# (d_ff 17408), kimi-k2's expert buffer (384 experts x 107 slots at 4 x 1024
# tokens, moe_d_ff 2048), the demo's f32 MLP (8 x 128, 2048), and an odd
# width on the scalar route in both dtypes
SWIGLU_CHECKS = (("phi4-mini-3.8b train", "bfloat16", (4, 1024, 8192)),
                 ("olmoe-1b-7b experts", "bfloat16", (64, 640, 1024)),
                 ("qwen3-14b prefill", "bfloat16", (4, 1024, 17408)),
                 ("qwen3-14b decode", "bfloat16", (4, 1, 17408)),
                 ("kimi-k2 experts", "bfloat16", (384, 107, 2048)),
                 ("demo-100m", "float32", (8, 128, 2048)),
                 ("odd width", "bfloat16", (3, 7, 1001)),
                 ("odd width f32", "float32", (3, 7, 1001)))
SWIGLU_TIMED = ("phi4-mini-3.8b train", "olmoe-1b-7b experts", "qwen3-14b prefill",
                "qwen3-14b decode", "kimi-k2 experts")
# f32 operations an element counted for the bound: the forward's negation,
# exp, sum, quotient and product; the adjoint's exp, sum, two quotients,
# four products, difference and fma (two)
SWIGLU_FLOPS = {"swiglu_fwd": 5, "swiglu_bwd": 11}


def bits_apart(got, want) -> dict:
    """Elements of ``got`` whose bits differ from ``want``'s where ``want``
    is a number, and whether ``got`` is NaN exactly where ``want`` is."""
    import torch
    nan = torch.isnan(want)
    return {"differing": int((bits(got) != bits(want))[~nan].sum()),
            "nan_where_want": bool(torch.equal(torch.isnan(got), nan))}


def swiglu_sweep(dtype, gen, per_g: int = 8) -> dict:
    """B8 on every bf16 bit pattern as g (in f32, its f32 value), each beside
    ``per_g`` gradients dh and values u (normal, times 2, in the dtype): the
    forward against ``F.silu(g) * u`` and the adjoint's dg and du against
    that chain's autograd and against ``swiglu_bwd_plain``, each bit for bit
    and NaN where they are NaN; one launch each on the ``vector`` route."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import swiglu as sw
    pats = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    g = pats.cuda().to(dtype)[:, None].expand(-1, per_g).contiguous()
    u, dh = ((torch.randn(g.shape, generator=gen, device="cuda") * 2).to(dtype) for _ in "ud")
    before = (dict(sw.swiglu_fwd.launches_by_route), dict(sw.swiglu_bwd.launches_by_route))
    h = sw.swiglu_fwd(g, u)
    dg, du = sw.swiglu_bwd(dh, g, u)
    took = [{r: fn.launches_by_route[r] - b[r] for r in sw.ROUTES}
            for fn, b in zip((sw.swiglu_fwd, sw.swiglu_bwd), before)]
    ga, ua = g.clone().requires_grad_(True), u.clone().requires_grad_(True)
    want = F.silu(ga) * ua
    want.backward(dh)
    plain_dg, plain_du = sw.swiglu_bwd_plain(dh, g, u)
    torch.cuda.synchronize()
    checks = {"forward": bits_apart(h, want.detach()), "dg_autograd": bits_apart(dg, ga.grad),
              "du_autograd": bits_apart(du, ua.grad), "dg_plain": bits_apart(dg, plain_dg),
              "du_plain": bits_apart(du, plain_du)}
    one = {"vector": 1, "scalar": 0}
    ok = (all(c["differing"] == 0 and c["nan_where_want"] for c in checks.values())
          and took == [one, one])
    return {"dtype": str(dtype).split(".")[-1], "g_values": int(pats.numel()),
            "inputs": int(g.numel()), **checks, "launches": took, "ok": ok}


def check_swiglu(gen, smi: str, ptxas: dict) -> dict:
    """B8 (``swiglu_fwd``, ``swiglu_bwd``) against their plain versions on
    the card, one launch each on the route the width gives (``vector``; the
    odd widths ``scalar``), at ``SWIGLU_CHECKS``: h against
    ``swiglu_plain`` (``F.silu(g) * u``) and dg, du against
    ``swiglu_bwd_plain`` (the ops autograd calls), bit for bit; then every
    bf16 g with several gradients in f32 and bf16 (``swiglu_sweep``). Then
    ``SWIGLU_TIMED`` in turns with the plain versions (no one PyTorch call
    computes either), each beside its bound by bytes, with the kernels' own
    device time, each call's host µs, their registers and local memory from
    the runtime and ptxas's registers and spills (``ptxas``: this source's
    log by entry function). Returns the kernels line's entries."""
    import torch
    from repro_torch.kernels import swiglu as sw
    dev = torch.device("cuda")
    d = torch.cuda.current_device()

    def took(fn, before):
        return {r: fn.launches_by_route[r] - before[r] for r in fn.launches_by_route}

    worst = dict.fromkeys(B8, 0.0)
    timed = {}
    for label, dt, shape in SWIGLU_CHECKS:
        dtype = getattr(torch, dt)
        route = "vector" if shape[-1] * (2 if dt == "bfloat16" else 4) % 16 == 0 else "scalar"
        one = {r: int(r == route) for r in sw.ROUTES}
        g, u, dh = ((torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
                    for _ in range(3))
        before = dict(sw.swiglu_fwd.launches_by_route)
        h = sw.swiglu_fwd(g, u)
        fwd_took = took(sw.swiglu_fwd, before)
        before = dict(sw.swiglu_bwd.launches_by_route)
        dg, du = sw.swiglu_bwd(dh, g, u)
        bwd_took = took(sw.swiglu_bwd, before)
        want_h = sw.swiglu_plain(g, u)
        want_dg, want_du = sw.swiglu_bwd_plain(dh, g, u)
        torch.cuda.synchronize()
        checks = {"h": bits_apart(h, want_h), "dg": bits_apart(dg, want_dg),
                  "du": bits_apart(du, want_du)}
        ok = (all(c["differing"] == 0 and c["nan_where_want"] for c in checks.values())
              and fwd_took == one and bwd_took == one)
        worst["swiglu_fwd"] = max(worst["swiglu_fwd"], float((h.float() - want_h.float())
                                                             .abs().max()))
        worst["swiglu_bwd"] = max(worst["swiglu_bwd"], *(
            float((a.float() - b.float()).abs().max()) for a, b in ((dg, want_dg), (du, want_du))))
        emit({"phase": "kernel_check", "kernel": "swiglu", "path": label, "dtype": dt,
              "shape": list(shape), "route": route, "vs_plain": checks,
              "launches": {"fwd": fwd_took, "bwd": bwd_took}, "ok": ok})
        if not ok:
            raise AssertionError(f"swiglu differs from its plain version at {label}: {checks}, "
                                 f"launches {fwd_took} {bwd_took}")
        if label in SWIGLU_TIMED:
            timed[label] = (g, u, dh)
        del h, dg, du, want_h, want_dg, want_du
    for dtype in (torch.float32, torch.bfloat16):
        sweep = swiglu_sweep(dtype, gen)
        emit({"phase": "kernel_check", "kernel": "swiglu every bf16 g", **sweep})
        if not sweep["ok"]:
            raise AssertionError(f"swiglu differs from F.silu(g) * u or its autograd: {sweep}")
    gc.collect()
    torch.cuda.empty_cache()

    entries = {name: {} for name in B8}
    for label, (g, u, dh) in timed.items():
        n, es = g.numel(), g.element_size()
        for name, nbytes, contenders in (
                ("swiglu_fwd", 3 * n * es, {"kernel": lambda: sw.swiglu_fwd(g, u),
                                            "plain": lambda: sw.swiglu_plain(g, u)}),
                ("swiglu_bwd", 5 * n * es, {"kernel": lambda: sw.swiglu_bwd(dh, g, u),
                                            "plain": lambda: sw.swiglu_bwd_plain(dh, g, u)})):
            kernel = name + "_kernel"
            t = timed_in_turns(contenders, NC_ITERS, {kernel: 1}, 100)
            bound = nc_bound(nbytes, SWIGLU_FLOPS[name] * n)
            entries[name][label] = dict(
                shape=list(g.shape), dtype=str(g.dtype), **t, **bound,
                share_of_bound=bound["bound_ms"] / t["ms"],
                kernel_share_of_bound=bound["bound_ms"] / t["kernel_device_ms"],
                resources={**sw.attributes(g.dtype, name == "swiglu_bwd", d),
                           "ptxas": {k: v for k, v in ptxas.items() if kernel in k}})
    for name, rows in entries.items():
        for label, e in rows.items():
            emit({"phase": "kernel_time", "kernel": name, "path": label, "smi": smi, **e})
    del timed
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
            "share_of_bound", "host_us", "shape", "resources")
    result = {}
    for name in B8:
        first_label = next(iter(entries[name]))
        first = entries[name].pop(first_label)
        result[name] = {"max_abs_err": worst[name], "path": first_label,
                        **{k: first[k] for k in keys},
                        "other_shapes": {lb: {k: e[k] for k in keys if k != "host_us"}
                                         for lb, e in entries[name].items()},
                        "library_layout": "none: no one PyTorch call computes it (F.glu gates "
                                          "by a sigmoid)"}
    return result


def kernel_split(fn, want: dict, calls: int = 3, tries: int = 5) -> dict:
    """Device ms per call of ``fn`` by kernel (``torch.profiler``) for the
    kernels in ``want``, each launched ``want[name]`` times a call. The
    profiler drops launches of short windows, more so late in a long
    process (a full ``chip_smoke.py`` run: 4 of 5 in every window of B6's,
    B7's and B8's timings with 5 ms pauses, none of 25 in five windows
    without them; ``--drift`` of ``examples/profiler_window_probe_torch.py``:
    none of 5 in each window after a minute of products), which divided by
    the calls would read as less time. Each window opens and closes with a
    launch of PyTorch's ``spin_kernel`` (``torch.cuda._sleep``, ~1 µs), in
    case the record it loses is its first or last; a window is taken again until one records ``calls`` ×
    ``want[name]`` launches of each (up to ``tries``); else their records are
    pooled: each kernel's mean over the launches recorded, times
    ``want[name]``. A kernel no window recorded is timed by CUDA events
    over ``calls`` calls where it is the only one wanted (the call's other
    launches and gaps included), and raises otherwise; more records than
    launches raise. Each incomplete window and each fallback is listed in
    ``INCOMPLETE_PROFILES``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    pooled = {n: [0, 0.0] for n in want}              # launches recorded, their µs
    for _ in range(tries):
        with profiled(ProfilerActivity.CUDA) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = {n: sum(e.count for e in events if named(n, e.key)) for n in want}
        us = {n: sum(e.self_device_time_total for e in events if named(n, e.key)) for n in want}
        if any(seen[n] > calls * want[n] for n in want):
            raise AssertionError(f"kernel_split: the profiler recorded {seen} launches in "
                                 f"{calls} calls of {want} a call")
        if all(seen[n] == calls * want[n] for n in want):
            return {n: us[n] / calls / 1e3 for n in want}
        INCOMPLETE_PROFILES.append(("kernel_split", seen))
        for n in want:
            pooled[n][0] += seen[n]
            pooled[n][1] += us[n]
    missing = [n for n in want if not pooled[n][0]]
    if missing and len(want) > 1:
        raise AssertionError(f"kernel_split: the profiler recorded no launch of {missing} in "
                             f"{tries} windows of {calls} calls of {want} a call")
    if missing:
        INCOMPLETE_PROFILES.append(("kernel_split by CUDA events", missing[0]))
        return {missing[0]: cuda_ms(fn, iters=calls)}
    return {n: pooled[n][1] / pooled[n][0] * want[n] / 1e3 for n in want}


def k2k3_operand_shapes(cfg, batch: int, seq: int) -> list:
    """The shapes in which K2's and K3's operands and their gradients would
    be copied around the kernels: (B, S, n, w), (B, n, S, w) and (B·n, S,
    w) for q, k and v (n = H, Kv; w = hd) and for x, B and C (n = the SSM's
    heads, groups; w = P, N). dt's shapes are left out: its f32 cast from
    the projection's slice is a ``copy_`` of the same shape in the
    reference's arithmetic, not a layout copy."""
    forms = []
    if cfg.num_heads:
        hd = cfg.resolved_head_dim
        forms += [(cfg.num_heads, hd), (cfg.num_kv_heads, hd)]
    if cfg.ssm_state:
        forms += [(cfg.ssm_heads, cfg.ssm_head_dim), (cfg.ssm_groups, cfg.ssm_state)]
    shapes = []
    for n, w in forms:
        shapes += [[batch, seq, n, w], [batch, n, seq, w], [batch * n, seq, w]]
    return shapes


def train_profile(model, opt, state, tokens, labels, operand_shapes=()) -> dict:
    """Device ms of one train step split by what runs: K2's forward, K2's
    backward (its three kernels on either route, also apart), K3's forward
    and its backward (both passes, also apart), B2's forward kernels (fill
    and combine) and its adjoint kernels (also apart), B4's forward and
    adjoint kernels (both forms; the adjoint with its sum pass), B5's
    likewise, B6's (the loss: ``loss_forward``, ``loss_backward``), B7's
    (RoPE: ``rope_forward``, ``rope_backward``) and B8's (SwiGLU's gate:
    ``swiglu_forward``, ``swiglu_backward``) by kernel name, cuBLAS, the
    optimizer's update (B3's kernel by its name, launched through
    ``ctypes`` with no PyTorch op around it, and the ops under the
    optimizer's ``record_function`` range: the bias corrections) and the
    rest (the loss's mean, the embedding's gradient, the residual adds,
    the splits' gradients, copies). The split sums to the busy time, the rest at least
    0. ``rest_by_op``: the rest's device time by the PyTorch op
    that launched each kernel and its input shapes (the ops' own device
    time, ``key_averages(group_by_input_shape=True)``; products and the
    port's autograd Functions, whose kernels are counted by name, left
    out), the 15 largest. ``layout_copies``: each ``aten::copy_`` of the
    step whose input is in one of ``operand_shapes``
    (``k2k3_operand_shapes``), with its device ms: none when K2 and K3 read
    and write the model's layout in place."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from repro_torch.train import train_step

    def update(*args):
        with record_function("optimizer"):
            return opt[1](*args)
    with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA, record_shapes=True) as prof:
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
    bwd = ms(lambda key: any(named(n, key) for n in BWD_KERNELS))
    bwd_by_kernel = {n: ms(lambda key, n=n: named(n, key)) for n in BWD_KERNELS}
    ssd_fwd = ms(lambda key: any(named(n, key) for n in SSD_FWD_KERNELS))
    ssd_bwd = ms(lambda key: any(named(n, key) for n in SSD_BWD_KERNELS))
    ssd_bwd_by_kernel = {n: ms(lambda key, n=n: named(n, key)) for n in SSD_BWD_KERNELS}
    moe_fwd = ms(lambda key: any(named(n[0], key) for n in B2_KERNELS.values()))
    moe_bwd_by_kernel = {n: ms(lambda key, n=n: named(n, key)) for n in B2_BWD_KERNELS.values()}
    moe_bwd = sum(moe_bwd_by_kernel.values())
    gemm = ms(lambda key: any(n in key.lower() for n in ("gemm", "nvjet", "xmma", "cutlass")))
    norm_conv = {part: ms(lambda key, names=names: any(named(n, key) for n in names))
                 for part, names in {**NORM_CONV_KERNELS, **LOSS_ROPE_KERNELS,
                                     **SWIGLU_KERNELS}.items()}

    def inside(e, name):
        p = e.cpu_parent
        while p is not None:
            if p.name == name:
                return True
            p = p.cpu_parent
        return False
    # each kernel once: the self device time of every op under the range,
    # and the kernel, which no op under the range holds
    optimizer_ops = sum(e.self_device_time_total for e in prof.events()
                        if e.device_type == DeviceType.CPU and inside(e, "optimizer")) / 1e3
    adamw = ms(lambda key: named("adamw_kernel", key))
    optimizer = optimizer_ops + adamw
    split = {"attention_forward": fwd, "attention_backward": bwd, "ssd_forward": ssd_fwd,
             "ssd_backward": ssd_bwd, "moe_dispatch_forward": moe_fwd,
             "moe_dispatch_backward": moe_bwd, **norm_conv, "cublas": gemm,
             "optimizer": optimizer}
    split["rest"] = busy - sum(split.values())
    if split["rest"] < -1e-3 * busy:
        raise AssertionError(f"train profile counts some kernel twice: {split}, busy {busy}")
    by_op = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
             and e.key not in GEMM_OPS and e.key != "optimizer"
             and not e.key.endswith(("Fn", "FnBackward"))]
    rest_by_op = [[e.key, str(e.input_shapes)[:160], e.self_device_time_total / 1e3, e.count]
                  for e in sorted(by_op, key=lambda e: -e.self_device_time_total)[:15]]
    shapes = [list(s) for s in operand_shapes]
    layout_copies = [[e.key, str(e.input_shapes)[:160], e.self_device_time_total / 1e3, e.count]
                     for e in by_op if e.key == "aten::copy_"
                     and any(list(s) in shapes for s in e.input_shapes)]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "split_ms": split,
            "rest_by_op": rest_by_op, "layout_copies": layout_copies,
            "optimizer_ms": {"adamw_kernel": adamw, "ops_in_range": optimizer_ops},
            "split_sum_ms": sum(split.values()),
            "attention_backward_ms": {n: t for n, t in bwd_by_kernel.items() if t},
            "ssd_backward_ms": {n: t for n, t in ssd_bwd_by_kernel.items() if t},
            "moe_dispatch_backward_ms": {n: t for n, t in moe_bwd_by_kernel.items() if t},
            "device_share": busy / wall_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]]}, state


def train_swaps(kind: str):
    """What ``train_check`` swaps into ``ops`` for ``kind`` (``attention``:
    K2, ``ssd``: K3, ``moe``: B2, ``norm``: B4's plain form, ``norm_conv``:
    B4's two forms and B5, ``loss_rope``: B6 and B7, ``swiglu``: B8): {name there: a
    stand-in running the plain forward, which autograd differentiates} and
    {a fault's name: {name there: the kernels' Function with a faulty
    backward}}. The faults zero the gradients of the two inputs the scores
    are formed from (dQ and dK; dB and dC), the gates' gradient (the
    router's only path to the loss), the norms' scale gradient, or the
    convolution's dw; drop the loss's one-hot term (the softmax alone);
    rotate RoPE's gradient by +angle (the forward's rotation); take SiLU's
    derivative as σ alone (its ``g·(1 − σ)`` term dropped)."""
    import torch
    if kind == "swiglu":
        sw = importlib.import_module("repro_torch.kernels.swiglu")

        class PlainSwiglu:
            @staticmethod
            def apply(g, u):
                return sw.swiglu_plain(g, u)

        class LostSiluTerm(sw.SwigluFn):
            @staticmethod
            def backward(ctx, dh):
                g, u = ctx.saved_tensors
                dh = dh.to(g.dtype)
                dg = ((dh * u).float() * torch.sigmoid(g.float())).to(g.dtype)
                return dg, dh * torch.nn.functional.silu(g)
        return {"SwigluFn": PlainSwiglu}, {"lost_silu_term": {"SwigluFn": LostSiluTerm}}
    if kind == "loss_rope":
        ce = importlib.import_module("repro_torch.kernels.cross_entropy")
        rope = importlib.import_module("repro_torch.kernels.rope")

        class PlainLoss:
            @staticmethod
            def apply(logits, labels):
                return ce.cross_entropy_plain(logits, labels)

        class PlainRope:
            @staticmethod
            def apply(q, k, positions, theta):
                return (rope.rope_plain(q, positions, theta),
                        None if k is None else rope.rope_plain(k, positions, theta))

        class LostOnehot(ce.CrossEntropyFn):
            @staticmethod
            def backward(ctx, grad):
                dx, dlabels = ce.CrossEntropyFn.backward(ctx, grad)
                _, _, labels = ctx.saved_tensors
                flat = dx.view(-1, dx.shape[-1])
                rows = torch.arange(flat.shape[0], device=dx.device)
                flat[rows, labels.reshape(-1)] += (grad / flat.shape[0]).to(dx.dtype)
                return dx, dlabels

        class RopeForwardSign(rope.RopeFn):
            @staticmethod
            def backward(ctx, gq, gk):
                (positions,) = ctx.saved_tensors
                dq, dk = rope.rope_qk_fwd(gq.contiguous(), gk.contiguous(), positions,
                                          ctx.theta)
                return dq, dk, None, None
        return ({"CrossEntropyFn": PlainLoss, "RopeFn": PlainRope},
                {"lost_onehot": {"CrossEntropyFn": LostOnehot},
                 "rope_plus_angle": {"RopeFn": RopeForwardSign}})
    if kind in ("norm", "norm_conv"):
        rn = importlib.import_module("repro_torch.kernels.rms_norm")
        cc = importlib.import_module("repro_torch.kernels.causal_conv")

        class PlainNorm:
            @staticmethod
            def apply(x, scale, eps):
                return rn.rms_norm_plain(x, scale, eps)

        class PlainGated:
            @staticmethod
            def apply(y, xh, D, z, scale, eps):
                return rn.gated_rms_norm_plain(y, xh, D, z, scale, eps)

        class PlainConv:
            @staticmethod
            def apply(x, w, b, state):
                return cc.causal_conv1d_plain(x, w, b, state)

        class LostDscale(rn.RmsNormFn):
            @staticmethod
            def backward(ctx, g):
                dx, dscale, eps = rn.RmsNormFn.backward(ctx, g)
                return dx, torch.zeros_like(dscale), eps

        class LostConvDw(cc.CausalConv1dFn):
            @staticmethod
            def backward(ctx, g, g_state):
                dx, dw, db, dstate = cc.CausalConv1dFn.backward(ctx, g, g_state)
                return dx, torch.zeros_like(dw), db, dstate
        if kind == "norm":
            return {"RmsNormFn": PlainNorm}, {"lost_dscale": {"RmsNormFn": LostDscale}}
        return ({"RmsNormFn": PlainNorm, "GatedRmsNormFn": PlainGated,
                 "CausalConv1dFn": PlainConv}, {"lost_conv_dw": {"CausalConv1dFn": LostConvDw}})
    if kind == "moe":
        md = importlib.import_module("repro_torch.kernels.moe_dispatch")

        class PlainFill:
            @staticmethod
            def apply(rows, dest, kept, cap):
                return md.moe_fill_plain(rows, dest, kept, cap)

        class PlainCombine:
            @staticmethod
            def apply(y, dest, gate, kept, expert0):
                return md.moe_combine_plain(y, dest, gate, expert0)

        class LostDgate(md.MoeCombineFn):
            @staticmethod
            def backward(ctx, grad_out):
                dy, ddest, dgate, *rest = md.MoeCombineFn.backward(ctx, grad_out)
                return (dy, ddest, torch.zeros_like(dgate), *rest)
        return ({"MoeFillFn": PlainFill, "MoeCombineFn": PlainCombine},
                {"lost_dgate": {"MoeCombineFn": LostDgate}})
    if kind == "attention":
        fa = importlib.import_module("repro_torch.kernels.flash_attention")

        class PlainAttention:
            @staticmethod
            def apply(q, k, v, g, causal, window, q_offset):
                return fa.flash_attention_plain(q, k, v, q_heads_per_kv=g, causal=causal,
                                                window=window, q_offset=q_offset)

        class LostDqDk(fa.FlashAttentionFn):
            @staticmethod
            def backward(ctx, do):
                dq, dk, *rest = fa.FlashAttentionFn.backward(ctx, do)
                return (torch.zeros_like(dq), torch.zeros_like(dk), *rest)
        return ({"FlashAttentionFn": PlainAttention},
                {"lost_dq_dk": {"FlashAttentionFn": LostDqDk}})
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

    class PlainSsd:
        @staticmethod
        def apply(x, dt, A, Bm, Cm, chunk, g, initial_state):
            return ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, heads_per_group=g,
                                      initial_state=initial_state)

    class LostDbDc(ssd.SsdScanFn):
        @staticmethod
        def backward(ctx, dy, dstate):
            dx, ddt, dA, dB, dC, *rest = ssd.SsdScanFn.backward(ctx, dy, dstate)
            return (dx, ddt, dA, torch.zeros_like(dB), torch.zeros_like(dC), *rest)
    return {"SsdScanFn": PlainSsd}, {"lost_db_dc": {"SsdScanFn": LostDbDc}}


def train_check(counters: dict, arch: str, cut, kind: str) -> None:
    """``arch`` at full width cut by ``cut`` (``TRAIN_CHECKS``), bf16, random
    weights from seed 0, the first ``MarkovDataset`` batch of the train
    phase: ``forward_train`` (remat on) and the loss's backward through the
    kernels of ``kind`` (``train_swaps``), their launches as
    ``train_launches`` gives for one step (each forward kernel twice a layer
    with remat, each backward kernel once; all on ``sm90``), against the same with the kernels' Function
    swapped for the plain forward, which autograd differentiates. The loss
    within ``TRAIN_LOSS_TOL`` and every parameter's gradient within
    ``TRAIN_GRAD_TOL`` (relative L2). Then the kernels again with each of
    the backwards' faulty stand-ins: the same limits must reject each. For
    ``moe`` (olmoe-1b-7b) K2 runs in all three runs; only B2's Functions
    are swapped, both for the plain forwards, and the fault zeroes the
    gates' gradient."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward_train, init_params
    from repro_torch.train import DataConfig, MarkovDataset, cross_entropy_loss
    ops = importlib.import_module("repro_torch.kernels.ops")
    dev = torch.device("cuda")
    cfg = cut_config(get_config(arch), cut)
    model = init_params(cfg, seed=0, device=dev)
    model.requires_grad_(True)
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    batch_size=TRAIN_BATCH, seed=0))
    tokens, labels = (torch.from_numpy(a).to(dev, torch.int64) for a in next(data.batches()))
    plain, faults = train_swaps(kind)

    def swapped(swaps):
        stack = contextlib.ExitStack()
        for name, stand_in in swaps.items():
            stack.enter_context(mock.patch.object(ops, name, stand_in))
        return stack

    def run():
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(forward_train(model, tokens, None, remat=True), labels)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    def rel(got, want):
        return {n: float((got[n].float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
                for n, w in want.items()}

    zero_counts(counters)
    loss_k, grads_k = run()
    counted = read_counts(counters)
    with swapped(plain):
        loss_p, grads_p = run()
    errs = rel(grads_k, grads_p)
    fault_errs = {}
    for fault, faulty in faults.items():
        with swapped(faulty):
            _, grads_z = run()
        fault_errs[fault] = rel(grads_z, grads_p)
        del grads_z
    torch.cuda.synchronize()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    want = train_launches(cfg, 1)
    finite = math.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    rejected = {fault: max(e.values()) > TRAIN_GRAD_TOL for fault, e in fault_errs.items()}
    ok = (finite and loss_err <= TRAIN_LOSS_TOL and max(errs.values()) <= TRAIN_GRAD_TOL
          and counted["launches"] == want and counted["routes"] == train_routes(want)
          and all(rejected.values()) and len(grads_p) == sum(1 for _ in model.parameters()))
    emit({"phase": "train_check", "arch": cfg.name, "layers": cfg.num_layers,
          "pattern": cfg.layout_pattern, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "ssm_heads": cfg.ssm_heads, "ssm_groups": cfg.ssm_groups,
          "experts": cfg.num_experts, "top_k": cfg.experts_per_token, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "loss": loss_k, "plain_loss": loss_p, "loss_rel_err": loss_err,
          "loss_tol": TRAIN_LOSS_TOL, "grad_rel_err": errs, "grad_tol": TRAIN_GRAD_TOL,
          **{f"{fault}_grad_rel_err": e for fault, e in fault_errs.items()},
          **{f"{fault}_rejected": r for fault, r in rejected.items()},
          **counted, "want_launches": want, "ok": ok})
    if not ok:
        raise AssertionError(f"train_check {arch}: loss {loss_k} vs {loss_p}, gradients {errs}, "
                             f"{counted} (want {want}), faults rejected {rejected}")
    del model, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()


def train_launches(cfg, steps: int, adamw_per_step: int = 0, remat: bool = True) -> dict:
    """Kernel launches of ``steps`` train steps: each forward kernel (K2, K3,
    B2's fill and combine, B4's two forms, B5 and B7 inside the layers)
    twice a layer and step with ``remat`` (the forward, then its
    recomputation in the backward), once without; the norms and RoPE
    outside the layers (the final norm, an encoder's) once; each backward
    kernel (K2's, K3's, B2's two adjoints, B4's, B5's and B7's) once for
    each forward call it differentiates; the loss (B6) and its adjoint once
    a step; and AdamW's ``adamw_per_step`` times a step (0 where no
    optimizer runs)."""
    per = expected_launches(cfg)
    nc = norm_conv_counts(cfg)
    rc = rope_counts(cfg)
    sc = swiglu_counts(cfg)
    f = 2 if remat else 1
    want = dict.fromkeys(per, 0)
    want.update(flash_attention=f * per["flash_attention"] * steps,
                flash_attention_bwd=per["flash_attention"] * steps,
                ssd_scan=f * per["ssd_scan"] * steps, ssd_scan_bwd=per["ssd_scan"] * steps,
                adamw=adamw_per_step * steps,
                rms_norm_fwd=(f * nc["layers"] + nc["outside"]) * steps,
                rms_norm_bwd=(nc["layers"] + nc["outside"]) * steps,
                rope_qk_fwd=(f * rc["layers"] + rc["outside"]) * steps,
                rope_qk_bwd=(rc["layers"] + rc["outside"]) * steps,
                swiglu_fwd=(f * sc["layers"] + sc["outside"]) * steps,
                swiglu_bwd=(sc["layers"] + sc["outside"]) * steps,
                cross_entropy_fwd=steps, cross_entropy_bwd=steps)
    for fwd, bwd in zip(B2 + B4_GATED_B5, B2_BWD + B4_GATED_B5_BWD):
        want.update({fwd: f * per[fwd] * steps, bwd: per[fwd] * steps})
    return want


def train_routes(want: dict) -> dict:
    """Each kernel's launches in ``want`` by route: K2, its backward, K3's
    forward and its backward all on ``sm90`` (bf16 at these shapes), B2's,
    B4's and B5's adjoint kernels and B4's forward on ``vector``, B5's
    forward on ``staged`` (``nc_routes``)."""
    routes = {k: {"sm90": want[k], "simt": 0}
              for k in ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")}
    routes.update({k: {"vector": want[k], "scalar": 0} for k in B2 + B2_BWD})
    routes.update(nc_routes(want))
    return routes


def train_phase(smi: str, counters: dict, arch: str = TRAIN_ARCH,
                steps: int = TRAIN_STEPS, cut=None) -> dict:
    """``arch`` at full width and depth (phi4-mini-3.8b: 32 layers, d 3072,
    vocab 200064; mamba2-1.3b: 48 ssm layers, d 2048, vocab 50280), or cut
    in depth by ``cut`` (olmoe-1b-7b: 8 of 16 layers, d 2048, 64 experts
    top-8, expert d_ff 1024, vocab 50304), bf16,
    random weights from seed 0, the optimizer ``optimizer_for_config`` picks
    (AdamW) at ``TRAIN_LR``, remat on, batches of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` from ``MarkovDataset``: ``TRAIN_WARMUP`` steps, then
    ``steps`` through ``train_step`` with every kernel's count zeroed just
    before and read just after (``train_launches``: K2's forward 2 x 32 a
    step and its backward 32, all ``sm90``, for phi4; K3's forward 2 x 48 and
    its backward 48, all ``sm90``, for mamba2; K2's forward 2 x 8 and its
    backward 8, B2's fill and combine 2 x 8 and each adjoint 8, all
    ``vector``, for olmoe; B3 ``adamw_per_step`` times a step), each step
    on the
    host clock; the loss finite and falling (the last three steps' mean below
    the first three's); the peak memory; then one more step under the
    profiler. Returns the counted launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_leaves
    from repro_torch.train import (DataConfig, MarkovDataset, make_optimizer,
                                   optimizer_for_config, train_step)
    dev = torch.device("cuda")
    cfg = get_config(arch) if cut is None else cut_config(get_config(arch), cut)
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
               for _ in range(TRAIN_WARMUP + steps + 1)]
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for tokens, labels in batches[:TRAIN_WARMUP]:
        state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
        losses.append(float(loss))
    zero_counts(counters)
    for tokens, labels in batches[TRAIN_WARMUP:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counted = read_counts(counters)
    counts, routes = counted["launches"], counted["routes"]
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    want = train_launches(cfg, steps, adamw_per_step(cfg))
    prof, state = train_profile(model, opt, state, *batches[-1],
                                operand_shapes=k2k3_operand_shapes(cfg, TRAIN_BATCH, TRAIN_SEQ))
    mean_s = sum(step_s) / len(step_s)
    ok = (counts == want and routes == train_routes(want) and sm90_layout_copies(counted) == 0
          and not prof["layout_copies"]
          and all(math.isfinite(x) for x in losses) and sum(losses[-3:]) < sum(losses[:3]))
    emit({"phase": "train", "arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
          "full_layers": get_config(arch).num_layers, "experts": cfg.num_experts,
          "top_k": cfg.experts_per_token, "moe_d_ff": cfg.moe_d_ff,
          "vocab": cfg.vocab_size, "params": n_params, "dtype": cfg.dtype,
          "optimizer": opt_name, "lr": TRAIN_LR, "remat": True, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "init_s": init_s, "state_gb_before_step": state_gb, "data_s": data_s,
          "losses": losses, "ln_vocab": math.log(cfg.vocab_size), "loss_floor": data.entropy(),
          "step_s": step_s, "mean_step_s": mean_s, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_s,
          "peak_mem_gb": peak / 1e9, "launches": counts, "want_launches": want,
          "routes": routes, "layout_copies": counted["layout_copies"], "profile": prof,
          "device": torch.cuda.get_device_name(0), "smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"train {arch}: launches {counts} (want {want}), routes {routes}, "
                             f"layout copies {counted['layout_copies']} and in the profile "
                             f"{prof['layout_copies']}, losses {losses}")
    tally_conv_routes(routes)
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
    per layer and step, both on the ``simt`` route (f32), and B3
    ``adamw_per_step`` times a step (f32 parameters). Returns the counted
    launches."""
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
    want.update({k: v for k, v in train_launches(cfg, steps, adamw_per_step(cfg),
                                                 remat=False).items() if v})
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
    from repro_torch.kernels import moe_dispatch
    from repro_torch.kernels.flash_attention import ROUTES, flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ROUTES as SSD_ROUTES, ssd_scan, ssd_scan_bwd
    for c in counters.values():
        c.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
    ssd_scan.launches_by_route = dict.fromkeys(SSD_ROUTES, 0)
    ssd_scan_bwd.launches_by_route = dict.fromkeys(SSD_ROUTES, 0)
    for fn in (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd):
        fn.layout_copies = dict.fromkeys(fn.layout_copies, 0)
    for name in B2 + B2_BWD:
        getattr(moe_dispatch, name).launches_by_route = dict.fromkeys(moe_dispatch.ROUTES, 0)
    for name, fn in fused_wrappers().items():
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def norm_conv_wrappers() -> dict:
    """B4's and B5's wrappers by name."""
    from repro_torch.kernels import causal_conv, rms_norm
    return {name: getattr(rms_norm if name in B4 + B4_BWD else causal_conv, name)
            for name in NORM_CONV}


def loss_rope_wrappers() -> dict:
    """B6's and B7's wrappers by name."""
    from repro_torch.kernels import cross_entropy, rope
    return {name: getattr(cross_entropy if name in B6 else rope, name) for name in LOSS_ROPE}


def fused_wrappers() -> dict:
    """B4's to B8's wrappers by name."""
    from repro_torch.kernels import swiglu
    return {**norm_conv_wrappers(), **loss_rope_wrappers(),
            **{name: getattr(swiglu, name) for name in B8}}


def read_counts(counters: dict) -> dict:
    from repro_torch.kernels import moe_dispatch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    return {"launches": {k: c.launches for k, c in counters.items()},
            "layout_copies": {fn.__name__: dict(fn.layout_copies) for fn in (
                flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd)},
            "routes": {"flash_attention": dict(flash_attention.launches_by_route),
                       "flash_attention_bwd": dict(flash_attention_bwd.launches_by_route),
                       "ssd_scan": dict(ssd_scan.launches_by_route),
                       "ssd_scan_bwd": dict(ssd_scan_bwd.launches_by_route),
                       **{name: dict(getattr(moe_dispatch, name).launches_by_route)
                          for name in B2 + B2_BWD},
                       **{name: dict(fn.launches_by_route)
                          for name, fn in fused_wrappers().items()}}}


def steps_train(arch: str, held, mesh, smi: str, counters: dict) -> dict:
    """``make_train_step`` for ``arch`` at full width and depth on ``mesh``
    (bf16, AdamW at its default rate, remat, ``TRAIN_BATCH`` x ``TRAIN_SEQ``)
    held to ``train_step`` from the same weights on the same batches: its
    loss at each of the first ``STEPS_HELD`` steps within ``TRAIN_LOSS_TOL``
    (the second loss reads the first update), the parameters ``held``
    (``blocks.-1`` the last layer) within ``STEPS_PARAM_TOL`` of the
    update's size, then ``STEPS_TRAIN`` steps timed beside the 1×1 dry run's
    train terms, with ``train_launches`` (K2's and K3's routes as in
    ``train_phase``). Returns the counted launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_leaves
    from repro_torch.train import (DataConfig, MarkovDataset, make_optimizer,
                                   optimizer_for_config, train_step)
    dev = torch.device("cuda")
    cfg = get_config(arch)
    held = tuple(k.replace("blocks.-1.", f"blocks.{cfg.num_layers - 1}.") for k in held)
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
    want = train_launches(cfg, n, adamw_per_step(cfg))
    mean_s = sum(step_s[1:]) / n
    terms = dry_terms(arch, cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    routes = counted["routes"]
    ok = (loss_err <= TRAIN_LOSS_TOL and counted["launches"] == want
          and max(param_rel.values()) <= STEPS_PARAM_TOL
          and routes["flash_attention"]["simt"] == 0 and routes["flash_attention_bwd"]["simt"] == 0
          and routes["ssd_scan"]["simt"] == 0 and routes["ssd_scan_bwd"]["simt"] == 0
          and routes["ssd_scan_bwd"]["sm90"] == want["ssd_scan_bwd"]
          and all(routes[k] == v for k, v in nc_routes(want).items())
          and sm90_layout_copies(counted) == 0
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
        raise AssertionError(f"steps: {arch} train step {losses} vs {direct}, {param_rel}, "
                             f"{counted}")
    tally_conv_routes(routes)
    del model, opt, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return counted["launches"]


def steps_phase(smi: str, counters: dict) -> dict:
    """The reference's entry points on the card: ``make_train_step``,
    ``make_prefill_step`` and ``make_decode_step`` on ``make_host_mesh()``.

    phi4-mini-3.8b, then mamba2-1.3b, at full width and depth, bf16, random
    weights from seed 0: the train step held to ``train_step`` and timed
    (``steps_train``); phi4's prefill and ``STEPS_DECODE`` decode steps at batch 4 with 1024
    prompt tokens against ``generate`` on the same weights and tokens
    (logits within the bf16 tolerance, greedy ids equal); mamba2-1.3b's
    prefill likewise, through K3. Every kernel's count is zeroed just
    before each timed run and read just after: K2 forward and backward and
    K3's forward and backward launch, all ``sm90``; phi4's decode steps
    launch what ``expected_launches`` gives the steps beyond the prefill
    (B4, B7 and B8 once a layer and step). Beside each time, the dry run's three terms for
    the same shape on the 1×1 mesh. Returns the launches by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    mesh = make_host_mesh()
    by_path = {"flash_attention": {}, "flash_attention_bwd": {}, "ssd_scan": {}, "ssd_scan_bwd": {},
               "adamw": {}, **{name: {} for name in FUSED}}
    tol = TOL["bfloat16"]

    # train: the direct path's losses, then the mesh step's from the same start
    for arch, held in ((TRAIN_ARCH, ("embed", "blocks.0.attn.wq", "blocks.-1.mlp.w_down")),
                       (SSM_TRAIN_ARCH, ("embed", "blocks.0.ssm.in_proj",
                                         "blocks.-1.ssm.out_proj"))):
        counted = steps_train(arch, held, mesh, smi, counters)
        for kernel in ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
                       "adamw", *FUSED):
            if counted[kernel]:
                by_path[kernel][f"steps {arch} train"] = counted[kernel]

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
            zero_counts(counters)
            t0 = time.perf_counter()
            for _ in range(STEPS_DECODE):
                out, caches, clen = decode(model, ids[-1], caches, clen)
                ids.append(torch.argmax(out, dim=-1))
            torch.cuda.synchronize()
            decode_s = (time.perf_counter() - t0) / STEPS_DECODE
            decoded = read_counts(counters)
            # the decode steps' launches alone: those of the prefill and the
            # steps less the prefill's
            alone, steps = expected_launches(cfg), expected_launches(cfg, STEPS_DECODE)
            decode_want = {k: steps[k] - alone[k] for k in steps}
            ok = (ok and torch.equal(torch.cat(ids, dim=1), want.ids)
                  and decoded["launches"] == decode_want and sm90_layout_copies(decoded) == 0
                  and all(decoded["routes"][k] == v for k, v in nc_routes(decode_want).items()))
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
        ok = (ok and counted["launches"] == want_launches and sm90_layout_copies(counted) == 0
              and counted["routes"]["flash_attention"]["simt"] == 0
              and counted["routes"]["ssd_scan"]["simt"] == 0
              and all(counted["routes"][k] == v for k, v in nc_routes(want_launches).items()))
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
            record.update(decode_launches=decoded["launches"], decode_routes=decoded["routes"],
                          decode_want_launches=decode_want)
            record.update(decode_s_per_token=decode_s, decode_tokens_per_s=SERVE_BATCH / decode_s,
                          decode_roofline=beside(decode_s, dry_terms(arch, cfg, "decode",
                                                                     SERVE_BATCH, SERVE_PROMPT)))
        emit(record)
        if not ok:
            raise AssertionError(f"steps: {arch} prefill/decode: err {err}, {counted}")
        tally_conv_routes(counted["routes"])
        if with_decode:
            tally_conv_routes(decoded["routes"])
        if want_launches["flash_attention"]:
            by_path["flash_attention"][f"steps {arch} prefill"] = counted["launches"]["flash_attention"]
        if ssm:
            by_path["ssd_scan"][f"steps {arch} prefill"] = counted["launches"]["ssd_scan"]
        for kernel in FUSED:
            if counted["launches"][kernel]:
                by_path[kernel][f"steps {arch} prefill"] = counted["launches"][kernel]
            if with_decode and decoded["launches"][kernel]:
                by_path[kernel][f"steps {arch} decode"] = decoded["launches"][kernel]
        del model, prefill, want
        gc.collect()
        torch.cuda.empty_cache()
    return {k: v for k, v in by_path.items() if v}


DRYRUN_SHAPES = ("prefill_32k", "decode_32k")


def dryrun_phase(smi: str) -> None:
    """``run_one`` for every config at the 16×16 mesh and each of
    ``DRYRUN_SHAPES``, on the meta device over a fake process group: each
    must be ok. Per record the bottleneck, the three terms, the collective
    bytes by kind and the seconds; for an MoE config also ``useful_ratio``
    and the per-device FLOPs times the devices over the 1×1 mesh's (the
    whole step's) FLOPs: 1 when no product is repeated across a mesh dim,
    above it by the capacity's padding and the router products, which every
    device of a data rank computes as the dense layers' replicated weights
    are."""
    from repro_torch.configs import ALIASES, get_config
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.mesh import release
    t0 = time.perf_counter()
    records = []
    for shape in DRYRUN_SHAPES:
        for arch in sorted(ALIASES):
            r = run_one(arch, shape, "single", save=False, verbose=False)
            rec = {k: r.get(k) for k in ("arch", "shape", "ok", "bottleneck", "t_compute",
                                         "t_memory", "t_collective", "collective_by_op",
                                         "collective_count", "seconds", "error")}
            if r["ok"] and get_config(arch).uses_moe:
                whole = run_one(arch, shape, "host", save=False, verbose=False)
                rec.update(useful_ratio=r["useful_ratio"],
                           flops_over_whole=r["per_device_flops"] * r["chips"]
                           / whole["per_device_flops"])
            records.append(rec)
    release()
    failed = [(r["arch"], r["shape"], r["error"]) for r in records if not r["ok"]]
    emit({"phase": "dryrun", "mesh": "single", "shapes": DRYRUN_SHAPES, "records": records,
          "ok_count": len(records) - len(failed), "failed": len(failed),
          "seconds": time.perf_counter() - t0, "smi": smi})
    if failed:
        raise AssertionError(f"dry run failed at {failed}")


# moe_mesh: the MoE layer's mesh path at olmoe-1b-7b's full width, each rank
# of a 2x2 layout (batch 2 x experts 2) run on the card in turn with the
# collectives' results formed in the process; then the context-parallel
# decode softmax at phi4-mini-3.8b's decode (batch 4, a 1024-slot cache in
# 16 pieces), (cache_len, window) cases: a full and a partly filled cache,
# a window inside the cache, and most pieces empty
MOE_MESH_ARCH = "olmoe-1b-7b"
MOE_MESH_TOKENS = (4, 1024)
MOE_MESH_LAYOUT = {"batch": 2, "experts": 2, "slots": 1}
CP_ARCH = "phi4-mini-3.8b"
CP_BATCH, CP_SLOTS, CP_PIECES = 4, 1024, 16
CP_CASES = ((1024, None), (1000, None), (700, 256), (40, None))


def moe_mesh_check(num_experts: int, k: int, d: int, ff: int, batch: int, seq: int,
                   dtype, layout: dict, device, cf: float = 1.25, seed: int = 0) -> dict:
    """``moe_device_body`` for every rank of ``layout`` (rank by rank, in
    this process) against ``moe_ffn`` on the whole batch, random weights and
    tokens from ``seed``. The expert choices of the whole batch are the ones
    the ranks' routers made (``routing``): the two paths' router products
    differ in rows and may round a top-k tie apart. Returns the largest
    output difference and output, whether the kept assignments and slots
    are equal, and the FLOPs of the ranks against the whole layer's."""
    import torch
    from repro_torch.launch.op_analysis import analyze
    moe = importlib.import_module("repro_torch.models.moe")
    coll = importlib.import_module("repro_torch.sharding.collectives")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = moe.init_moe(gen, d, num_experts, ff, dtype=dtype)
    x = torch.randn((batch, seq, d), generator=gen, device=device).to(dtype)
    t = batch * seq
    x2d = x.reshape(t, d)
    lay = moe.MoELayout(*(layout[g] for g in ("batch", "experts", "slots")))
    tb, el = t // lay.n_batch, num_experts // lay.n_experts

    def body(c):
        r = lay.at(c)
        e = slice(r.experts * el, (r.experts + 1) * el)
        return moe.moe_device_body(x2d[r.batch * tb:(r.batch + 1) * tb], params["router"],
                                   params["w_gate"][e], params["w_up"][e], params["w_down"][e],
                                   k, cf, t, r)
    chosen = []
    with torch.no_grad():                # (the op counter sees no matmul under inference mode)
        with routing("record", chosen):
            ranks, mesh_stats = analyze(coll.rank_by_rank, body, lay.sizes)
        per_batch = len(chosen) // lay.n_batch
        ids = torch.cat(chosen[::per_batch])
        own = moe.router_topk(x2d, params["router"], k)[1]
        with routing("replay", [ids]):
            want, whole_stats = analyze(moe.moe_ffn, params, x, num_experts, k, cf)
        plan = moe.dispatch_plan(ids, num_experts, moe.capacity(t, k, num_experts, cf))
    outs = [[r[0] for c, r in sorted(ranks.items()) if c[0] == b] for b in range(lay.n_batch)]
    got = torch.cat([o[0] for o in outs]).reshape(x.shape)
    same_plan = all(all(torch.equal(a, b) for a, b in zip(r[1], plan)) for r in ranks.values())
    cap = moe.capacity(t, k, num_experts, cf)
    return {"max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_abs_out": float(want.float().abs().max()),
            "ranks_agree": all(torch.equal(o, os_[0]) for os_ in outs for o in os_),
            "plan_equal": same_plan, "kept": int(plan.keep.sum()),
            "dropped": int((~plan.keep).sum()), "capacity": cap,
            "padded_capacity": next(iter(ranks.values()))[2],
            "router_ties_apart": int((own != ids).any(dim=1).sum()),
            "flops_ranks_over_whole": mesh_stats.flops / whole_stats.flops,
            "ranks": len(ranks)}


def decode_cp_check(heads: int, kv_heads: int, hd: int, batch: int, slots: int, pieces: int,
                    cases, dtype, device, seed: int = 0) -> list:
    """``decode_device_body`` over ``pieces`` sequence pieces of one cache
    (rank by rank) against ``decode_attention`` on the whole cache, per
    (cache_len, window) case. Returns the largest difference and output
    per case."""
    import torch
    from repro_torch.models.attention import decode_attention, decode_device_body
    coll = importlib.import_module("repro_torch.sharding.collectives")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = torch.randn((batch, 1, heads, hd), generator=gen, device=device).to(dtype)
    ck = torch.randn((batch, slots, kv_heads, hd), generator=gen, device=device).to(dtype)
    cv = torch.randn((batch, slots, kv_heads, hd), generator=gen, device=device).to(dtype)
    n = slots // pieces
    out = []
    with torch.inference_mode():
        for cache_len, window in cases:
            want = decode_attention(q, ck, cv, cache_len, window)
            got = coll.rank_by_rank(
                lambda c: decode_device_body(q, ck[:, c["seq"] * n:(c["seq"] + 1) * n],
                                             cv[:, c["seq"] * n:(c["seq"] + 1) * n],
                                             cache_len, window, c["seq"] * n, slots),
                {"seq": pieces})
            diff = max(float((g.float() - want.float()).abs().max()) for g in got.values())
            out.append({"cache_len": cache_len, "window": window, "max_abs_err": diff,
                        "max_abs_out": float(want.float().abs().max())})
    return out


def moe_mesh_phase(smi: str, counters: dict) -> None:
    """The mesh paths' per-device bodies on the card (``moe_mesh_check`` at
    ``MOE_MESH_ARCH``'s full width in bf16, ``decode_cp_check`` at
    ``CP_ARCH``'s decode in bf16 and f32), every kernel's count zeroed just
    before and read just after: B2's fill and combine and B8's forward
    (``expert_swiglu``'s gate) once each in every rank's body and in the
    whole layer's ``moe_ffn``, all on the ``vector`` route, and no other
    kernel (the expert products are cuBLAS's, decode attention plain).
    Returns B2's and B8's launches."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(MOE_MESH_ARCH)
    t0 = time.perf_counter()
    zero_counts(counters)
    moe_rec = moe_mesh_check(cfg.num_experts, cfg.experts_per_token, cfg.d_model, cfg.moe_d_ff,
                             *MOE_MESH_TOKENS, torch.bfloat16, MOE_MESH_LAYOUT, "cuda",
                             cfg.capacity_factor)
    moe_s = time.perf_counter() - t0
    pc = get_config(CP_ARCH)
    cp = {dt: decode_cp_check(pc.num_heads, pc.num_kv_heads, pc.resolved_head_dim, CP_BATCH,
                              CP_SLOTS, CP_PIECES, CP_CASES, getattr(torch, dt), "cuda")
          for dt in ("bfloat16", "float32")}
    counts = read_counts(counters)
    tol = {dt: TOL[dt]["atol"] for dt in TOL}
    moe_ok = (moe_rec["plan_equal"] and moe_rec["ranks_agree"]
              and moe_rec["max_abs_err"] <= tol["bfloat16"] * moe_rec["max_abs_out"])
    cp_ok = all(c["max_abs_err"] <= tol[dt] * c["max_abs_out"] for dt, cs in cp.items()
                for c in cs)
    b2 = moe_rec["ranks"] + 1
    layer = B2 + B8[:1]
    want = {k: b2 if k in layer else 0 for k in counts["launches"]}
    launched_ok = (counts["launches"] == want and sm90_layout_copies(counts) == 0
                   and all(counts["routes"][k] == {"vector": b2, "scalar": 0} for k in layer))
    emit({"phase": "moe_mesh", "arch": cfg.name, "tokens": MOE_MESH_TOKENS,
          "experts": cfg.num_experts, "top_k": cfg.experts_per_token, "d_model": cfg.d_model,
          "layout": MOE_MESH_LAYOUT, "moe": moe_rec, "moe_tol": tol["bfloat16"], "moe_s": moe_s,
          "decode_cp": {"arch": pc.name, "batch": CP_BATCH, "slots": CP_SLOTS,
                        "pieces": CP_PIECES, "cases": cp, "tol": tol},
          "launches": counts["launches"], "routes": {k: counts["routes"][k] for k in layer},
          "layout_copies": counts["layout_copies"], "want_launches": want, "seconds": time.perf_counter() - t0, "smi": smi,
          "ok": moe_ok and cp_ok and launched_ok})
    if not (moe_ok and cp_ok and launched_ok):
        raise AssertionError(f"moe_mesh: MoE {moe_rec}, decode {cp}, launches {counts}")
    return {k: counts["launches"][k] for k in layer}


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


def sm90_layout_copies(counted: dict) -> int:
    """Tensors that K2's and K3's wrappers copied to or from a kernel's
    layout on the ``sm90`` route since the counts were zeroed: the model's
    (B, S, H, ·) layout reaches those kernels as it is, so 0."""
    return sum(c["sm90"] for c in counted["layout_copies"].values())


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
    from repro_torch.kernels.adamw import adamw_update
    from repro_torch.kernels.flash_attention import (ROUTES, _route, flash_attention,
                                                     flash_attention_bwd, flash_attention_plain)
    from repro_torch.kernels.batchsim_advance import batchsim_advance
    from repro_torch.kernels.int8_quant import quantize_int8
    from repro_torch.kernels.moe_dispatch import (moe_combine, moe_combine_bwd, moe_fill,
                                                  moe_fill_bwd)
    from repro_torch.kernels.ssd_scan import ROUTES as SSD_ROUTES
    from repro_torch.kernels.ssd_scan import _route as ssd_route
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_plain

    # 1. card -----------------------------------------------------------------
    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "card", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build ----------------------------------------------------------------
    t_start = t0 = time.perf_counter()
    logs = build.build(["flash_attention", "flash_attention_sm90", "flash_attention_bwd",
                        "flash_attention_bwd_sm90", "ssd_scan", "ssd_scan_sm90", "ssd_scan_bwd",
                        "ssd_scan_bwd_sm90",
                        "int8_quant", "int8_quant_sm90", "batchsim_advance", "adamw",
                        "moe_dispatch", "rms_norm", "causal_conv1d", "cross_entropy", "rope",
                        "swiglu"])
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
          "batchsim_advance_ptxas": b1_ptxas,
          "adamw_ptxas": ptxas_by_function(logs.get("adamw", "")),
          "moe_dispatch_ptxas": ptxas_by_function(logs.get("moe_dispatch", "")),
          "rms_norm_ptxas": ptxas_by_function(logs.get("rms_norm", "")),
          "causal_conv1d_ptxas": ptxas_by_function(logs.get("causal_conv1d", "")),
          "cross_entropy_ptxas": ptxas_by_function(logs.get("cross_entropy", "")),
          "rope_ptxas": ptxas_by_function(logs.get("rope", "")),
          "swiglu_ptxas": ptxas_by_function(logs.get("swiglu", ""))})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timings = {}
    counters = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
                "int8_quant": quantize_int8, "batchsim_advance": batchsim_advance,
                "flash_attention_bwd": flash_attention_bwd, "ssd_scan_bwd": ssd_scan_bwd,
                "adamw": adamw_update, "moe_fill": moe_fill, "moe_combine": moe_combine,
                "moe_fill_bwd": moe_fill_bwd, "moe_combine_bwd": moe_combine_bwd,
                **fused_wrappers()}

    # 3. kernel against plain --------------------------------------------------
    t0 = time.perf_counter()
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
    # its own generator: the phases after it draw the inputs they drew before it
    gen_ssd_bwd = torch.Generator(device=dev)
    gen_ssd_bwd.manual_seed(1)
    timings["ssd_scan_bwd"] = check_ssd_bwd(gen_ssd_bwd, smi)
    gen_adamw = torch.Generator(device=dev)
    gen_adamw.manual_seed(2)
    timings["adamw"] = check_adamw(gen_adamw, smi)
    gen_b2 = torch.Generator(device=dev)
    gen_b2.manual_seed(3)
    timings.update(check_moe_dispatch(gen_b2, smi))
    gen_nc = torch.Generator(device=dev)
    gen_nc.manual_seed(4)
    timings.update(check_norm_conv(gen_nc, smi))
    gen_lr = torch.Generator(device=dev)
    gen_lr.manual_seed(5)
    timings.update(check_loss_rope(gen_lr, smi))
    gen_sw = torch.Generator(device=dev)
    gen_sw.manual_seed(6)
    timings.update(check_swiglu(gen_sw, smi, ptxas_by_function(logs.get("swiglu", ""))))
    gen_layout = torch.Generator(device=dev)
    gen_layout.manual_seed(7)
    for kernel, rec in check_layouts(gen_layout, smi).items():
        timings[kernel]["layout"] = rec
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})

    # 4. each served model: kernel-vs-plain check, serve, profile --------------
    t0 = time.perf_counter()
    by_path = {"flash_attention": {}, "ssd_scan": {}, "moe_fill": {}, "moe_combine": {},
               **{name: {} for name in FUSED}}
    for arch, check_cut, serve_cut in SERVED_MODELS:
        for kernel, n in serve_model(arch, check_cut, serve_cut, gen, smi, counters).items():
            if n:
                by_path[kernel][arch] = n
    moe_route_check(smi, counters)
    emit({"phase": "serve_done", "seconds": time.perf_counter() - t0})

    # 4b. training: phi4-mini-3.8b and mamba2-1.3b at full width, then the
    # demo's checkpoint
    t0 = time.perf_counter()
    for arch, cut, kind in TRAIN_CHECKS:
        train_check(counters, arch, cut, kind)
    adamw_route_check(smi, counters)
    trained = train_phase(smi, counters)
    trained_ssm = train_phase(smi, counters, SSM_TRAIN_ARCH, SSM_TRAIN_STEPS)
    trained_moe = train_phase(smi, counters, MOE_TRAIN_ARCH, MOE_TRAIN_STEPS, MOE_TRAIN_CUT)
    ckpt = train_ckpt_phase(smi, counters)
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0})
    by_path["flash_attention"]["phi4-mini-3.8b train"] = trained["flash_attention"]
    by_path["flash_attention"]["demo-100m train"] = ckpt["flash_attention"]
    by_path["flash_attention_bwd"] = {"phi4-mini-3.8b train": trained["flash_attention_bwd"],
                                      "demo-100m train": ckpt["flash_attention_bwd"]}
    by_path["ssd_scan"][f"{SSM_TRAIN_ARCH} train"] = trained_ssm["ssd_scan"]
    by_path["ssd_scan_bwd"] = {f"{SSM_TRAIN_ARCH} train": trained_ssm["ssd_scan_bwd"]}
    by_path["adamw"] = {f"{TRAIN_ARCH} train": trained["adamw"],
                        f"{SSM_TRAIN_ARCH} train": trained_ssm["adamw"],
                        f"{MOE_TRAIN_ARCH} train": trained_moe["adamw"],
                        "demo-100m train": ckpt["adamw"]}
    moe_train = f"{MOE_TRAIN_ARCH} train"
    by_path["flash_attention"][moe_train] = trained_moe["flash_attention"]
    by_path["flash_attention_bwd"][moe_train] = trained_moe["flash_attention_bwd"]
    for kernel in B2 + B2_BWD:
        by_path.setdefault(kernel, {})[moe_train] = trained_moe[kernel]
    for kernel in FUSED:
        for path, counted in ((f"{TRAIN_ARCH} train", trained), (f"{SSM_TRAIN_ARCH} train",
                                                                   trained_ssm),
                              (moe_train, trained_moe), ("demo-100m train", ckpt)):
            if counted[kernel]:
                by_path[kernel][path] = counted[kernel]

    # 4c. the mesh steps on the card's 1×1 mesh, the dry run, the lane figures
    t0 = time.perf_counter()
    for kernel, paths in steps_phase(smi, counters).items():
        by_path.setdefault(kernel, {}).update(paths)
    dryrun_phase(smi)
    for kernel, n in moe_mesh_phase(smi, counters).items():
        by_path[kernel]["moe_mesh"] = n
    lanes_phase(smi)
    emit({"phase": "steps_dryrun_lanes_done", "seconds": time.perf_counter() - t0})
    launches = {k: sum(v.values()) for k, v in by_path.items()}

    # 5. Puzzle's runtime -----------------------------------------------------
    t0 = time.perf_counter()
    k1_runtime, k1_runtime_routes = runtime_phase(smi, counters)
    emit({"phase": "runtime_done", "seconds": time.perf_counter() - t0})

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

    if sum(CONV_FWD_ROUTES.values()) != launches["causal_conv1d_fwd"]:
        raise AssertionError(f"B5's forward: launches by route {CONV_FWD_ROUTES}, by path "
                             f"{by_path['causal_conv1d_fwd']}")
    emit({"phase": "done", "seconds_since_build": time.perf_counter() - t_start,
          "incomplete_profiles": INCOMPLETE_PROFILES})
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
         "launches_by_route": {"sm90": launches["flash_attention_bwd"]
                               - by_path["flash_attention_bwd"]["demo-100m train"],
                               "simt": by_path["flash_attention_bwd"]["demo-100m train"]},
         "launches_by_path": by_path["flash_attention_bwd"],
         **timings["flash_attention_bwd"]},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd_sm90.cu",
         "sources_by_route": {
             "sm90": "src/repro_torch/kernels/csrc/ssd_scan_bwd_sm90.cu",
             "simt": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"},
         "replaces": "src/repro/models/ssm.py:106",
         "launches": launches["ssd_scan_bwd"],
         # every path's routes were held to all-sm90 (train_routes, steps_train)
         "launches_by_route": {"sm90": launches["ssd_scan_bwd"], "simt": 0},
         "launches_by_path": by_path["ssd_scan_bwd"], **timings["ssd_scan_bwd"]},
        {"name": "adamw", "route": "cuda", "source": "src/repro_torch/kernels/csrc/adamw.cu",
         "replaces": "src/repro/train/optimizer.py:72", "launches": launches["adamw"],
         "launches_by_path": by_path["adamw"], **timings["adamw"]},
        {"name": "moe_fill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
         "replaces": "src/repro/models/moe.py:108", "launches": launches["moe_fill"],
         "launches_by_path": by_path["moe_fill"], **timings["moe_fill"]},
        {"name": "moe_combine", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
         "replaces": "src/repro/models/moe.py:121", "launches": launches["moe_combine"],
         "launches_by_path": by_path["moe_combine"], **timings["moe_combine"]},
        {"name": "moe_fill_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
         "replaces": "src/repro/models/moe.py:108",
         "launches": launches["moe_fill_bwd"], "launches_by_path": by_path["moe_fill_bwd"],
         **timings["moe_fill_bwd"]},
        {"name": "moe_combine_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
         "replaces": "src/repro/models/moe.py:121",
         "launches": launches["moe_combine_bwd"], "launches_by_path": by_path["moe_combine_bwd"],
         **timings["moe_combine_bwd"]},
        *({"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{source}.cu", "replaces": replaces,
           "launches": launches[name], "launches_by_path": by_path[name],
           **({"launches_by_route": dict(CONV_FWD_ROUTES)} if name == "causal_conv1d_fwd"
              else {}), **timings[name]}
          for name, source, replaces in (
              ("rms_norm_fwd", "rms_norm", "src/repro/models/layers.py:17"),
              ("rms_norm_bwd", "rms_norm", "src/repro/models/layers.py:17"),
              ("gated_rms_norm_fwd", "rms_norm", "src/repro/models/ssm.py:200"),
              ("gated_rms_norm_bwd", "rms_norm", "src/repro/models/ssm.py:200"),
              ("causal_conv1d_fwd", "causal_conv1d", "src/repro/models/ssm.py:76"),
              ("causal_conv1d_bwd", "causal_conv1d", "src/repro/models/ssm.py:76"),
              ("cross_entropy_fwd", "cross_entropy", "src/repro/train/loop.py:41"),
              ("cross_entropy_bwd", "cross_entropy", "src/repro/train/loop.py:41"),
              ("rope_qk_fwd", "rope", "src/repro/models/layers.py:44"),
              ("rope_qk_bwd", "rope", "src/repro/models/layers.py:44"),
              ("swiglu_fwd", "swiglu", "src/repro/models/layers.py:28"),
              ("swiglu_bwd", "swiglu", "src/repro/models/layers.py:28")))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
