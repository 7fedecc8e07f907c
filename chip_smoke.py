#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each one fails the run if it fails; nothing falls back to the CPU):

1. device: the card's name and power limit;
2. build: ``nvcc`` compiles every kernel of ``src/repro_torch/kernels/csrc``;
3. kernels vs their plain PyTorch versions on the card, over the reference
   test sweeps (``tests/test_kernels.py`` SHAPES, f32 and bf16, at
   rtol=3e-3, atol=1e-5; ``tests/test_wire.py``'s uplink shapes, f32 and
   bf16 v/e_old; ``masked_accumulate``, ``fused_uplink`` and
   ``fused_uplink_ef`` bit for bit) and the main path's shapes; the four
   leaf-table kernels, which cover a list of leaves in one call, over
   VGG-9's 34 full-width leaves (f32 and bf16; ``masked_accumulate`` in
   place with w = 0 rows; the uplinks at K = 20 with fedldf's w = 0 and
   gate = 0 rows, ``fused_uplink`` also with every w non-zero; the Eq. 3
   divergence at K = 20 and K = 1), SHAPES (1, 1), (9, 2049), (62, 33) as
   one-entry and mixed tables (a scalar leaf, a misaligned view), 100
   leaves in 3 calls, and uplink rows whose inf, NaN or huge scale (or
   non-finite v) must give the plain NaN; the divergence within the
   tolerance above and bit for bit the per-leaf kernel composed in leaf
   order from 0 (also over stacked units, n = 3), the others bit for bit;
4. ``run_training`` in ``mode="vmap"`` for 3 rounds on full-width VGG-9
   with the paper's FL setup (N=50, K=20, n=4, B=32, lr=0.05, fedldf), one
   ``sqdiff_rowsum`` call a round (over the round's leaf table); one
   round's divergence matrix, selection and new params are held against
   the same round computed with the plain Eq. 3 reduction;
5. the same in ``mode="scan"``; its round must match phase 4's to 2e-5,
   and it must call ``masked_accumulate`` and ``sqdiff_rowsum`` once a
   client (20 a round, each over the client's leaf table);
6. the packed compressed uplink, setting A (int8 levels, error feedback):
   ``run_training`` for 3 rounds, exact uplink bytes, the (50, ...)
   residual store and 1 ``fused_uplink_ef`` launch a round (over the 34
   leaves); one round held against the same round through the plain uplink
   kernels (identical selection and levels, params within 2e-5) and
   against the legacy unfused chain (relative L2 below 1e-4), and the
   kernel on the round's own call, bit for bit;
7. setting B (int4 levels, no error feedback): 2 rounds, exact uplink
   bytes, 1 ``fused_uplink`` launch a round (over the 34 leaves), one round
   against plain, and the kernel on the round's own call, bit for bit;
8. kernel times at the main path's shapes beside the byte bound, the plain
   version and a library call, and each path's round time; for the
   leaf-table kernels also the single-leaf entry a leaf, and
   ``torch._foreach_addcmul_`` (with its kernel count) or every w
   non-zero; for the Eq. 3 divergence (a vmap round, and a scan-round
   client at K=1) also the old per-leaf composition of the unit sums, the
   call with b already in L2, ``torch._foreach_norm(torch._foreach_sub(a,
   b))`` at K=1, and its two kernels' device times under the profiler;
9. serving full-width, full-depth qwen3-1.7b in f32 (TF32 off): batch 4, a
   2048-token prompt from a numpy seed, 32 greedy decode steps, through
   the flash-attention kernel, then the same steps through its plain
   version on the card and ``forward`` over the same tokens; logits must
   agree within 1e-3 of max |logit| and the greedy tokens must be equal
   except at a step whose top-2 gap is below that;
10. the same serving in the config's own bf16, timed: prefill ms, decode ms
   per token, 28 kernel launches per prefill (all on the tensor-core route)
   and per decode step (all on the split-KV route, none on the CUDA cores),
   and each route's device time per prefill and per decode step beside its
   bound, the plain version and ``scaled_dot_product_attention``; then the
   serve launcher (``python -m repro_torch.launch.serve --arch qwen3-1.7b``)
   once;
11. the device-resident engine (``run_training_scan``) at the paper's FL
   setup on the paper's 50,000 synthetic training images, in vmap, scan
   and setting A: 4 rounds with ``eval_every=2`` (blocks end after rounds
   1, 3 and 4); the same call again (run to run), and
   ``run_training(sampler="device")``, which must equal it bit for bit
   (within 2e-5 if two runs of the same call already differ); the same
   kernel launches a round as phases 4-7; exact uplink bytes in every
   round; resume, 2 + 2 rounds against 4; one 2-round block enqueued under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) and then
   pulled once; the block's device busy time under ``torch.profiler`` and
   its idle share; the engine's round time beside the host-sampler
   driver's, and the host->device bytes each copies a round;
12. each of the 7 registered algorithms for 2 rounds through the engine
   (vmap), plus fedadp and fedldf in scan mode: launches a round from the
   strategy's flags, uplink bytes against ``run_training(sampler=
   "device")`` and, where it is fixed, the formula;
13. federated LoRA fine-tuning of full-width, full-depth qwen3-1.7b
   (random bf16 weights, rank-8 adapters on every attention and MLP
   projection, ``lora_partition``; 8 clients by domain over 320 synthetic
   128-token sequences, K=4, n=2, B=4, fedldf): the partition's sizes;
   ``run_training_scan`` for 2 rounds in vmap, scan and setting A (int8 +
   EF) with the frozen base the start's own tensors, unchanged, the
   adapters moved, exact uplink bytes a round and the launches a round
   the round builders make (every bf16 attention launch on the
   tensor-core route); a client's local step twice, bit for bit (the scan
   round's recompute); in f32 one round through the kernel against the
   same round through the plain attention under autograd, against scan
   mode and against ``remat_blocks`` (identical selection, divergence
   within 3e-3, adapters within 2e-5), with peak memory;
   ``FlashAttentionFn``'s gradients at one layer's training shape against
   autograd of the plain version (1e-4 f32, 2e-2 bf16 of max |grad|) and
   its forward and backward times beside SDPA's; each mode's round
   wall-clock and device idle share;
14. serving the ssm and hybrid families at full width and depth:
   mamba2-780m (48 attention-free Mamba-2 SSD blocks) and hymba-1.5b (32
   blocks of attention ∥ SSD, 25 query heads over 5 KV heads at hd 64),
   random weights from seed 0, batch 4, a 2048-token prompt, 32 greedy
   decode steps; the parameter tree's params, bytes and leaves and the
   cache's bytes at max_len 2080 asserted; in f32 (TF32 off) the prefill
   and decode logits within 1e-3 of max |logit| of ``forward`` over the
   same tokens and, for hymba, of the same steps through the plain
   attention, the greedy tokens equal but at near-ties; at one
   full-width layer the chunked SSD (``ssd_fwd``) against its token-by-
   token recurrence (``ssd_step``) at S = 512 and 300, within 1e-4 of max
   |y| (state and conv tail alike); in bf16, timed: prefill ms and decode
   ms a token (median of 3), device busy time, idle share and top device
   ops of one prefill and one decode step under ``torch.profiler``, peak
   memory, and the launches (hymba 32 a prefill, all on the tensor-core
   route, and 32 a decode step, all on the split-KV route; mamba2 none),
   hymba's kernel on its own main-path calls against plain and its times;
   then the serve launcher once for each;
15. serving deepseek-moe-16b at full width and depth (28 blocks of
   attention, 16 query over 16 KV heads at hd 128, and 64 routed experts
   of 1408, top-6, + 2 shared), random weights from seed 0, the same
   traffic as phase 14; the parameter tree's params, bytes and leaves and
   the cache's bytes asserted; in f32 (TF32 off) at 4 layers (the f32
   weights of all 28 take 67.5 GB) and a capacity factor of 11 (no call
   drops a choice), the prefill and decode logits within 1e-3 of max
   |logit| of ``forward`` over the same tokens, the greedy tokens equal
   but at near-ties; at the config's own 1.25, the prefill against
   ``forward`` over the prompt alone; at one full-width layer ``moe_fwd``
   against a per-expert loop (``tests/torch_moe_loop.py``) at capacity
   factors 1.25 and 0.5 (choices must drop), within 1e-4 of max |out| and
   1e-5 on the balance loss; in bf16, timed: prefill ms and decode ms a
   token (median of 3), device busy time, idle share and top device ops
   of one prefill and one decode step, peak memory, the dropped choices
   a layer of one prefill, the positions' cumulative sum in both layouts,
   the launches (28 a prefill on the tensor-core route, 28 a decode step
   on the split-KV route), the kernel on its own main-path calls against
   plain and its times; then the serve launcher once;
16. serving seamless-m4t-large-v2 at full width and depth (an enc-dec
   model: 24 non-causal encoder blocks over the frames, 24 decoder blocks
   of causal self-attention, cross-attention to the encoder's output and
   an MLP; 16 query over 16 KV heads at hd 64), random weights from seed
   0, batch 4, a 2048-token prompt, 2048 frames (drawn after the prompts
   from the same numpy generator, as the serve launcher draws them, and
   given to each run in its compute dtype) and 32 greedy decode steps; the parameter tree's params, bytes
   and leaves and the cache's bytes (self and cross K/V) asserted; in f32
   (TF32 off) at full depth the prefill and decode logits within 1e-3 of
   max |logit| of ``forward`` over the same tokens and frames and of the
   same steps through the plain attention, the greedy tokens equal but at
   near-ties, and the cross K/V bit for bit as the prefill wrote them
   after the 32 steps; in bf16, timed: prefill ms and decode ms a token
   (median of 3), device busy time, idle share and top device ops of one
   prefill and one decode step, peak memory, the launches (72 a prefill
   on the tensor-core route: 24 encoder, 24 decoder, 24 cross; 48 a
   decode step on the split-KV route: 24 self, 24 cross; none on the CUDA
   cores), the kernel on its own main-path calls (encoder, decoder,
   cross, decode self, decode cross) against plain and its times; then
   the serve launcher once;
17. round telemetry at the paper's setup on phase 11's 50,000 images, in
   vmap and setting A (int8 + EF): ``run_training_scan`` for 4 rounds
   (eval_every=2) with ``TelemetryConfig(ledger_path=..., profile_rounds=
   (1, 2))`` against ``telemetry=None``, bit for bit (within 2e-5 only if
   two telemetry-off runs already differ), and ``run_training(sampler=
   "device")`` with the same telemetry, whose ledger must equal the
   engine's field by field (loss, comm, taps, selection, uplink); every
   round's record: ``sel_count`` 4 in every unit, the selection's column
   sums equal to it, exact uplink bytes, ``wire_bits``,
   ``wire_unit_bytes`` and a finite ``state_residual_norm`` in A,
   ``wall_s`` > 0, ``mem_peak_bytes`` at most ``max_memory_allocated``;
   the profiler trace, one file holding exactly rounds 1-2's FL kernels
   (2 ``sqdiff_rowsum`` calls of 2 kernels, and 2 ``fused_uplink_ef``
   in A); one round's taps against the plain Eq. 3 reduction (and the EF
   residual norm against float64); a telemetry-on 2-round block under
   ``set_sync_debug_mode("error")`` and its one device->host copy; the
   monitor over the phase's ledger; the telemetry cost: round wall-clock,
   host enqueue, device busy and idle share, off and on, the taps' own
   device time and ledger bytes a round; then ``python -m
   repro_torch.launch.train --task cifar --paper-scale --rounds 2`` once,
   whose comm summary must give the exact bytes of 2 fedldf rounds;
18. the client mesh (``FLConfig(mesh=make_client_mesh())``, one process
   a rank, started with ``repro_torch.launch.mesh.spawn``; a rank that
   raises fails the run) at the paper's setup on phase 11's 50,000
   images, 3 rounds a run: (a) 4 gloo ranks sharing the card, the flat
   reduce, held to the unsharded engine on the same keyed draws (2e-5
   params, 1e-5 losses); (b) the two-tier reduce (2 groups of 2) within
   2e-5 of (a), the ledger's ``agg`` header and tier bytes (intra, cross,
   busiest host 37,677,648 B; flat 0, 56,516,472, 113,032,944); (c)
   setting A, held to the unsharded A within 2e-5 plus one int8 step, the
   N-row EF store bit for bit on every rank; (d) ``shard_samples`` on 2
   ranks: every round's batch and the trajectory bit for bit the
   replicated placement's, about half the dataset's bytes a rank; (e) the
   host driver and telemetry on equal the engine bit for bit, the
   monitor's tier line; (f) a NCCL world of every visible card, within
   2e-5 of unsharded, a 2-round block without a host sync. Every run: the
   exact uplink bytes, every rank's params bit for bit, and a round a rank
   1 fused ``all_reduce`` (or the two tiers' group reduce and ring
   shift), 1 divergence all-gather (setting A: and 1 of the EF rows), 1
   ``sqdiff_rowsum`` and in A 1 ``fused_uplink_ef``; then the round
   wall-clock (median of 3) of the D=4 gloo world and the NCCL world, the
   gloo staging copies, bytes and ms a round, each rank's kernel time
   under ``torch.profiler`` and the card's idle share from ``nvidia-smi``'s
   utilization (ranks sharing the card time-slice it, so their profiles
   overlap; the one-rank NCCL world also gives it from its profile). The
   same 4-rank world then runs the 2-D ``('clients', 'model')`` grids
   (``make_client_mesh(model=M)``: the params and the EF store held as
   1/M shards): (g) 2 x 2 fedldf, (h) 2 x 2 setting A, (i) 1 x 4 setting
   A, (j) 2 x 2 through the host driver with telemetry, equal to (g) bit
   for bit, its ledger header ``{"clients": 2, "model": 2}``. Each: the
   exact uplink bytes, every rank's params and each column's EF shards
   bit for bit, a round a rank 1 row all-gather, 1 all-reduce and 1
   divergence all-gather (A: and 1 of the EF rows), 1 ``sqdiff_rowsum``
   (A: and 1 ``fused_uplink_ef``); each round of (g)-(i), chained by
   resume from the grid's shards (equal to the one 3-round run bit for
   bit), against rank 0's 1-rank mesh round from the same params and EF
   store (2e-5, losses 1e-5; bit for bit at C = 1); the shards' bytes at
   rest a rank (params and the N = 50 store; exact, and the allocator's
   deltas), the ledger's tier bytes (the reference's ``agg_tier_bytes``
   at 1/M of the model), and each grid's round wall-clock (median of 3
   1-round blocks), peak rise and collectives a round;
19. the dry-run tooling (``repro_torch.launch``: ``shapes``, ``opcount``,
   ``dryrun``, ``roofline``, ``inspect``) counts two programs on the
   ``meta`` device, with no time taken again: (a) phase 10's bf16
   prefill of qwen3-1.7b (batch 4, prompt 2048), whose argument bytes
   must equal the params and prompt phase 10 allocated, exactly, and
   whose counted FLOPs must equal the plain prefill's matmuls, exactly;
   it prints first the counted share of phase 10's measured prefill
   (counted FLOPs / (s x 989e12): the matmuls this prefill does), then
   ``model_flops_for``, ``useful_flops_ratio`` (above 1 for a prefill:
   ``model_flops_for`` counts the embedding and the head at every
   position), the ``mfu`` (``model_flops_for`` / (s x 989e12), which
   counts that work too), ``t_compute``, ``t_memory`` and the measured
   time over max(``t_compute``, ``t_memory``), all three of the plain
   program (its attention writes every pair's f32 scores, which the
   card's kernel never does: no share of the card's roofline), and the
   top 5 FLOP ops;
   (b) phase 4's vmap FedLDF round of full-width VGG-9 at the paper's
   setup, whose argument bytes must equal phase 4's exactly; it prints
   the counted conv/matmul FLOPs a round and their share of the f32 rate
   (67e12) at phase 8's measured round time;
20. the six port examples (``examples/*_torch.py``): (a) each one's
   ``main(argv)`` in this process (quickstart ``--rounds 3``; compressed
   ``--bits 8``, ``--bits auto`` and ``--bits 4 --no-error-feedback``;
   custom_strategy; fedlama ``--rounds 4``; ``fl_cifar_vgg
   --paper-scale --rounds 2 --algos fedldf,fedavg``, its uplink exactly
   150,712,032 B and 753,552,960 B; serve_llm ``--rounds 2``), each
   run's launches exact by counter and none of the kernels' plain
   versions called, then ``examples/quickstart_torch.py`` as a script
   with ``PYTHONPATH=src``; (b) serve_llm's path at full width and depth
   in f32 through the example's own functions: mamba2-780m and
   hymba-1.5b from seed 0, 2 scan-mode rounds of every parameter (6
   clients, K=3, top-n 1, B=4, 48-token sequences): finite losses, the
   uplink the f32 of ``model + K·U·4`` bytes a round, 3
   ``sqdiff_rowsum`` and 3 ``masked_accumulate`` a round, hymba's 32
   flash launches a local step on ``route()``'s f32 route, the first
   local step's calls held against the plain attention at 1e-4; then 4
   prompts of 16 tokens and 12 greedy steps, every step's logits within
   1e-3 of max |logit| of ``forward`` and hymba's every flash call held
   against the plain attention; the reckoned f32 footprint beside the
   peak, the wall-clock of a warm 1-round ``run_training`` call (set-up
   included) and a profiled one's device busy time and idle share under
   ``torch.profiler``.

Flash attention has three routes (``kernels/flash_attention.py:route``):
the tensor-core prefill (``flash_attention_tc.cu``), the split-KV decode
(``flash_attention_decode.cu``) and the CUDA cores (``flash_attention.cu``,
f32 prefill and bf16 at hd 16 or 32). Phase 3 holds every route to the
plain version: ``tests/test_flash_kernel.py`` CASES (f32 and bf16, at 1e-4
/ 2e-2), a decode sweep (Sq 1, 5, 16; G 1, 2, 7, 8; kv_len 0, 1, a split
boundary ± 1 and Skv; causal and windowed), ragged and padded tensor-core
cases, a fully masked case a route, and the full-width prefill and decode
shapes of qwen3-1.7b, hymba-1.5b (G = 5, hd 64), deepseek-moe-16b (G =
1, hd 128) and seamless-m4t-large-v2 (G = 1, hd 64: a non-causal prefill,
a cross prefill over a ragged 1500 frames, a decode step and a cross
decode step over 2048 frames) in bf16 and f32. Phase 2 prints the
CUDA-core kernel's ``nvcc -Xptxas -v`` registers and spills and, from
the card, its shared memory and blocks an SM. Each f32 use of the
CUDA-core route holds its recorded calls to the plain version and times
them (a ``[times] ... [cuda_core route]`` line): qwen3-1.7b's prefill
(phase 9), the LoRA layer (13), hymba-1.5b's prefill (14),
deepseek-moe-16b's at 4 layers (15), seamless-m4t-large-v2's encoder,
decoder self and cross (16) and hymba-1.5b's local training step (20).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Phases 4-8 cut the data set to 10,000
training images (200 per client instead of the paper's 1,000) to keep
set-up short; phases 11-12, 17 and 18 use the paper's 50,000. Weights are
random, drawn from a fixed seed.
"""
import ast
import atexit
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ROUNDS = 3
ROUNDS_B = 2                # setting B (int4) runs fewer rounds
NUM_TRAIN = 10_000          # the paper's 50,000 cut 5x (set-up time)
ENGINE_TRAIN = 50_000       # phases 11-12: the paper's 50,000 images
ENGINE_TEST = 512           # test images for the engine's eval
ENGINE_ROUNDS = 4           # eval_every=2: blocks end after rounds 1, 3, 4
TOL = {"rtol": 3e-3, "atol": 1e-5}  # tests/test_kernels.py:33,45
EQUIV_TOL = 2e-5            # benchmarks/round_engine_bench.py:59
EXACT = {"rtol": 0.0, "atol": 0.0}   # the uplinks and accumulate vs plain
# the leaf tables' reference SHAPES (one-entry and mixed tables)
TABLE_SHAPES = [(1, 1), (9, 2049), (62, 33)]
# tests/test_kernels.py:18
SHAPES = [(1, 1), (1, 37), (4, 1000), (8, 2048), (9, 2049), (48, 5000),
          (3, 16384), (62, 33)]
# tests/test_wire.py:174-175 and :191
UPLINK_SHAPES = [(1, 1, 1), (3, 7, 129), (4, 16, 2048), (5, 33, 2049)]
UPLINK_EF_SHAPES = [(2, 5, 64), (4, 16, 2048), (3, 9, 515)]
# exact uplink bytes a round, n·Σ_u(ceil(p_u·b/8) + 5) + K·U·4, and the
# packed payload of K clients, for full-width VGG-9 at K=20, n=4
WANT_UPLINK = {8: 18_839_724, 4: 9_420_312}
WANT_PAYLOAD = {8: 94_194_849, 4: 47_097_789}
# tests/test_flash_kernel.py CASES: (bh, bkv, sq, skv, hd, causal, window)
FLASH_CASES = [(4, 2, 64, 64, 32, True, 0), (2, 2, 100, 100, 32, True, 0),
               (6, 2, 48, 48, 16, True, 7), (2, 1, 33, 65, 64, False, 0),
               (8, 1, 40, 40, 128, True, 0)]
FLASH_TOL = {"f32": 1e-4, "bf16": 2e-2}    # tests/test_flash_kernel.py:37
# tests/test_torch_gpu.py TC_CASES: (hd, sq, skv, kv_len, causal, window)
TC_CASES = [(64, 33, 65, 65, False, 0), (128, 40, 40, 40, True, 0),
            (64, 100, 100, 100, True, 0), (128, 40, 200, 150, True, 0),
            (64, 300, 300, 300, True, 17), (128, 300, 300, 0, True, 0),
            (128, 129, 300, 257, False, 100), (64, 128, 128, 128, True, 0),
            (128, 17, 17, 17, True, 5), (128, 256, 256, 200, False, 0)]
SERVE_ARCH = "qwen3-1.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32   # 32 decode steps
SERVE_RTOL = 1e-3           # of max |logit|
# phase 13: federated LoRA fine-tuning of full-width qwen3-1.7b
LORA_ARCH = "qwen3-1.7b"
LORA_RANK, LORA_SEED = 8, 1          # inject_lora rank and generator seed
LORA_SEQS, LORA_SEQ_LEN, LORA_TRAIN = 352, 128, 320  # 32 eval sequences
LORA_N, LORA_K, LORA_TOP_N, LORA_B, LORA_B32 = 8, 4, 2, 4, 2
# trainable params, bytes (bf16), units, unit bytes, leaves
LORA_TRAINABLE = (8_716_288, 17_432_576, 28, {622_592}, 14)
# uplink bytes a round: fedldf n·U·622,592 + K·U·4, and int8 + EF
# n·U·(311,296 + 5) + K·U·4
LORA_UPLINK = (34_865_600, 17_433_304)
# phase 14: serving the ssm and hybrid families at full width
SSM_ARCHS = ("mamba2-780m", "hymba-1.5b")
HYMBA_HEADS = (25, 5, 64)           # query heads, KV heads, hd
# params, bytes (bf16, with the f32 A_log, D_skip and dt_bias) and leaves of
# the reference's init_params (jax.eval_shape); cfg.param_count() leaves out
# the norm scales and the conv and SSD vectors
SSM_PARAMS = {"mamba2-780m": (780_148_992, 1_560_311_808, 11),
              "hymba-1.5b": (1_640_872_320, 3_281_754_240, 20)}
# cache bytes at batch 4 and max_len 2080: ssm_state f32, the rest bf16
SSM_CACHE = {"mamba2-780m": {"ssm_conv": 3_833_856,
                             "ssm_state": 301_989_888},
             "hymba-1.5b": {"k": 170_393_600, "v": 170_393_600,
                            "ssm_conv": 2_482_176, "ssm_state": 26_214_400}}
SSD_LENGTHS = (512, 300)            # four chunks; a ragged last chunk
SSD_RTOL = 1e-4                     # of max |y| (|state|, |conv|)
# phase 15: serving deepseek-moe-16b at full width
MOE_ARCH = "deepseek-moe-16b"
MOE_HEADS = (16, 16, 128)           # query heads, KV heads, hd (G = 1)
# params, bytes (bf16, with the f32 router) and leaves of the reference's
# init_params (jax.eval_shape); cfg.param_count() leaves out the norm scales
MOE_PARAMS = (16_879_568_896, 33_766_477_824, 16)
MOE_CACHE = {"k": 954_204_160, "v": 954_204_160}   # batch 4, max_len 2080
MOE_F32_LAYERS = 4          # f32 parity depth: all 28 layers take 67.5 GB
MOE_NO_DROP_CF = 11.0       # k·cf >= E: every call's capacity covers its T
MOE_CFS = (1.25, 0.5)       # moe_fwd against the per-expert loop
MOE_RTOL = 1e-4             # of max |out|, moe_fwd against the loop (f32)
MOE_AUX_TOL = 1e-5          # the balance loss, against the loop
# phase 16: serving seamless-m4t-large-v2 (enc-dec) at full width
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_HEADS = (16, 16, 64)         # query heads, KV heads, hd (G = 1)
ENCDEC_RAGGED = 1500                # phase 3's ragged cross-prefill frames
# params, bytes (bf16) and leaves of the reference's init_params
# (jax.eval_shape); cfg.param_count() leaves out the norm scales
ENCDEC_PARAMS = (2_035_832_832, 4_071_665_664, 28)
# batch 4, max_len 2080 (self K/V), 2048 frames (cross K/V), bf16
ENCDEC_CACHE = {"k": 408_944_640, "v": 408_944_640,
                "cross_k": 402_653_184, "cross_v": 402_653_184}
APPLY_CALLS = 2000          # calls a turn when timing the host enqueue
SLEEP_CYCLES = 10_000_000   # ~5 ms of GPU spin: the host enqueues meanwhile


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


# ----------------------------------------------------------------------
# phase 18: the client mesh (module level: the spawned ranks import this
# file as their main module, whose main() does not run there)
# ----------------------------------------------------------------------
MESH_ROUNDS = 3             # rounds a run in the worlds of phase 18
MESH_WORLD = 4              # gloo ranks sharing the card: (a), (b), (c), (e)
SHARD_WORLD = 2             # (d): N/D = 25 clients a rank
MESH_GROUP = 2              # (b): 2 groups of 2
TIMED_ROUNDS = 3            # 1-round blocks timed, after one warm-up
UTIL_LAG_S = 0.25           # utilization samples this soon after the start
                            # of the timed rounds still cover the wait
# (b)'s and (a)'s tier bytes at P = 4 · 4,709,706 B (the reference's
# agg_tier_bytes): intra, cross, busiest host
TIER_BYTES = {MESH_GROUP: (37_677_648.0,) * 3,
              0: (0.0, 56_516_472.0, 113_032_944.0)}
# (g)-(j): the 2-D ('clients', 'model') grids in the same 4-rank world:
# name -> (model M, setting A?, telemetry?, driver)
GRID_RUNS = {"g": (2, False, False, "engine"), "h": (2, True, True, "engine"),
             "i": (4, True, True, "engine"), "j": (2, False, True, "host")}
GRID_HELD = ("g", "h", "i")        # each round against the 1-rank mesh's
# at rest a rank (the reference's fl_param_specs over full-width VGG-9):
# the params' and the N = 50 EF store's shard bytes, by M
GRID_AT_REST = {2: (9_430_952, 471_547_600), 4: (4_727_016, 236_350_800)}
# the aggregation tiers at P = 4,709,706 · 4 / M (payload, intra, cross,
# busiest host), by (C, M)
GRID_TIER_BYTES = {(2, 2): (9_419_412.0, 0.0, 9_419_412.0, 18_838_824.0),
                   (1, 4): (4_709_706.0, 0.0, 0.0, 0.0)}


def _mesh_rank(rank, task):
    """One rank of a phase-18 world: the runs of ``task["plan"]`` through
    the drivers on this rank's card, each run's params (rank 0 returns
    them whole; every rank a digest), losses, uplink, EF store digest,
    kernel launches and mesh counters, and the timed rounds."""
    import datetime
    import hashlib
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs import vgg9_cifar10 as vgg9
    from repro_torch.core.comm import comm_acc_init
    from repro_torch.core.units import UnitMap, tree_leaves
    from repro_torch.data import ClientShards, FederatedData
    from repro_torch.federated import (CompressionConfig, KeyedDraws,
                                       make_strategy, run_training,
                                       run_training_scan)
    from repro_torch.federated import server as fl_server
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.models.cnn import classify_loss
    from repro_torch.telemetry import TelemetryConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_client_mesh()
    # the 2-D grids 2 x 2 and 1 x 4 (new_group is collective: every rank
    # builds both, in this order) and this rank alone, a 1-rank mesh
    grids = ({m_: make_client_mesh(model=m_) for m_ in (2, 4)}
             if task.get("grids") else {})
    solo = make_client_mesh(1)
    dev = mesh.device
    cfg = vgg9.config()
    params = params_from_numpy(task["params"], dev)
    umap = UnitMap.build(params)
    data = FederatedData(np.load(task["xs"], mmap_mode="c"),
                         np.load(task["ys"], mmap_mode="c"), task["parts"])
    host_shards = ClientShards.from_federated(data)
    shards = host_shards.place(mesh)           # the whole set on the card

    def loss_fn(p, batch):
        return classify_loss(p, cfg, batch)

    def config(name, telemetry=True):
        if name in GRID_RUNS:
            m_, a_, tele_, _ = GRID_RUNS[name]
            kw = {"mesh": grids[m_]}
            if tele_ and telemetry:
                kw["telemetry"] = TelemetryConfig(
                    ledger_path=task["ledger"], run_id=name)
            comp = (CompressionConfig(bits=8, error_feedback=True)
                    if a_ else None)
            return dataclasses.replace(vgg9.fl_config(compression=comp),
                                       **kw)
        kw = {"mesh": mesh}
        if name in ("b", "b_tele"):
            kw["agg_group_size"] = MESH_GROUP
        if name == "shard":
            kw["shard_samples"] = True
        if name.endswith("_tele"):
            kw["telemetry"] = TelemetryConfig(ledger_path=task["ledger"],
                                              run_id=name)
        comp = (CompressionConfig(bits=8, error_feedback=True)
                if name == "c" else None)
        return dataclasses.replace(vgg9.fl_config(compression=comp), **kw)

    def digest(tree):
        h = hashlib.sha1()
        for leaf in tree_leaves(tree):
            h.update(leaf.detach().cpu().contiguous().view(-1)
                     .view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    out = {"rank": rank, "size": mesh.size, "backend": mesh.backend,
           "stage": mesh.stage, "device": str(dev), "runs": {}}
    for name in task["plan"]:
        fl = config(name)
        if name == "rep":          # the affinity layout, placed whole
            fldata = host_shards.with_affinity(mesh.size).place(mesh)
        elif name == "shard":      # this rank's block only
            fldata = host_shards
        else:
            fldata = shards
        # the params after every round (rank 0), for the per-round check:
        # an eval block a round leaves the trajectory as it is
        seen = []
        kw = {}
        if name in task.get("per_round", ()):
            kw = {"eval_every": 1, "eval_fn": lambda p_: seen.append(
                params_to_numpy(p_) if rank == 0 else None) or 0.0}
        ops.reset_launch_counts()
        fl.mesh.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if name in ("host", "j"):
            p, log = run_training(params, loss_fn, fldata, fl,
                                  rounds=MESH_ROUNDS, seed=SEED,
                                  sampler="device", device=dev)
        else:
            p, log = run_training_scan(params, loss_fn, fldata, fl,
                                       rounds=MESH_ROUNDS, seed=SEED,
                                       device=dev, **kw)
        torch.cuda.synchronize()
        run = {"wall": time.perf_counter() - t, "losses": list(log.losses),
               "uplink": log.meter.uplink_bytes, "digest": digest(p),
               "launches": {k: v for k, v in ops.launch_counts().items()
                            if v},
               "counts": fl.mesh.counts(), "col": fl.mesh.model_rank}
        if log.final_state is not None:
            run["store"] = digest(log.final_state["client"])
        if rank == 0:
            run["params"] = params_to_numpy(p)
            run["per_round"] = seen
        out["runs"][name] = run
        del p, log, fldata

    if "shard" in task["plan"]:
        # the same rounds' batches through both placements, and the bytes
        rep = host_shards.with_affinity(mesh.size).place(mesh)
        shd = host_shards.place(mesh, shard_samples=True)
        out["bytes"] = (rep.bytes_per_device(), shd.bytes_per_device())
        fl = config("shard")
        kloc = fl.clients_per_round // mesh.size
        rows = slice(rank * kloc, (rank + 1) * kloc)
        sizes = rep.part_sizes.cpu()
        same = True
        for t in range(MESH_ROUNDS):
            rd = KeyedDraws(SEED)(t)
            c = rd.clients(fl.num_clients, fl.clients_per_round, mesh.size)
            j = rd.indices(sizes[c], fl.batch_per_client)
            c, j = c[rows].to(dev), j[rows].to(dev)
            a, b = rep.gather(c, j), shd.gather(c, j)
            same = same and all(torch.equal(a[k], b[k]) for k in a)
        out["batches_equal"] = same
        del rep, shd

    if grids:
        out["grids"] = _grid_extras(rank, task, grids, solo, params, umap,
                                    shards, loss_fn, config, digest)

    if task.get("timed"):
        fl = config("a")
        block = fl_server._build_block_fn(loss_fn, umap, fl)
        carry = (params, make_strategy(fl).init_state(
            params, fl.num_clients, mesh), comm_acc_init(dev))
        args = (shards, shards.data_sizes(), shards.part_sizes.cpu(),
                KeyedDraws(SEED))
        carry, per = block(carry, *args, 0, 1)          # warm-up
        fl_server._pull(per)
        # the card's utilization over the timed rounds, as nvidia-smi
        # reads it: every process's kernels (a profile sees its own)
        smi_util = None
        if rank == 0:
            smi_util = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, text=True)
            time.sleep(1.0)
        walls, staged = [], []
        t_first = time.time()
        for i in range(TIMED_ROUNDS):
            torch.cuda.synchronize()
            dist.barrier()
            mesh.reset_counts()
            t = time.perf_counter()
            carry, per = block(carry, *args, 1 + i, 1)
            fl_server._pull(per)                  # the round's one sync
            walls.append(time.perf_counter() - t)
            staged.append(mesh.counts()["staged"])
        t_last = time.time()
        util = None
        if smi_util is not None:
            time.sleep(0.2)
            smi_util.terminate()
            util = []
            for l_ in smi_util.communicate()[0].splitlines():
                try:
                    ts, u = l_.split(", ")
                    at = datetime.datetime.strptime(
                        ts, "%Y/%m/%d %H:%M:%S.%f").timestamp()
                    # a sample covers nvidia-smi's last period (about
                    # 200 ms): the first ones still see the wait before
                    if t_first + UTIL_LAG_S <= at <= t_last:
                        util.append(float(u))
                except ValueError:      # a line cut by the terminate
                    continue
        torch.cuda.synchronize()
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            carry, per = block(carry, *args, 1 + TIMED_ROUNDS, 1)
            fl_server._pull(per)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        out["timed"] = {"wall_ms": [w_ * 1e3 for w_ in walls],
                        "median_ms": statistics.median(walls) * 1e3,
                        "staged": staged, "busy_ms": busy / 1e3,
                        "util": util}
        if task.get("sync_check"):
            # a 2-round block enqueued with any host sync an error
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                carry, per = block(carry, *args, 2 + TIMED_ROUNDS, 2)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out["synced_block"] = bool(torch.isfinite(
                fl_server._pull(per)[0]["loss"]).all())
        del carry, per
    return out


def _grid_extras(rank, task, grids, solo, params, umap, shards, loss_fn,
                 config, digest):
    """The 2-D grids' checks beyond their runs, in one rank: the bytes
    at rest a rank, each round of (g)-(i) against this rank's 1-rank mesh
    round from the same params and EF store (rank 0; the rounds chained
    by resume from the grid's shards), and each grid's timed rounds."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.configs import vgg9_cifar10 as vgg9
    from repro_torch.core.comm import comm_acc_init
    from repro_torch.core.units import tree_leaves, tree_map
    from repro_torch.federated import (KeyedDraws, make_strategy,
                                       run_training_scan)
    from repro_torch.federated import server as fl_server
    from repro_torch.launch.sharding import (fl_param_specs,
                                             init_residual_store,
                                             tree_all_gather,
                                             tree_shard_slice)

    dev = solo.device
    out = {}

    def nbytes(tree):
        return sum(l.numel() * l.element_size() for l in tree_leaves(tree))

    def added(fn):
        """``fn()`` and what it added on the card: the allocator's bytes
        (``memory_allocated``, its blocks) and the bytes asked for. The
        garbage collector is held off meanwhile: a cycle it frees would
        take its tensors' bytes off the deltas."""
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated(dev)
            q0 = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
            kept = fn()
            torch.cuda.synchronize()
            return (kept, torch.cuda.memory_allocated(dev) - a0,
                    torch.cuda.memory_stats(dev)
                    ["requested_bytes.all.current"] - q0)
        finally:
            gc.enable()

    def slack(tree):
        """The allocator's most above the bytes asked for: 512 B a tensor
        (its rounding), and a cached block up to 1 MiB larger for a tensor
        over 1 MiB (a remainder that small is not split off)."""
        return sum(512 + (2 ** 20 if l.numel() * l.element_size() > 2 ** 20
                          else 0) for l in tree_leaves(tree))

    # ---- at rest: the shards' own bytes and the allocator's deltas ------
    for m_, gm in grids.items():
        specs = fl_param_specs(params, gm)
        # a rank's held params: its shards and the whole 1-D leaves, as
        # copies (the slice hands back a replicated leaf itself)
        shard, p_alloc, p_req = added(lambda: tree_map(
            torch.clone, tree_shard_slice(params, specs, m_,
                                          gm.model_rank)))
        store, s_alloc, s_req = added(lambda: init_residual_store(
            params, vgg9.fl_config().num_clients, gm))
        out[f"rest{m_}"] = {"params": nbytes(shard), "store": nbytes(store),
                            "params_alloc": p_alloc, "store_alloc": s_alloc,
                            "params_req": p_req, "store_req": s_req,
                            "params_slack": slack(shard),
                            "store_slack": slack(store)}
        del shard, store

    # ---- each round against the 1-rank mesh's round ---------------------
    for name in GRID_HELD:
        fl = config(name, telemetry=False)
        gm = fl.mesh
        fl_solo = dataclasses.replace(fl, mesh=solo)
        specs = fl_param_specs(params, gm)
        p_t, st = params, None
        worst_p = worst_l = 0.0
        exact = True
        for t in range(MESH_ROUNDS):
            whole = None
            if st is not None:      # the EF store whole, for the solo round
                whole = {**st, "client": {
                    n_: tree_all_gather(e, specs, gm, offset=1)
                    for n_, e in st["client"].items()}}
            p1, log1 = run_training_scan(p_t, loss_fn, shards, fl, rounds=1,
                                         start_round=t, seed=SEED,
                                         server_state=st, device=dev)
            if rank == 0:
                pr, logr = run_training_scan(p_t, loss_fn, shards, fl_solo,
                                             rounds=1, start_round=t,
                                             seed=SEED, server_state=whole,
                                             device=dev)
                d = max(float((a - b).abs().max())
                        for a, b in zip(tree_leaves(p1), tree_leaves(pr)))
                dl = abs(log1.losses[0] - logr.losses[0])
                worst_p, worst_l = max(worst_p, d), max(worst_l, dl)
                exact = exact and d == 0.0 and dl == 0.0
                del pr, logr
            del whole
            p_t, st = p1, log1.final_state
        out[f"held_{name}"] = {
            "worst_p": worst_p, "worst_l": worst_l, "exact": exact,
            "digest": digest(p_t),
            "store": None if st is None else digest(st["client"])}
        del p_t, st

    # ---- timed: 1-round blocks on the grid's shards ---------------------
    args = (shards, shards.data_sizes(), shards.part_sizes.cpu(),
            KeyedDraws(SEED))
    for name in GRID_HELD:
        fl = config(name, telemetry=False)
        gm = fl.mesh
        ps, _, st, layout = fl_server._place(make_strategy(fl), params, None,
                                             fl, None, dev)
        block = fl_server._build_block_fn(loss_fn, umap, fl, layout)
        carry = (ps, st, comm_acc_init(dev))
        del ps, st
        carry, per = block(carry, *args, 0, 1)          # warm-up
        fl_server._pull(per)
        walls, rises, counts = [], [], []
        for i in range(TIMED_ROUNDS):
            torch.cuda.synchronize()
            dist.barrier()
            gm.reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            t = time.perf_counter()
            carry, per = block(carry, *args, 1 + i, 1)
            fl_server._pull(per)                  # the round's one sync
            walls.append(time.perf_counter() - t)
            rises.append(torch.cuda.max_memory_allocated(dev) - held)
            counts.append(gm.counts())
        out[f"timed_{name}"] = {
            "wall_ms": [w_ * 1e3 for w_ in walls],
            "median_ms": statistics.median(walls) * 1e3,
            "rise": rises, "held": held, "counts": counts}
        del carry, per
    torch.cuda.synchronize()
    dist.barrier()
    return out


def phase18(ctx):
    """The client mesh at the paper's setup (see the module docstring,
    phase 18); ``ctx`` holds main()'s names it reads. Returns the FL
    kernels' launches in the worlds' ranks."""
    import numpy as np
    import torch

    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.core.comm import agg_tier_bytes
    from repro_torch.core.units import tree_leaves
    from repro_torch.data import ClientShards
    from repro_torch.launch import monitor
    from repro_torch.launch.mesh import spawn
    from repro_torch.federated import run_training_scan
    from repro_torch.telemetry import read_ledger, split_runs

    dev, smi = ctx["dev"], ctx["smi"]
    params0, data_e, umap = ctx["params0"], ctx["data_e"], ctx["umap"]
    fl_v, fl_a, loss_fn = ctx["fl_v"], ctx["fl_a"], ctx["loss_fn"]
    per_round_up = ctx["per_round_up"]
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()
    say(f"[mesh] compute mode {mode}; {torch.cuda.device_count()} visible "
        f"card(s); {smi}")
    if any(m != "Default" for m in mode):
        fail(f"mesh: the card's compute mode is {mode}; ranks sharing a card "
             "need Default")
    tdir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    atexit.register(shutil.rmtree, tdir, True)
    np.save(tdir / "xs.npy", data_e.xs)
    np.save(tdir / "ys.npy", data_e.ys)
    base = {"params": params_to_numpy(params0), "xs": str(tdir / "xs.npy"),
            "ys": str(tdir / "ys.npy"), "parts": data_e.parts}

    def world(size, backend, **task):
        t = time.perf_counter()
        ranks = spawn(_mesh_rank, size, ({**base, **task},),
                      backend=backend, store_dir=str(tdir))
        say(f"[mesh] a world of {size} {backend} rank(s) "
            f"({ranks[0]['device']}, staging {ranks[0]['stage']}): "
            f"{time.perf_counter() - t:.1f} s, start-up included")
        return ranks

    # the unsharded engine on the same keyed draws
    shards = ClientShards.from_federated(data_e).to(dev)
    ref = {}
    for label, fl in (("v", fl_v), ("A", fl_a)):
        p, log = run_training_scan(params0, loss_fn, shards, fl,
                                   rounds=MESH_ROUNDS, seed=SEED, device=dev)
        ref[label] = (params_to_numpy(p), log)
        del p
    launches = {}

    def add_launches(ranks):
        for r in ranks:
            for run in r["runs"].values():
                for n_, c in run["launches"].items():
                    launches[n_] = launches.get(n_, 0) + c

    def max_diff(a, b):
        return max(float(np.abs(x - y).max()) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))

    def held_per_round(label, run):
        """Each round of a mesh run against the unsharded engine's round
        from the same params and draws (2e-5 params, 1e-5 loss): the
        mesh's own difference, the f32 order of its reduce. Its 3-round
        trajectory against the unsharded one is printed, not held: the
        paper's setup on random weights diverges (loss 3.4 -> 17.9 in
        round 2), and that amplifies a round-1 difference of 1e-7 about
        3,000 times by round 3, as the unsharded engine's own local
        training in chunks of K/D does not differ at all."""
        starts = [params_to_numpy(params0)] + run["per_round"][:-1]
        worst_p = worst_l = 0.0
        for t, (p_t, p_next) in enumerate(zip(starts, run["per_round"])):
            p, log = run_training_scan(params_from_numpy(p_t, dev), loss_fn,
                                       shards, fl_v, rounds=1, start_round=t,
                                       seed=SEED, device=dev)
            worst_p = max(worst_p, max_diff(params_to_numpy(p), p_next))
            worst_l = max(worst_l, abs(log.losses[0] - run["losses"][t]))
            del p
        if max_diff(run["per_round"][-1], run["params"]) != 0.0:
            fail(f"mesh {label}: the recorded last round is not the result")
        traj = max_diff(run["params"], ref["v"][0])
        traj_l = max(abs(x - y) for x, y in zip(run["losses"],
                                                ref["v"][1].losses))
        say(f"[mesh {label}] each round against the unsharded engine's "
            f"round from the same params and draws: params max_abs_diff "
            f"{worst_p:.3e} (limit {EQUIV_TOL}), loss {worst_l:.3e} (limit "
            f"1e-05); the {MESH_ROUNDS}-round trajectory against the "
            f"unsharded one (information only): params {traj:.3e}, losses "
            f"{traj_l:.3e}, unsharded losses {ref['v'][1].losses}")
        if worst_p > EQUIV_TOL or worst_l > 1e-5:
            fail(f"mesh {label}: a round differs from the unsharded round")

    def step_diff(a, b):
        """Max over the units of |a − b| less one int8 step of the unit."""
        worst = 0.0
        for key in b:
            step = max(float(np.abs(v).max()) for v in tree_leaves(b[key]))
            worst = max(worst, max_diff(a[key], b[key]) - step / 127.0)
        return worst

    def check_ranks(label, ranks, name, want_up, want_calls, want_kernels):
        runs = [r["runs"][name] for r in ranks]
        r0 = runs[0]
        if len({r_["digest"] for r_ in runs}) != 1 or \
                any(r_["losses"] != r0["losses"] for r_ in runs):
            fail(f"mesh {label}: the ranks' params or losses differ")
        # the EF store (the rank's shards on a grid): the same bits down
        # each column
        if len({(r_["col"], r_.get("store")) for r_ in runs}) != \
                len({r_["col"] for r_ in runs}):
            fail(f"mesh {label}: the ranks' EF residual stores differ")
        if r0["uplink"] != MESH_ROUNDS * want_up:
            fail(f"mesh {label}: uplink {r0['uplink']} B in {MESH_ROUNDS} "
                 f"rounds, expected exactly {MESH_ROUNDS} x {want_up} B")
        for i, r_ in enumerate(runs):
            calls = {op: c / MESH_ROUNDS for op, (c, *_) in
                     r_["counts"].items() if op != "staged" and c}
            kern = {n_: c / MESH_ROUNDS for n_, c in r_["launches"].items()}
            if calls != want_calls or kern != want_kernels:
                fail(f"mesh {label} rank {i}: a round made {calls} and "
                     f"launched {kern}, expected {want_calls} and "
                     f"{want_kernels}")
        staged = r0["counts"]["staged"]
        moved = {op: cb[1] / MESH_ROUNDS for op, cb in
                 r0["counts"].items() if op != "staged" and cb[0]}
        say(f"[mesh {label}] {len(ranks)} ranks, {MESH_ROUNDS} rounds: "
            f"{r0['wall']:.3f} s (rank 0, first-round warm-up included); "
            f"losses {r0['losses']}; uplink {r0['uplink']:.0f} B, exact; "
            f"ranks bit for bit equal (params"
            + (", EF store by column" if "store" in r0 else "") + f"); a "
            f"round a rank: {want_calls}, bytes {moved}, kernels "
            f"{want_kernels}; staged {staged[0]} copies, {staged[1]} B, "
            f"{staged[2] * 1e3:.1f} ms ({smi})")
        return r0

    def check_grids(ranks, segs):
        """(g)-(j): the 2-D ('clients', 'model') grids 2 x 2 and 1 x 4."""
        runs = {}
        for name, (m_, a_, tele_, driver) in GRID_RUNS.items():
            c_ = MESH_WORLD // m_
            label = (f"{name} {c_}x{m_} " + ("setting A" if a_ else "fedldf")
                     + (", host driver" if driver == "host" else "")
                     + (", telemetry" if tele_ else ""))
            calls = {"all_gather_model": (MESH_ROUNDS + 1) / MESH_ROUNDS,
                     "all_reduce_flat": 1,
                     "all_gather_rows": 2 if a_ else 1}
            runs[name] = check_ranks(
                label, ranks, name,
                ctx["want_uplink_a"] if a_ else per_round_up, calls,
                {"sqdiff_rowsum": 1.0, "fused_uplink_ef": 1.0} if a_
                else sq1)
        if runs["j"]["digest"] != runs["g"]["digest"] or \
                runs["j"]["losses"] != runs["g"]["losses"]:
            fail("mesh j: the host driver with telemetry differs from (g)")
        say("[mesh j] 2x2: run_training(sampler='device') with telemetry "
            "equals the engine's (g) bit for bit")
        # each round against the 1-rank mesh's, and resume
        for name in GRID_HELD:
            m_ = GRID_RUNS[name][0]
            h0 = ranks[0]["grids"][f"held_{name}"]
            bad = [r["rank"] for r in ranks
                   if r["grids"][f"held_{name}"]["digest"] !=
                   r["runs"][name]["digest"] or
                   r["grids"][f"held_{name}"]["store"] !=
                   r["runs"][name].get("store")]
            if bad:
                fail(f"mesh {name}: {MESH_ROUNDS} 1-round runs resumed from "
                     f"the grid's shards differ from the {MESH_ROUNDS}-round "
                     f"run on ranks {bad}")
            exact_needed = MESH_WORLD // m_ == 1
            say(f"[mesh {name}] each round against the 1-rank mesh's round "
                f"from the same params and EF store (rank 0): params "
                f"max_abs_diff {h0['worst_p']:.3e}, loss {h0['worst_l']:.3e} "
                f"(limits {EQUIV_TOL}, 1e-05"
                + ("; bit for bit at C = 1" if exact_needed else "")
                + f"): bit for bit {h0['exact']}; resumed round by round = "
                f"the {MESH_ROUNDS}-round run bit for bit on every rank")
            if h0["worst_p"] > EQUIV_TOL or h0["worst_l"] > 1e-5 or \
                    (exact_needed and not h0["exact"]):
                fail(f"mesh {name}: a round differs from the 1-rank mesh's")
        # at rest
        for m_, (want_p, want_s) in GRID_AT_REST.items():
            rest = [r["grids"][f"rest{m_}"] for r in ranks]
            if any((x["params"], x["params_req"], x["store"],
                    x["store_req"]) != (want_p, want_p, want_s, want_s) or
                   not 0 <= x["params_alloc"] - want_p <= x["params_slack"]
                   or not 0 <= x["store_alloc"] - want_s <= x["store_slack"]
                   for x in rest):
                fail(f"mesh grid M={m_}: bytes at rest a rank {rest}, "
                     f"expected params {want_p}, store {want_s}")
            say(f"[mesh rest M={m_}] a rank at rest: params "
                f"{rest[0]['params']} B, EF store (N=50) {rest[0]['store']} "
                f"B (the shards' bytes, and the bytes the ranks asked the "
                f"allocator for, exact); torch.cuda.memory_allocated deltas "
                f"{[x['params_alloc'] for x in rest]} / "
                f"{[x['store_alloc'] for x in rest]} B (its blocks; at most "
                f"{rest[0]['params_slack']} / {rest[0]['store_slack']} B "
                f"above) ({smi})")
        # the ledger: header and tier bytes
        for name in ("h", "i", "j"):
            m_ = GRID_RUNS[name][0]
            c_ = MESH_WORLD // m_
            meta, recs = segs[name]["meta"], segs[name]["rounds"]
            tiers = agg_tier_bytes(umap.total_bytes / m_, c_, 0)
            want = GRID_TIER_BYTES[(c_, m_)]
            keys = ("agg_payload_bytes", "agg_intra_bytes",
                    "agg_cross_bytes", "agg_cross_bytes_per_host")
            got = [tuple(x["comm"][k_] for k_ in keys) for x in recs]
            if meta["mesh"] != {"clients": c_, "model": m_} or \
                    meta["agg"] != {"group_size": c_, "num_groups": 1,
                                    "tiers": 1} or \
                    tuple(tiers[k_] for k_ in keys) != want or \
                    any(g_ != want for g_ in got) or \
                    len(recs) != MESH_ROUNDS:
                fail(f"mesh ledger {name}: mesh {meta['mesh']}, agg "
                     f"{meta['agg']}, tier bytes {got}, expected {want}")
            say(f"[mesh ledger {name}] header mesh {meta['mesh']} agg "
                f"{meta['agg']}; every round payload / intra / cross / "
                f"busiest host {got[0]} B (the reference's agg_tier_bytes)")
        # timed
        for name in GRID_HELD:
            m_ = GRID_RUNS[name][0]
            tm = [r["grids"][f"timed_{name}"] for r in ranks]
            wall = statistics.median(t_["median_ms"] for t_ in tm)
            c0 = tm[0]["counts"][-1]
            say(f"[times] mesh grid {name} {MESH_WORLD // m_}x{m_}: round "
                f"wall-clock {wall:.3f} ms (the ranks' medians of "
                f"{TIMED_ROUNDS} 1-round blocks: "
                f"{[round(t_['median_ms'], 3) for t_ in tm]}); peak rise a "
                f"round above what was held {[t_['rise'] for t_ in tm]} B "
                f"(held {[t_['held'] for t_ in tm]} B); rank 0's "
                f"collectives a round {c0} ({smi})")

    # ---- (a), (b), (c), (e): 4 gloo ranks sharing the card -------------
    ledger = str(tdir / "ledger.jsonl")
    flat_calls = {"all_reduce_flat": 1, "all_gather_rows": 1}
    g4 = world(MESH_WORLD, "gloo", ledger=ledger, timed=True, grids=True,
               plan=("a", "a_tele", "host", "b_tele", "c", *GRID_RUNS),
               per_round=("a", "b_tele"))
    add_launches(g4)
    sq1 = {"sqdiff_rowsum": 1.0}
    a = check_ranks("a flat", g4, "a", per_round_up, flat_calls, sq1)
    held_per_round("a flat", a)
    for name, what in (("a_tele", "telemetry on"),
                       ("host", "run_training(sampler='device')")):
        check_ranks(f"e {what}", g4, name, per_round_up, flat_calls, sq1)
        r_ = g4[0]["runs"][name]
        if r_["digest"] != a["digest"] or r_["losses"] != a["losses"]:
            fail(f"mesh e: {what} differs from the engine's flat run")
    say("[mesh e] the host driver and telemetry on equal the engine's flat "
        "D=4 run bit for bit")
    b = check_ranks(f"b two-tier gs={MESH_GROUP}", g4, "b_tele",
                    per_round_up, {"all_gather_rows": 1,
                                   "group_all_reduce": 1, "ring_shift": 1},
                    sq1)
    held_per_round(f"b two-tier gs={MESH_GROUP}", b)
    d_b = max_diff(b["per_round"][0], a["per_round"][0])
    say(f"[mesh b] round 1 against (a)'s: params max_abs_diff {d_b:.3e} "
        f"(limit {EQUIV_TOL}); after {MESH_ROUNDS} rounds (information "
        f"only) {max_diff(b['params'], a['params']):.3e}")
    if d_b > EQUIV_TOL:
        fail("mesh b: the two-tier reduce differs from the flat one")
    c = check_ranks("c setting A", g4, "c", ctx["want_uplink_a"],
                    {"all_reduce_flat": 1, "all_gather_rows": 2},
                    {"sqdiff_rowsum": 1.0, "fused_uplink_ef": 1.0})
    d_c = step_diff(c["params"], ref["A"][0])
    say(f"[mesh c] against the unsharded setting A: max over the units of "
        f"params max_abs_diff less one int8 step {d_c:.3e} (limit "
        f"{EQUIV_TOL})")
    if d_c > EQUIV_TOL:
        fail("mesh c: setting A on the mesh differs from the unsharded run")
    # the ledger (rank 0 alone writes it) and the monitor
    segs = {s_["meta"]["run_id"]: s_ for s_ in split_runs(
        read_ledger(ledger))}
    if sorted(segs) != ["a_tele", "b_tele", "h", "i", "j"]:
        fail(f"mesh: ledger segments {sorted(segs)}")
    for name, gs in (("a_tele", 0), ("b_tele", MESH_GROUP)):
        meta, recs = segs[name]["meta"], segs[name]["rounds"]
        want_agg = ({"group_size": MESH_WORLD, "num_groups": 1, "tiers": 1}
                    if not gs else {"group_size": gs, "num_groups":
                                    MESH_WORLD // gs, "tiers": 2})
        tiers = agg_tier_bytes(umap.total_bytes, MESH_WORLD, gs)
        got = [(x["comm"]["agg_intra_bytes"], x["comm"]["agg_cross_bytes"],
                x["comm"]["agg_cross_bytes_per_host"]) for x in recs]
        if meta["agg"] != want_agg or meta["mesh"] != {
                "clients": MESH_WORLD} or \
                any(g_ != TIER_BYTES[gs] for g_ in got) or \
                (tiers["agg_intra_bytes"], tiers["agg_cross_bytes"],
                 tiers["agg_cross_bytes_per_host"]) != TIER_BYTES[gs] or \
                any(x["comm"]["uplink_total"] != per_round_up
                    for x in recs):
            fail(f"mesh ledger {name}: agg {meta['agg']}, mesh "
                 f"{meta['mesh']}, tier bytes {got}")
        say(f"[mesh ledger {name}] header agg {meta['agg']} mesh "
            f"{meta['mesh']}; every round intra / cross / busiest host "
            f"{got[0]} B, uplink {recs[0]['comm']['uplink_total']:.0f} B")
    buf = io.StringIO()
    monitor.render(ledger, out=buf)
    tier_lines = [l_ for l_ in buf.getvalue().splitlines()
                  if "agg traffic/round" in l_ or "mesh=" in l_]
    if not any("2-tier reduce" in l_ for l_ in tier_lines):
        fail(f"mesh: the monitor printed no tier line:\n{buf.getvalue()}")
    for l_ in tier_lines:
        say(f"[monitor] {l_.strip()}")

    # ---- (g)-(j): the 2-D grids, in the same world ----------------------
    check_grids(g4, segs)

    # ---- (d) sample sharding, 2 gloo ranks ------------------------------
    g2 = world(SHARD_WORLD, "gloo", plan=("rep", "shard"))
    add_launches(g2)
    rep = check_ranks("d replicated (affinity layout)", g2, "rep",
                      per_round_up, flat_calls, sq1)
    shd = check_ranks("d shard_samples", g2, "shard", per_round_up,
                      flat_calls, sq1)
    by = [r["bytes"] for r in g2]
    if shd["digest"] != rep["digest"] or shd["losses"] != rep["losses"] or \
            not all(r["batches_equal"] for r in g2) or \
            any(s_ > r_ // 2 + 4 * 3072 * 30 for r_, s_ in by):
        fail(f"mesh d: shard_samples against replicated: trajectory equal "
             f"{shd['digest'] == rep['digest']}, batches equal "
             f"{[r['batches_equal'] for r in g2]}, bytes a rank {by}")
    say(f"[mesh d] shard_samples at D={SHARD_WORLD}: every round's batch "
        f"and the trajectory bit for bit the replicated placement's; "
        f"dataset bytes a rank {[s_ for _, s_ in by]} against "
        f"{by[0][0]} replicated ({smi})")

    # ---- (f) a NCCL world of every visible card ------------------------
    n_cards = torch.cuda.device_count()
    gn = world(n_cards, "nccl", plan=("f",), timed=True, sync_check=True,
               per_round=("f",))
    add_launches(gn)
    f = check_ranks("f nccl", gn, "f", per_round_up, flat_calls, sq1)
    held_per_round("f nccl", f)
    if gn[0]["backend"] != "nccl" or gn[0]["stage"] or \
            not all(r["synced_block"] for r in gn):
        fail(f"mesh f: backend {gn[0]['backend']}, staging "
             f"{gn[0]['stage']}, blocks {[r['synced_block'] for r in gn]}")
    say(f"[mesh f] NCCL world of {n_cards}: a 2-round block under "
        f"set_sync_debug_mode('error'): 0 host syncs ({smi})")

    # ---- times -----------------------------------------------------------
    for label, ranks in (("D=4 gloo", g4), (f"D={n_cards} nccl", gn)):
        tm = [r["timed"] for r in ranks]
        wall = statistics.median(t_["median_ms"] for t_ in tm)
        st = tm[0]["staged"]
        util = tm[0]["util"] or [math.nan]
        # one process: its profile is the card's busy time; several
        # processes time-slice the card, and a kernel's profiled span then
        # holds the other contexts' turns too, so only nvidia-smi's
        # utilization gives the card's idle share
        idle_own = 1 - tm[0]["busy_ms"] / wall
        idle_smi = 1 - statistics.mean(util) / 100
        own = (f"; idle share from the profile {idle_own:.4f}"
               if len(tm) == 1 else "")
        say(f"[times] mesh {label}: round wall-clock {wall:.3f} ms (the "
            f"ranks' medians of {TIMED_ROUNDS} 1-round blocks: "
            f"{[round(t_['median_ms'], 3) for t_ in tm]}; rank 0's rounds "
            f"{[round(x, 3) for x in tm[0]['wall_ms']]}); each rank's "
            f"kernel time a round under torch.profiler "
            f"{[round(t_['busy_ms'], 3) for t_ in tm]} ms{own}; the card's "
            f"utilization.gpu over the timed rounds (nvidia-smi every 100 "
            f"ms, its period about 200 ms) {util} %, idle share "
            f"{idle_smi:.4f}; gloo staging a round (rank 0): "
            f"{statistics.median(s_[0] for s_ in st)} copies to the host, "
            f"{statistics.median(s_[1] for s_ in st):.0f} B both ways, "
            f"{statistics.median(s_[2] for s_ in st) * 1e3:.3f} ms ({smi})")
    del shards
    torch.cuda.empty_cache()
    say(f"[mesh] phase 18: {time.perf_counter() - t18:.1f} s; launches in "
        f"its ranks {launches}")
    return launches


# ----------------------------------------------------------------------
# phase 19: the dry-run's counts of two programs the earlier phases timed
# ----------------------------------------------------------------------
def phase19(ctx):
    """Count phase 10's bf16 prefill of qwen3-1.7b and phase 4's vmap
    FedLDF round of full-width VGG-9 with the dry-run's programs on the
    ``meta`` device (``repro_torch.launch``: ``shapes``, ``opcount``,
    ``dryrun``, ``roofline``, ``inspect``), hold their argument bytes to
    the bytes the earlier phases allocated on the card, exactly, and set
    the counts against the times those phases measured (nothing is timed
    again). ``ctx`` holds main()'s names it reads."""
    import torch
    from repro_torch.core.units import UnitMap
    from repro_torch.federated import build_round_vmap
    from repro_torch.launch import dryrun, opcount
    from repro_torch.launch import inspect as dr_inspect
    from repro_torch.launch import shapes as dr_shapes
    from repro_torch.launch.roofline import F32_FLOPS, PEAK_FLOPS
    from repro_torch.models import cnn
    t19 = time.perf_counter()
    smi = ctx["smi"]
    meta = torch.device("meta")

    # (a) phase 10's prefill: params built on meta by the program, the
    # prompt at phase 10's own shape and dtype (int64 from numpy; the
    # program's own tokens are the reference's int32)
    cfg, (b, s) = ctx["serve_cfg"], ctx["serve_prompt_shape"]
    shape = dr_shapes.ShapeSpec("serve_prefill", "prefill", s, b)
    prog = dr_shapes.build_program(cfg, shape)
    prog.args = (prog.args[0], torch.empty(
        (b, s), dtype=ctx["serve_prompt_dtype"], device=meta))
    roof, totals = dryrun.count(cfg, shape, program=prog, arch=cfg.name)
    want = ctx["serve_arg_bytes"]
    got = roof.memory_per_device["argument_size_in_bytes"]
    say(f"[dryrun] {cfg.name} bf16 prefill, batch {b}, prompt {s}, counted "
        f"on meta: argument bytes {got:.0f} (phase 10 allocated {want} on "
        f"the card: params and prompt); {len(totals.records)} ops, peak "
        f"live {totals.peak_bytes:.0f} B")
    if got != want:
        fail(f"dry-run prefill: argument bytes {got:.0f}, phase 10 "
             f"allocated {want}")
    # the plain prefill's matmuls: the projections and the MLP at every
    # position, the attention over every (query, key) pair of the masked
    # block (masked, not skipped), the head at the last position only
    t, d, hd = b * s, cfg.d_model, cfg.hd
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    want_flops = (cfg.num_layers * (2 * t * d * (2 * qd + 2 * kvd)
                                    + 6 * t * d * cfg.d_ff
                                    + 4 * b * cfg.num_heads * s * s * hd)
                  + 2 * b * d * cfg.vocab_size)
    pre_s = ctx["serve_pre_ms"] / 1e3
    ratio, bound_s = roof.useful_ratio, max(roof.t_compute, roof.t_memory)
    mfu = roof.model_flops / (pre_s * PEAK_FLOPS)
    hfu = roof.flops_per_device / (pre_s * PEAK_FLOPS)
    say(f"[dryrun] prefill: measured {pre_s * 1e3:.3f} ms (phase 10, "
        f"median of 3): counted share {hfu:.4f} (counted FLOPs "
        f"{roof.flops_per_device:.6e}, analytic {want_flops:.6e}, / (s x "
        f"{PEAK_FLOPS:.3e})); model_flops_for {roof.model_flops:.6e}, "
        f"useful_flops_ratio {ratio:.6f} (above 1: model_flops_for's 2·N a "
        f"token counts the embedding, a gather, and the head, which a "
        f"prefill runs at the last position only), mfu {mfu:.4f} "
        f"(model_flops_for / (s x peak)); of the plain program, not the "
        f"kernel path: t_compute {roof.t_compute * 1e3:.4f} ms, t_memory "
        f"{roof.t_memory * 1e3:.4f} ms (counted bytes "
        f"{roof.bytes_per_device:.6e}, every pair's f32 scores in HBM), "
        f"measured / max(t_compute, t_memory) {pre_s / bound_s:.4f} "
        f"({smi})")
    say("[dryrun] prefill top FLOP ops (FLOPs, times run, source): " +
        "; ".join(f"{f:.4e} x{n} {src}"
                  for f, n, _, src in dr_inspect.top_flops(totals, 5)))
    if roof.flops_per_device != want_flops:
        fail(f"dry-run prefill: counted {roof.flops_per_device:.6e} FLOPs, "
             f"the plain prefill's matmuls are {want_flops:.6e}")
    if not ratio > 0 or not 0 < mfu < 1 or not 0 < hfu < 1:
        fail(f"dry-run prefill: useful_flops_ratio {ratio}, mfu {mfu}, "
             f"counted FLOPs / (s x peak) {hfu}")

    # (b) phase 4's vmap round of full-width VGG-9 at the paper's setup
    vcfg, fl = ctx["vgg_cfg"], ctx["fl_v"]
    k, bb, hw = fl.clients_per_round, fl.batch_per_client, vcfg.image_size
    params = cnn.init_params(vcfg, None, meta)
    batch = {"images": torch.empty((k, bb, hw, hw, vcfg.in_channels),
                                   device=meta),
             "labels": torch.empty((k, bb), dtype=torch.int32, device=meta)}
    sizes = torch.empty((k,), device=meta)
    round_fn = build_round_vmap(
        lambda p, bt: cnn.classify_loss(p, vcfg, bt), UnitMap.build(params),
        fl)
    vt = opcount.analyze(round_fn, params, batch, sizes)
    want = ctx["vgg_arg_bytes"]
    round_s = ctx["rv_ms"] / 1e3
    share = vt.flops / (round_s * F32_FLOPS)
    say(f"[dryrun] {vcfg.name} vmap fedldf round (N={fl.num_clients}, "
        f"K={k}, n={fl.top_n}, B={bb}), counted on meta: argument bytes "
        f"{vt.argument_bytes:.0f} (phase 4 allocated {want}); "
        f"{len(vt.records)} ops; conv/matmul FLOPs a round "
        f"{vt.flops:.6e}, bytes {vt.hbm_bytes:.6e}; measured round "
        f"{round_s * 1e3:.3f} ms (phase 8, median of 3): share of "
        f"F32_FLOPS {share:.5f} (FLOPs / (s x {F32_FLOPS:.3e})) ({smi})")
    say("[dryrun] round top FLOP ops: " + "; ".join(
        f"{f:.4e} x{n} {src}" for f, n, _, src in
        dr_inspect.top_flops(vt, 5)))
    if vt.argument_bytes != want:
        fail(f"dry-run round: argument bytes {vt.argument_bytes:.0f}, "
             f"phase 4 allocated {want}")
    if not vt.flops > 0 or not 0 < share < 1:
        fail(f"dry-run round: FLOPs {vt.flops}, share {share}")
    say(f"[dryrun] phase 19: {time.perf_counter() - t19:.1f} s")


# ----------------------------------------------------------------------
# phase 20: the six port examples, then serve_llm's path at full width
# ----------------------------------------------------------------------
# (example, argv, the launches its main makes, by counter; every other
# counter 0). quickstart: 1 Eq. 3 call for its step-by-step round, 1 a
# vmap round; compressed: 1 a round and 1 packed uplink a round;
# custom_strategy: two 3-round runs; fedlama: 4 rounds, then 2 + 2 for the
# resume; fl_cifar_vgg: fedldf's 2 rounds (fedavg needs no divergence);
# serve_llm (reduced mamba2, scan mode, K = 3): a call each a client
EXAMPLE_RUNS = (
    ("quickstart", ["--rounds", "3"], {"sqdiff_rowsum": 4}),
    ("compressed_fl", ["--bits", "8", "--rounds", "3"],
     {"sqdiff_rowsum": 3, "fused_uplink_ef": 3}),
    ("compressed_fl", ["--bits", "auto", "--rounds", "3"],
     {"sqdiff_rowsum": 3, "fused_uplink_ef": 3}),
    ("compressed_fl", ["--bits", "4", "--no-error-feedback", "--rounds", "2"],
     {"sqdiff_rowsum": 2, "fused_uplink": 2}),
    ("custom_strategy", ["--rounds", "3"], {"sqdiff_rowsum": 6}),
    ("fedlama_fl", ["--rounds", "4"], {"sqdiff_rowsum": 8}),
    ("fl_cifar_vgg", ["--paper-scale", "--rounds", "2", "--algos",
                      "fedldf,fedavg"], {"sqdiff_rowsum": 2}),
    ("serve_llm", ["--rounds", "2"],
     {"sqdiff_rowsum": 6, "masked_accumulate": 6}),
)
# fl_cifar_vgg --paper-scale, 2 rounds: n·model + K·U·4 a round for
# fedldf, K·model for fedavg (VGG-9: 18,838,824 B, 9 units; n=4, K=20)
CIFAR_UPLINK = {"fedldf": 150_712_032, "fedavg": 753_552_960}
P20_ROUNDS = 2              # serve_llm's fine-tuning rounds at full width
P20_STEPS = 12              # and its greedy decode steps
# the plain versions the kernels replace: none may run in phase 20
PLAIN_NAMES = ("sqdiff_rowsum", "sqdiff_rowsum_leaves", "masked_accumulate",
               "masked_accumulate_leaves", "fused_uplink",
               "fused_uplink_leaves", "fused_uplink_ef",
               "fused_uplink_ef_leaves", "flash_attention")


def core_entry(mangled):
    """``flash_fwd<T, HD>``'s mangled name as "f32 hd 128" (else as is)."""
    m = re.search(r"flash_fwdI(f|13__nv_bfloat16)Li(\d+)E", mangled)
    return (f"{'f32' if m.group(1) == 'f' else 'bf16'} hd {m.group(2)}"
            if m else mangled)


@contextlib.contextmanager
def plain_calls_counted():
    """Counts the calls of the kernels' plain versions
    (``repro_torch.kernels.ref``) while it is open: the dispatch runs
    them only for a tensor on the CPU."""
    from repro_torch.kernels import ref as kref
    seen = dict.fromkeys(PLAIN_NAMES, 0)
    saved = {n: getattr(kref, n) for n in PLAIN_NAMES}

    def counted(name, fn):
        def call(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(kref, name, counted(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(kref, name, fn)


@contextlib.contextmanager
def flash_calls_recorded(limit):
    """Keeps the first ``limit`` calls of the flash-attention kernel's
    wrapper (their q, k, v and masks, as the model passed them) while it
    is open; every call goes on to the kernel, so the launch counts are
    the path's own."""
    from repro_torch.kernels import flash_attention as fa
    calls, kernel = [], fa.flash_attention

    def recording(q, k, v, **kw):
        if len(calls) < limit:
            calls.append((q, k, v, kw))
        return kernel(q, k, v, **kw)

    fa.flash_attention = recording
    try:
        yield calls
    finally:
        fa.flash_attention = kernel


def load_example(name):
    """``examples/<name>_torch.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase20(ctx):
    """The six port examples through their ``main`` (a, and quickstart
    again as a script), then ``serve_llm``'s fine-tune-then-serve path at
    full width and depth through the example's own functions (b), with
    the hybrid's flash-attention calls of a local step and of its serving
    held against the plain attention (``ctx["main_path_check"]``), the
    local step's also timed (``ctx["core_times"]``).
    Returns the launches of both, by counter."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.units import UnitMap, tree_leaves
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import transformer as tf
    dev, smi = ctx["dev"], ctx["smi"]
    t20 = time.perf_counter()
    total = dict.fromkeys(ops.KERNELS, 0)

    def launched(fn, quiet=False):
        """fn()'s result, its seconds (synchronised), the kernels it
        launched and the plain versions it called (the nonzero counts),
        and its tail of standard output when ``quiet``."""
        ops.reset_launch_counts()
        out_buf = io.StringIO()
        with plain_calls_counted() as plain, \
                (contextlib.redirect_stdout(out_buf) if quiet
                 else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        for k, v in counts.items():
            total[k] += v
        tail = " | ".join(out_buf.getvalue().strip().splitlines()[-2:])
        return out, secs, counts, {k: v for k, v in plain.items() if v}, tail

    # ---- (a) each example's main, in this process ----------------------
    mods = {}
    for name, argv, want in EXAMPLE_RUNS:
        mod = mods.setdefault(name, load_example(name))
        args = argv + ["--device", dev.type]
        out, secs, counts, plain, tail = launched(
            lambda: mod.main(args), quiet=True)
        say(f"[example {name}] {' '.join(args)}: {secs:.2f} s; launches "
            f"{counts} (want {want}); plain versions called {plain}; "
            f"output: {tail}")
        if counts != want or plain:
            fail(f"example {name} {' '.join(args)}: launches {counts}, "
                 f"expected {want}; plain versions called {plain}")
        if name == "fl_cifar_vgg":
            got = {a: log.meter.uplink_bytes for a, log in out.items()}
            say(f"[example fl_cifar_vgg] paper-scale uplink over 2 rounds: "
                f"{got} (want {CIFAR_UPLINK}); final test error "
                f"{ {a: log.test_errors[-1][1] for a, log in out.items()} }")
            if got != CIFAR_UPLINK:
                fail(f"fl_cifar_vgg --paper-scale: uplink {got}, expected "
                     f"{CIFAR_UPLINK}")
    # one example from a checkout, as a script of its own
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--rounds", "3", "--device", dev.type], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    say(f"[example quickstart] python examples/quickstart_torch.py --rounds "
        f"3 with PYTHONPATH=src: rc {res.returncode}, "
        f"{time.perf_counter() - t0:.2f} s; {lines[-1] if lines else ''}")
    if res.returncode or not lines or "total uplink" not in lines[-1]:
        fail(f"examples/quickstart_torch.py as a script: rc "
             f"{res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")

    # ---- (b) serve_llm's path at full width and depth -------------------
    sl = mods["serve_llm"]
    for arch in SSM_ARCHS:
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                                  compute_dtype="float32")
        hybrid = tf.block_kind(cfg) == "hybrid"
        toks, data, fl = sl.fl_task(cfg)
        k = fl.clients_per_round
        t0 = time.perf_counter()
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dev)
        torch.cuda.synchronize()
        leaves = tree_leaves(params)
        p_bytes = sum(l_.numel() * l_.element_size() for l_ in leaves)
        units = UnitMap.build(params).num_units
        # n·model + K·U·4 a round, as the round's comm record holds it: a
        # float32 (the nearest to this many bytes is a multiple of 256)
        exact = fl.top_n * p_bytes + k * units * 4
        want_up = P20_ROUNDS * float(np.float32(exact))
        say(f"[serve_llm {arch}] full width and depth, f32: "
            f"{sum(l_.numel() for l_ in leaves):,} params = {p_bytes:,} B "
            f"in {len(leaves)} leaves and {units} units; init "
            f"{time.perf_counter() - t0:.2f} s; FL: {fl.num_clients} "
            f"clients, K={k}, top-n {fl.top_n}, B={fl.batch_per_client}, "
            f"{sl.SEQ_LEN}-token sequences, mode {fl.mode}; reckoned peak "
            f"4 x params = {4 * p_bytes / 2**30:.2f} GiB (the global "
            f"model, a client's local copy, its gradient, the Eq. 5 "
            f"accumulator) + activations")
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # the hybrid's first local step's calls (one a layer) are kept
        with flash_calls_recorded(cfg.num_layers if hybrid else 0) as \
                step_calls:
            (trained, log), secs, counts, plain, _ = launched(
                lambda: sl.finetune(cfg, params, data, fl, P20_ROUNDS, dev,
                                    verbose=False))
        peak = torch.cuda.max_memory_allocated()
        del params
        want = {"sqdiff_rowsum": k * P20_ROUNDS,
                "masked_accumulate": k * P20_ROUNDS}
        if hybrid:
            # a launch a layer a local step; scan mode trains each client
            # twice a round (Eq. 3, then the streamed Eq. 5)
            route = flash_attention.route(torch.float32, sl.SEQ_LEN - 1,
                                          cfg.hd)
            n_fa = cfg.num_layers * 2 * k * P20_ROUNDS
            want.update({"flash_attention": n_fa,
                         f"flash_attention_{route}": n_fa})
            say(f"[serve_llm {arch}] flash attention: {cfg.num_layers} "
                f"launches a local step ({2 * k * P20_ROUNDS} local steps), "
                f"route {route!r} (f32, {sl.SEQ_LEN - 1} query rows, hd "
                f"{cfg.hd}); its backward in plain ops (ref."
                f"flash_attention_bwd)")
        say(f"[serve_llm {arch}] fine-tune {P20_ROUNDS} rounds: "
            f"{secs:.3f} s ({secs / P20_ROUNDS * 1e3:.1f} ms a round, the "
            f"first warming up); losses {log.losses}; uplink "
            f"{log.meter.uplink_bytes:,.0f} B (want {want_up:,.0f}: "
            f"{P20_ROUNDS} x f32({exact:,})); launches "
            f"{counts} (want {want}); plain versions called {plain}; peak "
            f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above "
            f"the {held / 2**30:.2f} GiB held (reckoned "
            f"{4 * p_bytes / 2**30:.2f} GiB)")
        if counts != want or plain:
            fail(f"serve_llm {arch} fine-tune: launches {counts}, expected "
                 f"{want}; plain versions called {plain}")
        if not all(math.isfinite(x) for x in log.losses) or \
                log.meter.uplink_bytes != want_up:
            fail(f"serve_llm {arch} fine-tune: losses {log.losses}, uplink "
                 f"{log.meter.uplink_bytes}, expected {want_up}")

        if hybrid:
            # the training calls on the kernel's route against plain, and
            # their time
            ctx["core_times"](step_calls, f"one {arch} f32 local step")
        del step_calls

        # serve the fine-tuned model; every step's logits against forward,
        # and the hybrid's every flash call (the cache's written prefix,
        # which later steps leave alone) against plain
        with flash_calls_recorded(
                cfg.num_layers * P20_STEPS if hybrid else 0) as serve_calls:
            (prompts, run), gsecs, gcounts, gplain, _ = launched(
                lambda: sl.generate(trained, cfg, toks, P20_STEPS, dev))
        gwant = {}
        if hybrid:
            pre = flash_attention.route(torch.float32, sl.PROMPT_LEN, cfg.hd)
            gwant = {"flash_attention": cfg.num_layers * P20_STEPS}
            for r, n_ in ((pre, cfg.num_layers),
                          ("decode", cfg.num_layers * (P20_STEPS - 1))):
                gwant[f"flash_attention_{r}"] = \
                    gwant.get(f"flash_attention_{r}", 0) + n_
        with torch.inference_mode():
            seq = torch.cat([prompts, run.tokens[:, :-1]], dim=1)
            full = tf.forward(trained, cfg, seq)[0][:, sl.PROMPT_LEN - 1:]
            got = torch.stack(run.logits, dim=1)
            tol = SERVE_RTOL * float(got.abs().max())
            d_full = float((got - full).abs().max())
        del full, got
        say(f"[serve_llm {arch}] serve {sl.PROMPTS} prompts of "
            f"{sl.PROMPT_LEN} tokens, {P20_STEPS} greedy steps: "
            f"{gsecs * 1e3:.1f} ms; launches {gcounts} (want {gwant}); "
            f"logits vs forward over the same tokens: max_abs_diff "
            f"{d_full:.3e} (limit {tol:.3e} = {SERVE_RTOL} x max |logit|); "
            f"tokens {run.tokens[0].tolist()}")
        if gcounts != gwant or gplain or not d_full <= tol:
            fail(f"serve_llm {arch} serve: launches {gcounts}, expected "
                 f"{gwant}; plain versions called {gplain}; logits "
                 f"{d_full:.3e} from forward (limit {tol:.3e})")
        if hybrid:
            with torch.inference_mode():
                ctx["main_path_check"](serve_calls, f"{arch} serving",
                                       "f32")
        del serve_calls

        # one more run_training call of 1 round timed, and one under
        # torch.profiler; each call's wall-clock includes its set-up, and
        # the idle share is the profiled call's busy over its own
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sl.finetune(cfg, trained, data, fl, 1, dev, verbose=False)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        # the card's activity only: a round is tens of thousands of ops
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sl.finetune(cfg, trained, data, fl, 1, dev, verbose=False)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        say(f"[times] serve_llm {arch} fine-tune, one run_training call of "
            f"1 round (warm, set-up included): wall-clock {round_ms:.3f} "
            f"ms; under torch.profiler {prof_ms:.3f} ms with the device "
            f"busy {busy:.3f} ms, idle share {1 - busy / prof_ms:.4f} (the "
            f"profiled call and its parse {time.perf_counter() - t0:.1f} "
            f"s); peak {peak / 2**30:.2f} GiB ({smi})")
        del trained, run, prompts, prof
        torch.cuda.empty_cache()
    say(f"[examples] phase 20: {time.perf_counter() - t20:.1f} s")
    return total


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke test needs a "
             "CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}; run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import vgg9_cifar10 as vgg9
    from repro_torch.core.aggregation import aggregate_stacked
    from repro_torch.core.selection import topn_divergence
    from repro_torch.core.units import UnitMap, tree_leaves, tree_map
    from repro_torch.core.wire import UNIT_HEADER_BYTES
    from repro_torch.core.comm import comm_acc_init
    from repro_torch.data import (ClientShards, FederatedData, iid_partition,
                                  make_image_dataset)
    from repro_torch.federated import (ALGOS, CompressionConfig, FLConfig,
                                       KeyedDraws,
                                       build_round_scan, build_round_vmap,
                                       make_local_update, make_strategy,
                                       run_training, run_training_scan,
                                       sample_clients)
    from repro_torch.federated import server as fl_server
    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, aggregate, divergence,
                                     flash_attention, ops, uplink)
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import serve
    # H100 SXM data sheet: HBM rate, the f32 rate outside the tensor cores
    # and the dense bf16 tensor-core rate (one source: launch/roofline.py)
    from repro_torch.launch.roofline import F32_FLOPS
    from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.roofline import PEAK_FLOPS as BF16_FLOPS
    from repro_torch.models import decode as dec
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import accuracy, classify_loss, init_params
    from repro_torch.models.config import dtype_of
    from repro_torch.optim import sgd

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. device ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(smi)
    say(f"[device] torch.cuda.get_device_name(0)={kind!r} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")

    # ---- 2. build -----------------------------------------------------
    say(f"[elapsed] phase 2 starts at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    build_s = _build.build()
    say(f"[build] nvcc, one process a source, all started together: "
        f"{time.perf_counter() - t0:.2f} s in all; seconds a source from the "
        f"start: " + ", ".join(f"{n} {build_s[n]:.2f}" if n in build_s else
                               f"{n} (built before)"
                               for n in _build.SOURCES))
    # the CUDA-core route's instantiations as ptxas reports them
    core = _build.ptxas_report(_build.PTXAS.get("flash_attention", ""))
    say("[build] flash_attention.cu, nvcc -Xptxas -v: " + ("; ".join(
        f"{core_entry(e)}: {r} registers, spill stores {st} B, spill loads "
        f"{ld} B" for e, (r, st, ld) in core.items())
        or "built before, no report"))
    say("[build] flash_attention.cu on this card (cudaFuncGetAttributes, "
        "the occupancy calculator): " + "; ".join(
            f"{dn} hd {hd}: {o['smem_bytes']:,} B shared a block, "
            f"{o['blocks_per_sm']} blocks an SM, {o['registers']} registers, "
            f"{o['local_bytes']} B local"
            for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
            for hd in flash_attention.HEAD_DIMS
            for o in (flash_attention.core_occupancy(hd, dt),)))

    # ---- 3. kernels vs plain on the card -------------------------------
    say(f"[elapsed] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    failures = []
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def compare(label, got, want, tol=TOL, quiet=False):
        torch.cuda.synchronize()
        err = (got - want).abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp_min(1e-30)).max())
        ok = bool(torch.allclose(got, want, **tol))
        if not (quiet and ok):
            say(f"[kernel] {label}: max_abs_err={abs_err:.3e} "
                f"max_rel_err={rel_err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return abs_err

    for shape in SHAPES:
        for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            a, b = randn(shape, dtype), randn(shape, dtype)
            compare(f"sqdiff_rowsum {shape} {dn}",
                    divergence.sqdiff_rowsum(a, b), kref.sqdiff_rowsum(a, b))
            acc, x, w = randn(shape), randn(shape, dtype), randn(shape[:1])
            compare(f"masked_accumulate {shape} {dn}",
                    aggregate.masked_accumulate(acc, x, w),
                    kref.masked_accumulate(acc, x, w), EXACT)
    main_err = {"sqdiff_rowsum": 0.0, "masked_accumulate": 0.0}
    big = 3 * 3 * 512 * 512                   # VGG-9 conv7.w, one row
    for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for rows in (20, 1):
            a, b = randn((rows, big), dtype), randn((1, big), dtype)
            e = compare(f"sqdiff_rowsum ({rows}, {big}) b=(1, {big}) {dn}",
                        divergence.sqdiff_rowsum(a, b),
                        kref.sqdiff_rowsum(a, b))
            if dtype == torch.float32:
                main_err["sqdiff_rowsum"] = max(main_err["sqdiff_rowsum"], e)
        acc, x, w = randn((1, big)), randn((1, big), dtype), randn((1,))
        want = kref.masked_accumulate(acc, x, w)
        got = aggregate.masked_accumulate(acc, x, w, out=acc)   # in place
        e = compare(f"masked_accumulate (1, {big}) in place {dn}", got, want,
                    EXACT)
        if dtype == torch.float32:
            main_err["masked_accumulate"] = e

    def uplink_inputs(shape):
        k_, r_, _ = shape
        lv = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        return (lv, torch.rand((k_, r_), generator=gen, device=dev) + 1e-4,
                torch.rand((k_, r_), generator=gen, device=dev))

    big_uplink = (20, 1, big)                 # conv7.w of K=20 clients
    main_err["fused_uplink"] = main_err["fused_uplink_ef"] = 0.0
    for shape in UPLINK_SHAPES + [big_uplink]:
        lv, sc, w = uplink_inputs(shape)
        e = compare(f"fused_uplink {shape}", uplink.fused_uplink(lv, sc, w),
                    kref.fused_uplink(lv, sc, w), EXACT)
        if shape == big_uplink:
            main_err["fused_uplink"] = e
    for shape in UPLINK_EF_SHAPES + [big_uplink]:
        for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            lv, sc, w = uplink_inputs(shape)
            gate = (torch.rand(shape[:2], generator=gen, device=dev)
                    < 0.5).float()
            v, e_old = randn(shape, dtype), randn(shape, dtype)
            num, res = uplink.fused_uplink_ef(lv, sc, w, gate, v, e_old)
            want_num, want_res = kref.fused_uplink_ef(lv, sc, w, gate, v,
                                                      e_old)
            e1 = compare(f"fused_uplink_ef {shape} {dn} num", num, want_num,
                         EXACT)
            e2 = compare(f"fused_uplink_ef {shape} {dn} res", res, want_res,
                         EXACT)
            off = gate == 0
            if not torch.equal(res[off], e_old.float()[off]):
                failures.append(f"fused_uplink_ef {shape} {dn}: gate == 0 "
                                "rows do not keep e_old exactly")
            if shape == big_uplink and dtype == torch.float32:
                main_err["fused_uplink_ef"] = max(e1, e2)
    del lv, sc, w, gate, v, e_old, num, res, want_num, want_res

    # the leaf-table kernels: a list of leaves in one launch (one a chunk of
    # 48), bit for bit; VGG-9's 34 full-width leaves as the round sees
    # them, the reference SHAPES as one-entry and mixed tables (a scalar
    # leaf and a misaligned view among vectorised ones), a table longer
    # than one launch holds, and the uplink's skip of w = 0 rows
    vgg_shapes = [(1, leaf.numel()) for leaf in tree_leaves(init_params(
        vgg9.config(), torch.Generator().manual_seed(SEED), "cpu"))]

    def macc_table(shapes, dtype):
        """(acc, x, w) a leaf; every third leaf's weights are 0."""
        accs, xs, ws = [], [], []
        for i, shape in enumerate(shapes):
            accs.append(randn(shape))
            xs.append(randn(shape, dtype))
            ws.append(randn(shape[:1]) * (i % 3 != 0))
        return accs, xs, ws

    def check_macc_table(label, accs, xs, ws, chunks):
        want = [kref.masked_accumulate(a, x, w) for a, x, w in
                zip(accs, xs, ws)]
        before = ops.launch_counts()["masked_accumulate"]
        aggregate.masked_accumulate_leaves(accs, xs, ws)      # in place
        launched = ops.launch_counts()["masked_accumulate"] - before
        err = max(compare(f"masked_accumulate_leaves {label}, leaf {i}", a,
                          b, EXACT, quiet=True)
                  for i, (a, b) in enumerate(zip(accs, want)))
        say(f"[kernel] masked_accumulate_leaves {label}: {len(accs)} leaves "
            f"in {launched} launch(es) (want {chunks}), in place: "
            f"max_abs_err={err:.3e} (exact)")
        if launched != chunks:
            failures.append(f"masked_accumulate_leaves {label}: {launched} "
                            f"launches, expected {chunks}")
        return err

    def uplink_table(shapes, k, dense=False):
        """(levels, scales, w) a leaf of k clients; unless dense, 4 of
        every 5 clients have w = 0 (fedldf's n = 4 of K = 20)."""
        levels, scales, ws = [], [], []
        for r, c in shapes:
            lv, sc, w = uplink_inputs((k, r, c))
            if not dense:
                w[torch.arange(k, device=dev) % 5 != 0] = 0.0
            levels.append(lv)
            scales.append(sc)
            ws.append(w)
        return levels, scales, ws

    def check_uplink_table(label, levels, scales, ws, chunks):
        """Bit for bit, NaN where the plain version has NaN."""
        want = kref.fused_uplink_leaves(levels, scales, ws)
        before = ops.launch_counts()["fused_uplink"]
        got = uplink.fused_uplink_leaves(levels, scales, ws)
        launched = ops.launch_counts()["fused_uplink"] - before
        torch.cuda.synchronize()
        err, bad, nans = 0.0, 0, 0
        for a, b in zip(got, want):
            nan = torch.isnan(b)
            nans += int(nan.sum())
            if not (torch.equal(torch.isnan(a), nan)
                    and torch.equal(a[~nan], b[~nan])):
                bad += 1
            if bool((~nan).any()):
                err = max(err, float((a[~nan] - b[~nan]).abs().max()))
        say(f"[kernel] fused_uplink_leaves {label}: {len(got)} leaves in "
            f"{launched} launch(es) (want {chunks}): max_abs_err={err:.3e} "
            f"(exact), {nans} NaN as plain, {bad} leaves differ")
        if bad or launched != chunks:
            failures.append(f"fused_uplink_leaves {label}: {bad} leaves "
                            f"differ, {launched} launches")
        return err

    for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        e = check_macc_table(f"VGG-9 full table {dn}",
                             *macc_table(vgg_shapes, dtype), 1)
        if dtype == torch.float32:
            main_err["masked_accumulate"] = max(
                main_err["masked_accumulate"], e)
        for shape in TABLE_SHAPES:
            check_macc_table(f"{shape} one-entry {dn}",
                             *macc_table([shape], dtype), 1)
        accs, xs, ws = macc_table(TABLE_SHAPES + [(1, 4096), (4, 1000),
                                                  (1, 10)], dtype)
        accs[3] = torch.randn(4097, generator=gen, device=dev)[1:].view(
            1, 4096)                                # 4 bytes off 16
        check_macc_table(f"mixed {dn}", accs, xs, ws, 1)
    check_macc_table("100 leaves", *macc_table(
        [(1 + i % 3, 16 * (1 + i % 5)) for i in range(100)],
        torch.float32), 3)
    for dense, rows in ((False, "16 of 20 rows w=0"),
                        (True, "every w non-zero")):
        e = check_uplink_table(f"VGG-9 full table K=20, {rows}",
                               *uplink_table(vgg_shapes, 20, dense), 1)
        main_err["fused_uplink"] = max(main_err["fused_uplink"], e)
    for shape in TABLE_SHAPES:
        check_uplink_table(f"{shape} K=5 one-entry",
                           *uplink_table([shape], 5), 1)
    levels, scales, ws = uplink_table(TABLE_SHAPES + [(1, 4096), (3, 1000),
                                                      (1, 10)], 5)
    levels[3] = torch.randint(-127, 128, (5 * 4096 + 1,), generator=gen,
                              device=dev, dtype=torch.int8)[1:].view(
                                  5, 1, 4096)         # 1 byte off 16
    check_uplink_table("mixed K=5", levels, scales, ws, 1)
    check_uplink_table("100 leaves K=3", *uplink_table(
        [(1 + i % 2, 16 * (1 + i % 7)) for i in range(100)], 3), 3)
    levels, scales, ws = uplink_table([(1, 4096), (2, 10)] * 3, 5)
    for i, bad in enumerate((math.inf, math.nan, 3e38)):
        for j, (k_, r_) in enumerate(((1, 0), (1, 1))):
            ws[2 * i + j][k_, r_] = 0.0
            scales[2 * i + j][k_, r_] = bad
    check_uplink_table("w=0 rows with scale inf, NaN, 3e38 (not skipped)",
                       levels, scales, ws, 1)
    del accs, xs, ws, levels, scales

    # the grouped Eq. 3 divergence and the grouped error-feedback uplink:
    # one C call over a table of leaves (one a chunk of 48); the divergence
    # within TOL of plain and bit for bit the per-leaf kernel composed in
    # leaf order from 0, the EF uplink bit for bit
    def sq_table(shapes, kk, dtype):
        """(a (K·n, C), b (n, C), unit) a leaf; leaf i's rows are its own
        units."""
        a, b, units, off = [], [], [], 0
        for n, c in shapes:
            a.append(randn((kk * n, c), dtype))
            b.append(randn((n, c), dtype))
            units.append((off, n))
            off += n
        return a, b, units

    def check_sq_table(label, a, b, units, calls):
        before = ops.launch_counts()["sqdiff_rowsum"]
        got = divergence.sqdiff_rowsum_leaves(a, b, units)
        launched = ops.launch_counts()["sqdiff_rowsum"] - before
        err = compare(f"sqdiff_rowsum_leaves {label}", got,
                      kref.sqdiff_rowsum_leaves(a, b, units), quiet=True)
        kk = got.shape[0]
        composed = torch.zeros_like(got)
        for x, y, (off, n) in zip(a, b, units):
            composed[:, off:off + n] = (composed[:, off:off + n] + divergence
                                        .sqdiff_rowsum(x, y).reshape(kk, n))
        same = torch.equal(got, composed)
        again = torch.equal(got, divergence.sqdiff_rowsum_leaves(a, b, units))
        say(f"[kernel] sqdiff_rowsum_leaves {label}: {len(a)} leaves, "
            f"(K, U) = {tuple(got.shape)}, in {launched} call(s) of 2 "
            f"kernels (want {calls}): max_abs_err={err:.3e} (rtol "
            f"{TOL['rtol']}, atol {TOL['atol']}); bit for bit the per-leaf "
            f"kernel composed in leaf order {same}; the same on a second "
            f"call {again}")
        if launched != calls or not (same and again):
            failures.append(f"sqdiff_rowsum_leaves {label}: {launched} calls,"
                            f" composed {same}, repeatable {again}")
        return err

    for kk in (20, 1):
        for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            e = check_sq_table(f"VGG-9 full table K={kk} {dn}",
                               *sq_table(vgg_shapes, kk, dtype), 1)
            if dtype == torch.float32:
                main_err["sqdiff_rowsum"] = max(main_err["sqdiff_rowsum"], e)
    for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for shape in TABLE_SHAPES:
            check_sq_table(f"{shape} K=3 one-entry {dn}",
                           *sq_table([shape], 3, dtype), 1)
        a, b, units = sq_table(TABLE_SHAPES + [(1, 4096), (4, 1000),
                                               (1, 10)], 3, dtype)
        a[3] = torch.randn(3 * 4096 + 1, generator=gen, device=dev,
                           dtype=dtype)[1:].view(3, 4096)   # 4 bytes off
        units[3] = (0, 1)                   # unit 0 holds two leaves
        check_sq_table(f"mixed K=3 {dn}", a, b, units, 1)
    a, b, _ = sq_table([(1, 10), (1, 4096), (3, 20), (3, 4096), (1, 33)], 4,
                       torch.float32)
    check_sq_table("stacked units (n = 3) K=4", a, b,
                   [(0, 1), (1, 1), (2, 3), (2, 3), (5, 1)], 1)
    shapes = [(1 + i % 3, 16 * (1 + i % 5)) for i in range(100)]
    a, b, _ = sq_table(shapes, 2, torch.float32)
    check_sq_table("100 leaves K=2", a, b,
                   [(i % 7, n) for i, (n, _) in enumerate(shapes)], 3)

    def ef_table(shapes, kk, v_dtype, e_dtype):
        """(levels, v, e_old) a leaf and the shared (K, U) scales, w and
        gate; 4 of every 5 clients have gate = 0 and w = 0 (fedldf's n = 4
        of K = 20)."""
        levels, v, e, units, off = [], [], [], [], 0
        for n, c in shapes:
            levels.append(torch.randint(-127, 128, (kk, n, c), generator=gen,
                                        device=dev, dtype=torch.int8))
            v.append(randn((kk, n, c), v_dtype))
            e.append(randn((kk, n, c), e_dtype))
            units.append((off, n))
            off += n
        sc = torch.rand((kk, off), generator=gen, device=dev) + 1e-4
        gate = (torch.arange(kk, device=dev) % 5 == 0).float()[:, None] \
            .expand(kk, off).contiguous()
        w = torch.rand((kk, off), generator=gen, device=dev) * gate
        return levels, v, e, units, sc, w, gate

    def check_ef_table(label, levels, v, e, units, sc, w, gate, calls,
                       keeps_e=True):
        """Bit for bit, NaN where the plain version has NaN; gate = 0 rows
        keep e_old (with finite inputs)."""
        want = kref.fused_uplink_ef_leaves(levels, v, e, units, sc, w, gate)
        before = ops.launch_counts()["fused_uplink_ef"]
        got = uplink.fused_uplink_ef_leaves(levels, v, e, units, sc, w, gate)
        launched = ops.launch_counts()["fused_uplink_ef"] - before
        torch.cuda.synchronize()
        err, bad, nans, kept = 0.0, 0, 0, True
        for (num, res), (wn, wr), ee, (off, n) in zip(got, want, e, units):
            for x, y in ((num, wn), (res, wr)):
                nan = torch.isnan(y)
                nans += int(nan.sum())
                if not (torch.equal(torch.isnan(x), nan)
                        and torch.equal(x[~nan], y[~nan])):
                    bad += 1
                if bool((~nan).any()):
                    err = max(err, float((x[~nan] - y[~nan]).abs().max()))
            off_rows = gate[:, off:off + n] == 0
            kept &= torch.equal(res[off_rows], ee.float()[off_rows])
        say(f"[kernel] fused_uplink_ef_leaves {label}: {len(got)} leaves in "
            f"{launched} launch(es) (want {calls}): max_abs_err={err:.3e} "
            f"(exact), {nans} NaN as plain, {bad} outputs differ; gate = 0 "
            f"rows keep e_old: {kept}")
        if bad or launched != calls or (keeps_e and not kept):
            failures.append(f"fused_uplink_ef_leaves {label}: {bad} outputs "
                            f"differ, {launched} launches, keeps e {kept}")
        return err

    for vd, vn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for ed, en in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            e = check_ef_table(f"VGG-9 full table K=20, v {vn}, e_old {en}",
                               *ef_table(vgg_shapes, 20, vd, ed), 1)
            if vd == ed == torch.float32:
                main_err["fused_uplink_ef"] = max(main_err["fused_uplink_ef"],
                                                  e)
    for shape in TABLE_SHAPES:
        check_ef_table(f"{shape} K=5 one-entry",
                       *ef_table([shape], 5, torch.float32, torch.float32), 1)
    levels, v, e_, units, sc, w, gate = ef_table(
        TABLE_SHAPES + [(1, 4096), (3, 1000), (1, 10)], 5, torch.float32,
        torch.bfloat16)
    levels[3] = torch.randint(-127, 128, (5 * 4096 + 1,), generator=gen,
                              device=dev, dtype=torch.int8)[1:].view(
                                  5, 1, 4096)         # 1 byte off 16
    v[3] = torch.randn(5 * 4096 + 1, generator=gen, device=dev)[1:].view(
        5, 1, 4096)                                  # 4 bytes off 16
    check_ef_table("mixed K=5", levels, v, e_, units, sc, w, gate, 1)
    levels, v, e_, units, sc, w, gate = ef_table([(1, 4096), (2, 10)] * 3, 5,
                                                 torch.float32, torch.float32)
    for i, bad in enumerate((math.inf, math.nan, 3e38)):
        sc[1, units[2 * i][0]] = bad          # gate = 0, w = 0
        sc[0, units[2 * i][0] + 1] = bad      # gate = 1
        v[2 * i + 1][1, 0, 3] = bad           # a non-finite v, gate = 0
    check_ef_table("scales inf, NaN, 3e38 and non-finite v (every row "
                   "read)", levels, v, e_, units, sc, w, gate, 1,
                   keeps_e=False)
    check_ef_table("100 leaves K=3", *ef_table(
        [(1 + i % 2, 16 * (1 + i % 7)) for i in range(100)], 3,
        torch.float32, torch.float32), 3)
    del a, b, levels, v, e_, sc, w, gate

    fa_err = dict.fromkeys(flash_attention.ROUTES, 0.0)
    fa_seen = dict.fromkeys(flash_attention.ROUTES, 0)

    def flash_check(label, q, k, v, dn, quiet=False, **kw):
        """The kernel of the call's route against the plain version; the
        route is checked against the launch counts."""
        route = flash_attention.route(q.dtype, q.shape[1], q.shape[-1])
        before = ops.launch_counts()[f"flash_attention_{route}"]
        got = flash_attention.flash_attention(q, k, v, **kw)
        if ops.launch_counts()[f"flash_attention_{route}"] != before + 1:
            failures.append(f"flash_attention {label}: not on route {route}")
        if not bool(torch.isfinite(got).all()):
            failures.append(f"flash_attention {label}: non-finite output")
        e = compare(f"flash_attention [{route}] {label} {dn}", got.float(),
                    kref.flash_attention(q, k, v, **kw).float(),
                    {"rtol": FLASH_TOL[dn], "atol": FLASH_TOL[dn]}, quiet)
        fa_err[route] = max(fa_err[route], e)
        fa_seen[route] += 1
        return e, got

    dtypes = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
    for bh, bkv, sq, skv, hd, causal, window in FLASH_CASES:
        for dtype, dn in dtypes:
            q = randn((bh, sq, hd), dtype)
            k, v = randn((bkv, skv, hd), dtype), randn((bkv, skv, hd), dtype)
            flash_check(f"{(bh, bkv, sq, skv, hd)} causal={causal} "
                        f"window={window}", q, k, v, dn, causal=causal,
                        window=window)
    # the decode route over grouped heads, a line per (dtype, Sq, G)
    for dtype, dn in dtypes:
        for sq in (1, 5, 16):
            for group in (1, 2, 7, 8):
                q = randn((2, sq, 2 * group, 128), dtype)
                k, v = randn((2, 600, 2, 128), dtype), randn((2, 600, 2, 128),
                                                            dtype)
                rows = group * sq
                _, chunk = flash_attention.decode_plan(
                    4 * -(-rows // flash_attention.decode_row_block(rows)),
                    600, flash_attention.decode_tile(128, q.element_size()))
                errs = [flash_check(f"Sq={sq} G={group} kv_len={n}", q, k, v,
                                    dn, quiet=True, causal=c, window=w,
                                    kv_len=n)[0]
                        for n in (0, 1, chunk - 1, chunk, chunk + 1, 600)
                        for c, w in ((False, 0), (True, 0), (False, 9))]
                say(f"[kernel] flash_attention [decode] (2, {sq}, "
                    f"{2 * group}, 128) over (2, 600, 2, 128) {dn}, kv_len 0, "
                    f"1, {chunk - 1}, {chunk}, {chunk + 1}, 600, causal / "
                    f"window 9: {len(errs)} calls, max_abs_err="
                    f"{max(errs):.3e}")
    # the tensor-core route: ragged Sq, kv_len < Skv, windows, kv_len = 0
    for hd, sq, skv, kv_len, causal, window in TC_CASES:
        q = randn((2, sq, 4, hd), torch.bfloat16)
        k, v = (randn((2, skv, 2, hd), torch.bfloat16),
                randn((2, skv, 2, hd), torch.bfloat16))
        _, out = flash_check(f"(2, {sq}, 4, {hd}) over (2, {skv}, 2, {hd}) "
                             f"kv_len={kv_len} causal={causal} window="
                             f"{window}", q, k, v, "bf16", causal=causal,
                             window=window, kv_len=kv_len)
        if kv_len == 0 and not bool((out == 0).all()):
            failures.append("flash_attention [tc] kv_len=0: not all zeros")
    # fully masked rows, a case a route
    for label, dtype, dn, (qs, ks), kw, rows in (
            ("(2, 64, 16) over (2, 16, 16)", torch.float32, "f32",
             ((2, 64, 16), (2, 16, 16)), {"causal": False, "window": 8}, 23),
            ("(2, 64, 64) over (2, 16, 64)", torch.bfloat16, "bf16",
             ((2, 64, 64), (2, 16, 64)), {"causal": False, "window": 8}, 23),
            ("(4, 16, 64) over (2, 20, 64) kv_len=4", torch.float32, "f32",
             ((4, 16, 64), (2, 20, 64)),
             {"causal": False, "window": 3, "kv_len": 4}, 6)):
        q, k, v = randn(qs, dtype), randn(ks, dtype), randn(ks, dtype)
        route = flash_attention.route(dtype, qs[1], qs[2])
        _, out = flash_check(f"{label} window={kw['window']}", q, k, v, dn,
                             **kw)
        masked_ok = bool((out[:, rows:] == 0).all())
        say(f"[kernel] flash_attention [{route}] fully masked rows {rows}.. "
            f"of {label}: exactly 0 and no NaN: {masked_ok}")
        if not masked_ok:
            failures.append(f"flash_attention [{route}] fully masked rows")
    # full width: qwen3-1.7b's prefill and decode at batch 4, both dtypes
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = (randn((64, SERVE_PROMPT, 128), dtype),
                   randn((32, SERVE_PROMPT, 128), dtype),
                   randn((32, SERVE_PROMPT, 128), dtype))
        flash_check(f"prefill {(64, 32, SERVE_PROMPT, SERVE_PROMPT, 128)} "
                    f"causal", q, k, v, dn, causal=True)
        skv = SERVE_PROMPT + SERVE_STEPS
        q, k, v = (randn((64, 1, 128), dtype), randn((32, skv, 128), dtype),
                   randn((32, skv, 128), dtype))
        for kv_len in (1, SERVE_PROMPT + 1, skv):
            flash_check(f"decode {(64, 32, 1, skv, 128)} kv_len={kv_len}", q,
                        k, v, dn, causal=False, kv_len=kv_len)
    # hymba-1.5b's shapes at batch 4: 25 query heads over 5 KV heads (G =
    # 5), hd 64; a causal prefill and a decode step over its 2080 slots
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        bh, bkv, hd = 4 * HYMBA_HEADS[0], 4 * HYMBA_HEADS[1], HYMBA_HEADS[2]
        q, k, v = (randn((bh, SERVE_PROMPT, hd), dtype),
                   randn((bkv, SERVE_PROMPT, hd), dtype),
                   randn((bkv, SERVE_PROMPT, hd), dtype))
        shape = (bh, bkv, SERVE_PROMPT, SERVE_PROMPT, hd)
        flash_check(f"hymba prefill {shape} causal", q, k, v, dn,
                    causal=True)
        skv = SERVE_PROMPT + SERVE_STEPS
        q, k, v = (randn((bh, 1, hd), dtype), randn((bkv, skv, hd), dtype),
                   randn((bkv, skv, hd), dtype))
        flash_check(f"hymba decode {(bh, bkv, 1, skv, hd)} kv_len="
                    f"{SERVE_PROMPT + 1}", q, k, v, dn, causal=False,
                    kv_len=SERVE_PROMPT + 1)
    # deepseek-moe-16b's shapes at batch 4: 16 query heads over 16 KV heads
    # (G = 1), hd 128; a causal prefill and a decode step over 2080 slots
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        bh, bkv, hd = 4 * MOE_HEADS[0], 4 * MOE_HEADS[1], MOE_HEADS[2]
        q, k, v = (randn((bh, SERVE_PROMPT, hd), dtype),
                   randn((bkv, SERVE_PROMPT, hd), dtype),
                   randn((bkv, SERVE_PROMPT, hd), dtype))
        shape = (bh, bkv, SERVE_PROMPT, SERVE_PROMPT, hd)
        flash_check(f"deepseek prefill {shape} causal", q, k, v, dn,
                    causal=True)
        skv = SERVE_PROMPT + SERVE_STEPS
        q, k, v = (randn((bh, 1, hd), dtype), randn((bkv, skv, hd), dtype),
                   randn((bkv, skv, hd), dtype))
        flash_check(f"deepseek decode {(bh, bkv, 1, skv, hd)} kv_len="
                    f"{SERVE_PROMPT + 1}", q, k, v, dn, causal=False,
                    kv_len=SERVE_PROMPT + 1)
    # seamless-m4t-large-v2's shapes at batch 4: 16 query heads over 16 KV
    # heads (G = 1), hd 64; the encoder's non-causal prefill, a cross
    # prefill over a ragged frame count, a decode step over 2080 slots and
    # a cross decode step over every one of 2048 frames
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        bh, bkv = 4 * ENCDEC_HEADS[0], 4 * ENCDEC_HEADS[1]
        hd = ENCDEC_HEADS[2]
        for skv, use in ((SERVE_PROMPT, "encoder"),
                         (ENCDEC_RAGGED, "cross")):
            q, k, v = (randn((bh, SERVE_PROMPT, hd), dtype),
                       randn((bkv, skv, hd), dtype),
                       randn((bkv, skv, hd), dtype))
            flash_check(f"seamless {use} prefill "
                        f"{(bh, bkv, SERVE_PROMPT, skv, hd)} non-causal", q,
                        k, v, dn, causal=False)
        for skv, kv_len, use in (
                (SERVE_PROMPT + SERVE_STEPS, SERVE_PROMPT + 1, "decode"),
                (SERVE_PROMPT, SERVE_PROMPT, "cross decode")):
            q, k, v = (randn((bh, 1, hd), dtype), randn((bkv, skv, hd), dtype),
                       randn((bkv, skv, hd), dtype))
            flash_check(f"seamless {use} {(bh, bkv, 1, skv, hd)} kv_len="
                        f"{kv_len}", q, k, v, dn, causal=False,
                        kv_len=kv_len)
    say(f"[kernel] flash_attention calls a route in this phase: {fa_seen}; "
        f"max_abs_err a route: {fa_err}")
    if not all(fa_seen.values()):
        failures.append(f"flash_attention routes not all exercised: "
                        f"{fa_seen}")
    del q, k, v, out
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")

    # ---- 4. vmap rounds at full width ----------------------------------
    say(f"[elapsed] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    cfg = vgg9.config()
    fl_v, fl_s = vgg9.fl_config(mode="vmap"), vgg9.fl_config(mode="scan")
    t0 = time.perf_counter()
    train, _ = make_image_dataset(num_train=NUM_TRAIN, num_test=16,
                                  seed=SEED)
    data = FederatedData(train.xs, train.ys,
                         iid_partition(train.ys, fl_v.num_clients, seed=SEED))
    params0 = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    umap = UnitMap.build(params0)
    say(f"[setup] {cfg.name}: {umap.total_params} params "
        f"({umap.total_bytes / 1e6:.2f} MB f32), {umap.num_units} units, "
        f"{len(tree_leaves(params0))} leaves; {NUM_TRAIN} training images; "
        f"{time.perf_counter() - t0:.2f} s")

    def loss_fn(p, batch):
        return classify_loss(p, cfg, batch)

    def check_params(label, params):
        for a, b in zip(tree_leaves(params), tree_leaves(params0)):
            if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                fail(f"{label}: non-finite or mis-shaped parameters")

    per_round_up = (fl_v.top_n * umap.total_bytes
                    + fl_v.clients_per_round * umap.num_units * 4)

    def drive(fl, label, rounds=ROUNDS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, log = run_training(params0, loss_fn, data, fl,
                                   rounds=rounds, seed=SEED, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        check_params(label, params)
        if not all(np.isfinite(log.losses)) or len(log.losses) != rounds:
            fail(f"{label}: losses {log.losses}")
        if fl.compression is None:
            want_up = rounds * per_round_up
            if abs(log.meter.uplink_bytes - want_up) > 1e-6 * want_up:
                fail(f"{label}: uplink {log.meter.uplink_bytes} B, expected "
                     f"{want_up} B (n·model + K·U·4 per round)")
        else:   # the packed wire format's bytes are exact
            bits = int(fl.compression.bits)
            per_round = (fl.top_n * sum(math.ceil(p * bits / 8)
                                        + UNIT_HEADER_BYTES
                                        for p in umap.unit_params)
                         + fl.clients_per_round * umap.num_units * 4)
            if per_round != WANT_UPLINK[bits] or \
                    log.meter.uplink_bytes != rounds * per_round:
                fail(f"{label}: uplink {log.meter.uplink_bytes} B over "
                     f"{rounds} rounds, expected exactly {rounds} x "
                     f"{WANT_UPLINK[bits]} B (n·Σ(ceil(p·b/8)+5) + K·U·4)")
        say(f"[{label}] run_training {rounds} rounds: {wall:.3f} s "
            f"({wall / rounds:.3f} s/round incl. first-round warm-up); "
            f"losses {log.losses}; uplink {log.meter.uplink_bytes:.0f} B, "
            f"savings {log.meter.savings_frac:.4f}; launches {counts}")
        return params, counts, log

    p_vmap, counts_v, _ = drive(fl_v, "vmap")
    if counts_v["sqdiff_rowsum"] != ROUNDS:
        fail(f"vmap rounds made {counts_v['sqdiff_rowsum']} sqdiff_rowsum "
             f"calls in {ROUNDS} rounds, expected 1 a round (over the "
             f"round's leaf table)")

    # one round, kernel path vs the same round with the plain reduction
    rng = np.random.default_rng(SEED + 1)
    clients = sample_clients(rng, fl_v.num_clients, fl_v.clients_per_round)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             data.round_batch(clients, fl_v.batch_per_client, rng).items()}
    sizes = torch.from_numpy(data.data_sizes()[clients]).to(dev)
    round_v = build_round_vmap(loss_fn, umap, fl_v)
    new_v, m_v = round_v(params0, batch, sizes)
    train_clients = torch.func.vmap(
        make_local_update(loss_fn, sgd(fl_v.lr), fl_v.local_steps),
        in_dims=(None, 0))
    locals_, _ = train_clients(params0, batch)
    divs_p = umap.divergence(locals_, params0,
                             sqdiff_rowsum=kref.sqdiff_rowsum)
    divs_k = umap.divergence(locals_, params0)
    sel_p = topn_divergence(divs_p, fl_v.top_n)
    new_p = aggregate_stacked(locals_, umap, sel_p, sizes, fallback=params0)
    compare("round divergence, kernel vs plain (same locals)", divs_k,
            divs_p)
    compare("round divergence, round_fn vs plain", m_v["divergence"],
            divs_p)
    top = torch.sort(divs_p, dim=0, descending=True).values
    margin = (top[fl_v.top_n - 1] - top[fl_v.top_n]) / top[fl_v.top_n - 1]
    say(f"[vmap] smallest relative gap between the n-th and (n+1)-th "
        f"divergence of a unit: {float(margin.min()):.3e}")
    if not torch.equal(m_v["selection"], sel_p):
        fail("vmap round selection differs from the plain round's")
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(new_v), tree_leaves(new_p)))
    say(f"[vmap] round new params vs plain: max_abs_diff={d:.3e} "
        f"(limit {EQUIV_TOL})")
    if failures or d > EQUIV_TOL:
        fail("vmap round disagrees with the plain round")

    # ---- 5. scan rounds at full width ----------------------------------
    say(f"[elapsed] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    p_scan, counts_s, _ = drive(fl_s, "scan")
    for name in ("masked_accumulate", "sqdiff_rowsum"):
        if counts_s[name] != fl_s.clients_per_round * ROUNDS:
            fail(f"scan rounds made {counts_s[name]} {name} calls, expected "
                 f"{fl_s.clients_per_round} a round (one a client, over its "
                 f"leaf table)")
    round_s = build_round_scan(loss_fn, umap, fl_s)
    new_s, m_s = round_s(params0, batch, sizes)
    if not torch.equal(m_s["selection"], m_v["selection"]):
        fail("scan round selection differs from the vmap round's")
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(new_s), tree_leaves(new_v)))
    say(f"[scan] round new params vs vmap round: max_abs_diff={d:.3e} "
        f"(limit {EQUIV_TOL})")
    if d > EQUIV_TOL:
        fail("scan round disagrees with the vmap round")
    # why local training runs without cuDNN: client 0's local model from
    # the stacked (vmap) path vs from a single-client call, both ways
    gv = torch.func.grad(loss_fn)
    b0 = {k: v[:1] for k, v in batch.items()}
    for use_cudnn in (True, False):
        torch.backends.cudnn.enabled = use_cudnn
        g_all = torch.func.vmap(gv, in_dims=(None, 0))(params0, batch)
        g_one = torch.func.vmap(gv, in_dims=(None, 0))(params0, b0)
        d_loc = max(float((a[0] - b[0]).abs().max()) * fl_v.lr for a, b in
                    zip(tree_leaves(g_all), tree_leaves(g_one)))
        say(f"[scan] client 0 local model, K={fl_v.clients_per_round} "
            f"stacked vs alone, cuDNN {'on' if use_cudnn else 'off'}: "
            f"max_abs_diff={d_loc:.3e}")
    torch.backends.cudnn.enabled = True
    d3 = max(float((a - b).abs().max()) for a, b in
             zip(tree_leaves(p_scan), tree_leaves(p_vmap)))
    say(f"[scan] after {ROUNDS} rounds, params vs vmap: max_abs_diff="
        f"{d3:.3e} (information only)")

    # ---- 6./7. the packed compressed uplink at full width ---------------
    say(f"[elapsed] phase 6/7 starts at {time.perf_counter() - t_start:.1f} s")
    fl_a = vgg9.fl_config(compression=CompressionConfig(
        bits=8, error_feedback=True))
    fl_b = vgg9.fl_config(compression=CompressionConfig(bits=4))
    divs_k = umap.divergence(locals_, params0)   # the same round's Eq. 3
    sel_k = topn_divergence(divs_k, fl_v.top_n)
    idx = torch.from_numpy(clients).to(dev)
    recorded = {"fused_uplink_leaves": [], "fused_uplink_ef_leaves": []}

    def recording(name):
        plain = getattr(kref, name)

        def run(*args):
            recorded[name].append(args)
            return plain(*args)
        return run

    def max_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))

    def rel_l2(a, b):
        num = sum(float(((x - y).double() ** 2).sum()) for x, y in
                  zip(tree_leaves(a), tree_leaves(b)))
        return (num / sum(float((x.double() ** 2).sum())
                          for x in tree_leaves(a))) ** 0.5

    def packed_checks(fl, label, counts, rounds, rows):
        """One round of ``fl``: round_fn (kernels) against the same round
        through the plain uplink kernels on the same locals; returns the
        round function and its metrics."""
        ef = fl.compression.error_feedback
        name = "fused_uplink_ef" if ef else "fused_uplink"
        entry = "fused_uplink_ef_leaves" if ef else "fused_uplink_leaves"
        # one launch over the round's leaf table, and one Eq. 3 call
        for n_ in (name, "sqdiff_rowsum"):
            if counts[n_] != rounds:
                fail(f"setting {label}: {counts[n_]} {n_} calls in {rounds} "
                     f"rounds, expected 1 a round")
        round_c = build_round_vmap(loss_fn, umap, fl)
        new_c, m_c = round_c(params0, batch, sizes, rows)
        strat = make_strategy(fl)
        res_rows = None if rows is None else rows["client"]["residual"]
        new_p, rows_p, wire_p = strat.uplink_round(
            locals_, params0, umap, sel_k, divs_k, sizes, res_rows,
            **{entry: recording(entry)})
        if not torch.equal(m_c["selection"], sel_k):
            fail(f"setting {label}: round selection differs from the plain "
                 "round's")
        pay_c, pay_p = m_c["wire"]["payload"], wire_p["payload"]
        same_levels = torch.equal(pay_c.scales, pay_p.scales) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(pay_c.levels),
                                              tree_leaves(pay_p.levels)))
        d = max_diff(new_c, new_p)
        say(f"[{label}] round vs the same round through the plain uplink "
            f"kernels: identical levels and scales {same_levels}; new "
            f"params max_abs_diff={d:.3e} (limit {EQUIV_TOL}); payload "
            f"{m_c['wire']['nbytes']} B; comm uplink_total "
            f"{float(m_c['comm']['uplink_total']):.0f} B")
        if not same_levels or d > EQUIV_TOL:
            fail(f"setting {label}: round disagrees with the plain round")
        if rows_p is not None:
            dr = max_diff(m_c["state"]["client"]["residual"], rows_p)
            say(f"[{label}] residual rows vs plain: max_abs_diff={dr:.3e}")
            if dr > 1e-6:
                fail(f"setting {label}: residual rows disagree with plain")
        bits = int(fl.compression.bits)
        if m_c["wire"]["nbytes"] != WANT_PAYLOAD[bits] or \
                float(m_c["comm"]["uplink_total"]) != WANT_UPLINK[bits]:
            fail(f"setting {label}: payload {m_c['wire']['nbytes']} B or "
                 f"uplink {float(m_c['comm']['uplink_total'])} B, expected "
                 f"{WANT_PAYLOAD[bits]} and {WANT_UPLINK[bits]}")
        return round_c, new_c, m_c

    # setting A: int8 levels with error feedback
    _, counts_a, log_a = drive(fl_a, "A")
    store = log_a.final_state["client"]["residual"]
    if any(s_.shape != (fl_a.num_clients,) + p_.shape or s_.dtype != p_.dtype
           for s_, p_ in zip(tree_leaves(store), tree_leaves(params0))):
        fail("setting A: the residual store is not (50, ...) in the "
             "params' dtype")
    rows_a = {"client": {"residual": tree_map(lambda l: l[idx], store)}}
    round_a, new_a, m_a = packed_checks(fl_a, "A", counts_a, ROUNDS,
                                          rows_a)
    fl_l = vgg9.fl_config(compression=CompressionConfig(
        bits=8, error_feedback=True, fused=False))
    new_l, m_l = build_round_vmap(loss_fn, umap, fl_l)(params0, batch, sizes,
                                                       rows_a)
    r = rel_l2(new_a, new_l)
    say(f"[A] packed round vs the legacy unfused chain: relative L2 "
        f"{r:.3e} (limit 1e-4); identical selection "
        f"{torch.equal(m_l['selection'], m_a['selection'])}")
    if r >= 1e-4 or not torch.equal(m_l["selection"], m_a["selection"]):
        fail("setting A: packed round disagrees with the legacy chain")

    # setting B: int4 levels, no error feedback
    _, counts_b, _ = drive(fl_b, "B", rounds=ROUNDS_B)
    round_b, _, _ = packed_checks(fl_b, "B", counts_b, ROUNDS_B,
                                     None)
    # the kernel on the round's own call (the 34 leaves it was handed)
    up_call = recorded["fused_uplink_leaves"][0]
    e = check_uplink_table("setting B round's own call", *up_call, 1)
    main_err["fused_uplink"] = max(main_err["fused_uplink"], e)
    # and the EF kernel on setting A's own call (its 34 leaves)
    ef_call = recorded["fused_uplink_ef_leaves"][0]
    e = check_ef_table("setting A round's own call", *ef_call, 1)
    main_err["fused_uplink_ef"] = max(main_err["fused_uplink_ef"], e)
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")

    # ---- 8. times ------------------------------------------------------
    say(f"[elapsed] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
    flush = torch.empty(64 * 2**20, device=dev)     # 256 MB > 50 MB L2

    def device_ms(fn, reps=20, prep=None):
        """Median device time of fn() with a cold L2 (but for what prep()
        reads after the flush): a GPU spin holds the stream while the host
        enqueues fn, so host gaps are not timed."""
        for _ in range(3):
            fn()
        spans, host = [], []
        for _ in range(reps):
            flush.zero_()
            if prep is not None:
                prep()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            h = time.perf_counter()
            s.record()
            fn()
            e.record()
            host.append(time.perf_counter() - h)
            spans.append((s, e))
        torch.cuda.synchronize()
        return (statistics.median(s.elapsed_time(e) for s, e in spans),
                statistics.median(host) * 1e3)

    def bound_ms(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def nb(t):
        return t.numel() * t.element_size()

    # sqdiff_rowsum: one vmap round's Eq. 3 (K=20) and one scan-round
    # client's (K=1), the leaf tables UnitMap.sq_divergence hands the
    # kernel, in one call each; beside them the per-leaf loop of the
    # single-leaf entry, and that loop with the old composition of the unit
    # sums (UnitMap.sq_divergence's per-leaf argument)
    k = fl_v.clients_per_round
    local0 = tree_map(lambda v: v[0].contiguous(), locals_)

    def sq_args(loc, kk):
        a, b, units = [], [], []
        for key, (off, n) in umap.spans.items():
            for x, y in zip(tree_leaves(loc[key]), tree_leaves(params0[key])):
                a.append(x.reshape(kk * n, -1))
                b.append(y.reshape(n, -1))
                units.append((off, n))
        return a, b, units

    def sq_bound(a, b, kk):
        return bound_ms(sum(nb(x) + nb(y) for x, y in zip(a, b))
                        + kk * umap.num_units * 4,
                        sum(3 * x.numel() for x in a))

    sq_times = {}
    for kk, loc in ((k, locals_), (1, local0)):
        a, b, units = sq_args(loc, kk)
        e = check_sq_table(f"the main path's own leaves, K={kk}", a, b,
                           units, 1)
        main_err["sqdiff_rowsum"] = max(main_err["sqdiff_rowsum"], e)
        bound, by = sq_bound(a, b, kk)
        ms, host = device_ms(lambda: divergence.sqdiff_rowsum_leaves(
            a, b, units))
        loop, loop_host = device_ms(lambda: [divergence.sqdiff_rowsum(x, y)
                                             for x, y in zip(a, b)])
        old, old_host = device_ms(lambda: umap.sq_divergence(
            loc, params0, sqdiff_rowsum=divergence.sqdiff_rowsum))
        plain, _ = device_ms(lambda: kref.sqdiff_rowsum_leaves(a, b, units))
        # what keeping b (the global model) in L2 could give: b read just
        # before the timed call, after the flush
        warm_b, _ = device_ms(lambda: divergence.sqdiff_rowsum_leaves(
            a, b, units), prep=lambda: torch._foreach_norm(b))
        # a cold L2 without the flush's dirty lines: reading the flush
        # buffer after writing it leaves L2 clean, so no write-back
        # competes with the call's reads
        clean, _ = device_ms(lambda: divergence.sqdiff_rowsum_leaves(
            a, b, units), prep=lambda: flush.sum())
        sq_times[kk] = dict(ms=ms, host=host, loop=loop, loop_host=loop_host,
                            old=old, old_host=old_host, plain=plain,
                            bound=bound, by=by, warm_b=warm_b, clean=clean,
                            n=len(a),
                            mb=sum(nb(x) + nb(y) for x, y in zip(a, b)) / 1e6)
        if kk == 1:
            # two PyTorch calls that give the leaves' L2 norms (not the f32
            # sums of squares the unit map needs)
            fa = [x.reshape(-1) for x in a]
            fb = [y.reshape(-1) for y in b]
            sq_times[kk]["lib"], _ = device_ms(
                lambda: torch._foreach_norm(torch._foreach_sub(fa, fb)))
            # where a call's device time goes: its two kernels under the
            # profiler (pass 1 over the table, pass 2 over the units)
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    divergence.sqdiff_rowsum_leaves(a, b, units)
                torch.cuda.synchronize()
            sq_times[kk]["kernels"] = {
                ev.key[:40]: ev.self_device_time_total / ev.count / 1e3
                for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and "sqdiff" in ev.key}
            # the same 10 calls back to back under CUDA events: what a call
            # takes beyond its two kernels' device time is the gap between
            # them (and the ramps), the most a one-launch finish could save
            torch.cuda._sleep(SLEEP_CYCLES)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(10):
                divergence.sqdiff_rowsum_leaves(a, b, units)
            ev1.record()
            torch.cuda.synchronize()
            sq_times[kk]["warm_span"] = ev0.elapsed_time(ev1) / 10
    sq_ms, sq_plain = sq_times[k]["ms"], sq_times[k]["plain"]
    sq_bound_v, sq_by = sq_times[k]["bound"], sq_times[k]["by"]
    sq_pairs = list(zip(*sq_args(locals_, k)[:2]))
    # masked_accumulate: one client's Eq. 5 streaming add (scan round), the
    # (acc, x, w) triples UnitMap.accumulate hands the kernel, recorded
    # through its per-leaf argument
    frac = m_s["selection"][0] * 0.05
    acc = tree_map(torch.zeros_like, params0)
    ma_triples = []

    def record_macc(a, x, w):
        ma_triples.append((a, x, w))
        return kref.masked_accumulate(a, x, w)

    umap.accumulate(acc, local0, frac, masked_accumulate=record_macc)
    ma_accs, ma_xs, ma_ws = (list(t) for t in zip(*ma_triples))
    e = check_macc_table("one scan-round client's own triples",
                         [a.clone() for a in ma_accs], ma_xs, ma_ws, 1)
    main_err["masked_accumulate"] = max(main_err["masked_accumulate"], e)
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")
    ma_bytes = sum(2 * nb(a) + nb(x) + nb(w) for a, x, w in ma_triples)
    ma_flops = sum(2 * a.numel() for a, _, _ in ma_triples)
    ma_bound, ma_by = bound_ms(ma_bytes, ma_flops)
    ma_ms, ma_host = device_ms(lambda: aggregate.masked_accumulate_leaves(
        ma_accs, ma_xs, ma_ws))
    ma_loop, ma_loop_host = device_ms(lambda: [
        aggregate.masked_accumulate(a, x, w, out=a)
        for a, x, w in ma_triples])
    ma_plain, _ = device_ms(lambda: [kref.masked_accumulate(a, x, w, out=a)
                                     for a, x, w in ma_triples])
    ma_lib, _ = device_ms(lambda: [a.addcmul_(w[:, None], x)
                                   for a, x, w in ma_triples])
    ma_w2 = [w[:, None] for w in ma_ws]
    ma_fe, _ = device_ms(lambda: torch._foreach_addcmul_(ma_accs, ma_xs,
                                                         ma_w2))
    # does the foreach call run as one multi-tensor launch? count its
    # kernels under the profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch._foreach_addcmul_(ma_accs, ma_xs, ma_w2)
        torch.cuda.synchronize()
    fe_kernels = sum(ev.count for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
    # the single largest leaf alone (conv7.w)
    s7, b7 = max(sq_pairs, key=lambda p: p[0].numel())
    big_sq, _ = device_ms(lambda: divergence.sqdiff_rowsum(s7, b7))
    big_sq_bound, _ = bound_ms(nb(s7) + nb(b7) + s7.shape[0] * 4,
                               3 * s7.numel())
    m7, x7, w7 = max(ma_triples, key=lambda p: p[0].numel())
    big_ma, _ = device_ms(lambda: aggregate.masked_accumulate(
        m7, x7, w7, out=m7))
    big_ma_lib, _ = device_ms(lambda: m7.addcmul_(w7[:, None], x7))
    big_ma_bound, _ = bound_ms(2 * nb(m7) + nb(x7) + nb(w7), 2 * m7.numel())

    # fused_uplink_ef: one setting-A round's call over its 34 leaves;
    # fused_uplink: one setting-B round's; the arguments the round gave the
    # kernels. ef_leaves: the same call as one single-leaf entry a leaf
    # (the (K, n) segments of scales, w and gate copied untimed)
    ef_levels, ef_v, ef_e, ef_units, ef_s, ef_w, ef_g = ef_call
    ef_leaves = [(lv, *(t[:, off:off + n].contiguous()
                        for t in (ef_s, ef_w, ef_g)), v, e)
                 for lv, v, e, (off, n) in zip(ef_levels, ef_v, ef_e,
                                               ef_units)]
    up_leaves = list(zip(*up_call))

    def ef_bytes(a):
        lv, sc, w, g, v, e = a
        return (nb(lv) + nb(sc) + nb(w) + nb(g) + nb(v) + nb(e)
                + lv[0].numel() * 4 + lv.numel() * 4)     # num, res

    def up_bytes(a, live_only=False):
        """Levels of every client row, or (live_only) of the rows with
        w != 0, which are all the skip reads; scales, w and num."""
        lv, sc, w = a
        rows = int((w != 0).sum()) if live_only else w.numel()
        return rows * lv.shape[2] + nb(sc) + nb(w) + lv[0].numel() * 4

    def up_flops(a, live_only=False):
        lv, _, w = a
        return 3 * lv.shape[2] * (int((w != 0).sum()) if live_only
                                  else w.numel())

    # the shared (K, U) scales, w and gate are read once
    ef_nbytes = (sum(ef_bytes(a) - nb(a[1]) - nb(a[2]) - nb(a[3])
                     for a in ef_leaves) + nb(ef_s) + nb(ef_w) + nb(ef_g))
    ef_bound, ef_by = bound_ms(ef_nbytes,
                               sum(7 * a[0].numel() for a in ef_leaves))
    ef_ms, ef_host = device_ms(lambda: uplink.fused_uplink_ef_leaves(
        *ef_call))
    ef_loop, ef_loop_host = device_ms(lambda: [uplink.fused_uplink_ef(*a)
                                               for a in ef_leaves])
    ef_plain, _ = device_ms(lambda: kref.fused_uplink_ef_leaves(*ef_call))
    e7 = max(ef_leaves, key=lambda a: a[0].numel())
    big_ef, _ = device_ms(lambda: uplink.fused_uplink_ef(*e7))
    big_ef_bound, _ = bound_ms(ef_bytes(e7), 7 * e7[0].numel())
    up_nbytes = sum(up_bytes(a) for a in up_leaves)
    up_bound_all, up_by_all = bound_ms(up_nbytes,
                                       sum(up_flops(a) for a in up_leaves))
    up_live = sum(up_bytes(a, True) for a in up_leaves)
    up_bound, up_by = bound_ms(up_live,
                               sum(up_flops(a, True) for a in up_leaves))
    up_ms, up_host = device_ms(lambda: uplink.fused_uplink_leaves(*up_call))
    up_loop, up_loop_host = device_ms(lambda: [uplink.fused_uplink(*a)
                                               for a in up_leaves])
    up_plain, _ = device_ms(lambda: kref.fused_uplink_leaves(*up_call))
    lib_args = [(a[0].float(), a[1], a[2]) for a in up_leaves]  # untimed
    up_lib, _ = device_ms(lambda: [torch.einsum("kr,krc->rc", w * sc, lf)
                                   for lf, sc, w in lib_args])
    # the same call with every w non-zero: every client row is read
    dense = (up_call[0], up_call[1],
             [torch.rand(w.shape, generator=gen, device=dev) + 0.01
              for w in up_call[2]])
    check_uplink_table("setting B round's call, every w non-zero", *dense,
                       1)
    up_dense, _ = device_ms(lambda: uplink.fused_uplink_leaves(*dense))
    u7 = max(up_leaves, key=lambda a: a[0].numel())
    big_up, _ = device_ms(lambda: uplink.fused_uplink(*u7))
    big_up_bound, _ = bound_ms(up_bytes(u7, True), up_flops(u7, True))
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")
    del lib_args, dense

    def round_ms(fn, *state):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(params0, batch, sizes, *state)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    rv_ms, rs_ms = round_ms(round_v), round_ms(round_s)
    # what phase 19 holds the dry-run's count of the vmap round to
    vgg_arg_bytes = (sum(nb(t) for t in tree_leaves(params0))
                     + sum(nb(t) for t in batch.values()) + nb(sizes))
    ra_ms, rb_ms = round_ms(round_a, rows_a), round_ms(round_b)
    sq_per_round_v = counts_v["sqdiff_rowsum"] // ROUNDS
    sq_per_round_s = counts_s["sqdiff_rowsum"] // ROUNDS
    ma_per_round = counts_s["masked_accumulate"] // ROUNDS
    say(f"[times] card: {smi}")
    for kk, use in ((k, "one vmap round's Eq. 3"),
                    (1, "one scan-round client's Eq. 3")):
        t = sq_times[kk]
        say(f"[times] sqdiff_rowsum, {use} ({t['n']} leaves in 1 call of 2 "
            f"kernels, K={kk}, {t['mb']:.2f} MB): kernel_ms={t['ms']:.4f} "
            f"bound_ms={t['bound']:.4f} ({t['by']}) plain_ms="
            f"{t['plain']:.4f} host_enqueue_ms={t['host']:.4f}; the "
            f"single-leaf entry a leaf ({t['n']} calls): kernel_ms="
            f"{t['loop']:.4f} host_enqueue_ms={t['loop_host']:.4f}; with "
            f"the per-leaf composition of the unit sums (UnitMap."
            f"sq_divergence's per-leaf argument): kernel_ms={t['old']:.4f} "
            f"host_enqueue_ms={t['old_host']:.4f}; b read into L2 just "
            f"before the call: kernel_ms={t['warm_b']:.4f}; a cold L2 with "
            f"no dirty lines to write back: kernel_ms={t['clean']:.4f}")
    t = sq_times[1]
    say(f"[times] sqdiff_rowsum, one scan-round client: library_ms="
        f"{t['lib']:.4f} (two calls, torch._foreach_norm(torch."
        f"_foreach_sub(a, b)); it returns the leaves' L2 norms, not the f32 "
        f"per-unit sums of squares); device ms a kernel under torch."
        f"profiler (warm L2, 10 calls): {t['kernels']}; the same 10 calls "
        f"under CUDA events: {t['warm_span']:.4f} ms a call, "
        f"{t['warm_span'] - sum(t['kernels'].values()):.4f} ms beyond the "
        f"two kernels; x{k} clients: about {t['ms'] * k:.4f} ms a scan "
        f"round")
    say(f"[times] sqdiff_rowsum calls per round: vmap {sq_per_round_v}, "
        f"scan {sq_per_round_s} (2 kernels a call); library_ms=none for a "
        f"vmap round (no single PyTorch call computes a per-unit sum of "
        f"squared differences; F.pairwise_distance adds eps and takes the "
        f"root)")
    say(f"[times] sqdiff_rowsum, conv7.w alone {tuple(s7.shape)}: "
        f"kernel_ms={big_sq:.4f} bound_ms={big_sq_bound:.4f}")
    say(f"[times] masked_accumulate, one client's Eq. 5 add "
        f"({len(ma_triples)} leaves in 1 launch, {ma_bytes / 1e6:.2f} MB, "
        f"in place): kernel_ms={ma_ms:.4f} bound_ms={ma_bound:.4f} "
        f"({ma_by}) plain_ms={ma_plain:.4f} library_ms={ma_lib:.4f} "
        f"({len(ma_triples)} addcmul_) host_enqueue_ms={ma_host:.4f}; "
        f"second library_ms={ma_fe:.4f} (one torch._foreach_addcmul_ call: "
        f"{fe_kernels} kernel launches, "
        f"{'' if fe_kernels == 1 else 'not '}one multi-tensor launch); "
        f"the single-leaf entry a leaf: kernel_ms={ma_loop:.4f} "
        f"host_enqueue_ms={ma_loop_host:.4f}; launches per round: scan "
        f"{ma_per_round} (x{k} clients: about {ma_ms * k:.4f} ms a round)")
    say(f"[times] masked_accumulate, conv7.w alone {tuple(m7.shape)}: "
        f"kernel_ms={big_ma:.4f} bound_ms={big_ma_bound:.4f} "
        f"library_ms={big_ma_lib:.4f}")
    ef_per_round = counts_a["fused_uplink_ef"] // ROUNDS
    up_per_round = counts_b["fused_uplink"] // ROUNDS_B
    say(f"[times] fused_uplink_ef, one setting-A round ({len(ef_leaves)} "
        f"leaves in 1 launch, K={k}, {ef_nbytes / 1e6:.2f} MB): kernel_ms="
        f"{ef_ms:.4f} bound_ms={ef_bound:.4f} ({ef_by}) plain_ms="
        f"{ef_plain:.4f} library_ms=none (no single PyTorch call returns "
        f"both the Eq. 5 numerator and the gated residual) "
        f"host_enqueue_ms={ef_host:.4f}; the single-leaf entry a leaf: "
        f"kernel_ms={ef_loop:.4f} host_enqueue_ms={ef_loop_host:.4f}; "
        f"launches per round: {ef_per_round}")
    say(f"[times] fused_uplink_ef, conv7.w alone {tuple(e7[0].shape)}: "
        f"kernel_ms={big_ef:.4f} bound_ms={big_ef_bound:.4f}")
    say(f"[times] fused_uplink, one setting-B round ({len(up_leaves)} "
        f"leaves in 1 launch, K={k}): kernel_ms={up_ms:.4f} "
        f"bound_ms={up_bound:.4f} ({up_by}; the rows with w != 0, "
        f"{up_live / 1e6:.2f} MB) bound_ms_all_rows={up_bound_all:.4f} "
        f"({up_by_all}, {up_nbytes / 1e6:.2f} MB) plain_ms={up_plain:.4f} "
        f"library_ms={up_lib:.4f} ({len(up_leaves)} torch.einsum"
        f"(\"kr,krc->rc\", w*s, levels_f32); the int8->f32 conversion of "
        f"the levels is not timed) host_enqueue_ms={up_host:.4f}; every w "
        f"non-zero: kernel_ms={up_dense:.4f}; the single-leaf entry a "
        f"leaf: kernel_ms={up_loop:.4f} host_enqueue_ms={up_loop_host:.4f};"
        f" launches per round: {up_per_round}")
    say(f"[times] fused_uplink, conv7.w alone {tuple(u7[0].shape)}: "
        f"kernel_ms={big_up:.4f} bound_ms={big_up_bound:.4f} (w != 0 "
        f"rows)")
    say(f"[times] round wall-clock (median of 3, after run_training): "
        f"vmap {rv_ms:.3f} ms, scan {rs_ms:.3f} ms, setting A {ra_ms:.3f} "
        f"ms, setting B {rb_ms:.3f} ms ({smi})")

    # ---- 9. serving full-width qwen3-1.7b in f32 ------------------------
    say(f"[elapsed] phase 9 starts at {time.perf_counter() - t_start:.1f} s")
    del flush

    def main_path_check(calls, label, dn):
        """The main path's own calls (strided views of the projections and
        of the stacked cache), kernel of their route against plain."""
        errs, bad = [], 0
        route = flash_attention.route(calls[0][0].dtype, calls[0][0].shape[1],
                                      calls[0][0].shape[-1])
        for q, k, v, kw in calls:
            got = flash_attention.flash_attention(q, k, v, **kw).float()
            want = kref.flash_attention(q, k, v, **kw).float()
            errs.append(float((got - want).abs().max()))
            bad += not torch.allclose(got, want, rtol=FLASH_TOL[dn],
                                      atol=FLASH_TOL[dn])
        say(f"[kernel] flash_attention [{route}] on the {label}'s "
            f"{len(calls)} recorded calls (model views, kv_len "
            f"{sorted({kw.get('kv_len') for _, _, _, kw in calls}, key=str)}"
            f"): max_abs_err={max(errs):.3e}, {bad} outside rtol=atol="
            f"{FLASH_TOL[dn]}")
        if bad:
            fail(f"flash_attention disagrees with its plain version on {bad} "
                 f"of the {label}'s calls")
        fa_err[route] = max(fa_err[route], max(errs))

    def fa_bound(calls, flops_per_s):
        nbytes = flops = 0
        for q, k, v, kw in calls:
            b_, sq_, h_, hd_ = q.shape
            kv_len = kw.get("kv_len") or k.shape[1]
            # the mask broadcasts over the rows where no mask needs them
            pairs = int(kref._attention_mask(
                sq_, k.shape[1], kw["causal"], kw["window"], kv_len,
                dev).expand(sq_, k.shape[1]).sum())
            nbytes += 2 * nb(q) + 2 * b_ * kv_len * k.shape[2] * hd_ * \
                k.element_size()
            flops += 4 * b_ * h_ * hd_ * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    def route_times(calls, flops_per_s):
        """Device ms of one use's calls through the kernel, the plain
        version and scaled_dot_product_attention (layout copies untimed),
        the bound, and the kernel's host enqueue ms."""
        lib_args = []
        for q, k, v, kw in calls:
            n = kw.get("kv_len") or k.shape[1]
            lib_args.append((q.transpose(1, 2).contiguous(),
                             k[:, :n].transpose(1, 2).contiguous(),
                             v[:, :n].transpose(1, 2).contiguous(),
                             kw["causal"]))
        k_ms, k_host = device_ms(lambda: [
            flash_attention.flash_attention(q, k, v, **kw)
            for q, k, v, kw in calls], reps=5)
        p_ms, _ = device_ms(lambda: [kref.flash_attention(q, k, v, **kw)
                                     for q, k, v, kw in calls], reps=5)
        l_ms, _ = device_ms(lambda: [
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=c, enable_gqa=True)
            for q, k, v, c in lib_args], reps=5)
        b_ms, b_by = fa_bound(calls, flops_per_s)
        return k_ms, p_ms, l_ms, b_ms, b_by, k_host

    def core_times(calls, use):
        """The CUDA-core route (f32) on one use's recorded calls: held to
        the plain version, then timed (a cold L2 from a flush buffer of
        its own) and printed as a [times] line."""
        nonlocal flush
        t_use = time.perf_counter()
        main_path_check(calls, use, "f32")
        flush = torch.empty(64 * 2**20, device=dev)
        try:
            k_ms, p_ms, l_ms, b_ms, b_by, k_host = route_times(calls,
                                                               F32_FLOPS)
        finally:
            flush = None
        say(f"[times] flash_attention [cuda_core route], {use} "
            f"({len(calls)} launches): kernel_ms={k_ms:.4f} bound_ms="
            f"{b_ms:.4f} ({b_by}) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"host_enqueue_ms={k_host:.4f}; checked and timed in "
            f"{time.perf_counter() - t_use:.1f} s ({smi})")
    cfg_bf = get_config(SERVE_ARCH)
    cfg32 = dataclasses.replace(cfg_bf, param_dtype="float32",
                                compute_dtype="float32")
    layers_, steps = cfg_bf.num_layers, SERVE_STEPS + 1     # + the prefill
    gen_w = torch.Generator(device=dev)
    t0 = time.perf_counter()
    params = tf.init_params(cfg32, gen_w.manual_seed(SEED), dev)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg32.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT))).to(dev)
    torch.cuda.synchronize()
    say(f"[serve] {cfg32.name} f32: {cfg32.param_count()} params "
        f"(param_count()), {layers_} layers, d={cfg32.d_model}, "
        f"{cfg32.num_heads} heads over {cfg32.num_kv_heads} KV heads, "
        f"hd={cfg32.hd}; batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"{SERVE_STEPS} decode steps; init {time.perf_counter() - t0:.2f} s")

    def serve_once(p, cfg, label):
        """The main path: prefill + SERVE_STEPS greedy decode steps, with
        the launch counts zeroed just before and read just after. Every
        prefill launch must take the prefill route of the config's dtype
        and every decode launch the split-KV route."""
        ops.reset_launch_counts()
        run = serve.generate(p, cfg, prompts, steps, keep_logits=True)
        counts = ops.launch_counts()
        pre = flash_attention.route(dtype_of(cfg.compute_dtype),
                                    SERVE_PROMPT, cfg.hd)
        want = dict.fromkeys(flash_attention.ROUTES, 0)
        want[pre] += layers_
        want["decode"] += layers_ * SERVE_STEPS
        got = {r: counts[f"flash_attention_{r}"] for r in want}
        say(f"[{label}] prefill {run.prefill_s * 1e3:.3f} ms, decode "
            f"{run.decode_s_per_token * 1e3:.3f} ms/token; flash_attention "
            f"launches {counts['flash_attention']} (want {layers_} x (1 + "
            f"{SERVE_STEPS})), by route {got} (want {want})")
        if counts["flash_attention"] != layers_ * steps or got != want:
            fail(f"{label}: flash_attention launches {got}, expected {want}: "
                 f"{layers_} a prefill on the {pre} route and {layers_} a "
                 f"decode step on the decode route")
        if not all(bool(torch.isfinite(lg).all()) and
                   lg.shape == (SERVE_BATCH, cfg.vocab_size)
                   for lg in run.logits):
            fail(f"{label}: non-finite or mis-shaped logits")
        return run, got

    run32, n32 = serve_once(params, cfg32, "serve f32")
    recorded_fa = []

    def recording_fa(q, k, v, **kw):
        recorded_fa.append((q, k, v, kw))
        return kref.flash_attention(q, k, v, **kw)

    # the same steps through the plain attention on the card, fed the
    # kernel run's tokens (the prefill's calls are kept for the CUDA-core
    # route's times)
    with torch.inference_mode():
        lg, cache = dec.prefill(params, cfg32, prompts,
                                max_len=SERVE_PROMPT + steps,
                                flash_attention=recording_fa)
        plain = [lg]
        for t in range(SERVE_STEPS):
            lg, cache = dec.decode_step(params, cfg32,
                                        run32.tokens[:, t:t + 1], cache,
                                        flash_attention=kref.flash_attention)
            plain.append(lg)
        del cache
        seq = torch.cat([prompts, run32.tokens[:, :SERVE_STEPS]], dim=1)
        full = tf.forward(params, cfg32, seq)[0][:, SERVE_PROMPT - 1:]
    got = torch.stack(run32.logits, dim=1)              # (B, steps, V)
    plain = torch.stack(plain, dim=1)
    scale = float(got.abs().max())
    tol = SERVE_RTOL * scale
    d_plain = float((got - plain).abs().max())
    d_full = float((got - full).abs().max())
    top2 = plain.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                   # (B, steps)
    same = plain.argmax(dim=-1) == run32.tokens
    near = (gap < tol).any(dim=0)
    bad = (~same & (gap >= tol)).any(dim=0)
    say(f"[serve f32] max |logit| {scale:.4f}; kernel vs plain: max_abs_diff "
        f"{d_plain:.3e}; prefill + decode vs forward: max_abs_diff "
        f"{d_full:.3e} (limit {tol:.3e} = {SERVE_RTOL} x max |logit|); "
        f"greedy tokens equal at {int(same.all(dim=0).sum())} of {steps} "
        f"steps; steps with a top-2 gap below the limit: "
        f"{near.nonzero().flatten().tolist()}")
    if d_plain > tol or d_full > tol or bool(bad.any()):
        fail("serving f32: the kernel path disagrees with the plain path or "
             "with forward")
    del params, plain, full, got, seq
    pre32_calls = recorded_fa[:]
    main_path_check(pre32_calls, "f32 prefill", "f32")
    flush = torch.empty(64 * 2**20, device=dev)
    fa_times = {"cuda_core": route_times(pre32_calls, F32_FLOPS)}
    del pre32_calls, recorded_fa, flush
    torch.cuda.empty_cache()

    # ---- 10. serving in the config's own bf16, timed -----------------------
    say(f"[elapsed] phase 10 starts at {time.perf_counter() - t_start:.1f} s")
    params = tf.init_params(cfg_bf, gen_w.manual_seed(SEED), dev)
    serve.generate(params, cfg_bf, prompts[:, :256], 4)            # warm-up
    runs = [serve_once(params, cfg_bf, f"serve bf16 #{i}") for i in range(3)]
    # main-path launches a route: the f32 run and the three bf16 runs
    launches = {r: n32[r] + sum(n[r] for _, n in runs)
                for r in flash_attention.ROUTES}
    pre_ms = statistics.median(r.prefill_s * 1e3 for r, _ in runs)
    tok_ms = statistics.median(r.decode_s_per_token * 1e3 for r, _ in runs)
    recorded_fa = []
    with torch.inference_mode():
        lg, cache = dec.prefill(params, cfg_bf, prompts,
                                max_len=SERVE_PROMPT + steps,
                                flash_attention=recording_fa)
        pre_calls = recorded_fa[:]
        dec.decode_step(params, cfg_bf, lg.argmax(-1)[:, None], cache,
                        flash_attention=recording_fa)
        dec_calls = recorded_fa[len(pre_calls):]
        main_path_check(pre_calls, "bf16 prefill", "bf16")
        main_path_check(dec_calls, "bf16 decode step", "bf16")
    flush = torch.empty(64 * 2**20, device=dev)
    fa_times["tc"] = route_times(pre_calls, BF16_FLOPS)
    fa_times["decode"] = route_times(dec_calls, BF16_FLOPS)
    del pre_calls, dec_calls, recorded_fa, cache, flush

    # where a serving step's time goes: device time by kernel under
    # torch.profiler, against the step's host wall-clock measured above
    from torch.profiler import ProfilerActivity, profile
    busy = {}
    with torch.inference_mode():
        for label in ("prefill", "decode"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if label == "prefill":
                    lg, cache = dec.prefill(params, cfg_bf, prompts,
                                            max_len=SERVE_PROMPT + steps)
                else:
                    dec.decode_step(params, cfg_bf, lg.argmax(-1)[:, None],
                                    cache)
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy[label] = sum(e.self_device_time_total for e in kern) / 1e3
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
            say(f"[profile] one bf16 {label}: device busy {busy[label]:.3f} "
                f"ms; top kernels: " + "; ".join(
                    f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))
        del cache
    say(f"[profile] device idle share: prefill "
        f"{1 - busy['prefill'] / pre_ms:.3f}, decode "
        f"{1 - busy['decode'] / tok_ms:.3f} (busy time under the profiler "
        f"against the median host wall-clock of the timed runs)")
    for route, use in (("tc", "one bf16 prefill"),
                       ("decode", "one bf16 decode step"),
                       ("cuda_core", "one f32 prefill")):
        k_ms, p_ms, l_ms, b_ms, b_by, k_host = fa_times[route]
        say(f"[times] flash_attention [{route} route], {use} "
            f"({layers_} launches): kernel_ms={k_ms:.4f} bound_ms="
            f"{b_ms:.4f} ({b_by}) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"(scaled_dot_product_attention, enable_gqa; layout copies "
            f"untimed) host_enqueue_ms={k_host:.4f}")
    say(f"[times] serving bf16, median of 3: prefill {pre_ms:.3f} ms, "
        f"decode {tok_ms:.3f} ms/token ({smi})")
    # what phase 19 holds the dry-run's count of this prefill to
    serve_19 = {"serve_cfg": cfg_bf, "serve_pre_ms": pre_ms,
                "serve_prompt_shape": tuple(prompts.shape),
                "serve_prompt_dtype": prompts.dtype,
                "serve_arg_bytes": sum(nb(t) for t in tree_leaves(params))
                + nb(prompts)}
    del params
    torch.cuda.empty_cache()
    say("[cli] python -m repro_torch.launch.serve --arch qwen3-1.7b "
        "--temperature 0:")
    serve.main(["--arch", SERVE_ARCH, "--temperature", "0"])

    # ---- 11. the device-resident engine at the paper's setup ------------
    say(f"[elapsed] phase 11 starts at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_e, test_e = make_image_dataset(num_train=ENGINE_TRAIN,
                                         num_test=ENGINE_TEST, seed=SEED)
    data_e = FederatedData(train_e.xs, train_e.ys, iid_partition(
        train_e.ys, fl_v.num_clients, seed=SEED))
    shards = ClientShards.from_federated(data_e).to(dev)
    test_batch = {"images": torch.from_numpy(test_e.xs).to(dev),
                  "labels": torch.from_numpy(test_e.ys).to(dev)}
    say(f"[setup] engine: {ENGINE_TRAIN} training images on the card "
        f"({shards.bytes_per_device() / 1e6:.1f} MB), {ENGINE_TEST} test "
        f"images; {time.perf_counter() - t0:.2f} s")

    def eval_fn(p):
        with torch.no_grad():
            return 1.0 - float(accuracy(p, cfg, test_batch))

    def timed(fn):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts(), time.perf_counter() - t

    def run_engine(fl, rounds, **kw):
        return timed(lambda: run_training_scan(
            params0, loss_fn, shards, fl, rounds=rounds, seed=SEED,
            device=dev, **kw))

    def run_host(fl, rounds, sampler, **kw):
        return timed(lambda: run_training(
            params0, loss_fn, shards if sampler == "device" else data_e, fl,
            rounds=rounds, seed=SEED, sampler=sampler, device=dev, **kw))

    def run_engine_from(fl, p, state):
        """Rounds 2 and 3 from a 2-round run's params and final state."""
        return timed(lambda: run_training_scan(
            p, loss_fn, shards, fl, rounds=2, seed=SEED, start_round=2,
            server_state=state, device=dev))

    def per_round(counts, rounds):
        return {n_: c / rounds for n_, c in counts.items() if c}

    def bytes_a_round(fl):
        if fl.compression is None:
            return per_round_up
        return WANT_UPLINK[int(fl.compression.bits)]

    block_fn = fl_server._build_block_fn
    eng = {}
    for label, fl, counts_p in (("vmap", fl_v, counts_v),
                                ("scan", fl_s, counts_s),
                                ("A", fl_a, counts_a)):
        r = ENGINE_ROUNDS
        (p_e, log_e), c_e, wall_e = run_engine(fl, r, eval_fn=eval_fn,
                                               eval_every=2)
        (p_2, log_2), _, _ = run_engine(fl, r, eval_fn=eval_fn, eval_every=2)
        (p_h, log_h), c_h, wall_h = run_host(fl, r, "device",
                                             eval_fn=eval_fn, eval_every=2)
        check_params(f"engine {label}", p_e)
        if not all(np.isfinite(log_e.losses)) or len(log_e.losses) != r:
            fail(f"engine {label}: losses {log_e.losses}")
        cuts = [t_ for t_, _, _ in log_e.test_errors]
        if cuts != [0, 2, 3] or \
                [t_ for t_, _, _ in log_h.test_errors] != cuts:
            fail(f"engine {label}: eval rounds {cuts}, expected [0, 2, 3] "
                 f"(cuts 1, 3, 4) in both drivers")
        # launches a round: the same as phases 4-7's host-sampler rounds
        want_l = per_round(counts_p, ROUNDS)
        if per_round(c_e, r) != want_l or per_round(c_h, r) != want_l:
            fail(f"engine {label}: launches a round {per_round(c_e, r)} "
                 f"(engine), {per_round(c_h, r)} (device sampler); phases "
                 f"4-7 made {want_l}")
        # run to run, and the engine against run_training(sampler="device")
        rr = max_diff(p_e, p_2)
        dh = max_diff(p_e, p_h)
        same_h = dh == 0.0 and log_e.losses == log_h.losses
        lim = 0.0 if rr == 0.0 and log_e.losses == log_2.losses else \
            EQUIV_TOL
        say(f"[engine {label}] run_training_scan {r} rounds, eval_every=2 "
            f"(eval after rounds {cuts}): {wall_e:.3f} s; losses "
            f"{log_e.losses}; test errors "
            f"{[round(e, 4) for _, e, _ in log_e.test_errors]}; launches "
            f"a round {per_round(c_e, r)} (phases 4-7: {want_l}); the same "
            f"call again: params max_abs_diff {rr:.3e}; run_training("
            f"sampler='device'): {wall_h:.3f} s, params max_abs_diff "
            f"{dh:.3e}, bit for bit {same_h} (limit {lim})")
        if dh > lim or (lim == 0.0 and not same_h):
            fail(f"engine {label}: run_training(sampler='device') differs "
                 f"from run_training_scan by {dh:.3e} (limit {lim})")
        # exact uplink bytes a round
        want_b = bytes_a_round(fl)
        marks = [0.0] + [u * 1e6 for u in log_e.uplink_mb]
        deltas = [b - a for a, b in zip(marks, marks[1:])]
        if log_h.meter.uplink_bytes != r * want_b or \
                any(d_ != want_b for d_ in deltas) or \
                log_e.meter.uplink_bytes != r * want_b:
            fail(f"engine {label}: uplink a round {deltas} (engine, f32 "
                 f"accumulator), total {log_h.meter.uplink_bytes} (device "
                 f"sampler); expected exactly {want_b} B a round")
        # resume: 2 + 2 rounds through the final state
        (p_a, log_a2), _, _ = run_engine(fl, 2)
        (p_b, _), _, _ = run_engine_from(fl, p_a, log_a2.final_state)
        dres = max_diff(p_b, p_e)
        say(f"[engine {label}] uplink {deltas[0]:.0f} B a round, exact in "
            f"each of {r} rounds; resume 2 + 2 rounds vs {r}: params "
            f"max_abs_diff {dres:.3e} (limit {lim})")
        if dres > lim:
            fail(f"engine {label}: resumed run differs by {dres:.3e}")
        # no host sync while a block enqueues; one pull a block after it
        run_block = block_fn(loss_fn, umap, fl)
        host_sizes = shards.part_sizes.cpu()
        all_sizes = shards.data_sizes()

        def fresh():
            return (params0, make_strategy(fl).init_state(
                params0, fl.num_clients), comm_acc_init(dev))

        draws = KeyedDraws(SEED)
        run_block(fresh(), shards, all_sizes, host_sizes, draws, 0, 2)
        carry = fresh()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            h = time.perf_counter()
            carry, per = run_block(carry, shards, all_sizes, host_sizes,
                                   draws, 0, 2)
            enqueue_s = time.perf_counter() - h
        except RuntimeError as e:
            fail(f"engine {label}: a block synchronised the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pulled = torch.stack([per["loss"], per["uplink_bytes"]]).cpu()
        block_s = time.perf_counter() - h
        if not bool(torch.isfinite(pulled).all()):
            fail(f"engine {label}: block outputs {pulled}")
        # the block's device busy time under the profiler
        # (the card's activity only: the block's tens of thousands of host
        # ops made the profile's parse the phase's largest cost)
        from torch.profiler import ProfilerActivity, profile
        carry = fresh()
        torch.cuda.synchronize()
        prof_s = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            carry, per = run_block(carry, shards, all_sizes, host_sizes,
                                   draws, 0, 2)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        prof_s = time.perf_counter() - prof_s
        del carry, per, p_2, p_h, p_a, p_b
        # round wall-clock: the engine beside the host-sampler driver
        t_eng = statistics.median(run_engine(fl, r)[2] / r * 1e3
                                  for _ in range(3))
        t_host = statistics.median(run_host(fl, r, "host")[2] / r * 1e3
                                   for _ in range(3))
        idle = 1.0 - busy / 2 / t_eng
        eng[label] = {"engine_ms": t_eng, "host_ms": t_host,
                      "device_ms": wall_h / r * 1e3, "busy_ms": busy / 2,
                      "idle": idle, "enqueue_ms": enqueue_s / 2 * 1e3,
                      "block_ms": block_s / 2 * 1e3}
        say(f"[engine {label}] one 2-round block under set_sync_debug_mode"
            f"('error'): 0 syncs while it enqueued ({enqueue_s * 1e3:.3f} "
            f"ms), then 1 pull of {tuple(pulled.shape)}; block "
            f"{block_s * 1e3:.3f} ms; device busy under torch.profiler "
            f"{busy / 2:.3f} ms a round, idle share {idle:.4f} of the "
            f"engine round (the profiled block and its parse {prof_s:.1f} "
            f"s)")
        del p_e, log_e, log_h

    # host->device bytes a round, from the shapes each driver copies
    k_, b_ = fl_v.clients_per_round, fl_v.batch_per_client
    h2d_host = (k_ * b_ * (train_e.xs[0].nbytes + train_e.ys[0].nbytes)
                + k_ * 4 + k_ * 8)           # batch, |D_k|, client ids
    h2d_engine = k_ * 8 + k_ * b_ * 8        # client ids, sample indices
    for label, e in eng.items():
        say(f"[times] engine round wall-clock ({label}, median of 3 calls of "
            f"{ENGINE_ROUNDS} rounds, set-up included): run_training_scan "
            f"{e['engine_ms']:.3f} ms, run_training(sampler='host') "
            f"{e['host_ms']:.3f} ms, run_training(sampler='device') "
            f"{e['device_ms']:.3f} ms (one call); device busy "
            f"{e['busy_ms']:.3f} ms a round, idle share {e['idle']:.4f}; "
            f"enqueue {e['enqueue_ms']:.3f} ms a round ({smi})")
    say(f"[engine] host->device bytes a round: run_training(sampler='host') "
        f"{h2d_host} B (the (K, B) batch, |D_k| and client ids), "
        f"run_training_scan {h2d_engine} B (client ids and sample indices, "
        f"one copy a block; the random policies add K*U*4 B of uniforms); "
        f"{h2d_host - h2d_engine} B less")

    # ---- 12. every strategy through the engine --------------------------
    say(f"[elapsed] phase 12 starts at {time.perf_counter() - t_start:.1f} s")
    for algo, mode in ([(a, "vmap") for a in ALGOS]
                       + [("fedadp", "scan"), ("fedldf", "scan")]):
        fl = vgg9.fl_config(algo=algo, mode=mode)
        strat = make_strategy(fl)
        k_ = fl.clients_per_round
        want_l = {}
        if strat.needs_divergence:
            want_l["sqdiff_rowsum"] = 1.0 if mode == "vmap" else float(k_)
        if mode == "scan" and strat.eq5_weighted:
            want_l["masked_accumulate"] = float(k_)
        (p_e, log_e), c_e, wall_e = run_engine(fl, 2)
        (p_h, log_h), _, _ = run_host(fl, 2, "device")
        check_params(f"{algo} {mode}", p_e)
        d = max_diff(p_e, p_h)
        up_e, up_h = log_e.meter.uplink_bytes, log_h.meter.uplink_bytes
        formula = {"fedldf": per_round_up, "fedavg": k_ * umap.total_bytes,
                   "random": fl.top_n * umap.total_bytes,
                   "hdfl": fl.top_n * umap.total_bytes,
                   "fedadp": fl.algo_options.keep * k_ * umap.total_bytes
                   if algo == "fedadp" else None}.get(algo)
        say(f"[algos] {algo} {mode}: 2 rounds {wall_e:.3f} s; losses "
            f"{log_e.losses}; launches a round {per_round(c_e, 2)} (want "
            f"{want_l}); uplink {up_e:.0f} B (engine), {up_h:.0f} B "
            f"(run_training(sampler='device'), params max_abs_diff {d:.3e})"
            + ("" if formula is None else
               f"; expected {2 * formula:.0f} B"))
        if not all(np.isfinite(log_e.losses)) or \
                per_round(c_e, 2) != want_l or d > EQUIV_TOL or \
                abs(up_e - up_h) > 1e-6 * up_h or \
                (formula is not None
                 and abs(up_h - 2 * formula) > 1e-6 * up_h):
            fail(f"{algo} {mode}: the engine's run is not as expected")
        del p_e, p_h
    del shards

    # ---- 13. federated LoRA fine-tuning of full-width qwen3-1.7b ---------
    say(f"[elapsed] phase 13 starts at {time.perf_counter() - t_start:.1f} s")
    from repro_torch.core.partition import partition_counts
    from repro_torch.data import lm_federated, make_lm_dataset
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    from repro_torch.models.lora import inject_lora, lora_partition
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    cfg_l = get_config(LORA_ARCH)
    layers_l = cfg_l.num_layers

    def lora_model(cfg):
        base = tf.init_params(cfg, gen_w.manual_seed(SEED), dev)
        p = inject_lora(base, LORA_RANK, torch.Generator(
            device=dev).manual_seed(LORA_SEED))
        return p, lora_partition(p)

    params_l, part_l = lora_model(cfg_l)
    cnt = partition_counts(part_l, params_l)
    train_l, frozen_l = part_l.split(params_l)
    umap_l = UnitMap.build(train_l)
    n_leaves = len(tree_leaves(train_l))
    # cfg.param_count() leaves out the norm scales (ln1, ln2, q_norm,
    # k_norm a layer and the final norm); the frozen tree holds them
    norms = layers_l * (2 * cfg_l.d_model + 2 * cfg_l.hd) + cfg_l.d_model
    full_bytes = cnt["trainable_bytes"] + cnt["frozen_bytes"]
    say(f"[lora] {cfg_l.name} {cfg_l.param_dtype}, rank {LORA_RANK} on wq "
        f"wk wv wo w_gate w_up w_down: trainable {cnt['trainable_params']:,}"
        f" params = {cnt['trainable_bytes']:,} B in {umap_l.num_units} units"
        f" of {umap_l.unit_bytes[0]:,} B and {n_leaves} leaves; frozen "
        f"{cnt['frozen_params']:,} params = {cnt['frozen_bytes']:,} B "
        f"(cfg.param_count() {cfg_l.param_count():,} + {norms:,} norm "
        f"scales); init {time.perf_counter() - t13:.2f} s")
    if (cnt["trainable_params"], cnt["trainable_bytes"], umap_l.num_units,
            set(umap_l.unit_bytes), n_leaves) != LORA_TRAINABLE or \
            cnt["frozen_params"] != cfg_l.param_count() + norms or \
            cnt["frozen_bytes"] != 2 * cnt["frozen_params"]:
        fail(f"lora: partition sizes {cnt}, {umap_l.num_units} units of "
             f"{set(umap_l.unit_bytes)} B, {n_leaves} leaves; expected "
             f"{LORA_TRAINABLE} and cfg.param_count() + norms frozen")
    tokens_l, domains_l = make_lm_dataset(
        num_sequences=LORA_SEQS, seq_len=LORA_SEQ_LEN + 1,
        vocab=cfg_l.vocab_size, num_domains=8, seed=SEED)
    data_l = lm_federated(tokens_l[:LORA_TRAIN], domains_l[:LORA_TRAIN],
                          LORA_N)
    shards_l = ClientShards.from_federated(data_l).to(dev)
    if shards_l.xs.dtype != torch.int32 or shards_l.ys.dtype != torch.int32:
        fail(f"lora: ClientShards carry {shards_l.xs.dtype} tokens and "
             f"{shards_l.ys.dtype} labels, expected int32")
    eval_l = {"tokens": torch.from_numpy(tokens_l[LORA_TRAIN:, :-1]).to(dev),
              "labels": torch.from_numpy(tokens_l[LORA_TRAIN:, 1:]).to(dev)}
    fl_lv = FLConfig(algo="fedldf", num_clients=LORA_N,
                     clients_per_round=LORA_K, top_n=LORA_TOP_N,
                     batch_per_client=LORA_B, lr=0.05, partition=part_l)
    lora_fl = {"vmap": fl_lv,
               "scan": dataclasses.replace(fl_lv, mode="scan"),
               "A": dataclasses.replace(fl_lv, compression=CompressionConfig(
                   bits=8, error_feedback=True))}
    loss_l = tf.make_lm_loss(cfg_l)
    k_l, u_l = LORA_K, umap_l.num_units
    # launches a round, from the round builders: the vmap round trains the
    # K clients in one vmapped local step (one flash_attention launch a
    # layer) and scores them in one Eq. 3 call; the scan round trains
    # each client twice (phase 1 and the phase-2 recompute) and scores and
    # accumulates it once; setting A adds one fused EF uplink a round
    want_l = {
        "vmap": {"sqdiff_rowsum": 1, "flash_attention": layers_l,
                 "flash_attention_tc": layers_l},
        "scan": {"sqdiff_rowsum": k_l, "masked_accumulate": k_l,
                 "flash_attention": 2 * k_l * layers_l,
                 "flash_attention_tc": 2 * k_l * layers_l},
        "A": {"sqdiff_rowsum": 1, "fused_uplink_ef": 1,
              "flash_attention": layers_l, "flash_attention_tc": layers_l}}
    per_unit_int8 = [math.ceil(p_ * 8 / 8) + UNIT_HEADER_BYTES
                     for p_ in umap_l.unit_params]
    want_up_l = {"vmap": LORA_TOP_N * umap_l.total_bytes + k_l * u_l * 4,
                 "A": LORA_TOP_N * sum(per_unit_int8) + k_l * u_l * 4}
    want_up_l["scan"] = want_up_l["vmap"]
    fedavg_full = k_l * full_bytes
    if (want_up_l["vmap"], want_up_l["A"]) != LORA_UPLINK:
        fail(f"lora: uplink formula {want_up_l}, expected {LORA_UPLINK}")
    # the frozen base's bits, kept on the host (a copy on the card would
    # add 4 GB to every peak printed below)
    frozen_copy = [l.cpu() for l in tree_leaves(frozen_l)]
    say(f"[setup] lora: {LORA_TRAIN} sequences of {LORA_SEQ_LEN} tokens "
        f"over {LORA_N} clients (by domain), {LORA_SEQS - LORA_TRAIN} eval "
        f"sequences; K={k_l}, n={LORA_TOP_N}, B={LORA_B} "
        f"({k_l * LORA_B * LORA_SEQ_LEN} training tokens a round); "
        f"{time.perf_counter() - t13:.2f} s")

    def eval_lm(p):
        with torch.no_grad():
            return float(tf.lm_loss(p, cfg_l, eval_l))

    def peak_from(held):
        """Peak device memory since the reset, and above what was held
        (``held``: allocated at the reset, earlier phases' tensors too)."""
        peak = torch.cuda.max_memory_allocated()
        return (f"peak {peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} "
                f"GiB above the {held / 2**30:.2f} GiB held before)",
                peak - held)

    def lora_run(fl, rounds=2):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = time.perf_counter()
        p, log = run_training_scan(params_l, loss_l, shards_l, fl,
                                   rounds=rounds, seed=SEED, device=dev)
        torch.cuda.synchronize()
        return (p, log, ops.launch_counts(), time.perf_counter() - t,
                peak_from(held)[0])

    eval0 = eval_lm(params_l)
    lora_counts, lora_t = {}, {}
    for label, fl in lora_fl.items():
        p, log, c, wall, peak = lora_run(fl)
        per = {n_: v_ / 2 for n_, v_ in c.items() if v_}
        lora_counts[label] = c
        tr_p, fz_p = part_l.split(p)
        frozen_same = all(a is b and torch.equal(a.cpu(), c_) for a, b, c_
                          in zip(tree_leaves(fz_p), tree_leaves(frozen_l),
                                 frozen_copy))
        moved = max_diff(tr_p, train_l)
        marks = [0.0] + [u * 1e6 for u in log.uplink_mb]
        deltas = [b - a for a, b in zip(marks, marks[1:])]
        eval_t = eval_lm(p) if label == "vmap" else None
        say(f"[lora {label}] run_training_scan 2 rounds: {wall:.3f} s, "
            f"{peak}; losses {log.losses}"
            + ("" if eval_t is None else
               f"; eval loss {eval0:.4f} -> {eval_t:.4f}")
            + f"; launches a round {per} (want {want_l[label]}); uplink "
            f"{[round(d_, 1) for d_ in deltas]} B a round, "
            f"{log.meter.uplink_bytes:.0f} B in all (want "
            f"{want_up_l[label]:,} a round; full-model FedAvg "
            f"{fedavg_full:,} B, {fedavg_full / want_up_l[label]:.1f}x); "
            f"frozen leaves the start's tensors, unchanged: {frozen_same}; "
            f"adapters moved by up to {moved:.3e}")
        if not all(np.isfinite(log.losses)) or len(log.losses) != 2 or \
                per != want_l[label] or not frozen_same or moved == 0.0 or \
                log.meter.uplink_bytes != 2 * want_up_l[label] or \
                any(abs(d_ - want_up_l[label]) > 0.5 for d_ in deltas):
            fail(f"lora {label}: the fine-tuning run is not as expected")
        del p, tr_p, fz_p
    # the scan round's phase-2 recompute gives phase 1's local, bit for bit
    lu = make_local_update(loss_l, sgd(fl_lv.lr), 1, partition=part_l)
    j0 = torch.arange(LORA_B, device=dev)[None, :]
    batch_k = {n_: v_[0] for n_, v_ in shards_l.gather(
        torch.zeros(1, dtype=torch.int64, device=dev), j0).items()}
    (a1, l1), (a2, l2) = (lu(train_l, batch_k, frozen_l) for _ in range(2))
    same12 = torch.equal(l1, l2) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a1), tree_leaves(a2)))
    say(f"[lora scan] a client's local step twice at the same shapes: "
        f"bit for bit {same12} (the phase-2 recompute equals phase 1)")
    if not same12:
        fail("lora scan: the phase-2 recompute differs from phase 1")
    del a1, a2, frozen_copy
    say(f"[lora] checks in bf16: {time.perf_counter() - t13:.1f} s")
    # round wall-clock and the device's busy share of one round
    from torch.profiler import ProfilerActivity, profile
    for label, fl in lora_fl.items():
        t_round = statistics.median(lora_run(fl, rounds=1)[3] * 1e3
                                    for _ in range(3))
        torch.cuda.synchronize()
        # the card's activity only: tracing every host op of a host-paced
        # round costs minutes and does not change the device's busy time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_training_scan(params_l, loss_l, shards_l, fl, rounds=1,
                              seed=SEED, device=dev)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        lora_t[label] = (t_round, busy, 1.0 - busy / t_round)
        say(f"[lora {label}] timed and profiled: "
            f"{time.perf_counter() - t13:.1f} s")
    del params_l, train_l, frozen_l, shards_l, eval_l, prof
    torch.cuda.empty_cache()
    say(f"[lora] bf16 times: {time.perf_counter() - t13:.1f} s")

    # f32: the round through the kernel against the plain attention under
    # autograd, vmap against scan, remat_blocks against none
    cfg_l32 = dataclasses.replace(cfg_l, param_dtype="float32",
                                  compute_dtype="float32")
    params32, part32 = lora_model(cfg_l32)
    tr32, fz32 = part32.split(params32)
    umap32 = UnitMap.build(tr32)
    fl32 = dataclasses.replace(fl_lv, batch_per_client=LORA_B32,
                               partition=part32)
    rb = data_l.round_batch(np.arange(LORA_K), LORA_B32,
                            np.random.default_rng(SEED))
    batch32 = {n_: torch.from_numpy(v_).to(dev) for n_, v_ in rb.items()}
    sizes32 = torch.from_numpy(data_l.data_sizes()[:LORA_K].astype(
        np.float32)).to(dev)

    def round32(cfg, mode="vmap", plain=False):
        fl = dataclasses.replace(fl32, mode=mode)
        loss = tf.make_lm_loss(
            cfg, flash_attention=kref.flash_attention if plain else None)
        build = build_round_vmap if mode == "vmap" else build_round_scan
        rf = build(loss, umap32, fl)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        new, m = rf(tr32, batch32, sizes32, frozen=fz32)
        torch.cuda.synchronize()
        return (new, m, ops.launch_counts()) + peak_from(held)

    r_k = round32(cfg_l32)
    lora_counts["f32"] = r_k[2]
    checks32 = {"plain attention (autograd)": round32(cfg_l32, plain=True),
                "scan": round32(cfg_l32, mode="scan"),
                "remat_blocks": round32(dataclasses.replace(
                    cfg_l32, remat_blocks=True))}
    if r_k[2]["flash_attention_cuda_core"] != layers_l or \
            r_k[2]["flash_attention"] != layers_l:
        fail(f"lora f32: flash_attention launches {r_k[2]}, expected "
             f"{layers_l} on the CUDA-core route")
    if checks32["plain attention (autograd)"][2]["flash_attention"]:
        fail("lora f32: the plain round launched the kernel")
    say(f"[lora f32] one vmap round through the kernel (B={LORA_B32}): "
        f"selection {r_k[1]['selection'].int().tolist()}, {r_k[3]}")
    for label, (new, m, c, peak, rise) in checks32.items():
        d_div = float((m["divergence"] - r_k[1]["divergence"]).abs().max())
        div_ok = torch.allclose(m["divergence"], r_k[1]["divergence"], **TOL)
        sel_ok = torch.equal(m["selection"], r_k[1]["selection"])
        d_p = max_diff(new, r_k[0])
        say(f"[lora f32] kernel round vs {label}: selection identical "
            f"{sel_ok}; divergence max_abs_diff {d_div:.3e} (within "
            f"rtol={TOL['rtol']}: {div_ok}); adapters max_abs_diff "
            f"{d_p:.3e} (limit {EQUIV_TOL}); {peak}")
        if not (sel_ok and div_ok and d_p <= EQUIV_TOL):
            fail(f"lora f32: the kernel round disagrees with {label}")
        if label == "remat_blocks" and not (
                rise < r_k[4] and c["flash_attention"] == 2 * layers_l):
            fail(f"lora f32: remat_blocks rose {rise} B against "
                 f"{r_k[4]} B without, with {c['flash_attention']} "
                 f"flash_attention launches (want {2 * layers_l}: the "
                 f"forward's and the backward's recompute)")
    del params32, tr32, fz32, r_k, checks32
    torch.cuda.empty_cache()
    say(f"[lora] f32 checks: {time.perf_counter() - t13:.1f} s")

    # FlashAttentionFn at one layer's training shape: gradients against
    # autograd of the plain version, and times beside SDPA's
    flush = torch.empty(64 * 2**20, device=dev)
    b_l, h_l, kvh_l, hd_l = (LORA_K * LORA_B, cfg_l.num_heads,
                             cfg_l.num_kv_heads, cfg_l.hd)
    s_l = LORA_SEQ_LEN
    pairs_l = s_l * (s_l + 1) // 2
    fa_bwd = {}
    for dn, dt, peak_flops in (("f32", torch.float32, F32_FLOPS),
                               ("bf16", torch.bfloat16, BF16_FLOPS)):
        g = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev, dtype=dt)
                       for shape in ((b_l, s_l, h_l, hd_l),
                                     (b_l, s_l, kvh_l, hd_l),
                                     (b_l, s_l, kvh_l, hd_l),
                                     (b_l, s_l, h_l, hd_l)))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = FlashAttentionFn.apply(*leaves, True, 0, None)
        got = torch.autograd.grad(out, leaves, do)
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        out_p = kref.flash_attention(*plain, causal=True)
        want = torch.autograd.grad(out_p, plain, do, retain_graph=True)
        errs = [float((a.float() - b.float()).abs().max())
                / float(b.float().abs().max()) for a, b in zip(got, want)]
        o_d = out.detach()
        fwd_ms, _ = device_ms(lambda: FlashAttentionFn.apply(q, k, v, True,
                                                             0, None))
        bwd_ms, _ = device_ms(lambda: kref.flash_attention_bwd(
            q, k, v, o_d, do, causal=True))
        plain_bwd_ms, _ = device_ms(lambda: torch.autograd.grad(
            out_p, plain, do, retain_graph=True))
        st = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
        do_t = do.transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out_s = sdpa(*st, is_causal=True, enable_gqa=True)
        sdpa_fwd_ms, _ = device_ms(lambda: sdpa(
            *[t.detach() for t in st], is_causal=True, enable_gqa=True))
        sdpa_bwd_ms, _ = device_ms(lambda: torch.autograd.grad(
            out_s, st, do_t, retain_graph=True))
        # least time: read q, k, v, o, dO once, write dq, dk, dv once; five
        # products of 2·hd operations over each visible (query, key) pair
        nbytes = 4 * nb(q) + 4 * nb(k)
        flops = 10 * b_l * h_l * pairs_l * hd_l
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak_flops
        fa_bwd[dn] = {"ms": bwd_ms, "plain_ms": plain_bwd_ms,
                      "bound_ms": max(t_b, t_o) * 1e3,
                      "bound_by": "bytes" if t_b >= t_o else "operations",
                      "library_ms": sdpa_bwd_ms, "fwd_ms": fwd_ms,
                      "sdpa_fwd_ms": sdpa_fwd_ms, "max_rel_err": max(errs)}
        say(f"[lora attention] FlashAttentionFn {dn} at one layer's "
            f"training shape (B*K={b_l}, S={s_l}, {h_l}/{kvh_l} heads, "
            f"hd={hd_l}, causal): dq, dk, dv max_abs_err / max|grad| "
            f"{[f'{e:.3e}' for e in errs]} (limit {FLASH_TOL[dn]}); forward "
            f"(kernel, {flash_attention.route(dt, s_l, hd_l)} route) "
            f"{fwd_ms:.4f} ms, backward (plain ops) {bwd_ms:.4f} ms, bound "
            f"{fa_bwd[dn]['bound_ms']:.4f} ms ({fa_bwd[dn]['bound_by']}), "
            f"autograd of the plain version {plain_bwd_ms:.4f} ms; "
            f"scaled_dot_product_attention (enable_gqa) forward "
            f"{sdpa_fwd_ms:.4f} ms, backward {sdpa_bwd_ms:.4f} ms ({smi})")
        if max(errs) > FLASH_TOL[dn]:
            fail(f"FlashAttentionFn {dn}: gradients differ from autograd of "
                 f"the plain version by {errs}")
        if dn == "f32":
            core_calls = [(q, k, v, {"causal": True, "window": 0})]
        del q, k, v, do, leaves, out, plain, out_p, st, out_s, got, want
    del flush
    core_times(core_calls, f"one LoRA f32 layer's forward (B*K={b_l}, "
               f"S={s_l}, {h_l}/{kvh_l} heads, hd={hd_l}, causal)")
    del core_calls
    # the Function's host cost against the bare launcher at a decode step's
    # shape, in turns (why attend launches directly without grad mode)
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((SERVE_BATCH, 1, h_l, hd_l), generator=g, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((SERVE_BATCH, SERVE_PROMPT + steps, kvh_l, hd_l),
                        generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    enq = {"launcher": lambda: flash_attention.flash_attention(
               q, k, v, causal=False, kv_len=SERVE_PROMPT + 1),
           "FlashAttentionFn.apply": lambda: FlashAttentionFn.apply(
               q, k, v, False, 0, SERVE_PROMPT + 1)}
    enq_us = {n_: [] for n_ in enq}
    with torch.inference_mode():
        for n_ in (0, 1, 1, 0, 0, 1, 1, 0):
            name = list(enq)[n_]
            torch.cuda.synchronize()
            h = time.perf_counter()
            for _ in range(APPLY_CALLS):
                enq[name]()
            enq_us[name].append((time.perf_counter() - h)
                                / APPLY_CALLS * 1e6)
            torch.cuda.synchronize()
    say(f"[lora attention] host enqueue a call at a decode step's shape "
        f"(bf16, kv_len {SERVE_PROMPT + 1}; median of 4 turns of "
        f"{APPLY_CALLS} calls, turns A B B A): " + "; ".join(
            f"{n_} {statistics.median(x):.2f} us "
            f"{[round(y, 2) for y in x]}" for n_, x in enq_us.items())
        + f" ({smi})")
    del q, k, v
    for label, (t_round, busy, idle) in lora_t.items():
        say(f"[times] lora round wall-clock ({label}, median of 3 calls of "
            f"1 round, set-up included): {t_round:.3f} ms; device busy "
            f"under torch.profiler {busy:.3f} ms a round, idle share "
            f"{idle:.4f} ({smi})")
    say(f"[lora] phase 13: {time.perf_counter() - t13:.1f} s")

    # ---- 14. serving the ssm and hybrid families at full width ----------
    say(f"[elapsed] phase 14 starts at {time.perf_counter() - t_start:.1f} s")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.units import tree_stack_index
    from repro_torch.models import ssm as ssm_mod
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    max_len = SERVE_PROMPT + SERVE_STEPS

    def profile_once(fn):
        """fn()'s result, its device busy ms under torch.profiler, its top
        device kernels and the PyTorch ops that launched the most device
        time (each op's own kernels)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kern = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        ops_ = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]

        def top(evs, n, width):
            evs = sorted(evs, key=lambda e: -e.self_device_time_total)[:n]
            return "; ".join(f"{e.key[:width]} "
                             f"{e.self_device_time_total / 1e3:.3f} ms "
                             f"x{e.count}" for e in evs)
        return (out, sum(e.self_device_time_total for e in kern) / 1e3,
                top(kern, 6, 60) + " | by op: " + top(ops_, 8, 40))

    for arch in SSM_ARCHS:
        cfg_bf = get_config(arch)
        cfg32 = dataclasses.replace(cfg_bf, param_dtype="float32",
                                    compute_dtype="float32")
        hybrid = tf.block_kind(cfg_bf) == "hybrid"
        nl = cfg_bf.num_layers
        prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg_bf.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT))).to(dev)

        def serve14(p, cfg, label):
            """The main path (prefill + SERVE_STEPS greedy decode steps),
            the launch counts zeroed just before and read just after: the
            hybrid launches the kernel once a layer a pass, every prefill
            launch on its dtype's prefill route and every decode launch on
            the split-KV route; the ssm kind never."""
            ops.reset_launch_counts()
            run = serve.generate(p, cfg, prompts, steps, keep_logits=True)
            counts = ops.launch_counts()
            want = dict.fromkeys(flash_attention.ROUTES, 0)
            if hybrid:
                want[flash_attention.route(dtype_of(cfg.compute_dtype),
                                           SERVE_PROMPT, cfg.hd)] += nl
                want["decode"] += nl * SERVE_STEPS
            got = {r: counts[f"flash_attention_{r}"] for r in want}
            say(f"[{label}] prefill {run.prefill_s * 1e3:.3f} ms, decode "
                f"{run.decode_s_per_token * 1e3:.3f} ms/token; "
                f"flash_attention launches {counts['flash_attention']}, by "
                f"route {got} (want {want})")
            if counts["flash_attention"] != sum(want.values()) or \
                    got != want:
                fail(f"{label}: flash_attention launches {got}, expected "
                     f"{want}")
            if not all(bool(torch.isfinite(lg).all()) and
                       lg.shape == (SERVE_BATCH, cfg.vocab_size)
                       for lg in run.logits):
                fail(f"{label}: non-finite or mis-shaped logits")
            return run, got

        # f32 (TF32 off), for parity: the kernel path against forward over
        # the same tokens and, for the hybrid, against the plain attention
        t0 = time.perf_counter()
        params = tf.init_params(cfg32, gen_w.manual_seed(SEED), dev)
        torch.cuda.synchronize()
        say(f"[ssm-serve] {arch}: {nl} layers, d={cfg_bf.d_model}, SSD "
            f"d_inner {cfg_bf.ssm_d_inner} in {cfg_bf.ssm_heads} heads of "
            f"{cfg_bf.ssm_head_dim}, state {cfg_bf.ssm_state}, chunk "
            f"{cfg_bf.ssm_chunk}, conv {cfg_bf.ssm_conv_width}"
            + (f", attention {cfg_bf.num_heads} over {cfg_bf.num_kv_heads} "
               f"KV heads at hd {cfg_bf.hd}, d_ff {cfg_bf.d_ff}"
               if hybrid else ", attention-free")
            + f", vocab {cfg_bf.vocab_size}; batch {SERVE_BATCH}, prompt "
            f"{SERVE_PROMPT}, {SERVE_STEPS} decode steps; f32 init "
            f"{time.perf_counter() - t0:.2f} s")
        run32, n32 = serve14(params, cfg32, f"{arch} f32")
        for r in flash_attention.ROUTES:
            launches[r] += n32[r]
        with torch.inference_mode():
            seq = torch.cat([prompts, run32.tokens[:, :SERVE_STEPS]], dim=1)
            full = tf.forward(params, cfg32, seq)[0][:, SERVE_PROMPT - 1:]
            got = torch.stack(run32.logits, dim=1)          # (B, steps, V)
            tol = SERVE_RTOL * float(got.abs().max())
            d_full = float((got - full).abs().max())
            against, d_plain = full, None
            if hybrid:
                # the prefill's calls are kept for the CUDA-core route
                recorded_fa = []
                lg, cache = dec.prefill(params, cfg32, prompts,
                                        max_len=max_len,
                                        flash_attention=recording_fa)
                core_calls = recorded_fa[:]
                plain = [lg]
                for t in range(SERVE_STEPS):
                    lg, cache = dec.decode_step(
                        params, cfg32, run32.tokens[:, t:t + 1], cache,
                        flash_attention=kref.flash_attention)
                    plain.append(lg)
                del cache
                against = torch.stack(plain, dim=1)
                d_plain = float((got - against).abs().max())
            top2 = against.topk(2, dim=-1).values
            gap = top2[..., 0] - top2[..., 1]
            same = against.argmax(dim=-1) == run32.tokens
            bad = (~same & (gap >= tol)).any(dim=0)
        say(f"[ssm-serve {arch} f32] max |logit| {tol / SERVE_RTOL:.4f}; "
            f"prefill + decode vs forward: max_abs_diff {d_full:.3e}"
            + (f"; kernel vs plain attention: max_abs_diff {d_plain:.3e}"
               if hybrid else "")
            + f" (limit {tol:.3e} = {SERVE_RTOL} x max |logit|); greedy "
            f"tokens equal at {int(same.all(dim=0).sum())} of {steps} steps "
            f"(against {'the plain attention' if hybrid else 'forward'}); "
            f"steps with a top-2 gap below the limit: "
            f"{(gap < tol).any(dim=0).nonzero().flatten().tolist()}")
        if d_full > tol or (hybrid and d_plain > tol) or bool(bad.any()):
            fail(f"{arch} f32: the serving path disagrees with forward or "
                 "with the plain attention")
        del full, got, against, top2, gap, same, seq, run32
        if hybrid:
            del plain
            core_times(core_calls, f"one {arch} f32 parity prefill")
            del core_calls, recorded_fa

        # the chunked SSD against its own recurrence, one full-width layer
        ssd_p = tree_stack_index(params["blocks"], 0)["ssm"]
        for s_ in SSD_LENGTHS:
            x = randn((SERVE_BATCH, s_, cfg32.d_model))
            with torch.inference_mode():
                y, c = ssm_mod.ssd_fwd(ssd_p, x, cfg32, return_cache=True)
                st = ssm_mod.init_ssm_cache(cfg32, SERVE_BATCH,
                                            torch.float32, dev)
                ys = []
                for t in range(s_):
                    o, st = ssm_mod.ssd_step(ssd_p, x[:, t:t + 1], st, cfg32)
                    ys.append(o)
                ys = torch.cat(ys, dim=1)
            rel = {n_: float((a_ - b_).abs().max() / b_.abs().max())
                   for n_, a_, b_ in (("y", ys, y),
                                      ("state", st["state"], c["state"]),
                                      ("conv", st["conv"], c["conv"]))}
            say(f"[ssm-serve {arch} ssd] layer 0, (B, S) = ({SERVE_BATCH}, "
                f"{s_}), {-(-s_ // cfg32.ssm_chunk)} chunks: ssd_fwd against "
                f"ssd_step token by token, max_abs_diff / max |ref|: "
                + ", ".join(f"{n_} {v_:.3e}" for n_, v_ in rel.items())
                + f" (limit {SSD_RTOL})")
            if max(rel.values()) > SSD_RTOL:
                fail(f"{arch}: the chunked SSD disagrees with its recurrence "
                     f"at S={s_}: {rel}")
        del params, ssd_p, x, y, c, st, ys
        torch.cuda.empty_cache()

        # bf16, timed
        params = tf.init_params(cfg_bf, gen_w.manual_seed(SEED), dev)
        leaves = tree_leaves(params)
        sizes = (sum(l_.numel() for l_ in leaves),
                 sum(l_.numel() * l_.element_size() for l_ in leaves),
                 len(leaves))
        say(f"[ssm-serve {arch} bf16] params {sizes[0]:,} = {sizes[1]:,} B "
            f"over {sizes[2]} leaves (want {SSM_PARAMS[arch]}; "
            f"cfg.param_count() {cfg_bf.param_count():,})")
        if sizes != SSM_PARAMS[arch]:
            fail(f"{arch}: the parameter tree holds {sizes}, expected "
                 f"{SSM_PARAMS[arch]}")
        serve.generate(params, cfg_bf, prompts[:, :256], 4)        # warm-up
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs = [serve14(params, cfg_bf, f"{arch} bf16 #{i}")
                for i in range(3)]
        peak = torch.cuda.max_memory_allocated()
        for _, n_ in runs:
            for r in flash_attention.ROUTES:
                launches[r] += n_[r]
        pre_ms = statistics.median(r_.prefill_s * 1e3 for r_, _ in runs)
        tok_ms = statistics.median(r_.decode_s_per_token * 1e3
                                   for r_, _ in runs)
        with torch.inference_mode():
            (lg, cache), busy_pre, top_pre = profile_once(
                lambda: dec.prefill(params, cfg_bf, prompts,
                                    max_len=max_len))
            _, busy_dec, top_dec = profile_once(
                lambda: dec.decode_step(params, cfg_bf,
                                        lg.argmax(-1)[:, None], cache))
        cache_b = {n_: t_.numel() * t_.element_size()
                   for n_, t_ in cache.items() if n_ != "pos"}
        say(f"[ssm-serve {arch} bf16] cache at max_len {max_len}: "
            + ", ".join(f"{n_} {tuple(cache[n_].shape)} {cache[n_].dtype} "
                        f"{b_:,} B" for n_, b_ in cache_b.items())
            + f" (want {SSM_CACHE[arch]})")
        if cache_b != SSM_CACHE[arch]:
            fail(f"{arch}: cache sizes {cache_b}, expected "
                 f"{SSM_CACHE[arch]}")
        say(f"[profile] {arch} one bf16 prefill: device busy {busy_pre:.3f} "
            f"ms, idle share {1 - busy_pre / pre_ms:.4f}; top device ops: "
            f"{top_pre}")
        say(f"[profile] {arch} one bf16 decode step: device busy "
            f"{busy_dec:.3f} ms, idle share {1 - busy_dec / tok_ms:.4f}; "
            f"top device ops: {top_dec}")
        if hybrid:
            # the kernel on the main path's own calls against plain, and
            # its time a use at hymba's shapes
            recorded_fa = []
            with torch.inference_mode():
                lg, cache = dec.prefill(params, cfg_bf, prompts,
                                        max_len=max_len,
                                        flash_attention=recording_fa)
                pre_calls = recorded_fa[:]
                dec.decode_step(params, cfg_bf, lg.argmax(-1)[:, None],
                                cache, flash_attention=recording_fa)
                dec_calls = recorded_fa[len(pre_calls):]
                main_path_check(pre_calls, f"{arch} bf16 prefill", "bf16")
                main_path_check(dec_calls, f"{arch} bf16 decode step",
                                "bf16")
            flush = torch.empty(64 * 2**20, device=dev)
            for route, calls, use in (("tc", pre_calls, "prefill"),
                                      ("decode", dec_calls, "decode step")):
                k_ms, p_ms, l_ms, b_ms, b_by, k_host = route_times(
                    calls, BF16_FLOPS)
                say(f"[times] flash_attention [{route} route], one {arch} "
                    f"bf16 {use} ({nl} launches): kernel_ms={k_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={p_ms:.4f} "
                    f"library_ms={l_ms:.4f} host_enqueue_ms={k_host:.4f}")
            del pre_calls, dec_calls, recorded_fa, flush
        say(f"[times] serving {arch} bf16, median of 3: prefill "
            f"{pre_ms:.3f} ms, decode {tok_ms:.3f} ms/token; peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above "
            f"the {held / 2**30:.2f} GiB held, weights "
            f"{sizes[1] / 2**30:.2f} GiB) ({smi})")
        del params, cache, lg, runs, leaves
        torch.cuda.empty_cache()
        say(f"[cli] python -m repro_torch.launch.serve --arch {arch} "
            "--temperature 0:")
        serve.main(["--arch", arch, "--temperature", "0"])
        torch.cuda.empty_cache()
    say(f"[ssm-serve] phase 14: {time.perf_counter() - t14:.1f} s")

    # ---- 15. serving full-width deepseek-moe-16b --------------------------
    say(f"[elapsed] phase 15 starts at {time.perf_counter() - t_start:.1f} s")
    from repro_torch.models import moe as moe_mod
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_moe_loop import moe_loop
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    cfg_bf = get_config(MOE_ARCH)
    nl = cfg_bf.num_layers
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg_bf.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT))).to(dev)

    def serve15(p, cfg, label):
        """The main path (prefill + SERVE_STEPS greedy decode steps), the
        launch counts zeroed just before and read just after: one launch a
        layer a pass, every prefill launch on its dtype's prefill route
        and every decode launch on the split-KV route."""
        ops.reset_launch_counts()
        run = serve.generate(p, cfg, prompts, steps, keep_logits=True)
        counts = ops.launch_counts()
        want = dict.fromkeys(flash_attention.ROUTES, 0)
        want[flash_attention.route(dtype_of(cfg.compute_dtype),
                                   SERVE_PROMPT, cfg.hd)] += cfg.num_layers
        want["decode"] += cfg.num_layers * SERVE_STEPS
        got = {r: counts[f"flash_attention_{r}"] for r in want}
        say(f"[{label}] prefill {run.prefill_s * 1e3:.3f} ms, decode "
            f"{run.decode_s_per_token * 1e3:.3f} ms/token; flash_attention "
            f"launches {counts['flash_attention']}, by route {got} (want "
            f"{want})")
        if counts["flash_attention"] != sum(want.values()) or got != want:
            fail(f"{label}: flash_attention launches {got}, expected {want}")
        if not all(bool(torch.isfinite(lg).all()) and
                   lg.shape == (SERVE_BATCH, cfg.vocab_size)
                   for lg in run.logits):
            fail(f"{label}: non-finite or mis-shaped logits")
        return run, got

    # f32 (TF32 off) at reduced depth, for parity: at a capacity factor
    # under which no call drops a choice, the serving path against forward
    # over the same tokens; at the config's own, prefill against forward
    # over the prompt alone (the same tokens, so the same drops)
    cfg32 = dataclasses.replace(cfg_bf, param_dtype="float32",
                                compute_dtype="float32",
                                num_layers=MOE_F32_LAYERS,
                                capacity_factor=MOE_NO_DROP_CF)
    t0 = time.perf_counter()
    params = tf.init_params(cfg32, gen_w.manual_seed(SEED), dev)
    torch.cuda.synchronize()
    say(f"[moe-serve] {MOE_ARCH}: {nl} layers, d={cfg_bf.d_model}, "
        f"attention {cfg_bf.num_heads} over {cfg_bf.num_kv_heads} KV heads "
        f"at hd {cfg_bf.hd}, {cfg_bf.num_experts} routed experts of "
        f"{cfg_bf.moe_d_ff} (top-{cfg_bf.moe_top_k}) + "
        f"{cfg_bf.num_shared_experts} shared, capacity factor "
        f"{cfg_bf.capacity_factor} (cap "
        f"{moe_mod._capacity(SERVE_BATCH * SERVE_PROMPT, cfg_bf)} a "
        f"prefill, {moe_mod._capacity(SERVE_BATCH, cfg_bf)} a decode "
        f"step), vocab {cfg_bf.vocab_size}; batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT}, {SERVE_STEPS} decode steps; f32 at "
        f"{MOE_F32_LAYERS} layers, init {time.perf_counter() - t0:.2f} s")
    run32, n32 = serve15(params, cfg32, f"{MOE_ARCH} f32 x{MOE_F32_LAYERS} "
                         f"cf {MOE_NO_DROP_CF}")
    for r in flash_attention.ROUTES:
        launches[r] += n32[r]
    with torch.inference_mode():
        seq = torch.cat([prompts, run32.tokens[:, :SERVE_STEPS]], dim=1)
        full = tf.forward(params, cfg32, seq)[0][:, SERVE_PROMPT - 1:]
        got = torch.stack(run32.logits, dim=1)              # (B, steps, V)
        tol = SERVE_RTOL * float(got.abs().max())
        d_full = float((got - full).abs().max())
        top2 = full.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        same = full.argmax(dim=-1) == run32.tokens
        bad = (~same & (gap >= tol)).any(dim=0)
        del seq, full, got, top2
        cfg_own = dataclasses.replace(cfg32,
                                      capacity_factor=cfg_bf.capacity_factor)
        with flash_calls_recorded(MOE_F32_LAYERS) as core_calls:
            lg, cache = dec.prefill(params, cfg_own, prompts,
                                    max_len=max_len)
        del cache
        want_lg = tf.forward(params, cfg_own, prompts)[0][:, -1]
        tol_own = SERVE_RTOL * float(want_lg.abs().max())
        d_own = float((lg - want_lg).abs().max())
        del lg, want_lg
    say(f"[moe-serve f32] max |logit| {tol / SERVE_RTOL:.4f}; cf "
        f"{MOE_NO_DROP_CF}: prefill + decode vs forward max_abs_diff "
        f"{d_full:.3e} (limit {tol:.3e} = {SERVE_RTOL} x max |logit|), "
        f"greedy tokens equal at {int(same.all(dim=0).sum())} of {steps} "
        f"steps, steps with a top-2 gap below the limit: "
        f"{(gap < tol).any(dim=0).nonzero().flatten().tolist()}; cf "
        f"{cfg_bf.capacity_factor}: prefill vs forward over the prompt "
        f"max_abs_diff {d_own:.3e} (limit {tol_own:.3e})")
    if d_full > tol or bool(bad.any()) or d_own > tol_own:
        fail(f"{MOE_ARCH} f32: the serving path disagrees with forward")
    del gap, same, bad, run32
    core_times(core_calls, f"one {MOE_ARCH} f32 prefill at "
               f"{MOE_F32_LAYERS} layers")
    del core_calls

    # moe_fwd against the per-expert loop, one full-width layer, T = B·S
    moe_p = tree_stack_index(params["blocks"], 0)["moe"]
    x = randn((SERVE_BATCH, SERVE_PROMPT, cfg32.d_model))
    for cf in MOE_CFS:
        c = dataclasses.replace(cfg32, capacity_factor=cf)
        with torch.inference_mode():
            out, aux = moe_mod.moe_fwd(moe_p, x, c)
            want, want_aux, dropped = moe_loop(moe_p, x, c)
        rel = float((out - want).abs().max() / want.abs().max())
        d_aux = abs(float(aux) - float(want_aux))
        t_ = SERVE_BATCH * SERVE_PROMPT
        say(f"[moe-serve f32 layer] layer 0, T = {t_}, capacity factor "
            f"{cf} (cap {moe_mod._capacity(t_, c)}): moe_fwd against the "
            f"per-expert loop, max_abs_diff / max |ref| {rel:.3e} (limit "
            f"{MOE_RTOL}), aux {float(aux):.6f} vs {float(want_aux):.6f} "
            f"(diff {d_aux:.3e}, limit {MOE_AUX_TOL}); dropped choices "
            f"{dropped} of {t_ * c.moe_top_k}")
        if rel > MOE_RTOL or d_aux > MOE_AUX_TOL or (cf < 1 and not dropped):
            fail(f"{MOE_ARCH}: moe_fwd disagrees with the per-expert loop "
                 f"at capacity factor {cf}")
    del params, moe_p, x, out, want
    torch.cuda.empty_cache()

    # bf16 at full depth, timed
    t0 = time.perf_counter()
    params = tf.init_params(cfg_bf, gen_w.manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    sizes = (sum(l_.numel() for l_ in leaves),
             sum(l_.numel() * l_.element_size() for l_ in leaves),
             len(leaves))
    say(f"[moe-serve bf16] params {sizes[0]:,} = {sizes[1]:,} B over "
        f"{sizes[2]} leaves (want {MOE_PARAMS}; cfg.param_count() "
        f"{cfg_bf.param_count():,}); init {init_s:.2f} s")
    if sizes != MOE_PARAMS:
        fail(f"{MOE_ARCH}: the parameter tree holds {sizes}, expected "
             f"{MOE_PARAMS}")
    serve.generate(params, cfg_bf, prompts[:, :256], 4)            # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve15(params, cfg_bf, f"{MOE_ARCH} bf16 #{i}")
            for i in range(3)]
    peak = torch.cuda.max_memory_allocated()
    for _, n_ in runs:
        for r in flash_attention.ROUTES:
            launches[r] += n_[r]
    pre_ms = statistics.median(r_.prefill_s * 1e3 for r_, _ in runs)
    tok_ms = statistics.median(r_.decode_s_per_token * 1e3 for r_, _ in runs)
    with torch.inference_mode():
        (lg, cache), busy_pre, top_pre = profile_once(
            lambda: dec.prefill(params, cfg_bf, prompts, max_len=max_len))
        _, busy_dec, top_dec = profile_once(
            lambda: dec.decode_step(params, cfg_bf, lg.argmax(-1)[:, None],
                                    cache))
    cache_b = {n_: t_.numel() * t_.element_size()
               for n_, t_ in cache.items() if n_ != "pos"}
    say(f"[moe-serve bf16] cache at max_len {max_len}: "
        + ", ".join(f"{n_} {tuple(cache[n_].shape)} {cache[n_].dtype} "
                    f"{b_:,} B" for n_, b_ in cache_b.items())
        + f" (want {MOE_CACHE})")
    if cache_b != MOE_CACHE:
        fail(f"{MOE_ARCH}: cache sizes {cache_b}, expected {MOE_CACHE}")
    del cache
    say(f"[profile] {MOE_ARCH} one bf16 prefill: device busy {busy_pre:.3f} "
        f"ms, idle share {1 - busy_pre / pre_ms:.4f}; top device ops: "
        f"{top_pre}")
    say(f"[profile] {MOE_ARCH} one bf16 decode step: device busy "
        f"{busy_dec:.3f} ms, idle share {1 - busy_dec / tok_ms:.4f}; top "
        f"device ops: {top_dec}")

    # the dropped choices a layer of one bf16 prefill: moe_fwd wrapped to
    # count each layer's choices at or past its capacity (device counts,
    # read once after the prefill)
    drops, moe_fwd = [], moe_mod.moe_fwd

    def counting_moe_fwd(p, x, cfg):
        t_ = x.shape[0] * x.shape[1]
        cap = moe_mod._capacity(t_, cfg)
        pos = moe_mod.route(p, x.reshape(t_, -1), cfg, cap)[2]
        drops.append((pos >= cap).sum())
        return moe_fwd(p, x, cfg)

    moe_mod.moe_fwd = counting_moe_fwd
    try:
        with torch.inference_mode():
            dec.prefill(params, cfg_bf, prompts, max_len=max_len)
    finally:
        moe_mod.moe_fwd = moe_fwd
    drops = torch.stack(drops).tolist()
    say(f"[moe-serve bf16] dropped choices a layer in one prefill (cap "
        f"{moe_mod._capacity(SERVE_BATCH * SERVE_PROMPT, cfg_bf)} an "
        f"expert, {SERVE_BATCH * SERVE_PROMPT * cfg_bf.moe_top_k} choices): "
        f"{drops}, {sum(drops)} in all; a decode step drops none (cap "
        f"{moe_mod._capacity(SERVE_BATCH, cfg_bf)} >= {SERVE_BATCH} tokens)")

    # the positions' cumulative sum at the prefill's T·k = 49,152 choices:
    # over the (E, T·k) one-hot along its contiguous axis, as route runs
    # it, and over the (T·k, E) one-hot of the reference's layout
    t_ = SERVE_BATCH * SERVE_PROMPT
    eidx = moe_mod.route(tree_stack_index(params["blocks"], 0)["moe"],
                         randn((t_, cfg_bf.d_model), torch.bfloat16), cfg_bf,
                         moe_mod._capacity(t_, cfg_bf))[1].reshape(-1)
    experts = torch.arange(cfg_bf.num_experts, device=dev)
    by_expert = (eidx[None, :] == experts[:, None]).to(torch.int32)
    by_choice = by_expert.T.contiguous()
    flush = torch.empty(64 * 2**20, device=dev)
    scan_ms = [device_ms(lambda: torch.cumsum(oh, dim=d_, dtype=torch.int32),
                         reps=5)[0]
               for oh, d_ in ((by_expert, 1), (by_choice, 0))]
    say(f"[times] moe positions' cumulative sum, one layer of a bf16 "
        f"prefill: over (E, T*k) = {tuple(by_expert.shape)} along dim 1 "
        f"{scan_ms[0]:.4f} ms (route's), over (T*k, E) along dim 0 "
        f"{scan_ms[1]:.4f} ms; x {nl} layers: {scan_ms[0] * nl:.3f} / "
        f"{scan_ms[1] * nl:.3f} ms a prefill")
    del eidx, experts, by_expert, by_choice, flush

    # the kernel on the main path's own calls against plain, and its time
    # a use at deepseek's shapes
    recorded_fa = []
    with torch.inference_mode():
        lg, cache = dec.prefill(params, cfg_bf, prompts, max_len=max_len,
                                flash_attention=recording_fa)
        pre_calls = recorded_fa[:]
        dec.decode_step(params, cfg_bf, lg.argmax(-1)[:, None], cache,
                        flash_attention=recording_fa)
        dec_calls = recorded_fa[len(pre_calls):]
        main_path_check(pre_calls, f"{MOE_ARCH} bf16 prefill", "bf16")
        main_path_check(dec_calls, f"{MOE_ARCH} bf16 decode step", "bf16")
    del cache, lg
    flush = torch.empty(64 * 2**20, device=dev)
    for route, calls, use in (("tc", pre_calls, "prefill"),
                              ("decode", dec_calls, "decode step")):
        k_ms, p_ms, l_ms, b_ms, b_by, k_host = route_times(calls, BF16_FLOPS)
        say(f"[times] flash_attention [{route} route], one {MOE_ARCH} bf16 "
            f"{use} ({nl} launches): kernel_ms={k_ms:.4f} bound_ms="
            f"{b_ms:.4f} ({b_by}) plain_ms={p_ms:.4f} library_ms="
            f"{l_ms:.4f} host_enqueue_ms={k_host:.4f}")
    del pre_calls, dec_calls, recorded_fa, flush
    say(f"[times] serving {MOE_ARCH} bf16, median of 3: prefill "
        f"{pre_ms:.3f} ms, decode {tok_ms:.3f} ms/token; peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held, weights {sizes[1] / 2**30:.2f} GiB) "
        f"({smi})")
    del params, runs, leaves
    torch.cuda.empty_cache()
    say(f"[cli] python -m repro_torch.launch.serve --arch {MOE_ARCH} "
        "--temperature 0:")
    serve.main(["--arch", MOE_ARCH, "--temperature", "0"])
    torch.cuda.empty_cache()
    say(f"[moe-serve] phase 15: {time.perf_counter() - t15:.1f} s")

    # ---- 16. serving full-width seamless-m4t-large-v2 (enc-dec) -----------
    say(f"[elapsed] phase 16 starts at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    cfg_bf = get_config(ENCDEC_ARCH)
    cfg32 = dataclasses.replace(cfg_bf, param_dtype="float32",
                                compute_dtype="float32")
    nl, nl_enc = cfg_bf.num_layers, cfg_bf.encoder_layers
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg_bf.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT))).to(dev)
    frames = torch.from_numpy(rng.standard_normal(
        (SERVE_BATCH, SERVE_PROMPT, cfg_bf.frontend_dim),
        dtype=np.float32)).to(dev)

    def serve16(p, cfg, label):
        """The main path (prefill + SERVE_STEPS greedy decode steps), the
        launch counts zeroed just before and read just after: a prefill
        launches the kernel once an encoder layer and twice a decoder layer
        (self, cross), all on its dtype's prefill route; a decode step
        twice a decoder layer, on the split-KV route."""
        fr = frames.to(dtype_of(cfg.compute_dtype))   # the run's dtype
        ops.reset_launch_counts()
        run = serve.generate(p, cfg, prompts, steps, keep_logits=True,
                             enc_inputs=fr)
        counts = ops.launch_counts()
        want = dict.fromkeys(flash_attention.ROUTES, 0)
        want[flash_attention.route(dtype_of(cfg.compute_dtype),
                                   SERVE_PROMPT, cfg.hd)] += nl_enc + 2 * nl
        want["decode"] += 2 * nl * SERVE_STEPS
        got = {r: counts[f"flash_attention_{r}"] for r in want}
        say(f"[{label}] prefill {run.prefill_s * 1e3:.3f} ms, decode "
            f"{run.decode_s_per_token * 1e3:.3f} ms/token; flash_attention "
            f"launches {counts['flash_attention']}, by route {got} (want "
            f"{want})")
        if counts["flash_attention"] != sum(want.values()) or got != want:
            fail(f"{label}: flash_attention launches {got}, expected {want}")
        if not all(bool(torch.isfinite(lg).all()) and
                   lg.shape == (SERVE_BATCH, cfg.vocab_size)
                   for lg in run.logits):
            fail(f"{label}: non-finite or mis-shaped logits")
        return run, got

    # f32 (TF32 off) at full depth, for parity: the kernel path against
    # forward over the same tokens and frames and against the same steps
    # through the plain attention; decode must leave the cross K/V as the
    # prefill wrote them
    t0 = time.perf_counter()
    params = tf.init_params(cfg32, gen_w.manual_seed(SEED), dev)
    torch.cuda.synchronize()
    say(f"[encdec-serve] {ENCDEC_ARCH}: {nl_enc} encoder + {nl} decoder "
        f"layers, d={cfg_bf.d_model}, attention {cfg_bf.num_heads} over "
        f"{cfg_bf.num_kv_heads} KV heads at hd {cfg_bf.hd}, d_ff "
        f"{cfg_bf.d_ff}, frontend_dim {cfg_bf.frontend_dim}, vocab "
        f"{cfg_bf.vocab_size}; batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"{SERVE_PROMPT} frames, {SERVE_STEPS} decode steps; f32 init "
        f"{time.perf_counter() - t0:.2f} s")
    run32, n32 = serve16(params, cfg32, f"{ENCDEC_ARCH} f32")
    for r in flash_attention.ROUTES:
        launches[r] += n32[r]
    with torch.inference_mode():
        lg, cache = dec.prefill(params, cfg32, prompts, frames,
                                max_len=max_len)
        cross0 = (cache["cross_k"].clone(), cache["cross_v"].clone())
        for t in range(SERVE_STEPS):
            lg, cache = dec.decode_step(params, cfg32,
                                        run32.tokens[:, t:t + 1], cache)
        same_cross = (torch.equal(cache["cross_k"], cross0[0])
                      and torch.equal(cache["cross_v"], cross0[1]))
        del cache, cross0
        # the prefill's calls are kept for the CUDA-core route
        recorded_fa = []
        lg, cache = dec.prefill(params, cfg32, prompts, frames,
                                max_len=max_len,
                                flash_attention=recording_fa)
        core_calls = recorded_fa[:]
        plain = [lg]
        for t in range(SERVE_STEPS):
            lg, cache = dec.decode_step(params, cfg32,
                                        run32.tokens[:, t:t + 1], cache,
                                        flash_attention=kref.flash_attention)
            plain.append(lg)
        del cache
        plain = torch.stack(plain, dim=1)                   # (B, steps, V)
        got = torch.stack(run32.logits, dim=1)
        d_plain = float((got - plain).abs().max())
        seq = torch.cat([prompts, run32.tokens[:, :SERVE_STEPS]], dim=1)
        full = tf.forward(params, cfg32, seq, frames)[0][:, SERVE_PROMPT - 1:]
        tol = SERVE_RTOL * float(got.abs().max())
        d_full = float((got - full).abs().max())
        del full
        top2 = plain.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        same = plain.argmax(dim=-1) == run32.tokens
        bad = (~same & (gap >= tol)).any(dim=0)
    say(f"[encdec-serve f32] max |logit| {tol / SERVE_RTOL:.4f}; prefill + "
        f"decode vs forward: max_abs_diff {d_full:.3e}; kernel vs plain "
        f"attention: max_abs_diff {d_plain:.3e} (limit {tol:.3e} = "
        f"{SERVE_RTOL} x max |logit|); greedy tokens equal at "
        f"{int(same.all(dim=0).sum())} of {steps} steps (against the plain "
        f"attention); steps with a top-2 gap below the limit: "
        f"{(gap < tol).any(dim=0).nonzero().flatten().tolist()}; cross K/V "
        f"after {SERVE_STEPS} decode steps bit for bit as the prefill wrote "
        f"them: {same_cross}")
    if d_full > tol or d_plain > tol or bool(bad.any()) or not same_cross:
        fail(f"{ENCDEC_ARCH} f32: the serving path disagrees with forward or "
             "with the plain attention, or decode wrote the cross K/V")
    del params, plain, got, top2, gap, same, bad, seq, run32
    for use, calls in (("encoder", core_calls[:nl_enc]),
                       ("decoder self", core_calls[nl_enc::2]),
                       ("cross", core_calls[nl_enc + 1::2])):
        core_times(calls, f"{ENCDEC_ARCH} f32 {use}, one pass")
    del core_calls, recorded_fa, calls
    torch.cuda.empty_cache()

    # bf16 at full depth, timed
    t0 = time.perf_counter()
    params = tf.init_params(cfg_bf, gen_w.manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    sizes = (sum(l_.numel() for l_ in leaves),
             sum(l_.numel() * l_.element_size() for l_ in leaves),
             len(leaves))
    say(f"[encdec-serve bf16] params {sizes[0]:,} = {sizes[1]:,} B over "
        f"{sizes[2]} leaves (want {ENCDEC_PARAMS}; cfg.param_count() "
        f"{cfg_bf.param_count():,}); init {init_s:.2f} s")
    if sizes != ENCDEC_PARAMS:
        fail(f"{ENCDEC_ARCH}: the parameter tree holds {sizes}, expected "
             f"{ENCDEC_PARAMS}")
    frames_bf = frames.bfloat16()       # bf16 frames for the bf16 model
    serve.generate(params, cfg_bf, prompts[:, :256], 4,
                   enc_inputs=frames_bf[:, :256])                   # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve16(params, cfg_bf, f"{ENCDEC_ARCH} bf16 #{i}")
            for i in range(3)]
    peak = torch.cuda.max_memory_allocated()
    for _, n_ in runs:
        for r in flash_attention.ROUTES:
            launches[r] += n_[r]
    pre_ms = statistics.median(r_.prefill_s * 1e3 for r_, _ in runs)
    tok_ms = statistics.median(r_.decode_s_per_token * 1e3 for r_, _ in runs)
    with torch.inference_mode():
        (lg, cache), busy_pre, top_pre = profile_once(
            lambda: dec.prefill(params, cfg_bf, prompts, frames_bf,
                                max_len=max_len))
        _, busy_dec, top_dec = profile_once(
            lambda: dec.decode_step(params, cfg_bf, lg.argmax(-1)[:, None],
                                    cache))
    cache_b = {n_: t_.numel() * t_.element_size()
               for n_, t_ in cache.items() if n_ != "pos"}
    say(f"[encdec-serve bf16] cache at max_len {max_len}, {SERVE_PROMPT} "
        f"frames: " + ", ".join(f"{n_} {tuple(cache[n_].shape)} "
                                f"{cache[n_].dtype} {b_:,} B"
                                for n_, b_ in cache_b.items())
        + f" (want {ENCDEC_CACHE})")
    if cache_b != ENCDEC_CACHE:
        fail(f"{ENCDEC_ARCH}: cache sizes {cache_b}, expected "
             f"{ENCDEC_CACHE}")
    del cache
    say(f"[profile] {ENCDEC_ARCH} one bf16 prefill: device busy "
        f"{busy_pre:.3f} ms, idle share {1 - busy_pre / pre_ms:.4f}; top "
        f"device ops: {top_pre}")
    say(f"[profile] {ENCDEC_ARCH} one bf16 decode step: device busy "
        f"{busy_dec:.3f} ms, idle share {1 - busy_dec / tok_ms:.4f}; top "
        f"device ops: {top_dec}")

    # the kernel on the main path's own calls against plain, and its time
    # a use at seamless's shapes: the prefill's calls are the encoder's
    # (one a layer), then a decoder layer's self and cross in turn; a
    # decode step's, a layer's self and cross in turn
    recorded_fa = []
    with torch.inference_mode():
        lg, cache = dec.prefill(params, cfg_bf, prompts, frames_bf,
                                max_len=max_len, flash_attention=recording_fa)
        pre_calls = recorded_fa[:]
        dec.decode_step(params, cfg_bf, lg.argmax(-1)[:, None], cache,
                        flash_attention=recording_fa)
        dec_calls = recorded_fa[len(pre_calls):]
        uses = (("tc", "encoder", pre_calls[:nl_enc]),
                ("tc", "decoder self", pre_calls[nl_enc::2]),
                ("tc", "cross", pre_calls[nl_enc + 1::2]),
                ("decode", "decode-step self", dec_calls[0::2]),
                ("decode", "decode-step cross", dec_calls[1::2]))
        for _, use, calls in uses:
            main_path_check(calls, f"{ENCDEC_ARCH} bf16 {use}", "bf16")
    del cache, lg
    flush = torch.empty(64 * 2**20, device=dev)
    for route, use, calls in uses:
        k_ms, p_ms, l_ms, b_ms, b_by, k_host = route_times(calls, BF16_FLOPS)
        say(f"[times] flash_attention [{route} route], {ENCDEC_ARCH} bf16 "
            f"{use}, one pass ({len(calls)} launches): kernel_ms={k_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={p_ms:.4f} library_ms="
            f"{l_ms:.4f} host_enqueue_ms={k_host:.4f}")
    del pre_calls, dec_calls, recorded_fa, uses, flush
    say(f"[times] serving {ENCDEC_ARCH} bf16, median of 3: prefill "
        f"{pre_ms:.3f} ms, decode {tok_ms:.3f} ms/token; peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held, weights {sizes[1] / 2**30:.2f} GiB) "
        f"({smi})")
    del params, runs, leaves, frames
    torch.cuda.empty_cache()
    say(f"[cli] python -m repro_torch.launch.serve --arch {ENCDEC_ARCH} "
        "--temperature 0:")
    serve.main(["--arch", ENCDEC_ARCH, "--temperature", "0"])
    torch.cuda.empty_cache()
    say(f"[encdec-serve] phase 16: {time.perf_counter() - t16:.1f} s")

    # ---- 17. round telemetry at the paper's setup ------------------------
    say(f"[elapsed] phase 17 starts at {time.perf_counter() - t_start:.1f} s")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import monitor
    from repro_torch.launch import train as train_cli
    from repro_torch.telemetry import TelemetryConfig, read_ledger, split_runs
    from repro_torch.telemetry import taps as taps_mod
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    tdir = Path(tempfile.mkdtemp(prefix="chip_smoke_telemetry_"))
    atexit.register(shutil.rmtree, tdir, True)   # also when a check fails
    shards = ClientShards.from_federated(data_e).to(dev)
    ledger17 = str(tdir / "ledger.jsonl")
    n_units = umap.num_units
    counts_17 = {}

    def add_counts(counts):
        for n_, c in counts.items():
            counts_17[n_] = counts_17.get(n_, 0) + c

    def tele_cfg(fl, run_id, **kw):
        return dataclasses.replace(fl, telemetry=TelemetryConfig(
            ledger_path=ledger17, run_id=run_id, **kw))

    def cuda_kernels(path):
        """{kernel name: events} of the CUDA kernels in a Chrome trace."""
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        out = {}
        for e in events:
            if e.get("cat") == "kernel":
                out[e["name"]] = out.get(e["name"], 0) + 1
        return out

    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        say(f"[telemetry] {what}: {laps[-1] - laps[-2]:.1f} s")

    def close17(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(close17(x[k], y[k])
                                                 for k in x)
        return bool(np.allclose(x, y, rtol=EQUIV_TOL, atol=0))

    def busy_ms(fn):
        """Device busy ms of ``fn()`` under torch.profiler (the card's
        activity only: the host's ops would add nothing to the sum)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    tel = {}
    for label, fl in (("vmap", fl_v), ("A", fl_a)):
        r = ENGINE_ROUNDS
        want_b = bytes_a_round(fl)
        pdir = tdir / f"trace_{label}"
        fl_on = tele_cfg(fl, f"engine/{label}", profile_rounds=(1, 2),
                         profile_dir=str(pdir))
        # 1. the zero-cost path: telemetry on against off, engine
        (p_off, log_off), _, _ = run_engine(fl, r, eval_fn=eval_fn,
                                            eval_every=2)
        (p_on, log_on), c_on, wall_on = run_engine(fl_on, r,
                                                   eval_fn=eval_fn,
                                                   eval_every=2)
        add_counts(c_on)
        d_on = max_diff(p_on, p_off)
        same = d_on == 0.0 and log_on.losses == log_off.losses
        lim = 0.0
        if not same:      # phase 11's rule: 2e-5 only if runs already differ
            (p_2, log_2), _, _ = run_engine(fl, r, eval_fn=eval_fn,
                                            eval_every=2)
            if max_diff(p_2, p_off) != 0.0 or log_2.losses != log_off.losses:
                lim = EQUIV_TOL
            del p_2
        want_l = per_round(counts_v if label == "vmap" else counts_a, ROUNDS)
        say(f"[telemetry {label}] run_training_scan {r} rounds, eval_every=2,"
            f" telemetry on (ledger, taps, full selection, profile_rounds=(1,"
            f" 2)): {wall_on:.3f} s; against telemetry=None: params "
            f"max_abs_diff {d_on:.3e}, losses equal "
            f"{log_on.losses == log_off.losses}, bit for bit {same} (limit "
            f"{lim}); launches a round {per_round(c_on, r)} (phases 4-7: "
            f"{want_l})")
        if d_on > lim or (lim == 0.0 and not same):
            fail(f"telemetry {label}: telemetry on changed the engine's "
                 f"trajectory by {d_on:.3e} (limit {lim})")
        if per_round(c_on, r) != want_l:
            fail(f"telemetry {label}: launches a round {per_round(c_on, r)}, "
                 f"expected {want_l}")
        # 2. the host driver with the engine's streams, same telemetry
        fl_h = tele_cfg(fl, f"host/{label}")
        (p_h, log_h), c_h, _ = run_host(fl_h, r, "device", eval_fn=eval_fn,
                                        eval_every=2)
        add_counts(c_h)
        d_h = max_diff(p_h, p_on)
        if d_h > lim or (lim == 0.0 and log_h.losses != log_on.losses):
            fail(f"telemetry {label}: run_training(sampler='device') differs "
                 f"from the engine by {d_h:.3e} (limit {lim})")
        del p_off, p_on, p_h
        # 3. the trace window: exactly rounds 1-2 (block [1, 3))
        traces = sorted(os.listdir(pdir)) if pdir.is_dir() else []
        if traces != ["rounds_1-2.json"]:
            fail(f"telemetry {label}: trace files {traces}, expected "
                 f"['rounds_1-2.json']")
        kern = cuda_kernels(pdir / traces[0])
        want_k = {"sqdiff_partials": 2, "sqdiff_units": 2}
        if label == "A":
            want_k["fused_uplink_ef_leaves"] = 2
        got_k = {n_: sum(c for k_, c in kern.items() if n_ in k_) for n_ in
                 ("sqdiff_partials", "sqdiff_units",
                  "fused_uplink_ef_leaves", "fused_uplink_leaves",
                  "masked_accumulate_leaves")}
        say(f"[telemetry {label}] trace {traces[0]} "
            f"({os.path.getsize(pdir / traces[0]) / 1e6:.1f} MB): FL kernels "
            f"{got_k}; {sum(kern.values())} kernel events of "
            f"{len(kern)} names in all")
        if {n_: c for n_, c in got_k.items() if c} != want_k:
            fail(f"telemetry {label}: the trace of rounds 1-2 holds {got_k}, "
                 f"expected {want_k}; its most frequent kernels: "
                 f"{sorted(kern.items(), key=lambda kv: -kv[1])[:8]}")
        lap(f"{label}: zero-cost path, host driver, trace")
        tel[label] = {"want_b": want_b, "lim": lim}

    # 4. the ledger, every round of every run
    segs = split_runs(read_ledger(ledger17))
    by_id = {s_["meta"]["run_id"]: s_ for s_ in segs}
    if sorted(by_id) != ["engine/A", "engine/vmap", "host/A", "host/vmap"]:
        fail(f"telemetry: ledger segments {sorted(by_id)}")
    peak_now = torch.cuda.max_memory_allocated()
    with open(ledger17) as f:
        lines = f.read().splitlines()
    round_bytes = [len(l_) + 1 for l_ in lines if '"kind": "round"' in l_]
    for label in ("vmap", "A"):
        eng_s, host_s = by_id[f"engine/{label}"], by_id[f"host/{label}"]
        want_b = tel[label]["want_b"]
        for seg in (eng_s, host_s):
            recs = seg["rounds"]
            if [x["round"] for x in recs] != list(range(ENGINE_ROUNDS)) or \
                    [x["round"] for x in seg["evals"]] != [0, 2, 3]:
                fail(f"telemetry {label}: ledger rounds "
                     f"{[x['round'] for x in recs]}, evals "
                     f"{[x['round'] for x in seg['evals']]}")
            for x in recs:
                taps_x = x["taps"]
                cols = np.asarray(x["selection"]).sum(axis=0).tolist()
                problems = []
                if taps_x["sel_count"] != [float(fl_v.top_n)] * n_units:
                    problems.append(f"sel_count {taps_x['sel_count']}")
                if cols != taps_x["sel_count"]:
                    problems.append(f"selection column sums {cols}")
                if x["comm"]["uplink_total"] != want_b:
                    problems.append(f"uplink {x['comm']['uplink_total']}")
                if label == "A" and not (
                        "wire_bits" in taps_x and "wire_unit_bytes" in taps_x
                        and math.isfinite(taps_x.get("state_residual_norm",
                                                     math.nan))):
                    problems.append(f"taps {sorted(taps_x)}")
                if not x["wall_s"] > 0 or x["mem_peak_bytes"] is None or \
                        x["mem_peak_bytes"] > peak_now:
                    problems.append(f"wall_s {x['wall_s']} mem_peak_bytes "
                                    f"{x['mem_peak_bytes']} (max allocated "
                                    f"{peak_now})")
                if problems:
                    fail(f"telemetry {label} {seg['meta']['driver']} round "
                         f"{x['round']}: {'; '.join(problems)}")
        # the host driver's records equal the engine's, field by field
        # (loss and taps within 2e-5 only where phase 11's rule allows)
        for a, b in zip(eng_s["rounds"], host_s["rounds"]):
            for key in ("loss", "comm", "uplink_cum_bytes", "taps",
                        "selection"):
                if a[key] != b[key] and not (
                        tel[label]["lim"] > 0 and key in ("loss", "taps")
                        and close17(a[key], b[key])):
                    fail(f"telemetry {label} round {a['round']}: the host "
                         f"driver's {key} differs from the engine's")
        x0 = eng_s["rounds"][0]
        say(f"[telemetry {label}] ledger: {ENGINE_ROUNDS} round records a run"
            f" in both drivers, equal field by field (loss, comm, taps, "
            f"selection, uplink); sel_count {x0['taps']['sel_count'][:3]}... "
            f"in every round, selection column sums equal; uplink "
            f"{x0['comm']['uplink_total']:.0f} B a round, exact (want "
            f"{want_b}); taps {sorted(x0['taps'])}; wall_s "
            f"{[round(x['wall_s'], 4) for x in eng_s['rounds']]}; "
            f"mem_peak_bytes {x0['mem_peak_bytes']} <= {peak_now}"
            + (f"; state_residual_norm "
               f"{[x['taps']['state_residual_norm'] for x in eng_s['rounds']]}"
               if label == "A" else ""))

    # 5. the taps of one round against the plain Eq. 3 reduction
    lap("ledger checks")
    rd17 = KeyedDraws(SEED + 17)(0)
    cl17 = rd17.clients(fl_v.num_clients, fl_v.clients_per_round).long()
    j17 = rd17.indices(shards.part_sizes.cpu()[cl17], fl_v.batch_per_client)
    idx17 = cl17.to(dev)
    batch17 = shards.gather(idx17, j17.to(dev))
    sizes17 = shards.data_sizes()[idx17]
    locals17, _ = torch.func.vmap(
        make_local_update(loss_fn, sgd(fl_v.lr), fl_v.local_steps),
        in_dims=(None, 0))(params0, batch17)
    divs_p = umap.divergence(locals17, params0,
                             sqdiff_rowsum=kref.sqdiff_rowsum)
    del locals17
    taps_ms, taps_host_ms = {}, {}
    for label, fl in (("vmap", fl_v), ("A", fl_a)):
        fl_t = dataclasses.replace(fl, telemetry=TelemetryConfig())
        strat = make_strategy(fl_t)
        st = strat.init_state(params0, fl.num_clients)
        view = fl_server._state_round_view(st, idx17)
        _, m17 = build_round_vmap(loss_fn, umap, fl_t)(
            params0, batch17, sizes17, view)
        tp17 = m17["taps"]
        compare(f"telemetry {label} taps div_mean vs plain Eq. 3",
                tp17["div_mean"], divs_p.mean(0))
        compare(f"telemetry {label} taps div_max vs plain Eq. 3",
                tp17["div_max"], divs_p.amax(0))
        if not torch.equal(tp17["sel_count"], m17["selection"].sum(0)):
            fail(f"telemetry {label}: sel_count is not the selection's sum")
        extra = None
        if label == "A":
            rows = m17["state"]["client"]["residual"]
            want_n = math.sqrt(sum(float((l_.double() ** 2).sum())
                                   for l_ in tree_leaves(rows)))
            compare("telemetry A taps state_residual_norm vs float64",
                    tp17["state_residual_norm"].reshape(1),
                    torch.tensor([want_n], device=dev))
            extra = {"wire_unit_bytes": m17["wire"]["unit_bytes"],
                     "wire_bits": m17["wire"]["bits"]}
        # the largest of 3 profiles of 20 calls: the profiler now and then
        # drops kernel records (even all of a short profile), which only
        # lowers a sum
        reps = 20

        def taps20(strat=strat, m17=m17, extra=extra):
            return [taps_mod.collect(strat, m17.get("state"),
                                     m17["selection"], m17["divergence"],
                                     umap, extra=extra) for _ in range(reps)]

        taps_ms[label] = max(busy_ms(taps20) / reps for _ in range(3))
        # and their host enqueue: the same calls without a sync, median of 3
        enq_taps = []
        for _ in range(3):
            torch.cuda.synchronize()
            h = time.perf_counter()
            taps20()
            enq_taps.append((time.perf_counter() - h) / reps * 1e3)
        taps_host_ms[label] = statistics.median(enq_taps)
        del m17, tp17, view, st
    if failures:
        fail(f"telemetry taps disagree with plain: {failures}")

    # 6. no host sync in a telemetry-on block, one copy a block; then
    # 2-round blocks with telemetry off and on, in turns: wall-clock
    # (enqueue to pull) and host enqueue; device busy of a 1-round block
    # under the profiler (a round is 40,000 kernels: the profiler's
    # parsing, not the card, takes seconds a round)
    lap("taps against plain")
    # the time the host spends in Python's garbage collector, a block
    gc_s, gc_t0 = [0.0], [0.0]

    def gc_clock(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(gc_clock)
    host_sizes17, all_sizes17 = shards.part_sizes.cpu(), shards.data_sizes()
    draws17 = KeyedDraws(SEED)
    blk = {}
    for label, fl in (("vmap", fl_v), ("A", fl_a)):
        runs = {False: block_fn(loss_fn, umap, fl),
                True: block_fn(loss_fn, umap, dataclasses.replace(
                    fl, telemetry=TelemetryConfig()))}

        def fresh17(fl=fl):
            return (params0, make_strategy(fl).init_state(
                params0, fl.num_clients), comm_acc_init(dev))

        c17 = fresh17()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, per17 = runs[True](c17, shards, all_sizes17, host_sizes17,
                                  draws17, 0, 2)
        except RuntimeError as e:
            fail(f"telemetry {label}: a block synchronised the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host17, copies = fl_server._pull(per17)
        nbytes = sum(t_.numel() * t_.element_size()
                     for t_ in tree_leaves(host17))
        if copies != 1 or not all(bool(torch.isfinite(t_).all())
                                  for t_ in tree_leaves(host17)):
            fail(f"telemetry {label}: the block came back in {copies} "
                 f"copies")
        del c17, per17, host17
        times = {False: [], True: []}
        for on in (False, True, True, False, False, True):
            c17 = fresh17()
            torch.cuda.synchronize()
            g0 = gc_s[0]
            h = time.perf_counter()
            c17, per17 = runs[on](c17, shards, all_sizes17, host_sizes17,
                                  draws17, 0, 2)
            enq_s = time.perf_counter() - h
            fl_server._pull(per17)
            times[on].append((enq_s / 2 * 1e3,
                              (time.perf_counter() - h) / 2 * 1e3,
                              (gc_s[0] - g0) / 2 * 1e3))
            del c17, per17
        busy = {on: busy_ms(lambda on=on: runs[on](
            fresh17(), shards, all_sizes17, host_sizes17, draws17, 0, 1))
            for on in (False, True)}
        blk[label] = {on: (statistics.median(x[0] for x in times[on]),
                           statistics.median(x[1] for x in times[on]),
                           busy[on], [round(x[1], 1) for x in times[on]],
                           statistics.median(x[2] for x in times[on]))
                      for on in (False, True)}
        say(f"[telemetry {label}] a telemetry-on 2-round block under "
            f"set_sync_debug_mode('error'): 0 syncs while it enqueued; then "
            f"{copies} device->host copy of {nbytes} B (losses, uplink, "
            f"comm, taps, selection); off: 1 copy of 16 B")
    gc.callbacks.remove(gc_clock)
    lap("blocks")

    # 7. the monitor over the phase's ledger
    buf = io.StringIO()
    n_segs = monitor.render(ledger17, out=buf, bins=40)
    text = buf.getvalue()
    if n_segs != 4 or "per-layer mean divergence" not in text or \
            "per-layer uploads" not in text or \
            "state_residual_norm" not in text:
        fail(f"telemetry: the monitor rendered {n_segs} segments:\n{text}")
    say(f"[monitor] {n_segs} segments; the first lines:")
    for l_ in text.splitlines()[:14]:
        say(f"[monitor] {l_}")

    # 8. times
    lap("monitor")
    bytes_round = statistics.mean(round_bytes)
    for label in ("vmap", "A"):
        (e_off, w_off, b_off, raw_off, gc_off), \
            (e_on, w_on, b_on, raw_on, gc_on) = (blk[label][False],
                                                 blk[label][True])
        say(f"[times] telemetry {label} (engine, 2-round blocks, median of 3,"
            f" off and on in turns): round wall-clock off {w_off:.3f} ms "
            f"{raw_off}, on {w_on:.3f} ms {raw_on} "
            f"({(w_on / w_off - 1) * 100:+.2f} %); in the garbage collector "
            f"off {gc_off:.3f}, on {gc_on:.3f} ms a round; host enqueue "
            f"off {e_off:.3f} ms, on {e_on:.3f} ms a round; device busy (a "
            f"1-round block) off {b_off:.3f} ms, on {b_on:.3f} ms, idle "
            f"share off "
            f"{1 - b_off / w_off:.4f}, on {1 - b_on / w_on:.4f}; the taps' "
            f"own device time {taps_ms[label]:.4f} ms a round "
            f"(torch.profiler, the largest of 3 profiles of 20 calls) and "
            f"host enqueue {taps_host_ms[label]:.4f} ms a round (median of "
            f"3 x 20 calls) ({smi})")
    say(f"[times] telemetry ledger: {len(round_bytes)} round records, "
        f"{bytes_round:.0f} B a round on average (the (20, 9) selection, "
        f"9 x 3 tap floats, comm); the file {os.path.getsize(ledger17)} B")

    # 9. the launcher at the paper's scale
    out = io.StringIO()
    t_cli = time.perf_counter()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        train_cli.main(["--task", "cifar", "--paper-scale", "--rounds", "2",
                        "--eval-every", "1"])
    add_counts(ops.launch_counts())
    t_cli = time.perf_counter() - t_cli
    for l_ in out.getvalue().splitlines():
        say(f"[cli] {l_}")
    summary = [l_ for l_ in out.getvalue().splitlines()
               if l_.startswith("comm summary: ")]
    summary = ast.literal_eval(summary[-1][len("comm summary: "):]) \
        if summary else {}
    say(f"[cli] python -m repro_torch.launch.train --task cifar --paper-scale"
        f" --rounds 2 --eval-every 1: {t_cli:.1f} s (data set-up included); "
        f"uplink {summary.get('uplink_MB')} MB, expected exactly "
        f"{2 * per_round_up / 1e6} MB (2 fedldf rounds)")
    if summary.get("rounds") != 2 or \
            summary.get("uplink_MB") != 2 * per_round_up / 1e6:
        fail(f"launcher: comm summary {summary}")
    lap("launcher")
    del shards, test_batch
    torch.cuda.empty_cache()
    say(f"[telemetry] phase 17: {time.perf_counter() - t17:.1f} s; launches "
        f"on its path {counts_17}")

    # ---- 18. the client mesh at the paper's setup -----------------------
    say(f"[elapsed] phase 18 starts at {time.perf_counter() - t_start:.1f} s")
    counts_18 = phase18({"dev": dev, "smi": smi, "params0": params0,
                         "data_e": data_e, "umap": umap, "fl_v": fl_v,
                         "fl_a": fl_a, "loss_fn": loss_fn,
                         "per_round_up": per_round_up,
                         "want_uplink_a": WANT_UPLINK[8]})
    del data_e, train_e

    # ---- 19. the dry-run's counts of the prefill and the round ----------
    say(f"[elapsed] phase 19 starts at {time.perf_counter() - t_start:.1f} s")
    phase19({**serve_19, "smi": smi, "vgg_cfg": vgg9.config(),
             "fl_v": fl_v, "vgg_arg_bytes": vgg_arg_bytes, "rv_ms": rv_ms})

    # ---- 20. the examples, and serve_llm's path at full width -----------
    say(f"[elapsed] phase 20 starts at {time.perf_counter() - t_start:.1f} s")
    counts_20 = phase20({"dev": dev, "smi": smi,
                         "main_path_check": main_path_check,
                         "core_times": core_times})

    kernels = [
        {"name": "sqdiff_rowsum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/divergence.cu",
         "replaces": "src/repro/kernels/divergence.py:27",
         "launches": sum(c.get("sqdiff_rowsum", 0)
                         for c in (counts_v, counts_s, counts_a, counts_b,
                                   *lora_counts.values(), counts_17,
                                   counts_18, counts_20)),
         "max_abs_err": main_err["sqdiff_rowsum"], "ms": sq_ms,
         "plain_ms": sq_plain, "bound_ms": sq_bound_v, "bound_by": sq_by,
         "library_ms": None},
        {"name": "masked_accumulate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:25",
         "launches": (counts_v["masked_accumulate"]
                      + counts_s["masked_accumulate"]
                      + lora_counts["scan"]["masked_accumulate"]
                      + counts_20["masked_accumulate"]),
         "max_abs_err": main_err["masked_accumulate"], "ms": ma_ms,
         "plain_ms": ma_plain, "bound_ms": ma_bound, "bound_by": ma_by,
         "library_ms": ma_lib},
        {"name": "fused_uplink", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/uplink.cu",
         "replaces": "src/repro/kernels/uplink.py:82",
         "launches": counts_b["fused_uplink"] + counts_20["fused_uplink"],
         "max_abs_err": main_err["fused_uplink"], "ms": up_ms,
         "plain_ms": up_plain, "bound_ms": up_bound, "bound_by": up_by,
         "library_ms": up_lib},
        {"name": "fused_uplink_ef", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/uplink.cu",
         "replaces": "src/repro/kernels/uplink.py:117",
         "launches": (counts_a["fused_uplink_ef"]
                      + lora_counts["A"]["fused_uplink_ef"]
                      + counts_17.get("fused_uplink_ef", 0)
                      + counts_18.get("fused_uplink_ef", 0)
                      + counts_20["fused_uplink_ef"]),
         "max_abs_err": main_err["fused_uplink_ef"], "ms": ef_ms,
         "plain_ms": ef_plain, "bound_ms": ef_bound, "bound_by": ef_by,
         "library_ms": None},
    ]
    # flash attention a route: the prefill (tensor cores) keeps the
    # kernel's name; times are one use (28 launches) of the main path;
    # launches add phase 13's fine-tuning runs (bf16 on the tensor-core
    # route, f32 on the CUDA cores) and phase 20's (hymba's f32 training on
    # the CUDA cores, its serving on the split-KV route)
    for c in (*lora_counts.values(), counts_20):
        for route in flash_attention.ROUTES:
            launches[route] += c[f"flash_attention_{route}"]
    for name, route, source in (
            ("flash_attention", "tc", "flash_attention_tc.cu"),
            ("flash_attention_decode", "decode",
             "flash_attention_decode.cu"),
            ("flash_attention_cuda_core", "cuda_core",
             "flash_attention.cu")):
        k_ms, p_ms, l_ms, b_ms, b_by, _ = fa_times[route]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:32",
            "launches": launches[route], "max_abs_err": fa_err[route],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms})
    say(f"[elapsed] all phases: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
