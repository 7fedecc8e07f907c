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
   once.

Flash attention has three routes (``kernels/flash_attention.py:route``):
the tensor-core prefill (``flash_attention_tc.cu``), the split-KV decode
(``flash_attention_decode.cu``) and the CUDA cores (``flash_attention.cu``,
f32 prefill and bf16 at hd 16 or 32). Phase 3 holds every route to the
plain version: ``tests/test_flash_kernel.py`` CASES (f32 and bf16, at 1e-4
/ 2e-2), a decode sweep (Sq 1, 5, 16; G 1, 2, 7, 8; kv_len 0, 1, a split
boundary ± 1 and Skv; causal and windowed), ragged and padded tensor-core
cases, a fully masked case a route, and the full-width prefill and decode
shapes in bf16 and f32. Phase 9 times the CUDA-core route on the f32
prefill's own calls.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The data set is cut to 10,000 training
images (200 per client instead of the paper's 1,000) to keep set-up short;
weights are random, drawn from a fixed seed.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ROUNDS = 3
ROUNDS_B = 2                # setting B (int4) runs fewer rounds
NUM_TRAIN = 10_000          # the paper's 50,000 cut 5x (set-up time)
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
# H100 SXM data sheet: HBM rate, the f32 rate outside the tensor cores and
# the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
SLEEP_CYCLES = 10_000_000   # ~5 ms of GPU spin: the host enqueues meanwhile


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def main():
    import torch
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
    from repro_torch.data import (FederatedData, iid_partition,
                                  make_image_dataset)
    from repro_torch.federated import (CompressionConfig, build_round_scan,
                                       build_round_vmap, make_local_update,
                                       make_strategy, run_training,
                                       sample_clients)
    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, aggregate, divergence,
                                     flash_attention, ops, uplink)
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import serve
    from repro_torch.models import decode as dec
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import classify_loss, init_params
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
    t0 = time.perf_counter()
    build_s = _build.build()
    say(f"[build] nvcc, one process a source, all started together: "
        f"{time.perf_counter() - t0:.2f} s in all; seconds a source from the "
        f"start: " + ", ".join(f"{n} {build_s[n]:.2f}" if n in build_s else
                               f"{n} (built before)"
                               for n in _build.SOURCES))

    # ---- 3. kernels vs plain on the card -------------------------------
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
    say(f"[kernel] flash_attention calls a route in this phase: {fa_seen}; "
        f"max_abs_err a route: {fa_err}")
    if not all(fa_seen.values()):
        failures.append(f"flash_attention routes not all exercised: "
                        f"{fa_seen}")
    del q, k, v, out
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")

    # ---- 4. vmap rounds at full width ----------------------------------
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
            pairs = int(kref._attention_mask(
                sq_, k.shape[1], kw["causal"], kw["window"], kv_len,
                dev).sum())
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
    del params
    torch.cuda.empty_cache()
    say("[cli] python -m repro_torch.launch.serve --arch qwen3-1.7b "
        "--temperature 0:")
    serve.main(["--arch", SERVE_ARCH, "--temperature", "0"])

    kernels = [
        {"name": "sqdiff_rowsum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/divergence.cu",
         "replaces": "src/repro/kernels/divergence.py:27",
         "launches": sum(c["sqdiff_rowsum"]
                         for c in (counts_v, counts_s, counts_a, counts_b)),
         "max_abs_err": main_err["sqdiff_rowsum"], "ms": sq_ms,
         "plain_ms": sq_plain, "bound_ms": sq_bound_v, "bound_by": sq_by,
         "library_ms": None},
        {"name": "masked_accumulate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:25",
         "launches": (counts_v["masked_accumulate"]
                      + counts_s["masked_accumulate"]),
         "max_abs_err": main_err["masked_accumulate"], "ms": ma_ms,
         "plain_ms": ma_plain, "bound_ms": ma_bound, "bound_by": ma_by,
         "library_ms": ma_lib},
        {"name": "fused_uplink", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/uplink.cu",
         "replaces": "src/repro/kernels/uplink.py:82",
         "launches": counts_b["fused_uplink"],
         "max_abs_err": main_err["fused_uplink"], "ms": up_ms,
         "plain_ms": up_plain, "bound_ms": up_bound, "bound_by": up_by,
         "library_ms": up_lib},
        {"name": "fused_uplink_ef", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/uplink.cu",
         "replaces": "src/repro/kernels/uplink.py:117",
         "launches": counts_a["fused_uplink_ef"],
         "max_abs_err": main_err["fused_uplink_ef"], "ms": ef_ms,
         "plain_ms": ef_plain, "bound_ms": ef_bound, "bound_by": ef_by,
         "library_ms": None},
    ]
    # flash attention a route: the prefill (tensor cores) keeps the
    # kernel's name; times are one use (28 launches) of the main path
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
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
