#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each one fails the run if it fails; nothing falls back to the CPU):

1. device: the card's name and power limit;
2. build: ``nvcc`` compiles every kernel of ``src/repro_torch/kernels/csrc``;
3. kernels vs their plain PyTorch versions on the card, over the reference
   test sweep (``tests/test_kernels.py`` SHAPES, f32 and bf16) and the
   main path's shapes, at rtol=3e-3, atol=1e-5;
4. ``run_training`` in ``mode="vmap"`` for 3 rounds on full-width VGG-9
   with the paper's FL setup (N=50, K=20, n=4, B=32, lr=0.05, fedldf);
   one round's divergence matrix, selection and new params are held
   against the same round computed with the plain Eq. 3 reduction;
5. the same in ``mode="scan"``; its round must match phase 4's to 2e-5;
6. kernel times at the main path's shapes beside the byte bound, the plain
   version and a library call, and each mode's round time.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The data set is cut to 10,000 training
images (200 per client instead of the paper's 1,000) to keep set-up short;
weights are random, drawn from a fixed seed.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ROUNDS = 3
NUM_TRAIN = 10_000          # the paper's 50,000 cut 5x (set-up time)
TOL = {"rtol": 3e-3, "atol": 1e-5}  # tests/test_kernels.py:33,45
EQUIV_TOL = 2e-5            # benchmarks/round_engine_bench.py:59
# tests/test_kernels.py:18
SHAPES = [(1, 1), (1, 37), (4, 1000), (8, 2048), (9, 2049), (48, 5000),
          (3, 16384), (62, 33)]
# H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
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
    from repro_torch.core.units import UnitMap, tree_leaves
    from repro_torch.data import (FederatedData, iid_partition,
                                  make_image_dataset)
    from repro_torch.federated import (build_round_scan, build_round_vmap,
                                       make_local_update, run_training,
                                       sample_clients)
    from repro_torch.kernels import _build, aggregate, divergence, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models.cnn import classify_loss, init_params
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
    build_s = _build.build()
    say(f"[build] nvcc for {', '.join(_build.SOURCES)}: {build_s:.2f} s")

    # ---- 3. kernels vs plain on the card -------------------------------
    failures = []
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def compare(label, got, want):
        torch.cuda.synchronize()
        err = (got - want).abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp_min(1e-30)).max())
        ok = bool(torch.allclose(got, want, **TOL))
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
                    kref.masked_accumulate(acc, x, w))
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
        e = compare(f"masked_accumulate (1, {big}) in place {dn}", got, want)
        if dtype == torch.float32:
            main_err["masked_accumulate"] = e
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

    def drive(fl, label):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, log = run_training(params0, loss_fn, data, fl,
                                   rounds=ROUNDS, seed=SEED, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        check_params(label, params)
        if not all(np.isfinite(log.losses)) or len(log.losses) != ROUNDS:
            fail(f"{label}: losses {log.losses}")
        want_up = ROUNDS * per_round_up
        if abs(log.meter.uplink_bytes - want_up) > 1e-6 * want_up:
            fail(f"{label}: uplink {log.meter.uplink_bytes} B, expected "
                 f"{want_up} B (n·model + K·U·4 per round)")
        say(f"[{label}] run_training {ROUNDS} rounds: {wall:.3f} s "
            f"({wall / ROUNDS:.3f} s/round incl. first-round warm-up); "
            f"losses {log.losses}; uplink {log.meter.uplink_bytes:.0f} B, "
            f"savings {log.meter.savings_frac:.4f}; launches {counts}")
        return params, counts

    p_vmap, counts_v = drive(fl_v, "vmap")
    if counts_v["sqdiff_rowsum"] == 0:
        fail("vmap rounds launched no sqdiff_rowsum kernel")

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
    p_scan, counts_s = drive(fl_s, "scan")
    if counts_s["masked_accumulate"] == 0:
        fail("scan rounds launched no masked_accumulate kernel")
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

    # ---- 6. times ------------------------------------------------------
    flush = torch.empty(64 * 2**20, device=dev)     # 256 MB > 50 MB L2

    def device_ms(fn, reps=20):
        """Median device time of fn() with a cold L2: a GPU spin holds the
        stream while the host enqueues fn, so host gaps are not timed."""
        for _ in range(3):
            fn()
        spans, host = [], []
        for _ in range(reps):
            flush.zero_()
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

    # sqdiff_rowsum: one vmap round's Eq. 3, a launch per leaf, K=20
    k = fl_v.clients_per_round
    sq_pairs = []
    for key, (off, n) in umap.spans.items():
        for a, b in zip(tree_leaves(locals_[key]), tree_leaves(params0[key])):
            sq_pairs.append((a.reshape(k * n, -1), b.reshape(n, -1)))
    sq_bytes = sum(nb(a) + nb(b) + a.shape[0] * 4 for a, b in sq_pairs)
    sq_flops = sum(3 * a.numel() for a, _ in sq_pairs)
    sq_bound, sq_by = bound_ms(sq_bytes, sq_flops)
    sq_ms, sq_host = device_ms(lambda: [divergence.sqdiff_rowsum(a, b)
                                        for a, b in sq_pairs])
    sq_plain, _ = device_ms(lambda: [kref.sqdiff_rowsum(a, b)
                                     for a, b in sq_pairs])
    # masked_accumulate: one client's Eq. 5 streaming add (scan round)
    frac = m_s["selection"][0] * 0.05
    acc = {key: {n_: torch.zeros_like(v) for n_, v in sub.items()}
           for key, sub in params0.items()}
    local0 = {key: {n_: v[0].contiguous() for n_, v in sub.items()}
              for key, sub in locals_.items()}
    ma_triples = []
    for key, (off, n) in umap.spans.items():
        for a, x in zip(tree_leaves(acc[key]), tree_leaves(local0[key])):
            ma_triples.append((a.view(n, -1), x.reshape(n, -1),
                               frac[off:off + n]))
    ma_bytes = sum(2 * nb(a) + nb(x) + nb(w) for a, x, w in ma_triples)
    ma_flops = sum(2 * a.numel() for a, _, _ in ma_triples)
    ma_bound, ma_by = bound_ms(ma_bytes, ma_flops)
    ma_ms, ma_host = device_ms(lambda: [
        aggregate.masked_accumulate(a, x, w, out=a)
        for a, x, w in ma_triples])
    ma_plain, _ = device_ms(lambda: [kref.masked_accumulate(a, x, w, out=a)
                                     for a, x, w in ma_triples])
    ma_lib, _ = device_ms(lambda: [a.addcmul_(w[:, None], x)
                                   for a, x, w in ma_triples])
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

    def round_ms(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(params0, batch, sizes)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    rv_ms, rs_ms = round_ms(round_v), round_ms(round_s)
    sq_per_round_v = counts_v["sqdiff_rowsum"] // ROUNDS
    sq_per_round_s = counts_s["sqdiff_rowsum"] // ROUNDS
    ma_per_round = counts_s["masked_accumulate"] // ROUNDS
    say(f"[times] card: {smi}")
    say(f"[times] sqdiff_rowsum, one vmap round's Eq. 3 ({len(sq_pairs)} "
        f"launches, K={k}, {sq_bytes / 1e6:.2f} MB): kernel_ms={sq_ms:.4f} "
        f"bound_ms={sq_bound:.4f} ({sq_by}) plain_ms={sq_plain:.4f} "
        f"library_ms=none (no single PyTorch call computes a per-row sum "
        f"of squared differences; F.pairwise_distance adds eps and takes "
        f"the root) host_enqueue_ms={sq_host:.4f}; launches per round: "
        f"vmap {sq_per_round_v}, scan {sq_per_round_s}")
    say(f"[times] sqdiff_rowsum, conv7.w alone {tuple(s7.shape)}: "
        f"kernel_ms={big_sq:.4f} bound_ms={big_sq_bound:.4f}")
    say(f"[times] masked_accumulate, one client's Eq. 5 add "
        f"({len(ma_triples)} launches, {ma_bytes / 1e6:.2f} MB, in place): "
        f"kernel_ms={ma_ms:.4f} bound_ms={ma_bound:.4f} ({ma_by}) "
        f"plain_ms={ma_plain:.4f} library_ms={ma_lib:.4f} (addcmul_) "
        f"host_enqueue_ms={ma_host:.4f}; launches per round: scan "
        f"{ma_per_round} (x{k} clients: about {ma_ms * k:.4f} ms a round)")
    say(f"[times] masked_accumulate, conv7.w alone {tuple(m7.shape)}: "
        f"kernel_ms={big_ma:.4f} bound_ms={big_ma_bound:.4f} "
        f"library_ms={big_ma_lib:.4f}")
    say(f"[times] round wall-clock (median of 3, after run_training): "
        f"vmap {rv_ms:.3f} ms, scan {rs_ms:.3f} ms ({smi})")

    kernels = [
        {"name": "sqdiff_rowsum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/divergence.cu",
         "replaces": "src/repro/kernels/divergence.py:27",
         "launches": counts_v["sqdiff_rowsum"] + counts_s["sqdiff_rowsum"],
         "max_abs_err": main_err["sqdiff_rowsum"], "ms": sq_ms,
         "plain_ms": sq_plain, "bound_ms": sq_bound, "bound_by": sq_by,
         "library_ms": None},
        {"name": "masked_accumulate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:25",
         "launches": (counts_v["masked_accumulate"]
                      + counts_s["masked_accumulate"]),
         "max_abs_err": main_err["masked_accumulate"], "ms": ma_ms,
         "plain_ms": ma_plain, "bound_ms": ma_bound, "bound_by": ma_by,
         "library_ms": ma_lib},
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
