"""Dry-run of every (arch × shape): count the program on the ``meta``
device and dump its roofline, port of ``repro.launch.dryrun``.

The reference lowers and compiles each program for 512 placeholder TPU
devices and reads XLA's HLO. The port runs the same program on ``meta``
(:mod:`repro_torch.launch.shapes`) under the op counter
(:mod:`repro_torch.launch.opcount`): no compile, no allocation, no own
process, no ``XLA_FLAGS``. The roofline is one H100's (``mesh =
"1xH100"``, ``chips = 1``, no collective term): the port runs a model on
one card or as one rank a card, and has no SPMD partitioner to split one
program. ``memory_per_device`` gives, for that card, the arguments', the
outputs' and the temporaries' bytes (peak live bytes less the arguments)
and whether the program fits one 80 GB card; and, for the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`, 32×8 or with
``--multi-pod`` 2×32×8), the per-device argument bytes under the
``param_specs`` / ``batch_specs`` placement.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k [--multi-pod] [--variant V] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]

Artifacts: one JSON per (arch, shape, mesh) with FLOPs, bytes, the
collective breakdown and the three roofline terms, in the reference's
schema (``benchmarks/roofline_table.py`` tabulates them). An artifact that
exists is skipped; the run exits 1 listing the (arch, shape) pairs that
failed, each with the op that raised.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import opcount
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.shapes import (FL_TRAIN, SHAPES, ShapeSpec, Program,
                                       adapt_config, build_program)
from repro_torch.launch.sharding import batch_specs, param_specs
from repro_torch.core.units import tree_leaves

MESH = "1xH100"
CARD_BYTES = 80e9          # one H100 SXM's HBM3, 80 GB


def _arg_specs(program: Program, mesh, overrides=None) -> list:
    """The spec tree of every argument on ``mesh`` (None: not a tensor
    tree, such as the train program's ``uniform``)."""
    out = []
    for arg, kind in zip(program.args, program.arg_kinds):
        if callable(arg):
            out.append(None)
        elif kind in ("params", "cache"):
            out.append(param_specs(arg, mesh, overrides=overrides))
        elif kind == "batch":
            out.append(batch_specs(arg, mesh,
                                   client_leading=program.flcfg is not None))
        else:   # scalar: replicated
            out.append(None)
    return out


def _shard_bytes(leaf, spec, mesh) -> int:
    """One device's bytes of ``leaf`` laid out by ``spec`` (a dim cut n
    ways holds ceil(d / n) of it)."""
    if not hasattr(leaf, "shape"):
        return 0
    dims = list(leaf.shape)
    for d, axis in enumerate(spec or ()):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        dims[d] = -(-dims[d] // math.prod(mesh.shape[a] for a in axes))
    return math.prod(dims) * leaf.element_size()


def sharded_argument_bytes(program: Program, mesh, overrides=None) -> int:
    """Per-device argument bytes on ``mesh`` under the dry-run's
    placement (params and caches by :func:`param_specs`, batches by
    :func:`batch_specs`, scalars replicated)."""
    total = 0
    for arg, specs in zip(program.args, _arg_specs(program, mesh, overrides)):
        if callable(arg):
            continue
        leaves = tree_leaves(arg) if isinstance(arg, dict) else [arg]
        spec_leaves = (tree_leaves(specs) if isinstance(specs, dict)
                       else [specs] * len(leaves))
        total += sum(_shard_bytes(l, s, mesh)
                     for l, s in zip(leaves, spec_leaves))
    return total


def count(cfg, shape: ShapeSpec, *, program: Optional[Program] = None,
          arch: Optional[str] = None, flcfg=FL_TRAIN,
          multi_pod: bool = False, overrides=None, verbose: bool = False):
    """Count ``cfg``'s program for ``shape`` on ``meta``: (Roofline,
    OpTotals). ``cfg`` is used as given (after :func:`adapt_config`).
    ``program``: an already built one, whose arguments may have been
    swapped for ``meta`` tensors of another call's shapes and dtypes;
    by default :func:`build_program`'s."""
    cfg = adapt_config(cfg, shape)
    if program is None:
        program = build_program(cfg, shape, flcfg)
    t0 = time.perf_counter()
    totals = opcount.analyze(program.fn, *program.args)
    t1 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    mem = {
        "argument_size_in_bytes": totals.argument_bytes,
        "output_size_in_bytes": totals.output_bytes,
        "temp_size_in_bytes": totals.peak_bytes - totals.argument_bytes,
        "alias_size_in_bytes": totals.alias_bytes,
        "peak_size_in_bytes": totals.peak_bytes,
        "fits_one_card": totals.peak_bytes <= CARD_BYTES,
        "card_bytes": CARD_BYTES,
        "production_mesh": "x".join(str(v) for v in mesh.shape.values()),
        "argument_size_in_bytes_sharded": float(
            sharded_argument_bytes(program, mesh, overrides)),
    }
    roof = rl.Roofline(
        arch=arch or cfg.name, shape=shape.name, mesh=MESH, chips=1,
        flops_per_device=totals.flops,
        bytes_per_device=totals.hbm_bytes,
        collective_per_device=totals.collective_bytes,
        collective_by_type=totals.collective_by_type,
        model_flops=rl.model_flops_for(cfg, shape, flcfg),
        memory_per_device=mem)
    if verbose:
        print(f"[{roof.arch} × {shape.name} × {MESH}] count on meta "
              f"{t1 - t0:.1f}s, {len(totals.records)} ops")
        print("  memory:", mem)
        print(f"  cost: flops/dev={roof.flops_per_device:.3e} "
              f"bytes/dev={roof.bytes_per_device:.3e} "
              f"coll/dev={roof.collective_per_device:.3e}")
        print(f"  roofline of the plain program (not of the kernel path): "
              f"compute={roof.t_compute*1e3:.2f}ms "
              f"memory={roof.t_memory*1e3:.2f}ms "
              f"collective={roof.t_collective*1e3:.2f}ms "
              f"dominant={roof.dominant} useful={roof.useful_ratio:.3f}")
    return roof, totals


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              overrides=None, flcfg=FL_TRAIN, variant: str = None,
              verbose: bool = True):
    """Returns (roofline, totals). Raises when the count fails
    (:class:`~repro_torch.launch.opcount.OpCountError` names the op)."""
    cfg = get_config(arch)
    if variant:
        from repro_torch.launch.variants import apply_variant
        mesh = make_production_mesh(multi_pod=multi_pod)
        cfg, var_overrides = apply_variant(variant, cfg, data_axes(mesh))
        overrides = {**(var_overrides or {}), **(overrides or {})} or None
    return count(cfg, SHAPES[shape_name], arch=arch, flcfg=flcfg,
                 multi_pod=multi_pod, overrides=overrides, verbose=verbose)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="named perf variant from launch/variants.py")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES]
              if args.all else [(args.arch, args.shape)])
    failures = []
    t0 = time.perf_counter()
    for arch, shape_name in combos:
        tag = f"{arch}_{shape_name}_{MESH}"
        if args.multi_pod:
            tag += "_2x32x8"
        if args.variant:
            tag += f"__{args.variant}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"skip {tag} (artifact exists)")
            continue
        try:
            roof, _ = lower_one(arch, shape_name, multi_pod=args.multi_pod,
                                variant=args.variant)
            if args.variant:
                roof.mesh += f"__{args.variant}"
            roof.save(path)
        except Exception as e:  # noqa: BLE001 — report and continue
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e}")
            traceback.print_exc()
    print(f"{len(combos)} dry-runs in {time.perf_counter() - t0:.1f} s")
    if failures:
        print("FAILURES:", json.dumps(failures, indent=2))
        return 1
    print("all dry-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
