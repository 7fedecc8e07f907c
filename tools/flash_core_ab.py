"""Time the CUDA-core flash-attention kernel (``csrc/flash_attention.cu``)
against a baseline source with the same C interface, in turns on one card.

    python3 tools/flash_core_ab.py --baseline DIR [--baseline DIR2 ...]
        [--reps 10] [--json PATH]

Each ``DIR`` holds another checkout of the repository (for instance
``git archive <commit> | tar -x -C build/base``); its
``src/repro_torch/kernels/csrc/flash_attention.cu`` is compiled with the
same ``nvcc`` flags into ``build/flash_core_ab/`` (ptxas's registers and
spills printed). Every kernel launches through the same wrapper
(``kernels/flash_attention.py``, its checks and strides), one swapped in
for another. Each shape is one call at a shape of the main path's
CUDA-core uses, on inputs from a seed: every result is held to the plain
version (``kernels/ref.py``), then each kernel is timed with CUDA events
over a cold L2 (a 256 MB buffer zeroed before each launch), the median
of ``--reps`` launches, in the order of the baselines, current, current,
the baselines in reverse. The bound is the larger of the f32 operations
over the CUDA cores' peak and the bytes over the HBM rate
(``launch/roofline.py``).
Prints a line a shape (the first with the card's clock under load), the
card's name and power limit, the current kernel's blocks and the inner
loops of its f32 hd 64 and 128 instantiations from ``cuobjdump -sass``
(the whole SASS goes to ``build/flash_core_ab/current.sass``), and last
one JSON object with every number. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "flash_core_ab"
SEED = 0
SLEEP_CYCLES = 10_000_000    # ~5 ms of GPU spin: the host enqueues meanwhile
# (name, B, Sq, H, KV, Skv, hd, causal, launches a use): the f32 uses of
# the CUDA-core route on the main path (chip_smoke.py's [times] lines)
SHAPES = [
    ("qwen3-1.7b prefill", 4, 2048, 16, 8, 2048, 128, True, 28),
    ("hymba-1.5b prefill", 4, 2048, 25, 5, 2048, 64, True, 32),
    ("deepseek-moe-16b prefill", 4, 2048, 16, 16, 2048, 128, True, 4),
    ("seamless-m4t-large-v2 encoder", 4, 2048, 16, 16, 2048, 64, False, 24),
    ("seamless-m4t-large-v2 decoder self", 4, 2048, 16, 16, 2048, 64, True,
     24),
    ("seamless-m4t-large-v2 cross", 4, 2048, 16, 16, 2048, 64, False, 24),
    ("LoRA layer (qwen3-1.7b, 16 x 128 tokens)", 16, 128, 16, 8, 128, 128,
     True, 1),
    ("hymba-1.5b local step", 4, 47, 25, 5, 47, 64, True, 32),
]


_FUNCTION = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"^\s*(?:`\()?(0x[0-9a-f]+)")


def sass_loops(sass: str) -> dict[str, list[dict]]:
    """Each loop of each function in ``cuobjdump -sass`` text (a branch to
    an earlier address): its first and last address, its length and its
    instructions by kind (FFMA, LDS and STS by width, SHFL, MUFU, BAR,
    LDGSTS, FMUL, FADD, FMNMX)."""
    out, fn, body = {}, None, []
    for line in sass.splitlines():
        if m := _FUNCTION.search(line):
            fn, body = m.group(1), []
            out[fn] = []
            continue
        if fn is None or not (m := _INSN.search(line)):
            continue
        addr, op = int(m.group(1), 16), m.group(2)
        body.append((addr, op))
        t = _TARGET.match(m.group(3))
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            first = int(t.group(1), 16)
            ops = [o for a, o in body if a >= first]
            kinds = collections.Counter()
            for o in ops:
                base = o.split(".")[0]
                if base in ("LDS", "STS"):
                    kinds[o if o.endswith((".128", ".64")) else base] += 1
                elif base in ("FFMA", "SHFL", "MUFU", "BAR", "LDGSTS",
                              "FMUL", "FADD", "FMNMX", "LDL", "STL"):
                    kinds[base] += 1
            out[fn].append({"first": hex(first), "last": hex(addr),
                            "insns": len(ops), **kinds})
    return out


def build_baseline(src: Path, name: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = OUT_DIR / f"libflash_attention_{name}.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True, check=True)
    regs = {e: r for e, r in _build.ptxas_report(done.stdout
                                                  + done.stderr).items()
            if "IfLi" in e}
    print(f"[ab] {name}: f32 instantiations (registers, spill stores, "
          f"spill loads): {regs}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    fn = lib.repro_flash_attention
    fn.argtypes = fa._SIGNATURES["cuda_core"][2]
    fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", required=True,
                    help="a checkout holding a baseline kernel source (may "
                         "be given more than once)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the JSON object here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_core_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kernels = {}
    for base in args.baseline:
        lib = build_baseline(base / "src" / "repro_torch" / "kernels"
                             / "csrc" / "flash_attention.cu", base.name)
        kernels[base.name] = (lib, lib.repro_flash_attention)
    _build.build(("flash_attention",))
    kernels["current"] = fa._fn("cuda_core")
    # in turns: each baseline, current, current, each baseline in reverse
    order = [*kernels, *reversed(kernels)]
    flush = torch.empty(64 * 2**20, device=dev)

    def run(which, q, k, v, causal):
        fa._FNS["cuda_core"] = kernels[which]
        try:
            return fa.flash_attention(q, k, v, causal=causal)
        finally:
            fa._FNS["cuda_core"] = kernels["current"]

    def device_ms(fn):
        for _ in range(3):
            fn()
        spans = []
        for _ in range(args.reps):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            spans.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in spans)

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, b, sq, h, kvh, skv, hd, causal, launches in SHAPES:
        q = torch.randn((b, sq, h, hd), generator=g, device=dev)
        k, v = (torch.randn((b, skv, kvh, hd), generator=g, device=dev)
                for _ in range(2))
        want = ref.flash_attention(q, k, v, causal=causal)
        err = {w: float((run(w, q, k, v, causal) - want).abs().max())
               for w in kernels}
        times = {w: [] for w in kernels}
        for w in order:
            times[w].append(device_ms(lambda: run(w, q, k, v, causal)))
        pairs = (sq * (sq + 1) // 2 + max(0, skv - sq) * sq if causal
                 else sq * skv)
        flops = 4 * b * h * hd * pairs
        nbytes = 2 * q.numel() * 4 + 2 * k.numel() * 4
        bound = max(flops / F32_FLOPS, nbytes / HBM_BW) * 1e3
        if not rows:
            # the card's clock while the current kernel keeps it busy
            for _ in range(200):
                run("current", q, k, v, causal)
            clocks = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw,temperature.gpu", "--format=csv,noheader"],
                capture_output=True, text=True,
                check=True).stdout.strip()
            torch.cuda.synchronize()
            print(f"[ab] {name}, 200 launches of the current kernel in "
                  f"flight: clocks.sm, clocks.max.sm, power.draw, "
                  f"temperature.gpu = {clocks}", flush=True)
        rows.append({"shape": name, "q": [b, sq, h, hd],
                     "kv": [b, skv, kvh, hd], "causal": causal,
                     "launches_a_use": launches, "ms": times,
                     "bound_ms": bound, "max_abs_err": err})
        print(f"[ab] {name} q {tuple(q.shape)} kv {tuple(k.shape)} causal "
              f"{causal}, bound {bound:.4f} ms a launch ({launches} a use); "
              + "; ".join(f"{w} {times[w]} ms, share of bound "
                          f"{bound / min(times[w]):.3f}, x{launches} "
                          f"{min(times[w]) * launches:.3f} ms, max_abs_err "
                          f"{err[w]:.3e}" for w in kernels)
              + f" ({smi})", flush=True)
        del q, k, v, want
    occ = {f"{dn} hd {hd}": fa.core_occupancy(hd, dt)
           for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
           for hd in fa.HEAD_DIMS}
    print(f"[ab] current kernel's blocks: {occ}")
    # the inner loops of the current f32 instantiations, from the SASS
    sass = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
         str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    loops = {name: found for name, found in sass_loops(sass).items()
             if re.search(r"flash_fwdIfLi(64|128)E", name)}
    for name, found in loops.items():
        print(f"[ab] SASS loops of {name}: {found}")
    (OUT_DIR / "current.sass").write_text(sass)
    result = {"card": smi, "reps": args.reps, "shapes": rows,
              "occupancy": occ, "sass_loops": loops}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    bad = [r["shape"] for r in rows if max(r["max_abs_err"].values()) > 1e-4]
    if bad:
        print(f"flash_core_ab: outside 1e-4 of the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
