"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled for Hopper (``sm_90a``) into ``build/repro_torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``), under a file name that
carries a hash of the source, so an edited source is rebuilt and an
unchanged one is reused. Nothing is compiled or loaded when a module is
imported: this module only reaches ``nvcc`` when a CUDA tensor reaches a
kernel wrapper (or :func:`build` is called).

Each C entry point returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, so a refused launch never passes silently.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ("divergence", "aggregate", "uplink", "flash_attention",
           "flash_attention_tc", "flash_attention_decode")
CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Launches per kernel: each wrapper adds one where it launches its kernel.
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the port's "
        "CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no current library, one ``nvcc``
    process per source, all started together. Returns each compiled
    source's wall seconds from the common start to its process's end."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "wb") as f:
            procs[name] = (out, tmp, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT))
    seconds, failed = {}, []
    while len(seconds) < len(procs):
        for name, (out, tmp, log, proc) in procs.items():
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            if proc.returncode:
                failed.append(f"{name}.cu:\n"
                              f"{log.read_bytes().decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)   # atomic: concurrent builders are safe
            log.unlink(missing_ok=True)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, **signatures) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if needed).

    ``signatures`` maps each C function to its ``argtypes``: pointers and
    the stream are ``c_void_p`` so they are not cut to 32 bits; every
    function returns an ``int`` error code.
    """
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
