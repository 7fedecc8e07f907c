"""Loop-aware op totals of a program, the port's counterpart of
``repro.launch.hloparse``.

The reference counts a compiled XLA program: it parses the HLO text,
weights each ``while`` body by its trip count, and sums the FLOPs of
``dot`` / ``convolution``, the operand + result bytes of every top-level
(post-fusion) instruction and the result bytes of every collective. The
parser has no counterpart here: the port has no compiled program to read.
This module does its job instead. :func:`analyze` runs the program itself,
usually on the ``meta`` device (shape and dtype, no storage, no kernel:
a 400B-parameter model costs nothing to run), under a counting
``TorchDispatchMode`` that sees every aten op the program issues, once for
each time it runs, so every Python loop (layers, clients, KV chunks) is
counted as it runs, and a ``vmap`` over K counts its batched ops, K times
the work of one. Each op gives one :class:`OpRecord`:

- FLOPs of the matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``mv``, ``dot``: what ``matmul`` / ``einsum`` decompose into) and of
  convolutions and their backward, 2 per multiply-add: what
  ``hloparse.analyze`` counts (``dot``, ``convolution``). A grouped
  convolution (``vmap`` batches per-client weights into groups) counts
  ``C_in / groups`` inputs an output, in its backward too;
- bytes: every tensor operand read plus every result written. Eager
  PyTorch does not fuse, so each op's operands and results are the traffic
  model of the port, as fusion-level HLO bytes are of XLA's. View and alias
  ops (``view``, ``transpose``, ``expand``, ``slice``, ``select``,
  ``detach``, …) and bare allocations move nothing and count no bytes, as
  ``hloparse`` skips ``bitcast``;
- the innermost ``repro_torch`` frame (``file:line function``), the
  counterpart of HLO's ``op_name`` metadata, with the autograd node's name
  for an op of a backward pass.

Live storage bytes are tracked across the run (each new storage counted
until it is freed), which gives the peak that stands in for XLA's
``memory_analysis()``. Collectives keep the reference's ``COLLECTIVES``
keys in ``collective_by_type``; a one-card program issues none, and each
stays ``0.0``.

On ``meta`` the model takes its non-CUDA routes: the plain versions of the
hand-written kernels and the chunked ``_attend_flash``, which is also what
the reference's dry-run counts. The totals therefore describe the plain
program, not the kernels' launches. An op that needs data (``.item()``,
``nonzero``, a boolean mask) raises on ``meta``: :class:`OpCountError`
names it and its frame.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# torch's functional collectives, by the reference's collective names
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_reduce": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}
# ops that move no bytes: aliases the schema does not mark as views, bare
# allocations, and the scalar read (which raises on meta anyway)
_NO_BYTES_OPS = {"_unsafe_view", "lift_fresh", "empty", "empty_like",
                 "empty_strided", "new_empty", "new_empty_strided",
                 "_local_scalar_dense", "_reshape_alias"}
# ops whose first operand is only written
_WRITE_ONLY_OPS = {"copy_", "fill_", "zero_"}
_HERE = __file__


class OpCountError(RuntimeError):
    """An op of the counted program raised (on ``meta``: it needed data)."""


@dataclasses.dataclass(slots=True)
class OpRecord:
    op: str                       # e.g. "aten.mm.default"
    flops: float
    bytes: float                  # operands read + results written
    frame: str                    # innermost repro_torch frame
    collective: Optional[str] = None   # a COLLECTIVES key
    collective_bytes: float = 0.0      # its result bytes


@dataclasses.dataclass
class OpTotals:
    """``hloparse.HloTotals``'s fields, plus the memory of the run and the
    per-op records (:mod:`repro_torch.launch.inspect` reads them)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: dict = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    loop_weighted: bool = True
    peak_bytes: float = 0.0       # most live storage bytes, arguments in
    argument_bytes: float = 0.0   # the arguments' distinct storages
    output_bytes: float = 0.0     # the outputs' distinct storages
    alias_bytes: float = 0.0      # output bytes that are argument storage
    records: list = dataclasses.field(default_factory=list)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> float:
    """2 × outputs × (C_in / groups · kernel) multiply-adds: the weight is
    (C_out, C_in / groups, *k), or (C_in, C_out / groups, *k) transposed,
    where every input element meets C_out / groups · kernel weights."""
    return 2.0 * math.prod(x_shape if transposed else out_shape) \
        * math.prod(w_shape[1:])


def _flops(name: str, args, out) -> float:
    """FLOPs of one op (0 for the ops ``hloparse`` does not count)."""
    if name == "dot":
        return 2.0 * args[0].numel()
    if name in ("mm", "bmm", "mv"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):     # (bias, a, b)
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "convolution":
        x, w, transposed = args[0], args[1], args[6]
        return _conv_flops(x.shape, w.shape, out.shape, transposed)
    if name == "convolution_backward":
        # grad_input and grad_weight each cost the forward's FLOPs
        grad_out, x, w, transposed, mask = (args[0], args[1], args[2],
                                            args[7], args[10])
        return _conv_flops(x.shape, w.shape, grad_out.shape, transposed) \
            * (int(mask[0]) + int(mask[1]))
    return 0.0


class _Counter(TorchDispatchMode):
    def __init__(self, totals: OpTotals):
        super().__init__()
        self.totals = totals
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.frames: dict[tuple, str] = {}
        self.names: dict = {}

    # ---- memory ------------------------------------------------------
    def hold(self, t: torch.Tensor, release: bool = True) -> None:
        """Count ``t``'s storage as live (once), until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        if release:
            weakref.finalize(st, self._free, key)
        self.totals.peak_bytes = max(self.totals.peak_bytes,
                                     self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    # ---- attribution -------------------------------------------------
    def frame(self) -> str:
        f = sys._getframe(2)
        while f is not None:
            name = f.f_code.co_filename
            if "repro_torch" in name and name != _HERE:
                break
            f = f.f_back
        node = torch._C._current_autograd_node()
        node = None if node is None else node.name()
        key = (None, 0, node) if f is None else (f.f_code, f.f_lineno, node)
        where = self.frames.get(key)
        if where is None:
            if f is None:
                where = "?"
            else:
                path = f.f_code.co_filename.replace("\\", "/")
                path = path[path.rfind("repro_torch/"):]
                where = f"{path}:{f.f_lineno} {f.f_code.co_name}"
            if node is not None:
                where = f"{where} <{node}>"
            self.frames[key] = where
        return where

    # ---- dispatch ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except Exception as e:
            raise OpCountError(f"{func} at {self.frame()}: "
                               f"{type(e).__name__}: {e}") from e
        name = func.overloadpacket.__name__
        flops = _flops(name, args, out)
        outs = _tensors(out)
        nbytes = 0
        if not (func.is_view or name in _NO_BYTES_OPS):
            reads = _tensors((args[1:] if name in _WRITE_ONLY_OPS else args,
                              {k: v for k, v in kwargs.items()
                               if k != "out"}))
            nbytes = (sum(_nbytes(t) for t in reads)
                      + sum(_nbytes(t) for t in outs))
        coll, cb = None, 0
        if func.namespace == "_c10d_functional" and name in _COLLECTIVE_OPS:
            coll = _COLLECTIVE_OPS[name]
            cb = sum(_nbytes(t) for t in outs)
            self.totals.collective_bytes += cb
            self.totals.collective_by_type[coll] += cb
        for t in outs:
            self.hold(t)
        self.totals.flops += flops
        self.totals.hbm_bytes += nbytes
        op = self.names.get(func)
        if op is None:
            op = self.names[func] = str(func)
        self.totals.records.append(
            OpRecord(op, flops, float(nbytes), self.frame(), coll, float(cb)))
        return out


def analyze(fn: Callable, *args: Any) -> OpTotals:
    """Run ``fn(*args)`` under the counter and return its totals and
    per-op records. The arguments' storages are live from the start;
    ``peak_bytes`` counts them. Raises :class:`OpCountError` when an op
    of the program raises."""
    totals = OpTotals()
    counter = _Counter(totals)
    for t in _tensors(args):
        counter.hold(t, release=False)
    totals.argument_bytes = float(counter.live_bytes)
    arg_keys = set(counter.live)
    with counter:
        out = fn(*args)
    outs: dict[int, int] = {}
    for t in _tensors(out):
        outs[_storage_key(t)] = t.untyped_storage().nbytes()
    totals.output_bytes = float(sum(outs.values()))
    totals.alias_bytes = float(sum(n for k, n in outs.items()
                                   if k in arg_keys))
    return totals
