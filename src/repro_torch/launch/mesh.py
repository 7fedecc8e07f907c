"""The client mesh on ``torch.distributed``, port of ``repro.launch.mesh``.

The reference runs a mesh as ONE process over D devices: the FL round is a
``shard_map`` body over the ``'clients'`` axis, and each ``jax.lax``
collective in it reaches every device. The port runs one process (rank) a
device. Every rank runs the same program on its own K/D clients, and each
collective of the reference's body becomes one explicit
``torch.distributed`` call made by every rank. A :class:`ClientMesh`
stands in for the reference's ``Mesh``: it holds the rank, the world, the
device, the backend and the tier groups, and the four collectives the round
needs (:meth:`~ClientMesh.all_gather_rows`,
:meth:`~ClientMesh.all_reduce_flat`, :meth:`~ClientMesh.group_all_reduce`,
:meth:`~ClientMesh.ring_shift`), each with call and byte counters.

Backends: ``nccl`` when every rank has a card of its own (the default on
CUDA while the world is no larger than ``torch.cuda.device_count()``),
``gloo`` for CPU tensors and for ranks that share a card (NCCL refuses two
ranks on one card). Under ``gloo`` a CUDA payload is staged through one
pinned host buffer (a copy to the host, the collective, a copy back); the
mesh decides that when it is built, from its backend and device, and counts
the staged ops, bytes and seconds. Nothing runs on the CPU in place of a
CUDA op that failed.

The reference's ``replicated_rng`` has no counterpart: the port's draws
come from keyed CPU generators (``federated/sampling.py``), which give the
same values on every rank. ``make_production_mesh``, ``make_host_mesh`` and
``data_axes`` serve only the reference's XLA dry-run and wait for that
tooling (ROADMAP Queue 1, item 12); the 2-D ``('clients', 'model')`` mesh
is the next slice of item 11.

Multi-process use::

    init_distributed("tcp://host0:29500", num_processes=D, process_id=r)
    flcfg = FLConfig(..., mesh=make_client_mesh())   # every rank
    params, log = run_training_scan(params, loss_fn, data, flcfg, ...)

:func:`spawn` starts such a world on one host (``torch.multiprocessing``,
a ``file://`` store), as the tests and ``chip_smoke.py`` do.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

CLIENT_AXIS = "clients"
MODEL_AXIS = "model"

_OPS = ("all_gather_rows", "all_reduce_flat", "group_all_reduce",
        "ring_shift")
# how long a rank waits in a collective for the others
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def _default_backend(world: int) -> str:
    if torch.cuda.is_available() and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *,
                     backend: str | None = None) -> dict:
    """Idempotent ``torch.distributed.init_process_group``.

    Call once in every process before :func:`make_client_mesh`.
    ``coordinator_address`` is the store: ``"tcp://host:port"``,
    ``"host:port"`` (read as tcp) or ``"file:///path"``; with every
    argument ``None`` torch's ``env://`` reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. ``backend`` None picks
    ``nccl`` when CUDA is there and the world fits on the visible cards
    (one rank a card), else ``gloo``. With CUDA the process's card is set
    to ``local_device_ids[0]``, or to ``rank % device_count``. Every
    collective gives up after ``COLLECTIVE_TIMEOUT``, so a lost rank fails
    the others instead of hanging them. A process already in a group is
    left as it is.

    Returns ``{"process_id", "process_count", "device_count"}`` (one
    device a process: ``device_count`` is the world's size)."""
    if not dist.is_initialized():
        if coordinator_address is None and num_processes is None:
            init, world, rank = "env://", None, None
            world_n = int(os.environ.get("WORLD_SIZE", "1"))
        else:
            init = coordinator_address or "env://"
            if "://" not in init:
                init = "tcp://" + init
            world, rank, world_n = num_processes, process_id, num_processes
        backend = backend or _default_backend(world_n)
        kw = {} if world is None else {"world_size": world, "rank": rank}
        dist.init_process_group(backend, init_method=init,
                                timeout=COLLECTIVE_TIMEOUT, **kw)
        if torch.cuda.is_available():
            ids = list(local_device_ids or [])
            torch.cuda.set_device(ids[0] if ids else
                                  dist.get_rank() % torch.cuda.device_count())
    world = dist.get_world_size()
    return {"process_id": dist.get_rank(), "process_count": world,
            "device_count": world}


class ClientMesh:
    """A 1-D ``'clients'`` mesh of ``size`` ranks; this process is
    ``rank`` on ``device``.

    ``backend`` is the process group's (``"nccl"`` or ``"gloo"``), or None
    for a mesh of one rank without a process group, whose collectives are
    the identity. Every collective is called by every rank of the mesh in
    the same order, as the reference's ``shard_map`` body runs on every
    device. ``counts()`` gives ``{op: (calls, bytes)}`` (bytes this rank
    contributes) and ``staged`` (ops, bytes copied both ways, seconds)."""

    axis_names = (CLIENT_AXIS,)

    def __init__(self, size: int, rank: int, device, backend: Optional[str]):
        self.size, self.rank = int(size), int(rank)
        self.device = torch.device(device)
        self.backend = backend
        # gloo reads and writes host memory: a CUDA payload goes through
        # the pinned staging buffer, decided here and not on an error
        self.stage = backend == "gloo" and self.device.type == "cuda"
        self._tiers: dict[int, object] = {}
        self._host: Optional[torch.Tensor] = None
        self.reset_counts()

    @property
    def shape(self) -> dict:
        return {CLIENT_AXIS: self.size}

    def __repr__(self):
        return (f"ClientMesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    # ---- counters ----------------------------------------------------
    def reset_counts(self) -> None:
        self._calls = dict.fromkeys(_OPS, 0)
        self._bytes = dict.fromkeys(_OPS, 0)
        self._staged = [0, 0, 0.0]

    def counts(self) -> dict:
        out = {op: (self._calls[op], self._bytes[op]) for op in _OPS}
        out["staged"] = tuple(self._staged)
        return out

    def _note(self, op: str, t: torch.Tensor) -> None:
        self._calls[op] += 1
        self._bytes[op] += t.numel() * t.element_size()

    # ---- staging -----------------------------------------------------
    def _pinned(self, nbytes: int) -> torch.Tensor:
        """The staging buffer, grown to at least ``nbytes`` (uint8)."""
        if self._host is None or self._host.numel() < nbytes:
            self._host = torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=True)
        return self._host

    def _host_views(self, *likes: tuple) -> list[torch.Tensor]:
        """Consecutive views of the staging buffer, one a ``(shape,
        dtype)``."""
        sizes = [torch.Size(s).numel() * torch.empty((), dtype=d)
                 .element_size() for s, d in likes]
        buf = self._pinned(sum(sizes))
        out, off = [], 0
        for (s, d), n in zip(likes, sizes):
            out.append(buf[off:off + n].view(d).view(s))
            off += n
        return out

    def _to_host(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        t = time.perf_counter()
        dst.copy_(src)          # blocking: the collective reads it next
        self._staged[0] += 1
        self._staged[1] += src.numel() * src.element_size()
        self._staged[2] += time.perf_counter() - t

    def _from_host(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        t = time.perf_counter()
        dst.copy_(src)          # blocking: the buffer is reused next op
        self._staged[1] += src.numel() * src.element_size()
        self._staged[2] += time.perf_counter() - t

    # ---- collectives -------------------------------------------------
    def all_reduce_flat(self, buf: torch.Tensor) -> torch.Tensor:
        """Σ over the mesh of ``buf`` (any shape), in place; returns it."""
        self._note("all_reduce_flat", buf)
        return self._all_reduce(buf, None)

    def tier_group(self, group_size: int):
        """The process group of this rank's block of ``group_size``
        consecutive ranks. ``new_group`` is collective: every rank creates
        every block's group, in order, the first time a size is asked."""
        if group_size not in self._tiers:
            mine = None
            for g in range(self.size // group_size):
                ranks = list(range(g * group_size, (g + 1) * group_size))
                pg = dist.new_group(ranks, backend=self.backend)
                if self.rank in ranks:
                    mine = pg
            self._tiers[group_size] = mine
        return self._tiers[group_size]

    def group_all_reduce(self, buf: torch.Tensor,
                         group_size: int) -> torch.Tensor:
        """Σ of ``buf`` over this rank's block of ``group_size``
        consecutive ranks, in place (the tier-1 reduce)."""
        self._note("group_all_reduce", buf)
        if self.backend is None or group_size == 1:
            return buf
        return self._all_reduce(buf, self.tier_group(group_size))

    def _all_reduce(self, buf: torch.Tensor, group) -> torch.Tensor:
        if self.backend is None:
            return buf
        if not self.stage:
            dist.all_reduce(buf, group=group)
            return buf
        (h,) = self._host_views((buf.shape, buf.dtype))
        self._to_host(h, buf)
        dist.all_reduce(h, group=group)
        self._from_host(buf, h)
        return buf

    def ring_shift(self, buf: torch.Tensor, shift: int) -> torch.Tensor:
        """The ``buf`` of rank ``rank - shift`` (mod size), a new tensor:
        every rank sends its ``buf`` ``shift`` ranks on (the reference's
        ``ppermute`` rotation, one ``batch_isend_irecv``)."""
        self._note("ring_shift", buf)
        if self.backend is None or shift % self.size == 0:
            return buf.clone()
        dst, src = ((self.rank + shift) % self.size,
                    (self.rank - shift) % self.size)
        out = torch.empty_like(buf)
        if self.stage:
            h_in, h_out = self._host_views((buf.shape, buf.dtype),
                                           (buf.shape, buf.dtype))
            self._to_host(h_in, buf)
            self._p2p(h_in, h_out, dst, src)
            self._from_host(out, h_out)
        else:
            self._p2p(buf.contiguous(), out, dst, src)
        return out

    @staticmethod
    def _p2p(send: torch.Tensor, recv: torch.Tensor, dst: int,
             src: int) -> None:
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                       dist.P2POp(dist.irecv, recv, src)])
        for r in reqs:
            r.wait()

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` (R, ...) stacked in rank order: (size·R, ...)
        (the reference's ``all_gather(..., tiled=True)``)."""
        self._note("all_gather_rows", x)
        if self.backend is None:
            return x
        x = x.contiguous()
        shape = (self.size * x.shape[0],) + tuple(x.shape[1:])
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if self.stage:
            h_in, h_out = self._host_views((x.shape, x.dtype),
                                           (shape, x.dtype))
            self._to_host(h_in, x)
            dist.all_gather(list(h_out.chunk(self.size)), h_in)
            self._from_host(out, h_out)
        else:
            dist.all_gather(list(out.chunk(self.size)), x)
        return out


def make_client_mesh(num_devices: int | None = None, model: int = 1,
                     processes: int | None = None,
                     device="cuda") -> ClientMesh:
    """The 1-D ``'clients'`` mesh of the FL round engine
    (``FLConfig(mesh=...)``): the round's K clients split D ways, one rank
    a device.

    ``num_devices`` None is every rank of the process group (a world of 1
    without one). Inside a group, ``num_devices`` must be the world's size
    (the mesh's collectives run in the group, also at 1), or 1 for a mesh
    of this rank alone, whose collectives are the identity. ``processes``
    checks the world's size, as the reference's checks
    ``jax.process_count()``. ``device`` ``"cuda"`` is this process's card
    (``torch.cuda.current_device()``, which :func:`init_distributed`
    sets); ``"cpu"`` runs the mesh on the host under ``gloo``.

    ``model > 1`` (the reference's 2-D ``('clients', 'model')`` mesh, FSDP
    of the params and the EF store) is the next slice of the port."""
    if model > 1:
        raise NotImplementedError(
            f"make_client_mesh: model={model} (the 2-D ('clients', 'model') "
            "mesh, FSDP of the params and the EF residual store) is not "
            "ported yet; it is the next slice of the port (ROADMAP Queue 1, "
            "item 11). Use model=1")
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"make_client_mesh: asked for {n} devices, have {world} (one "
            "rank a device: start that many processes and call "
            "repro_torch.launch.mesh.init_distributed() in each)")
    if processes is not None and processes > 1 and world != processes:
        raise ValueError(
            f"make_client_mesh: processes={processes} but the process group "
            f"has {world} — call repro_torch.launch.mesh.init_distributed() "
            "in every process first")
    if grouped and 1 < n < world:
        raise ValueError(
            f"make_client_mesh: a mesh of {n} of the group's {world} ranks "
            "is not supported; start a group of that many processes")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if grouped and n == world:
        return ClientMesh(world, dist.get_rank(), device,
                          dist.get_backend())
    return ClientMesh(1, 0, device, None)


def client_mesh_size(mesh) -> int:
    """Ranks on the ``'clients'`` axis (validates the axis exists)."""
    if CLIENT_AXIS not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}; FL client sharding needs a "
            f"{CLIENT_AXIS!r} axis (see make_client_mesh)")
    return int(mesh.shape[CLIENT_AXIS])


def model_mesh_size(mesh) -> int:
    """Ranks on the ``'model'`` axis: 1, as every mesh of the port is 1-D
    (params and the EF store replicated on every rank)."""
    if MODEL_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[MODEL_AXIS])


# ----------------------------------------------------------------------
# a world of ranks on one host
# ----------------------------------------------------------------------
def _rank_main(rank: int, world: int, store: str, backend: Optional[str],
               out_dir: str) -> None:
    fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                          weights_only=False)
    init_distributed(store, world, rank, backend=backend)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          backend: Optional[str] = None,
          store_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes, each a rank of
    one process group, and return their results in rank order.

    ``fn`` is pickled by its import path (a module-level function of a
    module the children can import); the processes start fresh
    (``torch.multiprocessing`` ``spawn``), so they import only what ``fn``
    and ``args`` need. ``fn`` and ``args`` travel through a ``torch.save``
    file, not the start pipe: a large ``args`` in the pipe would hold each
    start until that child had imported torch, starting the ranks one after
    another. The group meets at a ``file://`` store in the same temporary
    directory (under ``store_dir``; the system's when None): no port to
    pick, no clash between worlds started side by side. ``backend`` None
    follows :func:`init_distributed`'s rule. A rank that raises fails the
    call (``torch.multiprocessing.ProcessRaisedException``); a rank left
    waiting on a collective gives up after ``COLLECTIVE_TIMEOUT``. The
    results come back through ``torch.save`` files."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        torch.save((fn, tuple(args)), os.path.join(tmp, "call.pt"))
        store = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, args=(world, store, backend, tmp),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
