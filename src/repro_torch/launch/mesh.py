"""The client mesh on ``torch.distributed``, port of ``repro.launch.mesh``.

The reference runs a mesh as ONE process over D devices: the FL round is a
``shard_map`` body over the ``'clients'`` axis (and on a 2-D mesh a
``'model'`` axis), and each ``jax.lax`` collective in it reaches every
device of its axis. The port runs one process (rank) a device. Every rank
runs the same program, and each collective of the reference's body becomes
one explicit ``torch.distributed`` call made by every rank of the axis. A
:class:`ClientMesh` stands in for the reference's ``Mesh``: it holds the
rank, the world, the device, the backend, the process groups of its axes
and the tier groups, and the collectives the round needs
(:meth:`~ClientMesh.all_gather_rows`, :meth:`~ClientMesh.all_reduce_flat`,
:meth:`~ClientMesh.group_all_reduce`, :meth:`~ClientMesh.ring_shift` over
the clients axis, :meth:`~ClientMesh.all_gather_model` over the model
axis), each with call and byte counters.

``make_client_mesh(D)`` is the 1-D ``'clients'`` mesh: the round's K
clients split D ways. D may be smaller than the world: the mesh is then
world ranks 0..D-1 (the reference's first D devices), and a rank outside
it holds a mesh it cannot run a round on. ``make_client_mesh(D,
model=M)`` folds the D ranks into a ``(C = D // M, M)`` grid, rank r at
``(c, m) = (r // M, r % M)`` (the reference's ``devs.reshape(D // M,
M)``): the M ranks of a model row (one c) train the same K/C clients,
each holding a 1/M shard of every parameter leaf and of the EF store
(FSDP, :mod:`repro_torch.launch.sharding`), and the clients-axis
collectives run within a column (one m).

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
same values on every rank. Nor has ``shard_map_norep``: the port runs no
``shard_map``; each rank runs its share of the round as plain code.

:func:`make_production_mesh` and :func:`make_host_mesh` build shape-only
meshes (:class:`ShapeMesh`: ``.shape`` and ``.axis_names``, no process
group, no device): the port has no SPMD partitioner, so they serve the
sharding specs of the dry-run (:mod:`repro_torch.launch.dryrun`) alone.

Multi-process use::

    init_distributed("tcp://host0:29500", num_processes=D, process_id=r)
    flcfg = FLConfig(..., mesh=make_client_mesh(model=M))   # every rank
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
        "ring_shift", "all_gather_model")
# how long a rank waits in a collective for the others
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)
# the process group's timeout, which the mesh's subgroups take too (a new
# group's own default is torch's 30 minutes)
_group_timeout = COLLECTIVE_TIMEOUT


class ShapeMesh:
    """A mesh by its shape only: ``shape`` (axis -> size, in order) and
    ``axis_names``. It joins no process group and holds no device; the
    sharding specs (:mod:`repro_torch.launch.sharding`) read nothing
    else."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The production mesh on H100s, for the same chip counts as the
    reference's TPU v5e pods: ``(data=32, model=8)``, 256 cards, or with
    ``multi_pod`` ``(pod=2, data=32, model=8)``, 512 cards; the 'pod' axis
    joins the data/FSDP product. 'model' (tensor parallelism) stays inside
    one 8-GPU NVLink node: the reference's ``(16, 16)`` is a v5e pod's
    torus, and 16-way tensor parallelism on H100s would cross onto the
    network between nodes."""
    if multi_pod:
        return ShapeMesh({"pod": 2, "data": 32, MODEL_AXIS: 8})
    return ShapeMesh({"data": 32, MODEL_AXIS: 8})


def data_axes(mesh) -> tuple[str, ...]:
    """Axes forming the batch/FSDP product ('pod' included when present)."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def make_host_mesh(data: int = 2, model: int = 2) -> ShapeMesh:
    """A small ``(data, model)`` mesh for CI-scale sharding tests."""
    return ShapeMesh({"data": int(data), MODEL_AXIS: int(model)})


def _default_backend(world: int) -> str:
    if torch.cuda.is_available() and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *,
                     backend: str | None = None,
                     timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
                     ) -> dict:
    """Idempotent ``torch.distributed.init_process_group``.

    Call once in every process before :func:`make_client_mesh`.
    ``coordinator_address`` is the store: ``"tcp://host:port"``,
    ``"host:port"`` (read as tcp) or ``"file:///path"``; with every
    argument ``None`` torch's ``env://`` reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. ``backend`` None picks
    ``nccl`` when CUDA is there and the world fits on the visible cards
    (one rank a card), else ``gloo``. With CUDA the process's card is set
    to ``local_device_ids[0]``, or to ``rank % device_count``. Every
    collective, also of a mesh's subgroups, gives up after ``timeout``
    (``COLLECTIVE_TIMEOUT``), so a lost rank fails the others instead of
    hanging them. A process already in a group is left as it is.

    Returns ``{"process_id", "process_count", "device_count"}`` (one
    device a process: ``device_count`` is the world's size)."""
    global _group_timeout
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
                                timeout=timeout, **kw)
        _group_timeout = timeout
        if torch.cuda.is_available():
            ids = list(local_device_ids or [])
            torch.cuda.set_device(ids[0] if ids else
                                  dist.get_rank() % torch.cuda.device_count())
    world = dist.get_world_size()
    return {"process_id": dist.get_rank(), "process_count": world,
            "device_count": world}


class ClientMesh:
    """A mesh of ``size`` ranks; this process is ``rank`` on ``device``.

    ``model`` 1 is the 1-D ``'clients'`` mesh. ``model`` M > 1 is the
    ``(size // M, M)`` grid of the 2-D ``('clients', 'model')`` mesh:
    this rank sits at ``(client_rank, model_rank) = divmod(rank, M)``.
    ``client_size`` and ``client_rank`` (C and c) say which K/C block of a
    round's clients the rank trains; ``model_size`` and ``model_rank`` (M
    and m) which 1/M shard of every sharded leaf it holds. On the 1-D mesh
    they are ``size``, ``rank``, 1 and 0.

    ``backend`` is the process group's (``"nccl"`` or ``"gloo"``), or None
    for a mesh without a process group, whose collectives are the
    identity. The mesh is world ranks ``0..size-1``; in a larger world
    (a submesh) a rank ``>= size`` is no ``member``: it holds the mesh
    but raises on any round (:meth:`check_member`), as a JAX process
    that owns no device of the mesh. Every rank of the world creates, at
    construction and in the same order (``new_group`` is collective),
    the submesh's group on the 1-D mesh, or on the grid the C row groups
    and the M column groups, then the two-tier reduce's groups of every
    group size from 2 below C that divides C (:meth:`tier_group`). The
    clients-axis collectives run over this rank's column (the world, or the
    submesh's group, on the 1-D mesh; none at C = 1, where they are the
    identity), :meth:`all_gather_model` over its row. Every collective is
    called by every rank of its group in the same order, as the
    reference's ``shard_map`` body runs on every device. ``counts()``
    gives ``{op: (calls, bytes)}`` (bytes this rank contributes) and
    ``staged`` (ops, bytes copied both ways, seconds)."""

    def __init__(self, size: int, rank: int, device, backend: Optional[str],
                 model: int = 1):
        self.size, self.rank = int(size), int(rank)
        self.model_size = max(int(model), 1)
        if self.size % self.model_size:
            raise ValueError(f"ClientMesh: model={model} must divide the "
                             f"size {size}")
        self.client_size = self.size // self.model_size
        self.client_rank, self.model_rank = divmod(self.rank,
                                                   self.model_size)
        self.axis_names = ((CLIENT_AXIS,) if self.model_size == 1
                           else (CLIENT_AXIS, MODEL_AXIS))
        self.device = torch.device(device)
        self.backend = backend
        # gloo reads and writes host memory: a CUDA payload goes through
        # the pinned staging buffer, decided here and not on an error
        self.stage = backend == "gloo" and self.device.type == "cuda"
        self._tiers: dict[int, object] = {}
        self._host: Optional[torch.Tensor] = None
        # the clients axis: the world (group None) or the submesh's group
        # on the 1-D mesh, this rank's column on the grid; no collective
        # at all along an axis of one rank
        self._col = self._row = None
        self._col_solo = backend is None or (self.model_size > 1
                                             and self.client_size == 1)
        self._row_solo = backend is None or self.model_size == 1
        world = dist.get_world_size() if backend is not None else self.size
        self.member = self.rank < self.size
        c_, m_ = self.client_size, self.model_size
        if backend is not None and m_ > 1:
            for c in range(c_):
                pg = self._new_group([c * m_ + j for j in range(m_)])
                if self.member and c == self.client_rank:
                    self._row = pg
            for j in range(m_):
                pg = self._new_group([c * m_ + j for c in range(c_)])
                if self.member and j == self.model_rank:
                    self._col = pg
        elif backend is not None and world > self.size:
            pg = self._new_group(list(range(self.size)))
            self._col = pg if self.member else None
        if backend is not None:
            # a block of 1 needs none, a block of C is the column
            for gs in range(2, c_):
                if c_ % gs == 0:
                    self._tiers[gs] = self._new_tier(gs)
        self.reset_counts()

    def check_member(self) -> None:
        """Raise unless this rank is one of the mesh's."""
        if not self.member:
            raise ValueError(
                f"rank {self.rank} is not in this client mesh of ranks "
                f"0..{self.size - 1}: only they run its rounds")

    def _new_group(self, ranks: list[int]):
        return dist.new_group(ranks, backend=self.backend,
                              timeout=_group_timeout)

    def _world_rank(self, client_rank: int) -> int:
        """The world rank at ``(client_rank, model_rank)``: this rank's
        column."""
        return client_rank * self.model_size + self.model_rank

    @property
    def shape(self) -> dict:
        if self.model_size == 1:
            return {CLIENT_AXIS: self.client_size}
        return {CLIENT_AXIS: self.client_size, MODEL_AXIS: self.model_size}

    def __repr__(self):
        return (f"ClientMesh(size={self.size}, rank={self.rank}, "
                f"model={self.model_size}, device={self.device}, "
                f"backend={self.backend})")

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
        """Σ over the clients axis of ``buf`` (any shape), in place;
        returns it."""
        self._note("all_reduce_flat", buf)
        if self._col_solo:
            return buf
        return self._all_reduce(buf, self._col)

    def _new_tier(self, group_size: int):
        """Every column's blocks of ``group_size`` consecutive client
        coordinates, each a new group (collective: every rank of the world
        creates them all, in order); returns this rank's."""
        mine = None
        for j in range(self.model_size):
            for g in range(self.client_size // group_size):
                ranks = [(g * group_size + i) * self.model_size + j
                         for i in range(group_size)]
                pg = self._new_group(ranks)
                if self.rank in ranks:
                    mine = pg
        return mine

    def tier_group(self, group_size: int):
        """The process group of this rank's block of ``group_size``
        consecutive client coordinates within its column, made at
        construction for every size from 2 below C that divides C; a
        block of C is the column's own group."""
        if group_size == self.client_size:
            return self._col
        if group_size not in self._tiers:
            raise ValueError(f"no tier group of {group_size} ranks on a "
                             f"clients axis of {self.client_size}")
        return self._tiers[group_size]

    def group_all_reduce(self, buf: torch.Tensor,
                         group_size: int) -> torch.Tensor:
        """Σ of ``buf`` over this rank's block of ``group_size``
        consecutive client coordinates, in place (the tier-1 reduce)."""
        self._note("group_all_reduce", buf)
        if self._col_solo or group_size == 1:
            return buf
        return self._all_reduce(buf, self.tier_group(group_size))

    def _all_reduce(self, buf: torch.Tensor, group) -> torch.Tensor:
        if not self.stage:
            dist.all_reduce(buf, group=group)
            return buf
        (h,) = self._host_views((buf.shape, buf.dtype))
        self._to_host(h, buf)
        dist.all_reduce(h, group=group)
        self._from_host(buf, h)
        return buf

    def ring_shift(self, buf: torch.Tensor, shift: int) -> torch.Tensor:
        """The ``buf`` of client coordinate ``client_rank - shift`` (mod
        C) in this rank's column, a new tensor: every rank sends its
        ``buf`` ``shift`` coordinates on (the reference's ``ppermute``
        rotation, one ``batch_isend_irecv``)."""
        self._note("ring_shift", buf)
        c_ = self.client_size
        if self._col_solo or shift % c_ == 0:
            return buf.clone()
        dst = self._world_rank((self.client_rank + shift) % c_)
        src = self._world_rank((self.client_rank - shift) % c_)
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

    def _p2p(self, send: torch.Tensor, recv: torch.Tensor, dst: int,
             src: int) -> None:
        # in the clients-axis group: every rank of it sends and receives
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, send, dst, group=self._col),
             dist.P2POp(dist.irecv, recv, src, group=self._col)])
        for r in reqs:
            r.wait()

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The column's ``x`` (R, ...) stacked in client-coordinate order:
        (C·R, ...) (the reference's ``all_gather(..., 'clients',
        tiled=True)``)."""
        self._note("all_gather_rows", x)
        if self._col_solo:
            return x
        return self._all_gather(x, self.client_size, self._col)

    def all_gather_model(self, buf: torch.Tensor) -> torch.Tensor:
        """The row's 1-D ``buf`` (n,) stacked in model-coordinate order:
        (M, n) (the reference's ``all_gather`` over ``'model'``, which
        :func:`repro_torch.launch.sharding.tree_all_gather` cuts into
        leaves)."""
        self._note("all_gather_model", buf)
        if self._row_solo:
            return buf.reshape(1, -1)
        return self._all_gather(buf.reshape(1, -1), self.model_size,
                                self._row)

    def _all_gather(self, x: torch.Tensor, n: int, group) -> torch.Tensor:
        x = x.contiguous()
        shape = (n * x.shape[0],) + tuple(x.shape[1:])
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if self.stage:
            h_in, h_out = self._host_views((x.shape, x.dtype),
                                           (shape, x.dtype))
            self._to_host(h_in, x)
            dist.all_gather(list(h_out.chunk(n)), h_in, group=group)
            self._from_host(out, h_out)
        else:
            dist.all_gather(list(out.chunk(n)), x, group=group)
        return out


def make_client_mesh(num_devices: int | None = None, model: int = 1,
                     processes: int | None = None,
                     device="cuda") -> ClientMesh:
    """The mesh of the FL round engine (``FLConfig(mesh=...)``), one rank
    a device: the 1-D ``'clients'`` mesh, or with ``model`` M > 1 the 2-D
    ``('clients', 'model')`` grid of ``(D // M, M)`` ranks (see
    :class:`ClientMesh`); M must divide D.

    ``num_devices`` None is every rank of the process group (a world of 1
    without one). Inside a group, ``num_devices`` D of the world's W ranks
    is the mesh of world ranks 0..D-1, the reference's first D devices
    (the mesh's collectives run in the group, also at D = W = 1; at
    1 < D < W in a group of those D, which every rank creates); a rank
    ``>= D`` gets a mesh whose rounds raise (:meth:`ClientMesh.
    check_member`). D = 1 < W is this rank alone, whose collectives are
    the identity. ``processes``
    checks the world's size, as the reference's checks
    ``jax.process_count()``. ``device`` ``"cuda"`` is this process's card
    (``torch.cuda.current_device()``, which :func:`init_distributed`
    sets); ``"cpu"`` runs the mesh on the host under ``gloo``."""
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
    model = max(int(model), 1)
    if n % model:
        raise ValueError(
            f"make_client_mesh: model={model} must divide the total device "
            f"count {n} (mesh shape is (clients={n}//{model}, model={model}))")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if grouped and (n == world or n > 1):
        return ClientMesh(n, dist.get_rank(), device, dist.get_backend(),
                          model=model)
    return ClientMesh(1, 0, device, None)


def client_mesh_size(mesh) -> int:
    """Ranks on the ``'clients'`` axis (validates the axis exists)."""
    if CLIENT_AXIS not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}; FL client sharding needs a "
            f"{CLIENT_AXIS!r} axis (see make_client_mesh)")
    return int(mesh.shape[CLIENT_AXIS])


def model_mesh_size(mesh) -> int:
    """Ranks on the ``'model'`` axis; 1 when the mesh has no such axis
    (1-D client meshes keep params fully replicated)."""
    if MODEL_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[MODEL_AXIS])


# ----------------------------------------------------------------------
# a world of ranks on one host
# ----------------------------------------------------------------------
def _rank_main(rank: int, world: int, store: str, backend: Optional[str],
               out_dir: str, timeout: datetime.timedelta) -> None:
    fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                          weights_only=False)
    init_distributed(store, world, rank, backend=backend, timeout=timeout)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          backend: Optional[str] = None,
          store_dir: Optional[str] = None,
          timeout: datetime.timedelta = COLLECTIVE_TIMEOUT) -> list:
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
    waiting on a collective gives up after ``timeout``. The results come
    back through ``torch.save`` files."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        torch.save((fn, tuple(args)), os.path.join(tmp, "call.pt"))
        store = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, args=(world, store, backend, tmp, timeout),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
