"""Launchers and placement, port of ``repro.launch``: the serve launcher
(``serve.py``), the FL training launcher (``train.py``), the telemetry
ledger monitor (``monitor.py``), the client mesh on ``torch.distributed``
and the shape-only production meshes (``mesh.py``), the placement specs
and per-client stores (``sharding.py``), and the dry-run tooling: the
assigned shapes as ``meta`` programs (``shapes.py``), the op counter
(``opcount.py``, the counterpart of ``hloparse.py``), the H100 roofline
(``roofline.py``), the dry-run (``dryrun.py``), its profiler
(``inspect.py``) and the named variants (``variants.py``).

Unlike the reference's, nothing here sets ``XLA_FLAGS`` or needs its own
process: the dry-run runs on the ``meta`` device."""
from repro_torch.launch.mesh import (CLIENT_AXIS, client_mesh_size, data_axes,
                                     init_distributed, make_client_mesh,
                                     make_host_mesh, make_production_mesh)

__all__ = ["CLIENT_AXIS", "client_mesh_size", "data_axes",
           "init_distributed", "make_client_mesh", "make_host_mesh",
           "make_production_mesh"]
