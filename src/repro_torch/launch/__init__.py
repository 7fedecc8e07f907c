"""Launchers and placement, port of ``repro.launch``: the serve launcher
(``serve.py``), the FL training launcher (``train.py``), the telemetry
ledger monitor (``monitor.py``), the client mesh on ``torch.distributed``
(``mesh.py``) and the per-client stores (``sharding.py``)."""
