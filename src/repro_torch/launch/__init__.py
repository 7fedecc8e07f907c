"""Launchers and placement, port of ``repro.launch``: the serve launcher
(``serve.py``), the FL training launcher (``train.py``), the telemetry
ledger monitor (``monitor.py``) and the single-device residual store
(``sharding.py``) so far."""
