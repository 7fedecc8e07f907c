"""Launchers and placement, port of ``repro.launch``: the serve launcher
(``serve.py``) and the single-device residual store (``sharding.py``) so
far."""
