"""The benchmark of the PyTorch/CUDA port (``repro_torch``): federated
rounds timed end to end on the card, the layers read from a device trace,
and the rounds checked against a plain PyTorch reference.

Run a cell from the root of a checkout::

    python3 bench/run.py --workload vgg9-k20-fedldf --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel group is a file of its own that the harness finds by the name
``BENCHMARK.json`` gives it (see :mod:`bench.spec`).
"""
