"""Plain PyTorch references: what the program computes, written out with
plain ``torch`` operations in f32 and checked against the program's rounds.

Nothing in this package imports the program (``repro_torch``), JAX or the
JAX package: the references work out again, from the benchmark's own
inputs, whatever the program derives from them. A configuration's model is
``bench/reference/<config>.py``; the federated round they share is
:mod:`bench.reference.fl`.
"""
