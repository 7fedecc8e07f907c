"""Placement of the federated state on devices (port of ``repro.launch``;
only the single-device residual store so far)."""
