"""Checkpointing, port of ``repro.checkpoint``: the same npz format."""
from repro_torch.checkpoint.io import (load_pytree, load_server_state,
                                       save_pytree, save_server_state)

__all__ = ["save_pytree", "load_pytree", "save_server_state",
           "load_server_state"]
