"""Federated runtime: ClientUpdate + ServerExecute (Algorithm 1)."""
from repro_torch.federated.client import make_local_update, plain_sgd_client
from repro_torch.federated.sampling import sample_clients
from repro_torch.federated.server import (FLConfig, TrainLog, build_round_fn,
                                          build_round_scan, build_round_vmap,
                                          run_training)
from repro_torch.federated.strategies import (FLStrategy, make_strategy,
                                              register_strategy,
                                              unregister_strategy)

__all__ = ["make_local_update", "plain_sgd_client", "sample_clients",
           "FLConfig", "TrainLog", "build_round_fn", "build_round_scan",
           "build_round_vmap", "run_training", "FLStrategy", "make_strategy",
           "register_strategy", "unregister_strategy"]
