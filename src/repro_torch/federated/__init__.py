"""Federated runtime: ClientUpdate + ServerExecute (Algorithm 1).

Algorithms are strategy plugins — see
:mod:`repro_torch.federated.strategies`. ``ALGOS`` is a live view of the
registry (module ``__getattr__``), so ``register_strategy`` additions
appear here.
"""
from repro_torch.core.partition import ParamPartition
from repro_torch.core.wire import CompressionConfig
from repro_torch.federated.client import make_local_update, plain_sgd_client
from repro_torch.federated.sampling import (KeyedDraws, local_rows,
                                            round_generators,
                                            sample_clients,
                                            sample_clients_torch)
from repro_torch.federated.server import (FLConfig, TrainLog, build_round_fn,
                                          build_round_scan, build_round_vmap,
                                          run_training, run_training_scan)
from repro_torch.federated.strategies import (FedADPOptions, FedLAMAOptions,
                                              FedLPOptions, FLStrategy,
                                              QuantizedUpload, make_strategy,
                                              register_strategy,
                                              registered_algos,
                                              strategy_registry,
                                              unregister_strategy)
from repro_torch.launch.sharding import init_residual_store
from repro_torch.telemetry import TelemetryConfig

__all__ = ["ALGOS", "CompressionConfig", "make_local_update",
           "plain_sgd_client", "KeyedDraws", "local_rows",
           "round_generators",
           "sample_clients", "sample_clients_torch", "FLConfig", "TrainLog",
           "build_round_fn", "build_round_scan", "build_round_vmap",
           "run_training", "run_training_scan", "FLStrategy",
           "FedADPOptions", "FedLAMAOptions", "FedLPOptions",
           "ParamPartition", "QuantizedUpload", "init_residual_store",
           "make_strategy", "register_strategy", "registered_algos",
           "strategy_registry", "TelemetryConfig", "unregister_strategy"]


def __getattr__(name):   # PEP 562: ALGOS tracks the live strategy registry
    if name == "ALGOS":
        return registered_algos()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
