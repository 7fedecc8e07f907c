"""Strategy plugins for the federated round engine (port of
``repro.federated.strategies``). ``FLConfig.algo`` resolves through the
registry here; see :mod:`repro_torch.federated.strategies.base` for the
hook contract.
"""
from repro_torch.federated.strategies.base import (FLStrategy,
                                                   get_strategy_cls,
                                                   register_strategy,
                                                   registered_algos,
                                                   strategy_registry,
                                                   unregister_strategy)
from repro_torch.federated.strategies import builtin  # noqa: F401 (registers)
from repro_torch.federated.strategies import fedlama  # noqa: F401 (registers)
from repro_torch.federated.strategies.builtin import (FedADPOptions,
                                                      FedLPOptions)
from repro_torch.federated.strategies.compression import QuantizedUpload
from repro_torch.federated.strategies.fedlama import FedLAMAOptions

__all__ = ["FLStrategy", "FedADPOptions", "FedLAMAOptions", "FedLPOptions",
           "QuantizedUpload", "get_strategy_cls", "make_strategy",
           "register_strategy", "registered_algos", "strategy_registry",
           "unregister_strategy"]


def make_strategy(flcfg) -> FLStrategy:
    """The strategy instance for ``flcfg.algo``, wrapped in the
    quantize(+EF) :class:`QuantizedUpload` when ``flcfg.compression`` is
    set."""
    strat = get_strategy_cls(flcfg.algo)(flcfg)
    comp = getattr(flcfg, "compression", None)
    if comp is not None:
        strat = QuantizedUpload(strat, flcfg, comp)
    return strat
