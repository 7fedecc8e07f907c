"""Strategy plugins for the federated round engine (port of
``repro.federated.strategies``). ``FLConfig.algo`` resolves through the
registry here; see :mod:`repro_torch.federated.strategies.base` for the
hook contract.
"""
from repro_torch.federated.strategies.base import (FLStrategy,
                                                   get_strategy_cls,
                                                   register_strategy,
                                                   unregister_strategy)
from repro_torch.federated.strategies import builtin  # noqa: F401 (registers)

__all__ = ["FLStrategy", "get_strategy_cls", "make_strategy",
           "register_strategy", "unregister_strategy"]


def make_strategy(flcfg) -> FLStrategy:
    """The strategy instance for ``flcfg.algo``."""
    return get_strategy_cls(flcfg.algo)(flcfg)
