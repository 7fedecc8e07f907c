"""FedLDF core: the paper's contribution as PyTorch modules."""
from repro_torch.core import (aggregation, comm, compress, selection, units,
                              wire)
from repro_torch.core.aggregation import (aggregate_stacked, fedavg_stacked,
                                          stacked_psum_finalize,
                                          streaming_add, streaming_finalize,
                                          streaming_init, unit_weights)
from repro_torch.core.comm import CommMeter, round_comm
from repro_torch.core.selection import full_participation, topn_divergence
from repro_torch.core.units import UnitMap
from repro_torch.core.wire import CompressionConfig, PackedPayload

__all__ = ["aggregation", "comm", "compress", "selection", "units", "wire",
           "aggregate_stacked", "fedavg_stacked", "stacked_psum_finalize",
           "streaming_add",
           "streaming_finalize", "streaming_init", "unit_weights",
           "CommMeter", "round_comm", "full_participation",
           "topn_divergence", "UnitMap", "CompressionConfig",
           "PackedPayload"]
