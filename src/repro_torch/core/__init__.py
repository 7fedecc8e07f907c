"""FedLDF core: the paper's contribution as PyTorch modules."""
from repro_torch.core import (aggregation, comm, compress, lowrank, partition,
                              selection, units, wire)
from repro_torch.core.aggregation import (aggregate_stacked, fedavg_stacked,
                                          hierarchical_psum, mesh_psum,
                                          stacked_psum_finalize,
                                          stacked_psum_parts,
                                          streaming_add, streaming_finalize,
                                          streaming_init, unit_weights)
from repro_torch.core.comm import CommMeter, agg_tier_bytes, round_comm
from repro_torch.core.partition import ParamPartition, partition_counts
from repro_torch.core.selection import (bernoulli_per_layer, client_dropout,
                                        full_participation, random_per_layer,
                                        topn_divergence)
from repro_torch.core.units import UnitMap
from repro_torch.core.wire import CompressionConfig, PackedPayload

__all__ = ["aggregation", "comm", "compress", "lowrank", "partition",
           "selection", "units", "wire",
           "aggregate_stacked", "fedavg_stacked", "hierarchical_psum",
           "mesh_psum", "stacked_psum_finalize", "stacked_psum_parts",
           "streaming_add",
           "streaming_finalize", "streaming_init", "unit_weights",
           "CommMeter", "agg_tier_bytes", "round_comm", "bernoulli_per_layer",
           "client_dropout", "full_participation", "random_per_layer",
           "topn_divergence", "UnitMap", "CompressionConfig",
           "PackedPayload", "ParamPartition", "partition_counts"]
