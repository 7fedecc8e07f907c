"""Data pipeline: synthetic datasets + federated partitioning + batching
(numpy, copied verbatim from the reference), and the device-resident
:class:`ClientShards` of the multi-round engine."""
from repro_torch.data.device import ClientShards
from repro_torch.data.loader import FederatedData, lm_federated
from repro_torch.data.partition import (dirichlet_partition, iid_partition,
                                        partition_sizes)
from repro_torch.data.synthetic import (ArrayDataset, make_image_dataset,
                                        make_lm_dataset)

__all__ = ["ClientShards", "FederatedData", "lm_federated",
           "dirichlet_partition", "iid_partition", "partition_sizes",
           "ArrayDataset", "make_image_dataset", "make_lm_dataset"]
