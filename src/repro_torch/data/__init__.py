"""Data pipeline: synthetic datasets + federated partitioning + batching
(numpy, copied verbatim from the reference)."""
from repro_torch.data.loader import FederatedData, lm_federated
from repro_torch.data.partition import (dirichlet_partition, iid_partition,
                                        partition_sizes)
from repro_torch.data.synthetic import (ArrayDataset, make_image_dataset,
                                        make_lm_dataset)

__all__ = ["FederatedData", "lm_federated", "dirichlet_partition",
           "iid_partition", "partition_sizes", "ArrayDataset",
           "make_image_dataset", "make_lm_dataset"]
