"""vgg9-cifar10 — the paper's own experimental setup (§III-A), port of
``repro.configs.vgg9_cifar10``.

VGG-9 (8 conv + 1 FC), CIFAR-10-like data, N=50 clients, K=20 participants
per round, FedLDF n=4 (80 % uplink saving), one local SGD step at lr 0.05,
batch 32 per client.
"""
from repro_torch.federated.server import FLConfig
from repro_torch.models.cnn import VGGConfig


def config() -> VGGConfig:
    return VGGConfig()


def fl_config(algo: str = "fedldf", mode: str = "vmap") -> FLConfig:
    return FLConfig(algo=algo, num_clients=50, clients_per_round=20,
                    top_n=4, local_steps=1, lr=0.05, mode=mode,
                    batch_per_client=32)
