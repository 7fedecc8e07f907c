"""Model zoo of the port: VGG-9 (the paper's model) and the transformer LM
for the dense and vlm families (attention, forward, serving)."""
from repro_torch.models import (attention, cnn, config, decode, layers,
                                transformer)

__all__ = ["attention", "cnn", "config", "decode", "layers", "transformer"]
