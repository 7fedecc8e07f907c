"""Model zoo of the port: VGG-9 (the paper's model) and the transformer LM
for the dense and vlm families (attention, forward, serving, the LM loss
and LoRA adapters for federated fine-tuning)."""
from repro_torch.models import (attention, cnn, config, decode, layers, lora,
                                transformer)
from repro_torch.models.lora import inject_lora, lora_partition

__all__ = ["attention", "cnn", "config", "decode", "layers", "lora",
           "transformer", "inject_lora", "lora_partition"]
