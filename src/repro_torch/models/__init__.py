"""Model zoo of the port: VGG-9 (the paper's model) and the transformer LM
for the dense, vlm, moe, ssm (Mamba-2 SSD) and hybrid families (attention,
the MoE layer, the SSD mixer, forward, serving, the LM loss and LoRA
adapters for federated fine-tuning)."""
from repro_torch.models import (attention, cnn, config, decode, layers, lora,
                                moe, ssm, transformer)
from repro_torch.models.lora import inject_lora, lora_partition

__all__ = ["attention", "cnn", "config", "decode", "layers", "lora", "moe",
           "ssm", "transformer", "inject_lora", "lora_partition"]
