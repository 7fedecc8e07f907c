"""Model zoo of the port: VGG-9 (the paper's model) so far."""
from repro_torch.models import cnn

__all__ = ["cnn"]
