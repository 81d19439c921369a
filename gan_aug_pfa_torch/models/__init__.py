"""Models (NCHW ``nn.Module``s with the reference ``state_dict`` names)."""

from .siamese_unet import SiameseUNet

__all__ = ["SiameseUNet"]
