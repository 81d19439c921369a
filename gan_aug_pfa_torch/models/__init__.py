"""Models (NCHW ``nn.Module``s with the reference ``state_dict`` names)."""

from .pix2pix import NLayerDiscriminator, UNetGenerator
from .siamese_unet import SiameseUNet

__all__ = ["NLayerDiscriminator", "SiameseUNet", "UNetGenerator"]
