"""Pix2Pix: the recursive U-Net generator and the 70x70 PatchGAN
discriminator (NCHW counterparts of the JAX package's
``models/pix2pix.py``, reference models.py:149-247).

Both are built as the reference's ``nn.Sequential``s, so the
``state_dict`` keys are the reference's: ``model.model.N.*`` for the
generator (each skip block a ``model`` Sequential inside the next) and
``model.N.*`` for the discriminator.  Sequential indices per block:

  outermost: downconv 0, submodule 1, ReLU 2, upconv 3, Tanh 4
  innermost: LeakyReLU 0, downconv 1, ReLU 2, upconv 3, upnorm 4
  middle:    LeakyReLU 0, downconv 1, downnorm 2, submodule 3, ReLU 4,
             upconv 5, upnorm 6

Quirks kept from the JAX package: every downconv is bias-free, the
norm-less outermost one too; only the outermost upconv has a bias; the
skip is ``cat([x, block(x)])`` with ``x`` as it entered the block (the
activations are not in place); the discriminator's first and last convs
have biases.  Full width: 41,828,995 and 2,768,705 parameters.  Dropout
is left out: no CLI turns it on.

Under the 'spatial' axis (``parallel/spatial.py``) both walk their layers
with each map's global height, and each conv follows the split rule: the
generator's 4x4 stride-2 convs and conv-transposes run on height blocks
with one halo row each side while the maps split, its inner levels whole
where their height no longer divides (the skip concatenations meet maps of
one height); the discriminator's stride-2 convs run split, its two
stride-1 convs (H - 1 rows, which no block layout keeps) whole, and its
patch map comes out whole on every spatial rank.  The discriminator's
pair input (``--concat-free-disc``) takes the same walk: its first conv
runs on the blocks of A and B apart, each slice with its halo rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import spatial
from .blocks import Slices, sliced_conv2d


class UnetSkipBlock(nn.Module):
    """One recursive skip block (JAX ``UnetSkipBlock``, pix2pix.py:59-105)."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional["UnetSkipBlock"] = None,
                 outermost: bool = False, innermost: bool = False):
        super().__init__()
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, stride=2, padding=1,
                             bias=False)
        if outermost:
            layers = [downconv, submodule, nn.ReLU(),
                      nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2,
                                         padding=1),
                      nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), downconv, nn.ReLU(),
                      nn.ConvTranspose2d(inner_nc, outer_nc, 4, stride=2,
                                         padding=1, bias=False),
                      nn.BatchNorm2d(outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), downconv, nn.BatchNorm2d(inner_nc),
                      submodule, nn.ReLU(),
                      nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2,
                                         padding=1, bias=False),
                      nn.BatchNorm2d(outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _walk(self.model, x, spatial.height())[0]
        return y if self.outermost else torch.cat([x, y], dim=1)


def _walk(layers: nn.Sequential, x: torch.Tensor, h: int):
    """``layers(x)`` on a map of global height ``h``: under a spatial
    split each conv by the split rule, every other layer at its map's
    level (without one, ``layers(x)``).  Returns the output and its global
    height."""
    for layer in layers:
        if isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
            x, h = spatial.conv(layer, x, h)
        else:
            with spatial.level(h):
                x = layer(x)
    return x, h


class UNetGenerator(nn.Module):
    """Pix2Pix U-Net generator (JAX ``UNetGenerator``, pix2pix.py:108-144):
    (B, input_nc, H, W) in [-1, 1] -> (B, output_nc, H, W) in [-1, 1]; H and
    W must be multiples of 2**num_downs."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 7, ngf: int = 64):
        super().__init__()
        if num_downs < 5:
            raise ValueError(
                f"UNetGenerator needs num_downs >= 5, got {num_downs}")
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block)
        block = UnetSkipBlock(ngf * 4, ngf * 8, submodule=block)
        block = UnetSkipBlock(ngf * 2, ngf * 4, submodule=block)
        block = UnetSkipBlock(ngf, ngf * 2, submodule=block)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc=input_nc,
                                   submodule=block, outermost=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with spatial.level(spatial.input_height(x)):
            return self.model(x)


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN (JAX ``NLayerDiscriminator``, pix2pix.py:147-198):
    4x4 convs with strides 2, ..., 2, 1, 1; input cat([A, B]) on channels,
    A first; 256x256 gives (B, 1, 30, 30) patch logits.  The input may be
    the pair (A, B) instead (``--concat-free-disc``): the first conv then
    sums the two convolutions with the halves of its 6-channel weight
    (``blocks.sliced_conv2d``), and the concatenation is never built.
    Either way the patch map comes out whole."""

    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * nf, 4, stride=2, padding=1,
                                 bias=False),
                       nn.BatchNorm2d(ndf * nf), nn.LeakyReLU(0.2)]
        prev, nf = nf, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * prev, ndf * nf, 4, stride=1, padding=1,
                             bias=False),
                   nn.BatchNorm2d(ndf * nf), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * nf, 1, 4, stride=1, padding=1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: Slices) -> torch.Tensor:
        conv0 = self.model[0]
        h = spatial.input_height(x if isinstance(x, torch.Tensor) else x[0])
        y = sliced_conv2d(x, conv0, h)
        y, h = _walk(self.model[1:], y, spatial.conv_height(conv0, h))
        return spatial.gather_rows(y) if spatial.splits(h) else y
