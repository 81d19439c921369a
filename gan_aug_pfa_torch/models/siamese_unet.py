"""Siamese Attention U-Net change-detection model, NCHW (reference
models.py:47-145; the JAX package's ``models/siamese_unet.py``).

  * shared-weight encoder 64 -> 128 -> 256 -> 512 (+ bottleneck 1024)
    applied to both images;
  * per-level concatenation of the two branches (2048-channel bottleneck,
    1024/512/256/128-channel skips);
  * four additive attention gates on the concatenated skips;
  * decoder by 2x bilinear upsample (align_corners=True) + DoubleConv;
  * 1x1 head ``conv_last`` producing ``n_classes`` logits (no sigmoid).

41,160,525 parameters, as the reference.

Under the 'spatial' axis (``parallel/spatial.py``) each level runs at its
global height h (the input's H / 2^l), split over the spatial ranks while
h divides by their number and whole on each of them below: the pools and
upsamples move maps between the two as the rule says, and the concatenated
skips (or, under ``concat_free``, their slices) meet maps of the same
height, so both sides follow it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import spatial
from .blocks import AttentionGate, DoubleConv, Slices


class SiameseUNet(nn.Module):
    """The JAX package's knobs (models/siamese_unet.py:40-145):

    * ``batched_encoder``: both images through the shared encoder as one
      2B-batch pass.  In eval mode (running-stat BN) it computes the same
      function as the two-pass form; in train mode the BatchNorm
      statistics are taken jointly over both images, and the running
      statistics update once a step, not twice.
    * ``concat_free``: the decoder's channel concatenations stay tuples of
      slices, in the order of the concatenation, which the attention
      gates and each decoder block's first conv take as they are
      (``blocks.sliced_conv2d``).  The same function.
    * ``remat``: every DoubleConv recomputes its activations in the
      backward (``blocks.DoubleConv``).  The same function and running
      statistics.

    None of them changes the parameters or the ``state_dict``."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1,
                 batched_encoder: bool = False, concat_free: bool = False,
                 remat: bool = False):
        super().__init__()
        self.batched_encoder = batched_encoder
        self.concat_free = concat_free
        self.dconv_down1 = DoubleConv(n_channels, 64)
        self.dconv_down2 = DoubleConv(64, 128)
        self.dconv_down3 = DoubleConv(128, 256)
        self.dconv_down4 = DoubleConv(256, 512)
        self.bottleneck = DoubleConv(512, 1024)

        # Combined (two-branch concatenated) channel sizes.
        ch_bott, ch_s4, ch_s3, ch_s2, ch_s1 = 2048, 1024, 512, 256, 128
        self.att3 = AttentionGate(ch_bott, ch_s4, ch_s4 // 2)
        self.att2 = AttentionGate(512, ch_s3, ch_s3 // 2)
        self.att1 = AttentionGate(256, ch_s2, ch_s2 // 2)
        self.att_last = AttentionGate(128, ch_s1, ch_s1 // 2)

        self.dconv_up3 = DoubleConv(ch_bott + ch_s4, 512)
        self.dconv_up2 = DoubleConv(512 + ch_s3, 256)
        self.dconv_up1 = DoubleConv(256 + ch_s2, 128)
        self.dconv_last = DoubleConv(128 + ch_s1, 64)
        self.conv_last = nn.Conv2d(64, n_classes, 1)
        for m in self.modules():
            if isinstance(m, DoubleConv):
                m.remat = remat

    def encode(self, x: torch.Tensor):
        """The five levels' features of ``x`` (c1, c2, c3, c4, b)."""
        h = spatial.input_height(x)
        feats = []
        for i, block in enumerate((self.dconv_down1, self.dconv_down2,
                                   self.dconv_down3, self.dconv_down4,
                                   self.bottleneck)):
            if i:
                x = spatial.max_pool2x(x, h)
                h //= 2
            with spatial.level(h):
                x = block(x)
            feats.append(x)
        return tuple(feats)

    def _join(self, ts) -> Slices:
        """A decoder input from its parts ``ts``: one part as it is, else
        their tuple under ``concat_free`` and their concatenation
        without."""
        if len(ts) == 1:
            return ts[0]
        return tuple(ts) if self.concat_free else torch.cat(ts, dim=1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """x1, x2: (B, C, H, W) in [-1, 1]. Returns (B, n_classes, H, W)
        logits (under a spatial split: this rank's rows of each)."""
        if self.batched_encoder:
            b = x1.shape[0]
            feats = self.encode(torch.cat([x1, x2], dim=0))
            (c1a, c1b), (c2a, c2b), (c3a, c3b), (c4a, c4b), (ba, bb) = (
                (t[:b], t[b:]) for t in feats
            )
        else:
            c1a, c2a, c3a, c4a, ba = self.encode(x1)
            c1b, c2b, c3b, c4b, bb = self.encode(x2)

        # One walk for both forms: under concat_free the bottleneck's two
        # halves are upsampled apart and no concatenation is built.
        x = self._join((ba, bb))
        h = spatial.input_height(x1) // 16
        for att, block, skip in (
                (self.att3, self.dconv_up3, (c4a, c4b)),
                (self.att2, self.dconv_up2, (c3a, c3b)),
                (self.att1, self.dconv_up1, (c2a, c2b)),
                (self.att_last, self.dconv_last, (c1a, c1b))):
            up = tuple(spatial.upsample2x(t, h) for t in _parts(x))
            h *= 2
            with spatial.level(h):
                gated = att(self._join(up), self._join(skip))
                x = block(self._join(up + _parts(gated)))
        return self.conv_last(x)


def _parts(x: Slices) -> tuple:
    """The channel slices of ``x``: a tensor is one."""
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)
