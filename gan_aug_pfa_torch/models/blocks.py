"""Shared building blocks: DoubleConv and the additive AttentionGate (NCHW).

Submodule names and order follow the reference ``state_dict`` keys
(``dconv_down1.0.weight``, ``att3.W_g.0.weight``, ``att3.psi.1.running_var``)
so that reference ``.pth`` files load with ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn


class DoubleConv(nn.Sequential):
    """(Conv3x3 no-bias -> BN -> ReLU) x2 (reference models.py:7-15)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(inplace=True),
        )


class AttentionGate(nn.Module):
    """Additive attention gate (reference models.py:18-44):
    psi = sigmoid(BN(Conv1x1(relu(BN(W_g g) + BN(W_x x))))); returns x * psi.
    """

    def __init__(self, f_g: int, f_l: int, f_int: int):
        super().__init__()
        self.W_g = nn.Sequential(
            nn.Conv2d(f_g, f_int, 1, bias=True), nn.BatchNorm2d(f_int)
        )
        self.W_x = nn.Sequential(
            nn.Conv2d(f_l, f_int, 1, bias=True), nn.BatchNorm2d(f_int)
        )
        self.psi = nn.Sequential(
            nn.Conv2d(f_int, 1, 1, bias=True), nn.BatchNorm2d(1), nn.Sigmoid()
        )

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = torch.relu(self.W_g(g) + self.W_x(x))
        return x * self.psi(psi)
