"""Latent transition cells (port of ``pdecontrol_tpu/models/transition.py``;
reference ``surrogates/transition.py``).

A cell maps ``(carry, laction, lstate, tf) -> (carry, outlatent)``.  When
``tf`` (teacher forcing) is true the hidden state ``H`` is *overwritten*
with the provided latent before the gate update (transition.py:83,276-277);
when false the cell free-runs and ignores ``lstate``, like the reference's
``transition`` methods.  Initial carries are zeros (the reference's
non-learnable ``H0``/``C0``).

Only the fused ``CNNLSTMCell`` of the main model is ported so far.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pdecontrol_tpu_torch.models.blocks import CircularConv1d

Carry = Tuple[torch.Tensor, torch.Tensor]


class CNNLSTMCell(nn.Module):
    """Convolutional LSTM over the periodic spatial axis (reference
    ``CNNLSTMCell``/``CNNLSTMTransitionModel``, transition.py:112-296).

    The gates are one 4x-output-channel circular x-conv (with bias) plus one
    4x-output-channel circular h-conv (no bias), kernel 3, split into the
    gate order (i, f, c, o); the output-gate bias starts at 1.0 and the rest
    at 0 (transition.py:213-216).  Latents are ``[B, C, H]``.
    """

    needs_prev_latent = False

    def __init__(self, in_channels: int, schannels: int = 16, ssize: int = 16,
                 kernel_size: int = 3):
        super().__init__()
        self.schannels, self.ssize = schannels, ssize
        self.wx = CircularConv1d(in_channels, 4 * schannels, kernel_size, bias=True)
        self.wh = CircularConv1d(schannels, 4 * schannels, kernel_size, bias=False)
        with torch.no_grad():
            self.wx.bias[3 * schannels :] = 1.0

    def init_carry(self, batch: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Carry:
        z = torch.zeros((batch, self.schannels, self.ssize), dtype=dtype, device=device)
        return (z, z)

    def forward(self, carry: Carry, laction: torch.Tensor, lstate: torch.Tensor,
                tf: bool) -> Tuple[Carry, torch.Tensor]:
        h, c = carry
        if tf:
            h = lstate
        gi, gf, gc, go = torch.chunk(self.wx(laction) + self.wh(h), 4, dim=1)
        ci, cf, co = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        cc = cf * c + ci * torch.tanh(gc)
        ch = co * torch.tanh(cc)
        return (ch, cc), ch
