"""Latent transition cells (port of ``pdecontrol_tpu/models/transition.py``;
reference ``surrogates/transition.py``).

A cell maps ``(carry, laction, lstate, tf) -> (carry, outlatent)``.  When
``tf`` (teacher forcing) is true the hidden state ``H`` is *overwritten*
with the provided latent before the gate update (transition.py:83,276-277);
when false the cell free-runs and ignores ``lstate``, like the reference's
``transition`` methods.  The ``DelayCell`` instead pushes ``lstate`` into
its history buffer in both modes (transition.py:334-382).  Initial carries
are zeros (the reference's non-learnable ``H0``/``C0``).

The JAX package's unfused ``CNNLSTMCell(fused=False)`` and
``fuse_cnn_lstm_params`` exist there only for its own equivalence test and
have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pdecontrol_tpu_torch.models.blocks import CircularConv1d, lecun_normal_

Carry = Tuple[torch.Tensor, torch.Tensor]


class LSTMCell(nn.Module):
    """Flattened-input LSTM (reference ``LSTMTransitionModel``,
    transition.py:34-109).  Latent states/actions ``[B, C, H]`` are flattened
    to vectors; hidden size = schannels * ssize.  ``wx`` has a bias, ``wh``
    none; gate order (i, f, g, o).  ``in_features`` is the flattened latent
    action's length."""

    needs_prev_latent = False

    def __init__(self, in_features: int, schannels: int = 1, ssize: int = 16):
        super().__init__()
        self.schannels, self.ssize = schannels, ssize
        hidden = self.hidden_size
        self.wx = nn.Linear(in_features, 4 * hidden)
        self.wh = nn.Linear(hidden, 4 * hidden, bias=False)
        lecun_normal_(self.wx.weight, in_features)
        nn.init.zeros_(self.wx.bias)
        lecun_normal_(self.wh.weight, hidden)

    @property
    def hidden_size(self) -> int:
        return self.schannels * self.ssize

    def init_carry(self, batch: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Carry:
        z = torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)
        return (z, z)

    def forward(self, carry: Carry, laction: torch.Tensor, lstate: torch.Tensor,
                tf: bool) -> Tuple[Carry, torch.Tensor]:
        h, c = carry
        b = laction.shape[0]
        if tf:
            h = lstate.reshape(b, -1)
        gates = self.wx(laction.reshape(b, -1)) + self.wh(h)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h.reshape(b, self.schannels, self.ssize)


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


class DelayCell(nn.Module):
    """Fixed-delay history MLP (reference ``DelayTransitionModel``,
    transition.py:299-382): buffers of the last ``delay`` latent states and
    actions, newest last, fed through the MLP ``fwd``.  ``lstate`` is pushed
    in both modes and ``tf`` is ignored."""

    needs_prev_latent = True

    def __init__(self, fwd: nn.Module, schannels: int = 8, ssize: int = 8,
                 achannels: int = 4, asize: int = 8, delay: int = 3):
        super().__init__()
        self.schannels, self.ssize = schannels, ssize
        self.achannels, self.asize = achannels, asize
        self.delay = delay
        self.fwd = fwd

    def init_carry(self, batch: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Carry:
        s = torch.zeros((batch, self.delay, self.schannels, self.ssize),
                        dtype=dtype, device=device)
        a = torch.zeros((batch, self.delay, self.achannels, self.asize),
                        dtype=dtype, device=device)
        return (s, a)

    def forward(self, carry: Carry, laction: torch.Tensor, lstate: torch.Tensor,
                tf: bool) -> Tuple[Carry, torch.Tensor]:
        sctx, actx = carry
        # Write into slot 0, then roll left: the oldest entry drops out and
        # the newest ends at slot -1 (transition.py:348-353).
        sctx = torch.cat([sctx[:, 1:], lstate[:, None]], dim=1)
        actx = torch.cat([actx[:, 1:], laction[:, None]], dim=1)

        b = sctx.shape[0]
        augmented = torch.cat((sctx, actx), dim=2)
        augmented = augmented.reshape(
            b, self.delay * (self.schannels + self.achannels), self.ssize)
        out = self.fwd(augmented).reshape(b, self.schannels, self.ssize)
        return (sctx, actx), out
