"""Plain conv-LSTM surrogate of the two KS families (the ECC'24 reference's
``architectures/autoreg.py:44-101`` and ``architectures/latent.py:10-67``),
written as functions of a flat parameter vector.

Per frame of ``[B, 1, n]``: a state encoder of three residual blocks
(8, 16, 16 channels, strides 2, 2, 1), an action encoder of three (2, 4,
4), a 16-channel convolutional LSTM cell on the ``n / 4`` latent grid, and
a decoder of two stride-2 transposed convolutions (16, 8) and two
convolutions (kernel 7 to 1 channel, kernel 5 to 1 channel, the last with
no activation and no norm).  Every convolution wraps the periodic grid
(``(k-1)//2`` points on the left, ``k//2`` on the right, then a valid
strided correlation); the transposed ones are zero padded, flax's ``SAME``.
Activations are SiLU; each norm is a LayerNorm over the grid axis with a
learned scale and bias per point, epsilon 1e-5.  The residual blocks have
no bias; the cell's input convolution has one, its hidden convolution none.

AUTOREG integrates in state space, ``u_{t+1} = u_t + delta * d(dec(h))``
with ``d`` the delta scaling's inverse, anchored on the ground truth during
the warmup; LATENT integrates the latent, ``z_{t+1} = z_t + delta * h``,
and decodes every step.  ``reencode`` marks steps at which the rollout
re-encodes its own detached output and detaches the carried hidden state.

The flat vector's layout (``layout``) is the order in which the modules
declare their parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

AUTOREG, LATENT = "autoreg", "latent"
FAMILIES = {"KSAutoRegConvolutionalLSTM": AUTOREG, "KSLatentConvolutionalLSTM": LATENT}


def _residual(prefix: str, cin: int, cout: int, size: int, stride: int):
    out = (size - 1) // stride + 1
    return [(prefix + "skip.weight", (cout, cin, 1)),
            (prefix + "conv_l1.weight", (cout, cin, 3)),
            (prefix + "conv_l2.weight", (cout, cout, 3)),
            (prefix + "norm_l1.weight", (out,)), (prefix + "norm_l1.bias", (out,)),
            (prefix + "norm_l2.weight", (out,)), (prefix + "norm_l2.bias", (out,)),
            (prefix + "norm_skip.weight", (out,)), (prefix + "norm_skip.bias", (out,))], out


def _encoder(prefix: str, features: Sequence[int], size: int):
    spec, cin = [], 1
    for i, (cout, stride) in enumerate(zip(features, (2, 2, 1))):
        block, size = _residual(f"{prefix}blocks.{i}.", cin, cout, size, stride)
        spec += block
        cin = cout
    return spec, size


def layout(n: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in the flat vector's order."""
    enc, lat = _encoder("state_encoder.", (8, 16, 16), n)
    dec = [("state_decoder.blocks.0.weight", (16, 16, 3)), ("state_decoder.blocks.0.bias", (16,)),
           ("state_decoder.blocks.0.norm.weight", (2 * lat,)),
           ("state_decoder.blocks.0.norm.bias", (2 * lat,)),
           ("state_decoder.blocks.1.weight", (16, 8, 3)), ("state_decoder.blocks.1.bias", (8,)),
           ("state_decoder.blocks.1.norm.weight", (4 * lat,)),
           ("state_decoder.blocks.1.norm.bias", (4 * lat,)),
           ("state_decoder.blocks.2.conv.weight", (1, 8, 7)),
           ("state_decoder.blocks.2.conv.bias", (1,)),
           ("state_decoder.blocks.2.norm.weight", (4 * lat,)),
           ("state_decoder.blocks.2.norm.bias", (4 * lat,)),
           ("state_decoder.blocks.3.conv.weight", (1, 1, 5)),
           ("state_decoder.blocks.3.conv.bias", (1,))]
    aenc, _ = _encoder("action_encoder.", (2, 4, 4), n)
    cell = [("cell.wx.weight", (64, 4, 3)), ("cell.wx.bias", (64,)),
            ("cell.wh.weight", (64, 16, 3))]
    return enc + dec + aenc + cell


def unflatten(flat: torch.Tensor, n: int) -> Dict[str, torch.Tensor]:
    """The parameters of one member's flat vector [P] as views by name."""
    out, offset = {}, 0
    for name, shape in layout(n):
        size = int(np.prod(shape))
        out[name] = flat[offset: offset + size].view(shape)
        offset += size
    if offset != flat.shape[-1]:
        raise ValueError(f"the layout holds {offset} parameters, the vector {flat.shape[-1]}")
    return out


# ------------------------------------------------------------------ layers
def conv(x, w, b=None, stride: int = 1):
    k = w.shape[-1]
    if k > 1:
        x = F.pad(x, ((k - 1) // 2, k // 2), mode="circular")
    return F.conv1d(x, w, b, stride=stride)


def norm(x, p, prefix):
    return F.layer_norm(x, (x.shape[-1],), p[prefix + ".weight"], p[prefix + ".bias"], 1e-5)


def residual(x, p, prefix: str, stride: int):
    skip = conv(x, p[prefix + "skip.weight"], None, stride)
    out = norm(F.silu(conv(x, p[prefix + "conv_l1.weight"], None, stride)), p, prefix + "norm_l1")
    out = norm(F.silu(conv(out, p[prefix + "conv_l2.weight"])), p, prefix + "norm_l2")
    return norm(out + skip, p, prefix + "norm_skip")


def encode(x, p, prefix: str):
    for i, stride in enumerate((2, 2, 1)):
        x = residual(x, p, f"{prefix}blocks.{i}.", stride)
    return x


def deconv(x, w, b):
    """Stride-2 transposed convolution, kernel 3, flax ``SAME``: of torch's
    ``2H + 1`` outputs the first ``2H``."""
    y = F.conv_transpose1d(x, w, b, stride=2)
    return y[..., : 2 * x.shape[-1]]


def decode(x, p):
    q = "state_decoder.blocks."
    x = norm(F.silu(deconv(x, p[q + "0.weight"], p[q + "0.bias"])), p, q + "0.norm")
    x = norm(F.silu(deconv(x, p[q + "1.weight"], p[q + "1.bias"])), p, q + "1.norm")
    x = norm(F.silu(conv(x, p[q + "2.conv.weight"], p[q + "2.conv.bias"])), p, q + "2.norm")
    return conv(x, p[q + "3.conv.weight"], p[q + "3.conv.bias"])


def cell(hidden, laction, lstate, force: bool, p):
    h, c = hidden
    if force:
        h = lstate
    gates = conv(laction, p["cell.wx.weight"], p["cell.wx.bias"]) + conv(h, p["cell.wh.weight"])
    gi, gf, gc, go = torch.chunk(gates, 4, dim=1)
    c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
    h = torch.sigmoid(go) * torch.tanh(c)
    return (h, c), h


def frames(fn, x):
    """``fn`` over [B, T, C, H] with time folded into the batch."""
    b, t = x.shape[:2]
    y = fn(x.reshape((b * t,) + tuple(x.shape[2:])))
    return y.reshape((b, t) + tuple(y.shape[1:]))


# ----------------------------------------------------------------- rollout
def rollout(p: Dict[str, torch.Tensor], mode: str, states, actions, delta: float,
            d_mean, d_std, hidden=None, reencode: Optional[np.ndarray] = None):
    """Teacher-force over the ``Tw`` frames of ``states`` [B, Tw, 1, n], then
    run free to the length of ``actions`` [B, T, 1, n] (world space).
    ``d_mean`` and ``d_std`` undo the delta scaling (``x * std + mean``).
    Returns (outputs [B, T, 1, n], deltas [B, T, 1, n], hidden)."""
    b, tw = states.shape[:2]
    t_total = actions.shape[1]
    flags = np.zeros(t_total, bool) if reencode is None else np.asarray(reencode, bool)
    lstates = frames(lambda x: encode(x, p, "state_encoder."), states)
    lactions = frames(lambda x: encode(x, p, "action_encoder."), actions)
    if hidden is None:
        z = torch.zeros((b, 16) + tuple(lstates.shape[3:]), dtype=states.dtype,
                        device=states.device)
        hidden = (z, z)
    outputs, deltas = [], []
    if mode == AUTOREG:
        prev = states[:, 0]
        for t in range(t_total):
            force, re = t < tw, bool(flags[t])
            if re:
                prev = prev.detach()
                hidden = tuple(h.detach() for h in hidden)
            if force:
                lstate = lstates[:, t]
            elif re:
                lstate = encode(prev.detach(), p, "state_encoder.")
            else:
                lstate = None  # a free-running cell ignores it
            hidden, out_lat = cell(hidden, lactions[:, t], lstate, force or re, p)
            d = decode(out_lat, p)
            base = states[:, t] if force else prev
            prev = base + delta * (d * d_std + d_mean)
            outputs.append(prev)
            deltas.append(d)
        return torch.stack(outputs, 1), torch.stack(deltas, 1), hidden
    latent, prev = lstates[:, 0], states[:, 0]
    for t in range(t_total):
        force, re = t < tw, bool(flags[t])
        if re:
            latent = encode(prev.detach(), p, "state_encoder.")
            hidden = tuple(h.detach() for h in hidden)
        hidden, out_lat = cell(hidden, lactions[:, t], lstates[:, t] if force else latent,
                               force or re, p)
        latent = latent + delta * out_lat
        prev = decode(latent, p)
        outputs.append(prev)
    outputs = torch.stack(outputs, 1)
    steps = torch.diff(torch.cat([states[:, :1], outputs], dim=1), dim=1) / delta
    return outputs, (steps - d_mean) / d_std, hidden
