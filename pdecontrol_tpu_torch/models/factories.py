"""Architecture factories + string registry (port of
``pdecontrol_tpu/models/factories.py``; reference ``architectures/``).

A factory name (CLI ``--factory``) resolves to a builder returning a
configured ``PDESurrogate`` plus a ``defaults`` config tree that CLI JSON
overrides merge onto (reference ``PDESurrogateFactory.defaults``,
factory.py:19-34).  The five model families of the reference's
``architectures/{autoreg,latent,delay}.py``.  The world action is the
scaled forcing field: one channel on the N-point grid.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from pdecontrol_tpu_torch.models import blocks as B
from pdecontrol_tpu_torch.models import transition as Tr
from pdecontrol_tpu_torch.models.surrogate import AUTOREG, LATENT, PDESurrogate


@dataclass
class Factory:
    """Named surrogate builder with default config tree."""

    name: str
    build: Callable[..., PDESurrogate]
    defaults: Dict = field(
        default_factory=lambda: {
            "model": {},
            "surrogate": {},
            "training": {},
            "trainer": {},
            "curriculum": {},
        }
    )


REGISTRY: Dict[str, Factory] = {}


def register(name: str):
    def wrap(fn):
        REGISTRY[name] = Factory(name=name, build=fn)
        return fn

    return wrap


def make(name: str, delta: float, **kwargs) -> PDESurrogate:
    if name not in REGISTRY:
        raise KeyError(f"unknown factory {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name].build(delta=delta, **kwargs)


def _conv_lstm_parts(N: int = 64, state_channels: int = 1, action_channels: int = 1):
    """Shared encoder/decoder/cell of the conv-LSTM families
    (architectures/autoreg.py:49-101, latent.py:16-60): encoder 8/16/16, action encoder
    2/4/4, decoder 16/8/1/1 and a 16-channel CNN-LSTM on the N/4 latent grid."""
    state_encoder = B.ConvNet(
        blocks=[B.ResidualBlock] * 3,
        features=[8, 16, 16],
        in_channels=state_channels,
        size=N,
        kernel_size=[3, 3, 3],
        stride=[2, 2, 1],
        activation=[F.silu] * 3,
        layernorm=[True] * 3,
    )
    action_encoder = B.ConvNet(
        blocks=[B.ResidualBlock] * 3,
        features=[2, 4, 4],
        in_channels=action_channels,
        size=N,
        kernel_size=[3, 3, 3],
        stride=[2, 2, 1],
        activation=[F.silu] * 3,
        layernorm=[True] * 3,
    )
    lat = state_encoder.out_size
    state_decoder = B.ConvNet(
        blocks=[B.DeConvBlock, B.DeConvBlock, B.ConvBlock, B.ConvBlock],
        features=[16, 8, 1, 1],
        in_channels=16,
        size=lat,
        kernel_size=[3, 3, 7, 5],
        stride=[2, 2, 1, 1],
        activation=[F.silu, F.silu, F.silu, B.identity],
        layernorm=[True, True, True, False],
    )
    cell = Tr.CNNLSTMCell(action_encoder.out_channels, schannels=16, ssize=lat)
    return state_encoder, state_decoder, action_encoder, cell


@register("KSAutoRegConvolutionalLSTM")
def ks_autoreg_conv_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Main model (architectures/autoreg.py:44-101)."""
    enc, dec, aenc, cell = _conv_lstm_parts(N=N)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=AUTOREG,
    )


@register("KSLatentConvolutionalLSTM")
def ks_latent_conv_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Hard-encoded-IC ablation (architectures/latent.py:10-67)."""
    enc, dec, aenc, cell = _conv_lstm_parts(N=N)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=LATENT,
    )


def _fc_lstm(delta: float, N: int, mode: str, hidden_act, out_act) -> PDESurrogate:
    """Fully connected encoder N -> N/2 -> N/4, decoder N/4 -> N/2 -> N, the
    raw action field into a flattened LSTM of N/4 units."""
    enc = B.MLP(1, N, sizes=[(1, N // 2), (1, N // 4)], activations=[hidden_act] * 2)
    dec = B.MLP(1, N // 4, sizes=[(1, N // 2), (1, N)], activations=[hidden_act, out_act])
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=B.IdentityModule(),
        cell=Tr.LSTMCell(N, schannels=1, ssize=N // 4), delta=delta, mode=mode,
    )


@register("KSAutoRegFullyConnectedLSTM")
def ks_autoreg_fc_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Spatial/temporal locality ablation (architectures/autoreg.py:10-41)."""
    return _fc_lstm(delta, N, AUTOREG, F.silu, torch.tanh)


@register("KSLatentLSTM")
def ks_latent_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Fully-connected LSTM baseline (architectures/latent.py:70-101)."""
    return _fc_lstm(delta, N, LATENT, F.elu, B.identity)


@register("KSDelayCNNSurrogateFactory")
def ks_delay_cnn(delta: float, N: int = 64, delay: int = 3, **kwargs) -> PDESurrogate:
    """Delay-history model (architectures/delay.py:19-79)."""
    enc = B.ConvNet(
        blocks=[B.ResidualBlock] * 3,
        features=[1, 4, 8],
        in_channels=1,
        size=N,
        kernel_size=[3, 3, 3],
        stride=[2, 2, 2],
        activation=[F.elu, F.elu, torch.tanh],
        layernorm=[True, True, False],
    )
    lat = enc.out_size  # three stride-2 stages
    dec = B.ConvNet(
        blocks=[B.DeConvBlock, B.DeConvBlock, B.DeConvBlock, B.ConvBlock],
        features=[8, 4, 1, 1],
        in_channels=8,
        size=lat,
        kernel_size=[3, 3, 3, 5],
        stride=[2, 2, 2, 1],
        activation=[F.elu, F.elu, F.elu, torch.tanh],
        layernorm=[True, True, False, False],
    )
    aenc = B.MLP(1, N, sizes=[(4, 4), (4, lat)], activations=[F.elu, torch.tanh])
    fwd = B.MLP(
        delay * (8 + 4), lat,
        sizes=[(12, lat), (8, lat), (8, lat)],
        activations=[F.elu, F.elu, torch.tanh],
    )
    cell = Tr.DelayCell(fwd, schannels=8, ssize=lat, achannels=4, asize=lat, delay=delay)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=AUTOREG,
    )
