"""Architecture factories + string registry (port of
``pdecontrol_tpu/models/factories.py``; reference ``architectures/``).

A factory name (CLI ``--factory``) resolves to a builder returning a
configured ``PDESurrogate`` plus a ``defaults`` config tree that CLI JSON
overrides merge onto (reference ``PDESurrogateFactory.defaults``,
factory.py:19-34).  Only the main model, ``KSAutoRegConvolutionalLSTM``, is
ported so far.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch.nn.functional as F

from pdecontrol_tpu_torch.models import blocks as B
from pdecontrol_tpu_torch.models import transition as Tr
from pdecontrol_tpu_torch.models.surrogate import AUTOREG, PDESurrogate


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
        raise NotImplementedError(
            f"factory {name!r} is not yet ported; have {sorted(REGISTRY)}"
        )
    return REGISTRY[name].build(delta=delta, **kwargs)


def _conv_lstm_parts(N: int = 64, state_channels: int = 1, action_channels: int = 1):
    """Encoder/decoder/cell of the conv-LSTM family
    (architectures/autoreg.py:49-101): encoder 8/16/16, action encoder
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
    """Main model (architectures/autoreg.py:44-101).  The world action is the
    scaled forcing field, one channel on the N-point grid."""
    enc, dec, aenc, cell = _conv_lstm_parts(N=N)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=AUTOREG,
    )
