"""The device an entry point of the port runs on.

An entry point (the MBPO controller, the SAC trainer, the attractor gate)
runs on the GPU unless its caller asks for the CPU with ``--platform cpu``
or ``device="cpu"``.  Without a CUDA device it raises: it never carries on
quietly on the CPU.  Library constructors that take an explicit ``device``
(``KSOperators.create``, ``KuramotoSivashinsky.create``, the modules) keep
PyTorch's usual default instead.
"""

from __future__ import annotations

import argparse
from typing import Optional, Union

import torch

PLATFORMS = ("cpu", "gpu", "cuda")


def add_platform_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--platform", type=str, default=None, choices=PLATFORMS,
                        help="device to run on (default: the GPU; without one the run "
                             "stops, and only --platform cpu runs it on the CPU)")


def platform_device(platform: Optional[str]) -> Optional[str]:
    """The device named by a ``--platform`` value (``None`` stays ``None``)."""
    if platform is None:
        return None
    return "cpu" if platform == "cpu" else "cuda"


def entry_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``device``, where ``None`` means the GPU; raises if that is a CUDA
    device and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless asked for the CPU; "
            "pass --platform cpu (or device=\"cpu\") to run on the CPU"
        )
    return dev
