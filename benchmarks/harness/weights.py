"""Starting weights the benchmark makes from the seed, on the device, in
one draw: every surrogate member's parameters in the flat order of
``reference.surrogate.layout``, drawn as PyTorch's layers draw theirs
(weights and biases uniform in +-1/sqrt(fan_in), the weight's fan-in; a
norm's scale 1 and shift 0).  The program is handed them, and the plain
reference starts from the same tensor."""

from __future__ import annotations

import math

import torch

from benchmarks.reference.surrogate import layout


def surrogate(n: int, members: int, seed: int, device) -> torch.Tensor:
    """``[members, P]`` float32 from ``seed``."""
    scale, fill, fan = [], [], None
    for name, shape in layout(n):
        size = math.prod(shape)
        if ".norm" in name:
            scale.append(torch.zeros(size))
            fill.append(torch.full((size,), 1.0 if name.endswith("weight") else 0.0))
            continue
        if name.endswith("weight"):
            fan = math.prod(shape[1:])
        scale.append(torch.full((size,), 1.0 / math.sqrt(fan)))
        fill.append(torch.zeros(size))
    scale, fill = torch.cat(scale).to(device), torch.cat(fill).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    draw = torch.rand((members, scale.numel()), generator=gen, device=device)
    return (2 * draw - 1) * scale + fill
