"""Carry parameters of the JAX package over into the port.

The inputs are flax parameter trees as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``); the outputs are ``state_dict``s
of the port's modules.  Layout rules:

  * a flax ``Conv`` kernel is ``[W, in, out]``; a torch ``Conv1d`` weight
    (``CircularConv1d``) is ``[out, in, W]``;
  * a flax ``ConvTranspose`` kernel is ``[W, in, out]`` and is applied
    unflipped; ``DeConvBlock`` holds ``[in, out, W]`` flipped along W;
  * a flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear`` weight is
    ``[out, in]``;
  * ``SpatialLayerNorm``'s ``scale``/``bias`` of shape ``(H, 1)`` become a
    LayerNorm ``weight``/``bias`` of shape ``(H,)``;
  * flax submodule names map onto the port's attributes: ``block_l{i}`` ->
    ``blocks.{i}``, ``Conv_0`` -> ``conv``, ``SpatialLayerNorm_0`` ->
    ``norm``, a ``ConvTranspose_0`` holds the ``DeConvBlock``'s own weight
    and bias, and of an ``MLP`` ``linear_l{i}`` -> ``layers.{i}`` with its
    ``Dense_0`` -> ``linear``.  The cells' ``wx`` and ``wh`` and the
    ``DelayCell``'s ``fwd`` keep their names.

``stacked_trainer_state`` carries a whole stacked ensemble trainer state
over (every member's parameters and Adam moments, by the same rules).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C", copy=True))


def _module_path(names: List[str]) -> List[str]:
    out = []
    for name in names:
        m = re.fullmatch(r"(block|linear)_l(\d+)", name)
        if m:
            out += ["blocks" if m.group(1) == "block" else "layers", m.group(2)]
        elif name == "Dense_0":
            out.append("linear")
        elif name == "Conv_0":
            out.append("conv")
        elif name == "SpatialLayerNorm_0":
            out.append("norm")
        elif name == "ConvTranspose_0":
            pass  # the DeConvBlock's own parameters
        else:
            out.append(name)
    return out


def _convert_leaf(parent: str, leaf: str, x: np.ndarray):
    x = np.asarray(x)
    if leaf == "kernel":
        if parent == "ConvTranspose_0":
            return "weight", x.transpose(1, 2, 0)[..., ::-1]
        if x.ndim == 3:
            return "weight", x.transpose(2, 1, 0)
        return "weight", x.T
    if leaf == "scale":
        return "weight", x.reshape(-1)
    if leaf == "bias":
        return "bias", x.reshape(-1)
    raise KeyError(f"unexpected flax parameter {parent}/{leaf}")


def _walk(tree: Mapping, names: List[str], out: StateDict) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, names + [key], out)
        else:
            torch_name, arr = _convert_leaf(names[-1] if names else "", key, value)
            out[".".join(_module_path(names) + [torch_name])] = _tensor(arr)


def state_dict(params: Mapping) -> StateDict:
    """One module's parameters: a surrogate of any of the five factories
    (``PDESurrogate``), the SAC ``GaussianPolicy`` (``linear1``,
    ``linear2``, ``mean``, ``log_std``) or the twin ``QNetwork``
    (``linear1`` .. ``linear6``)."""
    out: StateDict = {}
    _walk(params, [], out)
    return out


def ensemble_state_dicts(stacked: Mapping) -> List[StateDict]:
    """The JAX ensemble's stacked parameters (leading member axis) -> one
    ``state_dict`` per member of ``EnsembleState.members``."""

    def leaves(tree):
        for v in tree.values():
            if isinstance(v, Mapping):
                yield from leaves(v)
            else:
                yield v

    m = np.asarray(next(leaves(stacked))).shape[0]

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in tree.items()}

    return [state_dict(take(stacked, i)) for i in range(m)]


def stacked_trainer_state(modules, params: Mapping, mu: Mapping, nu: Mapping,
                          count, global_step):
    """The JAX package's stacked ``TrainerState`` (leading member axis M on
    every leaf: flax ``params``, optax ``ScaleByAdamState`` ``mu``, ``nu``
    and ``count``, and ``global_step``, as numpy arrays) -> the port's
    stacked ``train.trainer.TrainerState`` over ``modules`` (M fresh
    surrogates of the same factory, in their final dtype and device).
    Parameters and moments follow the layout rules above; the modules'
    parameters are loaded and become views of the state's ``params``."""
    from pdecontrol_tpu_torch.models.surrogate import stack_parameters
    from pdecontrol_tpu_torch.train.trainer import TrainerState

    for module, sd in zip(modules, ensemble_state_dicts(params), strict=True):
        module.load_state_dict(sd, strict=True)
    flat = stack_parameters(modules)

    def stacked(tree):
        rows = [torch.cat([sd[name].reshape(-1) for name, _ in modules[0].named_parameters()])
                for sd in ensemble_state_dicts(tree)]
        return torch.stack(rows).to(flat)

    def counter(x):
        return torch.as_tensor(np.array(x), dtype=torch.int32, device=flat.device)

    return TrainerState(list(modules), flat, stacked(mu), stacked(nu), counter(count),
                        counter(global_step))
