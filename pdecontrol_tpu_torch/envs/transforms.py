"""Composable, invertible, stateful data transforms (port of
``pdecontrol_tpu/envs/transforms.py``).

Each transform is a small dataclass holding its running statistics as
tensors, with the JAX package's functional interface:

  * ``t.apply(x)``   — forward map (reference ``__call__``),
  * ``t.inverse(x)`` — exact inverse (reference ``.Inverse.__call__``),
  * ``t.update(x)``  — returns a *new* transform with updated statistics
    (a no-op when ``frozen``); the old one is left as it was,
  * ``t.inv``        — an inverted view: apply and inverse swap, and
    ``update`` maps values through the inverse before updating the base
    (pdegym ``common/transforms.py:26-28``).

Reduction-axis conventions follow transforms.py:71-78: ``aggregate`` and
``batched`` select which leading axes the statistics pool over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def _reduce_axes(aggregate: bool, batched: bool, ndim: int) -> Tuple[int, ...]:
    """Reference dim-selection table (transforms.py:71-78, 151-158)."""
    if aggregate and batched:
        return (0, 1, 2)[:ndim]
    if aggregate or batched:
        return (0, 1)[:ndim]
    return (0,)


def _reduced_shape(shape: Sequence[int], axes: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(1 if i in axes else s for i, s in enumerate(shape))


class Transform:
    """Base: identity with no state."""

    def apply(self, values):
        return values

    def inverse(self, values):
        return values

    def update(self, values) -> "Transform":
        return self

    def __call__(self, values):
        return self.apply(values)

    @property
    def inv(self) -> "Transform":
        return Inverted(base=self)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True, eq=False)
class Identity(Transform):
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class Inverted(Transform):
    """Inverted view: swaps apply/inverse; ``update`` maps through the
    inverse first, then updates the base (transforms.py:26-28)."""

    base: Transform = None

    def apply(self, values):
        return self.base.inverse(values)

    def inverse(self, values):
        return self.base.apply(values)

    def update(self, values) -> "Inverted":
        mapped = self.base.inverse(values)
        return self.replace(base=self.base.update(mapped))

    @property
    def inv(self) -> Transform:
        return self.base


@dataclasses.dataclass(frozen=True, eq=False)
class Normalize(Transform):
    """Running mean/variance standardisation (transforms.py:62-138).

    The merge is the reference's parallel-variance update (from gym's
    ``NormalizeObservation``, transforms.py:121-127) with its quirks: the
    count grows by the *batch size* (first axis) however many elements the
    reduction pools, and the batch variance has Bessel's correction.
    """

    mean: torch.Tensor = None
    var: torch.Tensor = None
    count: torch.Tensor = None
    aggregate: bool = False
    batched: bool = False
    frozen: bool = False
    epsilon: float = 1e-4

    @classmethod
    def create(
        cls,
        shape: Sequence[int],
        aggregate: bool = False,
        batched: bool = False,
        frozen: bool = False,
        epsilon: float = 1e-4,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> "Normalize":
        axes = _reduce_axes(aggregate, batched, len(shape))
        rshape = _reduced_shape(shape, axes)
        return cls(
            mean=torch.zeros(rshape, dtype=dtype, device=device),
            var=torch.zeros(rshape, dtype=dtype, device=device),
            count=torch.zeros((), dtype=dtype, device=device),
            aggregate=aggregate,
            batched=batched,
            frozen=frozen,
            epsilon=epsilon,
        )

    @property
    def axes(self) -> Tuple[int, ...]:
        return _reduce_axes(self.aggregate, self.batched, self.mean.ndim)

    def apply(self, values):
        return (values - self.mean) / torch.sqrt(self.var + self.epsilon)

    def inverse(self, values):
        return values * torch.sqrt(self.var + self.epsilon) + self.mean

    def update(self, values) -> "Normalize":
        if self.frozen:
            return self
        axes = self.axes
        bsize = values.shape[0]
        batch_mean = torch.mean(values, dim=axes, keepdim=True)
        batch_var = torch.var(values, dim=axes, keepdim=True, correction=1)

        delta = batch_mean - self.mean
        tot = self.count + bsize
        mean = self.mean + delta * bsize / tot
        m_a = self.var * self.count
        m_b = batch_var * bsize
        m2 = m_a + m_b + torch.square(delta) * self.count * bsize / tot
        return self.replace(mean=mean, var=m2 / tot, count=tot)

    def reset(self) -> "Normalize":
        return self.replace(
            mean=torch.zeros_like(self.mean),
            var=torch.zeros_like(self.var),
            count=torch.zeros_like(self.count),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class Scale(Transform):
    """Running min/max rescaling onto ``[lower, upper]`` (transforms.py:141-210)."""

    vmin: torch.Tensor = None
    vmax: torch.Tensor = None
    lower: torch.Tensor = None
    upper: torch.Tensor = None
    aggregate: bool = False
    batched: bool = False
    frozen: bool = False

    @classmethod
    def create(
        cls,
        shape: Sequence[int],
        scale: Tuple[float, float] = (-1.0, 1.0),
        bounds: Tuple[Any, Any] = (-np.inf, np.inf),
        aggregate: bool = False,
        batched: bool = False,
        frozen: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> "Scale":
        axes = _reduce_axes(aggregate, batched, len(shape))
        rshape = _reduced_shape(shape, axes)
        vmin = np.broadcast_to(np.asarray(bounds[0], dtype=np.float64), shape)
        vmax = np.broadcast_to(np.asarray(bounds[1], dtype=np.float64), shape)
        # Known bounds are pooled onto the reduced shape (transforms.py:168-170).
        vmin = np.min(vmin, axis=axes, keepdims=True) + np.zeros(rshape)
        vmax = np.max(vmax, axis=axes, keepdims=True) + np.zeros(rshape)
        # Unknown (infinite) bounds become opposite-sign sentinels so the
        # running min/max update can tighten them (transforms.py:186-194).
        vmin = np.where(np.isneginf(vmin), np.inf, vmin)
        vmax = np.where(np.isposinf(vmax), -np.inf, vmax)

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        return cls(
            vmin=t(vmin),
            vmax=t(vmax),
            lower=t(scale[0]),
            upper=t(scale[1]),
            aggregate=aggregate,
            batched=batched,
            frozen=frozen,
        )

    @property
    def axes(self) -> Tuple[int, ...]:
        return _reduce_axes(self.aggregate, self.batched, self.vmin.ndim)

    def apply(self, values):
        return (values - self.vmin) / (self.vmax - self.vmin) * (
            self.upper - self.lower
        ) + self.lower

    def inverse(self, values):
        return (values - self.lower) / (self.upper - self.lower) * (
            self.vmax - self.vmin
        ) + self.vmin

    def update(self, values) -> "Scale":
        if self.frozen:
            return self
        axes = self.axes
        vmin = torch.minimum(torch.amin(values, dim=axes, keepdim=True), self.vmin)
        vmax = torch.maximum(torch.amax(values, dim=axes, keepdim=True), self.vmax)
        return self.replace(vmin=vmin, vmax=vmax)


@dataclasses.dataclass(frozen=True, eq=False)
class Sensor(Transform):
    """Strided spatial subsampling (transforms.py:231-247).  Invertible only
    for stride 1 (identity), matching the reference."""

    stride: int = 1

    def apply(self, values):
        return values[..., self.stride // 2 :: self.stride]

    def inverse(self, values):
        if self.stride > 1:
            raise NotImplementedError("Sensor inverse undefined for stride > 1")
        return values


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianForcing(Transform):
    """Action coefficients -> spatial forcing field, with exact inverse.

    ``apply(a) = a @ F`` where ``F[j] = exp(-(x - xi_j)^2 / (2 sigma^2)) /
    sqrt(2 pi sigma)`` (transforms.py:258-260, the reference's
    ``sqrt(2*pi*sigma)`` normalisation quirk kept).  The inverse reads the
    field at the jet centres and multiplies by the inverse of the
    ``[jets, jets]`` sub-matrix (transforms.py:267-279).
    """

    matrix: torch.Tensor = None  # [jets, N]
    inv_matrix: torch.Tensor = None  # [jets, jets]
    jet_idx: torch.Tensor = None  # [jets] int64

    @classmethod
    def create(
        cls,
        n: int,
        length: float,
        xi_rel: Sequence[float],
        sigma: float,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
        zero_mean: bool = False,
    ) -> "GaussianForcing":
        """``zero_mean=True`` subtracts each jet's spatial mean from its row
        of the forcing matrix, which makes the actuation conserve momentum
        (the Burgers env needs it to stay well-posed under sustained
        forcing; the KS env keeps the reference's raw jets).  The exact
        inverse is computed from the modified matrix."""
        from pdecontrol_tpu_torch.ops.kuramoto import gaussian_forcing_matrix

        x = np.linspace(0.0, length - length / n, n, dtype=np.float64)
        mat = gaussian_forcing_matrix(x, np.asarray(xi_rel), sigma, length)
        if zero_mean:
            mat = mat - mat.mean(axis=1, keepdims=True)
        jet_idx = (n * np.asarray(xi_rel, dtype=np.float64)).astype(np.int64)
        inv = np.linalg.inv(mat[:, jet_idx])
        return cls(
            matrix=torch.as_tensor(mat, dtype=dtype, device=device),
            inv_matrix=torch.as_tensor(inv, dtype=dtype, device=device),
            jet_idx=torch.as_tensor(jet_idx, device=device),
        )

    def apply(self, values):
        return values @ self.matrix

    def inverse(self, values):
        return values[..., self.jet_idx] @ self.inv_matrix


@dataclasses.dataclass(frozen=True, eq=False)
class Chain(Transform):
    """Sequential composition (reference ``Operation``, transforms.py:310-341).

    ``apply`` runs left-to-right; ``inverse`` runs the inverses right-to-left;
    ``update`` performs the reference's update-then-apply sweep so that later
    transforms see already-transformed values (transforms.py:322-328).
    """

    transforms: Tuple[Transform, ...] = ()

    def apply(self, values):
        for t in self.transforms:
            values = t.apply(values)
        return values

    def inverse(self, values):
        for t in reversed(self.transforms):
            values = t.inverse(values)
        return values

    def update(self, values) -> "Chain":
        new = []
        for t in self.transforms:
            t = t.update(values)
            values = t.apply(values)
            new.append(t)
        return self.replace(transforms=tuple(new))


@dataclasses.dataclass(frozen=True, eq=False)
class FuncTransform(Transform):
    """Wraps a pure function pair (reference ``FuncTransform``,
    transforms.py:213-228).  Stateless."""

    fn: Optional[Callable] = None
    inv_fn: Optional[Callable] = None

    def apply(self, *args):
        return self.fn(*args)

    def inverse(self, *args):
        if self.inv_fn is None:
            raise NotImplementedError
        return self.inv_fn(*args)


@dataclasses.dataclass(frozen=True, eq=False)
class SampleTransform:
    """Applies an obs-chain to obs/nxtobs and an action-chain to actions of a
    ``Sample`` (reference transforms.py:344-374)."""

    otransf: Transform = Identity()
    atransf: Transform = Identity()

    def __call__(self, sample):
        return dataclasses.replace(
            sample,
            obs=self.otransf.apply(sample.obs),
            nxtobs=self.otransf.apply(sample.nxtobs),
            actions=self.atransf.apply(sample.actions),
        )

    def apply(self, sample):
        return self(sample)

    @property
    def inv(self) -> "SampleTransform":
        return SampleTransform(otransf=self.otransf.inv, atransf=self.atransf.inv)
