"""Visualisation module (reference ``pdecontrol/visualize.py`` +
``pdegym/visual.py``): spacetime diagnostics for PDE trajectories and
surrogate predictions, returned as PIL images for logging.

Plot families:
  * ``pdeplot``  — truth / prediction / actions / squared error / reward
    curves (visualize.py:6-19 five-panel layout).
  * ``spatial``  — per-field spacetime heatmaps, e.g. predicted vs target
    deltas (visualize.py:21-68).
  * ``epplot``   — single-episode heatmap + action traces + reward curve
    (visualize.py:70-90).
  * ``hstepplot``— loss as a function of open-loop horizon step
    (visualize.py:92-121).
  * ``trisurf``  — 3-D surface of a trajectory (pdegym/visual.py:7-53).

A copy of ``pdecontrol_tpu.viz.plots`` (numpy, matplotlib and PIL only).
It imports matplotlib when it is imported, so the controller imports it
inside the background job that renders, never at its own import.
"""

from __future__ import annotations

import io
from typing import Dict, Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from PIL import Image  # noqa: E402


def _to_image(fig) -> Image.Image:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", dpi=110)
    plt.close(fig)
    buf.seek(0)
    return Image.open(buf).copy()


def _squeeze2d(x) -> np.ndarray:
    x = np.asarray(x)
    while x.ndim > 2:
        x = np.squeeze(x, axis=-2) if x.shape[-2] == 1 else x.reshape(
            x.shape[0], -1
        )
    return x


def pdeplot(obs, opred, actions, rewards=None, rpred=None) -> Image.Image:
    """Truth / prediction / actions / squared error (+ reward curves)."""
    obs, opred = _squeeze2d(obs), _squeeze2d(opred)
    actions = _squeeze2d(actions)
    nrows = 5 if rewards is not None else 4
    fig, axes = plt.subplots(nrows, 1, figsize=(8, 2.1 * nrows), sharex=True)

    for ax, field, title in (
        (axes[0], obs.T, "PDE solution"),
        (axes[1], opred.T, "Surrogate prediction"),
        (axes[2], actions.T, "Actions"),
        (axes[3], ((obs - opred) ** 2).T, "Squared error"),
    ):
        im = ax.imshow(field, aspect="auto", origin="lower", cmap="RdBu_r",
                       interpolation="nearest")
        ax.set_title(title, fontsize=9)
        fig.colorbar(im, ax=ax, pad=0.01)

    if rewards is not None:
        axes[4].plot(np.asarray(rewards).reshape(-1), label="reward")
        if rpred is not None:
            axes[4].plot(np.asarray(rpred).reshape(-1), label="predicted")
        axes[4].legend(fontsize=8)
        axes[4].set_title("Reward", fontsize=9)
    axes[-1].set_xlabel("step")
    return _to_image(fig)


def spatial(fields: Dict[str, np.ndarray]) -> Image.Image:
    """Spacetime heatmaps for named fields (e.g. outdeltas vs deltas)."""
    n = len(fields)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2.2 * n), sharex=True)
    if n == 1:
        axes = [axes]
    for ax, (name, field) in zip(axes, fields.items()):
        field = _squeeze2d(field)
        im = ax.imshow(field.T, aspect="auto", origin="lower", cmap="RdBu_r")
        ax.set_title(name, fontsize=9)
        fig.colorbar(im, ax=ax, pad=0.01)
    return _to_image(fig)


def epplot(obs, actions, rewards) -> Image.Image:
    """One episode: field heatmap + action traces + reward curve."""
    obs, actions = _squeeze2d(obs), _squeeze2d(actions)
    fig, axes = plt.subplots(3, 1, figsize=(8, 7), sharex=True)
    im = axes[0].imshow(obs.T, aspect="auto", origin="lower", cmap="RdBu_r")
    axes[0].set_title("episode", fontsize=9)
    fig.colorbar(im, ax=axes[0], pad=0.01)
    axes[1].plot(actions)
    axes[1].set_title("actions", fontsize=9)
    axes[2].plot(np.asarray(rewards).reshape(-1))
    axes[2].set_title("reward", fontsize=9)
    axes[2].set_xlabel("step")
    return _to_image(fig)


def hstepplot(hsteploss: Sequence[float], label: str = "loss") -> Image.Image:
    """Loss vs open-loop horizon step (h-step loss curve)."""
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(np.asarray(hsteploss).reshape(-1), marker="o", ms=3, label=label)
    ax.set_xlabel("horizon step")
    ax.set_ylabel(label)
    ax.set_yscale("log")
    ax.legend(fontsize=8)
    return _to_image(fig)


def trisurf(obs, dt: float = 1.0, length: Optional[float] = None) -> Image.Image:
    """3-D surface of a trajectory u(x, t) (pdegym/visual.py:7-53)."""
    obs = _squeeze2d(obs)
    t_steps, n = obs.shape
    x = np.linspace(0.0, length or n, n)
    t = np.arange(t_steps) * dt
    tt, xx = np.meshgrid(t, x, indexing="ij")

    fig = plt.figure(figsize=(8, 5))
    ax = fig.add_subplot(projection="3d")
    ax.plot_trisurf(tt.ravel(), xx.ravel(), obs.ravel(), cmap="viridis",
                    linewidth=0.1)
    ax.set_xlabel("t")
    ax.set_ylabel("x")
    ax.set_zlabel("u")
    return _to_image(fig)
