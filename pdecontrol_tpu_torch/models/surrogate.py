"""Autoregressive PDE surrogate and its ensemble (port of
``pdecontrol_tpu/models/surrogate.py``; reference ``surrogates/surrogate.py``).

**AutoReg** rollout (surrogate.py:58-133): states and actions are encoded;
during the warmup the hidden state is overwritten with the encoded ground
truth and the Euler residual update anchors on the ground-truth state,
``u_{t+1} = u_t + delta * dscale(dec(latent))`` (surrogate.py:100-103);
afterwards the model free-runs on its own predictions (surrogate.py:109-119).

**Latent** rollout (surrogate.py:136-206): the integration happens in latent
space, ``z_{t+1} = z_t + delta * f(z, a)``, with a decode to state per step;
the per-step deltas are recovered afterwards by differencing the decoded
trajectory (surrogate.py:197-198).  The integrated latent starts at the
encoding of the first warmup state and is *not* re-anchored on the ground
truth during the warmup: teacher forcing only overwrites the cell's hidden
state.

The JAX package runs the rollout as one ``lax.scan`` with per-step
teacher-forcing and self-forcing masks.  Both masks are the same for every
batch element at every call site (steps ``< Tw`` are teacher-forced; the
``reencode`` schedule is per step), so here they are Python booleans and
the scan is a Python loop over time with ``detach()`` where the JAX package
has ``stop_gradient`` — the same values and the same gradients.

The ensemble is an ``nn.ModuleList`` of members run one after another; its
outputs carry a leading member axis ``M`` like the JAX package's stacked,
vmapped ensemble.  The members' parameters live in one ``[M, P]`` tensor
(``EnsembleState.params``, made by ``stack_parameters``): each member's
parameters are views of its row, so that the lock-step fit of all members
(``train/trainer.py``) writes where the world model and the CUDA graphs
read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pdecontrol_tpu_torch.data.types import ModelRollout
from pdecontrol_tpu_torch.envs.transforms import Identity, Transform
from pdecontrol_tpu_torch.models.blocks import batched_apply

AUTOREG = "autoreg"
LATENT = "latent"


def align_actions(times: np.ndarray, delta: float) -> np.ndarray:
    """Host-side action->timepoint index map (surrogate.py:88-89): the
    reference maps action timestamps onto solver timepoints with
    ``searchsorted``.  Every in-loop grid is uniform and 1:1; this is the
    general mapping, for offline evaluation."""
    times = np.asarray(times).reshape(-1)
    timepoints = np.arange(times[0], times[-1] + delta, delta)
    return np.searchsorted(times, timepoints, side="right") - 1


class PDESurrogate(nn.Module):
    """One surrogate (encoders + transition cell + decoder).  ``delta`` is
    the control-period length (= surrogate step)."""

    def __init__(self, state_encoder: nn.Module, state_decoder: nn.Module,
                 action_encoder: nn.Module, cell: nn.Module, delta: float,
                 mode: str = AUTOREG):
        super().__init__()
        if mode not in (AUTOREG, LATENT):
            raise ValueError(f"unknown mode {mode!r}")
        self.state_encoder = state_encoder
        self.state_decoder = state_decoder
        self.action_encoder = action_encoder
        self.cell = cell
        self.delta = delta
        self.mode = mode

    def forward(self, states, actions, dscaling: Transform = Identity(),
                hidden: Any = None, reencode: Any = None) -> ModelRollout:
        return self.rollout(states, actions, dscaling, hidden, reencode)

    def rollout(
        self,
        states: torch.Tensor,
        actions: torch.Tensor,
        dscaling: Transform = Identity(),
        hidden: Any = None,
        reencode: Any = None,
    ) -> ModelRollout:
        """Teacher-force over ``states`` then free-run to ``actions`` length.

        states  [B, Tw, C, H] — warmup ground truth (Tw may be 1 for pure
                continuation from a given state).
        actions [B, T, Ca, A] with T >= Tw; steps [0, Tw) are teacher-forced,
                [Tw, T) free-run.
        reencode: optional bool array [T] (or True for all steps).  At marked
                free-run steps the model *self-forces*: the hidden state is
                overwritten with the re-encoding of its own (detached)
                previous output, which also anchors the Euler update — the
                world env's repeated 1-step rollouts (world.py:159-161) and
                the TBPTT chunk boundaries (training.py:86-98).
        Returns per-step ``outputs``/``deltas``/latents (length T) and the
        final transition carry.
        """
        b, tw = states.shape[:2]
        t_total = actions.shape[1]
        actions = actions.to(states.dtype)

        if reencode is None:
            re_flags = np.zeros(t_total, bool)
        elif reencode is True:
            re_flags = np.ones(t_total, bool)
        else:
            re_flags = np.asarray(reencode, bool)
        reencode_any = bool(re_flags.any())

        lstates = batched_apply(self.state_encoder, states)
        lactions = batched_apply(self.action_encoder, actions)
        if hidden is None:
            hidden = self.cell.init_carry(b, states.dtype, states.device)

        if self.mode == LATENT:
            return self._latent_rollout(states, lstates, lactions, dscaling, hidden,
                                        tw, re_flags)

        prev = states[:, 0]
        outputs, outdeltas, outlats, inlats = [], [], [], []
        for t in range(t_total):
            tf, re = t < tw, bool(re_flags[t])
            # Ground truth past the warmup is the JAX package's zero padding.
            state_gt = states[:, t] if tf else None
            lstate_gt = lstates[:, t] if tf else torch.zeros_like(lstates[:, 0])

            if re:
                # Self-forcing step: detach the carried state and hidden (the
                # reference detaches dslast and the hidden between TBPTT
                # chunks, training.py:86-98).
                prev = prev.detach()
                hidden = tuple(h.detach() for h in hidden)

            if tf:
                prev_lat = lstate_in = lstate_gt
            elif self.cell.needs_prev_latent or reencode_any:
                # Two distinct detach semantics: self-forcing encodes the
                # *detached* output but keeps encoder-weight gradients
                # (training.py:86-98 -> surrogate.py:80); the plain free-run
                # ``inlast`` detaches the encoder *output* (surrogate.py:103,115).
                raw = self.state_encoder(prev.detach())
                prev_lat = lstate_in = raw if re else raw.detach()
            else:
                # LSTM-family cells ignore lstate when not forcing, so the
                # per-step re-encode the reference computes is skipped.
                prev_lat = lstate_in = lstate_gt

            hidden, outlat = self.cell(hidden, lactions[:, t], lstate_in, tf or re)
            outdelta = self.state_decoder(outlat)
            base = state_gt if tf else prev
            out = base + self.delta * dscaling.apply(outdelta)
            prev = out
            outputs.append(out)
            outdeltas.append(outdelta)
            outlats.append(outlat)
            inlats.append(prev_lat)

        return ModelRollout(
            outputs=torch.stack(outputs, 1),
            inlatents=torch.stack(inlats, 1),
            outlatents=torch.stack(outlats, 1),
            deltas=torch.stack(outdeltas, 1),
            hidden=hidden,
        )

    def _latent_rollout(self, states, lstates, lactions, dscaling: Transform,
                        hidden, tw: int, re_flags: np.ndarray) -> ModelRollout:
        inlatent, prev_out = lstates[:, 0], states[:, 0]
        outputs, outlats, inlats = [], [], []
        for t in range(lactions.shape[1]):
            tf, re = t < tw, bool(re_flags[t])
            if re:
                # Self-forcing: re-anchor the integrated latent on the
                # re-encoding of the previous decoded output (detached, but
                # with encoder-weight gradients), which the reference's
                # repeated 1-step world rollouts do at every call
                # (surrogate.py:158-160), and detach the carried hidden.
                inlatent = self.state_encoder(prev_out.detach())
                hidden = tuple(h.detach() for h in hidden)
            # Teacher forcing overwrites the cell's hidden only; the
            # integrated latent is left as it is.
            lstate_in = lstates[:, t] if tf else inlatent
            hidden, outlat = self.cell(hidden, lactions[:, t], lstate_in, tf or re)
            nxtlatent = inlatent + self.delta * outlat
            prev_out = self.state_decoder(nxtlatent)
            outputs.append(prev_out)
            outlats.append(outlat)
            inlats.append(lstate_in)
            inlatent = nxtlatent

        outputs = torch.stack(outputs, 1)
        # Per-step deltas recovered from the decoded trajectory
        # (surrogate.py:197-198), mapped back through the delta scaling.
        augmented = torch.cat([states[:, :1], outputs], dim=1)
        deltas = dscaling.inverse(torch.diff(augmented, dim=1) / self.delta)
        return ModelRollout(
            outputs=outputs,
            inlatents=torch.stack(inlats, 1),
            outlatents=torch.stack(outlats, 1),
            deltas=deltas,
            hidden=hidden,
        )


def stack_parameters(members: Sequence[nn.Module]) -> torch.Tensor:
    """Move the parameters of the structurally identical ``members`` into
    one ``[M, P]`` tensor and return it: member ``i``'s parameters become
    views of row ``i``, in ``named_parameters`` order.  Run it once the
    members' device and dtype are final (``.to()`` gives a parameter new
    storage) and before anything notes their addresses."""
    named = [list(m.named_parameters(remove_duplicate=False)) for m in members]
    layout = [(name, p.shape) for name, p in named[0]]
    if any([(n, p.shape) for n, p in params] != layout for params in named):
        raise ValueError("the members' parameters differ in names or shapes")
    first = named[0][0][1]
    if any(p.dtype != first.dtype or p.device != first.device
           for params in named for _, p in params):
        raise ValueError("the members' parameters differ in dtype or device")
    if len({id(p) for _, p in named[0]}) != len(layout):
        raise ValueError("a parameter shared between submodules cannot be stacked")
    size = sum(shape.numel() for _, shape in layout)
    flat = torch.empty((len(members), size), dtype=first.dtype, device=first.device)
    for row, member, params in zip(flat, members, named):
        offset = 0
        for name, p in params:
            view = row[offset: offset + p.numel()].view(p.shape)
            with torch.no_grad():
                view.copy_(p)
            owner, _, leaf = name.rpartition(".")
            setattr(member.get_submodule(owner), leaf,
                    nn.Parameter(view, requires_grad=p.requires_grad))
            offset += p.numel()
    return flat


def member_axis_views(params: torch.Tensor, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The stacked ``[M, P]`` parameters as ``{name: [M, *shape]}`` views in
    ``module``'s layout (one member of the stack), for
    ``torch.func.functional_call`` under ``torch.func.vmap``."""
    out, offset, m = {}, 0, params.shape[0]
    for name, p in module.named_parameters():
        out[name] = params[:, offset: offset + p.numel()].view((m,) + tuple(p.shape))
        offset += p.numel()
    return out


@dataclasses.dataclass
class EnsembleState:
    """Ensemble members + elite bookkeeping (reference ``PDEEnsemble``,
    surrogate.py:22-55).  ``elite_mask`` is a boolean [M]; ``params`` is
    the ``[M, P]`` tensor of which the members' parameters are views."""

    members: nn.ModuleList
    elite_mask: torch.Tensor
    num_elites: int
    params: Optional[torch.Tensor] = None

    @property
    def num_members(self) -> int:
        return len(self.members)

    def replace(self, **changes) -> "EnsembleState":
        return dataclasses.replace(self, **changes)


def init_ensemble(build, num_members: int, num_elites: Optional[int] = None,
                  device=None) -> EnsembleState:
    """``num_members`` independently initialised surrogates from the
    zero-argument builder ``build`` (initialised from torch's global
    generator, which the caller seeds), their parameters stacked."""
    members = nn.ModuleList([build() for _ in range(num_members)]).to(device)
    if num_elites is None:
        num_elites = num_members
    return EnsembleState(
        members=members,
        elite_mask=torch.ones((num_members,), dtype=torch.bool, device=device),
        num_elites=num_elites,
        params=stack_parameters(members),
    )


def ensemble_rollout(
    ens: EnsembleState,
    states: torch.Tensor,
    actions: torch.Tensor,
    dscaling: Transform = Identity(),
    hidden: Any = None,
) -> ModelRollout:
    """Run every member on the same batch; outputs and the hidden carry get
    a leading member axis M (``hidden`` in is stacked the same way)."""
    rolls = [
        m.rollout(states, actions, dscaling,
                  hidden=None if hidden is None else tuple(h[i] for h in hidden))
        for i, m in enumerate(ens.members)
    ]

    def stack(field):
        return torch.stack([getattr(r, field) for r in rolls], 0)

    return ModelRollout(
        outputs=stack("outputs"),
        inlatents=stack("inlatents"),
        outlatents=stack("outlatents"),
        deltas=stack("deltas"),
        hidden=tuple(torch.stack(hs, 0) for hs in zip(*(r.hidden for r in rolls))),
    )


def draw_elites(
    generator: Optional[torch.Generator], ens: EnsembleState, n: int,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """A random elite member for each of ``n`` batch elements (surrogate.py:44-46),
    drawn before the outputs they pick from exist.  ``rows``: only those
    elements' members are kept (a rank's share of the batch)."""
    members = torch.multinomial(ens.elite_mask.to(torch.float32), n,
                                replacement=True, generator=generator)
    return members if rows is None else members[rows]


def select_elites(
    generator: Optional[torch.Generator], ens: EnsembleState, outputs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``outputs`` [M, B, ...] -> each element's output of its elite member
    (``draw_elites``) [B, ...], plus the member indices."""
    b = outputs.shape[1]
    members = draw_elites(generator, ens, b)
    return outputs[members, torch.arange(b, device=outputs.device)], members


def update_elites(ens: EnsembleState, scores: torch.Tensor) -> EnsembleState:
    """Keep the ``num_elites`` lowest-scoring members (surrogate.py:53-55)."""
    order = torch.argsort(scores, stable=True)
    mask = torch.zeros_like(ens.elite_mask)
    mask[order[: ens.num_elites]] = True
    return ens.replace(elite_mask=mask)
