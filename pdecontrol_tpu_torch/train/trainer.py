"""Surrogate training: TBPTT train step, free-run validation, early stopping,
curriculum, and the lock-step fit of all ensemble members (port of
``pdecontrol_tpu/train/trainer.py``; reference ``PDETrainingModule`` under
pytorch-lightning).

  * ``train_step`` == ``training_step`` (training.py:64-130): the chunked
    TBPTT loop is ONE rollout whose ``reencode`` schedule self-forces (and
    detaches) at every chunk boundary; the loss is on per-step deltas
    (AutoReg modules) or on the decoded states (Latent modules)
    (training.py:49-55,106-109).
  * ``val_step`` == ``validation_step`` (training.py:132-174): a full
    free-run from a tau warmup; the early-stopping / elite score is the MSE
    in *unscaled* space (training.py:157-164).
  * ``fit`` == ``pl.Trainer.fit`` + ``EarlyStopping`` + the curriculum
    reload (mbrl.py:344-382): each epoch draws windows of length
    ``tau + K(curriculum)`` from the replay, one optimizer step per batch,
    then one validation batch; early stopping on the val loss with patience,
    bounded by min/max optimizer steps.  It trains one member, and serves
    the offline evaluation and ``--sequential_member_training``.  The
    member's state is copied into the trainer's one-member slot, which
    trains at fixed addresses whichever member it holds, and back at the
    end.  With ``graphs`` set each TBPTT step and each validation step
    replay a CUDA graph (the JAX package's jitted ``_epoch_fn``), and every
    epoch ends in one pull of its last train loss and its val losses.
  * ``fit_ensemble`` trains every member in lock-step (the JAX package's
    vmapped ``fit_ensemble``): one step draws a batch for every member and
    takes each member's own gradient with ``torch.func.vmap`` over
    ``torch.func.grad`` of the member module (a convolution with a member
    axis becomes one grouped convolution); a member whose early stopping
    tripped is frozen by the ``active`` mask while the rest go on.  Every
    epoch ends in ONE pull of the members' val losses, on which the host
    keeps the JAX package's early-stopping bookkeeping.  With ``graphs``
    set (on the card, ``fuse_fit``) the step and the validation step
    replay CUDA graphs captured at their first use (``utils/graphs.py``);
    the JAX package's ``lax.while_loop`` over epochs has no counterpart in
    a graph without conditional nodes, hence the per-epoch pull.  With a
    ``mesh`` (``parallel/mesh.py``) the members are sharded over ``model``
    (the JAX package's ``shard_map``): a rank draws every member's batch
    and trains its own members, the pull is gathered over ``model`` before
    the host decides, and the stacked state is gathered at the end.
  * the optimizer is optax's ``clip_by_global_norm`` (per member, when
    ``gradient_clip_val``) followed by ``scale_by_adam`` (b1 0.9, b2 0.999,
    eps 1e-8) and the step ``-lr``, with the learning rate set per epoch
    (StepLR, training.py:273-278).  Its state is stacked over the members
    (``TrainerState``); ``fit`` trains one member of the stack in place.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, grad, vmap

from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.envs.transforms import Normalize, SampleTransform
from pdecontrol_tpu_torch.models.surrogate import (
    AUTOREG,
    PDESurrogate,
    member_axis_views,
    stack_parameters,
)
from pdecontrol_tpu_torch.parallel.mesh import MODEL_AXIS
from pdecontrol_tpu_torch.utils import profiling
from pdecontrol_tpu_torch.utils.graphs import copy_into, tensors_of

# optax.scale_by_adam's defaults.
B1, B2, EPS = 0.9, 0.999, 1e-8

# The lock-step fit's device stamps (``FitInputs.stamps``): the summed
# device time of its step replays and of its validation replays, the fit's
# first stamp and its last.
FIT_STEP, FIT_VAL, FIT_FIRST, FIT_LAST = range(4)


class TrainConfig(NamedTuple):
    tau: int = 5
    tbtt: int = 10
    lr: float = 1e-3
    lr_gamma: float = 1.0
    step_size: int = 25
    batch_size: int = 64
    patience: int = 10
    gradient_clip_val: float = 0.0
    max_epochs: int = 1000
    min_steps: int = 0
    max_steps: int = 0


@dataclasses.dataclass
class TrainerState:
    """The training state of M members stacked on a leading member axis (the
    JAX package's stacked ``TrainerState``): ``params`` [M, P], of which
    each of ``modules``' parameters are views; optax's Adam state
    ``exp_avg`` and ``exp_avg_sq`` [M, P] and ``count`` [M]; and the
    optimizer steps taken across retrains, ``global_step`` [M].  Every
    update is written in place."""

    modules: List[PDESurrogate]
    params: torch.Tensor
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    count: torch.Tensor
    global_step: torch.Tensor

    @property
    def num_members(self) -> int:
        return self.params.shape[0]

    @property
    def module(self) -> PDESurrogate:
        """The one member of a one-member state."""
        if len(self.modules) != 1:
            raise ValueError(f"a state of {len(self.modules)} members has no one module")
        return self.modules[0]

    def member(self, i: int) -> "TrainerState":
        """Member ``i`` as a one-member state whose tensors are views of
        this state's."""
        return self.rows(slice(i, i + 1))

    def rows(self, s: slice) -> "TrainerState":
        """The members ``s`` as a state whose tensors are views of this
        state's."""
        return TrainerState(self.modules[s], *(t[s] for t in self.tensors()))

    def tensors(self) -> List[torch.Tensor]:
        """The stacked tensors, each with the member axis leading."""
        return [self.params, self.exp_avg, self.exp_avg_sq, self.count, self.global_step]

    def stacked_params(self) -> Dict[str, torch.Tensor]:
        return member_axis_views(self.params, self.modules[0])


@dataclasses.dataclass
class FitInputs:
    """What the lock-step step reads besides the state, at fixed addresses so
    that a CUDA graph of it replays each epoch: the learning rate, the
    ``active`` mask over members and the split's row masks; and the slots
    its device stamps write (``FIT_STEP`` ...; the lock-step fit's only)."""

    lr: torch.Tensor
    active: torch.Tensor
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    stamps: Optional[torch.Tensor] = None


def tbtt_reencode_mask(t_total: int, tbtt: int) -> np.ndarray:
    """Self-forcing steps at TBPTT chunk boundaries (training.py:71-75)."""
    idx = np.arange(t_total)
    return (idx >= tbtt) & (idx % tbtt == 0)


def _check_windows(fill: np.ndarray, train_np: np.ndarray, val_np: np.ndarray,
                   length: int) -> None:
    """Guard the degenerate zero-weight sampling case: with no row holding a
    length-``length`` window, window sampling would silently draw uniform
    rows and train/validate on all-zero gathers."""
    for name, mask in (("train", train_np), ("val", val_np)):
        if int(np.sum(np.maximum(fill[mask] - length + 1, 0))) == 0:
            raise ValueError(
                f"no length-{length} windows available in the {name} split "
                f"(fill={fill[mask].tolist()}); replay too small or split "
                "empty"
            )


def _host_inputs(hints: Dict, replay: R.ReplayState, train_mask, val_mask):
    fill = np.asarray(hints["fill"]) if "fill" in hints else replay.fill.cpu().numpy()
    train_np = (np.asarray(hints["train_np"]).astype(bool) if "train_np" in hints
                else train_mask.cpu().numpy().astype(bool))
    val_np = (np.asarray(hints["val_np"]).astype(bool) if "val_np" in hints
              else val_mask.cpu().numpy().astype(bool))
    return fill, train_np, val_np


def _batches(fill: np.ndarray, train_np: np.ndarray, length: int, batch_size: int) -> int:
    """Epoch size = non-overlapping window count over train episodes
    (SubSeqDataset default stride == length, dataset.py:54-58)."""
    nwin = int(np.sum(np.maximum((fill[train_np] - length) // length + 1, 0)))
    return max(nwin // batch_size, 1)


class SurrogateTrainer:
    def __init__(self, loss_fn: Callable, config: TrainConfig,
                 check: Optional[Callable] = None):
        """``check``, if given, is called with every TBPTT step's loss
        (``utils.profiling.FiniteChecks``, the ``--debug_nans`` option); it
        reads the host, so it runs on the eager route only."""
        assert config.tbtt > config.tau, (
            "Chunk size of TBPTT must be larger than warm-up length."
        )
        self.loss_fn = loss_fn
        self.config = config
        self.check = check
        # The lock-step fit: ``fuse_fit`` names the JAX package's default
        # route (its record's pull time is ``t_fit_ready``, else
        # ``t_fit_val``); ``graphs``, a ``utils.graphs.GraphCache`` on the
        # card, replays its steps as CUDA graphs.
        self.fuse_fit = True
        self.graphs = None
        self.mesh = None
        # The lock-step fit's host spans; a controller hands over its own.
        self.tracer = profiling.Tracer()
        self._inputs: Optional[FitInputs] = None
        # The one-member fit's slot and inputs (``_one_member``).
        self._slot: Optional[TrainerState] = None
        self._one_inputs: Optional[FitInputs] = None

    # ------------------------------------------------------------------ init
    def init(self, module: PDESurrogate) -> TrainerState:
        """A one-member state for ``module``, whose parameters move into a
        ``[1, P]`` tensor."""
        return self.init_members([module], stack_parameters([module]))

    def init_members(self, modules: Sequence[PDESurrogate], params: torch.Tensor
                     ) -> TrainerState:
        """A fresh state for ``modules``, whose parameters are views of the
        rows of ``params`` (``models.surrogate.stack_parameters``)."""
        m = params.shape[0]
        zeros = torch.zeros((m,), dtype=torch.int32, device=params.device)
        return TrainerState(list(modules), params, torch.zeros_like(params),
                            torch.zeros_like(params), zeros, zeros.clone())

    # ------------------------------------------------------------- core math
    def _losses(self, module: PDESurrogate, states, actions, und: Normalize,
                params: Optional[Dict[str, torch.Tensor]] = None):
        """Elementwise training loss tensor: [B, T-1, C, H] on the deltas of
        an AutoReg module, [B, T, C, H] on the decoded states of a Latent
        one.  ``params`` replaces the module's own parameters."""
        cfg = self.config
        mask = tbtt_reencode_mask(actions.shape[1], cfg.tbtt)
        args = (states[:, : cfg.tau], actions)
        kwargs = {"dscaling": und.inv, "reencode": mask}
        roll = (module(*args, **kwargs) if params is None
                else functional_call(module, params, args, kwargs))
        if module.mode == AUTOREG:
            out = roll.deltas[:, :-1]
            target = und.apply(torch.diff(states, dim=1) / module.delta)
            return self.loss_fn(out, target), roll
        decoded = torch.cat([states[:, :1], roll.outputs[:, :-1]], dim=1)
        return self.loss_fn(decoded, states), roll

    @torch.no_grad()
    def _adam_(self, state: TrainerState, grads: torch.Tensor, lr,
               active: Optional[torch.Tensor] = None) -> None:
        """``clip_by_global_norm`` of each member's own gradient, optax's
        ``scale_by_adam`` and the step ``-lr * update`` on the stacked
        ``[M, P]`` gradient, written into ``state``; with ``active`` only the
        members where it is true change (``jnp.where(active, new, old)``
        over the whole state, the JAX package's ``one_train``)."""
        clip = self.config.gradient_clip_val
        if clip:
            norm = torch.sqrt(torch.sum(grads * grads, dim=1, keepdim=True))
            grads = torch.where(norm < clip, grads, grads / norm * clip)
        count = state.count + 1
        mu = (1 - B1) * grads + B1 * state.exp_avg
        nu = (1 - B2) * (grads * grads) + B2 * state.exp_avg_sq
        t = count.to(grads.dtype)[:, None]
        update = (mu / (1 - B1 ** t)) / (torch.sqrt(nu / (1 - B2 ** t)) + EPS)
        new = (state.params - lr * update, mu, nu, count, state.global_step + 1)
        old = (state.params, state.exp_avg, state.exp_avg_sq, state.count,
               state.global_step)
        for dst, src in zip(old, new):
            if active is not None:
                src = torch.where(active.view((-1,) + (1,) * (src.ndim - 1)), src, dst)
            dst.copy_(src)

    def train_step(self, state: TrainerState, states, actions, und: Normalize,
                   lr) -> Tuple[TrainerState, Dict[str, torch.Tensor]]:
        """One TBPTT step of a one-member state."""
        module = state.module
        params = list(module.parameters())
        elems, roll = self._losses(module, states, actions, und)
        loss = torch.mean(elems)
        if self.check is not None:
            self.check("the surrogate fit (TBPTT step)", train_loss=loss)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(1, -1)
                          for p, g in zip(params, grads)], dim=1)
        self._adam_(state, flat, lr)
        deltas = roll.deltas.detach()
        metrics = {
            "train_loss": loss.detach(),
            "hstep_loss": torch.mean(elems.detach(), dim=(0, 2, 3)),
            "mean_delta_output": torch.mean(deltas),
            "std_delta_output": torch.std(deltas, correction=0),
        }
        return state, metrics

    @torch.no_grad()
    def val_step(self, module: PDESurrogate, states, actions, und: Normalize,
                 stransf: SampleTransform,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        args = (states[:, : cfg.tau], actions)
        kwargs = {"dscaling": und.inv}
        roll = (module(*args, **kwargs) if params is None
                else functional_call(module, params, args, kwargs))
        decoded = torch.cat([states[:, :1], roll.outputs[:, :-1]], dim=1)

        outdeltas = roll.deltas[:, :-1]
        target = und.apply(torch.diff(states, dim=1) / module.delta)
        delta_loss = torch.mean(self.loss_fn(outdeltas, target))
        scaled_loss = torch.mean(self.loss_fn(decoded, states))

        # Unscale before the early-stopping metric (training.py:157-164).
        states_u = stransf.otransf.inverse(states)
        decoded_u = stransf.otransf.inverse(decoded)
        elems = self.loss_fn(decoded_u, states_u)
        return {
            "val_loss": torch.mean(elems),
            "val_hstep_loss": torch.mean(elems, dim=(0, 2, 3)),
            "val_delta_loss": delta_loss,
            "val_scaled_loss": scaled_loss,
        }

    # ---------------------------------------------------- lock-step members
    def lockstep_train_step(self, state: TrainerState, states, actions, und: Normalize,
                            lr, active: torch.Tensor) -> torch.Tensor:
        """One TBPTT step of every member on its own batch (``states`` and
        ``actions`` [M, B, T, ...]): the JAX package's vmapped ``one_train``
        without its draw.  Returns the members' train losses [M]."""
        module = state.modules[0]
        stacked = state.stacked_params()

        def member_loss(params, s, a):
            elems, _ = self._losses(module, s, a, und, params=params)
            loss = torch.mean(elems)
            return loss, loss

        if self.check is not None:
            # Before the backward pass, which anomaly detection watches.
            with torch.no_grad():
                losses = vmap(member_loss)(stacked, states, actions)[0]
            self.check("the surrogate fit (TBPTT step)", train_loss=losses)
        grads, losses = vmap(grad(member_loss, has_aux=True))(stacked, states, actions)
        m = state.num_members
        flat = torch.cat([grads[name].reshape(m, -1) for name in stacked], dim=1)
        self._adam_(state, flat, lr, active)
        return losses

    def lockstep_val_step(self, state: TrainerState, states, actions, und: Normalize,
                          stransf: SampleTransform) -> Dict[str, torch.Tensor]:
        """``val_step`` of every member on its own batch: each output gains a
        leading member axis (the JAX package's vmapped ``one_val``)."""
        module = state.modules[0]
        return vmap(lambda p, s, a: self.val_step(module, s, a, und, stransf, params=p))(
            state.stacked_params(), states, actions)

    # ----------------------------------------------------------------- draws
    def _draw(self, replay, generator, length: int, mask, stransf):
        """One batch of windows (obs, actions) for the one-member fit."""
        batch = stransf(R.sample_windows(replay, generator, self.config.batch_size,
                                         length, mask))
        return batch.obs, batch.actions

    def _draw_members(self, replay, generator, m: int, length: int, mask, stransf):
        """A batch for each of ``m`` members, stopped or not (so the stream
        does not depend on which members stopped), as one draw of
        ``m * batch_size`` windows: (obs, actions) [M, B, ...]."""
        bs = self.config.batch_size
        batch = stransf(R.sample_windows(replay, generator, m * bs, length, mask))
        return tuple(x.reshape((m, bs) + tuple(x.shape[1:]))
                     for x in (batch.obs, batch.actions))

    # ------------------------------------------------------------------- fit
    def fit(
        self,
        state: TrainerState,
        replay: R.ReplayState,
        train_mask: torch.Tensor,
        val_mask: torch.Tensor,
        und: Normalize,
        stransf: SampleTransform,
        curriculum,
        iteration: int,
        generator: Optional[torch.Generator],
        min_steps: Optional[int] = None,
        max_steps: Optional[int] = None,
        patience: Optional[int] = None,
        max_epochs: Optional[int] = None,
        host_hints: Optional[Dict] = None,
    ) -> Tuple[TrainerState, float, Dict[str, float]]:
        """Per-epoch host loop for a one-member state (a member of a stack,
        ``TrainerState.member``, is trained in the trainer's slot and copied
        back in place).  Returns the final state, the last val loss (the
        elite score, mbrl.py:595), and logs.

        ``host_hints`` may carry host copies of ``fill``, ``train_np``,
        ``val_np`` and ``start_step`` that the caller already holds.
        """
        cfg = self.config
        min_steps = cfg.min_steps if min_steps is None else min_steps
        max_steps = cfg.max_steps if max_steps is None else max_steps
        patience = cfg.patience if patience is None else patience
        max_epochs = cfg.max_epochs if max_epochs is None else max_epochs
        hints = host_hints or {}
        self._check_graphed(generator)
        fill, train_np, val_np = _host_inputs(hints, replay, train_mask, val_mask)

        start_step = (int(hints["start_step"]) if "start_step" in hints
                      else int(state.global_step[0]))
        slot, inp = self._one_member(state, train_mask.shape[0])
        copy_into(slot.tensors(), state.tensors())
        inp.train_mask.copy_(train_mask)
        inp.val_mask.copy_(val_mask)
        captured: List = []

        def graph_state():
            return tensors_of(slot, replay, und, stransf, inp)

        best, wait = math.inf, 0
        val_loss = math.nan
        logs: Dict[str, float] = {}
        epoch = 0
        stop = False
        steps_taken = 0
        t_train = t_val = 0.0

        while not stop and epoch < max_epochs:
            k = int(curriculum(iteration=iteration, epoch=epoch,
                               step=start_step + steps_taken))
            length = cfg.tau + k
            lr = cfg.lr * (cfg.lr_gamma ** (epoch // cfg.step_size))
            _check_windows(fill, train_np, val_np, length)
            nb = _batches(fill, train_np, length, cfg.batch_size)
            nb_eff = nb
            if max_steps:
                nb_eff = max(0, min(nb, max_steps - steps_taken))

            def train_body(length=length):
                obs, actions = self._draw(replay, generator, length, inp.train_mask, stransf)
                return self.train_step(slot, obs, actions, und, inp.lr)[1]["train_loss"]

            def val_body(length=length):
                obs, actions = self._draw(replay, generator, length, inp.val_mask, stransf)
                vm = self.val_step(slot.module, obs, actions, und, stransf)
                return torch.stack([vm["val_loss"], vm["val_delta_loss"]])

            t0 = time.perf_counter()
            inp.lr.fill_(lr)
            tl = None
            for _ in range(nb_eff):
                # The clip is read when the step is captured, so it keys it.
                tl = self._run(("fit_one_step", length, cfg.batch_size, cfg.tau, cfg.tbtt,
                                cfg.gradient_clip_val), train_body, graph_state, captured)
            steps_taken += nb_eff
            if max_steps and nb_eff < nb:
                stop = True
            t1 = time.perf_counter()
            vl = self._run(("fit_one_val", length, cfg.batch_size), val_body, graph_state,
                           captured)
            # The epoch's one pull: its val losses and its last train loss.
            pulled = vl if tl is None else torch.cat([vl, tl.reshape(1)])
            pulled = pulled.to("cpu", torch.float64).tolist()
            val_loss, val_delta_loss = pulled[:2]
            train_loss = math.nan if tl is None else pulled[2]
            t_train += t1 - t0
            t_val += time.perf_counter() - t1
            logs = {
                "train_loss": train_loss,
                "val_loss": val_loss,
                "val_delta_loss": val_delta_loss,
                "epochs": epoch + 1,
                "curriculum_K": k,
                "lr": lr,
            }

            # Lightning-style EarlyStopping on "Val. Loss" (mbrl.py:351-354),
            # gated by the min-steps window (mbrl.py:379-380).
            if val_loss < best:
                best, wait = val_loss, 0
            else:
                wait += 1
                if wait >= patience and steps_taken >= min_steps:
                    stop = True
            if max_steps and steps_taken >= max_steps:
                stop = True
            epoch += 1

        copy_into(state.tensors(), slot.tensors())
        logs["steps"] = steps_taken
        logs["t_fit_train"] = round(t_train, 4)
        logs["t_fit_val"] = round(t_val, 4)
        if captured:
            logs["t_fit_capture"] = round(sum(g.seconds for g in captured), 4)
            logs["fit_graph_pool_mb"] = round(sum(g.pool_bytes for g in captured) / 1e6, 3)
        return state, val_loss, logs

    def _one_member(self, state: TrainerState, rows: int) -> Tuple[TrainerState, FitInputs]:
        """The one-member fit's slot, a one-member state of its own made once
        per layout from a copy of ``state``'s module, and its inputs (the
        learning rate and the split's row masks), at fixed addresses so
        that a CUDA graph of its step replays for every member."""
        p = state.params
        slot = self._slot
        if (slot is None or slot.params.shape != p.shape or slot.params.device != p.device
                or slot.params.dtype != p.dtype):
            module = copy.deepcopy(state.module)
            slot = self._slot = self.init_members([module], stack_parameters([module]))
        inp = self._one_inputs
        if inp is None or inp.train_mask.shape[0] != rows or inp.lr.device != p.device:
            mask = torch.zeros((rows,), dtype=torch.bool, device=p.device)
            inp = self._one_inputs = FitInputs(
                lr=torch.zeros((), dtype=p.dtype, device=p.device),
                active=torch.ones((1,), dtype=torch.bool, device=p.device),
                train_mask=mask, val_mask=mask.clone())
        return slot, inp

    def _check_graphed(self, generator) -> None:
        if self.graphs is None:
            return
        if self.check is not None:
            raise ValueError("the graphed fit cannot run the finite checks")
        if not any(g is generator for g in self.graphs.generators):
            raise ValueError("the graphed fit must draw from its graphs' generator")

    # ------------------------------------------------------- lock-step fit
    def _fit_inputs(self, state: TrainerState, rows: int) -> FitInputs:
        """The lock-step step's per-epoch inputs, made once per shape."""
        p = state.params
        inp = self._inputs
        if (inp is None or inp.active.shape[0] != state.num_members
                or inp.train_mask.shape[0] != rows or inp.lr.device != p.device
                or inp.lr.dtype != p.dtype):
            mask = torch.zeros((rows,), dtype=torch.bool, device=p.device)
            inp = self._inputs = FitInputs(
                lr=torch.zeros((), dtype=p.dtype, device=p.device),
                active=torch.ones((state.num_members,), dtype=torch.bool, device=p.device),
                train_mask=mask, val_mask=mask.clone(),
                stamps=torch.zeros((FIT_LAST + 1,), dtype=torch.int64, device=p.device))
        return inp

    def _run(self, key: Tuple, body: Callable[[], torch.Tensor],
             state: Callable[[], Sequence[torch.Tensor]], captured: List) -> torch.Tensor:
        """``body`` eagerly, or through its CUDA graph under ``key``
        (``GraphCache.run``: the first call of a key runs eagerly and
        captures after it, every later call replays it)."""
        if self.graphs is None:
            return body()
        return self.graphs.run(key, body, state, f"the surrogate fit's {key[0]}",
                               captured=captured)

    def fit_ensemble(
        self,
        state: TrainerState,
        replay: R.ReplayState,
        train_mask: torch.Tensor,
        val_mask: torch.Tensor,
        und: Normalize,
        stransf: SampleTransform,
        curriculum,
        iteration: int,
        generator: Optional[torch.Generator],
        min_steps: Optional[int] = None,
        max_steps: Optional[int] = None,
        patience: Optional[int] = None,
        max_epochs: Optional[int] = None,
        host_hints: Optional[Dict] = None,
    ) -> Tuple[TrainerState, np.ndarray, Dict[str, float]]:
        """Train ALL members of ``state`` in lock-step, each with its own
        early stopping (the JAX package's ``fit_ensemble``: its per-epoch
        host loop, whose bookkeeping its whole-fit program replays).
        Returns the state, the per-member val losses and the logs.

        The host's time goes into the spans ``fit.prep`` and, per epoch,
        ``fit.epoch`` around ``fit.dispatch`` and ``fit.pull`` (the logs'
        ``t_fit_prep``, ``t_fit_dispatch`` and ``t_fit_ready``); the card's
        into the stamps (``t_fit_dev_step``, ``t_fit_dev_val``, and the
        card's idle between the fit's first and last stamp,
        ``t_fit_dev_wait``).  ``fit_member_steps`` counts the member-steps computed,
        ``fit_masked_member_steps`` those of members already stopped."""
        cfg = self.config
        min_steps = cfg.min_steps if min_steps is None else min_steps
        max_steps = cfg.max_steps if max_steps is None else max_steps
        patience = cfg.patience if patience is None else patience
        max_epochs = cfg.max_epochs if max_epochs is None else max_epochs
        hints = host_hints or {}
        self._check_graphed(generator)
        tracer = self.tracer

        with tracer.span("fit.prep") as prep:
            m = state.num_members
            mesh = self.mesh
            # This rank's members and their state.
            rows = None if mesh is None else mesh.model_slice(m)
            local = state if rows is None else state.rows(rows)
            fill, train_np, val_np = _host_inputs(hints, replay, train_mask, val_mask)
            # Cumulative step basis so a steptype='step' curriculum advances
            # across retrains (matches fit's start_step + steps_taken).
            start_step = (int(hints["start_step"]) if "start_step" in hints
                          else int(state.global_step.max()))
            inp = self._fit_inputs(local, train_mask.shape[0])
            inp.train_mask.copy_(train_mask)
            inp.val_mask.copy_(val_mask)
            stamps = inp.stamps
            stamps.zero_()
            captured: List = []

            def graph_state():
                return tensors_of(state, replay, und, stransf, inp)

            best = np.full(m, np.inf)
            wait = np.zeros(m, int)
            stopped = np.zeros(m, bool)
            val_losses = np.full(m, np.nan)
            steps_taken = np.zeros(m, int)
            member_steps = masked_steps = 0
            epoch = 0
            last_tl = float("nan")
            logs: Dict[str, float] = {}
            pulled_stamps = None
        t_dispatch = t_pull = 0.0

        while not stopped.all() and epoch < max_epochs:
            with tracer.span("fit.epoch"):
                k = int(curriculum(iteration=iteration, epoch=epoch,
                                   step=start_step + int(steps_taken.max())))
                length = cfg.tau + k
                lr = cfg.lr * (cfg.lr_gamma ** (epoch // cfg.step_size))
                _check_windows(fill, train_np, val_np, length)
                nb = _batches(fill, train_np, length, cfg.batch_size)
                nb_eff = nb
                if max_steps:
                    nb_eff = max(0, min(nb, max_steps - int(steps_taken.max())))

                def draw(mask, length):
                    # Every member's batch, of which a rank of a mesh keeps its own.
                    obs, actions = self._draw_members(replay, generator, m, length, mask,
                                                      stransf)
                    return (obs, actions) if rows is None else (obs[rows], actions[rows])

                def train_body(length=length):
                    profiling.stamp(stamps, FIT_STEP, profiling.SUB)
                    obs, actions = draw(inp.train_mask, length)
                    losses = self.lockstep_train_step(local, obs, actions, und, inp.lr,
                                                      inp.active)
                    profiling.stamp(stamps, FIT_STEP, profiling.ADD)
                    return losses

                def val_body(length=length):
                    profiling.stamp(stamps, FIT_VAL, profiling.SUB)
                    obs, actions = draw(inp.val_mask, length)
                    vl = self.lockstep_val_step(local, obs, actions, und, stransf)["val_loss"]
                    profiling.stamp(stamps, FIT_VAL, profiling.ADD)
                    return vl

                with tracer.span("fit.dispatch") as dispatch:
                    if epoch == 0:
                        profiling.stamp(stamps, FIT_FIRST)
                    inp.lr.fill_(lr)
                    inp.active.copy_(torch.as_tensor(~stopped if rows is None
                                                     else ~stopped[rows]))
                    tl = None
                    for _ in range(nb_eff):
                        # The clip is read when the step is captured, so it keys it.
                        tl = self._run(("fit_step", length, m, cfg.batch_size, cfg.tau,
                                        cfg.tbtt, cfg.gradient_clip_val),
                                       train_body, graph_state, captured)
                    vl = self._run(("fit_val", length, m, cfg.batch_size), val_body,
                                   graph_state, captured)
                    profiling.stamp(stamps, FIT_LAST)
                    # Every member computes each step; the stopped ones are
                    # masked out of the update.
                    member_steps += nb_eff * m
                    masked_steps += nb_eff * int(stopped.sum())
                    steps_taken[~stopped] += nb_eff
                    if max_steps and nb_eff < nb:
                        stopped[:] = True
                t_dispatch += dispatch.seconds

                # The epoch's one pull: the val losses and the mean over all
                # members of the last batch's train loss, every member's on
                # every rank of a mesh, so that all stop the same members;
                # the stamps beside them, in a copy of their own.
                with tracer.span("fit.pull") as pull:
                    if mesh is not None:
                        vl, *tl = mesh.gather([vl] + ([] if tl is None else [tl]), MODEL_AXIS)
                        tl = tl[0] if tl else None
                    pulled_stamps = profiling.pull_async(stamps)
                    pulled = (vl if tl is None else torch.cat([vl, torch.mean(tl)[None]]))
                    pulled = pulled.to("cpu", torch.float64).numpy()
                    vl = pulled[:m]
                    if tl is not None:
                        last_tl = float(pulled[m])
                t_pull += pull.seconds
                val_losses = np.where(stopped, val_losses, vl)

                improved = vl < best
                wait = np.where(stopped | improved, np.where(improved, 0, wait), wait + 1)
                best = np.minimum(best, np.where(stopped, best, vl))
                newly = (~stopped) & (wait >= patience) & (steps_taken >= min_steps)
                stopped |= newly
                if max_steps and steps_taken.max() >= max_steps:
                    stopped[:] = True
                epoch += 1
                logs = {
                    "train_loss": last_tl,
                    "val_loss": float(np.mean(val_losses)),
                    "epochs": epoch,
                    "curriculum_K": k,
                    "lr": lr,
                }

        if mesh is not None:
            # Every rank holds every member for the rollouts.
            mesh.gather_rows_(state.tensors(), MODEL_AXIS)
        logs["steps"] = int(steps_taken.max())
        logs["fit_member_steps"] = member_steps
        logs["fit_masked_member_steps"] = masked_steps
        logs["t_fit_prep"] = round(prep.seconds, 4)
        logs["t_fit_dispatch"] = round(t_dispatch, 4)
        logs["t_fit_ready" if self.fuse_fit else "t_fit_val"] = round(t_pull, 4)
        if pulled_stamps is not None:
            step, val, first, last = (t * 1e-9 for t in pulled_stamps.tolist())
            logs["t_fit_dev_step"] = round(step, 6)
            logs["t_fit_dev_val"] = round(val, 6)
            logs["t_fit_dev_wait"] = round(last - first - step - val, 6)
        if captured:
            logs["t_fit_capture"] = round(sum(g.seconds for g in captured), 4)
            logs["fit_graph_pool_mb"] = round(sum(g.pool_bytes for g in captured) / 1e6, 3)
        return state, val_losses, logs
