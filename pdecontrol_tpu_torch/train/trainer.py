"""Surrogate training: TBPTT train step, free-run validation, early stopping,
curriculum (port of ``pdecontrol_tpu/train/trainer.py``; reference
``PDETrainingModule`` under pytorch-lightning).

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
    bounded by min/max optimizer steps.
  * the optimizer is Adam (``optax.scale_by_adam`` followed by the lr step
    in the JAX package; ``torch.optim.Adam`` puts eps in the same place),
    with the learning rate set per epoch (StepLR, training.py:273-278) and
    optional global-norm clipping (``gradient_clip_val``).

The JAX package's fused epoch and fused whole-fit programs are not ported:
this is its per-epoch host loop, and ``fit_ensemble`` fits the members one
after another (its ``--sequential_member_training`` path).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.envs.transforms import Normalize, SampleTransform
from pdecontrol_tpu_torch.models.surrogate import AUTOREG, PDESurrogate


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
    """One member under training: its module (updated in place), its Adam
    state, and the optimizer steps taken across retrains."""

    module: PDESurrogate
    optimizer: torch.optim.Optimizer
    global_step: int = 0


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


def _clip_by_global_norm_(params: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm``: scale all grads by ``max_norm / norm``
    when the global norm exceeds ``max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class SurrogateTrainer:
    def __init__(self, loss_fn: Callable, config: TrainConfig,
                 check: Optional[Callable] = None):
        """``check``, if given, is called with every TBPTT step's loss
        (``utils.profiling.FiniteChecks``, the ``--debug_nans`` option)."""
        assert config.tbtt > config.tau, (
            "Chunk size of TBPTT must be larger than warm-up length."
        )
        self.loss_fn = loss_fn
        self.config = config
        self.check = check

    # ------------------------------------------------------------------ init
    def init(self, module: PDESurrogate) -> TrainerState:
        opt = torch.optim.Adam(module.parameters(), lr=self.config.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return TrainerState(module=module, optimizer=opt, global_step=0)

    # ------------------------------------------------------------- core math
    def _losses(self, module: PDESurrogate, states, actions, und: Normalize):
        """Elementwise training loss tensor: [B, T-1, C, H] on the deltas of
        an AutoReg module, [B, T, C, H] on the decoded states of a Latent
        one."""
        cfg = self.config
        mask = tbtt_reencode_mask(actions.shape[1], cfg.tbtt)
        roll = module.rollout(states[:, : cfg.tau], actions, dscaling=und.inv,
                              reencode=mask)
        if module.mode == AUTOREG:
            out = roll.deltas[:, :-1]
            target = und.apply(torch.diff(states, dim=1) / module.delta)
            return self.loss_fn(out, target), roll
        decoded = torch.cat([states[:, :1], roll.outputs[:, :-1]], dim=1)
        return self.loss_fn(decoded, states), roll

    def train_step(self, state: TrainerState, states, actions, und: Normalize,
                   lr: float) -> Tuple[TrainerState, Dict[str, torch.Tensor]]:
        elems, roll = self._losses(state.module, states, actions, und)
        loss = torch.mean(elems)
        if self.check is not None:
            self.check("the surrogate fit (TBPTT step)", train_loss=loss)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.config.gradient_clip_val:
            _clip_by_global_norm_(list(state.module.parameters()),
                                  self.config.gradient_clip_val)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.global_step += 1
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
                 stransf: SampleTransform) -> Dict[str, torch.Tensor]:
        cfg = self.config
        roll = module.rollout(states[:, : cfg.tau], actions, dscaling=und.inv)
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
        """Per-epoch host loop for one member.  Returns the final state, the
        last val loss (the elite score, mbrl.py:595), and logs.

        ``host_hints`` may carry host copies of ``fill``, ``train_np`` and
        ``val_np`` that the caller already holds.
        """
        cfg = self.config
        min_steps = cfg.min_steps if min_steps is None else min_steps
        max_steps = cfg.max_steps if max_steps is None else max_steps
        patience = cfg.patience if patience is None else patience
        max_epochs = cfg.max_epochs if max_epochs is None else max_epochs
        hints = host_hints or {}
        fill = np.asarray(hints["fill"]) if "fill" in hints else replay.fill.cpu().numpy()
        train_np = (np.asarray(hints["train_np"]).astype(bool) if "train_np" in hints
                    else train_mask.cpu().numpy().astype(bool))
        val_np = (np.asarray(hints["val_np"]).astype(bool) if "val_np" in hints
                  else val_mask.cpu().numpy().astype(bool))

        start_step = state.global_step
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

            # Epoch size = non-overlapping window count over train episodes
            # (SubSeqDataset default stride == length, dataset.py:54-58).
            nwin = int(np.sum(np.maximum((fill[train_np] - length) // length + 1, 0)))
            nb = max(nwin // cfg.batch_size, 1)

            t0 = time.perf_counter()
            tm = None
            for _ in range(nb):
                if max_steps and steps_taken >= max_steps:
                    stop = True
                    break
                batch = stransf(R.sample_windows(replay, generator, cfg.batch_size,
                                                 length, train_mask))
                state, tm = self.train_step(state, batch.obs, batch.actions, und, lr)
                steps_taken += 1
            train_loss = math.nan if tm is None else float(tm["train_loss"])
            t1 = time.perf_counter()

            batch = stransf(R.sample_windows(replay, generator, cfg.batch_size,
                                             length, val_mask))
            vm = self.val_step(state.module, batch.obs, batch.actions, und, stransf)
            val_loss = float(vm["val_loss"])
            t_train += t1 - t0
            t_val += time.perf_counter() - t1
            logs = {
                "train_loss": train_loss,
                "val_loss": val_loss,
                "val_delta_loss": float(vm["val_delta_loss"]),
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

        logs["steps"] = steps_taken
        logs["t_fit_train"] = round(t_train, 4)
        logs["t_fit_val"] = round(t_val, 4)
        return state, val_loss, logs

    def fit_ensemble(
        self,
        states: List[TrainerState],
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
    ) -> Tuple[List[TrainerState], np.ndarray, Dict[str, float]]:
        """Fit every member, one after another, each with its own early
        stopping (the reference's sequential per-member ``trainer.fit``,
        mbrl.py:408).  Returns the states, per-member val losses and logs."""
        val_losses, member_logs = [], []
        for i, st in enumerate(states):
            states[i], vl, logs = self.fit(
                st, replay, train_mask, val_mask, und, stransf, curriculum,
                iteration, generator, min_steps=min_steps, max_steps=max_steps,
                patience=patience, max_epochs=max_epochs, host_hints=host_hints,
            )
            val_losses.append(vl)
            member_logs.append(logs)
        last = member_logs[-1]
        logs = {
            "train_loss": float(np.mean([m["train_loss"] for m in member_logs])),
            "val_loss": float(np.mean(val_losses)),
            "epochs": max(m["epochs"] for m in member_logs),
            "curriculum_K": last["curriculum_K"],
            "lr": last["lr"],
            "steps": max(m["steps"] for m in member_logs),
            "t_fit_train": round(sum(m["t_fit_train"] for m in member_logs), 4),
            "t_fit_val": round(sum(m["t_fit_val"] for m in member_logs), 4),
        }
        return states, np.asarray(val_losses), logs
