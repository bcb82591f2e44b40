"""Offline K-fold surrogate benchmark CLI (port of
``pdecontrol_tpu/evaluation/evaluate.py``; reference
``pdecontrol/surrogates/evaluation/evaluate.py``).

Protocol (evaluate.py:73-216): K-fold CV over the episodes of an offline
dataset (optionally a ``--total`` fraction); per fold, Normalize transforms
are fitted on the train split (obs scaling, action scaling or
forcing+field scaling when transformed, delta scaling), the surrogate
factory's model is trained with early stopping + constant-length curriculum,
and the full metric battery (``training.py:176-271``) runs on the held-out
fold at a ``--target_length``-step open-loop horizon.  Results are written
as ``.npz`` + a JSON summary per fold.  ``--store`` also writes the trained
member as ``fold{k}_model.pt``: ``torch.save`` of its ``state_dict``, the
tensors of the two scalings and the factory's name (the JAX package pickles
its flax trees).  On the card each fold's TBPTT and validation steps
replay CUDA graphs (``SurrogateTrainer.fit``), drawn from the fold's own
generator.  It runs on the GPU, and stops if there is none, unless
``--platform cpu`` asks for the CPU.

    python -m pdecontrol_tpu_torch.evaluation.evaluate \\
        --env_id KuramotoSivashinskyEnv-v0 \\
        --data ks_attractor.npz --factory KSAutoRegConvolutionalLSTM \\
        --training '{"tbtt": 1000000, "tau": 10, "batch_size": 64, "patience": 50}' \\
        --trainer '{"max_epochs": 250, "gradient_clip_val": 0.5}' --target_length 30
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from pdecontrol_tpu_torch.data import replay as R
from pdecontrol_tpu_torch.envs.transforms import Chain, Normalize, SampleTransform
from pdecontrol_tpu_torch.models import factories
from pdecontrol_tpu_torch.train.losses import make_loss
from pdecontrol_tpu_torch.train.metrics import surrogate_metric_battery
from pdecontrol_tpu_torch.train.schedulers import ConstantLengthScheduler, Scheduler
from pdecontrol_tpu_torch.train.trainer import SurrogateTrainer, TrainConfig
from pdecontrol_tpu_torch.utils.checkpoint import tensor_fields, to_host
from pdecontrol_tpu_torch.utils.graphs import GraphCache
from pdecontrol_tpu_torch.utils.device import (
    add_platform_argument, entry_device, platform_device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env_id", type=str, default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--env_config", type=str, default="{}")
    p.add_argument("--factory", type=str, default="KSAutoRegConvolutionalLSTM")
    p.add_argument("--untransformed", action="store_true")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--target_length", type=int, default=30)
    p.add_argument("--splits", type=int, default=5)
    p.add_argument("--total", type=float, default=1.0)
    p.add_argument("--val", type=float, default=0.2)
    p.add_argument("--loss", type=str, default="MSELoss")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--store", action="store_true")
    p.add_argument("--output", type=str, default="offline_eval")
    p.add_argument("--model", type=str, default="{}")
    p.add_argument("--surrogate", type=str, default="{}")
    p.add_argument("--training", type=str, default="{}")
    p.add_argument("--curriculum", type=str, default="{}")
    p.add_argument("--trainer", type=str, default="{}")
    p.add_argument("--max_folds", type=int, default=None)
    add_platform_argument(p)
    return p


def make_curriculum(curriculum_json: str, target_length: int) -> Scheduler:
    """Honor --curriculum when given (reference offline.sh grows the window
    25->50 over 100 epochs); the default is a constant window of
    ``target_length``, as in the JAX package."""
    cfg = json.loads(curriculum_json)
    if cfg:
        return Scheduler.factory(cfg)
    return ConstantLengthScheduler(length=target_length)


def kfold_indices(n: int, splits: int, seed: int):
    """sklearn-KFold(shuffle=True) equivalent: shuffled indices split into
    ``splits`` contiguous folds."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    sizes = np.full(splits, n // splits)
    sizes[: n % splits] += 1
    folds, start = [], 0
    for s in sizes:
        test = idx[start : start + s]
        train = np.concatenate([idx[:start], idx[start + s :]])
        folds.append((train, test))
        start += s
    return folds


def run_fold(args, data: Dict[str, np.ndarray], train_idx, val_idx, test_idx,
             fold: int, device: Optional[torch.device] = None, graphs: bool = True) -> Dict:
    """One fold: fit the surrogate and run the battery on the held-out
    episodes.  ``graphs=False`` fits eagerly on the card too."""
    from pdecontrol_tpu_torch.mbrl.controller import ENVS

    dev = entry_device(device)
    env_cls, _ = ENVS[args.env_id]
    env = env_cls.create(**json.loads(args.env_config), device=dev)
    delta = env.delta

    episodes, t = data["obs"].shape[:2]
    obs_shape = data["obs"].shape[2:]
    act_shape = data["actions"].shape[2:]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def mask(idx):
        m = torch.zeros((episodes,), dtype=torch.bool, device=dev)
        m[torch.as_tensor(np.asarray(idx), device=dev)] = True
        return m

    # Dense replay view of the offline dataset (all episodes complete).
    rep = R.create(episodes, t, 1, obs_shape, act_shape, device=dev)
    rep = dataclasses.replace(
        rep,
        obs_seq=f32(np.concatenate([data["obs"], data["nxtobs"][:, -1:]], axis=1)),
        actions=f32(data["actions"]),
        rewards=f32(data["rewards"]),
        terminated=torch.as_tensor(data["terminated"], device=dev),
        truncated=torch.as_tensor(data["truncated"], device=dev),
        steps=torch.as_tensor(data["steps"].astype(np.int32), device=dev),
        fill=torch.full((episodes,), t, dtype=torch.int32, device=dev),
        complete=torch.ones((episodes,), dtype=torch.bool, device=dev),
    )

    # ---- fit Normalize transforms on the train fold (evaluate.py:85-112).
    def flat(x):
        return f32(x.reshape((-1,) + x.shape[2:]))

    obs_train = flat(data["obs"][train_idx])
    act_train = flat(data["actions"][train_idx])
    nxt_train = flat(data["nxtobs"][train_idx])

    def scalar_stats(values):
        # Reference fits scalar stats: aggregate+batched pools all axes of
        # the flat [N, C, H] arrays (evaluate.py:86-90).
        return Normalize.create(values.shape, aggregate=True, batched=True,
                                device=dev).update(values)

    oscaling = scalar_stats(obs_train)
    if args.untransformed:
        atransf = scalar_stats(act_train)
    else:
        fields = env.forcing.apply(act_train)
        atransf = Chain(transforms=(env.forcing, scalar_stats(fields)))
    undscaling = scalar_stats(
        (oscaling.apply(nxt_train) - oscaling.apply(obs_train)) / delta)
    stransf = SampleTransform(otransf=oscaling, atransf=atransf)

    # ---- build + train the surrogate.
    merged = {**json.loads(args.training), **json.loads(args.trainer)}
    tc = TrainConfig(**{k: v for k, v in merged.items() if k in TrainConfig._fields})
    tau = tc.tau

    torch.manual_seed(args.seed + fold)  # module initialisation
    gen = torch.Generator(device=dev).manual_seed(args.seed + fold)
    module = factories.make(args.factory, delta=delta,
                            **{**env.scenario, **json.loads(args.model)}).to(dev)
    trainer = SurrogateTrainer(make_loss(args.loss, env.scenario), tc)
    if dev.type == "cuda" and graphs:
        trainer.graphs = GraphCache([gen])
    tstate = trainer.init(module)

    curriculum = make_curriculum(args.curriculum, args.target_length)
    t0 = time.time()
    tstate, val_loss, logs = trainer.fit(
        tstate, rep, mask(train_idx), mask(val_idx), undscaling, stransf, curriculum,
        iteration=0, generator=gen,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_time = time.time() - t0

    # ---- test battery on held-out episodes: ALL non-bootstrap stride-tau
    # windows, deterministically enumerated (datamodule.py:100-117).
    length = tau + args.target_length
    batch = R.enumerate_windows(rep, length, stride=tau, rows_mask=mask(test_idx))
    if batch.obs.shape[0] == 0:
        raise ValueError(
            f"fold {fold}: no test episode admits a length-{length} window "
            f"(tau={tau} + target_length={args.target_length}); the metric "
            "battery would be NaN — lower --target_length or the budget"
        )
    batch = stransf(batch)
    metrics = surrogate_metric_battery(module, batch, stransf, undscaling, env, tau)
    metrics = {k: v.cpu().numpy() for k, v in metrics.items()}

    result = {
        "fold": fold,
        "val_loss": val_loss,
        "train_time": train_time,
        "train_steps": logs.get("steps"),
        "MSE": float(metrics["MSE"]),
        "nrmse_final": float(metrics["nrmse"][-1]),
        "l2_loss_scaled_final": float(metrics["l2_loss_scaled"][-1]),
    }

    os.makedirs(args.output, exist_ok=True)
    np.savez_compressed(os.path.join(args.output, f"fold{fold}_metrics.npz"), **metrics)
    if args.store:
        torch.save(
            {
                "state_dict": to_host(module.state_dict()),
                "oscaling": to_host(tensor_fields(oscaling)),
                "undscaling": to_host(tensor_fields(undscaling)),
                "factory": args.factory,
            },
            os.path.join(args.output, f"fold{fold}_model.pt"),
        )
    return result


def fold_splits(args, episodes: int):
    """The folds' (train, val, test) episode indices.  The data budget
    restricts the FOLD INDICES, not the array shapes: the dense replay keeps
    every episode and the train/val/test row masks select among the first
    ``--total`` fraction, as in the JAX package."""
    folds = kfold_indices(math.ceil(args.total * episodes), args.splits, args.seed)
    if args.max_folds:
        folds = folds[: args.max_folds]
    for train_idx, test_idx in folds:
        train_size = math.ceil((1.0 - args.val) * len(train_idx))
        train_idx, val_idx = train_idx[:train_size], train_idx[train_size:]
        if len(val_idx) == 0:
            val_idx = train_idx[-1:]
        yield train_idx, val_idx, test_idx


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = entry_device(platform_device(args.platform))

    data = dict(np.load(args.data))
    results = []
    for fold, (train_idx, val_idx, test_idx) in enumerate(
            fold_splits(args, data["obs"].shape[0])):
        res = run_fold(args, data, train_idx, val_idx, test_idx, fold, device=dev)
        results.append(res)
        print(json.dumps(res), flush=True)

    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
