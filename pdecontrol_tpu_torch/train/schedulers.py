"""Curriculum / horizon schedulers (reference
``pdecontrol/surrogates/common/schedulers.py``): host-side scalar schedules
selected by ``steptype`` in {iteration, epoch, step}, built from a config
dict by name (``Scheduler.factory``, schedulers.py:13-16).

A copy of ``pdecontrol_tpu.train.schedulers`` (plain Python), kept in the
port so that importing it never runs the JAX package's ``__init__``."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np


class Scheduler:
    def __init__(self, steptype: str = "iteration", **_):
        self.steptype = steptype

    def get_step(self, iteration=None, epoch=None, step=None):
        return {"iteration": iteration, "epoch": epoch, "step": step}[self.steptype]

    def __call__(self, iteration=None, epoch=None, step=None):
        raise NotImplementedError

    @staticmethod
    def factory(config: Dict) -> "Scheduler":
        if not config:
            return ConstantLengthScheduler(length=1)
        name = config["scheduler"]
        cls = {
            "LinearScheduler": LinearScheduler,
            "StepScheduler": StepScheduler,
            "FuncScheduler": FuncScheduler,
            "ConstantLengthScheduler": ConstantLengthScheduler,
        }[name]
        return cls(**config)


class LinearScheduler(Scheduler):
    """Clip-interpolate vmin -> vmax between start and stop
    (schedulers.py:19-35)."""

    def __init__(self, steptype: str, start: int, stop: int, vmin: float,
                 vmax: float, **kwargs):
        super().__init__(steptype)
        assert start < stop
        self.start, self.stop = start, stop
        self.vmin, self.vmax = vmin, vmax

    def __call__(self, iteration=None, epoch=None, step=None):
        step = self.get_step(iteration, epoch, step)
        fraction = max((step - self.start) / (self.stop - self.start), 0.0)
        value = self.vmin + fraction * (self.vmax - self.vmin)
        return float(np.clip(value, self.vmin, self.vmax))


class StepScheduler(Scheduler):
    def __init__(self, steptype: str, steps: Sequence, values: Sequence, **kwargs):
        super().__init__(steptype)
        self.steps, self.values = list(steps), list(values)

    def __call__(self, iteration=None, epoch=None, step=None):
        step = self.get_step(iteration, epoch, step)
        idx = int(np.searchsorted(self.steps, step, side="left"))
        return self.values[idx]


class FuncScheduler(Scheduler):
    def __init__(self, steptype: str, func: Callable, **kwargs):
        super().__init__(steptype)
        self.func = func

    def __call__(self, iteration=None, epoch=None, step=None):
        return self.func(self.get_step(iteration, epoch, step))


class ConstantLengthScheduler(Scheduler):
    def __init__(self, length: int, **kwargs):
        super().__init__("iteration")
        self.length = length

    def __call__(self, iteration=None, epoch=None, step=None):
        return self.length
