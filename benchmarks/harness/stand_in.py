"""Stand-ins for the program, to show that the comparison fails what it
must: the plain reference put in the program's place, computed in a
lower precision (the control) or with a fault planted in it.  The
benchmark's own runs use none of this; ``benchmarks/tests`` does.

  * ``control``: the reference in the nearest precision below the
    configuration's float32 with TF32 off: TF32 for its matrix products
    and cuDNN convolutions, bfloat16 for the env's control period (K1's
    elementwise float32 arithmetic);
  * ``half_batch``: every batched update (a SAC update, a TBPTT step) takes
    the mean over the first half of its batch and leaves the rest out;
  * ``altered``: an answer altered where it is produced by a relative
    1e-3 (a collected reward; a member's validation loss).

A step that returns its state unchanged reads 1 by the change and gradient
measures (the program's change is nought), so it needs no stand-in.
"""

from __future__ import annotations

import contextlib

import torch

from benchmarks.reference import fit as F
from benchmarks.reference import ks, mbpo, sac

NAMES = ("control", "half_batch", "altered")
ALTER = 1e-3


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(name: str):
    stack = contextlib.ExitStack()
    with stack:
        if name == "control":
            def bf16_period(self, u, phi):
                env = self.cfg["env"]
                u1, r = ks.control_period(u.bfloat16(), phi.bfloat16(), env["length"],
                                          env["dt"], env["cfg_steps"], self.objective)
                return u1.float(), r.float()

            flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            stack.callback(lambda: (setattr(torch.backends.cuda.matmul, "allow_tf32", flags[0]),
                                    setattr(torch.backends.cudnn, "allow_tf32", flags[1])))
            stack.enter_context(_patched(mbpo.Iteration, "period", bf16_period))
        elif name == "half_batch":
            update, loss = sac.update, F.member_loss

            def half_update(st, batch, gen, cfg):
                half = batch["obs"].shape[0] // 2
                return update(st, {k: v[:half] for k, v in batch.items()}, gen, cfg)

            def half_loss(p, mode, states, actions, *args):
                half = states.shape[0] // 2
                return loss(p, mode, states[:half], actions[:half], *args)

            stack.enter_context(_patched(sac, "update", half_update))
            stack.enter_context(_patched(F, "member_loss", half_loss))
        elif name == "altered":
            period, val = mbpo.Iteration.period, F.member_val

            def altered_period(self, u, phi):
                u1, r = period(self, u, phi)
                return u1, r * (1 + ALTER)

            def altered_val(*args):
                return val(*args) * (1 + ALTER)

            stack.enter_context(_patched(mbpo.Iteration, "period", altered_period))
            stack.enter_context(_patched(F, "member_val", altered_val))
        else:
            raise ValueError(f"unknown stand-in {name!r}; have {NAMES}")
        yield
