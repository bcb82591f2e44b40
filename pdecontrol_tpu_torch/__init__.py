"""pdecontrol_tpu_torch — the PyTorch / CUDA port of ``pdecontrol_tpu``.

The same model-based PDE control stack (KS and Burgers environments, the
five surrogate families trained with TBPTT, SAC, the MBPO loop, the offline
dataset and k-fold evaluation CLIs) written in PyTorch for one
NVIDIA H100.  The layout mirrors ``pdecontrol_tpu/``: one file for each JAX
file ported, with the same public names.  The JAX package is the reference;
``tests/test_torch_*.py`` hold the two to the same numbers on the CPU.

Every Pallas kernel on the main path is a hand-written CUDA kernel here
(``csrc/``), built at first use.  A kernel's wrapper takes its plain PyTorch
version for tensors on the CPU and launches the kernel, or raises, for
tensors on the GPU.

Float32 on the GPU means float32: TF32 is turned off for matrix products and
for cuDNN convolutions (the surrogate is all convolutions, and cuDNN would
otherwise run them in TF32) before anything of the port runs.  cuDNN also
keeps to its deterministic algorithms, so that two runs of one seed on one
card give the same numbers, as the JAX package's do: the fused iteration's
CUDA graphs are held to the eager phases that way (``chip_smoke.py`` phase
13).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

__version__ = "0.1.0"
