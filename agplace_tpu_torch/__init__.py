"""agplace_tpu_torch — the PyTorch / CUDA (Hopper) port of ``agplace_tpu``.

The JAX package stays the reference; this package mirrors its module names
so each ported piece sits next to its counterpart's name.  It imports
nothing of the JAX package: the frozen ``Config`` tree and the dataset
presets are the port's own copy (``agplace_tpu_torch/config.py``), and so
is the host voxelizer (``agplace_tpu_torch/native``).

Kernel dispatch rule: every hand-written kernel's wrapper runs its plain
PyTorch version only for CPU tensors; a CUDA tensor either launches the
kernel or raises.  There is no fallback and no switch that turns kernels
off (see ``agplace_tpu_torch/ops``).
"""

import torch

from agplace_tpu_torch.config import (  # noqa: F401  (re-exported presets)
    Config,
    kitti360_config,
    nuscenes_config,
    synthetic_config,
)

# fp32 convolutions and matmuls run in full fp32 on the card: cuDNN would
# otherwise take fp32 convs through TF32 (about three decimal digits), and
# the retrieval distances and the ODE chain are compared against fp32
# references.  bf16 work is unaffected.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
