"""tpu3drecon_torch — the PyTorch/CUDA port of tpu3drecon for NVIDIA Hopper.

The JAX package ``tpu3drecon`` is the reference; this package mirrors its
module paths (``tpu3drecon_torch.solvers.ba_wtt`` is the counterpart of
``tpu3drecon.solvers.ba_wtt``) and never imports jax.  The slice ported so
far is the medium bundle-adjustment solve on the windowed track-table
("wtt") engine, fully indexed, with its four kernels written by hand in
CUDA C++ for ``sm_90a`` (``csrc/wtt_kernels.cu``).

Precision: float32 matmuls stay in full float32.  TF32 keeps ~3 decimal
digits, the Hopper form of the TPU's bf16-matmul trap, and stalls the f32
solve the same way; the solvers also pin
``torch.set_float32_matmul_precision("highest")`` where they start.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
