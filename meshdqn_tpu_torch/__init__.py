"""meshdqn_tpu_torch — the PyTorch/CUDA port of meshdqn_tpu.

The JAX package `meshdqn_tpu` is the reference; this package mirrors its
layout (mesh/, fem/, probes.py, ops/, solver/) so each module has an obvious
counterpart, and imports neither JAX nor anything of `meshdqn_tpu`.  The
host-side numpy layers (mesh topology, assembly, probes) are copies; the
device layers are torch, and every dense operator apply of the fused IPCS
step goes through the hand-written Hopper kernel in csrc/matvec.cu
(ops/matvec.py).

Entry points run on CUDA unless the caller passes device="cpu"; on the CPU
every kernel wrapper uses its plain torch version.
"""
import torch

# f32 must be true f32: TF32 keeps ~10 mantissa bits, which plays the role of
# the bf16 MXU passes that the reference measured at 4x worse drag/lift
# accuracy than 'highest' precision (meshdqn_tpu/__init__.py).  Matmuls
# default to full f32 already; convolutions through cuDNN do not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
