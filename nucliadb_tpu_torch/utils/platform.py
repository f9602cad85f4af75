"""Torch platform policy for the index compute path.

Counterpart of ``nucliadb_tpu/utils/platform.py`` (``configure_jax``,
``device_fetch``). What carries over:

- **Precision.** Every float32 matrix product of the port runs in full
  float32. Importing this module turns TF32 off for CUDA matmuls and cuDNN
  and pins ``float32_matmul_precision`` to "highest": the exact rerank needs
  the JAX package's ``Precision.HIGHEST`` scores, and the plain int8 dot
  (``ops/quant.py``) is exact in float32 only without TF32.
- **Explicit devices.** Every entry point takes a ``device`` argument. A
  CUDA device on a machine without a card raises; nothing silently moves
  to the CPU.
- **One wait per fetch.** ``device_fetch`` synchronises once and then
  copies every tensor to host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

# the port's precision policy (see module docstring): full f32 everywhere
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device: "str | torch.device") -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def device_fetch(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Copy several tensors to host numpy behind ONE device wait."""
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    return tuple(t.detach().cpu().numpy() for t in tensors)
