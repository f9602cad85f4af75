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
- **A stream per dispatching thread.** ``thread_stream`` gives each
  thread that launches device work its own CUDA stream and makes it the
  thread's current stream (PyTorch keeps the current stream per thread), so
  the kernels of concurrent requests run side by side.
- **One wait per fetch, on the caller's stream only.** ``device_fetch``
  queues the copies of every tensor to host on the calling thread's stream
  and waits for that stream once, never for the whole device: the JAX
  package's ``device_fetch`` likewise waits only for the arrays it is given.
- **Shared device state is complete before it is shared.** An object that
  other threads read (an arena, a group, a cached mask) is built on its
  builder's stream, which ``stream_wait`` drains before the object is
  published.
"""

from __future__ import annotations

import threading

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


_THREAD = threading.local()


def thread_stream(device: "str | torch.device") -> "torch.cuda.Stream | None":
    """The calling thread's own stream on a CUDA ``device``, made its current
    stream on first use; None (and nothing done) on the CPU.

    On first use the new stream waits for the work already queued on the
    thread's previous current stream, so tensors the thread made before are
    ready on it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    streams = getattr(_THREAD, "streams", None)
    if streams is None:
        streams = _THREAD.streams = {}
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(device=index)
        stream.wait_stream(torch.cuda.current_stream(index))
        # set_stream also makes the stream's card the thread's current
        # device; keep the caller's, or tensors later made on a device
        # without an index ("cuda") would land on this card
        current = torch.cuda.current_device()
        torch.cuda.set_stream(stream)
        if torch.cuda.current_device() != current:
            torch.cuda.set_device(current)
    return stream


def stream_wait(device: "str | torch.device") -> None:
    """Wait until the calling thread's current stream on ``device`` has
    finished its queued work (no-op on the CPU). Called before device state
    built by this thread is handed to others."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def device_fetch(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Copy several tensors to host numpy behind ONE wait for the calling
    thread's current stream (the stream the tensors were computed on)."""
    cuda = [t for t in tensors if t.is_cuda]
    if not cuda:
        return tuple(t.detach().numpy() for t in tensors)
    # non-blocking copies land in pinned host memory, queued behind the
    # kernels that produce the tensors
    host = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(cuda[0].device).synchronize()
    return tuple(h.numpy() for h in host)
