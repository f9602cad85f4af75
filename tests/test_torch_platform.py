"""The port's platform helpers on the CPU: the per-thread stream is a
no-op there, and ``device_fetch`` hands back the tensors' values. (Their
CUDA behaviour is held by ``tests/test_torch_cuda.py``.)"""

import threading

import numpy as np
import torch

from nucliadb_tpu_torch.utils.platform import device_fetch, stream_wait, thread_stream


def test_thread_stream_is_a_no_op_on_the_cpu():
    out = []

    def run():
        out.append((thread_stream("cpu"), thread_stream(torch.device("cpu")), stream_wait("cpu")))

    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert out == [(None, None, None)]
    assert thread_stream("cpu") is None


def test_device_fetch_returns_the_same_arrays():
    gen = torch.Generator().manual_seed(3)
    tensors = (
        torch.randn(4, 5, generator=gen),
        torch.arange(7, dtype=torch.int32),
        torch.tensor([True, False, True]),
        torch.randn(3, generator=gen, requires_grad=True),
        torch.tensor(2.5),
    )
    got = device_fetch(*tensors)
    assert len(got) == len(tensors)
    for g, t in zip(got, tensors):
        assert isinstance(g, np.ndarray) and g.dtype == t.detach().numpy().dtype
        np.testing.assert_array_equal(g, t.detach().numpy())
    assert device_fetch() == ()
