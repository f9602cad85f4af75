"""The benchmark of the PyTorch and CUDA port, ``nucliadb_tpu_torch``. See
``run.py`` and ``harness.py``; nothing here imports JAX or the JAX package."""
