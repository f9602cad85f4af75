"""The benchmark's data, made from the run's seed: corpus rows, queries,
paragraph keys, labels and deletions.

The recipe is ``chip_smoke.py:make_corpus``'s (itself ``bench.py``'s),
frozen here so that no later change to the program can move it: a row or a
query is a random centre plus 0.35 * N(0, 1) noise, L2-normalised; each of
the 1,024 centres owns a contiguous block of rows (a layout striding
clusters by a multiple of the slot count would put a whole cluster into one
slot). Each block of ``BLOCK_ROWS`` rows and each chunk of ``QUERY_CHUNK``
queries draws from a generator of its own, seeded from the run's seed and
its index, so that row ``i`` and query ``j`` are the same whatever else a
run makes, and the reference can make them again after the window.

Paragraph ``i`` belongs to resource ``i // 10`` (``key_of``). A label sits
on every ``label_every``-th paragraph; every ``delete_every``-th resource is
deleted. This module imports nothing of the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

N_CENTERS = 1024
NOISE = 0.35
BLOCK_ROWS = 131072
QUERY_CHUNK = 65536
PARAGRAPHS_PER_RESOURCE = 10
DELETED_RESIDUE = 37  # resource r is deleted when r % delete_every == this (mod delete_every)

# streams of queries: the measured pool and the warm-up's, which never meet
POOL = "pool"
WARMUP = "warmup"


def sub_seed(seed: int, *salt) -> int:
    """A 63-bit seed for one generator, from the run's seed and a salt."""
    text = repr((int(seed),) + tuple(salt)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def _generator(device, seed: int, *salt) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *salt))
    return gen


def centers(seed: int, d: int, device) -> torch.Tensor:
    return torch.randn(N_CENTERS, d, generator=_generator(device, seed, "centers", d), device=device)


def fill_rows(out: torch.Tensor, seed: int, n: int) -> torch.Tensor:
    """Rows ``0 .. out.shape[0]`` of an ``n``-row corpus, written into
    ``out`` ([rows, D] f32 on its device) a block at a time."""
    rows, d = out.shape
    device = out.device
    c = centers(seed, d, device)
    for lo in range(0, rows, BLOCK_ROWS):
        hi = min(rows, lo + BLOCK_ROWS)
        gen = _generator(device, seed, "rows", d, lo // BLOCK_ROWS)
        assign = torch.arange(lo, hi, device=device) * N_CENTERS // n
        block = c[assign] + NOISE * torch.randn(hi - lo, d, generator=gen, device=device)
        out[lo:hi] = block / block.norm(dim=-1, keepdim=True)
    return out


def rows(seed: int, n: int, d: int, device) -> torch.Tensor:
    """The whole ``[n, D]`` corpus on ``device``."""
    return fill_rows(torch.empty((n, d), dtype=torch.float32, device=device), seed, n)


def queries(seed: int, d: int, start: int, count: int, device, stream: str = POOL) -> torch.Tensor:
    """Queries ``start .. start + count`` of a stream, ``[count, D]`` f32."""
    c = centers(seed, d, device)
    out = torch.empty((count, d), dtype=torch.float32, device=device)
    j = start
    while j < start + count:
        chunk = j // QUERY_CHUNK
        gen = _generator(device, seed, "queries", stream, d, chunk)
        lo = chunk * QUERY_CHUNK
        assign = torch.randint(0, N_CENTERS, (QUERY_CHUNK,), generator=gen, device=device)
        noise = torch.randn(QUERY_CHUNK, d, generator=gen, device=device)
        hi = min(lo + QUERY_CHUNK, start + count)
        part = c[assign[j - lo : hi - lo]] + NOISE * noise[j - lo : hi - lo]
        out[j - start : hi - start] = part / part.norm(dim=-1, keepdim=True)
        j = hi
    return out


def query_pool(seed: int, d: int, count: int, device, stream: str = POOL) -> np.ndarray:
    """Queries ``0 .. count`` of a stream in host memory, made on ``device``
    a chunk at a time."""
    out = np.empty((count, d), dtype=np.float32)
    for lo in range(0, count, QUERY_CHUNK):
        hi = min(count, lo + QUERY_CHUNK)
        out[lo:hi] = queries(seed, d, lo, hi - lo, device, stream).cpu().numpy()
    return out


def key_of(i: int) -> str:
    """The paragraph key of row ``i``: resource ``i // 10``, field
    paragraph ``i % 10``. Zero-padded, so keys sort in row order."""
    return f"r{i // PARAGRAPHS_PER_RESOURCE:06d}/f/{i % PARAGRAPHS_PER_RESOURCE}/0-10"


def row_of(key: str) -> int:
    """The row of a key made by ``key_of``, or -1 for any other string."""
    try:
        i = int(key[1:7]) * PARAGRAPHS_PER_RESOURCE + int(key[10])
    except (ValueError, IndexError):
        return -1
    return i if key_of(i) == key else -1


def labelled(n: int, label_every: int) -> np.ndarray:
    """[n] bool: the paragraphs that carry the label."""
    mask = np.zeros(n, dtype=bool)
    mask[::label_every] = True
    return mask


def alive(n: int, delete_every: int) -> np.ndarray:
    """[n] bool: False on every paragraph of a deleted resource."""
    resource = np.arange(n) // PARAGRAPHS_PER_RESOURCE
    return resource % delete_every != DELETED_RESIDUE % delete_every
