"""Padded-size bucket ladder shared by every consolidated arena.

The port's copy of ``nucliadb_tpu/utils/buckets.py``, kept verbatim: the
port imports nothing of the JAX package.

Sizes come from {2^k, 1.5*2^k}: ~2 jit variants per octave while capping
padding waste at 33% (a pure power-of-two ladder wastes up to 2x — at
1M x 768 f32 that is 3.2 GB of HBM; for the text engine it inflates every
dense stopword row and mask transfer the same way).
"""

from __future__ import annotations

# A growing KB walks the ladder bucket by bucket, and EVERY bucket is a
# fresh XLA compile of every hot kernel (seconds to minutes each through
# the remote compile service on the deployment platform — the soak test
# spent its first minutes compiling instead of serving). Starting the
# ladder at 4096 rows removes ~10 tiny steps: a 4096-row arena costs
# ~12 MB HBM at 768-d f32 (nothing) and scanning it is sub-millisecond,
# so small KBs lose no measurable speed and gain a stable program shape
# until they exceed 4096 paragraphs.
MIN_BUCKET = 4096


def bucket(n: int, minimum: int = MIN_BUCKET) -> int:
    size = minimum
    while size < n:
        if size + size // 2 >= n:
            return size + size // 2
        size *= 2
    return size
