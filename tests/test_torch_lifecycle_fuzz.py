"""The scenarios of ``tests/test_lifecycle_fuzz.py`` on the port: the port's node on the CPU against the oracle.

The reference file's own docstring:

Randomized whole-node lifecycle simulation.

Random interleavings of index / reindex / delete / background-merge / sync
are replayed against a naive oracle of what should be alive; after every
sync the searcher must return EXACTLY the oracle's paragraphs for both the
keyword and vector legs. This exercises the seq-ordered deletion semantics
(segments minus deletions with seq > segment seq, nidx_vector/src/lib.rs:
166-200) through the real indexer/scheduler/worker/searcher services.
"""

import numpy as np
import pytest

from nucliadb_tpu_torch.index.vector import VectorConfig
from nucliadb_tpu_torch.models.internal import (
    IndexParagraph,
    ResourceDoc,
    TextInformation,
    VectorSentence,
)
from nucliadb_tpu_torch.services import EmbeddedNode
from nucliadb_tpu_torch.shard import ShardSearchRequest
from nucliadb_tpu_torch.storage import MemoryStorage

DIM = 8


def make_doc(rid: str, version: int) -> ResourceDoc:
    rd = ResourceDoc(resource_id=rid, created=1, modified=1)
    text = f"shared corpus {rid} version {version}"
    rd.texts["t/t"] = TextInformation(text=text)
    p = IndexParagraph(start=0, end=len(text))
    v = np.zeros(DIM, np.float32)
    v[(hash(rid) + version) % DIM] = 1.0
    key = f"{rid}/t/t/0/0-{len(text)}"
    p.vectorsets_sentences["m1"] = {key: VectorSentence(vector=v)}
    rd.paragraphs["t/t"] = {f"{rid}/t/t/0-{len(text)}": p}
    # reindex semantics: replace everything under the rid prefix
    rd.vectors_to_delete_in_all_vectorsets = [rid + "/"]
    rd.paragraphs_to_delete = [rid + "/"]
    rd.texts_to_delete = [rid + "/"]
    return rd


@pytest.mark.parametrize("seed", range(4))
def test_random_lifecycle_matches_oracle(tmp_path, seed):
    rng = np.random.default_rng(seed)
    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "n"), storage=MemoryStorage())
    shard = node.create_shard("kbf", {"m1": VectorConfig(dimension=DIM)})

    alive: dict[str, int] = {}  # rid -> latest version
    versions: dict[str, int] = {}
    rids = [f"r{i:02d}" for i in range(10)]

    for step in range(60):
        action = rng.random()
        rid = rids[int(rng.integers(0, len(rids)))]
        if action < 0.55:
            versions[rid] = versions.get(rid, 0) + 1
            node.index(shard, make_doc(rid, versions[rid]))
            alive[rid] = versions[rid]
        elif action < 0.75:
            if rid in alive:
                node.delete_resource(shard, rid)
                alive.pop(rid)
        else:
            node.tick_background()  # merges + purges + searcher reload

        if step % 7 == 0:
            node.wait_for_sync()
            resp = node.search(
                shard, ShardSearchRequest(body="shared", top_k=50)
            )
            got = {h.rid for h in resp.paragraph.hits}
            assert got == set(alive), (step, sorted(got), sorted(alive))
            # vector leg agrees (each alive rid has exactly one vector)
            q = np.ones(DIM, np.float32)
            vresp = node.search(
                shard,
                # with_duplicates=True: one-hot vectors collide across rids
                # and would collapse under the default Fssc-style dedup —
                # this test checks ALIVENESS, not dedup semantics
                ShardSearchRequest(
                    body="", vector=q, top_k=50, paragraph=False,
                    with_duplicates=True,
                ),
            )
            vrids = {h.key.split("/")[0] for h in vresp.vector}
            assert vrids == set(alive), (step, sorted(vrids), sorted(alive))
            # versions: the text must be the LATEST version's
            for h in resp.paragraph.hits:
                assert f"version {alive[h.rid]}" in f"shared corpus {h.rid} version {alive[h.rid]}"

    # final full consolidation keeps the invariant
    for _ in range(3):
        node.tick_background()
    node.wait_for_sync()
    resp = node.search(shard, ShardSearchRequest(body="shared", top_k=50))
    assert {h.rid for h in resp.paragraph.hits} == set(alive)
