"""The scenarios of ``tests/test_restart_durability.py`` on the port: the same requests
against the port's ``StandaloneApp`` on the CPU (``standalone_app``
binds ``device="cpu"``) and the port's modules.
"""

import numpy as np

from nucliadb_tpu_torch.models.api import (
    Classification,
    ConversationFieldPayload,
    ConversationMessage,
    CreateResourcePayload,
    FindRequest,
    KnowledgeBoxConfig,
    SearchFeature,
    SentenceEmbedding,
    TextFieldPayload,
    UpdateResourcePayload,
    UserMetadata,
    VectorSetSpec,
)
from tests.torch_test_helpers import standalone_app

DIM = 16


def embed(text):
    r = np.random.default_rng(abs(hash(text)) % (2**31))
    v = r.standard_normal(DIM).astype(np.float32)
    return (v / np.linalg.norm(v)).tolist()


def test_standalone_restart_serves_previous_state(tmp_path):
    StandaloneApp = standalone_app("nucliadb_tpu_torch")

    data_dir = str(tmp_path / "data")

    # ---- first "process": write a representative slice of state ----------
    app1 = StandaloneApp(data_dir=data_dir)
    kbid = app1.kbs.create(
        KnowledgeBoxConfig(slug="persist-kb", vectorsets={"m": VectorSetSpec(dimension=DIM)})
    )
    body = "durable content about persistence"
    rid, _ = app1.processor.create_resource(
        kbid,
        CreateResourcePayload(
            title="doc",
            slug="durable-doc",
            texts={"t": TextFieldPayload(body=body)},
            conversations={
                "chat": ConversationFieldPayload(
                    messages=[ConversationMessage(text="hello there", ident="m1")]
                )
            },
            usermetadata=UserMetadata(
                classifications=[Classification(labelset="topic", label="storage")]
            ),
            embeddings={"m": {"t": [SentenceEmbedding(start=0, end=len(body), vector=embed(body))]}},
        ),
    )
    app1.labels.set_labelset(kbid, "topic", {"title": "Topic", "labels": [{"title": "storage"}]})
    app1.node.storage.put(f"blobs/{kbid}/{rid}/file1", b"blob-bytes")
    app1._sync(force=True)
    # run a merge-producing tick so segments move through the lifecycle
    app1.processor.update_resource(kbid, rid, UpdateResourcePayload(summary="updated"))
    app1.node.tick_background()
    app1.stop_background()
    del app1

    # ---- second "process": same dir, everything must be there ------------
    app2 = StandaloneApp(data_dir=data_dir)
    assert app2.kbs.resolve_slug("persist-kb") == kbid
    assert app2.processor.resolve_slug(kbid, "durable-doc") == rid
    payload = app2.processor.get_payload(kbid, rid)
    assert payload.texts["t"].body == body
    assert payload.summary == "updated"
    assert payload.conversations["chat"].messages[0].text == "hello there"
    assert app2.node.storage.get(f"blobs/{kbid}/{rid}/file1") == b"blob-bytes"
    assert "topic" in app2.labels.list_labelsets(kbid)

    app2._sync(force=True)
    # keyword + semantic legs both serve from the reopened segments
    out = app2.search.find(
        kbid, FindRequest(query="durable persistence", features=[SearchFeature.KEYWORD])
    )
    assert rid in out.resources
    out2 = app2.search.find(
        kbid,
        FindRequest(query="", features=[SearchFeature.SEMANTIC], vector=embed(body)),
    )
    assert rid in out2.resources

    # and writes keep working after the restart (seq continuity)
    rid2, seq2 = app2.processor.create_resource(
        kbid, CreateResourcePayload(title="post-restart", texts={"t": TextFieldPayload(body="written after restart")})
    )
    app2._sync(force=True)
    out3 = app2.search.find(
        kbid, FindRequest(query="after restart", features=[SearchFeature.KEYWORD])
    )
    assert rid2 in out3.resources
    app2.stop_background()
