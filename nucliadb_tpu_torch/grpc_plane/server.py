"""gRPC server exposing the node's three services.

Method surface parity (nidx_protos/nidx.proto:8-34):
- NidxApi:     NewShard, DeleteShard, ListShards, ConfigureShards,
  AddVectorSet, RemoveVectorSet, ListVectorSets, GetShard
- NidxIndexer: Index, Delete
- NidxSearcher: Search, Suggest, GraphSearch, ExtractedTexts,
  Paragraphs (stream), Documents (stream) — the stream pair feeds
  train/export consumers (nodereader.proto StreamRequest).
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Optional

import grpc
import msgpack

from ..index.vector.config import VectorConfig
from ..services import EmbeddedNode
from . import codec

from .limits import MSG_OPTS as _MSG_OPTS



def _unary(fn, req_deser, resp_ser):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=req_deser, response_serializer=resp_ser
    )


class NodeGrpcServer:
    def __init__(self, node: EmbeddedNode, address: str = "127.0.0.1:0", workers: int = 8):
        self.node = node
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=workers), options=_MSG_OPTS
        )
        handlers = {
            # ---- NidxApi ----
            "NewShard": _unary(self._new_shard, msgpack.unpackb, msgpack.packb),
            "DeleteShard": _unary(self._delete_shard, msgpack.unpackb, msgpack.packb),
            "ListShards": _unary(self._list_shards, msgpack.unpackb, msgpack.packb),
            "AddVectorSet": _unary(self._add_vectorset, msgpack.unpackb, msgpack.packb),
            "RemoveVectorSet": _unary(self._remove_vectorset, msgpack.unpackb, msgpack.packb),
            "ListVectorSets": _unary(self._list_vectorsets, msgpack.unpackb, msgpack.packb),
            "ConfigureShards": _unary(self._configure_shards, msgpack.unpackb, msgpack.packb),
            "GetShard": _unary(self._get_shard, msgpack.unpackb, msgpack.packb),
            # ---- NidxIndexer ----
            "Index": _unary(self._index, lambda b: b, msgpack.packb),
            "Delete": _unary(self._delete, msgpack.unpackb, msgpack.packb),
            # ---- NidxSearcher ----
            "Search": _unary(self._search, lambda b: b, lambda b: b),
            "Suggest": _unary(self._suggest, msgpack.unpackb, msgpack.packb),
            "GraphSearch": _unary(self._graph_search, msgpack.unpackb, msgpack.packb),
            "ExtractedTexts": _unary(self._extracted_texts, msgpack.unpackb, msgpack.packb),
            "Paragraphs": grpc.unary_stream_rpc_method_handler(
                self._paragraphs, request_deserializer=msgpack.unpackb,
                response_serializer=msgpack.packb,
            ),
            "Documents": grpc.unary_stream_rpc_method_handler(
                self._documents, request_deserializer=msgpack.unpackb,
                response_serializer=msgpack.packb,
            ),
            "Sync": _unary(self._sync, msgpack.unpackb, msgpack.packb),
        }
        self.server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("nidx.Node", handlers),)
        )
        # protobuf-wire NidxApi/NidxSearcher for reference clients
        # (nidx_protos/nidx.proto service names, real proto bytes)
        from .proto_compat import register_proto_services

        register_proto_services(self.server, node)
        self.port = self.server.add_insecure_port(address)

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 1.0) -> None:
        self.server.stop(grace)

    # ---- api ----------------------------------------------------------------

    def _new_shard(self, request, context):
        vectorsets = {
            name: VectorConfig.from_dict(cfg)
            for name, cfg in request.get("vectorsets", {}).items()
        }
        shard_id = self.node.create_shard(
            request["kbid"], vectorsets, shard_id=request.get("shard_id")
        )
        return {"shard_id": shard_id}

    def _delete_shard(self, request, context):
        self.node.delete_shard(request["shard_id"])
        return {"ok": True}

    def _list_shards(self, request, context):
        shards = self.node.metadata.list_shards(request.get("kbid"))
        return {"shards": [{"id": s.id, "kbid": s.kbid} for s in shards]}

    def _add_vectorset(self, request, context):
        self.node.add_vectorset(
            request["shard_id"],
            request["name"],
            VectorConfig.from_dict(request["config"]),
        )
        return {"ok": True}

    def _remove_vectorset(self, request, context):
        self.node.delete_vectorset(request["shard_id"], request["name"])
        return {"ok": True}

    def _list_vectorsets(self, request, context):
        return {"vectorsets": self.node.list_vectorsets(request["shard_id"])}

    def _configure_shards(self, request, context):
        self.node.configure_shards(request.get("configs", []))
        return {"ok": True}

    def _get_shard(self, request, context):
        """Shard stats (parity: GetShard — fields/paragraphs/size)."""
        shard_id = request["shard_id"]
        stats = {"shard_id": shard_id, "indexes": []}
        for index in self.node.metadata.get_indexes(shard_id):
            segs = self.node.metadata.ready_segments(index.id)
            prewarm = 0
            for s in segs:
                if index.kind == "vector":
                    # device-resident bytes a searcher loads to serve: the
                    # int8 code arena + the f32 rerank arena (parity:
                    # GetShard prewarm size, api/shards.rs)
                    n = int(s.index_metadata.get("n_vectors", s.records))
                    dim = int(s.index_metadata.get("dim", 0))
                    prewarm += n * dim * (1 + 4)
                else:
                    prewarm += s.size_bytes
            stats["indexes"].append(
                {
                    "kind": index.kind,
                    "name": index.name,
                    "segments": len(segs),
                    "records": sum(s.records for s in segs),
                    "size_bytes": sum(s.size_bytes for s in segs),
                    "prewarm_bytes": prewarm,
                }
            )
        return stats

    # ---- indexer -------------------------------------------------------------

    def _index(self, request: bytes, context):
        envelope = msgpack.unpackb(request)
        doc = codec.unpack_resource(envelope["resource"])
        seq = self.node.index(
            envelope["shard_id"], doc, hidden=envelope.get("hidden", False)
        )
        return {"seq": int(seq)}

    def _delete(self, request, context):
        seq = self.node.delete_resource(request["shard_id"], request["resource_id"])
        return {"seq": int(seq)}

    # ---- searcher -------------------------------------------------------------

    def _search(self, request: bytes, context) -> bytes:
        envelope = msgpack.unpackb(request)
        req = codec.unpack_search_request(envelope["request"])
        resp = self.node.search(envelope["shard_id"], req)
        return codec.pack_search_response(resp)

    def _suggest(self, request, context):
        """Shard-level suggest (parity: NidxSearcher.Suggest): fuzzy
        paragraph prefix matches + entity-prefix nodes."""
        shard_id = request["shard_id"]
        searcher = self.node.searcher.shard(shard_id)
        top_k = int(request.get("top_k", 10))
        query = request.get("query", "")
        out = {"paragraphs": [], "entities": []}
        if searcher.paragraph is not None:
            for hit in searcher.paragraph.suggest(query, top_k):
                out["paragraphs"].append(
                    {"id": hit.paragraph_id, "score": hit.score,
                     "rid": hit.rid, "field": hit.field,
                     "start": hit.start, "end": hit.end}
                )
        if searcher.relation is not None:
            out["entities"] = [
                n.value for n in searcher.relation.suggest_nodes(query, top_k)
            ]
        return out

    def _graph_search(self, request, context):
        """Shard-level path query (parity: NidxSearcher.GraphSearch)."""
        from ..index.relation import GraphSearchRequest, NodePattern, RelationPattern

        searcher = self.node.searcher.shard(request["shard_id"])
        if searcher.relation is None:
            return {"paths": []}
        greq = GraphSearchRequest(
            source=NodePattern(
                value=request.get("source_value"),
                ntype=request.get("source_type"),
                fuzzy=bool(request.get("fuzzy")),
            ),
            relation=RelationPattern(label=request.get("relation_label")),
            target=NodePattern(
                value=request.get("target_value"),
                ntype=request.get("target_type"),
                fuzzy=bool(request.get("fuzzy")),
            ),
            undirected=bool(request.get("undirected")),
            top_k=int(request.get("top_k", 50)),
        )
        return {
            "paths": [
                {"source": p.source.value, "source_type": p.source.ntype,
                 "relation": p.relation, "label": p.label,
                 "target": p.target.value, "target_type": p.target.ntype}
                for p in searcher.relation.graph_search(greq)
            ]
        }

    def _extracted_texts(self, request, context):
        """Extracted text from the index's stored field text (parity:
        NidxSearcher.ExtractedTexts, nidx.proto:25)."""
        return self.node.extracted_texts(
            request["shard_id"],
            request.get("field_ids"),
            request.get("paragraph_ids"),
        )

    def _paragraphs(self, request, context):
        """Stream every live paragraph id of a shard (parity:
        NidxSearcher.Paragraphs over StreamRequest — consumers hydrate
        text from storage, as the reference's train generators do)."""
        searcher = self.node.searcher.shard(request["shard_id"])
        if searcher.paragraph is None:
            return
        engine = searcher.paragraph.engine
        for i, key in enumerate(engine.keys):
            if engine.alive[i]:
                yield {"id": key}

    def _documents(self, request, context):
        """Stream every live field document of a shard (parity:
        NidxSearcher.Documents)."""
        searcher = self.node.searcher.shard(request["shard_id"])
        if searcher.text is None:
            return
        engine = searcher.text.engine
        for i, key in enumerate(engine.keys):
            if engine.alive[i]:
                rid, _, field = key.partition("/")
                yield {"uuid": rid, "field": field}

    def _sync(self, request, context):
        return {"synced": self.node.wait_for_sync()}
