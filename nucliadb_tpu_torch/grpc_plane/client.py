"""gRPC client for the node services (and searcher-to-searcher forwarding)."""

from __future__ import annotations

from typing import Optional

import grpc
import msgpack

from ..models.internal import ResourceDoc
from ..shard import ShardSearchRequest, ShardSearchResponse
from . import codec

from .limits import MSG_OPTS as _MSG_OPTS


_SERVICE = "/nidx.Node/"


class NodeClient:
    def __init__(self, address: str, timeout: float = 30.0):
        self.channel = grpc.insecure_channel(address, options=_MSG_OPTS)
        self.timeout = timeout

    def close(self) -> None:
        self.channel.close()

    def _unary(self, method: str, req_ser, resp_deser):
        return self.channel.unary_unary(
            _SERVICE + method,
            request_serializer=req_ser,
            response_deserializer=resp_deser,
        )

    # ---- api ----------------------------------------------------------------

    def new_shard(self, kbid: str, vectorsets: dict, shard_id: Optional[str] = None) -> str:
        fn = self._unary("NewShard", msgpack.packb, msgpack.unpackb)
        out = fn(
            {
                "kbid": kbid,
                "vectorsets": {k: v.to_dict() for k, v in vectorsets.items()},
                "shard_id": shard_id,
            },
            timeout=self.timeout,
        )
        return out["shard_id"]

    def delete_shard(self, shard_id: str) -> None:
        self._unary("DeleteShard", msgpack.packb, msgpack.unpackb)(
            {"shard_id": shard_id}, timeout=self.timeout
        )

    def list_shards(self, kbid: Optional[str] = None) -> list[dict]:
        fn = self._unary("ListShards", msgpack.packb, msgpack.unpackb)
        return fn({"kbid": kbid}, timeout=self.timeout)["shards"]

    def get_shard(self, shard_id: str) -> dict:
        fn = self._unary("GetShard", msgpack.packb, msgpack.unpackb)
        return fn({"shard_id": shard_id}, timeout=self.timeout)

    # ---- indexer -------------------------------------------------------------

    def index(self, shard_id: str, doc: ResourceDoc, hidden: bool = False) -> int:
        fn = self._unary("Index", lambda b: b, msgpack.unpackb)
        out = fn(
            msgpack.packb(
                {
                    "shard_id": shard_id,
                    "hidden": hidden,
                    "resource": codec.pack_resource(doc),
                }
            ),
            timeout=self.timeout,
        )
        return out["seq"]

    def delete_resource(self, shard_id: str, resource_id: str) -> int:
        fn = self._unary("Delete", msgpack.packb, msgpack.unpackb)
        return fn(
            {"shard_id": shard_id, "resource_id": resource_id}, timeout=self.timeout
        )["seq"]

    # ---- searcher -------------------------------------------------------------

    def search(self, shard_id: str, request: ShardSearchRequest) -> ShardSearchResponse:
        fn = self._unary("Search", lambda b: b, lambda b: b)
        out = fn(
            msgpack.packb(
                {"shard_id": shard_id, "request": codec.pack_search_request(request)}
            ),
            timeout=self.timeout,
        )
        return codec.unpack_search_response(out)

    def suggest(self, shard_id: str, query: str, top_k: int = 10) -> dict:
        fn = self._unary("Suggest", msgpack.packb, msgpack.unpackb)
        return fn(
            {"shard_id": shard_id, "query": query, "top_k": top_k},
            timeout=self.timeout,
        )

    def graph_search(self, shard_id: str, **pattern) -> list[dict]:
        """Pattern kwargs: source_value/source_type/relation_label/
        target_value/target_type/fuzzy/undirected/top_k."""
        fn = self._unary("GraphSearch", msgpack.packb, msgpack.unpackb)
        return fn(
            {"shard_id": shard_id, **pattern}, timeout=self.timeout
        )["paths"]

    def stream_paragraphs(self, shard_id: str):
        fn = self.channel.unary_stream(
            _SERVICE + "Paragraphs",
            request_serializer=msgpack.packb,
            response_deserializer=msgpack.unpackb,
        )
        yield from fn({"shard_id": shard_id}, timeout=self.timeout)

    def stream_documents(self, shard_id: str):
        fn = self.channel.unary_stream(
            _SERVICE + "Documents",
            request_serializer=msgpack.packb,
            response_deserializer=msgpack.unpackb,
        )
        yield from fn({"shard_id": shard_id}, timeout=self.timeout)

    def sync(self) -> list[str]:
        fn = self._unary("Sync", msgpack.packb, msgpack.unpackb)
        return fn({}, timeout=self.timeout)["synced"]
