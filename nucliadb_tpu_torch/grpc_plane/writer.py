"""Writer gRPC service: KB admin + resource writes + backups.

Parity: the reference's WriterServicer (nucliadb/src/nucliadb/ingest/
service/writer.py:78 — NewKnowledgeBox/DeleteKnowledgeBox/vectorset admin,
ProcessMessage for BrokerMessage-style writes, backup create/restore/delete)
served over gRPC for component deployments that drive ingestion without the
HTTP writer.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc
import msgpack

from ..common.kb import KnowledgeBoxManager
from ..ingest.processor import Processor
from ..models.api import (
    CreateResourcePayload,
    KnowledgeBoxConfig,
    UpdateResourcePayload,
    VectorSetSpec,
)

from .limits import MSG_OPTS as _MSG_OPTS

_SERVICE = "/ndbtpu.Writer/"


def _unary(fn):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=msgpack.unpackb, response_serializer=msgpack.packb
    )


class WriterGrpcServer:
    def __init__(self, kbs: KnowledgeBoxManager, processor: Processor,
                 address: str = "127.0.0.1:0", workers: int = 4):
        self.kbs = kbs
        self.processor = processor
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=workers), options=_MSG_OPTS
        )
        handlers = {
            "NewKnowledgeBox": _unary(self._new_kb),
            "DeleteKnowledgeBox": _unary(self._delete_kb),
            "ListKnowledgeBoxes": _unary(self._list_kbs),
            "NewVectorSet": _unary(self._new_vectorset),
            "DelVectorSet": _unary(self._del_vectorset),
            "ProcessMessage": _unary(self._process_message),
            "CreateBackup": _unary(self._create_backup),
            "RestoreBackup": _unary(self._restore_backup),
            "DeleteBackup": _unary(self._delete_backup),
        }
        self.server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("ndbtpu.Writer", handlers),)
        )
        self.port = self.server.add_insecure_port(address)

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 1.0) -> None:
        self.server.stop(grace)

    # ------------------------------------------------------------------

    def _new_kb(self, request, context):
        config = KnowledgeBoxConfig.model_validate(request.get("config", {}))
        kbid = self.kbs.create(config, kbid=request.get("kbid"))
        return {"kbid": kbid}

    def _delete_kb(self, request, context):
        self.kbs.delete(request["kbid"])
        return {"ok": True}

    def _list_kbs(self, request, context):
        return {"kbs": self.kbs.list_kbs()}

    def _new_vectorset(self, request, context):
        self.kbs.add_vectorset(
            request["kbid"], request["name"],
            VectorSetSpec.model_validate(request["spec"]),
        )
        return {"ok": True}

    def _del_vectorset(self, request, context):
        self.kbs.delete_vectorset(request["kbid"], request["name"])
        return {"ok": True}

    def _process_message(self, request, context):
        """One BrokerMessage-equivalent write (parity: ProcessMessage —
        the gRPC ingestion path that bypasses the HTTP writer)."""
        kbid = request["kbid"]
        op = request["op"]
        if op == "create":
            payload = CreateResourcePayload.model_validate(request.get("payload", {}))
            rid, seq = self.processor.create_resource(
                kbid, payload, rid=request.get("rid")
            )
            return {"rid": rid, "seq": int(seq)}
        if op == "update":
            payload = UpdateResourcePayload.model_validate(request.get("payload", {}))
            seq = self.processor.update_resource(kbid, request["rid"], payload)
            return {"rid": request["rid"], "seq": int(seq)}
        if op == "delete":
            seq = self.processor.delete_resource(kbid, request["rid"])
            return {"rid": request["rid"], "seq": int(seq) if seq is not None else None}
        raise ValueError(f"unknown op {op!r}")

    def _create_backup(self, request, context):
        from ..common.export_import import create_backup

        backup_id = create_backup(
            self.kbs, self.processor, self.processor.node.storage, request["kbid"]
        )
        return {"backup_id": backup_id}

    def _restore_backup(self, request, context):
        from ..common.export_import import restore_backup

        kbid = restore_backup(
            self.kbs, self.processor, self.processor.node.storage,
            request["backup_id"], slug=request.get("slug", ""),
        )
        return {"kbid": kbid}

    def _delete_backup(self, request, context):
        from ..common.export_import import delete_backup

        delete_backup(self.processor.node.storage, request["backup_id"])
        return {"ok": True}


class WriterClient:
    def __init__(self, address: str, timeout: float = 60.0):
        self.channel = grpc.insecure_channel(address, options=_MSG_OPTS)
        self.timeout = timeout

    def close(self) -> None:
        self.channel.close()

    def _call(self, method: str, request: dict) -> dict:
        fn = self.channel.unary_unary(
            _SERVICE + method,
            request_serializer=msgpack.packb,
            response_deserializer=msgpack.unpackb,
        )
        return fn(request, timeout=self.timeout)

    def new_kb(self, config: dict, kbid: Optional[str] = None) -> str:
        return self._call("NewKnowledgeBox", {"config": config, "kbid": kbid})["kbid"]

    def delete_kb(self, kbid: str) -> None:
        self._call("DeleteKnowledgeBox", {"kbid": kbid})

    def list_kbs(self) -> list[str]:
        return self._call("ListKnowledgeBoxes", {})["kbs"]

    def new_vectorset(self, kbid: str, name: str, spec: dict) -> None:
        self._call("NewVectorSet", {"kbid": kbid, "name": name, "spec": spec})

    def del_vectorset(self, kbid: str, name: str) -> None:
        self._call("DelVectorSet", {"kbid": kbid, "name": name})

    def process_message(self, kbid: str, op: str, *, rid: Optional[str] = None,
                        payload: Optional[dict] = None) -> dict:
        return self._call(
            "ProcessMessage", {"kbid": kbid, "op": op, "rid": rid, "payload": payload or {}}
        )

    def create_backup(self, kbid: str) -> str:
        return self._call("CreateBackup", {"kbid": kbid})["backup_id"]

    def restore_backup(self, backup_id: str, slug: str = "") -> str:
        return self._call("RestoreBackup", {"backup_id": backup_id, "slug": slug})["kbid"]

    def delete_backup(self, backup_id: str) -> None:
        self._call("DeleteBackup", {"backup_id": backup_id})
