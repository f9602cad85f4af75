"""Train gRPC service: stream training batches to external consumers.

Parity: the reference's Train servicer (nucliadb/src/nucliadb/train/
servicer.py:47-110, train.proto Train service — GetSentences/GetParagraphs/
GetFields/GetResources streams): one unary-stream method per task type,
each yielding msgpack-encoded batches assembled by the train generators.
The nucliadb_dataset exporter consumes the same generators; this service is
the remote transport for them.

Counterpart of ``nucliadb_tpu/grpc_plane/train.py``; it imports the train
modules when a server is built, not when the plane is imported: they load
the Arrow IPC writer, which needs ``flatbuffers``, and a machine without
it must still import the node plane beside this module.
"""

from __future__ import annotations

from concurrent import futures
from dataclasses import asdict

import grpc
import msgpack

from ..ingest.processor import Processor

from .limits import MSG_OPTS as _MSG_OPTS


_SERVICE = "/ndbtpu.Train/"


class TrainGrpcServer:
    """Serves every registered train task as a batch stream.

    Method name = task name (paragraph_classification, sentences, ...);
    request = msgpack {kbid, batch_size, labelset?}; each response message
    is one msgpack batch (column dict).
    """

    def __init__(self, processor: Processor, address: str = "127.0.0.1:0", workers: int = 4):
        from ..train.dataset import GENERATORS

        self.processor = processor
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=workers), options=_MSG_OPTS
        )
        handlers = {
            task: grpc.unary_stream_rpc_method_handler(
                self._stream_for(task),
                request_deserializer=msgpack.unpackb,
                response_serializer=msgpack.packb,
            )
            for task in GENERATORS
        }
        self.server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("ndbtpu.Train", handlers),)
        )
        self.port = self.server.add_insecure_port(address)

    def _stream_for(self, task: str):
        from ..train.dataset import GENERATORS
        from ..train.generators import TrainSet

        generator_fn = GENERATORS[task]

        def stream(request, context):
            trainset = TrainSet(
                kbid=request["kbid"],
                batch_size=int(request.get("batch_size", 32)),
                labelset=request.get("labelset"),
            )
            for batch in generator_fn(self.processor, trainset):
                yield asdict(batch)

        return stream

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 1.0) -> None:
        self.server.stop(grace)


class TrainClient:
    def __init__(self, address: str, timeout: float = 60.0):
        self.channel = grpc.insecure_channel(address, options=_MSG_OPTS)
        self.timeout = timeout

    def close(self) -> None:
        self.channel.close()

    def batches(self, task: str, kbid: str, *, batch_size: int = 32,
                labelset: str | None = None):
        """Yield column-dict batches for one task."""
        fn = self.channel.unary_stream(
            _SERVICE + task,
            request_serializer=msgpack.packb,
            response_deserializer=msgpack.unpackb,
        )
        request = {"kbid": kbid, "batch_size": batch_size}
        if labelset:
            request["labelset"] = labelset
        yield from fn(request, timeout=self.timeout)
