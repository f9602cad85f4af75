"""gRPC service plane for component-mode deployments.

Parity with the reference's gRPC surface (nidx_protos/nidx.proto — NidxApi,
NidxSearcher, NidxIndexer; nucliadb_protos writer/train services): the same
three services over real gRPC/HTTP2. Deviation: the image has no protobuf
codegen plugin for Python services, so messages are msgpack-encoded
structures (documented in codec.py) behind grpc generic handlers — the wire
framing, method routing, deadlines and streaming semantics stay gRPC.
"""

from .client import NodeClient
from .server import NodeGrpcServer
from .train import TrainClient, TrainGrpcServer
from .writer import WriterClient, WriterGrpcServer

__all__ = [
    "NodeGrpcServer", "NodeClient", "TrainGrpcServer", "TrainClient",
    "WriterGrpcServer", "WriterClient",
]
