"""Shared gRPC channel/server limits for every plane.

Index/search payloads (vectors, text blocks, packed segments) routinely
exceed gRPC's 4 MB default; one definition keeps the node/writer/train
planes and the substrate plane from drifting apart.
"""

MAX_MSG = 512 * 1024 * 1024

MSG_OPTS = [
    ("grpc.max_send_message_length", MAX_MSG),
    ("grpc.max_receive_message_length", MAX_MSG),
]
