"""Component runner: ``python -m nucliadb_tpu_torch.component.run indexer worker ...``

Components (any subset; parity nidx/src/main.rs:130-153):
  ingest     consume writer BrokerMessages from the bus (partition 0)
  scheduler  merge planning + purge loops on a timer
  worker     merge job execution loop
  searcher   node gRPC services (search plane) with periodic sync
  api        alias of searcher (shard admin rides the same gRPC server)
  train      Train gRPC service streaming training batches
  writer     Writer gRPC service (KB admin, ProcessMessage writes, backups)

All components share --data-dir (metadata/KV/bus/storage). Each process
death is fatal (supervisor restarts — parity: nidx panics on task death).

Counterpart of ``nucliadb_tpu/component/run.py``: the same components and
options plus ``--device`` (default ``cuda``; ``cpu`` for tests), resolved
where the JAX package initialises its backend and handed to the node. The
``--supervise`` parent and a substrate-only process never touch the card.
"""

from __future__ import annotations

import argparse
import threading
import time

from ..bus import EmbeddedBus
from ..common.kb import KnowledgeBoxManager
from ..ingest.consumer import IngestConsumer
from ..ingest.processor import Processor
from ..maindb import Driver
from ..services import EmbeddedNode


def main() -> None:
    import os as _os

    if any(
        _os.environ.get(k)
        for k in ("NDBTPU_TELEMETRY__TRACING", "NDBTPU_TELEMETRY__CONSOLE_TRACES",
                  "NDBTPU_TELEMETRY__OTLP")
    ):
        from ..telemetry.tracing import setup_tracing

        setup_tracing()

    parser = argparse.ArgumentParser(description="nucliadb_tpu_torch component runner")
    parser.add_argument("components", nargs="+",
                        choices=["ingest", "scheduler", "worker", "searcher",
                                 "api", "train", "writer", "substrate"])
    parser.add_argument("--data-dir", default="./data")
    parser.add_argument("--grpc-address", default="127.0.0.1:10000")
    parser.add_argument("--train-address", default="127.0.0.1:10001")
    parser.add_argument("--writer-address", default="127.0.0.1:10002")
    parser.add_argument("--interval", type=float, default=15.0)
    parser.add_argument(
        "--substrate", default="",
        help="host:port of a substrate server — metadata/bus/KV/blobs are"
        " consumed over the network instead of local files (the PG+NATS+"
        "object-store roles; parity: nidx/src/metadata.rs, indexer.rs NATS)",
    )
    parser.add_argument(
        "--serve-substrate", default="",
        help="address to SERVE the substrate on from this process (it owns"
        " the backing files under --data-dir); other hosts point their"
        " --substrate here",
    )
    parser.add_argument(
        "--substrate-standby", default="",
        help="with --serve-substrate: address of a standby substrate"
        " (started with --substrate-follower) to bootstrap and ship every"
        " mutating op to synchronously — zero acked-write loss on primary"
        " kill (the PG warm-standby posture, nidx/src/metadata.rs)",
    )
    parser.add_argument(
        "--substrate-follower", action="store_true",
        help="with --serve-substrate: start as an UNPROMOTED standby that"
        " serves nothing until promoted (repl.promote over the wire)",
    )
    parser.add_argument(
        "--substrate-ha-fence", action="store_true",
        help="with --substrate-standby: consistency-first mode — a failed"
        " ship FENCES this primary (mutations refused until a standby"
        " re-attaches) instead of detaching the standby; required for safe"
        " standby AUTO-promotion (no split-brain)",
    )
    parser.add_argument(
        "--substrate-watch-primary", default="",
        help="with --substrate-follower: probe the primary at this address"
        " and AUTO-PROMOTE after 4 missed probes (run the primary with"
        " --substrate-ha-fence); clients started with a comma-separated"
        " --substrate primary,standby list retarget themselves",
    )
    parser.add_argument(
        "--topology", default="",
        help="JSON node-list file watched for changes; with --node-name this"
        " searcher only syncs shards it owns per rendezvous placement and"
        " re-places on change (parity: K8s pod watch, shard_selector.rs)",
    )
    parser.add_argument("--node-name", default="")
    parser.add_argument(
        "--control-socket", default="",
        help="unix socket answering alive/ready probes (parity: nidx ctl)",
    )
    # the port's own option: where the node's searchers run
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the index node's searchers (cuda or cpu)",
    )
    parser.add_argument(
        "--supervise", action="store_true",
        help="restart the component process when it dies (parity: the "
        "reference panics on task death and relies on a supervisor)",
    )
    args = parser.parse_args()

    if args.supervise:
        # the supervisor must NOT touch the card: a parent holding a CUDA
        # context would keep the card's memory through every restart of
        # its children
        _supervise()
        return

    import os

    substrate_only = set(args.components) == {"substrate"}
    substrate_server = None
    if args.serve_substrate:
        from ..substrate import SubstrateServer

        substrate_server = SubstrateServer(
            os.path.join(args.data_dir, "substrate"),
            address=args.serve_substrate,
            follower=args.substrate_follower,
            ha_fence=args.substrate_ha_fence,
        )
        substrate_server.start()
        role = "standby" if args.substrate_follower else "primary"
        print(f"substrate ({role}) served on port {substrate_server.port}")
        if args.substrate_standby:
            substrate_server.attach_follower(args.substrate_standby)
            print(f"standby attached at {args.substrate_standby}")
        if args.substrate_watch_primary:
            if not args.substrate_follower:
                raise SystemExit("--substrate-watch-primary requires "
                                 "--substrate-follower")
            substrate_server.watch_primary(args.substrate_watch_primary)
            print(f"watching primary at {args.substrate_watch_primary} "
                  "(auto-promote on failure)")
        if args.substrate_follower or substrate_only:
            # a pure substrate role (primary or unpromoted standby) serves
            # only the data plane — never touch the card or boot
            # components in this process
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                substrate_server.stop()
            return
    elif substrate_only:
        raise SystemExit("component 'substrate' requires --serve-substrate")

    from ..utils.platform import resolve_device

    # fail fast, before any component thread starts: a --device cuda
    # component on a machine without a card raises here
    device = resolve_device(args.device)

    def make_driver():
        if substrate_server is not None:
            return substrate_server.driver
        if args.substrate:
            from ..substrate import RemoteDriver

            return RemoteDriver(args.substrate)
        return Driver(os.path.join(args.data_dir, "maindb.db"))

    def make_bus():
        if substrate_server is not None:
            return substrate_server.bus
        if args.substrate:
            from ..substrate import RemoteBus

            return RemoteBus(args.substrate)
        return EmbeddedBus(os.path.join(args.data_dir, "bus.db"))

    topology = None
    if args.topology:
        from ..cluster import TopologyWatcher

        topology = TopologyWatcher(args.topology)
        topology.start()
    node_kwargs = dict(
        selector=topology.selector if topology is not None else None,
        node_name=args.node_name or None,
        device=device,
    )
    if substrate_server is not None:
        node = EmbeddedNode(
            data_dir=os.path.join(args.data_dir, "node"),
            metadata=substrate_server.metadata,
            storage=substrate_server.storage,
            **node_kwargs,
        )
    elif args.substrate:
        from ..substrate import RemoteMetadataStore, RemoteStorage

        node = EmbeddedNode(
            data_dir=os.path.join(args.data_dir, "node"),
            metadata=RemoteMetadataStore(args.substrate),
            storage=RemoteStorage(args.substrate),
            **node_kwargs,
        )
    else:
        node = EmbeddedNode(
            data_dir=os.path.join(args.data_dir, "node"), **node_kwargs
        )
    threads: list[threading.Thread] = []
    stop = threading.Event()

    def loop(fn, interval):
        def body():
            while not stop.wait(interval):
                try:
                    fn()
                except Exception:
                    # task death kills the PROCESS (parity: nidx main.rs
                    # panics so the supervisor restarts) — a silently dead
                    # thread would leave a zombie component
                    import logging, os as _os, traceback

                    logging.getLogger(__name__).critical(
                        "component task died:\n%s", traceback.format_exc()
                    )
                    _os._exit(1)
        t = threading.Thread(target=body, daemon=True)
        t.start()
        threads.append(t)

    components = set(args.components)
    if "ingest" in components:
        driver = make_driver()
        bus = make_bus()
        kbs = KnowledgeBoxManager(driver, node)
        processor = Processor(driver, node, kbs)
        consumer = IngestConsumer(bus, processor)
        loop(consumer.drain, 0.2)

        def purge_bus():
            from ..ingest.consumer import INGEST_STREAM

            bus.purge_acked(INGEST_STREAM, [consumer.consumer])
            bus.purge_older_than("ndb_notify", 7 * 24 * 3600)
            bus.purge_older_than("ndb_audit", 30 * 24 * 3600)

        loop(purge_bus, 300.0)
        print("ingest consumer started")
    if "scheduler" in components:
        loop(lambda: node.scheduler.tick(), args.interval)
        print("scheduler started")
    if "worker" in components:
        def work():
            while node.worker.run_one():
                pass
        loop(work, 1.0)
        print("worker started")
    if components & {"searcher", "api"}:
        from ..grpc_plane import NodeGrpcServer

        server = NodeGrpcServer(node, address=args.grpc_address)
        server.start()
        loop(lambda: node.wait_for_sync(), 1.0)
        print(f"searcher/api gRPC on port {server.port}")

    if "train" in components:
        from ..grpc_plane import TrainGrpcServer

        driver_t = make_driver()
        kbs_t = KnowledgeBoxManager(driver_t, node)
        train_server = TrainGrpcServer(
            Processor(driver_t, node, kbs_t), address=args.train_address
        )
        train_server.start()
        print(f"train gRPC on port {train_server.port}")

    if "writer" in components:
        from ..grpc_plane import WriterGrpcServer

        driver_w = make_driver()
        kbs_w = KnowledgeBoxManager(driver_w, node)
        writer_server = WriterGrpcServer(
            kbs_w, Processor(driver_w, node, kbs_w), address=args.writer_address
        )
        writer_server.start()
        print(f"writer gRPC on port {writer_server.port}")

    if args.control_socket:
        from .control import ControlSocket

        ControlSocket(
            args.control_socket,
            ready_check=lambda: all(t.is_alive() for t in threads),
        )
        print(f"control socket at {args.control_socket}")

    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop.set()


def _supervise() -> None:
    """Restart-on-death wrapper around the component process."""
    import subprocess
    import sys

    argv = [a for a in sys.argv[1:] if a != "--supervise"]
    backoff = 1.0
    while True:
        started = time.time()
        proc = subprocess.Popen(
            [sys.executable, "-m", "nucliadb_tpu_torch.component.run", *argv]
        )
        code = proc.wait()
        if code == 0:
            return
        # reset backoff after a healthy stretch; cap at 30s
        backoff = 1.0 if time.time() - started > 60 else min(backoff * 2, 30.0)
        print(f"component exited with {code}; restarting in {backoff:.0f}s")
        time.sleep(backoff)


if __name__ == "__main__":
    main()
