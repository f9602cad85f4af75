"""Component mode: the services as independently runnable processes.

Parity with the reference's deployable components
(nidx/README.md:11-19 — indexer/scheduler/worker/searcher/api selected on
the command line, nidx/src/main.rs:48-55; plus the Python writer/ingest
split): ``python -m nucliadb_tpu_torch.component.run <component...>`` starts any
subset against shared state (sqlite metadata + KV + bus on a shared data
dir, or PG/NATS equivalents behind the same interfaces in a multi-host
deployment). The searcher/api component serves the node gRPC services; the
ingest component consumes the writer's bus stream.
"""
