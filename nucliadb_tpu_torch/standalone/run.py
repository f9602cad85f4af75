"""Standalone entrypoint: ``python -m nucliadb_tpu_torch.standalone.run``.

Parity: the reference's ``nucliadb`` binary (standalone/run.py:84-147).

Counterpart of ``nucliadb_tpu/standalone/run.py``: the same options plus
``--device`` (default ``cuda``; ``cpu`` for tests), which reaches the app's
node and every replica's command line.
"""

from __future__ import annotations

import argparse
import asyncio

from .app import StandaloneApp


def replica_args(args: argparse.Namespace) -> list[str]:
    """The options a primary hands its replicas (the port builds them here,
    apart from ``main``, so that they can be read without spawning)."""
    extra = ["--replica-of", "auto", "--auth-policy", args.auth_policy]
    extra += ["--device", args.device]  # replicas run where the primary runs
    for entry in args.api_key:
        extra += ["--api-key", entry]
    if args.local_predict:
        extra.append("--local-predict")
    return extra


def main() -> None:
    parser = argparse.ArgumentParser(description="nucliadb_tpu standalone server")
    parser.add_argument("--data-dir", default="./data")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--bg-interval", type=float, default=15.0)
    parser.add_argument(
        "--workers", type=int, default=1,
        help="worker processes sharing the port via SO_REUSEPORT: worker 0 "
        "is the primary (ingest + background jobs), the rest are read "
        "replicas proxying writes to it (the reference's uvicorn-replicas "
        "deployment story, standalone/run.py:84-147)",
    )
    parser.add_argument(
        "--replica-of", default=None,
        help="internal: run as a read replica; 'auto' reads the primary's "
        "private address from <data-dir>/primary.json",
    )
    parser.add_argument(
        "--auth-policy", default="insecure",
        choices=["insecure", "upstream_naive", "api_key"],
        help="auth mode (parity: reference auth_policy settings)",
    )
    parser.add_argument(
        "--api-key", action="append", default=[],
        metavar="TOKEN=ROLE1;ROLE2",
        help="api_key policy: static token to roles (repeatable)",
    )
    parser.add_argument(
        "--local-predict", action="store_true",
        help="enable the in-process hashing predict engine (query embedding "
        "without an external model — useful for demos/tests)",
    )
    # the port's own option: where the node's searchers run
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the index node's searchers (cuda or cpu)",
    )
    args = parser.parse_args()

    import os as _os

    if any(
        _os.environ.get(k)
        for k in ("NDBTPU_TELEMETRY__TRACING", "NDBTPU_TELEMETRY__CONSOLE_TRACES",
                  "NDBTPU_TELEMETRY__OTLP")
    ):
        from ..telemetry.tracing import setup_tracing

        setup_tracing()


    from .auth import AuthSettings

    api_keys = {}
    for entry in args.api_key:
        token, _, roles = entry.partition("=")
        api_keys[token] = [
            role.strip().upper() for role in roles.split(";") if role.strip()
        ]
    auth = AuthSettings(policy=args.auth_policy, api_keys=api_keys)
    predict = None
    if args.local_predict:
        from ..search.predict import LocalPredictEngine

        predict = LocalPredictEngine()

    replica_of = args.replica_of
    if replica_of == "auto":
        import json
        import os
        import time

        # the primary writes its private address after binding; give a
        # freshly-spawned replica a grace window to find it
        path = os.path.join(args.data_dir, "primary.json")
        for _ in range(100):
            if os.path.exists(path):
                break
            time.sleep(0.2)
        with open(path) as f:
            replica_of = json.load(f)["url"]

    multi = args.workers > 1 or replica_of is not None
    app = StandaloneApp(
        data_dir=args.data_dir, host=args.host, port=args.port,
        auth=auth, predict=predict, replica_of=replica_of,
        reuse_port=multi, device=args.device,
    )
    app.start_background(args.bg_interval)
    role = "replica" if replica_of else "standalone"
    print(f"nucliadb_tpu {role} listening on http://{args.host}:{args.port}",
          flush=True)

    replicas: list = []

    def _reap_replicas(*_sig) -> None:
        for p in replicas:
            try:
                p.terminate()
            except Exception:
                pass
        raise SystemExit(0)

    async def serve():
        if replica_of is None and args.workers > 1:
            import atexit
            import json
            import os
            import signal

            from .workers import spawn_replicas

            private_port = await app.start_private_listener()
            with open(os.path.join(args.data_dir, "primary.json"), "w") as f:
                json.dump({"url": f"http://127.0.0.1:{private_port}"}, f)
            replicas.extend(spawn_replicas(
                args.workers - 1, data_dir=args.data_dir, host=args.host,
                port=args.port, extra_args=replica_args(args),
            ))
            # the primary owns replica lifetime: a supervisor's SIGTERM (or
            # a normal exit) must not orphan workers holding the port
            signal.signal(signal.SIGTERM, _reap_replicas)
            atexit.register(lambda: [p.terminate() for p in replicas])
        try:
            await app.server.serve_forever()
        finally:
            for p in replicas:
                p.terminate()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    finally:
        app.stop_background()


if __name__ == "__main__":
    main()
