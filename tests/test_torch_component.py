"""The port's component runner (``python -m nucliadb_tpu_torch.component.run``)
and its control socket, on the CPU.

``--device`` (default ``cuda``) is resolved where the JAX package
initialises its backend: after a substrate-only process has returned and
never in the ``--supervise`` parent. So on a machine without a card a
``--device cuda`` searcher fails at boot, before it binds its port, while
a substrate-only process and a supervisor start with the same option and
never reach the card.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "nucliadb_tpu_torch.component.run", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kw,
    )


def _wait_port(port, proc, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        assert proc.poll() is None, proc.stdout.read()
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"port {port} never came up")


def test_control_socket(tmp_path):
    from nucliadb_tpu_torch.component.control import ControlSocket, probe

    ready = {"ok": False}
    ctl = ControlSocket(str(tmp_path / "ctl.sock"), ready_check=lambda: ready["ok"])
    try:
        assert probe(str(tmp_path / "ctl.sock"), "alive")
        assert not probe(str(tmp_path / "ctl.sock"), "ready")
        ready["ok"] = True
        assert probe(str(tmp_path / "ctl.sock"), "ready")
    finally:
        ctl.close()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda component is valid here")


def test_cuda_searcher_without_a_card_fails_at_boot(tmp_path, no_card):
    port = _free_port()
    proc = _run(["searcher", "--data-dir", str(tmp_path / "d"), "--grpc-address", f"127.0.0.1:{port}"])
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in out, out
    assert "searcher/api gRPC" not in out
    assert not os.path.exists(tmp_path / "d" / "node")  # failed before the node opened a file


def test_substrate_only_process_never_resolves_the_device(tmp_path, no_card):
    """``--device cuda`` (the default) on a machine without a card: the
    substrate role serves, since it never reaches ``resolve_device``."""
    from nucliadb_tpu_torch.substrate import RemoteDriver

    port = _free_port()
    proc = _run(["substrate", "--serve-substrate", f"127.0.0.1:{port}", "--data-dir", str(tmp_path)])
    try:
        _wait_port(port, proc)
        kv = RemoteDriver(f"127.0.0.1:{port}")
        with kv as txn:
            txn.set("k", b"v")
        with kv as txn:
            assert txn.get("k") == b"v"
        kv.close()
        assert proc.poll() is None
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert "substrate (primary) served on port" in out and "Traceback" not in out, out


def test_supervisor_respawns_the_port_with_its_device(tmp_path, no_card):
    """The ``--supervise`` parent never resolves the device: it starts, and
    restarts its child (the port's runner, ``--device cuda`` kept), which
    fails at boot here."""
    port = _free_port()
    proc = _run(
        ["--supervise", "searcher", "--device", "cuda", "--data-dir", str(tmp_path), "--grpc-address",
         f"127.0.0.1:{port}"],
        start_new_session=True,
    )
    lines = []
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not any("restarting" in line for line in lines):
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
        assert proc.poll() is None, "".join(lines)  # the parent outlives its child
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=30)
    out = "".join(lines)
    assert "torch.cuda.is_available() is False" in out and "component exited with 1; restarting" in out, out


def test_device_option_reaches_every_node(tmp_path, monkeypatch):
    """``--device`` reaches the node of an in-process run: main() with the
    node class replaced records what it was given."""
    import nucliadb_tpu_torch.component.run as run

    seen = []

    class Stop(Exception):
        pass

    def node(**kw):
        seen.append(kw)
        raise Stop

    monkeypatch.setattr(run, "EmbeddedNode", node)
    for extra in ([], ["--substrate", "127.0.0.1:1"]):
        monkeypatch.setattr(sys, "argv", ["run", "scheduler", "--device", "cpu", "--data-dir", str(tmp_path), *extra])
        with pytest.raises(Stop):
            run.main()
    assert [str(kw["device"]) for kw in seen] == ["cpu", "cpu"]
    assert seen[1]["metadata"].__class__.__module__ == "nucliadb_tpu_torch.substrate"


def test_node_plane_imports_without_flatbuffers():
    """On a machine without ``flatbuffers`` (the Arrow IPC writer of the
    train modules needs it) the runner, the planes, the cluster and the
    substrate import, and the train modules stay unloaded until a train
    server is built."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'flatbuffers':\n"
        "            raise ImportError('no flatbuffers here')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import nucliadb_tpu_torch.component.run, nucliadb_tpu_torch.grpc_plane.proto_compat\n"
        "import nucliadb_tpu_torch.cluster, nucliadb_tpu_torch.substrate\n"
        "from nucliadb_tpu_torch.grpc_plane import NodeGrpcServer, TrainGrpcServer, WriterGrpcServer\n"
        "assert 'nucliadb_tpu_torch.train.arrow_ipc' not in sys.modules\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr
