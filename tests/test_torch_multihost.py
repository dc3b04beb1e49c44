"""The fleet's process group (``omldm_tpu_torch.parallel.multihost``) on the
CPU: the single-process no-op, a join that fails, two processes joined
over gloo, and the backend rule."""

import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from omldm_tpu_torch.parallel import multihost
from omldm_tpu_torch.parallel.mesh import Mesh, make_mesh

ROOT = Path(__file__).resolve().parents[1]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(code: str, timeout: float = 120):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_initialize_single_host_noop():
    assert multihost.initialize_multihost() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_single_process_mesh_is_make_mesh():
    assert multihost.make_multihost_mesh("cpu") == make_mesh(device="cpu")


@pytest.mark.parametrize("device_type,processes,cards,backend", [
    ("cpu", 2, 0, "gloo"),
    ("cpu", 4, 8, "gloo"),
    ("cuda", 2, 1, "gloo"),   # two ranks on one card: NCCL refuses
    ("cuda", 4, 2, "gloo"),
    ("cuda", 2, 2, "nccl"),   # a card a process
    ("cuda", 4, 8, "nccl"),
])
def test_backend_rule(device_type, processes, cards, backend):
    assert multihost.choose_backend(device_type, processes, cards) == backend


def test_process_device_on_the_cpu():
    assert multihost.process_device("cpu", 3) == torch.device("cpu")


def test_host_local_array_is_the_identity_on_local_rows():
    mesh = Mesh(4, 1, "cpu", processes=2, process_id=1)
    rows = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = multihost.host_local_array(rows, mesh)
    np.testing.assert_array_equal(out.numpy(), rows)
    with pytest.raises(ValueError, match="dp_local=2"):
        multihost.host_local_array(rows[:1], mesh)


@pytest.mark.parametrize("args,message", [
    (("127.0.0.1:1", 2, None), "needs the coordinator"),
    (("127.0.0.1:1", 2, 2), "outside"),
])
def test_join_refuses_a_half_named_fleet(args, message):
    with pytest.raises(ValueError, match=message):
        multihost.initialize_multihost(*args, device="cpu")


def test_failed_join_retries_each_attempt_then_raises(monkeypatch):
    """Each refused join is retried under the backoff helper until the
    attempts run out; then the last error raises."""
    calls = []

    def refused(*args, **kwargs):
        calls.append(kwargs)
        raise torch.distributed.DistNetworkError("connection refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", refused)
    with pytest.raises(torch.distributed.DistNetworkError):
        multihost.initialize_multihost("127.0.0.1:1", 2, 1, connect_attempts=3, device="cpu")
    assert len(calls) == 3
    assert all(c["init_method"] == "tcp://127.0.0.1:1" and c["rank"] == 1 for c in calls)
    assert not torch.distributed.is_initialized()


def test_failed_join_raises_after_its_attempts():
    """A non-zero rank whose coordinator never comes up retries its join
    within the join's deadline and then raises; it does not go on as one
    process (how many attempts fit the deadline depends on the host's
    load: the count of attempts is the test above)."""
    result = _run(f"""
        import time, torch.distributed as dist
        from omldm_tpu_torch.parallel import multihost
        calls = []
        real = dist.init_process_group
        def counted(*a, **kw):
            calls.append(time.monotonic())
            return real(*a, **kw)
        dist.init_process_group = counted
        try:
            multihost.initialize_multihost("127.0.0.1:{_free_port()}", 2, 1,
                                           connect_attempts=2, connect_timeout_s=6.0,
                                           device="cpu")
        except (RuntimeError, OSError) as exc:
            print("RAISED", len(calls), dist.is_initialized(), type(exc).__name__)
        else:
            print("JOINED")
    """)
    assert result.returncode == 0, result.stderr[-2000:]
    words = result.stdout.split()
    assert words[0] == "RAISED" and words[1] in ("1", "2") and words[2] == "False", result.stdout


def test_two_processes_join_reduce_and_broadcast(tmp_path):
    """Two processes join over gloo (the backend printed at join), reduce by
    sum, max and min, broadcast process 0's frame and gather each one's
    rows in process order."""
    port = _free_port()
    code = """
        import json, sys, torch
        from omldm_tpu_torch.parallel import multihost
        pid = {pid}
        print(json.dumps(multihost.initialize_multihost("127.0.0.1:{port}", 2, pid,
                                                        device="cpu")))
        v = torch.tensor([1.0 + pid, 10.0 * pid, -pid], dtype=torch.float64)
        out = {{
            "sum": multihost.all_reduce(v.clone(), "sum").tolist(),
            "max": multihost.all_reduce(v.clone(), "max").tolist(),
            "min": multihost.all_reduce(v.clone(), "min").tolist(),
            "bcast": multihost.broadcast(torch.full((4,), 7 + pid, dtype=torch.uint8)).tolist(),
            "gather": multihost.all_gather(torch.full((1, 2), float(pid))).tolist(),
        }}
        # a strided operand is reduced in place all the same
        m = torch.arange(6.0).reshape(2, 3).t()
        multihost.all_reduce(m)
        out["strided"] = m.tolist()
        print(json.dumps(out))
        multihost.shutdown_multihost()
    """
    procs = [subprocess.Popen([sys.executable, "-c",
                               textwrap.dedent(code).format(pid=pid, port=port)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert "over gloo" in err
        joined, got = (json.loads(line) for line in out.strip().splitlines())
        assert joined == [pid, 2]
        assert got["sum"] == [3.0, 10.0, -1.0]
        assert got["max"] == [2.0, 10.0, 0.0]
        assert got["min"] == [1.0, 0.0, -1.0]
        assert got["bcast"] == [7, 7, 7, 7]
        assert got["gather"] == [[0.0, 0.0], [1.0, 1.0]]
        assert got["strided"] == (2 * torch.arange(6.0).reshape(2, 3).t()).tolist()
