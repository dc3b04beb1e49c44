"""The fleet's Kafka drive in the port (omldm_tpu_torch/runtime/distributed_job.py
``_drive_kafka`` and its topic outputs) against the JAX fleet's, over the
file-backed broker of tests/fskafka.py.

Every fleet runs in processes of its own (``python -c`` bootstraps that
install the fake broker, then call each package's ``run_distributed``; the
JAX processes with one CPU device each), on copies of one broker directory:
600 HIGGS-like rows (12 features) on 2 ``trainingData`` partitions, a
forecast every 50 rows among them, 20 rows on ``forecastingData`` (forced
to forecasts whatever their operation says) and the Create on
``requests``, in windows of ``--chunkRows 100``:

1. one process and two processes, port against JAX: every integer
   statistic and the holdout equal, the score within 1e-5 (PERF.md's SPMD
   tolerance), the predictions within rtol 2e-4 / atol 2e-5. The broker
   is filled before the fleets start and the fake hands each process every
   record that is there, so the windows do not depend on poll timing and
   the 2-process counts are held exactly, not to conservation alone;
2. ``--checkpointEvery 2 --failAfterChunks 3`` (exit 3), then ``--restore
   true``: the restore resumes at the checkpointed offsets and ends as the
   clean run (score within 1e-6), in both packages;
3. ``--severBrokerAfterChunks 2``: the run exits 0, says "dropping record"
   for the predictions it cannot publish, and writes the report on its file
   sink; the rows it trained equal the JAX fleet's;
4. the ``EMITTED.p<i>`` marker (in one process, in this interpreter): a
   restored incarnation that finds it publishes nothing twice; one whose
   producer dropped sends leaves none, so its restore publishes; a fresh
   run unlinks a stale marker.
"""

import concurrent.futures
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
sys.path.insert(0, str(TESTS))
import fskafka  # noqa: E402

RTOL, ATOL, SCORE_TOL = 2e-4, 2e-5, 1e-5
INT_STATS = ("fitted", "numOfBlocks", "bytesShipped", "modelsShipped", "bytesOnWire",
             "fleetProcesses", "rescalesPerformed", "fleetDegraded")
N_ROWS, DIM, FORE_EVERY, N_FORE_TOPIC = 600, 12, 50, 20
N_FORE = N_ROWS // FORE_EVERY + N_FORE_TOPIC
TRAINING = N_ROWS - N_ROWS // FORE_EVERY
BASE = ["--batchSize", "64", "--testSetSize", "32", "--chunkRows", "100",
        "--kafkaBrokers", "fs://local", "--kafkaPollMs", "50", "--idleWindows", "2"]
BOOT = ("import sys; sys.path.insert(0, {tests!r}); import fskafka; fskafka.install(); "
        "from {pkg}.runtime.distributed_job import run_distributed; "
        "sys.exit(run_distributed(sys.argv[1:]))")

CREATE = json.dumps({
    "id": 0, "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 1.0}, "dataStructure": {"nFeatures": DIM}},
    "preProcessors": [], "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 1},
})


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fill(broker: Path) -> None:
    """The broker's topics, made with numpy from a seed."""
    rng = np.random.RandomState(3)
    w = rng.randn(DIM)
    old = os.environ.get("FSKAFKA_DIR")
    os.environ["FSKAFKA_DIR"] = str(broker)
    try:
        for i in range(N_ROWS):
            x = np.round(rng.randn(DIM), 6)
            rec = {"numericalFeatures": [float(v) for v in x]}
            if i % FORE_EVERY == 0:
                rec["operation"] = "forecasting"
            else:
                rec.update(target=float(x @ w > 0), operation="training")
            fskafka.append("trainingData", json.dumps(rec), partition=i % 2)
        for _ in range(N_FORE_TOPIC):
            x = np.round(rng.randn(DIM), 6)
            # a forecast-topic record is a forecast whatever it says
            fskafka.append("forecastingData", json.dumps(
                {"numericalFeatures": [float(v) for v in x], "target": 1.0,
                 "operation": "training"}))
        fskafka.append("requests", CREATE)
    finally:
        if old is None:
            os.environ.pop("FSKAFKA_DIR", None)
        else:
            os.environ["FSKAFKA_DIR"] = old


class Run:
    def __init__(self, rcs, report, preds, err, broker):
        self.rcs, self.report, self.preds, self.err, self.broker = (
            rcs, report, preds, err, broker)


def _launch(tmp: Path, tag: str, pkg: str, nproc: int, flags=(), expect=0, broker=None,
            files=True):
    """``nproc`` processes of one package's Kafka fleet on a copy of the
    filled broker (or on ``broker``); every process must exit ``expect``.
    With ``files`` the outputs go to file sinks, else to the topics."""
    if broker is None:
        broker = tmp / f"broker_{tag}"
        shutil.copytree(tmp / "broker", broker)
    perf, preds = tmp / f"perf_{tag}.jsonl", tmp / f"preds_{tag}.jsonl"
    args = BASE + (["--performanceOut", str(perf), "--predictionsOut", str(preds)]
                   if files else []) + [str(a) for a in flags]
    env = dict(os.environ, FSKAFKA_DIR=str(broker), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one CPU device a JAX process
    module = "omldm_tpu" if pkg == "jax" else "omldm_tpu_torch"
    head = [sys.executable, "-c", BOOT.format(tests=str(TESTS), pkg=module)]
    if pkg == "port":
        args += ["--device", "cpu"]
    port = _free_port()
    procs = []
    for pid in range(nproc):
        fleet = (["--coordinator", f"127.0.0.1:{port}", "--processId", str(pid)]
                 if nproc > 1 else [])
        procs.append(subprocess.Popen(head + args + ["--processes", str(nproc)] + fleet,
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    err = "\n".join(e for _, e in outs)
    for pid, p in enumerate(procs):
        assert p.returncode == expect, (
            f"{tag}: process {pid} exited {p.returncode}, not {expect}:\n{err[-4000:]}")
    report = json.loads(perf.read_text()) if perf.exists() else None
    paths = [preds] if nproc == 1 else [Path(f"{preds}.p{i}") for i in range(nproc)]
    predictions = [json.loads(line) for path in paths if path.exists()
                   for line in path.read_text().splitlines() if line.strip()]
    return Run([p.returncode for p in procs], report, predictions, err, broker)


def _chain(tmp: Path, pkg: str):
    """One package's runs: clean at 1 and 2 processes, the faulted and
    restored pair at 2, the severed broker at 1."""
    out = {f"clean{n}": _launch(tmp, f"{pkg}_clean{n}", pkg, n) for n in (1, 2)}
    ck = tmp / f"{pkg}_ck"
    out["faulted"] = _launch(tmp, f"{pkg}_faulted", pkg, 2, [
        "--checkpointDir", ck, "--checkpointEvery", "2", "--failAfterChunks", "3"], expect=3)
    out["restored"] = _launch(tmp, f"{pkg}_restored", pkg, 2, [
        "--checkpointDir", ck, "--restore", "true"], broker=out["faulted"].broker)
    sever = tmp / f"{pkg}_sever"
    sever.mkdir()
    out["sever"] = _launch(tmp, f"{pkg}_sever", pkg, 1, [
        "--severBrokerAfterChunks", "2", "--performanceOut", sever / "perf.jsonl"],
        files=False)
    out["sever"].report = json.loads((sever / "perf.jsonl").read_text())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_kafka")
    _fill(tmp / "broker")
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        futures = {pkg: pool.submit(_chain, tmp, pkg) for pkg in ("jax", "port")}
        return {pkg: f.result() for pkg, f in futures.items()}


def _stat(run):
    [s] = run.report["statistics"]
    return s


def _same(a, b, score_tol=SCORE_TOL):
    sa, sb = _stat(a), _stat(b)
    for key in INT_STATS:
        assert sa[key] == sb[key], (key, sa[key], sb[key])
    assert a.report["holdout"] == b.report["holdout"]
    assert abs(sa["score"] - sb["score"]) <= score_tol
    assert len(sa["learningCurve"]) == len(sb["learningCurve"])
    np.testing.assert_allclose(sa["learningCurve"], sb["learningCurve"], atol=SCORE_TOL)


@pytest.mark.parametrize("nproc", [1, 2])
def test_kafka_fleet_matches_jax(runs, nproc):
    port, jax = runs["port"][f"clean{nproc}"], runs["jax"][f"clean{nproc}"]
    _same(port, jax)
    s = _stat(port)
    # every training row conserved, every forecast (both topics) answered
    assert s["fitted"] + port.report["holdout"]["0"] == TRAINING
    assert len(port.preds) == len(jax.preds) == N_FORE
    assert s["fleetProcesses"] == nproc and port.report["processes"] == nproc
    np.testing.assert_allclose([p["value"] for p in port.preds],
                               [p["value"] for p in jax.preds], rtol=RTOL, atol=ATOL)
    assert s["score"] > 0.8


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_resumes_at_checkpointed_offsets(runs, pkg):
    out = runs[pkg]
    assert out["faulted"].rcs == [3, 3]
    # the snapshot after window 2: the partitions' offsets past 0, short of
    # their ends
    line = next(ln for ln in out["restored"].err.splitlines()
                if "restored; resuming at offsets" in ln)
    offsets = eval(line.split("offsets ", 1)[1])
    assert set(offsets) >= {"trainingData:0", "trainingData:1"}
    assert all(0 < v < N_ROWS // 2 for k, v in offsets.items() if k.startswith("training"))
    _same(out["restored"], out["clean2"], score_tol=1e-6)
    assert len(out["restored"].preds) == N_FORE


def test_restored_offsets_match_jax(runs):
    def offsets(run):
        return sorted(ln.split("] ", 1)[1] for ln in run.err.splitlines()
                      if "restored; resuming at offsets" in ln)
    assert offsets(runs["port"]["restored"]) == offsets(runs["jax"]["restored"])
    _same(runs["port"]["restored"], runs["jax"]["restored"])


def test_severed_broker_degrades_to_warnings(runs):
    run = runs["port"]["sever"]
    assert "severed file-backed broker" in run.err
    assert "dropping record" in run.err
    s = _stat(run)
    assert 0 < s["fitted"] + run.report["holdout"]["0"] <= TRAINING
    # the broker path is a plain file now: nothing was published
    assert run.broker.is_file()
    _same(run, runs["jax"]["sever"])


# --- the EMITTED marker, in this interpreter ----------------------------------


@pytest.fixture
def broker(tmp_path, monkeypatch):
    b = tmp_path / "broker"
    _fill(b)
    monkeypatch.setenv("FSKAFKA_DIR", str(b))
    monkeypatch.setitem(sys.modules, "kafka", fskafka)
    return b


def _in_process(tmp_path, ck, *extra):
    from omldm_tpu_torch.__main__ import main

    return main(BASE + ["--processes", "1", "--device", "cpu", "--checkpointDir", str(ck),
                        "--checkpointEvery", "2", *map(str, extra)])


def _topic(broker, topic):
    path = broker / f"{topic}--0.log"
    return path.read_text().splitlines() if path.exists() else []


def test_emitted_marker_keeps_a_restore_from_publishing_twice(tmp_path, broker, capsys):
    ck = tmp_path / "ck"
    assert _in_process(tmp_path, ck) == 0
    first = _topic(broker, "predictions")
    assert len(first) == N_FORE and len(_topic(broker, "performance")) == 1
    assert (ck / "EMITTED.p0").read_text() == "published\n"
    assert _in_process(tmp_path, ck, "--restore", "true") == 0
    assert "skipping topic publication (exactly-once)" in capsys.readouterr().err
    assert _topic(broker, "predictions") == first
    assert len(_topic(broker, "performance")) == 1
    # a fresh run on the same directory unlinks the stale marker and
    # publishes its own outputs
    assert _in_process(tmp_path, ck) == 0
    assert len(_topic(broker, "predictions")) == 2 * N_FORE


def test_dropped_sends_leave_no_marker_and_the_restore_publishes(tmp_path, broker,
                                                                 monkeypatch):
    from omldm_tpu_torch.runtime import kafka_io
    from omldm_tpu_torch.utils.backoff import BackoffPolicy

    ck = tmp_path / "ck"
    real = fskafka.KafkaProducer.send

    def refuse(self, topic, value):
        raise OSError("broker unreachable")

    monkeypatch.setattr(kafka_io, "SEND_RETRY", BackoffPolicy(attempts=1, base_delay=0.0))
    monkeypatch.setattr(fskafka.KafkaProducer, "send", refuse)
    assert _in_process(tmp_path, ck) == 0
    assert not (ck / "EMITTED.p0").exists()
    assert _topic(broker, "predictions") == []
    monkeypatch.setattr(fskafka.KafkaProducer, "send", real)
    assert _in_process(tmp_path, ck, "--restore", "true") == 0
    assert len(_topic(broker, "predictions")) == N_FORE
    assert (ck / "EMITTED.p0").exists()


def test_file_sink_takes_precedence_over_the_topic(tmp_path, broker):
    ck = tmp_path / "ck"
    preds = tmp_path / "preds.jsonl"
    assert _in_process(tmp_path, ck, "--predictionsOut", preds) == 0
    assert len(preds.read_text().splitlines()) == N_FORE
    assert _topic(broker, "predictions") == []
    assert len(_topic(broker, "performance")) == 1


def test_kafka_drive_needs_a_kafka_module(tmp_path, monkeypatch):
    """No ``kafka`` module: the drive raises ImportError, with no fallback
    to the file route."""
    from omldm_tpu_torch.__main__ import main

    monkeypatch.setitem(sys.modules, "kafka", None)
    with pytest.raises(ImportError, match="kafka-python"):
        main(BASE + ["--processes", "1", "--device", "cpu",
                     "--trainingData", str(tmp_path / "unused.jsonl")])


def test_no_create_ends_at_the_startup_bound(tmp_path, monkeypatch, capsys):
    """An empty broker: the fleet waits --startupIdleWindows agreed idle
    windows for a Create, then ends with nothing deployed."""
    from omldm_tpu_torch.__main__ import main

    b = tmp_path / "empty"
    b.mkdir()
    monkeypatch.setenv("FSKAFKA_DIR", str(b))
    monkeypatch.setitem(sys.modules, "kafka", fskafka)
    assert main(BASE + ["--processes", "1", "--device", "cpu", "--startupIdleWindows", "3",
                        "--performanceOut", str(tmp_path / "perf.jsonl")]) == 0
    assert "no Create arrived within the startup idle bound" in capsys.readouterr().err
