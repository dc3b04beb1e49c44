"""The fleet's recovery half across real processes, against the JAX fleet.

Every case runs ``python -m omldm_tpu_torch --device cpu`` (gloo) and,
where it is compared, the JAX fleet (``python -m
omldm_tpu.runtime.distributed_job``, one CPU device a process) on the
stream of ``tests/test_distributed_job.py::test_checkpoint_resume_matches_unfaulted``:
3,000 rows, a forecast every 50, ``--chunkRows 256``, a final Query. The
runs are shared through one module-scoped fixture, a few chains of launches
at a time:

1. clean, faulted (``--checkpointEvery 2 --failAfterChunks 5``, exit 3)
   and ``--restore true`` at 2 processes in both packages: the port's
   resumed run equals its clean run in every integer statistic and the
   holdout (score within 1e-6) and the JAX resumed run (score and losses
   within 1e-5, parameters and predictions rtol 2e-4, atol 2e-5);
2. the faulted snapshot restored at 1 and at 3 processes, in both
   packages: the same comparison, ``rescalesPerformed`` 1;
3. process 1's shard of the newest snapshot truncated: the restore falls
   back a generation, records ``candidate_rejected``, and still ends as
   the clean run;
4. the JAX snapshot restored by the port and the port's by the JAX fleet;
5. a standing ``--rescaleSignalDir`` target: both processes exit 17
   (``RESCALE_EXIT``) after a snapshot, which restores at 1 process;
6. the sparse fleet resumed at its byte cursor;
7. process 1 frozen (``--hangProcess``): process 0's watchdog exits 19
   (``HANG_EXIT``) with a ``hang`` event in its black box.
"""

import concurrent.futures
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL, SCORE_TOL = 2e-4, 2e-5, 1e-5
INT_STATS = ("fitted", "numOfBlocks", "bytesShipped", "modelsShipped", "bytesOnWire",
             "fleetProcesses", "rescalesPerformed")
SPARSE_HASH, SPARSE_NNZ = 1024, 24
BASE = ["--batchSize", "64", "--testSetSize", "32", "--chunkRows", "256"]
FAULT = ["--checkpointEvery", "2", "--failAfterChunks", "5"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rows(n, dim, seed=0, forecast_every=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    lines = []
    for i in range(n):
        x = np.round(rng.randn(dim), 6)
        if forecast_every and i % forecast_every == 0:
            lines.append(json.dumps({"numericalFeatures": [float(v) for v in x],
                                     "operation": "forecasting"}))
        else:
            lines.append(json.dumps({"numericalFeatures": [float(v) for v in x],
                                     "target": float(x @ w > 0), "operation": "training"}))
    return lines


def _sparse_rows(n, seed=0, forecast_every=0):
    rng = np.random.RandomState(seed)
    cat_w = rng.randn(6, 50)
    lines = []
    for i in range(n):
        num = np.round(rng.randn(13), 4)
        cats = rng.randint(0, 50, size=6)
        rec = {"numericalFeatures": [float(v) for v in num],
               "categoricalFeatures": [f"c{j}_{c}" for j, c in enumerate(cats)]}
        if forecast_every and i % forecast_every == 0:
            rec["operation"] = "forecasting"
        else:
            rec["target"] = float(num[0] + cat_w[np.arange(6), cats].sum() > 0)
            rec["operation"] = "training"
        lines.append(json.dumps(rec))
    return lines


CREATE = json.dumps({
    "id": 0, "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                "dataStructure": {"nFeatures": 12}},
    "preProcessors": [], "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 1},
})
SPARSE_CREATE = json.dumps({
    "id": 0, "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                "dataStructure": {"sparse": True, "nFeatures": 13 + SPARSE_HASH,
                                  "hashSpace": SPARSE_HASH, "maxNnz": SPARSE_NNZ}},
    "trainingConfiguration": {"protocol": "Asynchronous", "syncEvery": 2},
})
QUERY = json.dumps({"id": 0, "request": "Query", "requestId": 7})
DENSE = _rows(3000, 12, forecast_every=50)
SPARSE = _sparse_rows(2000, seed=1, forecast_every=10)


class Run:
    """One fleet launch: its processes' exit codes, the report (process
    0's), predictions, Query responses and stderr."""

    def __init__(self, rcs, report, preds, responses, err):
        self.rcs, self.report, self.preds, self.responses, self.err = (
            rcs, report, preds, responses, err)


def _launch(tmp: Path, tag: str, pkg: str, nproc: int, flags, expect=0, sparse=False,
            stopped=None):
    """``nproc`` processes of one package's fleet on the case's files.
    ``expect`` is every process's exit code; with ``stopped`` that process
    is expected to freeze: the launch waits for the others, checks it is
    still alive, and kills it."""
    port = _free_port()
    perf, preds, resp = (tmp / f"{k}_{tag}.jsonl" for k in ("perf", "preds", "resp"))
    stream = "sparse" if sparse else "dense"
    args = BASE + ["--performanceOut", str(perf), "--predictionsOut", str(preds),
                   "--responsesOut", str(resp), "--requestsFinal", str(tmp / "final.jsonl"),
                   "--requests", str(tmp / f"{stream}_reqs.jsonl"),
                   "--trainingData", str(tmp / f"{stream}_train.jsonl")] + list(flags)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one CPU device a JAX process
    env["JAX_PLATFORMS"] = "cpu"
    if pkg == "jax":
        head = [sys.executable, "-m", "omldm_tpu.runtime.distributed_job"]
    else:
        head = [sys.executable, "-m", "omldm_tpu_torch", "--device", "cpu"]
        if nproc == 1:
            args += ["--processes", "1"]
    procs = []
    for pid in range(nproc):
        fleet = (["--coordinator", f"127.0.0.1:{port}", "--processes", str(nproc),
                  "--processId", str(pid)] if nproc > 1 else [])
        procs.append(subprocess.Popen(head + args + fleet, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = {}
    try:
        for pid, p in enumerate(procs):
            if pid != stopped:
                outs[pid] = p.communicate(timeout=240)
        if stopped is not None:
            frozen = procs[stopped]
            assert frozen.poll() is None, f"{tag}: process {stopped} exited {frozen.returncode}"
            os.kill(frozen.pid, signal.SIGKILL)
            outs[stopped] = frozen.communicate(timeout=60)
    finally:
        for p in procs:  # a failed or stuck member must not hang the group
            if p.poll() is None:
                p.kill()
                p.wait()
    err = "\n".join(outs[i][1] for i in sorted(outs))
    for pid, p in enumerate(procs):
        if pid != stopped:
            assert p.returncode == expect, (
                f"{tag}: process {pid} exited {p.returncode}, not {expect}:\n{err[-4000:]}")
    report = json.loads(perf.read_text()) if perf.exists() else None
    paths = [preds] if nproc == 1 else [Path(f"{preds}.p{i}") for i in range(nproc)]
    predictions = [json.loads(line) for path in paths if path.exists()
                   for line in path.read_text().splitlines() if line.strip()]
    responses = ([json.loads(line) for line in resp.read_text().splitlines() if line.strip()]
                 if resp.exists() else [])
    return Run([p.returncode for p in procs], report, predictions, responses, err)


def _copy(tmp: Path, src: str, dst: str) -> str:
    shutil.copytree(tmp / src, tmp / dst)
    return str(tmp / dst)


def _resume_chain(tmp: Path, pkg: str):
    """Case 1 and 2 for one package: clean, faulted, resumed at 2, then the
    faulted snapshot restored at 1 and at 3 processes."""
    out = {"clean": _launch(tmp, f"{pkg}_clean", pkg, 2, [])}
    out["faulted"] = _launch(tmp, f"{pkg}_faulted", pkg, 2,
                             ["--checkpointDir", str(tmp / f"{pkg}_ck")] + FAULT, expect=3)
    for n in (2, 1, 3):
        ck = _copy(tmp, f"{pkg}_ck", f"{pkg}_ck_r{n}")
        out[f"resumed{n}"] = _launch(tmp, f"{pkg}_resumed{n}", pkg, n,
                                     ["--checkpointDir", ck, "--restore", "true"])
    return out


def _cross(tmp: Path, jax_f, port_f):
    """Case 4: each package's faulted snapshot restored by the other."""
    jax_f.result()
    port_f.result()
    return {
        "port_from_jax": _launch(tmp, "port_from_jax", "port", 2, [
            "--checkpointDir", _copy(tmp, "jax_ck", "x_jax_ck"), "--restore", "true"]),
        "jax_from_port": _launch(tmp, "jax_from_port", "jax", 2, [
            "--checkpointDir", _copy(tmp, "port_ck", "x_port_ck"), "--restore", "true"]),
    }


def _faults_chain(tmp: Path):
    """Cases 3, 5 and 7 on the port."""
    out = {}
    ck = str(tmp / "corrupt_ck")
    _launch(tmp, "corrupt_faulted", "port", 2, [
        "--checkpointDir", ck, *FAULT, "--corruptShardProcess", "1", "--corruptShardSeq", "1",
        "--corruptShardMode", "truncate"], expect=3)
    out["corrupt_files"] = sorted(os.listdir(ck))
    out["fallback"] = _launch(tmp, "corrupt_resumed", "port", 2, [
        "--checkpointDir", ck, "--restore", "true", "--flightRecorder", "on",
        "--blackboxPath", str(tmp / "corrupt_bb")])
    out["fallback_files"] = sorted(os.listdir(ck))
    sig = tmp / "signal"
    sig.mkdir()
    (sig / "RESCALE").write_text("1")
    ck = str(tmp / "signal_ck")
    out["signalled"] = _launch(tmp, "signalled", "port", 2, [
        "--checkpointDir", ck, "--rescaleSignalDir", str(sig)], expect=17)
    out["signal_files"] = sorted(os.listdir(ck))
    out["after_signal"] = _launch(tmp, "after_signal", "port", 1, [
        "--checkpointDir", ck, "--restore", "true"])
    t0 = time.monotonic()
    out["hang"] = _launch(tmp, "hang", "port", 2, [
        "--hangProcess", "1", "--hangAfterChunks", "3", "--collectiveTimeoutMs", "4000",
        "--collectiveWarmupMs", "60000", "--flightRecorder", "on",
        "--blackboxPath", str(tmp / "hang_bb")], expect=19, stopped=1)
    out["hang_s"] = time.monotonic() - t0
    return out


def _sparse_chain(tmp: Path):
    """Case 6: the sparse fleet clean, faulted and resumed at its byte
    cursor."""
    ck = str(tmp / "sparse_ck")
    return {
        "clean": _launch(tmp, "sparse_clean", "port", 2, [], sparse=True),
        "faulted": _launch(tmp, "sparse_faulted", "port", 2, ["--checkpointDir", ck] + FAULT,
                           expect=3, sparse=True),
        "resumed": _launch(tmp, "sparse_resumed", "port", 2,
                           ["--checkpointDir", ck, "--restore", "true"], sparse=True),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recovery")
    (tmp / "dense_train.jsonl").write_text("\n".join(DENSE) + "\n")
    (tmp / "dense_reqs.jsonl").write_text(CREATE + "\n")
    (tmp / "sparse_train.jsonl").write_text("\n".join(SPARSE) + "\n")
    (tmp / "sparse_reqs.jsonl").write_text(SPARSE_CREATE + "\n")
    (tmp / "final.jsonl").write_text(QUERY + "\n")
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        jax_f = pool.submit(_resume_chain, tmp, "jax")
        port_f = pool.submit(_resume_chain, tmp, "port")
        faults_f = pool.submit(_faults_chain, tmp)
        sparse_f = pool.submit(_sparse_chain, tmp)
        cross_f = pool.submit(_cross, tmp, jax_f, port_f)
        return {"jax": jax_f.result(), "port": port_f.result(), "faults": faults_f.result(),
                "sparse": sparse_f.result(), "cross": cross_f.result(), "tmp": tmp}


def _stat(report, net_id=0):
    [s] = [s for s in report["statistics"] if s["pipeline"] == net_id]
    return s


def assert_same_counts(run, ref, score_tol):
    """Every integer statistic and the holdout equal, the score within
    ``score_tol``, as many predictions and Query answers."""
    sr, sc = _stat(run.report), _stat(ref.report)
    for key in INT_STATS:
        assert sr[key] == sc[key], key
    assert run.report["holdout"] == ref.report["holdout"]
    assert abs(sr["score"] - sc["score"]) <= score_tol
    assert len(run.preds) == len(ref.preds)
    assert [q["dataFitted"] for q in run.responses] == [q["dataFitted"] for q in ref.responses]


def assert_same_run(port, ref):
    """The port's run against the JAX fleet's: the counts, the learning
    curve and the Query's loss within 1e-5, predictions and parameters
    within rtol 2e-4, atol 2e-5."""
    assert_same_counts(port, ref, SCORE_TOL)
    sp, sj = _stat(port.report), _stat(ref.report)
    assert sp["LCX"] == sj["LCX"]
    np.testing.assert_allclose(sp["learningCurve"], sj["learningCurve"], rtol=0, atol=SCORE_TOL)
    assert [p["mlpId"] for p in port.preds] == [p["mlpId"] for p in ref.preds]
    np.testing.assert_allclose([p["value"] for p in port.preds],
                               [p["value"] for p in ref.preds], rtol=RTOL, atol=ATOL)
    [qp], [qj] = port.responses, ref.responses
    assert abs(qp["loss"] - qj["loss"]) <= SCORE_TOL
    np.testing.assert_allclose(qp["learner"]["parameters"]["values"],
                               qj["learner"]["parameters"]["values"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_checkpoint_resume_matches_unfaulted(runs, pkg):
    """Case 1: both processes killed at the same chunk, relaunched with
    --restore: the unfaulted run's counts and holdout, a float-equal
    score (the JAX test's checks, in each package)."""
    clean, resumed = runs[pkg]["clean"], runs[pkg]["resumed2"]
    assert "restored; resuming at row 1024" in resumed.err
    assert_same_counts(resumed, clean, 1e-6)
    assert _stat(resumed.report)["rescalesPerformed"] == 0


@pytest.mark.parametrize("case", ["clean", "resumed2"])
def test_port_resume_matches_the_jax_fleet(runs, case):
    assert_same_run(runs["port"][case], runs["jax"][case])


@pytest.mark.parametrize("nproc", [1, 3])
def test_rescale_restore_matches_the_jax_fleet(runs, nproc):
    """Case 2: the 2-process snapshot restored at another process count:
    the JAX fleet's statistics, one rescale counted, every training row
    fitted or held out."""
    port, ref = runs["port"][f"resumed{nproc}"], runs["jax"][f"resumed{nproc}"]
    assert "rescale-restore: redistributing a 2-process snapshot" in port.err
    assert_same_run(port, ref)
    assert port.report["rescalesPerformed"] == 1 and port.report["processes"] == nproc
    s = _stat(port.report)
    assert s["fitted"] + port.report["holdout"]["0"] == 2940
    assert len(port.preds) == 60


def test_truncated_shard_falls_back_a_generation(runs):
    """Case 3: process 1 truncates its shard of ckpt-1; the restore falls
    back to ckpt-0 (LATEST repointed, ckpt-1 pruned), records
    candidate_rejected and still ends as the clean run."""
    f = runs["faults"]
    assert f["corrupt_files"] == ["LATEST", "ckpt-0", "ckpt-1"]
    run = f["fallback"]
    assert "falling back from ckpt-1 to ckpt-0" in run.err
    assert "restored; resuming at row 512" in run.err
    assert f["fallback_files"] == ["LATEST", "ckpt-0"]
    assert_same_counts(run, runs["port"]["clean"], 1e-6)
    bb = runs["tmp"] / "corrupt_bb"
    events = [json.loads(line) for p in sorted(bb.glob("blackbox-proc*.jsonl"))
              for line in p.read_text().splitlines()]
    causes = [(e["pid"], e["cause"]) for e in events if e["kind"] == "restore"]
    assert (1, "candidate_rejected") in causes
    assert (0, "snapshot") in causes and (1, "snapshot") in causes
    assert any(e["kind"] == "terminate" for e in events)


@pytest.mark.parametrize("direction", ["port_from_jax", "jax_from_port"])
def test_snapshot_restores_across_packages(runs, direction):
    """Case 4: a JAX fleet snapshot restored by the port ends as the JAX
    resumed run; a port snapshot restored by the JAX fleet ends as the
    port's."""
    run = runs["cross"][direction]
    if direction == "port_from_jax":
        assert_same_run(run, runs["jax"]["resumed2"])
    else:
        assert_same_run(runs["port"]["resumed2"], run)


def test_rescale_signal_exits_17_with_a_snapshot(runs):
    """Case 5: a standing target of 1 process: the fleet agrees on it at
    the first chunk, snapshots and exits RESCALE_EXIT; the snapshot
    restores at 1 process with every row accounted for."""
    f = runs["faults"]
    assert f["signalled"].rcs == [17, 17]
    assert "rescale signal honored: snapshot ckpt-0 taken" in f["signalled"].err
    assert f["signal_files"] == ["LATEST", "ckpt-0"]
    after = f["after_signal"]
    assert after.report["rescalesPerformed"] == 1 and after.report["processes"] == 1
    s = _stat(after.report)
    assert s["fitted"] + after.report["holdout"]["0"] == 2940
    assert len(after.preds) == 60


def test_sparse_fleet_resumes_at_its_byte_cursor(runs):
    """Case 6: the sparse fleet's cursor is the line-aligned byte offset and
    the line count; the resumed run ends as the clean one."""
    sp = runs["sparse"]
    assert "restored; resuming at {'bytes': " in sp["resumed"].err
    assert_same_counts(sp["resumed"], sp["clean"], 1e-6)
    n_fore = sum(1 for line in SPARSE if "forecasting" in line)
    s = _stat(sp["resumed"].report)
    assert s["fitted"] + sp["resumed"].report["holdout"]["0"] == 2000 - n_fore


def test_hang_watchdog_exits_19(runs):
    """Case 7: process 1 SIGSTOPs itself after chunk 3; process 0, wedged in
    its next collective, exits HANG_EXIT within the timeout and leaves a
    hang event in its black box."""
    f = runs["faults"]
    assert f["hang"].rcs[0] == 19
    assert "injected hang: SIGSTOP after chunk 3" in f["hang"].err
    assert "collective watchdog: no progress in" in f["hang"].err
    assert f["hang_s"] < 120
    events = [json.loads(line) for line in
              (runs["tmp"] / "hang_bb" / "blackbox-proc0.jsonl").read_text().splitlines()]
    [hang] = [e for e in events if e["kind"] == "hang"]
    assert hang["cause"] == "collective_timeout" and hang["timeout_ms"] == 4000.0
