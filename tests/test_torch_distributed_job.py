"""The port's multi-process fleet against the JAX package's, file route.

Every case writes the streams of ``tests/test_distributed_job.py`` (and a
sparse one), then runs the JAX fleet (``python -m
omldm_tpu.runtime.distributed_job``, one CPU device a process, as that
file's ``_launch`` runs it) and the port's (``python -m omldm_tpu_torch
--device cpu``, gloo) at one and at two processes. The runs are shared
through one module-scoped fixture, a few launches at a time. Integer
statistics must be equal; the Query's parameters and the predictions
within rtol 2e-4, atol 2e-5; score, loss and the learning curve within
1e-5.
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omldm_tpu_torch.runtime.distributed_job import FLEET_LATER_FLAGS

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL, SCORE_TOL = 2e-4, 2e-5, 1e-5
INT_STATS = ("fitted", "numOfBlocks", "bytesShipped", "modelsShipped", "bytesOnWire",
             "fleetProcesses")
SPARSE_HASH, SPARSE_NNZ = 1024, 24


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rows(n, dim, seed=0, forecast_every=0):
    """The JAX tests' stream: a planted linear rule, a forecast every
    ``forecast_every`` records."""
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
    """Criteo-shaped records: 13 numerical features, 6 categorical ones
    hashed into SPARSE_HASH slots; the label follows a planted rule."""
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


def _create(net_id=0, protocol="Synchronous", dim=12, **tc_extra):
    tc = {"protocol": protocol, "syncEvery": 1}
    tc.update(tc_extra)
    return json.dumps({
        "id": net_id, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                    "dataStructure": {"nFeatures": dim}},
        "preProcessors": [], "trainingConfiguration": tc,
    })


SPARSE_CREATE = json.dumps({
    "id": 0, "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                "dataStructure": {"sparse": True, "nFeatures": 13 + SPARSE_HASH,
                                  "hashSpace": SPARSE_HASH, "maxNnz": SPARSE_NNZ}},
    "trainingConfiguration": {"protocol": "Asynchronous", "syncEvery": 2},
})
BAD_LEARNER = json.dumps({
    "id": 5, "request": "Create",
    "learner": {"name": "NoSuchLearner", "dataStructure": {"nFeatures": 12}},
    "trainingConfiguration": {"protocol": "Synchronous"},
})
SPARSE_ON_DENSE = json.dumps({
    "id": 6, "request": "Create",
    "learner": {"name": "PA", "dataStructure": {"sparse": True, "nFeatures": 1024}},
    "trainingConfiguration": {"protocol": "Synchronous"},
})
QUERY0 = json.dumps({"id": 0, "request": "Query", "requestId": 7})
# mid-stream requests (--requestSchedule, with --chunkRows 256): a second
# pipeline deployed at record 700, a Query of the first at record 1300
SCHEDULE = [json.dumps({"atRecord": 700, "request": json.loads(_create(1, protocol="GM"))}),
            json.dumps({"atRecord": 1300, "request": json.loads(QUERY0)})]

# case -> (training lines, request lines, final request lines)
CASES = {
    "sync": (_rows(3000, 12), [_create()], []),
    # forecasts at even stream positions land in process 0's stripe only,
    # starving its worker: the staleness bound refuses the fast worker
    "ssp": (_rows(2400, 12, forecast_every=4), [_create(protocol="SSP", staleness=1)], []),
    "fore": (_rows(1500, 12, forecast_every=100), [_create()], []),
    "ctrl": (_rows(2000, 12), [_create(0), _create(1, protocol="EASGD"), BAD_LEARNER,
                               SPARSE_ON_DENSE],
             [QUERY0, json.dumps({"id": 1, "request": "Delete"})]),
    "sparse": (_sparse_rows(2000, forecast_every=10), [SPARSE_CREATE], [QUERY0]),
    "schedule": (_rows(2000, 12, seed=3, forecast_every=25), [_create()], []),
}


def _launch(tmp: Path, case: str, pkg: str, nproc: int):
    """One fleet run; (report, predictions, responses, stderr)."""
    tag = f"{case}_{pkg}_{nproc}"
    port = _free_port()
    perf, preds, resp = (tmp / f"{k}_{tag}.jsonl" for k in ("perf", "preds", "resp"))
    flags = ["--performanceOut", str(perf), "--predictionsOut", str(preds),
             "--responsesOut", str(resp), "--batchSize", "64", "--testSetSize", "32",
             "--requests", str(tmp / f"{case}_reqs.jsonl"),
             "--trainingData", str(tmp / f"{case}_train.jsonl")]
    if CASES[case][2]:
        flags += ["--requestsFinal", str(tmp / f"{case}_final.jsonl")]
    if case == "schedule":
        flags += ["--requestSchedule", str(tmp / "schedule.jsonl"), "--chunkRows", "256"]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one CPU device a JAX process
    env["JAX_PLATFORMS"] = "cpu"
    if pkg == "jax":
        head = [sys.executable, "-m", "omldm_tpu.runtime.distributed_job"]
    else:
        head = [sys.executable, "-m", "omldm_tpu_torch", "--device", "cpu"]
        if nproc == 1:
            flags += ["--processes", "1"]
    procs = []
    for pid in range(nproc):
        fleet = (["--coordinator", f"127.0.0.1:{port}", "--processes", str(nproc),
                  "--processId", str(pid)] if nproc > 1 else [])
        procs.append(subprocess.Popen(head + flags + fleet, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:  # a failed or stuck member must not hang the group
            if p.poll() is None:
                p.kill()
                p.wait()
    err = "\n".join(e for _, e in outs)
    for p in procs:
        assert p.returncode == 0, f"{tag} exited {p.returncode}:\n{err[-4000:]}"
    report = json.loads(perf.read_text())
    paths = [preds] if nproc == 1 else [Path(f"{preds}.p{i}") for i in range(nproc)]
    predictions = [json.loads(line) for path in paths
                   for line in path.read_text().splitlines() if line.strip()]
    responses = ([json.loads(line) for line in resp.read_text().splitlines() if line.strip()]
                 if resp.exists() else [])
    return report, predictions, responses, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    (tmp / "schedule.jsonl").write_text("\n".join(SCHEDULE) + "\n")
    for case, (train, reqs, final) in CASES.items():
        (tmp / f"{case}_train.jsonl").write_text("\n".join(train) + "\n")
        (tmp / f"{case}_reqs.jsonl").write_text("\n".join(reqs) + "\n")
        if final:
            (tmp / f"{case}_final.jsonl").write_text("\n".join(final) + "\n")
    keys = [(case, pkg, n) for case in CASES for n in (1, 2) for pkg in ("jax", "port")]
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        futures = {key: pool.submit(_launch, tmp, *key) for key in keys}
        return {key: f.result() for key, f in futures.items()}


def _stat(report, net_id=0):
    [s] = [s for s in report["statistics"] if s["pipeline"] == net_id]
    return s


def assert_same_run(jax_run, port_run):
    """Every pipeline's integer statistics equal, score and learning curve
    within 1e-5, the holdout sizes equal, the predictions and the Query
    responses' values within rtol 2e-4, atol 2e-5."""
    (jr, jp, jq, _), (pr, pp, pq, _) = jax_run, port_run
    assert [s["pipeline"] for s in pr["statistics"]] == [s["pipeline"] for s in jr["statistics"]]
    for js, ps in zip(jr["statistics"], pr["statistics"]):
        for key in INT_STATS:
            assert ps[key] == js[key], key
        assert ps["protocol"] == js["protocol"]
        assert abs(ps["score"] - js["score"]) <= SCORE_TOL
        assert ps["LCX"] == js["LCX"]
        np.testing.assert_allclose(ps["learningCurve"], js["learningCurve"], rtol=0,
                                   atol=SCORE_TOL)
        assert ps["meanBufferSize"] == js["meanBufferSize"]
    for key in ("holdout", "parallelism", "processes", "requeuedLocal",
                "terminateAccounting"):
        assert pr[key] == jr[key], key
    assert [p["mlpId"] for p in pp] == [p["mlpId"] for p in jp]
    np.testing.assert_allclose([p["value"] for p in pp], [p["value"] for p in jp],
                               rtol=RTOL, atol=ATOL)
    assert len(pq) == len(jq)
    for a, b in zip(pq, jq):
        assert (a["responseId"], a["mlpId"], a["dataFitted"]) == (
            b["responseId"], b["mlpId"], b["dataFitted"])
        assert abs(a["score"] - b["score"]) <= SCORE_TOL
        assert abs(a["loss"] - b["loss"]) <= SCORE_TOL
        np.testing.assert_allclose(a["learner"]["parameters"]["values"],
                                   b["learner"]["parameters"]["values"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nproc", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_port_fleet_matches_the_jax_fleet(runs, case, nproc):
    assert_same_run(runs[(case, "jax", nproc)], runs[(case, "port", nproc)])


@pytest.mark.parametrize("nproc", [1, 2])
def test_two_processes_match_single(runs, nproc):
    """Every row lands somewhere, the model separates the stream, protocol
    traffic happened and the learning curve was recorded (the JAX test's
    checks, on the port's runs)."""
    report = runs[("sync", "port", nproc)][0]
    assert set(report) >= {"jobName", "parallelism", "durationMs", "statistics",
                           "processes", "holdout"}
    s = _stat(report)
    assert s["fitted"] + report["holdout"]["0"] == 3000
    assert report["processes"] == nproc and report["parallelism"] == nproc
    assert s["score"] > 0.85
    assert abs(s["score"] - _stat(runs[("sync", "port", 1)][0])["score"]) < 0.05
    assert s["numOfBlocks"] > 0 and s["bytesShipped"] > 0
    assert s["LCX"] == sorted(s["LCX"]) and s["LCX"][-1] <= s["fitted"]


def test_ssp_imbalanced_stripes_conserve_rows(runs):
    """SSP with process 0's stripe starved: refused rows are requeued,
    never dropped; fitted conserves, every forecast answered."""
    report, preds, _, _ = runs[("ssp", "port", 2)]
    n_fore = sum(1 for line in CASES["ssp"][0] if "forecasting" in line)
    s = _stat(report)
    assert s["fitted"] + report["holdout"]["0"] == 2400 - n_fore
    assert len(preds) == n_fore
    # after the drain nothing is staged: the backlog the report counts is
    # the rows the bound refused and requeued (the trainers' tally, as in
    # the JAX package), so the requeue ran
    assert report["terminateAccounting"]["backlogRows"] > 0


def test_forecasts_served_across_processes(runs):
    report, preds, _, _ = runs[("fore", "port", 2)]
    n_fore = sum(1 for line in CASES["fore"][0] if "forecasting" in line)
    assert len(preds) == n_fore and all(np.isfinite(p["value"]) for p in preds)
    assert _stat(report)["fitted"] + report["holdout"]["0"] == 1500 - n_fore


@pytest.mark.parametrize("nproc", [1, 2])
def test_multi_pipeline_query_delete(runs, nproc):
    """Two pipelines, an unknown learner and a sparse Create on a dense
    stream rejected WITH their reasons, a Query answered collectively with
    bucketed parameters, a Delete that drops its pipeline from the
    report."""
    report, _, responses, err = runs[("ctrl", "port", nproc)]
    assert "rejecting Create for pipeline 5: unknown learner 'NoSuchLearner'" in err
    assert "rejecting pipeline 6" in err
    assert "sparse pipeline cannot share its parse route" in err
    assert "pipeline 1 deleted" in err
    assert [s["pipeline"] for s in report["statistics"]] == [0]
    s0 = _stat(report)
    assert s0["fitted"] + report["holdout"]["0"] == 2000 and s0["score"] > 0.8
    [q] = responses
    assert (q["responseId"], q["mlpId"], q["dataFitted"]) == (7, 0, s0["fitted"])
    assert q["learner"]["name"] == "PA"
    params = q["learner"]["parameters"]["values"]
    assert len(params) >= 12 and np.isfinite(params).all()


@pytest.mark.parametrize("nproc", [1, 2])
def test_request_schedule_mid_stream(runs, nproc):
    """--requestSchedule: the second pipeline deploys at its record and
    reports, the Query is answered mid-stream (fewer rows fitted than at the
    end)."""
    report, _, responses, _ = runs[("schedule", "port", nproc)]
    assert [s["pipeline"] for s in report["statistics"]] == [0, 1]
    s0, s1 = _stat(report, 0), _stat(report, 1)
    assert 0 < s1["fitted"] < s0["fitted"]
    [q] = responses
    assert q["mlpId"] == 0 and 0 < q["dataFitted"] < s0["fitted"]


def test_sparse_fleet(runs):
    """A sparse (padded-COO) fleet: the stream's COO layout pinned by the
    Create, rows conserved across the stripes, forecasts answered."""
    report, preds, responses, _ = runs[("sparse", "port", 2)]
    n_fore = sum(1 for line in CASES["sparse"][0] if "forecasting" in line)
    s = _stat(report)
    assert s["fitted"] + report["holdout"]["0"] == 2000 - n_fore
    assert len(preds) == n_fore
    assert len(responses[0]["learner"]["parameters"]["values"]) > 13 + SPARSE_HASH - 1


def _files(tmp_path):
    train = tmp_path / "t.jsonl"
    train.write_text("\n".join(_rows(20, 3)) + "\n")
    reqs = tmp_path / "r.jsonl"
    reqs.write_text(_create(dim=3) + "\n")
    return ["--trainingData", str(train), "--requests", str(reqs)]


FLEET = ["--processes", "2", "--processId", "0", "--coordinator", "127.0.0.1:1"]


@pytest.mark.parametrize("flag", sorted(FLEET_LATER_FLAGS) + [
    "supervise", "compileCache", "compileCacheMinSecs"])
def test_fleet_refuses_later_flags_by_name(flag, tmp_path):
    """In fleet mode each flag of the fleet's later half, the supervisor and
    the compile cache raise SystemExit naming the flag, before any group
    is joined."""
    from omldm_tpu_torch.__main__ import main

    with pytest.raises(SystemExit, match=f"--{flag}"):
        main(FLEET + ["--device", "cpu", *_files(tmp_path), f"--{flag}", "x"])


# the flags of the fleet's recovery half: each is accepted and reaches its
# part
RECOVERY_FLAGS = (
    "checkpointDir", "checkpointEvery", "restore", "rescaleRestore", "rescaleCount",
    "rescaleSignalDir", "heartbeatDir", "collectiveTimeoutMs", "collectiveWarmupMs",
    "flightRecorder", "blackboxPath", "overload", "profileDir", "failProcess",
    "failAfterRecords", "failAfterChunks", "corruptShardProcess", "corruptShardSeq",
    "corruptShardMode", "hangProcess", "hangAfterChunks", "refuseLaunchProcess",
    "refuseLaunchCount", "faultStateDir")


class _Injected(Exception):
    """An injected crash, raised where the injector would end the process."""


def _one_process_fleet(tmp_path, monkeypatch, extra):
    """``python -m omldm_tpu_torch --processes 1 --device cpu`` in this
    process on 20 rows in chunks of 4; (the job, process 0's report or
    None, the SystemExit code or the injected crash's message). The
    injector's hard exit and SIGSTOP are caught instead of taken."""
    from omldm_tpu_torch.__main__ import main
    from omldm_tpu_torch.runtime import distributed_job as dj
    from omldm_tpu_torch.runtime.supervisor import DistributedFaultInjector

    jobs = []
    init = dj.DistributedStreamJob.__init__

    def caught(self, *a, **k):
        init(self, *a, **k)
        jobs.append(self)

    def die(self, why):
        raise _Injected(why)

    monkeypatch.setattr(dj.DistributedStreamJob, "__init__", caught)
    monkeypatch.setattr(DistributedFaultInjector, "_die", die)
    perf = tmp_path / f"perf{len(list(tmp_path.glob('perf*')))}.jsonl"
    outcome = 0
    try:
        main(["--processes", "1", "--device", "cpu", "--chunkRows", "4",
              "--performanceOut", str(perf), *_files(tmp_path), *extra])
    except SystemExit as exc:
        outcome = exc.code
    except _Injected as exc:
        outcome = str(exc)
    report = json.loads(perf.read_text()) if perf.exists() else None
    return jobs[-1], report, outcome


def _rows_accounted(report):
    return _stat(report)["fitted"] + report["holdout"]["0"] == 20


@pytest.mark.parametrize("flag", RECOVERY_FLAGS)
def test_fleet_accepts_recovery_flags(flag, tmp_path, monkeypatch, capsys):
    """Each flag of the fleet's recovery half is accepted by the CLI and
    reaches its part in a one-process CPU fleet."""
    assert flag not in FLEET_LATER_FLAGS
    ck, fs = tmp_path / "ck", tmp_path / "fault"
    stops = []
    monkeypatch.setattr("omldm_tpu_torch.runtime.selfheal.sigstop_self",
                        lambda: stops.append(True))

    def run(*extra):
        return _one_process_fleet(tmp_path, monkeypatch, [str(a) for a in extra])

    if flag in ("checkpointDir", "checkpointEvery"):
        every = 1 if flag == "checkpointDir" else 2
        _, report, rc = run("--checkpointDir", ck, "--checkpointEvery", every)
        assert rc == 0 and _rows_accounted(report)
        last = 4 if every == 1 else 1  # 5 chunks of 4 rows
        assert (ck / "LATEST").read_text() == f"ckpt-{last}"
        assert sorted(os.listdir(ck))[-1] == f"ckpt-{last}"
        assert len(os.listdir(ck)) == 1 + min(last + 1, 3)  # JobConfig.checkpoint_keep
    elif flag == "restore":
        _, _, rc = run("--checkpointDir", ck, "--checkpointEvery", 1, "--failAfterChunks", 3)
        assert rc == "after chunk 3 (all processes)"
        _, report, rc = run("--checkpointDir", ck, "--restore", "true")
        assert rc == 0 and _rows_accounted(report)
        assert "restored; resuming at row 12" in capsys.readouterr().err
    elif flag == "rescaleRestore":
        run("--checkpointDir", ck, "--checkpointEvery", 1, "--failAfterChunks", 3)
        manifest = json.loads((ck / "ckpt-2" / "manifest.json").read_text())
        manifest["processes"] = 2  # a snapshot of another process count
        (ck / "ckpt-2" / "manifest.json").write_text(json.dumps(manifest))
        job, report, rc = run("--checkpointDir", ck, "--restore", "true",
                              "--rescaleRestore", "false")
        assert rc == 0 and job.rescale_restore is False and _rows_accounted(report)
        assert report["rescalesPerformed"] == 0
        err = capsys.readouterr().err
        assert "(--rescaleRestore false) -- starting fresh" in err
    elif flag == "rescaleCount":
        _, report, rc = run("--rescaleCount", 4)
        assert rc == 0 and report["rescalesPerformed"] == 4
        assert _stat(report)["rescalesPerformed"] == 4
    elif flag == "rescaleSignalDir":
        sig = tmp_path / "sig"
        sig.mkdir()
        (sig / "RESCALE").write_text("2")
        _, report, rc = run("--checkpointDir", ck, "--rescaleSignalDir", sig)
        assert rc == 17 and report is None
        assert (ck / "LATEST").read_text() == "ckpt-0"
    elif flag == "heartbeatDir":
        _, _, rc = run("--heartbeatDir", tmp_path / "hb")
        epoch, level, *tail = (tmp_path / "hb" / "proc0.hb").read_text().split()
        assert rc == 0 and float(epoch) > 0 and level == "0"
        assert [t.split("=")[0] for t in tail] == [
            "serveP99", "imbalance", "backlog", "events", "alerts"]
    elif flag in ("collectiveTimeoutMs", "collectiveWarmupMs"):
        extra = ["--collectiveWarmupMs", 90000] if flag == "collectiveWarmupMs" else []
        job, report, rc = run("--collectiveTimeoutMs", 60000, *extra)
        wd = job.watchdog
        assert rc == 0 and wd is not None and not wd.fired and wd._stop.is_set()
        assert wd.timeout_s == 60.0 and wd.warmup_s == (90.0 if extra else 120.0)
        # the Create's deploy re-grants the allowance ("control" entered
        # before it); the drive's phases warmed after it
        assert {"pump", "flush", "report"} <= wd._warmed
    elif flag in ("flightRecorder", "blackboxPath"):
        spec = "on" if flag == "flightRecorder" else "cap=16"
        job, _, rc = run("--flightRecorder", spec, "--blackboxPath", tmp_path / "bb")
        assert rc == 0 and job.events.cap == (16 if spec == "cap=16" else 4096)
        lines = (tmp_path / "bb" / "blackbox-proc0.jsonl").read_text().splitlines()
        assert json.loads(lines[-1])["kind"] == "terminate"
    elif flag == "overload":
        job, _, rc = run("--overload", "backlogHigh=1,backlogCritical=2",
                         "--heartbeatDir", tmp_path / "hb")
        assert rc == 0 and job.overload_cfg.backlog_high == 1
        # the last chunk staged rows before its pump: the window's peak
        assert (tmp_path / "hb" / "proc0.hb").read_text().split()[1] == "2"
    elif flag == "profileDir":
        _, _, rc = run("--profileDir", tmp_path / "prof")
        assert rc == 0 and list((tmp_path / "prof" / "proc0").glob("trace-*.json"))
    elif flag in ("failProcess", "failAfterRecords"):
        after = 8 if flag == "failProcess" else 12
        _, report, rc = run("--failProcess", 0, "--failAfterRecords", after)
        assert rc == f"worker 0 after {after} records" and report is None
    elif flag == "failAfterChunks":
        _, _, rc = run("--failAfterChunks", 2)
        assert rc == "after chunk 2 (all processes)"
    elif flag in ("corruptShardProcess", "corruptShardSeq", "corruptShardMode"):
        seq = 2 if flag == "corruptShardSeq" else 1
        mode = "withhold" if flag == "corruptShardMode" else "truncate"
        _, _, rc = run("--checkpointDir", ck, "--checkpointEvery", 1, "--corruptShardProcess",
                       0, "--corruptShardSeq", seq, "--corruptShardMode", mode)
        assert rc == 0
        for k in (2, 3, 4):
            shard = ck / f"ckpt-{k}" / "proc0.npz"
            if k != seq:
                assert dj_sha(shard) == json.loads(shard.with_suffix(".json").read_text())[
                    "sha256"]
            elif mode == "withhold":
                assert not shard.exists()
            else:
                assert dj_sha(shard) != json.loads(shard.with_suffix(".json").read_text())[
                    "sha256"]
    elif flag in ("hangProcess", "hangAfterChunks"):
        after = 2 if flag == "hangProcess" else 4
        _, _, rc = run("--hangProcess", 0, "--hangAfterChunks", after)
        assert rc == 0 and stops == [True]
        assert f"injected hang: SIGSTOP after chunk {after}" in capsys.readouterr().err
    elif flag in ("refuseLaunchProcess", "refuseLaunchCount"):
        count = 1 if flag == "refuseLaunchProcess" else 2
        for i in range(count):
            _, _, rc = run("--refuseLaunchProcess", 0, "--refuseLaunchCount", count,
                           "--faultStateDir", fs)
            assert rc == f"worker 0 refused launch ({i + 1}/{count})"
        _, report, rc = run("--refuseLaunchProcess", 0, "--refuseLaunchCount", count,
                            "--faultStateDir", fs)
        assert rc == 0 and _rows_accounted(report)
        assert (fs / "refused.p0").read_text() == str(count)
    elif flag == "faultStateDir":
        for _ in range(2):
            _, _, rc = run("--hangProcess", 0, "--hangAfterChunks", 1, "--faultStateDir", fs)
            assert rc == 0
        assert stops == [True] and (fs / "hang.p0").exists()  # one-shot across runs
    else:
        raise AssertionError(f"no check for --{flag}")


def dj_sha(path):
    from omldm_tpu_torch.runtime.distributed_job import _file_sha256

    return _file_sha256(str(path))


@pytest.mark.parametrize("argv,message", [
    (["--processes", "2", "--processId", "0"], "needs --coordinator"),
    (["--processes", "2", "--coordinator", "127.0.0.1:1"], "needs --processId"),
    (["--processes", "2", "--processId", "2", "--coordinator", "127.0.0.1:1"], "outside"),
    (["--processId", "0"], "--processId needs --processes"),
    (["--coordinator", "127.0.0.1:1"], "--coordinator needs --processes"),
    (["--processes", "0"], "at least one process"),
])
def test_half_named_fleet_is_refused(argv, message, tmp_path):
    from omldm_tpu_torch.__main__ import main

    with pytest.raises(SystemExit, match=message):
        main(["--device", "cpu", *_files(tmp_path), *argv])


def test_fleet_wants_cuda_without_device(tmp_path):
    """Without --device cpu the fleet wants CUDA and, on a host without a
    card, raises before it joins any group."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from omldm_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(FLEET + _files(tmp_path))


def test_unified_cli_single_process(tmp_path):
    """``python -m omldm_tpu_torch --processes 1 ...`` reaches the fleet's
    route through the one entry point (Job.scala:110-120)."""
    perf = tmp_path / "perf.jsonl"
    train = tmp_path / "train.jsonl"
    train.write_text("\n".join(_rows(600, 12)) + "\n")
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(_create() + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "omldm_tpu_torch", "--processes", "1", "--device", "cpu",
         "--requests", str(reqs), "--trainingData", str(train), "--performanceOut",
         str(perf), "--batchSize", "64", "--testSetSize", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(perf.read_text())
    assert report["processes"] == 1
    s = _stat(report)
    assert s["fitted"] + report["holdout"]["0"] == 600
