"""Supervised recovery of the port's fleet, end to end, against its own clean
run and the JAX package's supervised run (tests/test_supervised_recovery.py).

Every case runs the CLI's supervisor (``python -m omldm_tpu_torch
--supervise true --device cpu``, workers ``python -m
omldm_tpu_torch.runtime.distributed_job`` or, on the Kafka route, a
``--workerBoot`` bootstrap that installs tests/fskafka.py first) and the
JAX package's (``python -m omldm_tpu.runtime.distributed_job --supervise
true``, one CPU device a process) on the same files or the same broker
contents, a few launches at a time:

1. a worker killed mid-stream (``--failAfterRecords 350``) on the file
   route: one restart restores the newest snapshot and replays the file
   from its cursor;
2. the same on the Kafka route (``--failAfterRecords 400``): the restart
   seeks every assigned partition back to its checkpointed offset;
3. a snapshot's shard truncated or withheld (``--corruptShardProcess 0
   --corruptShardSeq 1``), then the whole fleet killed: the supervised
   relaunch falls back to the previous complete snapshot.

Each recovered run equals the port's clean run as the JAX tests hold it
(fitted, the holdout, the score within 1e-6, the learning curve), equals
the JAX supervised run in every integer statistic (its score within 1e-5),
and emits its predictions once: the clean run's, line for line.
"""

import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
INT_STATS = ("fitted", "numOfBlocks", "bytesShipped", "modelsShipped", "bytesOnWire",
             "fleetProcesses", "rescalesPerformed", "fleetDegraded")
BOOT = ("import sys; sys.path.insert(0, {tests!r}); import fskafka; fskafka.install(); "
        "from {pkg}.runtime.distributed_job import run_distributed; "
        "sys.exit(run_distributed(sys.argv[1:]))")
N_ROWS, FORE_EVERY = 600, 50


def _rows(n, dim=12, seed=0, forecast_every=0):
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


CREATE = json.dumps({
    "id": 0, "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 1.0}, "dataStructure": {"nFeatures": 12}},
    "preProcessors": [], "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 1},
})


def _run(tmp: Path, tag: str, pkg: str, args, broker=None, expect=0):
    """One CLI invocation (a supervisor, or a bare one-process fleet);
    (report, predictions lines, stderr)."""
    perf, preds = tmp / f"perf_{tag}.jsonl", tmp / f"preds_{tag}.jsonl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one CPU device a JAX process
    if broker is not None:
        env["FSKAFKA_DIR"] = str(broker)
    if pkg == "jax":
        head = [sys.executable, "-m", "omldm_tpu.runtime.distributed_job"]
    else:
        head = [sys.executable, "-m", "omldm_tpu_torch", "--device", "cpu"]
    args = [str(a) for a in args]
    if broker is not None:
        module = "omldm_tpu" if pkg == "jax" else "omldm_tpu_torch"
        args += ["--kafkaBrokers", "fs://local", "--kafkaPollMs", "50",
                 "--workerBoot", BOOT.format(tests=str(TESTS), pkg=module)]
    out = subprocess.run(
        head + ["--performanceOut", str(perf), "--predictionsOut", str(preds),
                "--batchSize", "64", "--testSetSize", "32", "--chunkRows", "100"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == expect, (
        f"{tag}: rc {out.returncode} (wanted {expect}):\n{out.stdout[-2000:]}\n"
        f"{out.stderr[-4000:]}")
    report = json.loads(perf.read_text()) if perf.exists() else None
    lines = preds.read_text().strip().splitlines() if preds.exists() else []
    return report, lines, out.stderr


def _kafka_broker(tmp: Path, tag: str) -> Path:
    broker = tmp / f"broker_{tag}"
    shutil.copytree(tmp / "broker", broker)
    return broker


def _cases(tmp: Path):
    """Every run, by (package, case): the supervised runs of both packages
    and the port's clean ones (a bare one-process fleet)."""
    base = ["--requests", tmp / "reqs.jsonl", "--trainingData", tmp / "train.jsonl"]
    sup = ["--supervise", "true", "--processes", "1", "--restartAttempts", "2",
           "--restartDelayMs", "50"]
    cases = {
        ("port", "clean_file"): dict(args=base + ["--processes", "1"]),
        ("port", "clean_kafka"): dict(args=sup, kafka=True),
    }
    for pkg in ("jax", "port"):
        cases[pkg, "kill_file"] = dict(args=base + sup + [
            "--checkpointDir", tmp / f"{pkg}_ck_file", "--checkpointEvery", "2",
            "--failProcess", "0", "--failAfterRecords", "350"])
        cases[pkg, "kill_kafka"] = dict(args=sup + [
            "--checkpointDir", tmp / f"{pkg}_ck_kafka", "--checkpointEvery", "1",
            "--failProcess", "0", "--failAfterRecords", "400"], kafka=True)
        for mode in ("truncate", "withhold"):
            cases[pkg, mode] = dict(args=base + sup + [
                "--checkpointDir", tmp / f"{pkg}_ck_{mode}", "--checkpointEvery", "2",
                "--corruptShardProcess", "0", "--corruptShardSeq", "1",
                "--corruptShardMode", mode, "--failAfterChunks", "5"])
    return cases


def _launch(tmp: Path, key, case):
    pkg, name = key
    broker = _kafka_broker(tmp, f"{pkg}_{name}") if case.get("kafka") else None
    return _run(tmp, f"{pkg}_{name}", pkg, case["args"], broker=broker)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("supervised")
    (tmp / "train.jsonl").write_text("\n".join(_rows(N_ROWS, forecast_every=FORE_EVERY)) + "\n")
    (tmp / "reqs.jsonl").write_text(CREATE + "\n")
    sys.path.insert(0, str(TESTS))
    import fskafka

    old = os.environ.get("FSKAFKA_DIR")
    os.environ["FSKAFKA_DIR"] = str(tmp / "broker")
    try:
        for i, line in enumerate(_rows(N_ROWS, seed=3, forecast_every=FORE_EVERY)):
            fskafka.append("trainingData", line, partition=i % 2)
        fskafka.append("requests", CREATE)
    finally:
        if old is None:
            os.environ.pop("FSKAFKA_DIR", None)
        else:
            os.environ["FSKAFKA_DIR"] = old
    cases = _cases(tmp)
    out = {"jax": {}, "port": {}}
    with concurrent.futures.ThreadPoolExecutor(max_workers=5) as pool:
        futures = {key: pool.submit(_launch, tmp, key, case) for key, case in cases.items()}
        for (pkg, name), f in futures.items():
            out[pkg][name] = f.result()
    return out


def _stat(report):
    [s] = report["statistics"]
    return s


def _assert_converged(recovered, clean):
    """tests/test_supervised_recovery.py's rule: the same rows fitted, the
    same holdout, a float-equal score (the same step sequence after the
    replay from the checkpoint: no loss, no double training)."""
    sr, sc = _stat(recovered), _stat(clean)
    assert sr["fitted"] == sc["fitted"]
    assert recovered["holdout"] == clean["holdout"]
    assert abs(sr["score"] - sc["score"]) < 1e-6
    assert sr["learningCurve"] == pytest.approx(sc["learningCurve"])


def _same_as_jax(port, jax):
    sp, sj = _stat(port), _stat(jax)
    for key in INT_STATS:
        assert sp[key] == sj[key], (key, sp[key], sj[key])
    assert port["holdout"] == jax["holdout"]
    assert abs(sp["score"] - sj["score"]) <= 1e-5


def test_supervised_kill_recovery_file_source(runs):
    report, preds, err = runs["port"]["kill_file"]
    clean, clean_preds, _ = runs["port"]["clean_file"]
    assert "injected crash: worker 0 after" in err
    assert "relaunching fleet from latest consistent checkpoint" in err
    _assert_converged(report, clean)
    _same_as_jax(report, runs["jax"]["kill_file"][0])
    # outputs dedupe across incarnations: the clean run's predictions, once
    assert preds == clean_preds and len(preds) == N_ROWS // FORE_EVERY


def test_supervised_kill_recovery_kafka_source(runs):
    clean, clean_preds, _ = runs["port"]["clean_kafka"]
    assert _stat(clean)["fitted"] + clean["holdout"]["0"] == N_ROWS - N_ROWS // FORE_EVERY
    report, preds, err = runs["port"]["kill_kafka"]
    assert "injected crash" in err
    assert "relaunching fleet from latest consistent checkpoint" in err
    assert "restored; resuming at offsets" in err
    _assert_converged(report, clean)
    _same_as_jax(report, runs["jax"]["kill_kafka"][0])
    assert preds == clean_preds and len(preds) == N_ROWS // FORE_EVERY


@pytest.mark.parametrize("mode", ["truncate", "withhold"])
def test_supervised_corrupt_shard_falls_back(runs, mode):
    report, preds, err = runs["port"][mode]
    clean, clean_preds, _ = runs["port"]["clean_file"]
    assert "injected crash: after chunk 5" in err
    assert "failed validation" in err
    assert "falling back from ckpt-1 to ckpt-0" in err
    assert "restored; resuming at row 200" in err
    _assert_converged(report, clean)
    _same_as_jax(report, runs["jax"][mode][0])
    assert preds == clean_preds


def test_restart_records_match_jax(runs):
    """The supervisor's log lines of each case: the same restarts, causes
    and relaunches in both packages."""
    def decisions(err):
        return [ln for ln in err.splitlines() if ln.startswith("[supervisor]")]
    for case in ("kill_file", "kill_kafka", "truncate", "withhold"):
        assert decisions(runs["port"][case][2]) == decisions(runs["jax"][case][2]), case
        assert len(decisions(runs["port"][case][2])) == 2, case
