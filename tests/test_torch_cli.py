"""The port's CLI (python -m omldm_tpu_torch) against the JAX package's
(python -m omldm_tpu), both called in-process on the same files.

Tolerances (those of PERF.md section 2 and tests/test_torch_stream_job.py):
a PA prediction is a sign, and float32 sums in another order can flip a
margin near zero, so at least 99% of predictions must be equal -- in count
and in order exactly; final parameters within rtol=2e-4, atol=2e-5; every
integer field of the final JobStatistics equal, float fields within 1e-4,
the holdout ``score`` within one holdout row (1/testSetSize); wall-clock
fields are excluded by name."""

import json

import numpy as np
import pytest
import torch

import omldm_tpu.__main__ as jax_cli
import omldm_tpu_torch.__main__ as port_cli
import omldm_tpu_torch.runtime.fast_ingest as port_ingest

DIM, N_TRAIN, TEST_SET = 8, 1200, 64
COMMON = ["--parallelism", "2", "--batchSize", "16", "--testSetSize", str(TEST_SET)]
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}


def create(width=True, per_record=True, **tc):
    hp = {"C": 0.01, "variant": "PA-I"}
    if per_record:
        hp["usePallas"] = True  # the JAX side runs its kernel in interpret mode
    learner = {"name": "PA", "hyperParameters": hp}
    if width:
        learner["dataStructure"] = {"nFeatures": DIM}
    return {
        "id": 0, "request": "Create", "learner": learner,
        "preProcessors": [{"name": "StandardScaler"}],
        "trainingConfiguration": dict({"protocol": "Asynchronous", "perRecord": per_record}, **tc),
    }


def training_lines(n=N_TRAIN, seed=0, forecast_every=10):
    """HIGGS-like records from a planted rule; every ``forecast_every``-th
    record a forecast inline, EOS markers and a malformed line in the mix."""
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    lines = []
    for i in range(n):
        x = np.round(rng.randn(DIM) * 2.0 + 1.0, 6)
        if i % forecast_every == forecast_every - 1:
            lines.append(json.dumps({"numericalFeatures": x.tolist(), "operation": "forecasting"}))
        else:
            y = float((x - 1.0) @ w + 0.3 * rng.randn() > 0)
            lines.append(json.dumps({"numericalFeatures": x.tolist(), "target": y}))
        if i == n // 3:
            lines.append("EOS")
        if i == n // 2:
            lines.append('{"numericalFeatures": [1.0, "x"')
    return lines


def write_files(tmp_path, requests, lines=None):
    train = tmp_path / "train.jsonl"
    train.write_text("\n".join(lines or training_lines()) + "\n")
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in requests) + "\n")
    return train, reqs


def run_cli(cli, tmp_path, tag, argv, monkeypatch, all_performance=False):
    """Run ``cli.main`` with file sinks under ``tmp_path/tag``; returns
    (job, predictions, responses, final statistics) read back from the
    sinks (with ``all_performance``, every performance record: heartbeats
    and alerts first, the final report last). The job is captured through
    ``build_job``."""
    out = tmp_path / tag
    out.mkdir()
    captured = {}
    real = cli.build_job

    def build_job(flags):
        job, sinks = real(flags)
        captured["job"] = job
        return job, sinks

    monkeypatch.setattr(cli, "build_job", build_job)
    argv = list(argv) + [
        "--predictionsOut", str(out / "pred.jsonl"),
        "--responsesOut", str(out / "resp.jsonl"),
        "--performanceOut", str(out / "perf.jsonl"),
    ]
    if cli is jax_cli:
        argv += ["--compileCache", "off"]
    else:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0

    def read(name):
        text = (out / name).read_text().strip()
        return [json.loads(line) for line in text.splitlines()] if text else []

    if all_performance:
        perf = read("perf.jsonl")
    else:
        [perf] = read("perf.jsonl")
    return captured["job"], read("pred.jsonl"), read("resp.jsonl"), perf


def final_params(job):
    return [net.pipeline.get_flat_params()[0]
            for spoke in job.spokes for net in spoke.nets.values()]


def assert_predictions_match(port, ref):
    assert len(port) == len(ref) > 0
    feats = [p["dataInstance"]["numericalFeatures"] for p in port]
    assert feats == [p["dataInstance"]["numericalFeatures"] for p in ref]
    values = np.array([p["value"] for p in port])
    mismatches = int((values != np.array([p["value"] for p in ref])).sum())
    print(f"prediction mismatches: {mismatches}/{len(values)}")
    assert mismatches <= 0.01 * len(values)


def assert_statistics_match(port, ref):
    [ts], [js] = port["statistics"], ref["statistics"]
    assert set(ts) == set(js) and ts["fitted"] > 0
    for key, jv in js.items():
        tv = ts[key]
        if key in WALL_CLOCK_FIELDS:
            continue
        if key == "score":
            assert abs(tv - jv) <= 1.0 / TEST_SET + 1e-9, key
        elif isinstance(jv, list):
            assert len(tv) == len(jv), key
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=key)
        elif isinstance(jv, float):
            assert abs(tv - jv) <= 1e-4, (key, tv, jv)
        else:
            assert tv == jv, (key, tv, jv)


@pytest.mark.parametrize("width", [True, False], ids=["nFeatures", "inferred"])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, width):
    """Create + Query in the requests file, a training file with inline
    forecasts: the same predictions (count, order, >= 99% of values),
    parameters and statistics as the JAX CLI; the native parser took every
    block of the training file."""
    train, reqs = write_files(tmp_path, [create(width), {"id": 0, "request": "Query",
                                                           "requestId": 3}])
    argv = COMMON + ["--trainingData", str(train), "--requests", str(reqs)]
    port_ingest.blocks.update(native=0, python=0)
    port_job, port_pred, port_resp, port_perf = run_cli(port_cli, tmp_path, "port", argv,
                                                        monkeypatch)
    assert port_ingest.blocks["native"] > 0 and port_ingest.blocks["python"] == 0
    jax_job, jax_pred, jax_resp, jax_perf = run_cli(jax_cli, tmp_path, "jax", argv, monkeypatch)
    assert_predictions_match(port_pred, jax_pred)
    assert len(port_pred) == N_TRAIN // 10
    for a, b in zip(final_params(port_job), final_params(jax_job)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert [r["responseId"] for r in port_resp] == [r["responseId"] for r in jax_resp]
    assert_statistics_match(port_perf, jax_perf)


def test_query_in_requests_file_is_answered_before_training(tmp_path, monkeypatch):
    """The requests file is replayed before the training file (the JAX
    CLI's order): the Query sees a model that has fitted nothing, with zero
    weights, in both packages."""
    train, reqs = write_files(tmp_path, [create(), {"id": 0, "request": "Query",
                                                    "requestId": 5}])
    argv = COMMON + ["--trainingData", str(train), "--requests", str(reqs)]
    for cli, tag in ((port_cli, "port"), (jax_cli, "jax")):
        _, _, resp, perf = run_cli(cli, tmp_path, tag, argv, monkeypatch)
        assert [r["responseId"] for r in resp] == [5]
        assert resp[0]["dataFitted"] == 0
        assert not any(resp[0]["learner"]["parameters"]["values"])
        assert perf["statistics"][0]["fitted"] > 0


@pytest.mark.parametrize("block", ["one_row_a_worker", "default"])
@pytest.mark.parametrize("parallelism", [2, 3])
def test_packed_route_matches_per_record_route(tmp_path, monkeypatch, parallelism, block):
    """The port's packed route against --fastIngest false on the same files
    (tests/test_packed_path.py's rule). With blocks of one row a worker
    (--ingestBatch = parallelism) the workers take their rows in the record
    route's order, so predictions, parameters and statistics are the same
    exactly. With the default 8192-row blocks each worker takes its whole
    share of a block at once, which reorders the Asynchronous pushes
    between workers (as the reference's Flink rebalance may): the same
    records are fitted and the same forecasts answered, the holdout
    accuracy within 0.05."""
    train, reqs = write_files(tmp_path, [create(per_record=False)])
    argv = ["--parallelism", str(parallelism), "--batchSize", "16",
            "--testSetSize", str(TEST_SET), "--trainingData", str(train),
            "--requests", str(reqs)]
    if block == "one_row_a_worker":
        argv += ["--ingestBatch", str(parallelism)]
    port_ingest.blocks.update(native=0, python=0)
    packed_job, packed_pred, _, packed_perf = run_cli(port_cli, tmp_path, "packed", argv,
                                                      monkeypatch)
    assert port_ingest.blocks["native"] > 0
    port_ingest.blocks.update(native=0, python=0)
    plain_job, plain_pred, _, plain_perf = run_cli(
        port_cli, tmp_path, "plain", argv + ["--fastIngest", "false"], monkeypatch)
    assert port_ingest.blocks == {"native": 0, "python": 0}
    assert len(packed_pred) == len(plain_pred) == N_TRAIN // 10
    [ps], [rs] = packed_perf["statistics"], plain_perf["statistics"]
    assert ps["fitted"] == rs["fitted"] > 0

    # the packed route carries the parsed float32 features, the record
    # route the JSON's doubles
    def rows(preds):
        return [(np.float32(p["dataInstance"]["numericalFeatures"]).tolist(), p["value"])
                for p in preds]

    if block == "one_row_a_worker":
        assert rows(packed_pred) == rows(plain_pred)
        for a, b in zip(final_params(packed_job), final_params(plain_job)):
            np.testing.assert_array_equal(a, b)
        assert ps["score"] == rs["score"]
    else:
        assert sorted(r for r, _ in rows(packed_pred)) == sorted(r for r, _ in rows(plain_pred))
        assert abs(ps["score"] - rs["score"]) <= 0.05


def test_events_replay_matches_jax(tmp_path, monkeypatch):
    """--events replays one ordered file: a Query after the training
    records is answered after them, as in the JAX CLI."""
    lines = [{"stream": "requests", "data": create(per_record=False)}]
    for line in training_lines(400):
        obj = json.loads(line) if line.startswith("{") and line.endswith("}") else line
        lines.append({"stream": "trainingData", "data": obj})
    lines.append({"stream": "requests", "data": {"id": 0, "request": "Query", "requestId": 7}})
    combined = tmp_path / "events.jsonl"
    combined.write_text("\n".join(json.dumps(line) for line in lines) + "\n")
    argv = COMMON + ["--events", str(combined)]
    port_job, port_pred, port_resp, port_perf = run_cli(port_cli, tmp_path, "port", argv,
                                                        monkeypatch)
    jax_job, jax_pred, jax_resp, jax_perf = run_cli(jax_cli, tmp_path, "jax", argv, monkeypatch)
    assert_predictions_match(port_pred, jax_pred)
    assert [r["responseId"] for r in port_resp] == [r["responseId"] for r in jax_resp] == [7]
    assert port_resp[0]["dataFitted"] == jax_resp[0]["dataFitted"] > 0
    np.testing.assert_allclose(port_resp[0]["learner"]["parameters"]["values"],
                               jax_resp[0]["learner"]["parameters"]["values"],
                               rtol=2e-4, atol=2e-5)
    assert_statistics_match(port_perf, jax_perf)


def test_telemetry_and_flight_recorder_flags_match_jax(tmp_path, monkeypatch):
    """--telemetry, --flightRecorder and --blackboxPath reach the job in
    both CLIs: the same heartbeat schedule on the performance sink, the
    same black-box dump (wall times aside), and the final report,
    predictions and parameters of the unarmed comparison."""
    train, reqs = write_files(tmp_path, [create(per_record=False, guard=True)])
    base = COMMON + ["--trainingData", str(train), "--requests", str(reqs),
                     "--ingestBatch", "256", "--telemetry", "statsEvery=256,traceSample=4",
                     "--flightRecorder", "watchdogEvery=256,shedHigh=1"]
    runs = {}
    for cli, tag in ((port_cli, "port"), (jax_cli, "jax")):
        argv = base + ["--blackboxPath", str(tmp_path / f"bb_{tag}")]
        runs[tag] = run_cli(cli, tmp_path, tag, argv, monkeypatch, all_performance=True)
    (port_job, port_pred, _, port_perf), (jax_job, jax_pred, _, jax_perf) = (
        runs["port"], runs["jax"])
    assert port_job.telemetry is not None and port_job.events is not None

    def beats(perf):
        return [(p["seq"], p["eventsProcessed"], p["telemetry"]["counters"])
                for p in perf if p.get("kind") == "heartbeat"]

    assert len(beats(port_perf)) >= 3 and beats(port_perf) == beats(jax_perf)
    assert "kind" not in port_perf[-1]
    assert_statistics_match(port_perf[-1], jax_perf[-1])
    assert port_perf[-1]["statistics"][0]["eventsRecorded"] >= 1
    assert_predictions_match(port_pred, jax_pred)
    for a, b in zip(final_params(port_job), final_params(jax_job)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)

    def dump(tag):
        lines = (tmp_path / f"bb_{tag}" / "blackbox-proc0.jsonl").read_text().splitlines()
        return [{k: v for k, v in json.loads(line).items() if k != "wall"} for line in lines]

    assert dump("port") == dump("jax") and dump("port")[-1]["kind"] == "terminate"


def test_profile_dir_writes_a_cpu_trace(tmp_path, monkeypatch):
    """--profileDir on the CPU: a Chrome trace of CPU ops lands in the
    directory, and the run's outputs equal the unprofiled run's."""
    from omldm_tpu_torch.utils.tracing import trace_path

    train, reqs = write_files(tmp_path, [create(per_record=False)])
    argv = COMMON + ["--trainingData", str(train), "--requests", str(reqs)]
    prof = tmp_path / "prof"
    _, plain_pred, _, plain_perf = run_cli(port_cli, tmp_path, "plain", argv, monkeypatch)
    job, prof_pred, _, prof_perf = run_cli(port_cli, tmp_path, "profiled",
                                           argv + ["--profileDir", str(prof)], monkeypatch)
    doc = json.loads(open(trace_path(str(prof))).read())
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops, "the trace holds no CPU op"
    assert [(p["dataInstance"], p["value"]) for p in prof_pred] == [
        (p["dataInstance"], p["value"]) for p in plain_pred]
    assert_statistics_match(prof_perf, plain_perf)


def test_profile_dir_stops_on_an_exception(tmp_path, monkeypatch):
    """A run that raises under --profileDir stops the profiler and the
    exception propagates unchanged."""
    import torch.autograd.profiler as autograd_profiler

    train, reqs = write_files(tmp_path, [create(per_record=False)])

    def boom(job, flags):
        raise RuntimeError("mid-run failure")

    monkeypatch.setattr(port_cli, "_run", boom)
    with pytest.raises(RuntimeError, match="mid-run failure"):
        port_cli.main(COMMON + ["--trainingData", str(train), "--requests", str(reqs),
                                "--device", "cpu", "--profileDir", str(tmp_path / "prof")])
    assert not autograd_profiler._is_profiler_enabled


def test_no_sources_exits():
    with pytest.raises(SystemExit, match="no sources"):
        port_cli.main(["--parallelism", "2", "--device", "cpu"])


def test_parse_flags_pairs_and_booleans():
    assert port_cli.parse_flags(["--parallelism", "4", "--test", "--jobName", "run1"]) == \
        jax_cli.parse_flags(["--parallelism", "4", "--test", "--jobName", "run1"])
    with pytest.raises(SystemExit):
        port_cli.parse_flags(["oops"])


def test_default_device_is_cuda(tmp_path):
    """With no --device the CLI wants CUDA: on a host without a card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    train, reqs = write_files(tmp_path, [create()])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["--trainingData", str(train), "--requests", str(reqs),
                       "--performanceOut", str(tmp_path / "perf.jsonl")])


def test_sparse_create_takes_the_per_record_route(tmp_path, monkeypatch):
    """A sparse Create: requests first, then the training file record by
    record (the dense block parser cannot feed a hashed index space)."""
    sparse = {
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                    "dataStructure": {"sparse": True, "nFeatures": 4 + 64,
                                      "hashSpace": 64, "maxNnz": 8}},
        "trainingConfiguration": {"protocol": "Asynchronous"},
    }
    rng = np.random.RandomState(1)
    lines = []
    for i in range(300):
        rec = {"numericalFeatures": np.round(rng.randn(4), 5).tolist(),
               "categoricalFeatures": [f"a{rng.randint(5)}", f"b{rng.randint(5)}"]}
        if i % 10 == 9:
            rec["operation"] = "forecasting"
        else:
            rec["target"] = float(rec["numericalFeatures"][0] > 0)
        lines.append(json.dumps(rec))
    train, reqs = write_files(tmp_path, [sparse], lines)
    argv = COMMON + ["--trainingData", str(train), "--requests", str(reqs)]
    port_ingest.blocks.update(native=0, python=0)
    port_job, port_pred, _, port_perf = run_cli(port_cli, tmp_path, "port", argv, monkeypatch)
    assert port_ingest.blocks == {"native": 0, "python": 0}
    _, jax_pred, _, jax_perf = run_cli(jax_cli, tmp_path, "jax", argv, monkeypatch)
    assert_predictions_match(port_pred, jax_pred)
    assert_statistics_match(port_perf, jax_perf)
