"""CLI entry point: ``python -m omldm_tpu_torch [--flag value ...]``.

The port's counterpart of ``python -m omldm_tpu`` on its file and replay
routes (the reference's ``Job.main``, Job.scala:110-171): parse ``--key
value`` flags with ``ParameterTool.fromArgs`` semantics, build the sinks,
assemble the job and run it. The job knobs take the JAX package's names
(``JobConfig.from_args``).

Sources (choose one style):

- ``--trainingData path.jsonl`` / ``--forecastingData path.jsonl`` /
  ``--requests path.jsonl`` -- JSON-lines file replay, round-robin
  interleaved (the deterministic stand-in for stream union, Job.scala:70);
  ``EOS`` marker lines are dropped and replay continues
  (DataInstanceParser.scala:13-21). With a training file and only a
  requests file beside it, the requests are replayed FIRST, as the JAX
  package does. With ``--ingest SPEC`` (``JobConfig.ingest``: e.g.
  ``shards=4``, ``shards=4,device=on`` or ``on``), a dense job's training
  file goes through the sharded ingest plane
  (``StreamJob.run_file_sharded``: parser processes, blocks replayed in
  file order through the packed route, any number of pipelines). Else,
  when the requests leave one pipeline, on the SPMD engine (``engine:
  spmd``), the training file goes through the fused C parse -> holdout ->
  stage loop (``StreamJob.run_file_fused``; ``--fusedIngest false`` opts
  out), dense or sparse. Otherwise it goes through the C++ bulk parser
  (``--fastIngest auto|true|false``, blocks of ``--ingestBatch`` rows,
  parsed ``--prefetchDepth`` blocks ahead on a thread); sparse Creates then
  take the per-record route.
- ``--events combined.jsonl`` -- one fully ordered file of ``{"stream":
  "trainingData"|"forecastingData"|"requests", "data": {...}}`` lines.
- ``--kafkaBrokers host:port`` -- the live Kafka consumer and producer
  (``runtime.kafka_io``; needs kafka-python, a module importable as
  ``kafka``): the polling loop runs until the silence timer
  (``--timeout`` ms, StatisticsOperator.scala:135-142) terminates the job;
  an idle poll window still ticks the silence and overload clocks, and an
  overload controller at CRITICAL pauses consumption (its offsets stay
  unread, so paused traffic replays). Predictions, responses, performance
  and dead letters publish to their topics unless a ``--*Out`` file flag
  claims the stream. ``--retry*`` / ``--sendRetry*`` set the connect and
  send backoff (``BackoffPolicy.from_flags``); ``OMLDM_CHAOS_KAFKA``
  arms the seeded broker-side chaos (``runtime.supervisor.ChaosConsumer``).

Sinks: ``--predictionsOut`` / ``--responsesOut`` / ``--performanceOut``
write JSON lines to files (default: performance to stdout).

Observability: ``--telemetry SPEC`` arms the telemetry plane (heartbeats on
the performance sink, the phase table, sampled spans), ``--flightRecorder
SPEC`` the flight recorder (``--blackboxPath DIR`` for its ring dumps and
bundles), and ``--profileDir DIR`` wraps the file and replay routes in a
``torch.profiler`` trace (``utils.tracing.trace``: a Chrome trace in DIR,
with the card's kernels on a CUDA job). On the unbounded Kafka route the
trace covers the first ``--profileSteps`` events (default 1000) and stops
once (``utils.tracing.ProfileWindow``).

Recovery: ``--checkpointing true --stateBackend DIR --checkInterval MS``
snapshot the job every MS milliseconds into DIR, and ``--restartAttempts
N`` (with ``--restartDelayMs``) runs the replay under
``runtime.recovery.JobSupervisor``: a failure restores the newest snapshot
and resumes the replay at its event offset (without checkpointing, from
the start). Either one keeps the file route on the event loop, which
owns the periodic save. On the Kafka route a failure restores the newest
snapshot of this run and seeks the rebuilt consumer to its (topic,
partition) offsets; without one the next incarnation starts fresh at the
live position, its request partitions rewound.

Fleet: ``--processes N --processId i --coordinator host:port`` (any of
the three) hands the command to the multi-process fleet's file route,
``runtime.distributed_job.run_distributed``, as the JAX CLI does; every
process runs the same command with its own ``--processId``. The fleet
checkpoints (``--checkpointDir D --checkpointEvery K``), restores
(``--restore true``, also at another process count), beats
(``--heartbeatDir``), guards its collectives (``--collectiveTimeoutMs``),
journals (``--flightRecorder``) and injects faults (``--failAfterChunks``
and the rest of the JAX fleet's injector flags); the flags of its Kafka
drive and of its supervisor (``--fleetDegraded``) are refused by name.

``--device`` (default ``cuda``) is the port's own flag: without a card,
CUDA raises. Flags of the JAX CLI whose route or knob the port does not
have (the fleet's supervisor, the XLA compile cache, JAX-only
``JobConfig`` fields) raise ``SystemExit`` naming the flag instead of
being ignored.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, Iterator, List, Optional, Tuple

from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime.ingest import file_events, interleave
from omldm_tpu_torch.runtime.job import (
    FORECASTING_STREAM,
    PACKED_STREAM,
    REQUEST_STREAM,
    TRAINING_STREAM,
    StreamJob,
)
from omldm_tpu_torch.utils.tracing import ProfileWindow, trace

_STREAMS = (TRAINING_STREAM, FORECASTING_STREAM, REQUEST_STREAM)

# flags that make a command one process of the fleet
FLEET_FLAGS = ("processes", "processId", "coordinator")

# routes of the JAX CLI the port does not have: flag -> what it arms there
UNPORTED_ROUTE_FLAGS = {
    "supervise": "the multi-process fleet's supervisor",
    "compileCache": "the XLA compile cache",
    "compileCacheMinSecs": "the XLA compile cache",
}


def parse_flags(argv: List[str]) -> Dict[str, str]:
    """``--key value`` pairs -> dict (ParameterTool.fromArgs, Job.scala:114).
    A flag without a value is treated as boolean true."""
    flags: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"expected --flag, got {arg!r}")
        key = arg[2:]
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            flags[key] = argv[i + 1]
            i += 2
        else:
            flags[key] = "true"
            i += 1
    return flags


def refuse_unported(flags: Dict[str, str]) -> None:
    """SystemExit naming the first flag whose route the port lacks."""
    for key, what in UNPORTED_ROUTE_FLAGS.items():
        if key in flags:
            raise SystemExit(f"--{key}: {what} is not ported to omldm_tpu_torch")


def combined_events(path: str) -> Iterator[Tuple[str, str]]:
    """Replay a fully-ordered combined event file: each line is
    ``{"stream": <topic>, "data": <record object or JSON string>}``."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            stream = obj.get("stream")
            if stream not in _STREAMS:
                continue
            data = obj.get("data")
            yield (stream, data if isinstance(data, str) else json.dumps(data))


class _FileSink:
    def __init__(self, path: Optional[str], default=None):
        self._f = open(path, "w") if path else default

    def __call__(self, obj: Any) -> None:
        if self._f is None:
            return
        payload = obj.to_json() if hasattr(obj, "to_json") else json.dumps(obj)
        self._f.write(payload + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None and self._f not in (sys.stdout, sys.stderr):
            self._f.close()


def build_job(flags: Dict[str, str]) -> Tuple[StreamJob, List[_FileSink]]:
    config = JobConfig.from_args(flags)
    pred_sink = _FileSink(flags.get("predictionsOut"))
    resp_sink = _FileSink(flags.get("responsesOut"))
    perf_sink = _FileSink(flags.get("performanceOut"), default=sys.stdout)
    sinks = [pred_sink, resp_sink, perf_sink]
    try:
        job = StreamJob(
            config,
            on_prediction=pred_sink,
            on_response=resp_sink,
            on_performance=perf_sink,
            device=flags.get("device"),
        )
    except BaseException:
        for sink in sinks:
            sink.close()
        raise
    return job, sinks


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = parse_flags(argv)
    refuse_unported(flags)
    if any(k in flags for k in FLEET_FLAGS):
        # one entry point for both shapes (Job.scala:110-120)
        from omldm_tpu_torch.runtime.distributed_job import run_distributed

        return run_distributed(argv)
    job, sinks = build_job(flags)
    try:
        if "kafkaBrokers" in flags:
            # unbounded stream: the Kafka loop bounds its own profile
            # window (--profileSteps events) instead of tracing the run
            return _run_kafka(job, flags)
        with trace(flags.get("profileDir"), job.device):
            return _run(job, flags)
    finally:
        for sink in sinks:
            sink.close()


def _run(job: StreamJob, flags: Dict[str, str]) -> int:
    if "events" in flags:
        _run_replay(job, flags, lambda: combined_events(flags["events"]))
        return 0
    if _try_fused_run(job, flags):
        return 0

    def make_events():
        packed = None
        if TRAINING_STREAM in flags and flags.get("fastIngest", "auto") != "false":
            packed = _packed_training_source(flags)
        sources = []
        for topic in _STREAMS:
            if topic not in flags:
                continue
            if topic == TRAINING_STREAM and packed is not None:
                sources.append(packed)
            else:
                sources.append(file_events(flags[topic], topic))
        if not sources:
            raise SystemExit(
                "no sources: pass --trainingData/--forecastingData/--requests "
                "<path.jsonl>, --events <combined.jsonl>, or --kafkaBrokers "
                "<host:port>"
            )
        return interleave(*sources)

    _run_replay(job, flags, make_events)
    return 0


def _apply_kafka_sinks(job: StreamJob, flags: Dict[str, str], producer_sinks) -> None:
    """Kafka producers are the default egress; an explicitly passed file
    sink keeps precedence over the producer for its stream."""
    job.set_sinks(
        on_prediction=None if "predictionsOut" in flags else producer_sinks.on_prediction,
        on_response=None if "responsesOut" in flags else producer_sinks.on_response,
        on_performance=None if "performanceOut" in flags else producer_sinks.on_performance,
    )
    # quarantined records and requests publish to the deadLetters topic
    # besides the job's in-memory ring and --deadLetterPath file
    job.dead_letter.publish = producer_sinks.on_dead_letter


def _kafka_loop(job: StreamJob, events, profile: Dict) -> None:
    """One supervised attempt at the live polling loop. ``profile`` carries
    the bounded trace window across restart attempts (the window counts
    TOTAL events, and the trace stops exactly once)."""
    # start the silence clock at loop entry, so a broker that never
    # delivers anything still terminates after the timeout
    job.stats.mark_activity()
    for event in events:  # None on each idle poll window
        if event is not None:
            job.process_event(*event)
            if job.checkpoint_manager is not None:
                job.checkpoint_manager.maybe_save(job)
            profile["n_events"] += 1
            window = profile["window"]
            if window is not None and window.active and profile["n_events"] >= profile["steps"]:
                try:
                    window.stop()
                except Exception as exc:  # noqa: BLE001 -- re-raised by _run_kafka
                    # a profiling fault is not a job failure: held past the
                    # restart loop, so it never triggers a restart
                    profile["error"] = exc
        else:
            # idle or backpressure-paused poll window: idle capacity decays
            # the overload counters so a CRITICAL pause can clear (a no-op
            # when the plane is unarmed)
            job.overload_idle_tick()
        job.check_silence()
        if job.stats.terminated:
            break


def _kafka_retry_policies(flags: Dict[str, str]):
    """(connect/metadata policy, producer-send policy) from the CLI knobs
    ``--retry{Attempts,BaseDelayMs,Growth,JitterMs,TimeoutMs}`` and
    ``--sendRetry{...}`` (defaults in ``runtime.kafka_io``)."""
    import dataclasses

    from omldm_tpu_torch.runtime.kafka_io import CONNECT_RETRY, SEND_RETRY
    from omldm_tpu_torch.utils.backoff import BackoffPolicy

    connect = BackoffPolicy.from_flags(flags, "retry", **dataclasses.asdict(CONNECT_RETRY))
    send = BackoffPolicy.from_flags(flags, "sendRetry", **dataclasses.asdict(SEND_RETRY))
    return connect, send


def _run_kafka(job: StreamJob, flags: Dict[str, str]) -> int:
    """The live Kafka job, optionally supervised (``--restartAttempts N``):
    on failure, restore the newest checkpoint taken during this run and
    seek the rebuilt consumer to the snapshot's (topic, partition) offsets
    -- Flink's restore-from-checkpoint with Kafka source offsets. Without a
    usable snapshot the next incarnation starts fresh from the live
    position (no replay), Flink's uncheckpointed behaviour on a live
    source. The restart loop runs under the shared backoff helper (fixed
    delay, bounded attempts: RestartStrategies.fixedDelayRestart)."""
    # looked up on the module at call time: tests stand a fake broker in
    from omldm_tpu_torch.runtime import kafka_io
    from omldm_tpu_torch.runtime.recovery import recover_job
    from omldm_tpu_torch.utils.backoff import BackoffPolicy, with_backoff

    attempts = int(flags.get("restartAttempts", "0"))
    delay_s = float(flags.get("restartDelayMs", "0")) / 1000.0
    connect_retry, send_retry = _kafka_retry_policies(flags)
    # the bounded profile window of the unbounded stream: the first
    # --profileSteps events (default 1000)
    profile = {"window": None, "n_events": 0, "error": None,
               "steps": int(flags.get("profileSteps", "1000"))}
    if flags.get("profileDir"):
        profile["window"] = ProfileWindow(flags["profileDir"], job.device).start()

    manager = job.checkpoint_manager
    ckpt_floor = manager.latest_path() if manager is not None else None
    # mutable attempt state: each restart swaps in the recovered job, its
    # tracker and the reconnected clients for the next with_backoff attempt
    state = {"job": job, "tracker": {}}

    def pause_when() -> bool:
        # upstream backpressure (runtime/overload.py): while any spoke's
        # overload controller reports CRITICAL the polling loop stops
        # consuming, offsets unread, so paused traffic replays instead of
        # buffering; read through ``state``, it follows the restarts
        return state["job"].overload_level() >= 2

    failed = True
    try:
        events, producer_sinks = kafka_io.connect_kafka(
            flags["kafkaBrokers"], tracker=state["tracker"], retry=connect_retry,
            send_retry=send_retry, pause_when=pause_when,
        )
        state.update(events=events, sinks=producer_sinks)

        def attempt() -> int:
            j = state["job"]
            j.source_position = state["tracker"]
            _apply_kafka_sinks(j, flags, state["sinks"])
            _kafka_loop(j, state["events"], profile)
            return 0

        def on_restart(exc: Exception, next_attempt: int) -> None:
            print(f"job failure ({type(exc).__name__}: {exc}); "
                  f"restart {next_attempt - 1}/{attempts}", file=sys.stderr)
            new_job, _restored_from = recover_job(state["job"], ckpt_floor)
            if new_job.source_position is None:
                # fresh incarnation: data streams continue from the live
                # position (no replay on a live source), but the CONTROL
                # stream rewinds to the beginning -- a fresh-state job must
                # re-consume Create/Update/Delete to rebuild its topology.
                # Dropping the key makes the reconnect seek those
                # partitions to the beginning
                position = dict(state["tracker"])
                for key in list(position):
                    if kafka_io.DEFAULT_TOPICS.get(key[0]) == REQUEST_STREAM:
                        del position[key]
                new_job.source_position = position
            new_tracker = dict(new_job.source_position)
            # close the abandoned clients: restarts must not leak broker
            # connections
            state["sinks"].close()
            new_events, new_sinks = kafka_io.connect_kafka(
                flags["kafkaBrokers"], position=new_tracker, tracker=new_tracker,
                retry=connect_retry, send_retry=send_retry, pause_when=pause_when,
            )
            state.update(job=new_job, events=new_events, sinks=new_sinks, tracker=new_tracker)

        rc = with_backoff(
            attempt, policy=BackoffPolicy(attempts=attempts + 1, base_delay=delay_s),
            retry_on=(Exception,), on_retry=on_restart,
        )
        if profile["error"] is not None:
            raise profile["error"]
        failed = False
        return rc
    finally:
        # the window stops once: here only if the stream ended (or failed)
        # inside it
        if profile["window"] is not None:
            profile["window"].stop(write=not failed)


def _run_replay(job: StreamJob, flags: Dict[str, str], make_events) -> None:
    """Replay a deterministic source; ``--restartAttempts N`` opts into
    supervised recovery (Flink's restart strategy: restore the newest
    checkpoint -- pass ``--checkpointing true`` for stateful recovery --
    and resume the replay at the snapshot's event offset)."""
    attempts = int(flags.get("restartAttempts", "0"))
    if attempts > 0:
        from omldm_tpu_torch.runtime.recovery import JobSupervisor, replayable

        JobSupervisor(
            job,
            replayable(make_events),
            max_restarts=attempts,
            restart_delay_s=float(flags.get("restartDelayMs", "0")) / 1000.0,
        ).run()
    else:
        job.run(make_events())


def _try_fused_run(job: StreamJob, flags: Dict[str, str]) -> bool:
    """The fastest file route, as the JAX CLI's: whenever the training file
    is the only data source and the width can be pinned, replay the whole
    requests file first, deploy the Creates at that width, and consume the
    training file -- through the sharded ingest plane when ``--ingest``
    arms it and the job is dense (``StreamJob.run_file_sharded``: any
    pipelines, blocks replayed in file order), else through the fused C
    loop when the job holds one pipeline, on the SPMD engine
    (``StreamJob.run_file_fused``) -- and terminate: True. Checkpointing
    and ``--restartAttempts`` keep the file on the event loop: False before
    anything is read. Otherwise the requests stay processed, the width is
    stashed for the packed route (a sparse job takes the per-record route
    instead), and the event loop resumes: False."""
    if TRAINING_STREAM not in flags:
        return False
    if flags.get("fastIngest", "auto") == "false":
        return False
    if flags.get("fusedIngest", "auto") == "false":
        return False
    if job.checkpoint_manager is not None:
        return False  # the event loop owns maybe_save
    if int(flags.get("restartAttempts", "0")) > 0:
        return False  # supervised recovery wraps the event loop, not this
    if any(t in flags for t in _STREAMS if t not in (TRAINING_STREAM, REQUEST_STREAM)):
        return False
    spec = _stream_spec(flags)
    sparse = False
    if spec is None:
        spec = _sparse_stream_spec(flags)
        sparse = spec is not None
    if spec is None:
        return False
    if REQUEST_STREAM in flags:
        for stream, line in file_events(flags[REQUEST_STREAM], REQUEST_STREAM):
            job.process_event(stream, line)
        # consumed here: the event route must not replay them again
        del flags[REQUEST_STREAM]
        if sparse:
            # the dense packed batcher cannot feed a sparse job: the marker
            # sends it down the per-record route
            flags["__sparseStream__"] = "1"
        else:
            flags["__streamSpec__"] = f"{spec[0]},{spec[1]}"
    job.ensure_deployed(spec[0])
    # the sharded ingest plane: dense jobs only (its parser shards run the
    # dense packed batcher); host-plane and multi-pipeline jobs are fine --
    # the blocks replay through the packed route, in file order
    if job.ingest_cfg is not None and not sparse:
        if job.run_file_sharded(flags[TRAINING_STREAM], dim=spec[0], hash_dims=spec[1]):
            job.terminate()
            return True
        return False
    if job.fused_file_bridge() is None:
        return False  # requests stay processed; the packed route resumes
    job.run_file_fused(flags[TRAINING_STREAM])
    job.terminate()
    return True


def _sparse_stream_spec(flags: Dict[str, str]) -> Optional[Tuple[int, int]]:
    """(total feature width, 0) from the first SPARSE Create/Update."""
    from omldm_tpu_torch.api.requests import Request, RequestType

    if REQUEST_STREAM not in flags:
        return None
    try:
        for _, line in file_events(flags[REQUEST_STREAM], REQUEST_STREAM):
            req = Request.from_json(line)
            if req is None or req.request not in (RequestType.CREATE, RequestType.UPDATE):
                continue
            ds = req.learner.data_structure if req.learner else None
            if ds and ds.get("sparse") and "nFeatures" in ds:
                return int(ds["nFeatures"]), 0
            return None
    except OSError:
        return None
    return None


def _stream_spec(flags: Dict[str, str]) -> Optional[Tuple[int, int]]:
    """(total feature width, hash_dims) for the packed route: from the first
    Create/Update carrying nFeatures, else inferred from the first training
    record (the reference sizes models lazily on the first record; the
    packed batcher needs the width up front). None for a sparse job."""
    from omldm_tpu_torch.api.data import DataInstance
    from omldm_tpu_torch.api.requests import Request, RequestType
    from omldm_tpu_torch.runtime.vectorizer import Vectorizer

    if "__sparseStream__" in flags:
        return None  # sparse pipelines featurize per record
    if "__streamSpec__" in flags:  # resolved by _try_fused_run
        dim, hash_dims = flags["__streamSpec__"].split(",")
        return int(dim), int(hash_dims)
    if REQUEST_STREAM in flags:
        try:
            for _, line in file_events(flags[REQUEST_STREAM], REQUEST_STREAM):
                req = Request.from_json(line)
                if req is None or req.request not in (
                    RequestType.CREATE, RequestType.UPDATE
                ):
                    continue
                hash_dims = int(req.training_configuration.extra.get("hashDims", 0))
                ds = req.learner.data_structure if req.learner else None
                if ds and ds.get("sparse"):
                    # padded COO per record (SparseVectorizer): the dense
                    # block parser cannot feed a wide hashed index space
                    return None
                if ds and "nFeatures" in ds:
                    return int(ds["nFeatures"]) + hash_dims, hash_dims
                # first Create without an explicit width: infer from data
                for _, dline in file_events(flags[TRAINING_STREAM], TRAINING_STREAM):
                    inst = DataInstance.from_json(dline)
                    if inst is not None:
                        return Vectorizer.infer_dim(inst, hash_dims), hash_dims
                return None
        except OSError:
            return None
    try:
        for _, dline in file_events(flags[TRAINING_STREAM], TRAINING_STREAM):
            inst = DataInstance.from_json(dline)
            if inst is not None:
                return Vectorizer.infer_dim(inst, 0), 0
    except OSError:
        return None
    return None


def _packed_training_source(flags: Dict[str, str]):
    """The training file as PACKED_STREAM events: C++ bulk parse -> (x, y,
    op) blocks, prefetched ahead of the device feed. None when the width
    cannot be pinned or (in auto mode) the native parser is unavailable --
    the caller then replays the file record by record."""
    from omldm_tpu_torch.ops.native import fast_parser_available
    from omldm_tpu_torch.runtime.fast_ingest import iter_file_batches
    from omldm_tpu_torch.runtime.prefetch import prefetch

    spec = _stream_spec(flags)
    if spec is None:
        return None
    if flags.get("fastIngest", "auto") != "true" and not fast_parser_available():
        return None
    dim, hash_dims = spec
    batches = iter_file_batches(
        flags[TRAINING_STREAM], dim, int(flags.get("ingestBatch", "8192")), hash_dims,
    )
    depth = int(flags.get("prefetchDepth", "2"))
    return ((PACKED_STREAM, b) for b in prefetch(batches, depth))


if __name__ == "__main__":
    sys.exit(main())
