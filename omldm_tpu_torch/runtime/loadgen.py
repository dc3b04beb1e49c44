"""Seeded, deterministic fleet-scale traffic generator.

Counterpart of ``omldm_tpu/runtime/loadgen.py``: a copy, byte for byte in
what it generates and reports (the port never imports the JAX package).

The load harness' storm source: one :class:`StormSpec` (seed + knobs)
expands into a fully-determined stream -- tenant churn waves
(Create/Update/Delete at chunk-aligned record positions), a diurnal
forecast-rate curve, hot-tenant bursts, mixed train/forecast traffic,
and a scheduled fault storm rendered as the existing selfheal/chaos
fault-driver flags. Same seed => same byte stream, replayable like every
other count-clocked plane (ROADMAP north star; no reference counterpart
-- the reference ships with no test or load tooling at all, PAPER.md §0).

Everything downstream needs is derived here, once, eagerly:

- the DATA stream (``data_lines()``) -- DataInstance JSON lines, train
  and forecast ops mixed per the diurnal curve, optionally
  tenant-addressed (``metadata.tenant``) for the routed/overload planes;
- the CONTROL stream -- the initial Create wave (``request_lines()``)
  plus the mid-stream churn schedule (``schedule_lines()``), the latter
  consumed by the distributed engine's count-clocked
  ``--requestSchedule`` flag and interleaved at exact record positions
  by the in-process leg;
- exact per-tenant accounting (``expected_forecasts()``) -- how many
  forecast outputs each tenant MUST produce given its alive windows,
  the quantity the SLO evaluator's zero-loss / exactly-once gates
  compare against;
- the fault storm (``FaultSpec`` -> injector flags) and the fleet
  argument rendering (``worker_args()``);
- fskafka preloading (``preload_fskafka()``) so the Kafka/distributed
  route replays the identical storm from topic logs (offsets included).

Determinism contract: all generation flows from ``random.Random(seed)``
plus integer arithmetic; floats are rounded before serialization so the
JSON byte stream is stable. ``fingerprint()`` hashes the full byte
stream (data + requests + schedule) -- two storms agree iff their
fingerprints agree, which is what the harness' replay gate asserts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# churn actions (request vocabulary subset the storm composes)
CREATE = "Create"
UPDATE = "Update"
DELETE = "Delete"


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault, rendered onto the existing fault drivers
    (supervisor.DistributedFaultInjector / ChaosConsumer flags):

    - ``crash``: worker ``process`` hard-exits after ``at_records``
      records cross its pump points (exit code 3 -- the classified CRASH
      class; one-shot across incarnations via --faultStateDir)
    - ``hang``: worker ``process`` SIGSTOPs itself after ``at_chunks``
      pump points (the HANG class; needs a supervisor heartbeat timeout)
    - ``launch``: worker ``process`` refuses to come up ``count`` times
      (the LAUNCH class -- dies before its first heartbeat)
    - ``chaos``: seeded drop/dup/reorder on the Kafka data stream
      (``spec`` is the --kafkaChaos spec string)
    - ``sever``: process 0 severs the file-backed broker after
      ``at_chunks`` pump points (fskafka route)
    """

    kind: str
    process: int = 0
    at_records: int = 0
    at_chunks: int = 0
    count: int = 1
    spec: str = ""

    KINDS = ("crash", "hang", "launch", "chaos", "sever")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (want one of {self.KINDS})"
            )

    def flags(self) -> List[str]:
        """The worker argv fragment arming this fault."""
        if self.kind == "crash":
            return [
                "--failProcess", str(self.process),
                "--failAfterRecords", str(self.at_records),
            ]
        if self.kind == "hang":
            return [
                "--hangProcess", str(self.process),
                "--hangAfterChunks", str(self.at_chunks),
            ]
        if self.kind == "launch":
            return [
                "--refuseLaunchProcess", str(self.process),
                "--refuseLaunchCount", str(self.count),
            ]
        if self.kind == "chaos":
            return ["--kafkaChaos", self.spec]
        return ["--severBrokerAfterChunks", str(self.at_chunks)]


@dataclasses.dataclass
class StormSpec:
    """Knobs for one deterministic storm. Every field participates in the
    fingerprint; two equal specs generate identical byte streams."""

    seed: int = 0
    # healthy core: tenants created before record 0 and never touched by
    # churn -- the zero-forecast-loss SLO subjects
    tenants: int = 64
    records: int = 2048
    chunk_rows: int = 64
    n_features: int = 4
    # base fraction of forecast (vs training) records
    forecast_ratio: float = 0.25
    # diurnal rate curve: forecast share modulated sinusoidally with this
    # amplitude over this period (records); 0 disables
    diurnal_amplitude: float = 0.0
    diurnal_period: int = 0
    # hot-tenant bursts: every burst_every records, burst_len consecutive
    # records are ADDRESSED to one of the first hot_tenants tenants
    # (round-robin across bursts); 0 disables
    hot_tenants: int = 0
    burst_every: int = 0
    burst_len: int = 0
    # fraction of non-burst records tenant-addressed to a uniformly
    # chosen alive tenant (0 = pure broadcast traffic)
    addressed_fraction: float = 0.0
    # churn storm: waves of Create/Update/Delete at chunk-aligned
    # positions spread over the stream
    churn_waves: int = 0
    churn_tenants_per_wave: int = 0
    churn_updates_per_wave: int = 0
    # request template
    protocol: str = "CentralizedTraining"
    learner: str = "PA"
    hyper_parameters: Optional[dict] = None
    # extra trainingConfiguration tables (plane arming: serving, guard,
    # codec, ...) merged into every Create/Update
    training_extra: Optional[dict] = None
    # scheduled fault storm
    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {self.tenants}")
        if self.records < 1:
            raise ValueError(f"records must be >= 1, got {self.records}")
        if self.chunk_rows < 1:
            raise ValueError(
                f"chunk_rows must be >= 1, got {self.chunk_rows}"
            )
        if not 0.0 <= self.forecast_ratio <= 1.0:
            raise ValueError(
                f"forecast_ratio must be in [0,1], got {self.forecast_ratio}"
            )
        if self.hot_tenants > self.tenants:
            raise ValueError(
                f"hot_tenants {self.hot_tenants} > tenants {self.tenants}"
            )
        if isinstance(self.faults, list):
            self.faults = tuple(self.faults)


@dataclasses.dataclass
class ChurnEvent:
    """One mid-stream control-plane event: ``action`` on ``tenant`` at
    record position ``at`` (chunk-aligned -- both engines deliver at pump
    points, so alignment makes the accounting exact, not approximate)."""

    at: int
    action: str
    tenant: int


class LoadStorm:
    """One fully-expanded storm: records, churn schedule, fault flags and
    the exact accounting, all derived from the spec at construction."""

    def __init__(self, spec: StormSpec):
        self.spec = spec
        rng = random.Random(spec.seed)
        self.churn: List[ChurnEvent] = self._build_churn(rng)
        # records[i] = (is_forecast, tenant_or_None)
        self._records: List[Tuple[bool, Optional[int]]] = []
        self._features: List[List[float]] = []
        self._targets: List[Optional[float]] = []
        self._build_records(rng)

    # --- churn schedule --------------------------------------------------

    def _align(self, at: int) -> int:
        """Snap a position onto the chunk grid inside (0, records]."""
        cr = self.spec.chunk_rows
        snapped = max(cr, int(round(at / cr)) * cr)
        return min(snapped, (self.spec.records // cr) * cr or cr)

    def _build_churn(self, rng: random.Random) -> List[ChurnEvent]:
        s = self.spec
        events: List[ChurnEvent] = []
        if s.churn_waves <= 0 or s.churn_tenants_per_wave <= 0:
            return events
        next_id = s.tenants  # churn ids never collide with the core
        prev_wave: List[int] = []
        for w in range(1, s.churn_waves + 1):
            at = self._align(w * s.records // (s.churn_waves + 1))
            # Update the first churn_updates_per_wave of the previous
            # wave's tenants (their output window resets -- Update
            # replaces the pipeline with fresh state), Delete the rest
            # (their predictions are preserved as orphans)
            n_up = min(s.churn_updates_per_wave, len(prev_wave))
            for t in prev_wave[:n_up]:
                events.append(ChurnEvent(at, UPDATE, t))
            for t in prev_wave[n_up:]:
                events.append(ChurnEvent(at, DELETE, t))
            # updated tenants stay alive to the end of the stream; only
            # the freshly created wave is managed by the next wave
            created = []
            for _ in range(s.churn_tenants_per_wave):
                events.append(ChurnEvent(at, CREATE, next_id))
                created.append(next_id)
                next_id += 1
            prev_wave = created
        self._next_churn_id = next_id
        return events

    # --- record stream ---------------------------------------------------

    def _forecast_prob(self, i: int) -> float:
        s = self.spec
        p = s.forecast_ratio
        if s.diurnal_amplitude > 0.0 and s.diurnal_period > 0:
            p *= 1.0 + s.diurnal_amplitude * math.sin(
                2.0 * math.pi * i / s.diurnal_period
            )
        return min(max(p, 0.0), 1.0)

    def _build_records(self, rng: random.Random) -> None:
        s = self.spec
        # walk the churn schedule alongside the record index so addressed
        # traffic only ever targets tenants alive AT that position --
        # records addressed to an unknown tenant would fall back to
        # broadcast and wreck the exact accounting
        alive = set(range(s.tenants))
        churn_iter = iter(sorted(self.churn, key=lambda e: (e.at, e.tenant)))
        pending = next(churn_iter, None)
        # burst windows: [start, start+burst_len) addressed to hot tenant
        # (burst_index % hot_tenants)
        for i in range(s.records):
            while pending is not None and pending.at <= i:
                if pending.action == CREATE:
                    alive.add(pending.tenant)
                elif pending.action == DELETE:
                    alive.discard(pending.tenant)
                pending = next(churn_iter, None)
            tenant: Optional[int] = None
            if s.hot_tenants > 0 and s.burst_every > 0 and s.burst_len > 0:
                b = i // s.burst_every
                if b >= 1 and (i % s.burst_every) < s.burst_len:
                    tenant = (b - 1) % s.hot_tenants
            if tenant is None and s.addressed_fraction > 0.0 and alive:
                if rng.random() < s.addressed_fraction:
                    tenant = rng.choice(sorted(alive))
            is_forecast = rng.random() < self._forecast_prob(i)
            feats = [
                round(rng.uniform(-1.0, 1.0), 6) for _ in range(s.n_features)
            ]
            target = None
            if not is_forecast:
                target = round(
                    sum(feats) + 0.1 * rng.uniform(-1.0, 1.0), 6
                )
            self._records.append((is_forecast, tenant))
            self._features.append(feats)
            self._targets.append(target)

    # --- request rendering -----------------------------------------------

    def _request_dict(self, action: str, tenant: int) -> dict:
        s = self.spec
        if action == DELETE:
            return {"id": tenant, "request": DELETE}
        tc = {"protocol": s.protocol}
        if s.training_extra:
            tc.update(s.training_extra)
        return {
            "id": tenant,
            "request": action,
            "learner": {
                "name": s.learner,
                "hyperParameters": dict(s.hyper_parameters or {"C": 1.0}),
                "dataStructure": {"nFeatures": s.n_features},
            },
            "preProcessors": [],
            "trainingConfiguration": tc,
        }

    def request_lines(self) -> List[str]:
        """The initial Create wave (--requests file): the healthy core."""
        return [
            json.dumps(self._request_dict(CREATE, t))
            for t in range(self.spec.tenants)
        ]

    def schedule_entries(self) -> List[Tuple[int, dict]]:
        """The mid-stream churn as (atRecord, request) pairs, delivery
        order = schedule order (Updates/Deletes of the previous wave
        before the wave's Creates, matching the accounting windows)."""
        return [
            (e.at, self._request_dict(e.action, e.tenant))
            for e in self.churn
        ]

    def schedule_lines(self) -> List[str]:
        """--requestSchedule file lines: ``{"atRecord": N, "request":
        {...}}`` JSONL, consumed at pump points where
        ``prev_cursor < atRecord <= cursor``."""
        return [
            json.dumps({"atRecord": at, "request": req})
            for at, req in self.schedule_entries()
        ]

    # --- data rendering --------------------------------------------------

    def data_lines(self) -> Iterator[str]:
        """The DataInstance JSON stream, in record order."""
        for i, (is_forecast, tenant) in enumerate(self._records):
            obj: dict = {
                "id": i,
                "numericalFeatures": self._features[i],
                "operation": "forecasting" if is_forecast else "training",
            }
            if not is_forecast:
                obj["target"] = self._targets[i]
            if tenant is not None:
                obj["metadata"] = {"tenant": tenant}
            yield json.dumps(obj)

    def events(self) -> Iterator[Tuple[str, str]]:
        """The in-process event stream: ("requests"|data-stream, line)
        pairs with churn interleaved at EXACT record positions -- the same
        storm the distributed route replays chunk-quantized (churn
        positions are chunk-aligned, so the two legs see identical
        windows)."""
        schedule = self.schedule_entries()
        k = 0
        for i, line in enumerate(self.data_lines()):
            while k < len(schedule) and schedule[k][0] <= i:
                yield "requests", json.dumps(schedule[k][1])
                k += 1
            is_forecast = self._records[i][0]
            yield (
                "forecastingData" if is_forecast else "trainingData"
            ), line
        while k < len(schedule):
            yield "requests", json.dumps(schedule[k][1])
            k += 1

    # --- exact accounting ------------------------------------------------

    def windows(self) -> Dict[int, List[Tuple[int, int, bool]]]:
        """Per-tenant output windows ``(start, end, preserved)``: a
        window's forecasts survive into the final output iff it ended in
        Delete (orphaned) or end-of-stream -- an Update REPLACES the
        pipeline (fresh state), discarding the predictions of the window
        it closes."""
        out: Dict[int, List[Tuple[int, int, bool]]] = {}
        open_at: Dict[int, int] = {t: 0 for t in range(self.spec.tenants)}
        for e in sorted(self.churn, key=lambda e: (e.at, e.tenant)):
            if e.action == CREATE:
                open_at[e.tenant] = e.at
            elif e.action == UPDATE:
                start = open_at.pop(e.tenant, None)
                if start is not None:
                    out.setdefault(e.tenant, []).append(
                        (start, e.at, False)
                    )
                open_at[e.tenant] = e.at
            elif e.action == DELETE:
                start = open_at.pop(e.tenant, None)
                if start is not None:
                    out.setdefault(e.tenant, []).append((start, e.at, True))
        for t, start in open_at.items():
            out.setdefault(t, []).append((start, self.spec.records, True))
        return out

    def expected_forecasts(
        self, routed: bool = False, update_discards: bool = True
    ) -> Dict[int, int]:
        """Exactly how many forecast outputs each tenant must produce.

        ``routed=False`` (fan-out semantics -- the distributed engine, or
        the in-process engine without overload/tenant routing): every
        forecast record reaches every live pipeline. ``routed=True``
        (tenant routing armed): addressed records reach only their
        addressee, broadcast records reach everyone.

        ``update_discards=True`` models the distributed engine, which
        buffers predictions per pipeline until the final write -- an
        Update replaces the pipeline and its buffered outputs vanish.
        The in-process engine emits predictions live, so outputs from a
        window an Update closed survive: pass ``update_discards=False``
        there."""
        # prefix counts over the record stream
        n = self.spec.records
        all_pref = [0] * (n + 1)
        bcast_pref = [0] * (n + 1)
        addr_pos: Dict[int, List[int]] = {}
        for i, (is_forecast, tenant) in enumerate(self._records):
            all_pref[i + 1] = all_pref[i] + (1 if is_forecast else 0)
            bcast_pref[i + 1] = bcast_pref[i] + (
                1 if (is_forecast and tenant is None) else 0
            )
            if is_forecast and tenant is not None:
                addr_pos.setdefault(tenant, []).append(i)
        import bisect

        def addr_count(t: int, a: int, b: int) -> int:
            pos = addr_pos.get(t)
            if not pos:
                return 0
            return bisect.bisect_left(pos, b) - bisect.bisect_left(pos, a)

        out: Dict[int, int] = {}
        for t, wins in self.windows().items():
            total = 0
            for start, end, preserved in wins:
                if update_discards and not preserved:
                    continue
                if routed:
                    total += (
                        bcast_pref[end] - bcast_pref[start]
                        + addr_count(t, start, end)
                    )
                else:
                    total += all_pref[end] - all_pref[start]
            out[t] = total
        return out

    def healthy_tenants(self) -> List[int]:
        """The zero-loss SLO subjects: the untouched core."""
        churned = {e.tenant for e in self.churn}
        return [t for t in range(self.spec.tenants) if t not in churned]

    def hot_tenant_ids(self) -> List[int]:
        """The burst targets -- the only tenants a bounded-shed SLO may
        charge shed to."""
        return list(range(self.spec.hot_tenants))

    # --- fleet rendering -------------------------------------------------

    def fault_flags(self, state_dir: str) -> List[str]:
        """The fault storm as injector argv (+ the one-shot state dir --
        without it every relaunched incarnation would re-fire)."""
        args: List[str] = []
        for f in self.spec.faults:
            args += f.flags()
        if self.spec.faults:
            args += ["--faultStateDir", state_dir]
        return args

    def write_files(self, out_dir: str) -> Dict[str, str]:
        """Materialize the storm: data + initial requests + churn
        schedule JSONL files; returns their paths."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "data": os.path.join(out_dir, "storm_data.jsonl"),
            "requests": os.path.join(out_dir, "storm_requests.jsonl"),
            "schedule": os.path.join(out_dir, "storm_schedule.jsonl"),
        }
        with open(paths["data"], "w") as f:
            for line in self.data_lines():
                f.write(line + "\n")
        with open(paths["requests"], "w") as f:
            for line in self.request_lines():
                f.write(line + "\n")
        with open(paths["schedule"], "w") as f:
            for line in self.schedule_lines():
                f.write(line + "\n")
        return paths

    def worker_args(
        self,
        out_dir: str,
        *,
        checkpoint_every: int = 0,
        extra: Sequence[str] = (),
    ) -> List[str]:
        """Worker argv for the supervised fleet: storm files, chunk
        cadence, checkpointing, the fault storm. ``extra`` appends
        plane-arming flags (overload/events/...)."""
        paths = self.write_files(out_dir)
        args = [
            "--trainingData", paths["data"],
            "--requests", paths["requests"],
            "--chunkRows", str(self.spec.chunk_rows),
        ]
        if self.churn:
            args += ["--requestSchedule", paths["schedule"]]
        if checkpoint_every > 0:
            ckpt = os.path.join(out_dir, "ckpt")
            os.makedirs(ckpt, exist_ok=True)
            args += [
                "--checkpointDir", ckpt,
                "--checkpointEvery", str(checkpoint_every),
            ]
        args += self.fault_flags(os.path.join(out_dir, "faults"))
        args += list(extra)
        return args

    # --- fskafka preloading ----------------------------------------------

    def preload_fskafka(
        self, fskafka_dir: str, partitions: int = 1
    ) -> Dict[str, int]:
        """Write the storm into tests/fskafka.py topic logs so the
        Kafka/distributed route replays the identical byte stream:
        training records to ``trainingData`` partitions (round-robin by
        record index -- offsets are line numbers), forecast records to
        ``forecastingData``, the full control stream (initial Creates
        then churn, in schedule order) to ``requests``. Returns the
        per-topic record counts."""
        os.makedirs(fskafka_dir, exist_ok=True)

        def _append(topic: str, partition: int, line: str) -> None:
            path = os.path.join(
                fskafka_dir, f"{topic}--{partition}.log"
            )
            with open(path, "a") as f:
                f.write(line + "\n")

        # truncate any previous preload (replay = identical logs)
        for name in os.listdir(fskafka_dir):
            if name.endswith(".log"):
                os.unlink(os.path.join(fskafka_dir, name))
        counts = {"trainingData": 0, "forecastingData": 0, "requests": 0}
        for i, line in enumerate(self.data_lines()):
            topic = (
                "forecastingData" if self._records[i][0] else "trainingData"
            )
            _append(topic, i % partitions, line)
            counts[topic] += 1
        for line in self.request_lines():
            _append("requests", 0, line)
            counts["requests"] += 1
        for _, req in self.schedule_entries():
            _append("requests", 0, json.dumps(req))
            counts["requests"] += 1
        return counts

    # --- identity --------------------------------------------------------

    def fingerprint(self) -> str:
        """sha256 over the complete byte stream (data + initial requests
        + schedule): the replay identity the harness asserts."""
        h = hashlib.sha256()
        for line in self.data_lines():
            h.update(line.encode())
            h.update(b"\n")
        for line in self.request_lines():
            h.update(line.encode())
            h.update(b"\n")
        for line in self.schedule_lines():
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()
