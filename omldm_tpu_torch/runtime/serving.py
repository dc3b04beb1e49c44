"""Adaptive-batching forecast serving plane.

Counterpart of ``omldm_tpu/runtime/serving.py``. The reference answers
every forecasting record immediately with one predict per record
(FlinkSpoke.scala:92-107). Armed per pipeline by
``trainingConfiguration.serving`` (or the job-wide ``JobConfig.serving``
default spec), forecasting records are ADMITTED into per-net FIFO queues
and served by ONE padded predict launch over the whole queue. A queue
flushes when:

- it fills to ``serving.maxBatch`` rows (checked at record boundaries);
- its oldest entry ages past ``serving.maxDelayMs`` (the deadline -- polled
  on the event path and from the job's silence check);
- the net's model is about to change -- a fit dispatch or a hub payload --
  in the default ``staleness=exact`` mode, so every queued forecast is
  answered with exactly the parameters the per-record path would have used;
- ``staleness=relaxed`` (opt-in) lets up to ``serving.staleChunks`` such
  changes pass first, trading a bounded model staleness for wider batches;
- the stream terminates, a query arrives, or the pipeline is deleted.

Under overload pressure (``runtime.overload``) the limits a flush compares
against are the controller's degraded ones (widened ``maxBatch`` and
``maxDelayMs``, relaxed staleness: :func:`_limits`), and on entering
CRITICAL an over-limit tenant's queue is taken unserved (:meth:`take_queue`)
and answered with reason-coded dead letters.

Per-record latency clocks (enqueue -> emit) feed the ``forecastsServed`` and
serving-latency fields of ``Statistics``; emission keeps stream order per
net. A flush takes the net's cohort group: every pending net attached to
the same cohort (``runtime.cohort``) is served by ONE ``[C, B]`` gang
predict (``Cohort.predict_rows``). Unset (the default), no queue object
exists and every forecast takes the immediate per-record predict path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from omldm_tpu_torch.api.data import DataInstance, Prediction
from omldm_tpu_torch.utils import clock as uclock

DEFAULT_MAX_BATCH = 64
DEFAULT_MAX_DELAY_MS = 5.0
DEFAULT_STALE_CHUNKS = 4
STALENESS_MODES = ("exact", "relaxed")

# bounded latency-sample ring per net: percentiles summarize the most
# recent window instead of growing with the stream
LATENCY_RING_CAP = 8192


@dataclasses.dataclass
class ServingConfig:
    """Parsed ``trainingConfiguration.serving`` knobs for one pipeline."""

    max_batch: int = DEFAULT_MAX_BATCH
    max_delay_ms: float = DEFAULT_MAX_DELAY_MS
    staleness: str = "exact"
    stale_chunks: int = DEFAULT_STALE_CHUNKS


def _parse_spec_str(spec: str) -> dict:
    """``"maxBatch=64,maxDelayMs=5,staleness=relaxed"`` -> dict; the bare
    mode names ``"on"``/``"exact"``/``"relaxed"`` select defaults."""
    spec = spec.strip()
    if spec.lower() in ("on", "exact"):
        return {}
    if spec.lower() == "relaxed":
        return {"staleness": "relaxed"}
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad serving spec entry {part!r} (want k=v)")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def parse_serving_spec(spec) -> Optional[ServingConfig]:
    """dict / spec-string / True -> ServingConfig; None / False / "" ->
    None (unarmed). Raises ValueError on unknown staleness or non-positive
    sizes — callers at the control gate turn that into a request drop."""
    if spec is None or spec is False or spec == "":
        return None
    if spec is True:
        spec = {}
    if isinstance(spec, str):
        spec = _parse_spec_str(spec)
    if not isinstance(spec, dict):
        raise ValueError(f"serving spec must be a table, got {type(spec).__name__}")
    unknown = set(spec) - {"maxBatch", "maxDelayMs", "staleness", "staleChunks"}
    if unknown:
        # a misspelled knob silently running with defaults is exactly the
        # misconfiguration the control gate exists to catch
        raise ValueError(f"unknown serving knob(s): {sorted(unknown)}")
    cfg = ServingConfig(
        max_batch=int(spec.get("maxBatch", DEFAULT_MAX_BATCH)),
        max_delay_ms=float(spec.get("maxDelayMs", DEFAULT_MAX_DELAY_MS)),
        staleness=str(spec.get("staleness", "exact")).lower(),
        stale_chunks=int(spec.get("staleChunks", DEFAULT_STALE_CHUNKS)),
    )
    if cfg.staleness not in STALENESS_MODES:
        raise ValueError(
            f"serving.staleness must be one of {STALENESS_MODES}, "
            f"got {cfg.staleness!r}"
        )
    if cfg.max_batch < 1:
        raise ValueError("serving.maxBatch must be >= 1")
    if cfg.max_delay_ms < 0:
        raise ValueError("serving.maxDelayMs must be >= 0")
    if cfg.stale_chunks < 0:
        raise ValueError("serving.staleChunks must be >= 0")
    return cfg


def serving_config(tc, job_spec: str = "") -> Optional[ServingConfig]:
    """The pipeline's serving config: ``trainingConfiguration.serving``
    wins (including an explicit False = opt out of the job default);
    otherwise the job-wide ``JobConfig.serving`` spec string applies.
    None = unarmed, the exact pre-plane per-record serving path."""
    extra = getattr(tc, "extra", None) or {}
    if "serving" in extra:
        return parse_serving_spec(extra["serving"])
    return parse_serving_spec(job_spec or "")


def validate_serving(tc) -> Optional[str]:
    """Control-gate twin of :func:`serving_config`: the error string for an
    undeployable serving table, or None. Mirrors the codec/sparse gates —
    a bad request must drop at admission, not raise at SpokeNet
    construction and kill the job."""
    try:
        serving_config(tc)
    except (ValueError, TypeError) as exc:
        return str(exc)
    return None


class ServeStats:
    """Per-net serving telemetry: served count + a bounded ring of
    enqueue->emit latencies (ms). Populated by BOTH routes — the batched
    plane and the immediate per-record path — so the Statistics fields
    compare modes on equal footing."""

    __slots__ = ("count", "_ring", "_n", "_i")

    def __init__(self, cap: int = LATENCY_RING_CAP):
        self.count = 0
        self._ring = np.zeros((cap,), np.float64)
        self._n = 0
        self._i = 0

    def note(self, latency_ms: float) -> None:
        self.count += 1
        self._ring[self._i] = latency_ms
        self._i = (self._i + 1) % self._ring.shape[0]
        self._n = min(self._n + 1, self._ring.shape[0])

    def note_many(self, latencies_ms: np.ndarray) -> None:
        """Vectorized ring write for one flush's worth of latencies — the
        batched emission path must not pay a Python call per row."""
        k = int(latencies_ms.shape[0])
        cap = self._ring.shape[0]
        self.count += k
        if k >= cap:
            self._ring[:] = latencies_ms[-cap:]
            self._i = 0
            self._n = cap
            return
        end = self._i + k
        if end <= cap:
            self._ring[self._i : end] = latencies_ms
        else:
            split = cap - self._i
            self._ring[self._i :] = latencies_ms[:split]
            self._ring[: end - cap] = latencies_ms[split:]
        self._i = end % cap
        self._n = min(self._n + k, cap)

    def percentiles(self) -> Tuple[float, float, float]:
        """(p50, p99, p999) ms over the retained window; zeros if empty."""
        if self._n == 0:
            return 0.0, 0.0, 0.0
        window = self._ring[: self._n]
        p = np.percentile(window, (50.0, 99.0, 99.9))
        return float(p[0]), float(p[1]), float(p[2])

    def reset(self) -> None:
        """Drop the folded-out counters (percentile window retained: a
        later fold summarizes the stream so far, matching how scores
        report latest-state rather than per-interval)."""
        self.count = 0


class ServeQueue:
    """One net's pending forecasts: FIFO entries, the total queued row
    count, the oldest enqueue time (deadline clock), and the
    model-staleness chunk count (relaxed mode).

    Entries are ``(inst, x, t_enqueue)`` — ``inst`` may be None for
    packed-route rows, in which case ``x`` is the adapted dense row (or,
    from the bulk span-admission path, a whole ``[k, dim]`` row BLOCK
    counting k rows) and the DataInstances materialize at emit (bitwise
    the per-record payload). ``n_rows`` is the row-accounted length the
    maxBatch fill trigger compares."""

    __slots__ = ("entries", "n_rows", "t_oldest", "chunks")

    def __init__(self):
        self.entries: List[Tuple[Optional[DataInstance], Any, float]] = []
        self.n_rows = 0
        self.t_oldest = 0.0
        self.chunks = 0


def _entry_rows(x) -> int:
    """Row count of one queue entry's payload: a dense [k, dim] block
    counts k, anything else (dense row, sparse pair) counts 1."""
    if type(x) is np.ndarray and x.ndim == 2:
        return x.shape[0]
    return 1


def _limits(net) -> ServingConfig:
    """The serving limits in force for ``net``: its static config, or the
    overload controller's degraded variant while its spoke is under
    pressure (``SpokeNet.serving_limits``). A net without the accessor
    gets the static config."""
    get = getattr(net, "serving_limits", None)
    return get() if get is not None else net.serving


class ServingPlane:
    """Per-spoke queue manager: admission, flush triggers, batched
    emission, latency accounting. One instance per Spoke, created when the
    first serving-armed net deploys."""

    def __init__(
        self,
        emit_prediction: Callable[[Prediction], None],
        clock: Callable[[], float] = uclock.PERF,
        emit_predictions: Optional[Callable[[List[Prediction]], None]] = None,
        timer=None,
    ):
        self._emit = emit_prediction
        # bulk sink hand-off (one call per flush instead of one per
        # prediction) when the hosting runtime provides it
        self._emit_many = emit_predictions
        self._clock = clock
        # serving-launch StepTimer (Spoke.serve_timer): flush predict
        # dispatches time here
        self._timer = timer
        # nets with a non-empty queue, keyed by network id (insertion
        # order = first-enqueue order, the cross-net emission order)
        self._pending: Dict[int, Any] = {}
        # set by admit when some queue reached maxBatch; the spoke checks
        # it at record boundaries (maybe_fill_flush)
        self._fill = False

    def queued(self) -> int:
        """Total forecast rows pending across every net's queue (the same
        contract as Prefetcher.queued())."""
        return sum(n.serve_queue.n_rows for n in self._pending.values())

    # --- admission -------------------------------------------------------

    def admit(self, net, inst: Optional[DataInstance], x) -> None:
        """Queue one forecast for ``net`` (which must be serving-armed)."""
        q = net.serve_queue
        now = self._clock()
        if not q.entries:
            q.t_oldest = now
            q.chunks = 0
            self._pending[net.request.id] = net
        q.entries.append((inst, x, now))
        q.n_rows += 1
        # the overload plane only widens a net's limits (overload.widen >=
        # 1): a queue short of its static maxBatch needs no lookup of the
        # limits in force
        if q.n_rows >= net.serving.max_batch and q.n_rows >= _limits(net).max_batch:
            self._fill = True

    def admit_rows(self, net, rows: np.ndarray, now: float) -> None:
        """Bulk admission for the packed fast path: ONE queue entry for a
        whole ``[k, dim]`` span of forecast rows, with one shared enqueue
        clock (``now`` — stamped once per span by the caller). The span
        array is aliased, not copied; DataInstances materialize at
        emission."""
        if rows.shape[0] == 0:
            return
        q = net.serve_queue
        if not q.entries:
            q.t_oldest = now
            q.chunks = 0
            self._pending[net.request.id] = net
        q.entries.append((None, rows, now))
        q.n_rows += rows.shape[0]
        if q.n_rows >= _limits(net).max_batch:
            self._fill = True

    # --- flush triggers --------------------------------------------------

    def maybe_fill_flush(self) -> None:
        """Record-boundary fill check: flush every group holding a queue
        at/over its maxBatch. Deferred to the boundary (not done at admit)
        so every member of a cohort has admitted the same stream position
        before the gang launch."""
        if not self._fill:
            return
        self._fill = False
        for net in list(self._pending.values()):
            q = net.serve_queue
            if q.entries and q.n_rows >= _limits(net).max_batch:
                self.flush_group(self._group(net))

    def poll(self, now: Optional[float] = None) -> None:
        """Deadline check: flush queues whose oldest entry aged past
        maxDelayMs. Called at event boundaries and from the live loop's
        silence check."""
        if not self._pending:
            return
        now = self._clock() if now is None else now
        for net in list(self._pending.values()):
            q = net.serve_queue
            if not q.entries:
                continue
            # as in admit: the static maxDelayMs bounds the one in force
            # from below, so a younger queue skips the lookup
            age_ms = (now - q.t_oldest) * 1000.0
            if age_ms >= net.serving.max_delay_ms and age_ms >= _limits(net).max_delay_ms:
                self.flush_group(self._group(net))

    def fence(self, net, chunks: int = 1) -> None:
        """``net``'s model is about to change (a fit is about to stage or
        dispatch, a hub payload is about to be delivered). Exact mode:
        serve the queue NOW, with the pre-change params — this is the
        bit-identity trigger. Relaxed mode: let up to ``staleChunks``
        such changes pass before flushing.

        The flush takes the whole cohort group: a sibling's non-empty queue
        means (by the fence rule) its model has not changed since its
        oldest enqueue, so serving it early is what the per-record path
        would give -- and when cohort members fence in lockstep (the gang
        fit loop), the first member's fence serves every queue in ONE
        predict launch instead of C."""
        q = net.serve_queue
        if not q.entries:
            return
        cfg = _limits(net)
        if cfg.staleness == "exact" or q.chunks >= cfg.stale_chunks:
            self.flush_group(self._group(net))
        else:
            q.chunks += chunks

    def flush_net(self, net) -> None:
        """Serve one net's queue alone -- the flush for Delete and query
        responses, where exactly one net must drain."""
        if net.serve_queue.entries:
            self.flush_group([net])

    def flush_all(self) -> None:
        """Terminate barrier: serve everything still queued."""
        while self._pending:
            net = next(iter(self._pending.values()))
            self.flush_group(self._group(net))

    # --- flush execution -------------------------------------------------

    def take_queue(self, net) -> Tuple[List[tuple], int]:
        """Remove and return one net's pending entries unserved: the
        overload controller's CRITICAL shed takes an over-limit tenant's
        queue here and answers each entry with a reason-coded dead letter
        instead of a prediction."""
        q = net.serve_queue
        entries, q.entries = q.entries, []
        n_rows, q.n_rows = q.n_rows, 0
        q.chunks = 0
        self._pending.pop(net.request.id, None)
        return entries, n_rows

    def _group(self, net) -> List[Any]:
        """The gang-flush unit: every pending net attached to the same
        cohort (their queues fill in lockstep), or the net alone."""
        cohort = getattr(net.pipeline, "_cohort", None)
        if cohort is None:
            return [net]
        return [
            n for n in self._pending.values()
            if getattr(n.pipeline, "_cohort", None) is cohort
        ] or [net]

    def flush_group(self, nets: List[Any]) -> None:
        """ONE padded predict launch for the gang-eligible members of a
        cohort group (``Cohort.predict_rows`` over ``[C, B]`` rows), one
        batched solo launch for each other net; emission is FIFO a net."""
        gang: List[Tuple[Any, List[tuple], int]] = []
        solo: List[Tuple[Any, List[tuple], int]] = []
        cohort = None
        for net in nets:
            q = net.serve_queue
            if not q.entries:
                continue
            entries, q.entries = q.entries, []
            n_rows, q.n_rows = q.n_rows, 0
            q.chunks = 0
            self._pending.pop(net.request.id, None)
            if net.gang_predict_ok():
                cohort = net.pipeline._cohort
                gang.append((net, entries, n_rows))
            else:
                solo.append((net, entries, n_rows))
        if len(gang) == 1:
            # a lone member gains nothing from the stacked predict
            solo.append(gang.pop())
        if gang:
            width = max(n for _, _, n in gang)
            rows = []
            for net, entries, _n in gang:
                xb = net.predict_pad(width)
                self._fill_pad(xb, entries)
                rows.append((net.pipeline._slot, xb))
            preds = cohort.predict_rows(rows)
            for (net, entries, n_rows), (slot, _) in zip(gang, rows):
                self._emit_entries(net, entries, n_rows, preds[slot])
        for net, entries, n_rows in solo:
            self._serve_solo(net, entries, n_rows)

    @staticmethod
    def _fill_pad(xb: np.ndarray, entries: List[tuple]) -> None:
        pos = 0
        for _inst, x, _t0 in entries:
            k = _entry_rows(x)
            if k == 1:
                xb[pos] = x
            else:
                xb[pos : pos + k] = x
            pos += k

    def _serve_solo(self, net, entries: List[tuple], n_rows: int) -> None:
        """One padded predict launch over a single net's queue, through the
        same ``node.on_forecast_batch`` boundary the per-record path uses
        (protocol overrides keep working; only the batch is wider)."""
        if net.sparse:
            ib, vb = net.predict_pad(n_rows)
            for j, (_inst, x, _t0) in enumerate(entries):
                ib[j], vb[j] = x
            xb = (ib, vb)
        else:
            xb = net.predict_pad(n_rows)
            self._fill_pad(xb, entries)
        cohort = getattr(net.pipeline, "_cohort", None)
        if cohort is not None:
            # launch staged gang fits OUTSIDE the serve timer
            cohort.launch()
        if self._timer is not None:
            with self._timer:
                preds = net.node.on_forecast_batch(xb)
        else:
            preds = net.node.on_forecast_batch(xb)
        self._emit_entries(net, entries, n_rows, preds)

    def _emit_entries(
        self, net, entries: List[tuple], n_rows: int, preds
    ) -> None:
        """FIFO emission of one flushed queue. Batch-shaped work (value
        extraction, latency ring writes, the sink hand-off) runs in
        vectorized/bulk calls; packed-route feature payloads stay numpy
        row views (to_dict materializes the identical JSON lazily) — the
        remaining per-row Python (one DataInstance + Prediction per
        served forecast, the output contract) is the plane's floor."""
        now = self._clock()
        nid = net.request.id
        # python-float prediction values in one conversion (bitwise the
        # per-record path's float(preds[j]))
        vals = np.asarray(preds).reshape(len(preds), -1)[:n_rows, 0].tolist()
        out: List[Prediction] = []
        add = out.append
        payload = DataInstance.forecast_payload
        vi = 0
        t0s: List[float] = []
        counts: List[int] = []
        for inst, x, t0 in entries:
            if inst is not None:
                add(Prediction(nid, inst, vals[vi]))
                vi += 1
                t0s.append(t0)
                counts.append(1)
                continue
            if type(x) is np.ndarray and x.ndim == 2:
                # span block: one queue entry, one prediction per row
                for row in x:
                    add(Prediction(nid, payload(row), vals[vi]))
                    vi += 1
                t0s.append(t0)
                counts.append(x.shape[0])
            else:
                add(Prediction(nid, payload(x), vals[vi]))
                vi += 1
                t0s.append(t0)
                counts.append(1)
        if self._emit_many is not None:
            self._emit_many(out)
        else:
            emit = self._emit
            for p in out:
                emit(p)
        lats = (now - np.repeat(
            np.asarray(t0s, np.float64), np.asarray(counts)
        )) * 1000.0
        net.serve_stats.note_many(lats)
