"""Dead-letter sink: quarantine for malformed / rejected stream input.

Counterpart of ``omldm_tpu/runtime/deadletter.py``. Every rejected record
or request is kept in a bounded in-memory ring with a reason code, appended
to a JSONL file when ``path`` is set, and handed to ``publish`` when one is
given (the JAX package's Kafka route wires a ``deadLetters`` topic there;
the port has no Kafka route yet). Quarantine never raises: a failing file
or publisher must not take down the stream, so a refused write counts in
``write_errors`` and a failing publisher in ``publish_errors`` (and is
dropped). The overload plane's ``shed_overload`` and ``throttled`` entries
carry the tenant and its queue depth as extra fields
(``quarantine(extra=...)``). With the flight recorder armed the job sets
``event_ring`` to its journal, and each entry carries the journal's
high-water ``eventId``, pointing at the events that explain it.
"""

from __future__ import annotations

import collections
import json
import logging
from typing import Any, Callable, Deque, Dict, Optional

# cap on the raw payload text preserved per entry
MAX_PAYLOAD_CHARS = 4096

log = logging.getLogger(__name__)


class DeadLetterSink:
    """Bounded quarantine for rejected stream input, with reason codes."""

    def __init__(self, path: str = "", cap: int = 10_000,
                 publish: Optional[Callable[[dict], None]] = None,
                 request_stream: str = "requests"):
        self.path = path or ""
        #: optional external publisher of every entry
        self.publish = publish
        self.publish_errors = 0
        #: the flight-recorder journal (runtime/events.EventJournal) or None
        self.event_ring = None
        self.entries: Deque[dict] = collections.deque(maxlen=max(int(cap), 1))
        self._request_stream = request_stream
        self.record_count = 0
        self.request_count = 0
        self.by_reason: Dict[str, int] = {}
        self._fh = None
        self._file_failed = False
        self.write_errors = 0

    def quarantine(self, stream: str, payload: Any, reason: str,
                   detail: Optional[str] = None,
                   extra: Optional[Dict[str, Any]] = None) -> dict:
        """Record one rejected input and return its entry. Never raises.
        ``extra`` merges more machine-readable fields into the entry (the
        keys stream, reason, payload and detail are never overwritten)."""
        if isinstance(payload, bytes):
            payload = payload.decode("utf-8", errors="replace")
        elif not isinstance(payload, str):
            try:
                payload = json.dumps(payload, default=str)
            except (TypeError, ValueError):
                payload = str(payload)
        entry = {"stream": stream, "reason": reason,
                 "payload": payload[:MAX_PAYLOAD_CHARS]}
        if detail:
            entry["detail"] = detail
        if extra:
            for k, v in extra.items():
                entry.setdefault(k, v)
        if self.event_ring is not None:
            # 0: quarantined before any decision was recorded
            entry.setdefault("eventId", self.event_ring.high_water)
        self.entries.append(entry)
        if stream == self._request_stream:
            self.request_count += 1
            log.warning("rejected request: %s", detail or reason)
        else:
            self.record_count += 1
        self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
        self._write(entry)
        if self.publish is not None:
            try:
                self.publish(entry)
            except Exception as exc:  # a dead topic must not kill the job
                self.publish_errors += 1
                self.publish = None
                log.warning("dead-letter publish failed (%s); publishing stops", exc)
        return entry

    @property
    def total(self) -> int:
        return self.record_count + self.request_count

    def _write(self, entry: dict) -> None:
        if not self.path or self._file_failed:
            return
        try:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()
        except OSError as exc:
            # degrade to in-memory only, once, loudly
            self.write_errors += 1
            self._file_failed = True
            log.warning("dead-letter file %r unwritable (%s); quarantine "
                        "continues in memory only", self.path, exc)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
