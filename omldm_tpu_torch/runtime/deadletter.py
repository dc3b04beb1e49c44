"""Dead-letter sink: quarantine for malformed / rejected stream input.

Counterpart of ``omldm_tpu/runtime/deadletter.py`` without the external
publisher and the flight-recorder cross-reference (neither is ported).
Every rejected record or request is kept in a bounded in-memory ring with a
reason code and, when ``path`` is set, appended to a JSONL file. Quarantine
never raises: a failing dead-letter file must not take down the stream. The
overload plane's ``shed_overload`` and ``throttled`` entries carry the
tenant and its queue depth as extra fields (``quarantine(extra=...)``).
"""

from __future__ import annotations

import collections
import json
import logging
from typing import Any, Deque, Dict, Optional

# cap on the raw payload text preserved per entry
MAX_PAYLOAD_CHARS = 4096

log = logging.getLogger(__name__)


class DeadLetterSink:
    """Bounded quarantine for rejected stream input, with reason codes."""

    def __init__(self, path: str = "", cap: int = 10_000,
                 request_stream: str = "requests"):
        self.path = path or ""
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
        self.entries.append(entry)
        if stream == self._request_stream:
            self.request_count += 1
            log.warning("rejected request: %s", detail or reason)
        else:
            self.record_count += 1
        self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
        self._write(entry)
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
