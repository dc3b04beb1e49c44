"""Functional Geometric Monitoring (FGM): the two-phase safe-zone protocol.

Counterpart of ``omldm_tpu/protocols/fgm.py`` (Samoladas & Garofalakis's
functional geometric monitoring). The coordinator monitors the sum of a
convex safe function

    phi_i = ||w_i - e||^2 - T^2        (safe while  psi = sum_i phi_i < 0)

in two phases:

1. increment counting -- each round/subround has a quantum
   ``theta = -psi_0 / (2n)``; workers send integer counter increments
   ``c_i = floor((phi_i - phi_i^0) / theta)`` as they drift; the
   coordinator acts only when the summed counter passes ``n``;
2. subround poll -- the coordinator polls the exact ``phi_i``; if ``psi``
   is still safe it starts a subround with a smaller quantum, otherwise it
   collects every model, averages, and begins a new round.

The workers compute ``phi_i`` on the host from the flat params read back at
each sync point, as the JAX package does. Config extras: ``threshold``
(safe radius T, default 0.5).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from omldm_tpu_torch.protocols.base import HubNode
from omldm_tpu_torch.protocols.common import SyncingWorker
from omldm_tpu_torch.protocols.gm import _account
from omldm_tpu_torch.runtime.messages import OP_PULL, OP_PUSH, OP_UPDATE, OP_ZETA


class FGMWorker(SyncingWorker):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.threshold = float(self.config.extra.get("threshold", 0.5))
        self._estimate: Optional[np.ndarray] = None
        self._theta: float = self.threshold**2 / 2.0
        self._phi0: float = -(self.threshold**2)
        self._counter = 0

    def on_start(self) -> None:
        self._estimate = self.get_flat()

    def on_model_seeded(self) -> None:
        self._estimate = self.get_flat()

    def _phi(self) -> float:
        current = self.get_flat()
        est = self._estimate if self._estimate is not None else np.zeros_like(current)
        return float(np.sum((current - est) ** 2) - self.threshold**2)

    def on_sync_point(self) -> None:
        if self._theta <= 0:
            return
        c_new = int(np.floor((self._phi() - self._phi0) / self._theta))
        if c_new > self._counter:
            inc = c_new - self._counter
            self._counter = c_new
            self.send(OP_ZETA, {"inc": inc, **self.piggyback()}, 0)

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        if op == OP_ZETA and payload.get("poll"):
            self.send(OP_ZETA, {"phi": self._phi()}, 0)
        elif op == OP_PULL:
            self.send(OP_PUSH, {"params": self.get_flat(), **self.piggyback()}, 0)
        elif op == OP_UPDATE:
            if payload.get("params") is not None:
                self.set_flat(payload["params"])
                self._estimate = payload["params"]
                self._phi0 = -(self.threshold**2)
            else:
                # new subround: a tighter quantum, counters restarted from
                # the polled phi
                self._phi0 = self._phi()
            self._theta = payload["theta"]
            self._counter = 0

    def channel_resynced(self, payload: dict, hub_id: int) -> None:
        # a resync is a fresh round estimate: re-anchor the safe zone and
        # restart counting at the round quantum, as a round's release would
        params = payload.get("params")
        if params is not None:
            self._estimate = np.asarray(params)
            self._phi0 = -(self.threshold**2)
            self._theta = float(payload.get("theta", self.threshold**2 / 2.0))
            self._counter = 0
        super().channel_resynced(payload, hub_id)

    def final_push(self) -> None:
        self.send(OP_PUSH, {"params": self.get_flat(), **self.piggyback()}, 0)


class FGMParameterServer(HubNode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.threshold = float(self.config.extra.get("threshold", 0.5))
        self._global_counter = 0
        self._polling = False
        self._phis: Dict[int, float] = {}
        self._collecting = False
        self._collected: Dict[int, np.ndarray] = {}
        self._fitted_seen: Dict[int, int] = {}
        self.global_params: Optional[np.ndarray] = None
        self.rounds = 0
        self.subrounds = 0

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op == OP_ZETA and "inc" in payload:
            _account(self, self._fitted_seen, worker_id, payload)
            self._global_counter += payload["inc"]
            if self._global_counter > self.n_workers and not (
                self._polling or self._collecting
            ):
                self._polling = True
                self._phis.clear()
                self.count_shipped({"poll": True}, n_dest=self.n_workers)
                self.broadcast(OP_ZETA, {"poll": True})
        elif op == OP_ZETA and "phi" in payload:
            self.count_received(payload)
            self._phis[worker_id] = payload["phi"]
            self._maybe_finish_poll()
        elif op == OP_PUSH:
            _account(self, self._fitted_seen, worker_id, payload)
            self._collected[worker_id] = payload["params"]
            if len(self._collected) >= self.round_target():
                self._finish_round()

    def _maybe_finish_poll(self) -> None:
        if self._polling and len(self._phis) >= self.round_target():
            self._polling = False
            psi = sum(self._phis.values())
            if psi >= 0:
                # safe zone breached: a full synchronization round
                self._collecting = True
                self._collected.clear()
                self.count_shipped({"pull": True}, n_dest=self.n_workers)
                self.broadcast(OP_PULL, {})
            else:
                # still safe: a new subround with a tighter quantum
                self.subrounds += 1
                self._global_counter = 0
                theta = -psi / (2.0 * self.round_target())
                self.note_round_release()
                self.count_shipped({"theta": theta}, n_dest=self.n_workers)
                self.broadcast(OP_UPDATE, {"params": None, "theta": theta})

    def worker_retired(self, worker_id: int) -> None:
        self._phis.pop(worker_id, None)
        self._collected.pop(worker_id, None)

    def _barrier_recheck(self) -> None:
        self._maybe_finish_poll()
        if self._collecting and len(self._collected) >= self.round_target():
            self._finish_round()

    def set_parallelism(self, n_workers: int) -> None:
        """Pruning retired workers may complete a pending poll or
        collection: both barriers are re-checked here."""
        super().set_parallelism(n_workers)
        self._prune_retired(self._phis, n_workers)
        self._prune_retired(self._collected, n_workers)
        self._barrier_recheck()

    def _finish_round(self) -> None:
        self.global_params = np.stack(list(self._collected.values())).mean(axis=0)
        self._collected.clear()
        self._collecting = False
        self._global_counter = 0
        self.rounds += 1
        self.note_round_release()
        payload = {"params": self.global_params, "theta": self.threshold**2 / 2.0}
        self.count_shipped(payload, n_dest=self.n_workers)
        self.broadcast(OP_UPDATE, payload)

    def resync_payload(self) -> Optional[dict]:
        if self.global_params is None:
            return None
        return {"params": self.global_params, "theta": self.threshold**2 / 2.0}
