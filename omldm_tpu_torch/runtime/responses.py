"""Query-response re-assembly across workers.

Reference counterpart: ``ResponseConstructor`` (ResponseConstructor.scala:13-69)
— collects one ``QueryResponse`` fragment per worker (keyed by responseId),
then merges: keeps the last non-null learner/preprocessors/protocol, sums
``dataFitted``, averages loss/cumulativeLoss/score over parallelism.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from omldm_tpu_torch.api.responses import QueryResponse


class ResponseMerger:
    """Assembles per-worker, per-bucket fragments into one response.

    Each worker emits ``num_buckets`` fragments (model parameters split into
    <=max_param_bucket_size chunks, FlinkNetwork.scala:48-149,151-240); the
    job registers how many workers will answer; the bucket count is learned
    from the fragments themselves. Metrics ride on bucket-0 fragments only
    and are averaged over workers; parameter buckets are re-assembled from
    one worker's fragments (post-sync replicas agree)."""

    def __init__(self, emit: Callable[[QueryResponse], None]):
        self._emit = emit
        self._pending: Dict[int, List[QueryResponse]] = {}
        self._expected_workers: Dict[int, int] = {}

    def expect(self, response_id: int, n_workers: int) -> None:
        self._expected_workers[response_id] = n_workers

    def add_fragment(self, fragment: QueryResponse) -> Optional[QueryResponse]:
        rid = fragment.response_id
        frags = self._pending.setdefault(rid, [])
        frags.append(fragment)
        expected = self._expected_workers.get(rid, 1) * max(
            fragment.num_buckets, 1
        )
        if len(frags) < expected:
            return None
        del self._pending[rid]
        self._expected_workers.pop(rid, None)
        merged = self._merge(frags)
        self._emit(merged)
        return merged

    @staticmethod
    def _merge(frags: List[QueryResponse]) -> QueryResponse:
        out = QueryResponse(
            response_id=frags[0].response_id,
            mlp_id=frags[0].mlp_id,
            num_buckets=frags[0].num_buckets,
        )
        heads = [f for f in frags if f.bucket == 0]
        for f in heads:
            if f.learner is not None:
                out.learner = dict(f.learner)
            if f.preprocessors is not None:
                out.preprocessors = f.preprocessors
            if f.protocol is not None:
                out.protocol = f.protocol
            out.data_fitted += f.data_fitted
            if f.lifecycle is not None:
                # registry views are per-worker replicas of one
                # count-clocked state machine: keep the last non-null one
                # (the learner and protocol rule), never an average
                out.lifecycle = dict(f.lifecycle)
            if f.events is not None:
                # event-ring tails come from the one job-level journal
                # (every fragment carries the same view): keep the last
                # non-null one, the lifecycle rule
                out.events = list(f.events)
        n = max(len(heads), 1)
        out.loss = sum((f.loss or 0.0) for f in heads) / n
        out.cumulative_loss = sum((f.cumulative_loss or 0.0) for f in heads) / n
        out.score = sum((f.score or 0.0) for f in heads) / n
        # re-assemble parameter buckets from ONE worker's fragment set —
        # grouping by source worker, since async-protocol replicas may
        # legitimately differ between syncs and interleaving chunks from
        # different replicas would fabricate a model no worker ever held
        by_source: Dict[Any, Dict[int, list]] = {}
        for f in frags:
            chunk = (f.learner or {}).get("parameters", {}).get("bucketValues")
            if chunk is not None:
                src = by_source.setdefault(f.source_worker, {})
                src.setdefault(f.bucket, chunk)
        buckets: Dict[int, list] = {}
        for src in by_source.values():
            if len(src) >= max(out.num_buckets, 1):
                buckets = src
                break
        if not buckets and by_source:
            buckets = max(by_source.values(), key=len)
        if buckets and out.learner is not None:
            values: list = []
            for i in sorted(buckets):
                values.extend(buckets[i])
            out.learner["parameters"] = {"values": values}
        return out
