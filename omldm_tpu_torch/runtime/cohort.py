"""Cohort execution engine: multi-tenant co-hosting with gang dispatch.

Counterpart of ``omldm_tpu/runtime/cohort.py``. A spoke hosts one
``MLPipeline`` per network; with M live same-spec pipelines it would pay M
separate step launch sequences a micro-batch cycle. This module groups
pipelines with equal ``MLPipeline.cache_key`` (learner spec, preprocessor
chain, dim, per-record mode) into **cohorts**, stacks their state trees
along a leading member axis ``[C, ...]``, and runs fit, predict and flat
parameters for the whole cohort as one gang step:

- **Staged gang fit.** ``MLPipeline.fit`` on an attached pipeline stages
  its micro-batch in the cohort's ``[capacity, T, B, ...]`` host buffers;
  the spoke's gang barrier (end of a record or a packed block) launches
  every staged batch of the cohort at once. Capacity and the staging depth
  T are powers of two; churn reuses freed slots. A step whose mask is all
  zero (T padding, idle slots) keeps its member's state bitwise.
- **Member iteration**, in two forms of the SAME ``_fit_impl`` the solo
  pipeline runs, chosen by the device:
  - ``map``: a loop over the staged members on views of the stacked state,
    on the CPU; its answers equal the solo path's bitwise.
  - ``vmap``: ``torch.func.vmap`` over the member axis, on the card (as
    the JAX package vmaps off the CPU). Every op of the step runs
    once for all members; PA's per-record scan goes through the
    ``pa_scan`` custom op, whose vmap rule makes it ONE batched kernel
    launch (``ops.pa_scan.pa_scan_update_batched``). Batched reductions
    may round otherwise than the solo ones.
- **Gang flat params.** Protocol sync points read and write flat parameter
  vectors; a cohort computes the whole ``[capacity, P]`` flat matrix at
  once (cached, rows kept warm on writes) and scatters written rows back in
  one batched write before the next launch.
- **Deferred protocol actions.** A sync point that would force a launch
  mid-gang (the flat read after the round's fit) registers through
  ``MLPipeline.defer_after_launch`` and runs right after the gang launch.
- **Gang hub averaging.** :class:`GangAverager` lets same-protocol members'
  parameter-server shards stage their completed round matrices and
  average them in one stacked ``[M, W, P]`` numpy reduction at the job's
  event barrier (``SynchronousParameterServer``).

``JobConfig.cohort`` arms it: ``"off"``, ``"auto"`` (cohorts form once
``cohort_min`` same-spec pipelines are live on a spoke, the default) or
``"on"`` (from one pipeline). The JAX package's ``cohort_impl`` is
accepted and ignored: the device decides between ``map`` and ``vmap``.

- **Guarded cohorts.** Pipelines with a guard gang only with guarded
  ones (the guard is part of ``cache_key``). Their gang step also computes
  each member's parameter health after its steps (``param_health``,
  inside the same ``vmap``), and ``_note_health`` brings the ``[C]``
  vector to the host in one copy a gang step and notes each launched
  member's value on its guard. A member whose guard trips is evicted
  (``CohortEngine.retire``) before its rollback, so its recovery never
  rides a sibling's launch.

Not ported here: the tenant-axis device sharding (``cohort_shards`` > 1,
``shard_map`` over a ``tenants`` mesh axis) -- a ``cohort_shards`` that
resolves to one device is the single-device path and is admitted; more
than one card raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from omldm_tpu_torch.guard import gang_health_values
from omldm_tpu_torch.learners.registry import SINGLE_LEARNER_ONLY
from omldm_tpu_torch.models.transformer import tree_leaves, tree_unflatten
from omldm_tpu_torch.pipelines.pipeline import MLPipeline, _leaves, param_health, unravel_fn

# staged batches per member before a launch is forced: bounds the gang input
# [capacity, T, B, D] when a pipeline has no sync point for a while
MAX_STAGE_DEPTH = 32

#: gang fits launched (one a barrier with staged work), the steps they ran
#: (the sum of their staging depths) and gang predicts, in this process
gang_launches = 0
gang_steps = 0
gang_predicts = 0


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _tmap(fn, *trees):
    """``fn`` over the leaves of equally shaped state trees."""
    return tree_unflatten(trees[0], [fn(*ls) for ls in zip(*(tree_leaves(t) for t in trees))])


def resolve_cohort_shards(config, device) -> int:
    """The tenant-axis shard count ``config.cohort_shards`` asks for:
    ``off``/empty/<= 1 -> 1; ``auto`` -> the largest power of two <= the
    CUDA device count; an integer -> clamped to that count and floored to
    a power of two; an unknown spelling -> 1 (as in the JAX package). A CPU
    job has one device. More than one shard raises: the tenant mesh waits
    for the port's multi-device placement."""
    spec = str(getattr(config, "cohort_shards", "off") or "off").strip().lower()
    if spec in ("off", "none", "false", "0", "1", ""):
        return 1
    n_dev = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    if spec == "auto":
        want = n_dev
    else:
        try:
            want = int(spec)
        except ValueError:
            return 1
    want = min(max(want, 1), n_dev)
    n = 1
    while n * 2 <= want:
        n *= 2
    if n > 1:
        raise NotImplementedError(
            f"cohort_shards={config.cohort_shards!r} resolves to {n} devices: "
            "omldm_tpu_torch runs a cohort on one device"
        )
    return n


class _Steps:
    """The step functions of one cohort spec: MLPipeline's own ``_fit_impl``
    and ``_transform`` over the spec's stateless learner and preprocessors
    (the pipeline's state never enters)."""

    _fit_impl = MLPipeline._fit_impl
    _transform = MLPipeline._transform

    def __init__(self, pipeline: MLPipeline):
        self.learner = pipeline.learner
        self.preps = pipeline.preps
        self.per_record = pipeline.per_record

    def predict(self, st, x):
        return self.learner.predict(st["params"], self._transform(st["preps"], x))

    def member_fit(self, st, xs, ys, ms):
        """T steps of one member; a step whose mask is all zero keeps the
        state (the select discards the computed branch, NaN included)."""
        losses = []
        for t in range(xs.shape[0]):
            new, loss = self._fit_impl(st, xs[t], ys[t], ms[t])
            keep = ms[t].sum() > 0
            st = _tmap(lambda a, b: torch.where(keep, a, b), new, st)
            losses.append(loss)
        return st, torch.stack(losses)

    def member_fit_guarded(self, st, xs, ys, ms):
        """``member_fit`` and the health of the member's state after it (a
        kept state keeps its health)."""
        st, losses = self.member_fit(st, xs, ys, ms)
        return st, losses, param_health(st["params"])


class _LaunchResult:
    """One gang launch's ``[C, T]`` losses, brought to the host at most once
    (forcing the launch first if a statistics poll reads it early)."""

    __slots__ = ("_cohort", "_lazy", "_host")

    def __init__(self, cohort: "Cohort"):
        self._cohort: Optional[Cohort] = cohort
        self._lazy: Optional[torch.Tensor] = None
        self._host: Optional[torch.Tensor] = None

    def fulfill(self, losses: torch.Tensor) -> None:
        self._lazy = losses
        self._cohort = None

    def values(self) -> torch.Tensor:
        if self._host is None:
            if self._lazy is None:
                cohort, self._cohort = self._cohort, None
                if cohort is not None:
                    cohort.launch()
            self._host = self._lazy.cpu()
            self._lazy = None
        return self._host


class _StagedLoss:
    """Lazy loss of a staged fit: a scalar (a ``fit_many`` chain: a [T]
    vector), as lazy as the solo path's device tensors."""

    __slots__ = ("_res", "_slot", "_t0", "_t1")

    def __init__(self, res: _LaunchResult, slot: int, t0: int, t1: Optional[int] = None):
        self._res = res
        self._slot = slot
        self._t0 = t0
        self._t1 = t1

    def as_tensor(self) -> torch.Tensor:
        vals = self._res.values()
        if self._t1 is None:
            return vals[self._slot, self._t0]
        return vals[self._slot, self._t0:self._t1]

    def __float__(self) -> float:
        return float(self.as_tensor())

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.as_tensor().numpy(), dtype)


class Cohort:
    """Same-spec pipelines sharing one stacked state tree and gang steps.

    ``members[slot]`` is the attached pipeline or None; capacity is a power
    of two; churn reuses freed slots and only a full cohort doubles."""

    #: the tenant-axis shard count (one device: see the module docstring)
    n_shards = 1

    def __init__(self, pipeline: MLPipeline, use_vmap: bool, timer=None, serve_timer=None):
        self.key = pipeline.cache_key
        self.use_vmap = use_vmap
        self.device = pipeline.device
        self.timer = timer
        # gang predicts (serving flushes) time apart from the fit flushes
        self.serve_timer = serve_timer
        self._steps = _Steps(pipeline)
        # guarded pipelines gang with guarded ones only (cache_key)
        self.guarded = pipeline.guard is not None
        if use_vmap:
            self._vfit = torch.func.vmap(
                self._steps.member_fit_guarded if self.guarded else self._steps.member_fit)
            self._vpredict = torch.func.vmap(self._steps.predict)
        params = pipeline._state["params"]
        self._unravel = unravel_fn(params, self.device)
        self._flat_specs = [(t.shape, t.dtype) for t in _leaves(params)]
        self._flat_size = int(sum(np.prod(s, dtype=np.int64) for s, _ in self._flat_specs))
        self.capacity = 0
        self.members: List[Optional[MLPipeline]] = []
        self.n_active = 0
        self._free: List[int] = []
        self.stacked = None
        # host-side authoritative overrides, written back before every launch
        self._host_state: Dict[int, dict] = {}
        self._pending_flat: Dict[int, np.ndarray] = {}
        # staging: persistent [capacity, T, B, ...] host buffers written in
        # place at stage time; `_counts` is the staged depth a slot, and
        # only the staged mask region is zeroed again after a launch
        self._counts: Dict[int, int] = {}
        self._buf_x: Optional[np.ndarray] = None
        self._buf_y: Optional[np.ndarray] = None
        self._buf_m: Optional[np.ndarray] = None
        self._next_result: Optional[_LaunchResult] = None
        # deferred protocol actions (sync points), run right after a launch
        self._post: List[Tuple[int, Callable[[], None]]] = []
        self._post_slots: set = set()
        self._flat_cache: Optional[np.ndarray] = None
        self._in_launch = False
        # persistent gang-predict pads, keyed by a member's batch shape;
        # _pred_dirty holds the slots each pad last wrote
        self._pred_scratch: Dict[tuple, np.ndarray] = {}
        self._pred_dirty: Dict[tuple, List[int]] = {}
        self.attach(pipeline)

    # --- membership ------------------------------------------------------

    def _member_pull(self, slot: int) -> dict:
        """One member's state out of the stack, as tensors of its own."""
        return _tmap(lambda leaf: leaf[slot].clone(), self.stacked)

    def _write_member(self, slot: int, state) -> None:
        _tmap(lambda leaf, v: leaf[slot].copy_(v), self.stacked, state)

    def attach(self, pipeline: MLPipeline) -> int:
        """Adopt a pipeline: its state seeds a (reused or new) slot and its
        fit, predict and flat-parameter calls route through the cohort."""
        self.launch()
        if self.stacked is None:
            self.capacity = 1
            self.members = [pipeline]
            self.n_active = 1
            self._free = []
            self.stacked = _tmap(lambda leaf: leaf.unsqueeze(0).clone(), pipeline._state)
            slot = 0
        else:
            if not self._free:
                self._grow()
            slot = self._free.pop()
            self._write_member(slot, pipeline._state)
            self.members[slot] = pipeline
            self.n_active += 1
        pipeline._cohort = self
        pipeline._slot = slot
        pipeline._state = None
        self._flat_cache = None
        return slot

    def detach(self, pipeline: MLPipeline) -> None:
        """Release a member: its slot's state goes back to the pipeline and
        the slot to the free list."""
        self.launch()
        slot = pipeline._slot
        pipeline._state = self._member_pull(slot)  # the launch wrote every host write
        pipeline._cohort = None
        pipeline._slot = -1
        self.members[slot] = None
        self.n_active -= 1
        self._free.append(slot)
        self._free.sort(reverse=True)  # the lowest slot first

    def _grow(self) -> None:
        """Double the capacity; the new slots hold copies of the old rows,
        inert until attach seeds them. Only attach grows a cohort, right
        after a launch, so nothing staged carries a slot across."""
        old = self.capacity
        self.stacked = _tmap(lambda leaf: torch.cat([leaf, leaf], dim=0), self.stacked)
        self.members.extend([None] * old)
        self._free.extend(range(old * 2 - 1, old - 1, -1))
        self._free.sort(reverse=True)
        self.capacity = old * 2
        self._flat_cache = None

    def shard_placement(self) -> List[int]:
        """Active members a shard (one shard on one device)."""
        return [self.n_active]

    # --- staging -----------------------------------------------------------

    def has_staged(self, slot: int) -> bool:
        return slot in self._counts

    def has_deferred(self, slot: int) -> bool:
        return slot in self._post_slots

    def after_launch(self, slot: int, cb: Callable[[], None]) -> None:
        self._post.append((slot, cb))
        self._post_slots.add(slot)

    def _open_group(self) -> _LaunchResult:
        if self._next_result is None:
            self._next_result = _LaunchResult(self)
        return self._next_result

    def _stage_room(self, slot: int, x: np.ndarray, y: np.ndarray, m: np.ndarray,
                    need: int) -> int:
        """Room for ``need`` more staged steps on ``slot``; returns the
        slot's depth after any forced launch or reallocation."""
        if slot in self._post_slots:
            # a deferred sync point of this member must run (on the model
            # after the launch) before its next fit
            self.launch()
        n = self._counts.get(slot, 0)
        if n + need > MAX_STAGE_DEPTH:
            self.launch()
            n = 0
        buf = self._buf_x
        if (buf is None or buf.shape[0] != self.capacity or buf.shape[2:] != x.shape
                or buf.shape[1] < n + need):
            self._realloc_buffers(x, y, m, n + need)
            n = self._counts.get(slot, 0)  # a shape change launches
        return n

    def _realloc_buffers(self, x, y, m, depth: int) -> None:
        t_alloc = _pow2(max(depth, 4))
        new_x = np.zeros((self.capacity, t_alloc) + x.shape, np.float32)
        new_y = np.zeros((self.capacity, t_alloc) + y.shape, np.float32)
        new_m = np.zeros((self.capacity, t_alloc) + m.shape, np.float32)
        if self._counts and self._buf_x is not None:
            if self._buf_x.shape[2:] != x.shape:
                self.launch()
                self._counts = {}
            else:
                c = min(self._buf_x.shape[0], self.capacity)
                t = min(self._buf_x.shape[1], t_alloc)
                new_x[:c, :t] = self._buf_x[:c, :t]
                new_y[:c, :t] = self._buf_y[:c, :t]
                new_m[:c, :t] = self._buf_m[:c, :t]
        self._buf_x, self._buf_y, self._buf_m = new_x, new_y, new_m

    def stage_fit(self, slot: int, x, y, mask) -> _StagedLoss:
        x = np.asarray(x)
        y = np.asarray(y)
        m = np.asarray(mask)
        n = self._stage_room(slot, x, y, m, 1)
        res = self._open_group()
        self._buf_x[slot, n] = x
        self._buf_y[slot, n] = y
        self._buf_m[slot, n] = m
        self._counts[slot] = n + 1
        return _StagedLoss(res, slot, n)

    def stage_fit_many(self, slot: int, xs, ys, masks) -> _StagedLoss:
        xs = np.asarray(xs)
        ys = np.asarray(ys)
        ms = np.asarray(masks)
        depth = int(xs.shape[0])
        n = self._stage_room(slot, xs[0], ys[0], ms[0], depth)
        res = self._open_group()
        self._buf_x[slot, n:n + depth] = xs
        self._buf_y[slot, n:n + depth] = ys
        self._buf_m[slot, n:n + depth] = ms
        self._counts[slot] = n + depth
        return _StagedLoss(res, slot, n, n + depth)

    # --- launching -----------------------------------------------------------

    def launch(self) -> None:
        """Gang barrier: run every staged fit, then the deferred protocol
        actions (which may stage and launch more: a sync push whose round
        release drains blocked batches)."""
        if self._in_launch:
            self._run_staged()
            return
        self._in_launch = True
        try:
            while True:
                self._run_staged()
                if not self._post:
                    break
                post, self._post = self._post, []
                self._post_slots = set()
                for _slot, cb in post:
                    cb()
        finally:
            self._in_launch = False

    def _note_launch(self, slot: int) -> None:
        member = self.members[slot] if 0 <= slot < self.capacity else None
        if member is not None and member.on_launch is not None:
            member.on_launch()

    def _timed(self):
        return self.timer if self.timer is not None else contextlib.nullcontext()

    def _timed_serve(self):
        return self.serve_timer if self.serve_timer is not None else self._timed()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _map_fit(self, counts: Dict[int, int], t_pad: int):
        """The ``map`` gang fit: each staged member's steps on views of the
        stacked state, written back in place. A step whose host mask is all
        zero keeps the state, as the select of the ``vmap`` form does.
        Guarded: ``(losses, health [capacity])``, the health of each staged
        member after its steps."""
        losses = torch.zeros((self.capacity, t_pad), dtype=torch.float32, device=self.device)
        health = (torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
                  if self.guarded else None)
        steps = self._steps
        for slot in sorted(counts):
            xs = self._to_device(self._buf_x[slot, :counts[slot]])
            ys = self._to_device(self._buf_y[slot, :counts[slot]])
            ms_host = self._buf_m[slot, :counts[slot]]
            ms = self._to_device(ms_host)
            st = _tmap(lambda leaf: leaf[slot], self.stacked)
            for t in range(counts[slot]):
                new, loss = steps._fit_impl(st, xs[t], ys[t], ms[t])
                losses[slot, t] = loss
                if ms_host[t].any():
                    st = new
            self._write_member(slot, st)
            if health is not None:
                health[slot] = param_health(st["params"])
        return losses if health is None else (losses, health)

    def _run_staged(self) -> None:
        self._apply_host_writes()
        if not self._counts:
            return
        counts, self._counts = self._counts, {}
        result, self._next_result = self._next_result, None
        t_pad = _pow2(max(counts.values()))
        global gang_launches, gang_steps
        gang_launches += 1
        gang_steps += t_pad
        self._note_launch(min(counts))
        with self._timed():
            if not self.use_vmap:
                losses = self._map_fit(counts, t_pad)
            else:
                out = self._vfit(
                    self.stacked, self._to_device(self._buf_x[:, :t_pad]),
                    self._to_device(self._buf_y[:, :t_pad]),
                    self._to_device(self._buf_m[:, :t_pad]),
                )
                self.stacked, losses = out[0], out[1:] if self.guarded else out[1]
        # zero ONLY the staged mask region again: stale x/y rows under a
        # zero mask are inert
        for slot, n in counts.items():
            self._buf_m[slot, :n] = 0.0
        if self.guarded:
            losses = self._note_health(losses, counts)
        if result is not None:
            result.fulfill(losses)
        self._flat_cache = None

    def _note_health(self, gang_out, counts: Dict[int, int]) -> torch.Tensor:
        """Split a guarded gang step's ``(losses, health [C])``: the health
        vector comes to the host in ONE copy (C lazy scalars would cost a
        read each at the next guard check) and each launched member's value
        goes to its guard, counted as the fits it staged; returns the
        losses."""
        losses, health = gang_out
        vals = gang_health_values(health)
        for slot, n in counts.items():
            member = self.members[slot]
            if member is not None and member.guard is not None:
                member.guard.note(float(vals[slot]), fits=n)
        return losses

    def _apply_host_writes(self) -> None:
        """Write host-side authoritative state (checkouts, written flat
        rows) back into the stacked tree before the next step runs."""
        if self._host_state:
            for slot, st in self._host_state.items():
                self._write_member(slot, st)
            self._host_state.clear()
            self._flat_cache = None
        if self._pending_flat:
            slots = sorted(self._pending_flat)
            mat = self._to_device(np.stack([self._pending_flat[s] for s in slots]))
            idx = torch.tensor(slots, dtype=torch.long, device=self.device)
            out, pos = [], 0
            for shape, dtype in self._flat_specs:
                size = int(np.prod(shape, dtype=np.int64))
                out.append(mat[:, pos:pos + size].reshape(len(slots), *shape).to(dtype))
                pos += size
            params = self.stacked["params"]
            for leaf, rows in zip(_leaves(params), out):
                leaf[idx] = rows
            self._pending_flat.clear()

    # --- member state access -------------------------------------------------

    def checkout(self, slot: int) -> dict:
        """The authoritative state dict of one member. The SAME dict comes
        back until the next launch writes it into the stack, so callers
        that edit entries in place see their writes land."""
        st = self._host_state.get(slot)
        if st is None:
            self.launch()
            st = self._member_pull(slot)
            pend = self._pending_flat.pop(slot, None)
            if pend is not None:
                st["params"] = self._unravel(pend)
            self._host_state[slot] = st
            self._flat_cache = None  # the caller may edit the params
        return st

    def set_member_state(self, slot: int, value: dict) -> None:
        self.launch()
        self._pending_flat.pop(slot, None)
        self._host_state[slot] = value
        self._flat_cache = None

    def peek_state(self, slot: int) -> dict:
        """A read-only view of one member's state (predict, evaluate)."""
        st = self._host_state.get(slot)
        if st is not None:
            return st
        self.launch()  # a launch writes every pending host write first
        return _tmap(lambda leaf: leaf[slot], self.stacked)

    def flat_matrix(self, slot: int) -> np.ndarray:
        """The ``[capacity, P]`` flat parameters of every slot, in one
        device-to-host copy, cached until the next launch or state write
        (``slot``: the member whose read computes it)."""
        self.launch()
        if self._flat_cache is None:
            self._note_launch(slot)
            with self._timed():
                leaves = _leaves(self.stacked["params"])
                flat = torch.cat(
                    [t.reshape(self.capacity, -1).to(torch.float32) for t in leaves], dim=1
                )
                # writable: row writes keep the cache warm
                self._flat_cache = np.array(flat.cpu().numpy())
        return self._flat_cache

    def member_flat(self, slot: int):
        """(flat params row copy, unravel): a member's get_flat."""
        st = self._host_state.get(slot)
        if st is not None:
            leaves = _leaves(st["params"])
            flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
            return np.array(flat.cpu().numpy()), self._unravel
        return self.flat_matrix(slot)[slot].copy(), self._unravel

    def set_member_flat(self, slot: int, flat: np.ndarray) -> None:
        if slot in self._host_state:
            self._host_state[slot]["params"] = self._unravel(flat)
            return
        row = np.array(flat, np.float32, copy=True)
        self._pending_flat[slot] = row
        if self._flat_cache is not None:
            self._flat_cache[slot] = row

    def member_cum_loss(self, slot: int) -> float:
        st = self._host_state.get(slot)
        if st is not None:
            return float(st["cum_loss"])
        self.launch()
        return float(self.stacked["cum_loss"][slot])

    def predict_rows(self, entries: List[Tuple[int, np.ndarray]]) -> np.ndarray:
        """Gang forecast serving: one padded predict over the cohort.
        ``entries`` are ``(slot, padded [B, ...] batch)`` pairs of one
        shape; the result is indexed ``[slot, row]``. The ``[capacity, B,
        ...]`` pad is persistent a shape; only slots written last time
        are zeroed again."""
        self.launch()
        x0 = entries[0][1]
        shape = (self.capacity,) + x0.shape
        xs = self._pred_scratch.get(shape[1:])
        if xs is None or xs.shape != shape:
            xs = np.zeros(shape, np.float32)
            self._pred_scratch[shape[1:]] = xs
            self._pred_dirty.pop(shape[1:], None)
        else:
            for slot in self._pred_dirty.get(shape[1:], ()):
                xs[slot] = 0.0
        for slot, xb in entries:
            xs[slot] = xb
        self._pred_dirty[shape[1:]] = [slot for slot, _ in entries]
        global gang_predicts
        gang_predicts += 1
        self._note_launch(entries[0][0])
        with self._timed_serve():
            if self.use_vmap:
                out = self._vpredict(self.stacked, self._to_device(xs))
            else:
                out = torch.zeros(shape[:2], dtype=torch.float32, device=self.device)
                for slot, _ in entries:
                    st = _tmap(lambda leaf: leaf[slot], self.stacked)
                    out[slot] = self._steps.predict(st, self._to_device(xs[slot]))
            return out.cpu().numpy()


def _flat_is_float32(params) -> bool:
    """Whether the JAX package's ``ravel_pytree`` of these params would be
    float32: the leaves' promoted dtype (an int32 step count beside float32
    weights promotes to float32; integer-only leaves do not)."""
    dtypes = {t.dtype for t in _leaves(params)}
    floats = {d for d in dtypes if d.is_floating_point}
    return floats == {torch.float32}


class CohortEngine:
    """Per-spoke cohort manager: groups eligible pipelines by ``cache_key``
    and forms cohorts by the configured mode and threshold."""

    def __init__(self, config, device, timer=None, serve_timer=None):
        mode = str(getattr(config, "cohort", "off")).lower()
        self.mode = mode if mode in ("auto", "on") else "off"
        self.min_members = (
            1 if self.mode == "on" else max(int(getattr(config, "cohort_min", 8)), 1)
        )
        # vmap on the card (one batched launch a gang step), map on the CPU
        # (bitwise the solo path)
        self.use_vmap = torch.device(device).type != "cpu"
        self.n_shards = resolve_cohort_shards(config, device)
        self.timer = timer
        self.serve_timer = serve_timer
        self.cohorts: Dict[Any, Cohort] = {}
        self._pool: Dict[Any, List[MLPipeline]] = {}

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @staticmethod
    def eligible(pipeline: MLPipeline) -> bool:
        """Dense, device-side pipelines with float32 flat params gang; a
        host-side learner (HT), a SingleLearner-only one (its model lives on
        the hub) and the sparse learners keep the solo path."""
        if pipeline.cache_key is None or pipeline.learner.host_side:
            return False
        if pipeline.learner.name in SINGLE_LEARNER_ONLY:
            return False
        if getattr(pipeline.learner, "sparse", False):
            return False
        if pipeline._cohort is not None:
            return False
        return _flat_is_float32(pipeline._state["params"])

    def consider(self, pipeline: MLPipeline) -> None:
        """Offer a new pipeline: it joins its key's cohort, or pools until
        the threshold forms one."""
        if self.mode == "off" or not self.eligible(pipeline):
            return
        key = pipeline.cache_key
        cohort = self.cohorts.get(key)
        if cohort is not None:
            cohort.attach(pipeline)
            return
        pool = self._pool.setdefault(key, [])
        pool.append(pipeline)
        if len(pool) >= self.min_members:
            cohort = Cohort(pool[0], self.use_vmap, timer=self.timer,
                            serve_timer=self.serve_timer)
            for p in pool[1:]:
                cohort.attach(p)
            self.cohorts[key] = cohort
            del self._pool[key]

    def retire(self, pipeline: MLPipeline) -> None:
        cohort = pipeline._cohort
        if cohort is not None:
            cohort.detach(pipeline)
            if cohort.n_active == 0:
                self.cohorts.pop(cohort.key, None)
            return
        pool = self._pool.get(getattr(pipeline, "cache_key", None))
        if pool and pipeline in pool:
            pool.remove(pipeline)

    def flush(self) -> None:
        """Gang barrier: launch every cohort's staged work."""
        for cohort in self.cohorts.values():
            cohort.launch()

    def detach_all(self) -> None:
        """Dissolve every cohort: members take their state back and run
        solo until considered again."""
        for cohort in list(self.cohorts.values()):
            for member in list(cohort.members):
                if member is not None:
                    cohort.detach(member)
        self.cohorts.clear()
        self._pool.clear()


class GangAverager:
    """Deferred, vectorized model averaging for same-protocol cohort
    members' parameter-server shards.

    A hub whose round completes inside an active window stages its stacked
    ``[W, P]`` contribution matrix; at the window's exit every same-shape
    group averages in ONE ``[M, W, P]`` numpy reduction (the per-hub
    ``mean(axis=0)``, bitwise) and the hubs broadcast their releases.
    Outside a window the hubs average at once."""

    def __init__(self):
        self._depth = 0
        self._staged: List[Tuple[Any, np.ndarray]] = []

    @property
    def active(self) -> bool:
        return self._depth > 0

    @contextlib.contextmanager
    def window(self):
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self.flush()

    def stage(self, hub_node, stacked: np.ndarray) -> None:
        self._staged.append((hub_node, stacked))

    def flush(self) -> None:
        # a release can complete further rounds at once (a released worker
        # drains, pushes and closes the next round): loop until dry
        while self._staged:
            staged, self._staged = self._staged, []
            groups: Dict[Tuple[int, ...], List[Tuple[Any, np.ndarray]]] = {}
            for node, mat in staged:
                groups.setdefault(mat.shape, []).append((node, mat))
            for items in groups.values():
                if len(items) == 1:
                    node, mat = items[0]
                    node._finish_round(mat.mean(axis=0))
                    continue
                means = np.stack([m for _, m in items]).mean(axis=1)
                for (node, _), avg in zip(items, means):
                    node._finish_round(avg)
