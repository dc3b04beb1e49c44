"""SPMD protocol engine: the whole worker fleet of one pipeline as one step.

Counterpart of ``omldm_tpu/parallel/spmd.py`` (``SPMDTrainer``). Where the
host plane (``runtime`` + ``protocols``) exchanges parameter messages
between spokes and hubs, this engine trains every data-parallel worker in
one step and runs the protocol's synchronization as a collective over the
workers. The JAX package lays the workers over a device mesh and compiles
the step with ``shard_map``; the port holds them on one device, as the
leading axis of every state tensor (``parallel.mesh``): the collectives are
reductions over that axis, and the ``"hub"`` axis buckets the flat
parameter vector.

Protocols (the JAX package's six; SingleLearner, CentralizedTraining and
the host-side HT stay on the host plane):

- ``Synchronous``  -- every ``syncEvery`` steps: params <- mean over dp.
- ``EASGD``        -- on the same cadence, the elastic move toward a center
                      variable kept in the state.
- ``GM``           -- each worker's drift from the last synced estimate; a
                      one-scalar vote fires the sync when any worker left
                      the sphere of radius ``threshold``.
- ``FGM``          -- the safe-zone sum decides the same conditional sync.
- ``Asynchronous`` -- a worker advances its clock only on steps where it
                      has data and folds its delta into the shared global
                      at its own clock's cadence.
- ``SSP``          -- the same, but a worker ``staleness`` ahead of the
                      slowest is refused its batch: its state stays as it
                      was, ``last_accepted`` says so, and the host requeues
                      the batch.

The step syncs with the host nowhere the JAX step does not. The
Synchronous and EASGD cadence depends only on the step count, which the
host mirrors; GM's and FGM's vote and the asynchronous folds are device
values, selected with ``torch.where``. The only reads back are the JAX
bridge's: ``last_accepted`` and ``worker_clocks`` under SSP pacing, the
counters at a query or at termination, and ``predict``.

The JAX step donates the fleet state; the port's updates write into the
state where the learner does (the sparse learners' scatter, as in
``MLPipeline.fit``), and every tensor the step leaves in the state is its
own: no alias of one state tensor survives in another.

With a transport codec (``comm.codec`` ``fp16`` or ``int8``; ``topk`` is
host-plane only) every collective ships quantize-dequantized vectors
(``ops.codec.make_qdq``): a worker's contribution plus its error-feedback
residual (the state's ``ef`` leaf, ``[dp, flat_size]``, present only with a
codec) is quantized before the reduction, the reduced vector again for the
downlink, and the quantization error stays in ``ef`` for the next round.
Where the JAX step skips a collective under ``lax.cond`` (GM and FGM
without a violation, Async and SSP steps where no worker folds), the port
computes it and keeps the old values with ``torch.where``, residual
included.

``step_many`` and ``step_many_dense`` (one ``lax.scan`` program in the JAX
package) are loops of steps on the device's stream here. ``save``/``load``
snapshot the fleet state as a numpy tree in the JAX layout
(``fleet_numpy``: leaves ``[dp, hub, ...]``, the hub slots equal), through
``parallel.ckpt``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec, TrainingConfiguration
from omldm_tpu_torch.learners.registry import make_learner
from omldm_tpu_torch.ops.codec import BYTES_PER_ELEMENT, LEAF_META_BYTES, make_qdq
from omldm_tpu_torch.models.transformer import tree_map
from omldm_tpu_torch.parallel.ckpt import load_tree, save_tree, to_host
from omldm_tpu_torch.parallel.mesh import Mesh, make_mesh
from omldm_tpu_torch.pipelines.pipeline import _leaves, _rebuild, _tree_map as _map
from omldm_tpu_torch.pipelines.pipeline import fleet_state_from_numpy
from omldm_tpu_torch.preprocessors.registry import make_preprocessor
from omldm_tpu_torch.runtime.messages import comm_codec_name
from omldm_tpu_torch.utils import batch_valid_counts, resolve_device

SPMD_PROTOCOLS = (
    "Synchronous",
    "EASGD",
    "GM",
    "FGM",
    "Asynchronous",
    "SSP",
)

# the protocols whose workers progress on their own clocks
GATED = ("Asynchronous", "SSP")


def _map2(fn, tree, other):
    return _rebuild(tree, iter([fn(a, b) for a, b in zip(_leaves(tree), _leaves(other))]))


def _stack(trees):
    """Per-worker trees -> one tree of ``[dp, ...]`` leaves."""
    columns = zip(*(_leaves(t) for t in trees))
    return _rebuild(trees[0], iter([torch.stack(c) for c in columns]))


class SPMDTrainer:
    """One pipeline trained data-parallel by the workers of a ("dp", "hub")
    mesh.

    State leaves are stacked ``[dp, ...]``; micro-batches arrive stacked
    ``[dp, B, D]`` (one batch a worker), or as ``(idx, val)`` of shape
    ``[dp, B, K]`` for a sparse learner. The device is the mesh's: CUDA
    unless the caller asks for the CPU."""

    def __init__(
        self,
        learner_spec: LearnerSpec,
        preprocessor_specs: Sequence[PreprocessorSpec] = (),
        dim: int = 0,
        protocol: str = "Synchronous",
        mesh: Optional[Mesh] = None,
        training_configuration: Optional[TrainingConfiguration] = None,
        batch_size: int = 256,
        seed: int = 0,
        device=None,
    ):
        if protocol not in SPMD_PROTOCOLS:
            raise ValueError(
                f"SPMD engine supports {SPMD_PROTOCOLS}, got {protocol!r}; "
                "host-side models (HT) and SingleLearner/CentralizedTraining "
                "run in the host-multiplexed runtime"
            )
        if mesh is None:
            mesh = make_mesh(device=device)
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device, "SPMDTrainer")
        self.dp = mesh.shape["dp"]
        self.hub = mesh.shape["hub"]
        self.protocol = protocol
        self.tc = training_configuration or TrainingConfiguration(protocol=protocol)
        self.learner = make_learner(learner_spec)
        if self.learner.host_side:
            raise ValueError("host-side learners cannot run in the SPMD engine")
        self.preps = [make_preprocessor(p) for p in preprocessor_specs]
        self.sparse = getattr(self.learner, "sparse", False)
        if self.sparse and self.preps:
            raise ValueError(
                "sparse learners take padded-COO batches; streaming "
                "preprocessors are a dense-feature concept"
            )
        self.per_record = bool(self.tc.per_record)
        self.dim = dim
        self.batch_size = batch_size
        self.sync_every = max(int(self.tc.extra.get("syncEvery", 4)), 1)
        self.threshold = float(self.tc.extra.get("threshold", 0.5))
        # SSP staleness bound s: fastest - slowest worker clock <= s
        self.staleness = int(self.tc.extra.get("staleness", 3))
        if protocol == "SSP" and self.staleness < 1:
            # s=0 would refuse every batch and livelock the host's requeue
            # loop; lockstep semantics are what Synchronous is for
            raise ValueError(f"SSP staleness must be >= 1, got {self.staleness}")
        self.alpha = float(self.tc.extra.get("alpha", 0.5 / max(self.dp, 1)))
        # the transport codec's QDQ at the collective ship boundary (None:
        # the exact step); topk raises here, as in the JAX package
        self.codec_name = comm_codec_name(self.tc)
        self._qdq = make_qdq(self.codec_name)

        d = dim
        prep_dims = [d]
        for p in self.preps:
            d = p.out_dim(d)
            prep_dims.append(d)
        self.learner_dim = d

        self.state = self._init_state(seed, prep_dims)
        self._fitted_host = 0
        self._steps_host = 0
        self.requeued_rows = 0
        self._curve: List[Tuple[Any, Any]] = []

    # --- state construction ---

    def _init_state(self, seed: int, prep_dims) -> dict:
        """Per-worker draws from one generator seeded with ``seed`` (the JAX
        package splits a PRNG key per worker; parity tests load its draw
        with ``fleet_state_from_numpy``)."""
        gen = torch.Generator().manual_seed(seed)
        workers = [
            self.learner.init(self.learner_dim, gen, self.device) for _ in range(self.dp)
        ]
        self._template = _map(lambda t: None, workers[0])  # the tree's shape alone
        self._specs = [(tuple(t.shape), t.dtype) for t in _leaves(workers[0])]
        self.n_params = sum(int(np.prod(s, dtype=np.int64)) for s, _ in self._specs)
        self.pad = (-self.n_params) % self.hub
        self.flat_size = self.n_params + self.pad
        self.shard_size = self.flat_size // self.hub
        params = _stack(workers)
        preps = [_stack([p.init(di, self.device)] * self.dp)
                 for p, di in zip(self.preps, prep_dims)]
        # drift estimates start from each worker's own init; the center (the
        # EASGD center / the async global) is PS state and starts identical
        # on every worker, at the fleet-mean init
        flat = self._flat(params)
        dp = self.dp

        def counter(dtype, value=0):
            return torch.full((dp,), value, dtype=dtype, device=self.device)

        state = {
            "params": params,
            "preps": preps,
            "est": flat.clone(),
            "center": flat.mean(dim=0, keepdim=True).expand(dp, -1).clone(),
            "step": counter(torch.int32),
            "syncs": counter(torch.int32),
            "cum_loss": counter(torch.float32),
            # per-worker progress clock (steps with data consumed) and the
            # accept flag of the latest step: SSP's bound and the host's
            # pacing read them
            "clock": counter(torch.int32),
            "accepted": counter(torch.float32, 1.0),
            # steps on which the gated Async/SSP fold ran
            "fold_rounds": counter(torch.int32),
        }
        if self._qdq is not None:
            # each worker's error-feedback residual: the quantization error
            # of what it shipped, added to what it ships next
            state["ef"] = torch.zeros((dp, self.flat_size), dtype=torch.float32,
                                      device=self.device)
        return state

    def load_state(self, state: dict) -> None:
        """Adopt a whole fleet state (e.g. ``fleet_state_from_numpy`` of a
        JAX trainer's); the trainer owns it from here on."""
        self.state = state
        self._steps_host = int(state["step"][0])

    def fleet_numpy(self) -> dict:
        """The fleet state as numpy arrays in the JAX trainer's layout:
        every leaf ``[dp, hub, ...]``, the hub slots of a worker equal (the
        JAX package's hub shards hold the same values). The inverse is
        ``pipelines.pipeline.fleet_state_from_numpy``."""

        def widen(a):
            return np.ascontiguousarray(
                np.broadcast_to(a[:, None], (self.dp, self.hub) + a.shape[1:]))

        return tree_map(widen, to_host(self.state))

    def save(self, directory: str) -> None:
        """Snapshot the full fleet state (SURVEY.md section 7 step 8)."""
        save_tree(directory, self.fleet_numpy())

    def load(self, directory: str) -> None:
        """Restore fleet state saved by :meth:`save` (the same mesh shape)."""
        self.load_state(fleet_state_from_numpy(load_tree(directory), self))

    # --- flat layout and the collective ---

    def _flat(self, params) -> torch.Tensor:
        """``[dp, flat_size]``: each worker's leaves in ``ravel_pytree``
        order as float32, zero-padded to a multiple of hub."""
        cols = [t.reshape(self.dp, -1).to(torch.float32) for t in _leaves(params)]
        if self.pad:
            cols.append(torch.zeros((self.dp, self.pad), dtype=torch.float32,
                                    device=self.device))
        return torch.cat(cols, dim=1)

    def _unflat(self, flat: torch.Tensor):
        """The params tree from ``[dp, flat_size]``, every leaf a new
        contiguous tensor (cast back to its dtype: an integer leaf carried
        as a float truncates, as ``ravel_pytree``'s inverse does)."""
        out, pos = [], 0
        for shape, dtype in self._specs:
            size = int(np.prod(shape, dtype=np.int64))
            leaf = flat[:, pos : pos + size].reshape(self.dp, *shape)
            out.append(leaf.to(dtype, memory_format=torch.contiguous_format, copy=True))
            pos += size
        return _rebuild(self._template, iter(out))

    def _ps_allreduce(self, flat: torch.Tensor) -> torch.Tensor:
        """pmean over the workers through the hub-sharded PS: each hub
        bucket's mean over dp, reassembled (the all_gather over hub is a
        concatenation here), seen by every worker."""
        mean = flat.reshape(self.dp, self.hub, self.shard_size).mean(dim=0)
        return mean.reshape(1, self.flat_size).expand(self.dp, -1)

    # --- the step ---

    def _worker_update(self, params, preps, x, y, mask):
        """One worker's preprocessor and per-record learner update."""
        z = x
        new_preps = []
        for prep, s in zip(self.preps, preps):
            s = prep.update(s, z, mask)
            new_preps.append(s)
            z = prep.transform(s, z)
        p, loss = self.learner.update_per_record(params, z, y, mask, donate=True)
        return p, new_preps, loss

    def _local_update(self, params, preps, x, y, mask):
        """Every worker's preprocessor and learner update on its own batch:
        ``(params, preps, loss [dp])``. One worker runs on views of the
        state; a sparse fleet scatters once for all workers
        (``fleet_update``); a dense per-record fleet is ``torch.func.vmap``
        of one worker's update over dp (PA's scan then launches its
        batched kernel once for every worker); otherwise a loop over the
        workers."""
        learner = self.learner
        if self.dp > 1 and self.sparse and not self.per_record:
            new, loss = learner.fleet_update(params, x, y, mask)
            return new, preps, loss
        if self.dp > 1 and self.per_record and not self.sparse:
            return torch.func.vmap(self._worker_update)(params, preps, x, y, mask)
        update = learner.update_per_record if self.per_record else learner.update
        outs = []
        for i in range(self.dp):
            z = (x[0][i], x[1][i]) if self.sparse else x[i]
            new_preps = []
            for prep, s in zip(self.preps, preps):
                s = prep.update(_map(lambda t: t[i], s), z, mask[i])
                new_preps.append(s)
                z = prep.transform(s, z)
            p, loss = update(_map(lambda t: t[i], params), z, y[i], mask[i], donate=True)
            outs.append((p, new_preps, loss))
        if self.dp == 1:
            p, new_preps, loss = outs[0]
            lead = lambda t: t.unsqueeze(0)  # noqa: E731
            return _map(lead, p), [_map(lead, s) for s in new_preps], loss.reshape(1)
        return (
            _stack([o[0] for o in outs]),
            [_stack([o[1][j] for o in outs]) for j in range(len(self.preps))],
            torch.stack([o[2] for o in outs]),
        )

    def _step_impl(self, x, y, mask) -> torch.Tensor:
        st = self.state
        dp, protocol = self.dp, self.protocol
        self._steps_host += 1
        at_cadence = self._steps_host % self.sync_every == 0
        rows = mask.sum(dim=1)
        has_data = rows > 0
        gated = protocol in GATED
        # the update may write into the old params (donation): a refused
        # worker's flat is taken before it
        flat0 = self._flat(st["params"]) if gated else None
        params, preps, loss = self._local_update(st["params"], st["preps"], x, y, mask)
        est, center = st["est"], st["center"]
        syncs, clock, fold_rounds = st["syncs"], st["clock"], st["fold_rounds"]
        accepted = st["accepted"]
        qdq, ef = self._qdq, st.get("ef")

        if protocol == "Synchronous":
            if at_cadence:
                g, ef = self._shipped_allreduce(self._flat(params), ef)
                params, est, syncs = self._unflat(g), g, syncs + 1
        elif protocol == "EASGD":
            if at_cadence:
                flat = self._flat(params)
                mean_x, ef = self._shipped_allreduce(flat, ef)
                params = self._unflat(flat - self.alpha * (flat - center))
                center = center + self.alpha * dp * (mean_x - center)
                syncs = syncs + 1
        elif protocol in ("GM", "FGM"):
            flat = self._flat(params)
            drift2 = ((flat - est) ** 2).sum(dim=1)
            if protocol == "GM":
                # any worker outside the sphere => global violation
                fire = (drift2 > self.threshold ** 2).to(torch.float32).sum() > 0
            else:
                # FGM safe zone: psi = sum_i (drift_i^2 - T^2) >= 0
                fire = (drift2 - self.threshold ** 2).sum() >= 0.0
            if at_cadence:
                g, new_ef = self._shipped_allreduce(flat, ef)
                params = self._unflat(torch.where(fire, g, flat))
                est = torch.where(fire, g, est)
                syncs = syncs + fire.to(torch.int32)
                if ef is not None:
                    ef = torch.where(fire, new_ef, ef)
        else:  # Asynchronous / SSP: per-worker progress + PS folds
            flat = self._flat(params)
            allowed = has_data
            if protocol == "SSP":
                allowed = allowed & ((clock - clock.min()) < self.staleness)
            accepted = allowed.to(torch.float32)
            clock = clock + allowed.to(torch.int32)
            # refused and idle workers keep their exact previous state
            flat = torch.where(allowed[:, None], flat, flat0)
            preps = [
                _map2(lambda new, old: torch.where(
                    allowed.reshape((dp,) + (1,) * (new.dim() - 1)), new, old), s, s0)
                for s, s0 in zip(preps, st["preps"])
            ]
            loss = torch.where(allowed, loss, torch.zeros_like(loss))
            # the fold collective is gated on a one-scalar vote: a step
            # where no worker folds adds zeros, as the JAX lax.cond skips it
            my_turn = allowed & (clock % self.sync_every == 0)
            any_fold = my_turn.to(torch.float32).sum() > 0.0
            turn = my_turn[:, None]
            contrib = torch.where(turn, flat - est, torch.zeros_like(flat))
            if qdq is None:
                center = torch.where(any_fold, center + self._ps_allreduce(contrib), center)
            else:
                # only folding workers ship (and spend) their residual;
                # bystanders send exact zeros and keep theirs
                snd = torch.where(turn, contrib + ef, torch.zeros_like(contrib))
                t = qdq(snd)
                center = torch.where(any_fold, center + qdq(self._ps_allreduce(t)), center)
                ef = torch.where(any_fold, torch.where(turn, snd - t, ef), ef)
            fold_rounds = fold_rounds + any_fold.to(torch.int32)
            params = self._unflat(torch.where(turn, center, flat))
            est = torch.where(turn, center, est)
            syncs = syncs + my_turn.to(torch.int32)
        if not gated:
            clock = clock + has_data.to(torch.int32)

        self.state = {
            "params": params,
            "preps": preps,
            "est": est,
            "center": center,
            "step": st["step"] + 1,
            "syncs": syncs,
            "cum_loss": st["cum_loss"] + loss * (rows * accepted),
            "clock": clock,
            "accepted": accepted,
            "fold_rounds": fold_rounds,
        }
        if ef is not None:
            self.state["ef"] = ef
        return loss

    def _shipped_allreduce(self, flat: torch.Tensor, ef: Optional[torch.Tensor]):
        """``_ps_allreduce`` through the codec's ship boundary: ``(mean,
        new ef)``. Without a codec, the exact mean. With one, each worker
        ships ``qdq(flat + ef)``, the reduced vector is quantized again for
        the downlink, and the uplink's quantization error is the new
        residual."""
        if self._qdq is None:
            return self._ps_allreduce(flat), ef
        snd = flat + ef
        t = self._qdq(snd)
        return self._qdq(self._ps_allreduce(t)), snd - t

    # --- public API ---

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        """Host->device boundary: the array goes up in its own dtype (an fp16
        feed stays half the bytes) and is cast on the device."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        a = a.to(self.device)
        return a if dtype is None else a.to(dtype)

    def _batch(self, x):
        if self.sparse:
            idx, val = x
            return self._to_device(idx, torch.int32), self._to_device(val, torch.float32)
        return self._to_device(x, torch.float32)

    def step(self, x, y, mask, valid_count=None) -> torch.Tensor:
        """One fleet step. x: [dp, B, D] (or the COO pair); y, mask: [dp, B].
        Returns the lazy [dp] losses. Pass ``valid_count`` (total valid rows)
        when ``mask`` is on the device, else counting it reads it back."""
        n = int(valid_count) if valid_count is not None else int(np.asarray(mask).sum())
        loss = self._step_impl(self._batch(x), self._to_device(y, torch.float32),
                               self._to_device(mask, torch.float32))
        self._fitted_host += n
        self._curve.append((loss, self._fitted_host))
        return loss

    def step_many(self, xs, ys, masks, valid_counts=None) -> torch.Tensor:
        """T chained fleet steps. xs: [T, dp, B, D]; ys/masks: [T, dp, B].
        Returns the lazy [T, dp] losses."""
        counts = batch_valid_counts(masks, valid_counts)
        xs, ys, masks = (self._batch(xs), self._to_device(ys, torch.float32),
                         self._to_device(masks, torch.float32))
        t = masks.shape[0]
        losses = torch.stack([
            self._step_impl((xs[0][i], xs[1][i]) if self.sparse else xs[i], ys[i], masks[i])
            for i in range(t)
        ])
        fitted_after = []
        for c in counts:
            self._fitted_host += c
            fitted_after.append(self._fitted_host)
        self._curve.append((losses, fitted_after))
        return losses

    def step_many_dense(self, xs, ys) -> torch.Tensor:
        """T chained fleet steps where EVERY row is valid: the mask is made
        on the device, so the host ships only xs/ys, in their feed dtype
        (float16 staging halves the bytes; the cast to float32 runs on the
        device). A full stage of the bridge has no padding by
        construction."""
        t, dp, b = xs.shape[0], xs.shape[1], xs.shape[2]
        xs = self._to_device(xs, torch.float32)
        ys = self._to_device(ys, torch.float32)
        ones = torch.ones((dp, b), dtype=torch.float32, device=self.device)
        losses = torch.stack([self._step_impl(xs[i], ys[i], ones) for i in range(t)])
        fitted_after = []
        for _ in range(t):
            self._fitted_host += dp * b
            fitted_after.append(self._fitted_host)
        self._curve.append((losses, fitted_after))
        return losses

    @property
    def fitted(self) -> int:
        return self._fitted_host

    def worker_clocks(self) -> np.ndarray:
        """Per-worker progress clocks [dp] (steps with data consumed)."""
        return self.state["clock"].cpu().numpy()

    def last_accepted(self) -> np.ndarray:
        """Bool [dp]: whether each worker consumed its batch on the latest
        step. Under SSP a worker at the staleness bound refuses it; the
        host requeues it and calls :meth:`note_requeued`."""
        return self.state["accepted"].cpu().numpy() > 0.0

    def release_stragglers(self) -> None:
        """Termination-time SSP release (the host plane's
        ``SSPParameterServer.on_terminate``): lift every worker's clock to
        the fleet max so the bound stops refusing final drains."""
        clock = self.state["clock"]
        self.state = {**self.state, "clock": clock.max().expand_as(clock).clone()}

    def note_requeued(self, n_rows: int) -> None:
        """Correct the fitted counter for rows a step refused (the host
        counted them when it issued the step)."""
        self._fitted_host -= int(n_rows)
        self.requeued_rows += int(n_rows)

    def curve_slice(self) -> List[Tuple[float, int]]:
        """Drain the learning-curve points (the fleet-mean loss of each
        step); the lazy losses come to the host in one copy."""
        fresh = self._curve
        self._curve = []
        if not fresh:
            return []
        means = torch.cat([l.reshape(-1, self.dp).mean(dim=1) for l, _ in fresh]).tolist()
        fitted: List[int] = []
        for _, f in fresh:
            fitted.extend(f if isinstance(f, list) else [f])
        return [(float(l), int(f)) for l, f in zip(means, fitted)]

    def _counters(self) -> Tuple[int, int, int]:
        """(syncs summed over workers, worker 0's syncs, steps)."""
        syncs = self.state["syncs"].cpu().numpy()
        return int(syncs.sum()), int(syncs[0]), int(self.state["step"][0])

    def sync_count(self) -> int:
        """Parameter synchronizations executed (summed over workers for the
        staggered protocols; rounds for the others)."""
        total, first, _ = self._counters()
        return total if self.protocol in GATED else first

    @staticmethod
    def protocol_traffic_bytes(
        protocol: str, dp: int, flat_size: int,
        syncs_sum: int, syncs00: int, steps: int,
        codec: str = "none",
    ) -> Tuple[int, int]:
        """(sync_count, bytesShipped) from raw counters -- the ONE payload
        formula, shared with the distributed job's merged report so the
        two accountings can never diverge. ``codec`` prices each param
        sync at the transport codec's wire width (ops.codec): pass
        ``"none"`` (the default) for the LOGICAL fp32 accounting, the
        pipeline's configured codec for bytes-on-wire. Scalar control
        channels (votes, clocks) are never compressed."""
        per_el = BYTES_PER_ELEMENT[codec]
        meta = LEAF_META_BYTES[codec]
        param_bytes = 2 * (int(flat_size * per_el) + meta)
        if protocol in ("Asynchronous", "SSP"):
            sync_count = syncs_sum
            total = syncs_sum * param_bytes
            channels = 2 if protocol == "SSP" else 1
            total += steps * dp * channels * 2 * 4
        else:
            sync_count = syncs00
            total = syncs00 * dp * param_bytes
        if protocol in ("GM", "FGM"):
            total += steps * dp * 2 * 4
        return sync_count, total

    def bytes_shipped(self) -> int:
        """bytesShipped (FlinkHub.scala:118-127) from the collective sites'
        counters: a param sync moves a worker's params up and the global
        back down; the GM/FGM vote and the Async/SSP fold vote (and SSP's
        min-clock) are one scalar each way a worker a step."""
        total, first, steps = self._counters()
        return self.protocol_traffic_bytes(
            self.protocol, self.dp, self.flat_size, total, first, steps)[1]

    def bytes_on_wire(self) -> int:
        """bytesShipped priced at the configured codec's wire width (equal to
        :meth:`bytes_shipped` with codec ``none``, the only one ported)."""
        total, first, steps = self._counters()
        return self.protocol_traffic_bytes(
            self.protocol, self.dp, self.flat_size, total, first, steps,
            codec=self.codec_name)[1]

    def collective_bytes_physical(self) -> int:
        """Bytes the collectives moved: the Async/SSP fold runs only on
        steps where some worker folds (``fold_rounds``), plus the scalar
        vote channels every step; the other protocols as bytesShipped."""
        if self.protocol in GATED:
            steps = int(self.state["step"][0])
            rounds = int(self.state["fold_rounds"][0])
            channels = 2 if self.protocol == "SSP" else 1
            return (rounds * self.dp * 2 * self.flat_size * 4
                    + steps * self.dp * channels * 2 * 4)
        return self.bytes_shipped()

    def _worker(self, tree, w: int = 0):
        return _map(lambda t: t[w], tree)

    def global_flat_params(self) -> np.ndarray:
        """Model of worker 0 (post-sync replicas agree), ``ravel_pytree``
        order, unpadded; a host copy."""
        leaves = _leaves(self._worker(self.state["params"]))
        return torch.cat([t.reshape(-1).to(torch.float32) for t in leaves]).cpu().numpy()

    def shard_params(self) -> list:
        """Per-worker params trees (host copies)."""
        return [_map(lambda t: t.cpu().numpy(), self._worker(self.state["params"], w))
                for w in range(self.dp)]

    def _serve_input(self, x):
        """Worker 0's features: through its preprocessor states."""
        z = self._batch(x)
        for prep, s in zip(self.preps, self.state["preps"]):
            z = prep.transform(self._worker(s), z)
        return z

    def predict(self, x) -> np.ndarray:
        """Serve with the worker-0 model (post-sync replicas agree)."""
        z = self._serve_input(x)
        return self.learner.predict(self._worker(self.state["params"]), z).cpu().numpy()

    def evaluate(self, x, y, mask) -> Tuple[float, float]:
        """Loss/score of the worker-0 model on a host-side holdout set."""
        z = self._serve_input(x)
        params = self._worker(self.state["params"])
        y = self._to_device(y, torch.float32)
        mask = self._to_device(mask, torch.float32)
        return (float(self.learner.loss(params, z, y, mask)),
                float(self.learner.score(params, z, y, mask)))
