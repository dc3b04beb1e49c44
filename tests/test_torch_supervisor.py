"""The fleet supervisor and its pure policies in the port
(omldm_tpu_torch/runtime/supervisor.py, runtime/selfheal.py) against the
JAX package's (omldm_tpu/runtime/supervisor.py, runtime/selfheal.py).

- The supervisor's mechanics, as tests/test_supervisor.py holds them, with
  stand-in ``python -c`` workers and both packages' supervisors on the same
  workers: a flaky worker restarts, the budget runs out with an incident
  log, a wedged worker is found by its heartbeat timeout, a worker that
  never beats is timed from its spawn, one bad worker fails the fleet,
  and ``supervise_from_flags`` passes flags through and returns the
  worker's exit code. The two supervisors must keep the same failure
  records.
- The pure policies on the same scripted clock and pressure or failure
  sequences: ``AutoscalePolicy`` (tests/test_autoscale.py's
  TestAutoscalePolicy) and ``SelfHealPolicy`` (tests/test_selfheal.py's
  TestSelfHealPolicy), and ``kill_escalate`` (its TestKillEscalate) --
  the port's decision after every step equals the JAX class's, and both
  equal the JAX tests' expected values; seeded random sequences add
  coverage past the scripted ones.
- The supervisor's wiring (both JAX TestSupervisorWiring classes): the
  channels a policy arms, the classification of exits, strikes that
  degrade without burning a restart attempt, and the worker command,
  which names omldm_tpu_torch.
"""

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest

from omldm_tpu.runtime import selfheal as jax_selfheal
from omldm_tpu.runtime import supervisor as jax_supervisor
from omldm_tpu_torch.runtime import selfheal as port_selfheal
from omldm_tpu_torch.runtime import supervisor as port_supervisor

SUPERVISORS = {"jax": jax_supervisor, "port": port_supervisor}
SELFHEAL = {"jax": jax_selfheal, "port": port_selfheal}

# worker that logs its argv, then exits 1 on the first incarnation (state
# file absent) and 0 on the second: the transient failure a restart is for
FLAKY = """
import os, sys
args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
with open(args["--argvLog"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
marker = args["--marker"]
if os.path.exists(marker):
    sys.exit(0)
open(marker, "w").close()
sys.exit(1)
"""

# worker that beats once, then wedges (a process stuck in a collective
# whose peer died: alive, silent, never exits)
WEDGED = """
import os, sys, time
args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
d = args["--heartbeatDir"]
os.makedirs(d, exist_ok=True)
with open(os.path.join(d, "proc%s.hb" % args["--processId"]), "w") as f:
    f.write("beat")
time.sleep(300)
"""

ONE_BAD = """
import sys, time
args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
sys.exit(3) if args["--processId"] == "1" else time.sleep(300)
"""


def _records(sup):
    return [(r.attempt, r.cause, r.failed, r.restored, r.kind) for r in sup.failures]


def _supervisor(pkg, tmp_path, script, nproc=1, extra_args=(), **kw):
    return SUPERVISORS[pkg].DistributedJobSupervisor(
        list(extra_args), nproc, worker_cmd=[sys.executable, "-c", script],
        run_dir=str(tmp_path / pkg / "run"), **kw)


def _both(tmp_path, script, **kw):
    """The same stand-in fleet under both supervisors: {pkg: (supervisor,
    the FleetFailure raised or None, seconds)}."""
    out = {}
    for pkg in SUPERVISORS:
        sup = _supervisor(pkg, tmp_path, script, **kw)
        start = time.monotonic()
        try:
            sup.run()
            exc = None
        except SUPERVISORS[pkg].FleetFailure as e:
            exc = e
        out[pkg] = (sup, exc, time.monotonic() - start)
    return out


def test_flaky_worker_restarts_and_succeeds(tmp_path):
    runs = {}
    for pkg in SUPERVISORS:
        argv_log = tmp_path / f"argv_{pkg}.log"
        sup = _supervisor(pkg, tmp_path, FLAKY, max_restarts=1,
                          extra_args=["--marker", str(tmp_path / f"marker_{pkg}"),
                                      "--argvLog", str(argv_log)])
        assert sup.run() == 0
        first, second = argv_log.read_text().replace(f"_{pkg}", "").strip().splitlines()
        runs[pkg] = (_records(sup), first, second)
    [(attempt, cause, failed, restored, _)] = runs["port"][0]
    assert attempt == 1 and "exited 1" in cause and failed == [0]
    assert not restored  # no --checkpointDir in the worker args
    _, first, second = runs["port"]
    # the relaunch -- and only the relaunch -- carries --restore true
    assert "--restore true" not in first
    assert "--restore true" in second
    assert runs["port"] == runs["jax"]


def test_restart_budget_exhausts_with_incident_log(tmp_path):
    runs = _both(tmp_path, "import sys; sys.exit(7)", max_restarts=2, extra_args=["--x", "y"])
    sup, exc, _ = runs["port"]
    assert exc is not None and exc.returncode == 7
    # every attempt (the first + 2 restarts) is an incident
    assert [r.attempt for r in sup.failures] == [1, 2, 3]
    assert all("exited 7" in r.cause for r in sup.failures)
    assert _records(sup) == _records(runs["jax"][0])


def test_heartbeat_timeout_detects_wedged_worker(tmp_path):
    runs = _both(tmp_path, WEDGED, max_restarts=0, heartbeat_timeout_s=0.4)
    for pkg, (sup, exc, seconds) in runs.items():
        # found by staleness, well before the worker's 300 s sleep ends,
        # and the wedged process was killed on the way out
        assert seconds < 30, pkg
        assert "heartbeat timeout" in exc.cause and exc.failed == [0], pkg
        assert exc.kinds == {0: "hang"}, pkg


def test_never_beating_worker_times_out_from_spawn_clock(tmp_path):
    runs = _both(tmp_path, "import time; time.sleep(300)", max_restarts=0,
                 heartbeat_timeout_s=0.4)
    for pkg, (sup, exc, seconds) in runs.items():
        assert seconds < 30 and "heartbeat timeout" in exc.cause, pkg


def test_one_bad_worker_fails_whole_fleet(tmp_path):
    # Flink's global restart: a healthy peer is torn down with the failed one
    runs = _both(tmp_path, ONE_BAD, nproc=2, max_restarts=0)
    for pkg, (sup, exc, seconds) in runs.items():
        assert seconds < 30, pkg  # the peer was killed, not awaited
        assert exc.failed == [1] and exc.returncode == 3, pkg
    assert _records(runs["port"][0]) == _records(runs["jax"][0])


def test_supervise_from_flags_passthrough_and_exit_code(tmp_path):
    # supervisor-only flags are consumed, everything else reaches the
    # worker; exhausted restarts surface the worker's code
    for pkg, mod in SUPERVISORS.items():
        rc = mod.supervise_from_flags({
            "supervise": "true",
            "processes": "1",
            "restartAttempts": "1",
            "restartDelayMs": "0",
            "supervisorDir": str(tmp_path / pkg / "run"),
            "workerBoot": (
                "import sys; "
                "assert '--restartAttempts' not in sys.argv; "
                "assert '--processes' in sys.argv; "
                "assert '--device' in sys.argv; "
                "sys.exit(5)"
            ),
            "device": "cpu",
        })
        assert rc == 5, pkg


def test_cli_supervise_routes_to_the_supervisor(tmp_path):
    """``python -m omldm_tpu_torch --supervise true`` hands the command to
    the supervisor: the worker gets the job's flags and the plumbing, and
    the CLI returns the worker's code."""
    from omldm_tpu_torch.__main__ import main

    log = tmp_path / "argv.log"
    boot = ("import sys; open(%r, 'w').write(' '.join(sys.argv[1:])); sys.exit(4)"
            % str(log))
    rc = main(["--supervise", "true", "--processes", "1", "--device", "cpu",
               "--trainingData", "t.jsonl", "--restartAttempts", "0",
               "--supervisorDir", str(tmp_path / "run"), "--workerBoot", boot])
    assert rc == 4
    argv = log.read_text().split()
    assert argv[argv.index("--trainingData") + 1] == "t.jsonl"
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[argv.index("--processId") + 1] == "0"
    assert "--supervise" not in argv and "--workerBoot" not in argv


def test_supervisor_only_flags_match_the_jax_package():
    assert port_supervisor.SUPERVISOR_ONLY_FLAGS == jax_supervisor.SUPERVISOR_ONLY_FLAGS


# --- AutoscalePolicy: the JAX class's decisions, step for step ---------------


def _autoscale(pkg, **kw):
    kw.setdefault("min_processes", 1)
    kw.setdefault("max_processes", 8)
    kw.setdefault("up_after_s", 1.0)
    kw.setdefault("down_after_s", 2.0)
    kw.setdefault("cooldown_s", 0.5)
    return SUPERVISORS[pkg].AutoscalePolicy(**kw)


def _replay_autoscale(steps, **kw):
    """Feed the same script to both classes: steps are ("decide", nproc,
    level, now[, signals]) | ("rescaled", now) | ("reset",). Returns each
    package's decisions (None for the non-decide steps)."""
    out = {}
    for pkg in SUPERVISORS:
        p = _autoscale(pkg, **kw)
        got = []
        for step in steps:
            if step[0] == "decide":
                got.append(p.decide(*step[1:4], signals=step[4] if len(step) > 4 else None))
            elif step[0] == "rescaled":
                got.append(p.note_rescaled(step[1]))
            else:
                got.append(p.reset())
        out[pkg] = got
    assert out["port"] == out["jax"]
    return [g for s, g in zip(steps, out["port"]) if s[0] == "decide"]


AUTOSCALE_SCRIPTS = {
    # tests/test_autoscale.py's TestAutoscalePolicy, each with its expected
    # decisions
    "sustained_critical_scales_out": (
        {}, [("decide", 2, 2, 0.0), ("decide", 2, 2, 0.5), ("decide", 2, 2, 1.0)],
        [None, None, 4]),
    "bounded_by_max": (
        {"max_processes": 3}, [("decide", 2, 2, 0.0), ("decide", 2, 2, 1.5)], [None, 3]),
    "at_the_ceiling": (
        {"max_processes": 2}, [("decide", 2, 2, 0.0), ("decide", 2, 2, 1.5)], [None, None]),
    "sustained_ok_scales_in": (
        {}, [("decide", 4, 0, 0.0), ("decide", 4, 0, 1.0), ("decide", 4, 0, 2.0)],
        [None, None, 2]),
    "floored_by_min": (
        {"min_processes": 3}, [("decide", 4, 0, 0.0), ("decide", 4, 0, 2.5)], [None, 3]),
    "at_the_floor": (
        {"min_processes": 1}, [("decide", 1, 0, 0.0), ("decide", 1, 0, 99.0)], [None, None]),
    "elevated_holds_and_clears_streaks": (
        {}, [("decide", 2, 2, 0.0), ("decide", 2, 1, 0.9), ("decide", 2, 2, 1.0),
             ("decide", 2, 2, 2.0)], [None, None, None, 4]),
    "unknown_pressure_holds": (
        {}, [("decide", 2, 0, 0.0), ("decide", 2, -1, 1.0), ("decide", 2, 0, 2.5),
             ("decide", 2, 0, 4.5)], [None, None, None, 1]),
    "level_flap_never_fires": (
        {}, [("decide", 2, 2 if i % 2 else 0, i * 0.3) for i in range(40)], [None] * 40),
    "cooldown_gates_consecutive_decisions": (
        {"cooldown_s": 10.0},
        [("decide", 1, 2, 0.0), ("decide", 1, 2, 1.0), ("rescaled", 1.0), ("decide", 2, 2, 2.0),
         ("decide", 2, 2, 9.0), ("decide", 2, 2, 11.5)], [None, 2, None, None, 4]),
    "reset_forgets_streaks": (
        {}, [("decide", 1, 2, 0.0), ("reset",), ("decide", 1, 2, 1.5)], [None, None]),
    "serve_p99_reads_critical": (
        {"serve_p99_critical_ms": 50.0},
        [("decide", 1, 0, 0.0, {"serveP99": 80.0}), ("decide", 1, 0, 1.0, {"serveP99": 80.0})],
        [None, 2]),
    "imbalance_reads_critical": (
        {"imbalance_critical": 2.0},
        [("decide", 2, 0, 0.0, {"imbalance": 3.0}), ("decide", 2, 0, 1.5, {"imbalance": 3.0}),
         ("decide", 4, -1, 2.0, {"imbalance": 9.0})], [None, 4, None]),
}


@pytest.mark.parametrize("name", sorted(AUTOSCALE_SCRIPTS))
def test_autoscale_policy_matches_jax(name):
    kw, steps, want = AUTOSCALE_SCRIPTS[name]
    assert _replay_autoscale(steps, **kw) == want


@pytest.mark.parametrize("seed", range(12))
def test_autoscale_policy_random_sequences_match_jax(seed):
    """A seeded random walk of widths, levels (unknown included), clock
    steps, signals and rescales: the same decisions in both packages."""
    rng = np.random.RandomState(seed)
    kw = {"min_processes": int(rng.randint(1, 3)), "max_processes": int(rng.randint(3, 9)),
          "up_after_s": float(rng.uniform(0, 2)), "down_after_s": float(rng.uniform(0, 3)),
          "cooldown_s": float(rng.uniform(0, 2)), "serve_p99_critical_ms": 40.0}
    now, steps = 0.0, []
    for _ in range(200):
        now += float(rng.exponential(0.3))
        if rng.rand() < 0.05:
            steps.append(("rescaled", now))
            continue
        nproc = int(rng.randint(kw["min_processes"], kw["max_processes"] + 1))
        steps.append(("decide", nproc, int(rng.randint(-1, 3)), now,
                      {"serveP99": float(rng.uniform(0, 60))}))
    decisions = _replay_autoscale(steps, **kw)
    assert len(decisions) == sum(1 for s in steps if s[0] == "decide")


@pytest.mark.parametrize("kw", [
    {"min_processes": 0},
    {"min_processes": 4, "max_processes": 2},
    {"scale_factor": 1},
    {"serve_p99_critical_ms": -1.0},
])
def test_autoscale_policy_validation(kw):
    for pkg in SUPERVISORS:
        with pytest.raises(ValueError):
            _autoscale(pkg, **kw)


# --- SelfHealPolicy: the JAX class's decisions, step for step ----------------


def _selfheal(pkg, **kw):
    kw.setdefault("min_processes", 1)
    kw.setdefault("probe_after_s", 5.0)
    kw.setdefault("probe_window_s", 3.0)
    kw.setdefault("clock", lambda: 0.0)
    return SELFHEAL[pkg].SelfHealPolicy(kw.pop("threshold", 2), kw.pop("configured", 4), **kw)


def _state(p):
    return (dict(p.strikes), p.degraded_by, p.probing, p.degrades, p.probes,
            p.probe_failures, p.heals, p.snapshot())


def _replay_selfheal(steps, **kw):
    """Feed the same script to both classes: ("fail", slots, kinds, nproc,
    now) | ("healthy",) | ("probe", nproc, now) | ("signaled",) |
    ("spawn", now) | ("tick", now). Returns the port's answers; after each
    step both classes' answers and states are equal."""
    policies = {pkg: _selfheal(pkg, **kw) for pkg in SELFHEAL}
    answers = []
    for step in steps:
        got = {}
        for pkg, p in policies.items():
            op = step[0]
            if op == "fail":
                got[pkg] = p.note_failure(*step[1:])
            elif op == "healthy":
                got[pkg] = p.note_healthy_attempt()
            elif op == "probe":
                got[pkg] = p.probe_target(*step[1:])
            elif op == "signaled":
                got[pkg] = p.note_probe_signaled()
            elif op == "spawn":
                got[pkg] = p.note_spawn(step[1])
            else:
                got[pkg] = p.tick_healthy(step[1])
        assert got["port"] == got["jax"], step
        assert _state(policies["port"]) == _state(policies["jax"]), step
        answers.append(got["port"])
    return answers, policies["port"]


C, H = "crash", "hang"
SELFHEAL_SCRIPTS = {
    # tests/test_selfheal.py's TestSelfHealPolicy, each with its expected
    # answers
    "strikes_accrue_per_slot": (
        {}, [("fail", [1], {1: C}, 4, 0.0), ("fail", [2], {2: C}, 4, 1.0)], [None, None]),
    "threshold_degrades_to_survivors": (
        {}, [("fail", [1], {1: C}, 4, 0.0), ("fail", [1], {1: H}, 4, 1.0)], [None, 3]),
    "healthy_attempt_resets_streak": (
        {}, [("fail", [1], {1: C}, 4, 0.0), ("healthy",), ("fail", [1], {1: C}, 4, 1.0)],
        [None, None, None]),
    "multi_slot_failure_degrades_by_all": (
        {"threshold": 1}, [("fail", [1, 3], {1: H, 3: H}, 4, 0.0)], [2]),
    "floor": (
        {"threshold": 1, "configured": 2, "min_processes": 2},
        [("fail", [0], {0: C}, 2, 0.0)], [None]),
    "probe_cadence": (
        {"threshold": 1},
        [("fail", [1], {1: C}, 4, 10.0), ("probe", 3, 14.9), ("probe", 3, 15.1), ("signaled",),
         ("probe", 4, 99.0)], [3, None, 4, None, None]),
    "probe_heals_after_window": (
        {"threshold": 1},
        [("fail", [1], {1: C}, 4, 0.0), ("signaled",), ("spawn", 20.0), ("tick", 22.9),
         ("tick", 23.1), ("tick", 24.0)], [3, None, None, False, True, False]),
    "failed_probe_redegrades_immediately": (
        {"threshold": 2},
        [("fail", [1], {1: C}, 4, 0.0), ("fail", [1], {1: C}, 4, 1.0), ("signaled",),
         ("spawn", 10.0), ("fail", [1], {1: C}, 4, 11.0)], [None, 3, None, None, 3]),
    "spawn_starts_window_not_signal": (
        {"threshold": 1},
        [("fail", [1], {1: C}, 4, 0.0), ("signaled",), ("spawn", 50.0), ("tick", 52.0),
         ("tick", 53.5)], [3, None, None, False, True]),
    "empty_failure_is_no_strike": (
        {}, [("fail", [], {}, 4, 0.0), ("fail", [2], {2: "launch"}, 4, 1.0)], [None, None]),
}


@pytest.mark.parametrize("name", sorted(SELFHEAL_SCRIPTS))
def test_selfheal_policy_matches_jax(name):
    kw, steps, want = SELFHEAL_SCRIPTS[name]
    answers, p = _replay_selfheal(steps, **kw)
    assert answers == want
    if name == "probe_heals_after_window":
        assert not p.degraded and p.strikes == {} and p.heals == 1
    if name == "failed_probe_redegrades_immediately":
        assert p.probe_failures == 1 and not p.probing and p.degraded_by == 1


@pytest.mark.parametrize("seed", range(12))
def test_selfheal_policy_random_sequences_match_jax(seed):
    """A seeded random walk of failures (one or two slots, every class),
    clean completions, probe queries, signals, spawns and ticks, the width
    following the policy's own targets: the same answers and states in both
    packages after every step."""
    rng = np.random.RandomState(100 + seed)
    configured = int(rng.randint(2, 6))
    kw = {"threshold": int(rng.randint(1, 4)), "configured": configured,
          "min_processes": int(rng.randint(1, configured + 1)),
          "probe_after_s": float(rng.uniform(0.5, 4)), "probe_window_s": float(rng.uniform(0.5, 3))}
    policies = {pkg: _selfheal(pkg, **dict(kw)) for pkg in SELFHEAL}
    now, nproc = 0.0, configured
    for _ in range(150):
        now += float(rng.exponential(0.5))
        op = rng.choice(["fail", "healthy", "probe", "spawn", "tick"], p=[.3, .1, .3, .1, .2])
        slots = sorted(set(int(s) for s in rng.randint(0, nproc, size=2)))[: 1 + (seed % 2)]
        kinds = {s: ("crash", "hang", "launch")[s % 3] for s in slots}
        got = {}
        for pkg, p in policies.items():
            if op == "fail":
                got[pkg] = p.note_failure(slots, kinds, nproc, now)
            elif op == "healthy":
                got[pkg] = p.note_healthy_attempt()
            elif op == "probe":
                got[pkg] = p.probe_target(nproc, now)
                if got[pkg] is not None:
                    p.note_probe_signaled()
            elif op == "spawn":
                got[pkg] = p.note_spawn(now)
            else:
                got[pkg] = p.tick_healthy(now)
        assert got["port"] == got["jax"], (op, now)
        assert _state(policies["port"]) == _state(policies["jax"]), (op, now)
        if op in ("fail", "probe") and got["port"] is not None:
            nproc = got["port"]


def test_selfheal_policy_validation():
    for pkg in SELFHEAL:
        cls = SELFHEAL[pkg].SelfHealPolicy
        for args, kw in (((0, 4), {}), ((1, 4), {"min_processes": 0}),
                         ((1, 1), {"min_processes": 2})):
            with pytest.raises(ValueError):
                cls(*args, **kw)
    p = _selfheal("port", threshold=1)
    p.note_failure([1], {1: H}, 4, 0.0)
    snap = p.snapshot()
    assert snap["degradedBy"] == 1 and snap["degrades"] == 1
    json.dumps(snap)  # the strike file's form
    assert snap == _replay_selfheal([("fail", [1], {1: H}, 4, 0.0)], threshold=1)[1].snapshot()


# --- kill escalation ---------------------------------------------------------


class _FakeProc:
    """Popen-shaped: ``polite`` dies on terminate(), a stubborn (SIGSTOP'd
    or natively wedged) one only on kill()."""

    def __init__(self, polite: bool, rc=None):
        self.polite = polite
        self.rc = rc
        self.terminated = False
        self.killed = False

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated = True
        if self.polite:
            self.rc = -15

    def kill(self):
        self.killed = True
        self.rc = -9

    def wait(self):
        return self.rc


@pytest.mark.parametrize("fleet,want", [
    ((True, True), []),          # a polite fleet never escalates
    ((True, False), [1]),        # the stubborn process gets SIGKILL
    ((False, False, True), [0, 1]),
])
def test_kill_escalate_matches_jax(fleet, want):
    results = {}
    for pkg in SELFHEAL:
        procs = [_FakeProc(polite) for polite in fleet]
        clock = [0.0]
        escalated = SELFHEAL[pkg].kill_escalate(
            procs, 1.0, clock=lambda: clock[0],
            sleep=lambda s: clock.__setitem__(0, clock[0] + s))
        results[pkg] = (escalated, [(p.terminated, p.killed, p.rc) for p in procs])
    assert results["port"] == results["jax"]
    assert results["port"][0] == want
    assert all(t for t, _, _ in results["port"][1])


def test_kill_escalate_leaves_a_dead_fleet_untouched():
    p = _FakeProc(True, rc=0)
    assert port_selfheal.kill_escalate([p], 1.0) == []
    assert not p.terminated and not p.killed


# --- supervisor wiring -------------------------------------------------------


def _wired(pkg, tmp_path, nproc=2, **kw):
    return SUPERVISORS[pkg].DistributedJobSupervisor(
        ["--checkpointDir", str(tmp_path / pkg / "ck")], nproc,
        run_dir=str(tmp_path / pkg / "run"), **kw)


def _heal(pkg, threshold=2, nproc=2):
    return SELFHEAL[pkg].SelfHealPolicy(threshold, nproc, min_processes=1,
                                        probe_after_s=5.0, probe_window_s=3.0)


def _argv_tail(sup, pid=0, restore=False):
    argv = sup._worker_argv(pid, 9999, restore=restore)
    return argv[len(sup.worker_cmd):]


@pytest.mark.parametrize("arm", ["none", "autoscale", "selfheal", "timeout"])
def test_worker_argv_matches_jax(arm, tmp_path):
    """The plumbing a worker gets (processes, id, coordinator, restore, the
    heartbeat and signal channels, the rescale count, the degraded gauge)
    equals the JAX supervisor's, past the interpreter command."""
    tails = {}
    for pkg in SUPERVISORS:
        kw = {}
        if arm == "autoscale":
            kw["autoscale"] = _autoscale(pkg)
        elif arm == "selfheal":
            kw["selfheal"] = _heal(pkg)
        elif arm == "timeout":
            kw["heartbeat_timeout_s"] = 5.0
        sup = _wired(pkg, tmp_path, **kw)
        tails[pkg] = [_argv_tail(sup, pid, restore) for pid in (0, 1) for restore in (0, 1)]
    strip = lambda t: [a.replace(str(tmp_path / "port"), "D").replace(str(tmp_path / "jax"), "D")
                       for a in t]
    assert [strip(t) for t in tails["port"]] == [strip(t) for t in tails["jax"]]
    tail = tails["port"][0]
    assert ("--heartbeatDir" in tail) == (arm != "none")
    assert ("--rescaleSignalDir" in tail) == (arm in ("autoscale", "selfheal"))
    if arm == "autoscale":
        assert tail[tail.index("--rescaleCount") + 1] == "0"


def test_worker_command_names_the_port(tmp_path):
    sup = _wired("port", tmp_path)
    argv = sup._worker_argv(0, 9999, restore=False)
    assert argv[:3] == [sys.executable, "-m", "omldm_tpu_torch.runtime.distributed_job"]
    assert not any(a.startswith("omldm_tpu.") or a == "omldm_tpu" for a in argv)


def test_policies_require_checkpoint_dir(tmp_path):
    P = port_supervisor
    with pytest.raises(ValueError, match="checkpointDir"):
        P.DistributedJobSupervisor(["--trainingData", "x.jsonl"], 1,
                                   autoscale=_autoscale("port"), run_dir=str(tmp_path))
    with pytest.raises(ValueError, match="slotStrikes"):
        P.DistributedJobSupervisor(["--trainingData", "x.jsonl"], 2,
                                   selfheal=_heal("port"), run_dir=str(tmp_path))
    with pytest.raises(SystemExit, match="checkpointDir"):
        P.supervise_from_flags({"autoscale": "true", "processes": "1"})
    with pytest.raises(SystemExit, match="slotStrikes"):
        P.supervise_from_flags({"slotStrikes": "2", "processes": "2"})


def test_fleet_pressure_folds_beats(tmp_path):
    """Missing beats read UNKNOWN, a two-token beat its level, a torn or
    one-token beat level 0, a frame's signals fold max / sum -- the JAX
    supervisor's fold on the same files."""
    sups = {pkg: _wired(pkg, tmp_path, autoscale=_autoscale(pkg)) for pkg in SUPERVISORS}
    for sup in sups.values():
        os.makedirs(sup.hb_dir)
    bodies = [(None, None), ("123.0 0", None), ("123.0 0", "123.0 2"), ("123.0 0", "123.0"),
              ("1.0 1 serveP99=30.5 backlog=7", "1.0 0 serveP99=12 backlog=5 imbalance=x"),
              ("garbled body", "1.0 2 serveP99=4")]
    for b0, b1 in bodies:
        seen = {}
        for pkg, sup in sups.items():
            for pid, body in ((0, b0), (1, b1)):
                path = os.path.join(sup.hb_dir, f"proc{pid}.hb")
                if body is None:
                    if os.path.exists(path):
                        os.unlink(path)
                else:
                    with open(path, "w") as f:
                        f.write(body)
            seen[pkg] = (sup.fleet_pressure(), sup.fleet_signals())
        assert seen["port"] == seen["jax"], (b0, b1)
    assert sups["port"].fleet_pressure() == 2


def test_classify_exits_matches_jax(tmp_path):
    """A survivor's HANG_EXIT blames the wedged peer; a never-beat exit is a
    launch failure, a beaten one a crash -- in both packages."""
    sups = {pkg: _wired(pkg, tmp_path, selfheal=_heal(pkg)) for pkg in SUPERVISORS}
    for sup in sups.values():
        os.makedirs(sup.hb_dir, exist_ok=True)
        with open(os.path.join(sup.hb_dir, "proc0.hb"), "w") as f:
            f.write("123.0 0")
    for codes, bad in (([19, None], [0]), ([3, 3], [0, 1]), ([None, 3], [1]),
                       ([19, 3], [0, 1])):
        got = {pkg: sup._classify_exits(codes, bad) for pkg, sup in sups.items()}
        a, b = got["port"], got["jax"]
        assert (a.cause, a.returncode, a.failed, a.kinds, a.kind()) == (
            b.cause, b.returncode, b.failed, b.kinds, b.kind()), codes
    wedged = sups["port"]._classify_exits([19, None], [0])
    assert wedged.failed == [1] and wedged.kinds == {1: "hang"}
    assert "blaming wedged process 1" in wedged.cause
    mixed = sups["port"]._classify_exits([3, 3], [0, 1])
    assert mixed.kinds == {0: "crash", 1: "launch"} and mixed.kind() == "launch"


def test_strikes_degrade_without_burning_attempts(tmp_path):
    results = {}
    for pkg, mod in SUPERVISORS.items():
        sup = _wired(pkg, tmp_path, selfheal=_heal(pkg), blackbox_dir=str(tmp_path / pkg / "bb"))
        fail = mod.FleetFailure("p1 died", 3, [1], kinds={1: "crash"})
        first = sup._note_strikes(fail)       # strike 1: restart
        target = sup._note_strikes(fail)      # strike 2: degrade
        sup._apply_degrade(fail, target)
        with open(os.path.join(sup.run_dir, "STRIKES")) as f:
            strikes = json.load(f)
        kinds = [e["kind"] for e in sup.journal.events]
        results[pkg] = (first, target, sup.nproc, len(sup.failures),
                        [(d.from_procs, d.to_procs, d.slots, d.kind) for d in sup.degrades],
                        kinds, strikes, [os.path.basename(b) for b in sup.bundles])
    assert results["port"] == results["jax"]
    first, target, nproc, failures, degrades, kinds, strikes, bundles = results["port"]
    assert first is None and target == 1 and nproc == 1 and failures == 0
    assert degrades == [(2, 1, [1], "crash")]
    assert kinds.count("strike") == 2 and "degrade" in kinds
    assert strikes["degradedBy"] == 1 and bundles == ["incident-0.json"]


def test_degraded_worker_argv_carries_the_gauge(tmp_path):
    sup = _wired("port", tmp_path, selfheal=_heal("port"))
    tail = _argv_tail(sup)
    assert tail[tail.index("--fleetDegraded") + 1] == "0"
    sup.selfheal.degraded_by = 1
    sup.nproc = 1
    tail = _argv_tail(sup, restore=True)
    assert tail[tail.index("--fleetDegraded") + 1] == "1"


def test_hang_exit_code_distinct():
    assert port_selfheal.HANG_EXIT == jax_selfheal.HANG_EXIT
    assert port_selfheal.HANG_EXIT not in (
        0, port_supervisor.RESCALE_EXIT, port_supervisor.DistributedFaultInjector.EXIT_CODE)


def test_restart_policy_knobs_reach_the_backoff(tmp_path):
    """The fleet supervisor restarts under RestartPolicy with growth, jitter
    and seed: the same seeded delay schedule as the JAX package's."""
    for pkg in SELFHEAL:
        pol = SELFHEAL[pkg].RestartPolicy(max_restarts=4, base_delay_s=0.5, growth=3.0,
                                          jitter_s=0.25, seed=11)
        rng = pol.rng()
        delays = [pol.backoff().delay(k, rng) for k in range(4)]
        if pkg == "jax":
            jax_delays = delays
        else:
            assert delays == jax_delays


# --- heartbeat frames and the host signals (tests/test_telemetry.py's fleet
# cases: TestHeartbeatFrames on the supervisor, TestAutoscaleHostSignal) ------


def _write_beat(sup, pid, body):
    os.makedirs(sup.hb_dir, exist_ok=True)
    with open(os.path.join(sup.hb_dir, f"proc{pid}.hb"), "w") as f:
        f.write(body)


@pytest.mark.parametrize("pkg", sorted(SUPERVISORS))
def test_rich_frame_parses(pkg, tmp_path):
    sup = _wired(pkg, tmp_path, autoscale=_autoscale(pkg))
    _write_beat(sup, 0, "123.0 1 serveP99=42.5 imbalance=7.25 backlog=900")
    assert sup._beat_frame(0) == {"level": 1.0, "serveP99": 42.5, "imbalance": 7.25,
                                  "backlog": 900.0, "events": 0.0, "alerts": 0.0}
    assert sup._beat_level(0) == 1
    _write_beat(sup, 0, "123.0 1 serveP99=1 events=37 alerts=2")
    frame = sup._beat_frame(0)
    assert frame["events"] == 37.0 and frame["alerts"] == 2.0


@pytest.mark.parametrize("pkg", sorted(SUPERVISORS))
def test_legacy_and_torn_frames_degrade(pkg, tmp_path):
    sup = _wired(pkg, tmp_path, autoscale=_autoscale(pkg))
    _write_beat(sup, 0, "123.0 2")        # two tokens
    assert sup._beat_frame(0)["level"] == 2.0 and sup._beat_frame(0)["serveP99"] == 0.0
    _write_beat(sup, 0, "123.0")          # a bare epoch
    assert sup._beat_frame(0)["level"] == 0.0
    _write_beat(sup, 0, "123.0 garb=")    # a torn level token
    assert sup._beat_frame(0)["level"] == 0.0
    _write_beat(sup, 0, "123.0 1 serveP99=4x2 backlog=10")  # one torn kv token
    frame = sup._beat_frame(0)
    assert frame["serveP99"] == 0.0 and frame["backlog"] == 10.0
    assert sup._beat_frame(1) is None     # never beat


def test_worker_frame_rides_the_beat_file(tmp_path):
    """The worker writes the frame the supervisor reads: the port's
    ``_heartbeat`` and the JAX one write the same tokens."""
    from omldm_tpu.runtime.distributed_job import _heartbeat as jax_heartbeat
    from omldm_tpu_torch.runtime.distributed_job import _heartbeat

    frame = {"level": 2, "serveP99": 12.5, "imbalance": 0.0, "backlog": 44}
    for name, beat in (("port", _heartbeat), ("jax", jax_heartbeat)):
        flags = {"heartbeatDir": str(tmp_path / f"beats_{name}")}
        assert beat(flags, 0, frame) in (True, None)
        beat(flags, 1, 1)
    for pid in (0, 1):
        port = (tmp_path / "beats_port" / f"proc{pid}.hb").read_text().split()[1:]
        jax = (tmp_path / "beats_jax" / f"proc{pid}.hb").read_text().split()[1:]
        assert port == jax
    sup = _wired("port", tmp_path, autoscale=_autoscale("port"))
    shutil.copytree(tmp_path / "beats_port", sup.hb_dir)
    assert sup.fleet_signals() == {"level": 2.0, "serveP99": 12.5, "imbalance": 0.0,
                                   "backlog": 44.0}


@pytest.mark.parametrize("pkg", sorted(SUPERVISORS))
def test_p99_and_imbalance_thresholds_flip_decisions(pkg):
    mod = SUPERVISORS[pkg]
    kw = dict(min_processes=1, max_processes=8, up_after_s=1.0, down_after_s=60.0,
              cooldown_s=0.1)
    hot = {"serveP99": 120.0, "imbalance": 0.0, "backlog": 0.0}
    base = mod.AutoscalePolicy(**kw)  # the backlog level alone holds
    assert base.decide(2, 0, 0.0, signals=hot) is None
    assert base.decide(2, 0, 2.0, signals=hot) is None
    armed = mod.AutoscalePolicy(serve_p99_critical_ms=100.0, **kw)
    assert armed.decide(2, 0, 0.0, signals=hot) is None
    assert armed.decide(2, 0, 1.5, signals=hot) == 4
    skew = {"serveP99": 0.0, "imbalance": 300.0, "backlog": 0.0}
    p = mod.AutoscalePolicy(imbalance_critical=256.0, **kw)
    assert p.decide(2, 0, 0.0, signals=skew) is None
    assert p.decide(2, 0, 1.5, signals=skew) == 4
    assert p.effective_level(-1, None) == -1


@pytest.mark.parametrize("pkg", sorted(SUPERVISORS))
def test_supervisor_folds_frames_into_decision(pkg, tmp_path):
    mod = SUPERVISORS[pkg]
    policy = mod.AutoscalePolicy(min_processes=1, max_processes=8, up_after_s=1.0,
                                 down_after_s=60.0, cooldown_s=0.1,
                                 serve_p99_critical_ms=100.0)
    sup = _wired(pkg, tmp_path, autoscale=policy)
    for pid in (0, 1):
        _write_beat(sup, pid, "123.0 0 serveP99=150 imbalance=0 backlog=0")
    level, signals = sup.fleet_pressure(), sup.fleet_signals()
    assert level == 0  # the backlog alone says calm
    assert policy.effective_level(level, signals) == 2
    assert policy.decide(2, level, 0.0, signals=signals) is None
    assert policy.decide(2, level, 1.5, signals=signals) == 4
