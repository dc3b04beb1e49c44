"""The port's storm generator (omldm_tpu_torch/runtime/loadgen.py) against
the JAX package's on the same specs.

For each spec -- the load harness's default storm, a faulted one, a
perRecord one, churn-heavy and routed ones -- both ``LoadStorm``s must give
byte-identical data, request and schedule lines, event streams, the same
windows, exact accounting (fan-out and routed, with and without the
Update discard), fault flags, worker argv and files, fskafka topic logs,
and fingerprint. The tolerance is zero: same seed, same bytes."""

import os

import pytest

import omldm_tpu.runtime.loadgen as jax_lg
import omldm_tpu_torch.runtime.loadgen as port_lg
from omldm_tpu_torch.load_harness import default_storm_spec


def _fields(spec):
    return {k: getattr(spec, k) for k in port_lg.StormSpec.__dataclass_fields__}


def _spec_kwargs(name):
    """StormSpec kwargs for each case (faults as (kind, kwargs) pairs); the
    default storm's are the load harness's own (default_storm_spec)."""
    if name == "default":
        return _fields(default_storm_spec())
    if name == "per_record":
        return _fields(default_storm_spec(training_extra={"perRecord": True}))
    base = dict(seed=11, tenants=6, records=256, chunk_rows=32, n_features=4,
                forecast_ratio=0.4, churn_waves=2, churn_tenants_per_wave=2,
                churn_updates_per_wave=1)
    if name == "faulted":
        base.update(faults=(("launch", dict(process=1, count=2)),
                            ("crash", dict(process=0, at_records=128)),
                            ("hang", dict(process=1, at_chunks=3)),
                            ("chaos", dict(spec="seed=3,drop=0.1")),
                            ("sever", dict(at_chunks=5))),
                    protocol="Synchronous", training_extra={"syncEvery": 1,
                                                            "comm": {"codec": "int8"}})
    elif name == "routed":
        base.update(seed=3, tenants=9, records=300, hot_tenants=3, burst_every=40,
                    burst_len=6, addressed_fraction=0.35, diurnal_amplitude=0.8,
                    diurnal_period=75, hyper_parameters={"C": 0.5, "variant": "PA-II"})
    elif name == "churn_heavy":
        base.update(seed=21, tenants=4, records=513, chunk_rows=16, churn_waves=5,
                    churn_tenants_per_wave=3, churn_updates_per_wave=2,
                    learner="RegressorPA", n_features=7)
    return base


def make(mod, name):
    kw = _spec_kwargs(name)
    kw["faults"] = tuple(mod.FaultSpec(kind=k, **fkw) for k, fkw in kw.get("faults", ()))
    return mod.LoadStorm(mod.StormSpec(**kw))


NAMES = ["default", "faulted", "per_record", "routed", "churn_heavy"]


@pytest.mark.parametrize("name", NAMES)
def test_storm_bytes_match_jax(name):
    port, ref = make(port_lg, name), make(jax_lg, name)
    assert list(port.data_lines()) == list(ref.data_lines())
    assert port.request_lines() == ref.request_lines()
    assert port.schedule_lines() == ref.schedule_lines()
    assert list(port.events()) == list(ref.events())
    assert port.windows() == ref.windows()
    for routed in (False, True):
        for discards in (False, True):
            assert (port.expected_forecasts(routed=routed, update_discards=discards)
                    == ref.expected_forecasts(routed=routed, update_discards=discards))
    assert port.healthy_tenants() == ref.healthy_tenants()
    assert port.hot_tenant_ids() == ref.hot_tenant_ids()
    assert [vars(e) for e in port.churn] == [vars(e) for e in ref.churn]
    assert port.fingerprint() == ref.fingerprint()


@pytest.mark.parametrize("name", NAMES)
def test_fleet_rendering_matches_jax(name, tmp_path):
    port, ref = make(port_lg, name), make(jax_lg, name)
    assert port.fault_flags("STATE") == ref.fault_flags("STATE")
    # the argv names files under its out_dir: the two trees must hold the
    # same bytes under the same names
    pa = port.worker_args(str(tmp_path / "port"), checkpoint_every=2, extra=["--x", "1"])
    ja = ref.worker_args(str(tmp_path / "jax"), checkpoint_every=2, extra=["--x", "1"])
    assert [a.replace(str(tmp_path / "port"), "OUT") for a in pa] == \
        [a.replace(str(tmp_path / "jax"), "OUT") for a in ja]
    for fname in ("storm_data.jsonl", "storm_requests.jsonl", "storm_schedule.jsonl"):
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "jax" / fname).read_bytes()


@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("name", ["default", "faulted", "per_record"])
def test_preload_fskafka_matches_jax(name, partitions, tmp_path):
    port, ref = make(port_lg, name), make(jax_lg, name)
    pd, jd = tmp_path / "port", tmp_path / "jax"
    # a stale log from an earlier preload must be truncated by both
    for d in (pd, jd):
        d.mkdir()
        (d / "trainingData--9.log").write_text("stale\n")
    assert port.preload_fskafka(str(pd), partitions) == ref.preload_fskafka(str(jd), partitions)
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for fname in os.listdir(pd):
        assert (pd / fname).read_bytes() == (jd / fname).read_bytes(), fname


def test_seed_changes_fingerprint():
    a = port_lg.LoadStorm(default_storm_spec(seed=7))
    b = port_lg.LoadStorm(default_storm_spec(seed=8))
    assert a.fingerprint() != b.fingerprint()
    assert a.fingerprint() == jax_lg.LoadStorm(
        jax_lg.StormSpec(**_fields(default_storm_spec(seed=7)))).fingerprint()


@pytest.mark.parametrize("bad", [
    dict(tenants=0), dict(records=0), dict(chunk_rows=0),
    dict(forecast_ratio=1.5), dict(forecast_ratio=-0.1), dict(hot_tenants=99),
])
def test_invalid_specs_raise_as_jax(bad):
    for mod in (port_lg, jax_lg):
        with pytest.raises(ValueError):
            mod.StormSpec(**{**dict(seed=1, tenants=6, records=64), **bad})
    for mod in (port_lg, jax_lg):
        with pytest.raises(ValueError):
            mod.FaultSpec(kind="meteor")
