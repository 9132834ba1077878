"""The port's fault-scenario helpers (``gossip_simulator_tpu_torch/
scenario.py``) against the JAX package's ``scenario.py``, exactly, on
inputs made with numpy from a seed: the parser and its errors, the
window's crash/churn/recovery pass (``fault_window``, including float32
thresholds whose rounding differs from the double's), the send-time
partition mask, the failure detector and one healing pass
(``heal_and_wave``: repair, re-send, rejoin pull)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu import scenario as jscen
from gossip_simulator_tpu.utils import rng as jrng
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch import scenario as tscen
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


CHURN = ('{"groups": 2, "downtime": 60, "events": ['
         '{"type": "churn", "start": 0, "end": 150, "rate": 2.0},'
         '{"type": "crash", "at": 30, "frac": 0.3, "group": 1},'
         '{"type": "partition", "start": 20, "end": 60}]}')
SPECS = {
    "off": "off", "empty": "", "inert": "{}", "churn": CHURN,
    "groups3": ('{"groups": 3, "downtime": 0, "events": ['
                '{"type": "crash", "at": 5, "frac": 0.5},'
                '{"type": "churn", "start": 3, "end": 9, "rate": 900, '
                '"group": 2},'
                '{"type": "partition", "start": 0, "end": 5, "group": 1},'
                '{"type": "partition", "start": 4, "end": 8}]}'),
}


def _fields(scen):
    """A Scenario's values (the two packages' classes differ)."""
    return dataclasses.astuple(scen)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_parse_matches(name):
    j, t = jscen.parse(SPECS[name]), tscen.parse(SPECS[name])
    assert _fields(j) == _fields(t)
    assert (j.has_faults, j.has_partitions, j.active) == (
        t.has_faults, t.has_partitions, t.active)


def test_parse_reads_a_timeline_file(tmp_path):
    path = tmp_path / "timeline.json"
    path.write_text(CHURN)
    assert tscen.parse(str(path)) == tscen.parse(CHURN)
    assert _fields(jscen.parse(str(path))) == _fields(
        tscen.parse(str(path)))


BAD = {
    "json": "{not json", "array": "[1, 2]", "missing_file": "no/such.json",
    "unknown_key": '{"groups": 2, "when": 3}',
    "no_type": '{"events": [{"at": 3}]}',
    "bad_type": '{"events": [{"type": "flood"}]}',
    "missing_field": '{"events": [{"type": "crash", "at": 3}]}',
    "groups0": '{"groups": 0}', "downtime": '{"downtime": -1}',
    "frac": '{"events": [{"type": "crash", "at": 3, "frac": 1.5}]}',
    "at": '{"events": [{"type": "crash", "at": -3, "frac": 0.5}]}',
    "churn_window": '{"events": [{"type": "churn", "start": 5, "end": 5, '
                    '"rate": 1}]}',
    "rate": '{"events": [{"type": "churn", "start": 0, "end": 5, '
            '"rate": 2000}]}',
    "part_window": '{"groups": 2, "events": [{"type": "partition", '
                   '"start": 9, "end": 3}]}',
    "group_range": '{"groups": 2, "events": [{"type": "crash", "at": 1, '
                   '"frac": 0.1, "group": 2}]}',
    "one_group": '{"events": [{"type": "partition", "start": 0, '
                 '"end": 3}]}',
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_parse_errors_match(name):
    with pytest.raises(ValueError) as je:
        jscen.parse(BAD[name])
    with pytest.raises(ValueError) as te:
        tscen.parse(BAD[name])
    assert str(je.value) == str(te.value)


def _state(seed, n, crashed=0.3, rebooted=0.1, t_hi=200):
    """Crashed flags, crash ticks (-1 live, -(t+2) rebooted) and ids."""
    rng = np.random.default_rng(seed)
    c = rng.random(n) < crashed
    down = np.where(c, rng.integers(0, t_hi, n), -1).astype(np.int32)
    reb = ~c & (rng.random(n) < rebooted)
    down[reb] = -(rng.integers(0, t_hi, int(reb.sum())) + 2)
    return c, down, np.arange(n, dtype=np.int32)


def _fault_window(spec, n, tick0, nticks, c, down, ids, seed=5):
    scen_j, scen_t = jscen.parse(spec), tscen.parse(spec)
    j = jscen.fault_window(scen_j, n, jnp.int32(tick0), nticks,
                           jnp.asarray(ids), jnp.asarray(c),
                           jnp.asarray(down), jrng.base_key(seed))
    t = tscen.fault_window(scen_t, n, tick0, nticks, T(ids), T(c),
                           T(down.copy()), trng.base_key(seed))
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("tick0,nticks", ((0, 10), (20, 10), (30, 10),
                                          (140, 10), (150, 10), (31, 1),
                                          (29, 1), (100, 1)))
@pytest.mark.parametrize("name", ("churn", "groups3"))
def test_fault_window_matches(name, tick0, nticks):
    n = 5000
    c, down, ids = _state(tick0 + nticks, n)
    want, got = _fault_window(SPECS[name], n, tick0, nticks, c, down, ids)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


def _uniforms(widx, idx, n, seed=5):
    """The reference's per-node uniforms of event idx in window widx."""
    key = jscen._event_keys(jrng.base_key(seed), jnp.int32(widx), idx)
    return np.asarray(jscen._row_uniform(key, jnp.arange(n,
                                                          dtype=jnp.int32)))


def test_fault_window_thresholds_round_to_float32():
    """A crash frac and a churn rate whose float32 rounding puts some
    node's uniform on the other side of the threshold than the double
    would: the port compares as XLA does, in float32."""
    n, tick0 = 4000, 10
    u = _uniforms(tick0, 0, n)
    # frac just above a drawn uniform: float32(frac) == that uniform.
    j = int(np.argmax((u > 0.2) & (u < 0.8)))
    frac = float(u[j]) + 1e-12
    assert np.float32(frac) == u[j] and float(u[j]) < frac
    spec = json.dumps({"events": [{"type": "crash", "at": tick0,
                                   "frac": frac}]})
    c, down, ids = np.zeros(n, bool), np.full(n, -1, np.int32), \
        np.arange(n, dtype=np.int32)
    want, got = _fault_window(spec, n, tick0, 1, c, down, ids)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert not got[0][j]  # the double comparison would crash node j
    # A churn rate whose float32 product with the overlap lands on a
    # drawn uniform while the double product passes it.
    uc = _uniforms(tick0, 0, n)
    overlap = 7
    found = None
    for i in np.argsort(uc)[n // 4: 3 * n // 4]:
        rate = float(uc[i]) / overlap * 1000.0 * (1 + 3e-9)
        p32 = np.float32(overlap) * np.float32(rate / 1000.0)
        p64 = overlap * (rate / 1000.0)
        if (uc[i] < p32) != (float(uc[i]) < p64):
            found = (int(i), rate, bool(uc[i] < p32))
            break
    assert found is not None
    i, rate, crashes = found
    spec = json.dumps({"events": [{"type": "churn", "start": tick0,
                                   "end": tick0 + overlap, "rate": rate}]})
    want, got = _fault_window(spec, n, tick0, 10, c, down, ids)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert bool(got[0][i]) == crashes


@pytest.mark.parametrize("tick", (0, 10, 25, 59, 60, 100))
@pytest.mark.parametrize("name", ("churn", "groups3"))
def test_partition_blocked_matches(name, tick):
    n, m, k = 3001, 400, 7
    rng = np.random.default_rng(tick)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(-1, n, (m, k)).astype(np.int32)
    sticks = (tick + rng.integers(0, 10, m)).astype(np.int32)
    sj, st = jscen.parse(SPECS[name]), tscen.parse(SPECS[name])
    # A scalar send tick (the ring engine's wave) and per-sender ticks
    # (the event engine's appends).
    want = jscen.partition_blocked(sj, n, tick, jnp.asarray(src)[:, None],
                                   jnp.asarray(dst))
    got = tscen.partition_blocked(st, n, tick, T(src)[:, None], T(dst))
    assert np.array_equal(np.asarray(want), got.numpy())
    want = jscen.partition_blocked(sj, n, jnp.asarray(sticks)[:, None],
                                   jnp.asarray(src)[:, None],
                                   jnp.asarray(dst))
    got = tscen.partition_blocked(st, n, T(sticks)[:, None],
                                  T(src)[:, None], T(dst))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_detect_dead_and_rejoined_match():
    c, down, _ = _state(3, 2000)
    for tick, detect in ((50, 30), (200, 0), (10, 100)):
        want = jscen.detect_dead(jnp.asarray(c), jnp.asarray(down), tick,
                                 detect)
        got = tscen.detect_dead(T(c), T(down), tick, detect)
        assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(np.asarray(jscen.rejoined_mask(jnp.asarray(down))),
                          tscen.rejoined_mask(T(down)).numpy())
    assert np.array_equal(np.asarray(jscen.init_down_since(True, 5)),
                          tscen.init_down_since(True, 5).numpy())
    assert tscen.down_shape(False, 5) == jscen.down_shape(False, 5) == 1


HEAL = {
    "ticks": dict(),
    "ticks_partition": dict(scenario=CHURN),
    "rounds": dict(time_mode="rounds", scenario=CHURN),
    "compat_drop": dict(compat_reference=True, droprate=0.137),
    "no_drop": dict(droprate=0.0),
}


@pytest.mark.parametrize("tick", (30, 40))
@pytest.mark.parametrize("case", sorted(HEAL))
def test_heal_and_wave_matches(case, tick):
    n, k = 3000, 6
    kw = dict(n=n, fanout=k, graph="kout", overlay_heal="on", seed=2,
              **HEAL[case])
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    rng = np.random.default_rng(tick)
    friends = rng.integers(0, n, (n, k)).astype(np.int32)
    cnt = rng.integers(k - 2, k + 1, n).astype(np.int32)
    friends[np.arange(k)[None, :] >= cnt[:, None]] = -1
    c, down, ids = _state(tick, n, crashed=0.2)
    detected = jscen.detect_dead(jnp.asarray(c), jnp.asarray(down), tick,
                                 jc.heal_detect_ms)
    inf = ~c & (rng.random(n) < 0.5)
    bits_j = jscen.heal_peer_bits(detected, jnp.asarray(inf))
    bits_t = tscen.heal_peer_bits(T(np.array(detected)), T(inf))
    assert np.array_equal(np.asarray(bits_j), bits_t.numpy())
    rejoined = down <= -2
    want = jscen.heal_and_wave(
        jc, jnp.asarray(friends), jnp.asarray(cnt), bits_j,
        jnp.asarray(~c), jnp.asarray(inf), jnp.asarray(rejoined),
        jnp.asarray(ids), jnp.int32(tick), jrng.base_key(jc.seed))
    got = tscen.heal_and_wave(
        tc, T(friends.copy()), T(cnt), bits_t, T(~c), T(inf), T(rejoined),
        T(ids), tick, trng.base_key(tc.seed))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert int(got[5]) > 0 and int(got[2].sum()) > 0  # repairs and pulls
