"""The ring engine (``models/epidemic.py``) against the JAX package, on the
CPU, with exact equality (all state is integer and the randomness
counter-based):

* the three deposit kernels' plain versions against the JAX package's
  Pallas kernels (Pallas's generic interpreter, as ``test_torch_ops.py``
  runs them) and against its XLA chains;
* the crash-probability table against ``jnp.power``;
* the rumor-word packing;
* the engine-agnostic ``in_flight`` and ``removed_count``;
* a mid-run JAX ``SimState`` carried into the port continuing one window
  to identical leaves and Stats, for every engine setting of the slice;
* the config rules of the slice.

The whole runs twin the JAX package's CLI in ``test_torch_ring_cli.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.models import epidemic as jepi
from gossip_simulator_tpu.ops import pallas_deliver as jdeliver
from gossip_simulator_tpu.ops import pallas_megakernel as jmk
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.backends import (DeviceUnavailable,
                                                 TorchStepper)
from gossip_simulator_tpu_torch.models import epidemic as tepi
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.models.state import in_flight
from gossip_simulator_tpu_torch.ops import _build, deliver, megakernel
from gossip_simulator_tpu_torch.utils import interop
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_card import DEPOSIT_FNS, _deposit, _deposit_inputs
from test_torch_rng import match_jax_threefry

T = torch.from_numpy
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.fixture(autouse=True)
def generic_interpreter(monkeypatch):
    monkeypatch.setattr(jmk, "_interpret_param", bool)
    monkeypatch.setattr(jdeliver, "_interpret_param", bool)


# --- the deposits ----------------------------------------------------------


def _jax_deposit(kind, d, pallas: bool):
    """The JAX package's deposit of `kind`: its Pallas kernel (generic
    interpreter) or its XLA chain."""
    j = {k: jnp.asarray(v) for k, v in d.items()}
    if kind == "add":
        out = (jdeliver.fused_deposit_add(j["pending"], j["slots"],
                                          j["dst_n"], interpret=True)
               if pallas else j["pending"].at[j["slots"], j["dst_n"]].add(
                   1, mode="drop"))
        return [out]
    if kind == "rows":
        out = (jdeliver.fused_deposit_rows(j["prum"], j["slots"], j["dst_n"],
                                           j["vals"], interpret=True)
               if pallas else j["prum"].at[j["slots"], j["dst_n"]].add(
                   j["vals"], mode="drop"))
        return [out]
    if pallas:
        return list(jmk.fused_deposit_both(
            j["pending"], j["prum"], j["dst"], j["slots"], j["valid"],
            j["newbits"], interpret=True))
    return [jepi.deposit_local(j["pending"], j["dst"], j["slots"],
                               j["valid"]),
            jepi.deposit_rumors(j["prum"], j["dst"], j["slots"], j["valid"],
                                j["newbits"])]


DEPOSIT_CASES = {
    "r5": dict(), "r16": dict(r=16, n=300, k=6),
    "r33_two_words": dict(r=33, n=200, k=5),
    "ragged": dict(rows=333, k=6, r=16),
}


@pytest.mark.parametrize("kind", sorted(DEPOSIT_FNS))
@pytest.mark.parametrize("case", sorted(DEPOSIT_CASES))
def test_deposit_plain_matches_pallas_and_xla(case, kind):
    d = _deposit_inputs(3, **DEPOSIT_CASES[case])
    plain, wrapper = DEPOSIT_FNS[kind]
    got = _deposit(kind, plain, d, CPU)
    assert [torch.equal(g, w) for g, w in zip(
        got, _deposit(kind, wrapper, d, CPU))] == [True] * len(got)
    for pallas in (True, False):
        want = _jax_deposit(kind, d, pallas)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy()), (kind, pallas)


@pytest.mark.parametrize("case", sorted(DEPOSIT_CASES))
def test_deposit_add_plain_with_valid_matches_jax(case):
    """deposit_add_plain given the mask itself (as fused_deposit_add takes
    it on the kernel path, without the caller's dst = n pass) against the
    JAX package's deposit_local chain and its Pallas kernel on the dst = n
    lanes (generic interpreter), and against the wrapper on the CPU."""
    d = _deposit_inputs(9, **DEPOSIT_CASES[case])
    got = deliver.deposit_add_plain(T(d["pending"].copy()), T(d["slots"]),
                                    T(d["dst"]), T(d["valid"]))
    wrapped = deliver.fused_deposit_add(T(d["pending"].copy()),
                                        T(d["slots"]), T(d["dst"]),
                                        T(d["valid"]))
    j = {k: jnp.asarray(v) for k, v in d.items()}
    chain = jepi.deposit_local(j["pending"], j["dst"], j["slots"],
                               j["valid"])
    kernel = jdeliver.fused_deposit_add(j["pending"], j["slots"],
                                        j["dst_n"], interpret=True)
    assert torch.equal(got, wrapped)
    assert np.array_equal(np.asarray(chain), got.numpy())
    assert np.array_equal(np.asarray(kernel), got.numpy())


@pytest.mark.parametrize("kernel", ("pallas", "xla"))
@pytest.mark.parametrize("r", (16, 33))
def test_engine_deposits_match_jax(r, kernel):
    """epidemic.deposit_local / deposit_rumors, both gates, against the
    JAX package's (its xla gate: the two gates are pinned equal)."""
    d = _deposit_inputs(5, r=r, n=400, k=6)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want_p = jepi.deposit_local(j["pending"], j["dst"], j["slots"],
                                j["valid"])
    want_r = jepi.deposit_rumors(j["prum"], j["dst"], j["slots"], j["valid"],
                                 j["newbits"])
    got_p = tepi.deposit_local(T(d["pending"].copy()), T(d["dst"]),
                               T(d["slots"]), T(d["valid"]), kernel=kernel)
    got_r = tepi.deposit_rumors(T(d["prum"].copy()), T(d["dst"]),
                                T(d["slots"]), T(d["valid"]),
                                T(d["newbits"]), kernel=kernel)
    assert np.array_equal(np.asarray(want_p), got_p.numpy())
    assert np.array_equal(np.asarray(want_r), got_r.numpy())


def test_deposits_on_cpu_never_launch():
    _build.reset_launches()
    d = _deposit_inputs(1)
    for kind, (_, wrapper) in DEPOSIT_FNS.items():
        _deposit(kind, wrapper, d, CPU)
    assert not any(_build.LAUNCHES.values())


def test_deposit_wrappers_refuse_bad_inputs():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="pending must be int32 2-D"):
        deliver.fused_deposit_add(torch.zeros(4, dtype=torch.int32), z, z)
    with pytest.raises(ValueError, match="vals must be int32"):
        deliver.fused_deposit_rows(
            torch.zeros((2, 3, 5), dtype=torch.int32), z, z,
            torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="not k lanes"):
        megakernel.fused_deposit_both(
            torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((2, 3, 5), dtype=torch.int32), z, z, z > 0,
            torch.zeros((3, 5), dtype=torch.bool))


# --- crash table, rumor words, state helpers --------------------------------


@pytest.mark.parametrize("p", (0.001, 0.002, 0.005, 0.01, 0.1, 0.2, 0.3,
                               0.5, 1.0))
def test_crash_table_matches_jnp_power(p):
    """The table's bits equal the JAX package's float32 1 - (1 - p)^c on
    every entry, up to the first 1.0f where it ends (ROADMAP C3: both
    call the C library's powf)."""
    table = tepi.crash_table(p)
    c = np.arange(table.size)
    want = np.asarray(jax.jit(lambda x: 1.0 - jnp.power(1.0 - p, x))(
        jnp.asarray(c, jnp.float32)))
    got = tepi.CrashDraw(p).pc(torch.from_numpy(c.astype(np.int32)))
    assert got.dtype == torch.float32
    assert np.array_equal(want.view(np.uint32), got.numpy().view(np.uint32))
    assert np.array_equal(want.view(np.uint32), table.view(np.uint32))
    assert table[-1] == np.float32(1.0)
    assert (table[:-1] < np.float32(1.0)).all()


@pytest.mark.parametrize("p,parts", (
    (0.001, []), (0.002, []), (0.005, []), (0.01, []),
    (0.05, []), (0.1, []), (0.2, []), (0.5, [])))
def test_crash_table_parts_from_jnp_power_only_at_known_counts(p, parts):
    """Up to c = 100,000 arrivals (past the table's end the probability is
    1.0f), the counts whose bits differ from the reference's float32
    power: none since ROADMAP C3's repair (before it, a float64 power
    parted at c = 2958 and 3606 for p = 0.001, 516 for 0.002, 367 for
    0.005)."""
    c = np.arange(100_000)
    want = np.asarray(jax.jit(lambda x: 1.0 - jnp.power(1.0 - p, x))(
        jnp.asarray(c, jnp.float32)))
    got = tepi.CrashDraw(p).pc(torch.from_numpy(c.astype(np.int32))).numpy()
    differ = np.flatnonzero(want.view(np.uint32) != got.view(np.uint32))
    assert differ.tolist() == parts


@pytest.mark.parametrize("r", (16, 33))
def test_rumor_bits_round_trip(r):
    bits = np.random.default_rng(r).random((50, r)) < 0.3
    w = (r + 31) // 32
    jw = jepi.pack_rumor_bits(jnp.asarray(bits), w)
    tw = tepi.pack_rumor_bits(T(bits), w)
    assert np.array_equal(np.asarray(jw).astype(np.int64), tw.numpy())
    assert np.array_equal(np.asarray(jepi.unpack_rumor_bits(jw, r)),
                          tepi.unpack_rumor_bits(tw, r).numpy())
    assert np.array_equal(tepi.unpack_rumor_bits(tw, r).numpy(), bits)


def test_in_flight_and_removed_count_on_both_engines():
    cfg = tcfg.Config(n=50, fanout=3, graph="kout",
                      protocol="sir").validate()
    friends = torch.zeros((50, 3), dtype=torch.int32)
    cnt = torch.full((50,), 3, dtype=torch.int32)
    ring, ev = tepi.init_state(cfg, friends, cnt), tevent.init_state(
        cfg, friends, cnt)
    for st in (ring, ev):
        assert not bool(in_flight(st))
        assert int(tevent.removed_count(st)) == 0
    ring.pending[3, 7] = 2
    assert bool(in_flight(ring))
    ring.pending.zero_()
    ring.rebroadcast[1, 9] = True
    assert bool(in_flight(ring))
    ev.sup_cnt[0, 1] = 1
    assert bool(in_flight(ev))
    ring.removed[[2, 5, 6]] = True
    ev.flags[[1, 4]] = tevent.REMOVED | tevent.RECEIVED
    ev.flags[50] = tevent.REMOVED  # the trash cell counts nothing
    assert int(tevent.removed_count(ring)) == 3
    assert int(tevent.removed_count(ev)) == 2


# --- a JAX state continues in the port ---------------------------------------

BASE = dict(n=1000, fanout=6, graph="kout", seed=4, progress=False)
CONTINUE = {
    "si_compact": (dict(engine="ring"), 3),
    "si_dense": (dict(engine="ring", compact="off"), 3),
    "sir": (dict(engine="ring", protocol="sir", removal_rate=0.3,
                 droprate=0.3), 3),
    "rounds": (dict(time_mode="rounds"), 2),
    "pushpull": (dict(protocol="pushpull", fanout=10), 2),
    "pushpull_dense": (dict(protocol="pushpull", fanout=10, compact="off"),
                       2),
    "rumors16": (dict(engine="ring", rumors=16, crashrate=0.0,
                      coverage_target=0.95), 3),
}
GATES = {"default": {}, "p2_xla": dict(phase2_kernel="xla"),
         "all_xla": dict(phase2_kernel="xla", deliver_kernel="xla")}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """JAX package: `windows` windows, then its state and one more
    window's Stats and state."""
    kw, windows = CONTINUE[case]
    s = JaxStepper(jcfg.Config(**{**BASE, **kw}).validate())
    s.init()
    assert s.overlay_window()[2]
    s.seed()
    for _ in range(windows):
        s.gossip_window()
    tree = s.state_pytree()
    stats = s.gossip_window().to_dict()
    return tree, stats, s.state_pytree(), s.sim_time_ms()


@pytest.mark.parametrize("case,gate", [(c, "default") for c in CONTINUE]
                         + [("rumors16", "p2_xla"), ("rumors16", "all_xla")])
def test_jax_state_continues_in_port(case, gate):
    tree, want_stats, want_tree, want_ms = _jax_run(case)
    # The interop round trip is lossless.
    back = interop.sim_state_to_numpy(
        interop.sim_state_from_numpy(tree, "cpu"))
    for key, val in back.items():
        assert val.dtype == np.asarray(tree[key]).dtype, key
        assert np.array_equal(val, tree[key]), key
    kw, _ = CONTINUE[case]
    ts = TorchStepper(tcfg.Config(**{**BASE, **kw, **GATES[gate]}).validate(),
                      device="cpu")
    ts.init()
    ts.load_state_pytree(tree)
    assert ts.gossip_window().to_dict() == want_stats
    got = ts.state_pytree()
    assert set(got) == set(want_tree)
    for key in want_tree:
        assert np.asarray(want_tree[key]).dtype == got[key].dtype, key
        assert np.array_equal(want_tree[key], got[key]), key
    assert ts.sim_time_ms() == want_ms


def test_state_geometry_mismatch_is_named():
    tree = _jax_run("si_compact")[0]
    ts = TorchStepper(tcfg.Config(**{**BASE, "delayhigh": 25},
                                  engine="ring").validate(), device="cpu")
    ts.init()
    # The reference's restore check (utils/checkpoint.py) names the ring.
    with pytest.raises(ValueError, match="checkpoint delay ring"):
        ts.load_state_pytree(tree)


# --- config ------------------------------------------------------------------


@pytest.mark.parametrize("flags", (
    ["-time-mode", "rounds"], ["-engine", "ring"], ["-compact", "off"],
    ["-compact", "on", "-protocol", "sir"], ["-protocol", "pushpull"],
    ["-engine", "ring", "-rumors", "16"],
    ["-engine", "ring", "-rumors", "1024"]))
def test_slice_flags_validate_and_need_the_card(flags):
    """The slice's flags parse, resolve to the ring engine, and without
    -device run on cuda: on a host without a card they raise by name."""
    cfg, device = tcfg.parse_cli(["-graph", "kout", "-n", "100"] + flags)
    assert cfg.engine_resolved == "ring" and device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        TorchStepper(cfg)


@pytest.mark.parametrize("flags,match", (
    # The event engine's rumor axis runs on one device (A11) and on the
    # sharded backend (A13.2), after the sharded overlay too (A13.4);
    # -distributed does not.
    (["-engine", "event", "-rumors", "4", "-backend", "sharded",
      "-distributed"], r"not yet ported \(ROADMAP A13\)"),
    (["-traffic", "stream", "-backend", "sharded", "-graph", "overlay",
      "-distributed"], r"not yet ported \(ROADMAP A13\)"),
    (["-engine", "ring", "-traffic", "stream"], "requires the event engine"),
    (["-engine", "ring", "-rumors", "4", "-protocol", "sir"],
     "protocol=si only"),
    (["-engine", "ring", "-rumors", "4", "-time-mode", "rounds"],
     "require -time-mode ticks"),
    (["-engine", "ring", "-rumors", "1025"], r"rumors must be in \[1, 1024\]"),
    (["-engine", "event", "-time-mode", "rounds"], "engine=event supports"),
    (["-engine", "ring", "-rumors", "4", "-overlay-heal", "on"],
     "ring-engine heal re-sends are single-rumor"),
    # Push-pull on -graph erdos is ported (A3), on the sharded backend too
    # (A13.4); across processes it is not.
    (["-protocol", "pushpull", "-graph", "erdos", "-backend", "sharded",
      "-distributed"], r"ROADMAP A13")))
def test_slice_rules_match_the_jax_package(flags, match):
    argv = ["-graph", "kout", "-n", "100"] + flags
    with pytest.raises(ValueError, match=match):
        tcfg.parse_cli(argv)
    if "not yet ported" not in match and "ROADMAP" not in match:
        with pytest.raises(ValueError, match=match):
            jcfg.parse_args(argv)
