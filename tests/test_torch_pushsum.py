"""PushSum (``models/pushsum.py``) against the JAX package, on the CPU,
with exact equality -- integers and float32 bits alike:

* the fixed-point limb arithmetic, the float32 metric and the init values;
* the emission's seven outputs;
* the drain: the JAX package's Pallas ``fused_drain_sum`` (Pallas's
  generic interpreter, as ``test_torch_ops.py`` runs the kernels; it scans
  the whole slot, so cap stays <= 1000), the port's plain version and the
  JAX package's chunked ``deposit_sum`` chain;
* the wide ``fused_ring_append`` (PushSum's mass ring) against the Pallas
  kernel and the one-hot chain, overflow into the trash row included;
* ``deposit_sum`` under both gates;
* a mid-run JAX ``PushSumState`` carried into the port, continuing to
  identical Stats and leaves under each gate setting, with the mass
  conserved exactly in every window;
* the config rules of the slice.

The whole runs twin the JAX package's CLI in ``test_torch_pushsum_cli.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.models import pushsum as jps
from gossip_simulator_tpu.ops import mailbox as jmailbox
from gossip_simulator_tpu.ops import pallas_deliver as jdeliver
from gossip_simulator_tpu.ops import pallas_megakernel as jmk
from gossip_simulator_tpu.utils import rng as jrng
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.models import pushsum as tps
from gossip_simulator_tpu_torch.ops import _build, deliver, mailbox, megakernel
from gossip_simulator_tpu_torch.utils import interop
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_card import (_drain, _drain_inputs, _ring_append,
                             _ring_inputs)
from test_torch_rng import match_jax_threefry

T = torch.from_numpy
CPU = torch.device("cpu")
PS = dict(model="pushsum", graph="kout", droprate=0.0, crashrate=0.0,
          progress=False)


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


def _cfgs(**kw):
    base = dict(PS, n=500, fanout=6, seed=3)
    base.update(kw)
    return jcfg.Config(**base).validate(), tcfg.Config(**base).validate()


def _limbs(seed, shape, top=2**16):
    """Normalized random limbs (..., 4), a tenth of the rows zero."""
    rng = np.random.default_rng(seed)
    m3 = rng.integers(0, 2**16, shape + (tps.LIMBS,)).astype(np.int32)
    m3[..., -1] = rng.integers(0, top, shape)
    m3[rng.random(shape) < 0.1] = 0
    return m3


def _as_int(limbs) -> np.ndarray:
    """Python-int values of (..., 4) limbs (any per-limb range)."""
    a = np.asarray(limbs).astype(object)
    return sum(a[..., i] * (1 << (16 * i)) for i in range(tps.LIMBS))


# --- limb arithmetic ---------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1))
def test_normalize_halve_div_rows(seed):
    rng = np.random.default_rng(seed)
    # Post-deposit limbs: up to ~2^16 added per arrival.
    raw = rng.integers(0, 2**16 * 40, (300, 3, tps.LIMBS)).astype(np.int32)
    raw[..., -1] = rng.integers(0, 2**10, (300, 3))
    want = np.asarray(jps._normalize(jnp.asarray(raw)))
    got = tps._normalize(T(raw)).numpy()
    assert np.array_equal(want, got)
    assert (got >= 0).all() and (got[..., :-1] < 2**16).all()
    assert np.array_equal(_as_int(got), _as_int(raw))

    m3 = _limbs(seed, (300, 3))
    jh, jo = jps._halve(jnp.asarray(m3))
    th, to = tps._halve(T(m3))
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert np.array_equal(2 * _as_int(th.numpy()) + to.numpy(), _as_int(m3))

    m = rng.integers(1, 33, 300).astype(np.int32)
    jq, jr = jps._div_rows(jnp.asarray(m3), jnp.asarray(m))
    tq, tr = tps._div_rows(T(m3), T(m))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(_as_int(tq.numpy()) * m[:, None] + tr.numpy(),
                          _as_int(m3))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def test_to_float_bits():
    """The four-limb float32 sum, left to right, on 200,000 rows (a tree
    order gives other bits on about a quarter of them)."""
    m3 = _limbs(5, (200_000,), top=2**12)
    want = jax.jit(jps._to_float)(jnp.asarray(m3))
    assert np.array_equal(_bits(want), _bits(tps._to_float(T(m3))))


def _metric_limbs(cfg, seed, n=4000):
    """(n, dim+1, 4) limbs around the true means: estimates within ~1e-2
    to 1e-4 of them at weights from 2^-12 (starved) to 8, and a tenth of
    the rows random."""
    rng = np.random.default_rng(seed)
    dim = cfg.pushsum_dim
    means = np.asarray(tps.true_means(cfg))
    w = 2.0 ** rng.uniform(-12, 3, n)
    est = means[None, :] * (1 + rng.normal(0, 10.0 ** rng.uniform(
        -4, -2, (n, 1)), (n, dim)))
    vals = np.concatenate([est * w[:, None], w[:, None]], axis=1)
    fixed = np.floor(vals * 2.0**tps.FRAC_BITS).astype(np.int64)
    m3 = np.stack([(fixed >> (16 * i)) & 0xFFFF for i in range(tps.LIMBS)],
                  axis=-1).astype(np.int32)
    rand = rng.random(n) < 0.1
    m3[rand] = _limbs(seed, (int(rand.sum()), dim + 1), top=2**8)
    return m3


@pytest.mark.parametrize("dim,seed", ((1, 0), (2, 7), (8, 11)))
def test_metric_rel_bits(dim, seed):
    jc, tc = _cfgs(pushsum_dim=dim, seed=seed, n=3000)
    m3 = _metric_limbs(tc, seed)
    crashed = np.random.default_rng(seed).random(m3.shape[0]) < 0.05
    jrel, jrep = jax.jit(lambda a, c: jps.metric_rel(jc, a, c))(
        jnp.asarray(m3), jnp.asarray(crashed))
    trel, trep = tps.metric_rel(tc, T(m3), T(crashed))
    assert np.array_equal(_bits(jrel), _bits(trel))
    assert np.array_equal(_bits(jrep), _bits(trep))
    conv = trel.numpy() <= np.float32(tc.pushsum_eps)
    assert 0 < conv.sum() < len(conv)  # both sides of eps are exercised


@pytest.mark.parametrize("dim", (1, 2, 8))
@pytest.mark.parametrize("seed", (0, 123_456_789))
def test_init_mass_and_true_means(dim, seed):
    jc, tc = _cfgs(pushsum_dim=dim, seed=seed, n=1000)
    assert tps.true_means(tc) == jps.true_means(jc)
    assert tps.mass_cols(tc) == jps.mass_cols(jc)
    want = np.asarray(jps.init_mass(jc, 100, 900))
    assert np.array_equal(want, tps.init_mass(tc, 100, 900).numpy())
    assert np.array_equal(np.asarray(jps._values_q_jnp(
        seed, jnp.arange(1000), dim)), tps._values_q(
            seed, torch.arange(1000), dim).numpy())


def test_geometry_matches():
    for kw in (dict(), dict(n=20_000), dict(delaylow=3, delayhigh=40),
               dict(event_chunk=512), dict(event_slot_cap=700)):
        jc, tc = _cfgs(**kw)
        for fn in ("slot_cap", "drain_chunk", "ring_tail", "ring_len",
                   "_src_windows", "eps_target"):
            assert getattr(tps, fn)(tc) == getattr(jps, fn)(jc), (kw, fn)


# --- the emission ------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1))
def test_emit_shares(seed):
    jc, tc = _cfgs(seed=seed, n=500)
    rng = np.random.default_rng(seed)
    n, k = 500, 6
    cnt = rng.integers(0, k + 1, n).astype(np.int32)
    friends = rng.integers(0, n, (n, k)).astype(np.int32)
    friends[np.arange(k)[None, :] >= cnt[:, None]] = -1
    friends[rng.random((n, k)) < 0.05] = -1
    m3 = _limbs(seed, (n, tc.pushsum_dim + 1))
    crashed = rng.random(n) < 0.1
    tick = 40
    want = jps.emit_shares(jc, jnp.asarray(m3), jnp.asarray(crashed),
                           jnp.asarray(friends), jnp.asarray(cnt), tick,
                           jnp.arange(n, dtype=jnp.int32),
                           jrng.base_key(jc.seed))
    got = tps.emit_shares(tc, T(m3), T(crashed), T(friends), T(cnt), tick,
                          torch.arange(n, dtype=torch.int32),
                          trng.base_key(tc.seed))
    assert len(want) == len(got) == 7
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(w), g.numpy()), i
    assert 0 < int(got[5].sum()) < n * k


# --- kernels -----------------------------------------------------------------


def _jax_drain_chain(d, kw, ccap):
    """The JAX package's -phase2-kernel xla drain: deposit_sum over ccap
    chunks of the slot's live lanes."""
    acc = jnp.asarray(d["acc"])
    ids, mass = jnp.asarray(d["ids"]), jnp.asarray(d["mass"])
    slot, cap, b = kw["slot"], kw["cap"], kw["b"]
    m = int(d["cnt"][0, slot])
    for j in range((m + ccap - 1) // ccap):
        off0 = slot * cap + j * ccap
        ok = j * ccap + jnp.arange(ccap) < m
        acc = jmailbox.deposit_sum(acc, ids[off0:off0 + ccap] // b,
                                   mass[off0:off0 + ccap], ok, kernel="xla")
    return np.asarray(acc)


DRAIN_CASES = {"small": dict(), "dim8_full_slot": dict(c=36, cap=300, m=300),
               "out_of_range": dict(oob=0.3, cap=600), "empty": dict(m=0)}


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_drain_plain_matches_pallas_and_chunked_chain(case):
    d, kw = _drain_inputs(2, **DRAIN_CASES[case])
    got = _drain(megakernel.drain_sum_plain, d, kw, CPU).numpy()
    assert np.array_equal(got, _drain(megakernel.fused_drain_sum, d, kw,
                                      CPU).numpy())
    want = np.asarray(jmk.fused_drain_sum(
        jnp.asarray(d["acc"]), jnp.asarray(d["ids"]), jnp.asarray(d["mass"]),
        kw["slot"], int(d["cnt"][0, kw["slot"]]), cap=kw["cap"], b=kw["b"],
        interpret=True))
    assert np.array_equal(want, got)
    assert np.array_equal(_jax_drain_chain(d, kw, 64), got)


def test_drain_drops_negative_entries_as_the_pallas_kernel():
    """An entry below 0 decodes to a row below 0: the Pallas kernel and
    the port add nothing for it (the XLA scatter would wrap the index;
    no caller writes one, ROADMAP §C)."""
    d, kw = _drain_inputs(4, neg=0.2, cap=300)
    got = _drain(megakernel.drain_sum_plain, d, kw, CPU).numpy()
    want = np.asarray(jmk.fused_drain_sum(
        jnp.asarray(d["acc"]), jnp.asarray(d["ids"]), jnp.asarray(d["mass"]),
        kw["slot"], int(d["cnt"][0, kw["slot"]]), cap=kw["cap"], b=kw["b"],
        interpret=True))
    assert np.array_equal(want, got)


WIDE_RING_CASES = {"w12": dict(width=12, m=3000, cap=2000),
                   "w8_overflow": dict(width=8, cap=60, base_hi=50),
                   "w36": dict(width=36, dw=4)}


@pytest.mark.parametrize("case", sorted(WIDE_RING_CASES))
def test_wide_ring_append_matches_pallas_and_one_hot_chain(case):
    d, kw = _ring_inputs(6, **WIDE_RING_CASES[case])
    got = _ring_append(deliver.fused_ring_append, d, kw, CPU)
    assert d["rings"][1].ndim == 2 and got[1].dim() == 2
    rings = tuple(jnp.asarray(r) for r in d["rings"])
    pays = tuple(jnp.asarray(p) for p in d["pays"])
    args = (jnp.asarray(d["cnt"]), jnp.asarray(3, jnp.int32), pays,
            jnp.asarray(d["wslot"]), jnp.asarray(d["valid"]), kw["dw"],
            kw["cap"])
    for want in (jdeliver.fused_ring_append(rings, *args, interpret=True),
                 jmailbox.ring_append(rings, *args, kernel="xla")):
        (r0, r1), cnt, dropped = want
        for w, g in zip((r0, r1, cnt, dropped), got):
            assert np.array_equal(np.asarray(w), g.numpy())
    if case == "w8_overflow":
        assert int(got[3]) > 3  # lanes went to the trash row
        assert not got[1][kw["dw"] * kw["cap"]].any()


@pytest.mark.parametrize("kernel", ("pallas", "xla"))
def test_deposit_sum_both_gates(kernel):
    rng = np.random.default_rng(9)
    n, c, m = 400, 12, 3000
    acc = rng.integers(0, 2**16, (n, c)).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    rows = rng.integers(0, 2**16, (m, c)).astype(np.int32)
    valid = rng.random(m) < 0.7
    want = jmailbox.deposit_sum(jnp.asarray(acc), jnp.asarray(dst),
                                jnp.asarray(rows), jnp.asarray(valid))
    got = mailbox.deposit_sum(T(acc.copy()), T(dst), T(rows), T(valid),
                              kernel=kernel)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_cpu_drain_never_launches():
    _build.reset_launches()
    d, kw = _drain_inputs(0)
    _drain(megakernel.fused_drain_sum, d, kw, CPU)
    d, kw = _ring_inputs(0, width=12)
    _ring_append(deliver.fused_ring_append, d, kw, CPU)
    assert not any(_build.LAUNCHES.values())


def test_drain_wrapper_refuses_bad_inputs():
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="mail_mass must be int32"):
        megakernel.fused_drain_sum(i32(5, 12), i32(40), i32(40, 8),
                                   i32(1, 3), 1, cap=10, b=10)
    with pytest.raises(ValueError, match="past the ring"):
        megakernel.fused_drain_sum(i32(5, 12), i32(40), i32(40, 12),
                                   i32(1, 3), 2, cap=20, b=10)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        megakernel.fused_drain_sum(
            *(t.to("meta") for t in (i32(5, 12), i32(40), i32(40, 12),
                                     i32(1, 3))), 1, cap=10, b=10)


# --- a JAX state continues in the port ---------------------------------------

BASE = dict(n=500, fanout=6, seed=4)
CONTINUE = {
    "default": dict(),
    # Several drain chunks a window (-event-chunk 512: ~6 of them).
    "chunked": dict(event_chunk=512, pushsum_dim=1),
    # Slots of 2,000 entries for ~3,000 emissions: the trash row fills.
    "overflow": dict(event_slot_cap=2000, pushsum_dim=8),
}
GATES = {"default": {}, "p2_xla": dict(phase2_kernel="xla"),
         "all_xla": dict(phase2_kernel="xla", deliver_kernel="xla")}
WINDOWS = 3


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """JAX package: WINDOWS windows, then its state, and WINDOWS more
    windows' Stats and the final state."""
    s = JaxStepper(jcfg.Config(**{**PS, **BASE, **CONTINUE[case]}).validate())
    s.init()
    assert s.overlay_window()[2]
    s.seed()
    for _ in range(WINDOWS):
        s.gossip_window()
    tree = s.state_pytree()
    stats = [s.gossip_window().to_dict() for _ in range(WINDOWS)]
    return tree, stats, s.state_pytree(), s.sim_time_ms(), jps.report(s)


@pytest.mark.parametrize("case,gate", [(c, g) for c in CONTINUE
                                       for g in GATES])
def test_jax_state_continues_in_port(case, gate):
    tree, want_stats, want_tree, want_ms, want_report = _jax_run(case)
    back = interop.pushsum_state_to_numpy(
        interop.pushsum_state_from_numpy(tree, "cpu"))
    assert set(back) == set(tree) - {"host_mailbox_dropped"}
    for key, val in back.items():
        assert val.dtype == np.asarray(tree[key]).dtype, key
        assert np.array_equal(val, tree[key]), key
    cfg = tcfg.Config(**{**PS, **BASE, **CONTINUE[case],
                         **GATES[gate]}).validate()
    ts = TorchStepper(cfg, device="cpu")
    ts.init()
    initial = tps.conserved_totals(ts.state, cfg)
    ts.load_state_pytree(tree)
    for want in want_stats:
        assert ts.gossip_window().to_dict() == want
        if case != "overflow":
            assert tps.conserved_totals(ts.state, cfg) == initial
    if case == "overflow":
        assert want_stats[-1]["mailbox_dropped"] > 0
    got = ts.state_pytree()
    assert set(got) == set(want_tree)
    for key in want_tree:
        assert np.asarray(want_tree[key]).dtype == got[key].dtype, key
        assert np.array_equal(want_tree[key], got[key]), key
    assert ts.sim_time_ms() == want_ms
    assert tps.report(ts) == want_report


def test_conservation_from_init_every_window():
    """The port alone from the start: Sigma x and Sigma w over the masses
    and the live ring rows stay the initial totals, window by window."""
    cfg = tcfg.Config(**PS, n=700, fanout=5, seed=8).validate()
    ts = TorchStepper(cfg, device="cpu")
    ts.init()
    ts.overlay_window()
    ts.seed()
    initial = tps.conserved_totals(ts.state, cfg)
    assert initial[-1] == 700 << tps.FRAC_BITS  # weight 1.0 a node
    for _ in range(6):
        ts.gossip_window()
        assert tps.conserved_totals(ts.state, cfg) == initial
    assert int(ts.state.mail_dropped) == 0


def test_state_geometry_mismatch_is_named():
    """A state of another window count is refused by name; one of another
    slot capacity is repacked (utils/checkpoint.py) with every entry and
    its mass row kept."""
    tree = _jax_run("default")[0]
    ts = TorchStepper(tcfg.Config(**{**PS, **BASE, "delayhigh": 45})
                      .validate(), device="cpu")
    ts.init()
    with pytest.raises(ValueError, match="window-ring shape"):
        ts.load_state_pytree(tree)
    ts = TorchStepper(tcfg.Config(**{**PS, **BASE, "event_slot_cap": 5000})
                      .validate(), device="cpu")
    ts.init()
    ts.load_state_pytree(tree)
    assert ts.state.geom[0] == 5000 != int(tree["mail_geom"][0])
    assert ts.state.mail_cnt.tolist() == tree["mail_cnt"].tolist()
    assert int(ts.state.mail_dropped) == int(tree["mail_dropped"])


# --- config ------------------------------------------------------------------

ARGV = ["-model", "pushsum", "-graph", "kout", "-n", "100", "-droprate",
        "0", "-crashrate", "0"]


@pytest.mark.parametrize("flags,match", (
    (["-graph", "overlay"], "supports -graph kout"),
    (["-protocol", "sir"], "replaces the infection protocol"),
    (["-time-mode", "rounds"], "requires -time-mode ticks"),
    (["-engine", "ring"], "rides the event-engine mail ring"),
    (["-rumors", "4"], "incompatible with -rumors"),
    (["-compat-reference"], "strictly 1-bit SI"),
    (["-dup-suppress", "on"], "meaningless under -model pushsum"),
    (["-droprate", "0.1"], "requires droprate 0"),
    (["-crashrate", "0.001"], "requires crashrate 0"),
    (["-pushsum-dim", "9"], r"pushsum_dim must be in \[1, 8\]"),
    (["-pushsum-eps", "0"], "pushsum_eps must be > 0"),
    # Its fault scenarios and healing are ported (A10), with the JAX
    # package's rules, on the sharded backend too (A13.1); across
    # processes they are not (A13).
    (["-graph", "erdos", "-scenario", '{"groups": 0}'],
     "scenario groups must be >= 1"),
    (["-scenario", '{"groups": 101, "downtime": 5}'],
     r"scenario groups \(101\) cannot exceed n \(100\)"),
    (["-backend", "sharded", "-overlay-heal", "on", "-distributed"],
     r"not yet ported \(ROADMAP A13\)")))
def test_pushsum_rules_match_the_jax_package(flags, match):
    with pytest.raises(ValueError, match=match):
        tcfg.parse_cli(ARGV + flags)
    if "ROADMAP" not in match:
        with pytest.raises(ValueError, match=match):
            jcfg.parse_args(ARGV + flags)


def test_pushsum_flags_parse():
    cfg, device = tcfg.parse_cli(ARGV + ["-pushsum-dim", "3",
                                         "-pushsum-eps", "0.01"])
    assert (cfg.model, cfg.pushsum_dim, cfg.pushsum_eps) == (
        "pushsum", 3, 0.01)
    assert device == "cuda" and cfg.engine_resolved == "event"
    assert tcfg.Config().pushsum_dim == jcfg.Config().pushsum_dim
    assert tcfg.Config().pushsum_eps == jcfg.Config().pushsum_eps
