"""The port's checkpoint module (``utils/checkpoint.py``) against the JAX
package's, function by function, on the same inputs; exact equality
everywhere:

* ``save``/``latest``/``prune``/``load``: a snapshot written by either
  loads in the other with the same leaves and sidecar keys (the digest
  aside: the zip stamps differ), no ``.tmp`` is left, partials are
  ignored and pruned alike, a truncated or torn file is refused with the
  same message, a snapshot without a digest loads, and
  ``verify_provenance`` passes and refuses alike;
* ``prepare_restore_tree`` and ``prepare_overlay_restore_tree`` on the
  same trees (made by the port's steppers at n = 2000-3000) give equal
  leaves or the same ``ValueError`` text: the event engine, the ring
  engine, PushSum, ``-rumors 4``, a scenario, each legacy coercion, the
  engine, model, n, width and geometry mismatches, a repack and a
  reshard;
* ``repack_mail_ring`` and ``reshard_mail_rings`` on seeded random rings
  with companion words."""

import dataclasses
import json
import os

import numpy as np
import pytest

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.utils import checkpoint as jck
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.utils import checkpoint as tck
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import Stats as TStats
from gossip_simulator_tpu.utils.metrics import Stats as JStats
from test_torch_rng import match_jax_threefry
import torch_ckpt as ck


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


KOUT = ["-graph", "kout", "-n", "2000", "-fanout", "6", "-seed", "1"]
MODS = {"port": (tck, TStats), "ref": (jck, JStats)}


@pytest.fixture(scope="module")
def event_tree():
    return ck.phase2_tree(KOUT, 4)


# --- save / latest / prune / load ------------------------------------------

@pytest.mark.parametrize("writer", sorted(MODS))
def test_snapshot_crosses(tmp_path, event_tree, writer):
    """A snapshot written by either package loads in both with the tree's
    leaves; the two writers' sidecars are equal but for the digest."""
    metas = {}
    for side, (mod, stats_cls) in MODS.items():
        path = mod.save(str(tmp_path / side), 4, event_tree,
                        stats_cls(n=2000, round=40, total_received=7),
                        extra_meta={"run_id": "r1"})
        assert os.path.basename(path) == "state_00000004.npz"
        metas[side] = ck.sidecar(path)
    path = str(tmp_path / writer / "state_00000004.npz")
    for side, (mod, _) in MODS.items():
        arrays, meta = mod.load(path)
        ck.assert_same_leaves(event_tree, arrays)
        assert meta == metas[writer]
    for m in metas.values():
        assert len(m.pop("sha256")) == 64
    assert metas["port"] == metas["ref"]


def test_atomic_save_and_latest_alike(tmp_path, event_tree):
    """No .tmp is left; latest() ignores partials, prefers state_* over
    overlay_*, and is None on an empty or missing dir, in both."""
    small = {"a": np.arange(5, dtype=np.int32)}
    got = {}
    for side, (mod, stats_cls) in MODS.items():
        d = tmp_path / side
        assert mod.latest(str(d)) is None
        mod.save(str(d), 3, small, stats_cls(n=5))
        mod.save(str(d), 9, small, stats_cls(n=5), prefix="overlay",
                 extra_meta={"phase": 1, "sim_ms": 90.0})
        (d / "state_00000007.npz.tmp").write_bytes(b"partial")
        got[side] = (sorted(os.listdir(d)),
                     os.path.basename(mod.latest(str(d))))
    assert got["port"] == got["ref"]
    names, newest = got["port"]
    assert newest == "state_00000003.npz"
    assert [x for x in names if ".tmp" in x] == ["state_00000007.npz.tmp"]


@pytest.mark.parametrize("keep", (0, 1, 2, 5))
@pytest.mark.parametrize("prefix", ("state", "overlay"))
def test_prune_alike(tmp_path, keep, prefix):
    """Retention keeps the newest `keep` of the prefix, with sidecars,
    removes its partials, and touches nothing of the other prefix."""
    small = {"a": np.zeros(3, np.int32)}
    got = {}
    for side, (mod, stats_cls) in MODS.items():
        d = tmp_path / side
        for w in (2, 4, 6, 8):
            for pre in ("state", "overlay"):
                mod.save(str(d), w, small, stats_cls(n=3), prefix=pre)
        (d / f"{prefix}_00000009.npz.tmp").write_bytes(b"x")
        removed = mod.prune(str(d), keep, prefix=prefix)
        got[side] = (sorted(os.path.basename(p) for p in removed),
                     sorted(os.listdir(d)))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("damage", ("truncated", "torn", "garbage"))
def test_corrupt_snapshot_refused_alike(tmp_path, event_tree, damage):
    """A truncated file and a torn pair fail the digest, a file that is
    no zip fails the read; both packages refuse with the same text."""
    msgs = {}
    for side, (mod, stats_cls) in MODS.items():
        path = mod.save(str(tmp_path / side), 1, event_tree,
                        stats_cls(n=2000))
        raw = open(path, "rb").read()
        if damage == "truncated":
            open(path, "wb").write(raw[:len(raw) // 2])
        elif damage == "torn":
            meta = ck.sidecar(path)
            meta["sha256"] = "0" * 64
            json.dump(meta, open(path + ".json", "w"))
        else:
            meta = ck.sidecar(path)
            del meta["sha256"]
            json.dump(meta, open(path + ".json", "w"))
            open(path, "wb").write(b"not a zip file")
        with pytest.raises(ValueError) as e:
            mod.load(path)
        msgs[side] = str(e.value).replace(str(tmp_path / side), "<dir>")
    assert msgs["port"] == msgs["ref"]
    assert ("corrupt" if damage != "garbage" else "unreadable") \
        in msgs["port"]


def test_pre_digest_snapshot_loads(tmp_path, event_tree):
    """A sidecar without sha256 (written before digests) loads unchecked
    in both, as does a snapshot with no sidecar at all."""
    path = jck.save(str(tmp_path), 2, event_tree, JStats(n=2000))
    meta = ck.sidecar(path)
    del meta["sha256"]
    json.dump(meta, open(path + ".json", "w"))
    for mod, _ in MODS.values():
        arrays, got = mod.load(path)
        ck.assert_same_leaves(event_tree, arrays)
        assert got == meta
    os.remove(path + ".json")
    for mod, _ in MODS.values():
        assert mod.load(path)[1] == {}


@pytest.mark.parametrize("meta,run_id,now,stale", (
    ({"run_id": "a", "window": 3}, "a", 0, 0),
    ({"run_id": "a", "window": 3}, "b", 0, 0),
    ({"window": 3}, "b", 0, 0),
    ({"run_id": "a", "window": 3}, "", 0, 0),
    ({"run_id": "a", "window": 3}, "a", 10, 5),
    ({"run_id": "a", "window": 8}, "a", 10, 5),
))
def test_verify_provenance_alike(meta, run_id, now, stale):
    out = []
    for mod, _ in MODS.values():
        try:
            mod.verify_provenance(meta, "p.npz", run_id=run_id,
                                  now_window=now, max_stale=stale)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


# --- prepare_restore_tree ----------------------------------------------------

PS = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout", "6",
      "-droprate", "0", "-crashrate", "0", "-seed", "1"]
RING = ["-engine", "ring", "-graph", "kout", "-n", "2000", "-fanout", "6",
        "-seed", "1"]
RUMORS = KOUT + ["-rumors", "4", "-crashrate", "0"]
SCEN = ('{"groups": 2, "downtime": 60, "events": ['
        '{"type": "crash", "at": 20, "frac": 0.3, "group": 1}]}')
FAULTS = KOUT + ["-crashrate", "0", "-scenario", SCEN]
SIR = KOUT + ["-protocol", "sir", "-removal-rate", "0.3"]
PUSHPULL = ["-protocol", "pushpull", "-graph", "kout", "-n", "2000",
            "-fanout", "6", "-seed", "1"]
# The trees the cases start from: (argv, windows, shards).
TREES = {"event": (KOUT, 7, None), "event_s8": (KOUT, 7, 8),
         "ring": (RING, 4, None), "pushsum": (PS, 3, None),
         "pushsum_s8": (PS, 3, 8), "rumors": (RUMORS, 4, None),
         "faults": (FAULTS, 7, None), "sir": (SIR, 7, None),
         "pushpull": (PUSHPULL, 4, None)}


def _drop(*keys):
    def f(t):
        for k in keys:
            t.pop(k, None)
    return f


def _unpack_flags(t):
    flags = t.pop("flags")
    t["received"] = (flags & 1).astype(bool)
    t["crashed"] = (flags & 2).astype(bool)


def _scalar_total(t):
    t["total_message"] = np.asarray(int(t["total_message"][1]), np.int32)


def _full_friends(t):
    t["friends"] = np.zeros((2000, 6), np.int32)
    t["friend_cnt"] = np.full((2000,), 6, np.int32)


def _bad_geom(t):
    t["mail_geom"] = np.asarray([t["mail_geom"][0] * 4, t["mail_geom"][1]],
                                np.int64)


# name: (tree, mutation or None, the restoring run's argv, shards)
PREPARE = {
    "event_same": ("event", None, KOUT, 1),
    "event_repack_cap": ("event", None, KOUT + ["-event-slot-cap", "5000"],
                         1),
    "event_repack_cap_overflow": ("event", None,
                                  KOUT + ["-event-slot-cap", "300"], 1),
    "event_repack_chunk": ("event", None, KOUT + ["-event-chunk", "512"], 1),
    "event_reshard_1_to_8": ("event", None, KOUT, 8),
    "event_reshard_1_to_2": ("event", None, KOUT, 2),
    "event_reshard_8_to_1": ("event_s8", None, KOUT, 1),
    "event_s8_repack": ("event_s8", None, KOUT + ["-event-slot-cap", "900"],
                        8),
    "event_pre_packed_flags": ("event", _unpack_flags, KOUT, 1),
    "event_scalar_total": ("event", _scalar_total, KOUT, 1),
    "event_no_sup_cnt": ("event", _drop("sup_cnt"), KOUT, 1),
    "event_no_rumor_axis": ("event", _drop("rumor_words", "rumor_recv",
                                           "rumor_done", "mail_words"),
                            KOUT, 1),
    "event_no_scenario_leaves": ("event", _drop(
        "down_since", "scen_crashed", "scen_recovered", "part_dropped",
        "heal_repaired"), KOUT, 1),
    "event_no_geom_same": ("event", _drop("mail_geom"), KOUT, 1),
    "event_no_geom_other": ("event", _drop("mail_geom"),
                            KOUT + ["-event-slot-cap", "5000"], 1),
    "event_geom_contradiction": ("event", _bad_geom, KOUT, 1),
    "event_into_ring": ("event", None, RING, 1),
    "event_into_pushsum": ("event", None, PS, 1),
    "event_n_mismatch": ("event", None, ["-graph", "kout", "-n", "3000",
                                         "-fanout", "6"], 1),
    "event_window_shape": ("event", None, KOUT + ["-delayhigh", "60"], 1),
    "event_into_rumors": ("event", None, RUMORS, 1),
    "event_into_scenario": ("event", None, FAULTS, 1),
    "sir_same": ("sir", None, SIR, 1),
    "sir_reshard_1_to_8": ("sir", None, SIR, 8),
    "ring_same": ("ring", None, RING, 1),
    "ring_into_event": ("ring", None, KOUT, 1),
    "ring_depth_mismatch": ("ring", None, RING + ["-delayhigh", "60"], 1),
    "ring_scalar_total": ("ring", _scalar_total, RING, 1),
    "ring_no_rumor_axis": ("ring", _drop("rumor_words", "rumor_recv",
                                         "rumor_done", "pending_rumors"),
                           RING, 1),
    "pushpull_same": ("pushpull", None, PUSHPULL, 1),
    "pushpull_full_friends": ("pushpull", _full_friends, PUSHPULL, 1),
    "pushsum_same": ("pushsum", None, PS, 1),
    "pushsum_repack": ("pushsum", None, PS + ["-event-slot-cap", "20000"], 1),
    "pushsum_reshard_1_to_8": ("pushsum", None, PS, 8),
    "pushsum_reshard_8_to_1": ("pushsum_s8", None, PS, 1),
    "pushsum_into_si": ("pushsum", None, KOUT, 1),
    "pushsum_dim_mismatch": ("pushsum", None, PS + ["-pushsum-dim", "3"], 1),
    "rumors_same": ("rumors", None, RUMORS, 1),
    "rumors_repack": ("rumors", None, RUMORS + ["-event-slot-cap", "6000"],
                      1),
    "rumors_width_mismatch": ("rumors", None,
                              KOUT + ["-rumors", "40", "-crashrate", "0"], 1),
    "rumors_into_single": ("rumors", None, KOUT + ["-crashrate", "0"], 1),
    "faults_same": ("faults", None, FAULTS, 1),
    "faults_into_faultfree": ("faults", None, KOUT + ["-crashrate", "0"], 1),
}


@pytest.fixture(scope="module")
def trees():
    made = {}

    def get(name):
        if name not in made:
            argv, windows, shards = TREES[name]
            made[name] = ck.phase2_tree(argv, windows, shards)
        return {k: np.array(v) for k, v in made[name].items()}

    return get


def _prepare(mod, cfg, tree, shards, fn="prepare_restore_tree"):
    try:
        return getattr(mod, fn)(tree, cfg, shards)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", sorted(PREPARE))
def test_prepare_restore_tree_alike(trees, name):
    tree_name, mutate, argv, shards = PREPARE[name]
    tree = trees(tree_name)
    if mutate is not None:
        mutate(tree)
    jc = jcfg.parse_args(argv)
    tc, _ = tcfg.parse_cli(argv)
    want = _prepare(jck, jc, dict(tree), shards)
    got = _prepare(tck, tc, dict(tree), shards)
    if isinstance(want, str):
        assert got == want
        return
    assert not isinstance(got, str), got
    ck.assert_same_leaves(want, got)


# --- prepare_overlay_restore_tree --------------------------------------------

TICKS = ["-n", "2000", "-seed", "1", "-coverage-target", "0.9"]
ROUNDS = ["-overlay-mode", "rounds", "-n", "3000", "-fanout", "5", "-seed",
          "9"]


def _spill_pairs(t):
    for f in ("mk_spill", "bk_spill"):
        a = np.full((2, 9), -1, np.int32)
        a[:, :3] = [[1, 2, 3], [4, 5, 6]]
        t[f] = a


def _wide_spill(t):
    for f in ("mk_spill", "bk_spill"):
        a = np.full((2, 70_000), -1, np.int32)
        a[:, :2] = [[7, 8], [9, 10]]
        t[f] = a


def _ticks_spill(t):
    a = np.full((2, 5), -1, np.int32)
    a[:, 0] = [3, 4]
    t["spill"] = a


OVERLAY = {
    "ticks_same": ("ticks", None, TICKS, 1),
    "ticks_no_spill": ("ticks", _drop("spill"), TICKS, 1),
    "ticks_live_spill": ("ticks", _ticks_spill, TICKS, 1),
    "ticks_into_rounds": ("ticks", None, TICKS + ["-overlay-mode", "rounds"],
                          1),
    "ticks_into_kout": ("ticks", None, ["-graph", "kout", "-n", "2000"], 1),
    "ticks_n_mismatch": ("ticks", None, ["-n", "2500"], 1),
    "ticks_degree_mismatch": ("ticks", None, TICKS + ["-fanout", "7"], 1),
    "ticks_delay_mismatch": ("ticks", None, TICKS + ["-delayhigh", "40"], 1),
    "ticks_s8": ("ticks", None, TICKS, 8),
    "ticks_s8_live_spill": ("ticks", _ticks_spill, TICKS, 8),
    "rounds_same": ("rounds", None, ROUNDS, 1),
    "rounds_no_spill": ("rounds", _drop("mk_spill", "bk_spill"), ROUNDS, 1),
    "rounds_no_room_for_spill": ("rounds", _spill_pairs, ROUNDS, 1),
    # Cap 8 spills (the memory band's cap): its buffers re-pad.
    "rounds8_same": ("rounds8", None, ROUNDS, 1, {"mailbox_cap": 8}),
    "rounds8_repad_spill": ("rounds8", _spill_pairs, ROUNDS, 1,
                            {"mailbox_cap": 8}),
    "rounds8_wide_spill": ("rounds8", _wide_spill, ROUNDS, 1,
                           {"mailbox_cap": 8}),
    "rounds8_no_spill": ("rounds8", _drop("mk_spill", "bk_spill"), ROUNDS,
                         1, {"mailbox_cap": 8}),
    "rounds_into_ticks": ("rounds", None, ROUNDS[2:], 1),
    # The JAX package's parser has no -mailbox-cap: set on both configs.
    "rounds_cap_mismatch": ("rounds", None, ROUNDS, 1, {"mailbox_cap": 8}),
    "rounds_s8_live_spill": ("rounds", _spill_pairs, ROUNDS, 8),
    "rounds_s8": ("rounds", None, ROUNDS, 8),
}


@pytest.fixture(scope="module")
def overlay_trees():
    made = {"ticks": ck.phase1_tree(TICKS, 6),
            "rounds": ck.phase1_tree(ROUNDS, 4),
            "rounds8": ck.phase1_tree(ROUNDS + ["-mailbox-cap", "8"], 4)}
    return lambda name: {k: np.array(v) for k, v in made[name].items()}


@pytest.mark.parametrize("name", sorted(OVERLAY))
def test_prepare_overlay_restore_tree_alike(overlay_trees, name):
    tree_name, mutate, argv, shards, *fields = OVERLAY[name]
    tree = overlay_trees(tree_name)
    if mutate is not None:
        mutate(tree)
    fields = fields[0] if fields else {}
    jc = dataclasses.replace(jcfg.parse_args(argv), **fields).validate()
    tc = dataclasses.replace(tcfg.parse_cli(argv)[0], **fields).validate()
    fn = "prepare_overlay_restore_tree"
    want = _prepare(jck, jc, dict(tree), shards, fn)
    got = _prepare(tck, tc, dict(tree), shards, fn)
    if isinstance(want, str):
        assert got == want
        return
    assert not isinstance(got, str), got
    ck.assert_same_leaves(want, got)


# --- repack_mail_ring, reshard_mail_rings ------------------------------------

def _ring(gen, dw, cap, tail, n_rows, b, fill, width, dtype):
    mail = gen.integers(0, 2**31 - 1, dw * cap + tail, dtype=np.int64)
    cnt = np.minimum(gen.integers(0, int(cap * fill) + 1, dw), cap)
    for s in range(dw):
        mail[s * cap:s * cap + cnt[s]] = gen.integers(0, n_rows * b,
                                                      cnt[s])
    words = (gen.integers(0, 2**31, (dw * cap + tail, width)).astype(dtype)
             if width else None)
    return mail.astype(np.int32), cnt.astype(np.int32), words


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ncap,ntail", ((700, 300), (300, 512), (1500, 64)))
@pytest.mark.parametrize("width", (0, 2))
def test_repack_mail_ring_alike(seed, ncap, ntail, width):
    gen = np.random.default_rng(seed)
    dw, ocap, otail = 3, 1000, 256
    mail, cnt, words = _ring(gen, dw, ocap, otail, 500, 10, 0.8, width,
                             np.uint32)
    want = jck.repack_mail_ring(mail, cnt, ocap, otail, ncap, ntail, dw,
                                words=words)
    got = tck.repack_mail_ring(mail, cnt, ocap, otail, ncap, ntail, dw,
                               words=words)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
        else:
            assert np.asarray(w).dtype == np.asarray(g).dtype
            assert np.array_equal(w, g)


@pytest.mark.parametrize("s_old,s_new", ((1, 8), (8, 1), (2, 8), (8, 2)))
@pytest.mark.parametrize("protocol", ("si", "sir"))
@pytest.mark.parametrize("words", (None, "uint32", "int32"))
def test_reshard_mail_rings_alike(s_old, s_new, protocol, words):
    """Seeded rings of `s_old` shards, entries encoded at the old shard's
    row count (SIR: a third of them triggers), re-bucketed onto `s_new`
    by both packages: the same rings, counts, sup counts, losses and
    companion rows."""
    argv = ["-graph", "kout", "-n", "4000", "-fanout", "6", "-protocol",
            protocol, "-event-slot-cap", "2500"]
    jc, (tc, _) = jcfg.parse_args(argv), tcfg.parse_cli(argv)
    from gossip_simulator_tpu_torch.models import event

    gen = np.random.default_rng(s_old * 10 + s_new)
    b, dw = event.batch_ticks(tc), event.ring_windows(tc)
    nlo = tc.n // s_old
    ocap, otail = 2000, 700
    tb = event.trigger_base(nlo, b)
    per = dw * ocap + otail
    mail = np.zeros(s_old * per, np.int32)
    cnt = gen.integers(0, ocap + 1, (s_old, dw)).astype(np.int32)
    for sh in range(s_old):
        for s in range(dw):
            e = gen.integers(0, nlo * b, cnt[sh, s])
            if protocol == "sir":
                e = np.where(gen.random(e.shape) < 0.3, tb + e, e)
            at = sh * per + s * ocap
            mail[at:at + cnt[sh, s]] = e
    sup = gen.integers(0, 50, (s_old, dw)).astype(np.int32)
    w = (gen.integers(0, 2**31, (s_old * per, 3)).astype(words)
         if words else None)
    want = jck.reshard_mail_rings(mail, cnt, sup, jc, s_old, s_new, dw,
                                  ocap, otail, words=w)
    got = tck.reshard_mail_rings(mail, cnt, sup, tc, s_old, s_new, dw,
                                 ocap, otail, words=w)
    assert want[3] == got[3]
    for a, g in zip(want[:3] + want[4:], got[:3] + got[4:]):
        if a is None:
            assert g is None
        else:
            assert a.dtype == g.dtype and np.array_equal(a, g)
