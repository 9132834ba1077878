"""Round-indexed state snapshots: the port's copy of the JAX package's
``utils/checkpoint.py``, on the port's own modules.

Format (the JAX package's, so a snapshot written by either package
resumes in the other): one ``np.savez_compressed`` ``.npz`` per snapshot
holding the state dict's leaves under the JAX package's names and dtypes
(``utils/interop.py`` maps them), plus a JSON sidecar with ``window``,
``Stats.to_dict()``, a ``sha256`` of the ``.npz`` bytes and, where the
driver writes them, ``phase``, ``sim_ms``, ``interrupted`` and ``run_id``.
Phase-2 snapshots are ``state_<window:08d>.npz``, phase-1 (overlay)
snapshots ``overlay_<window:08d>.npz``.

``prepare_restore_tree`` and ``prepare_overlay_restore_tree`` validate a
loaded dict against this run's config and coerce the legacy layouts; the
phase-2 event ring is repacked to this config's slot geometry
(``repack_mail_ring``) or re-bucketed onto another shard count
(``reshard_mail_rings``), in numpy on the host.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Optional

import numpy as np

from gossip_simulator_tpu_torch.models.state import exch_counts_width
from gossip_simulator_tpu_torch.utils import trace as _trace
from gossip_simulator_tpu_torch.utils.metrics import Stats


def _digest(path: str) -> str:
    """sha256 of the snapshot file's bytes, streamed (a snapshot at
    n = 10^7 is about a gigabyte before compression)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir: str, window: int, tree: dict[str, Any], stats: Stats,
         prefix: str = "state", extra_meta: Optional[dict] = None) -> str:
    """Write ``{prefix}_{window:08d}.npz`` and its sidecar.  ``latest()``
    sorts by name and "overlay" < "state", so any phase-2 snapshot
    outranks every phase-1 one.

    Atomic: both files are written under ``.tmp`` names and
    ``os.replace``d into place, the sidecar first, so a crash mid-save
    leaves the previous snapshot, or a (new sidecar, old or no npz) pair
    that ``load()`` rejects by the digest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{prefix}_{window:08d}.npz")
    with _trace.span("checkpoint.save", cat="io", prefix=prefix,
                     window=window):
        # A copy, never a view: the plain versions write the rings in
        # place, so a view of a CPU tensor would track the live state.
        arrays = {k: np.array(v) for k, v in tree.items()}
        tmp = path + ".tmp"
        # np.savez appends ".npz" to a name without it: hand it a file.
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        meta = {"window": window, **(extra_meta or {}), **stats.to_dict(),
                "sha256": _digest(tmp)}
        with open(path + ".json.tmp", "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".json.tmp", path + ".json")
        os.replace(tmp, path)
    return path


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    snaps = sorted(p for p in os.listdir(ckpt_dir) if p.endswith(".npz"))
    return os.path.join(ckpt_dir, snaps[-1]) if snaps else None


def prune(ckpt_dir: str, keep: int, prefix: str = "state") -> list[str]:
    """Retention: remove all but the newest `keep` ``{prefix}_*.npz``
    snapshots, each with its sidecar, and any ``.tmp`` partial a crashed
    save left.  Called after a save, so the newest is the one just
    written.  ``keep <= 0`` keeps everything.  Returns the removed
    paths."""
    removed: list[str] = []
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return removed
    names = os.listdir(ckpt_dir)
    snaps = sorted(p for p in names
                   if p.startswith(prefix + "_") and p.endswith(".npz"))
    doomed = snaps[:-keep] if keep < len(snaps) else []
    partials = [p for p in names
                if p.startswith(prefix + "_") and p.endswith(".tmp")]
    for name in doomed:
        for f in (name, name + ".json"):
            path = os.path.join(ckpt_dir, f)
            if os.path.exists(path):
                os.remove(path)
                removed.append(path)
    for name in partials:
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            os.remove(path)
            removed.append(path)
    return removed


def load(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Load one snapshot, checking the sidecar's sha256 where it has one
    (a snapshot written before digests loads unchecked).  A truncated,
    torn or corrupted file raises ValueError naming it."""
    with _trace.span("checkpoint.load", cat="io",
                     file=os.path.basename(path)):
        meta = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        want = meta.get("sha256")
        if want is not None:
            got = _digest(path)
            if got != want:
                raise ValueError(
                    f"checkpoint {path} is corrupt: content digest "
                    f"{got[:16]}… does not match its sidecar's "
                    f"{want[:16]}… (truncated or torn write?) -- delete "
                    "it and resume from an older snapshot")
        try:
            arrays = dict(np.load(path))
        except Exception as e:
            raise ValueError(
                f"checkpoint {path} is unreadable ({e!r}); delete it and "
                "resume from an older snapshot") from e
        return arrays, meta


def verify_provenance(meta: dict, path: str, *, run_id: str,
                      now_window: int, max_stale: int = 0) -> None:
    """Refuse, by name, a snapshot written by another run (its sidecar's
    ``run_id`` differs from a non-empty `run_id`) or one more than
    `max_stale` windows behind `now_window` (``max_stale <= 0``: no
    staleness check).  A snapshot without a ``run_id`` passes the run
    check."""
    theirs = meta.get("run_id")
    if run_id and theirs is not None and theirs != run_id:
        raise ValueError(
            f"checkpoint {path} was written by run {theirs} but this "
            f"supervisor run is {run_id}; refusing to restore a foreign "
            "snapshot (pass its -run-id explicitly to adopt it)")
    if max_stale > 0:
        behind = now_window - int(meta.get("window", 0))
        if behind > max_stale:
            raise ValueError(
                f"checkpoint {path} is {behind} window(s) behind the loss "
                f"point (window {now_window}), over the -recover-max-stale "
                f"limit of {max_stale}; refusing to resurrect stale state "
                "-- lower -checkpoint-every or raise -recover-max-stale")


def prepare_restore_tree(tree: dict, cfg, n_shards: int) -> dict:
    """Validate and coerce a phase-2 state dict for a stepper of
    `n_shards` shards (1: ``TorchStepper``): the engine and model gates,
    the n check, the legacy coercions (pre-packed-flags event snapshots,
    the scalar ``total_message``, push-pull's full friends table), the
    rumor axis, the event ring's geometry with a per-shard slot repack or
    a reshard, and the scenario leaves.  Returns a new dict of host
    arrays (``mail_geom`` taken out); raises ValueError naming the flag
    to fix on any mismatch."""
    from gossip_simulator_tpu_torch.models import epidemic, event

    ckpt_engine = "event" if "mail_ids" in tree else "ring"
    if ckpt_engine != cfg.engine_resolved:
        raise ValueError(
            f"checkpoint was written by the {ckpt_engine} engine but "
            f"this run resolves to {cfg.engine_resolved}; pass "
            f"-engine {ckpt_engine} to restore it")
    # The model gate, both ways: PushSum's fixed-point mass columns have
    # no slot in an epidemic run, and an epidemic snapshot no mass.
    ckpt_pushsum = "mass" in tree
    if ckpt_pushsum and cfg.model != "pushsum":
        raise ValueError(
            "checkpoint was written by the pushsum numeric-gossip model "
            "(it carries fixed-point mass columns) but this run's model "
            f"is {cfg.model}; pass -model pushsum to restore it")
    if cfg.model == "pushsum" and not ckpt_pushsum:
        raise ValueError(
            "checkpoint was written by an epidemic-model run (it has no "
            "mass columns) but this run has -model pushsum; restore it "
            "without -model pushsum, or restart the pushsum run from "
            "scratch")
    tree = dict(tree)
    if ckpt_engine == "event" and "received" in tree:
        # Pre-packed-flags event snapshot: bit0 received, bit1 crashed.
        tree["flags"] = (
            tree.pop("received").astype(np.uint8)
            + tree.pop("crashed").astype(np.uint8) * 2)
    n = int(tree["flags" if ckpt_engine == "event"
                 else "received"].shape[0])
    if n != cfg.n:
        raise ValueError(
            f"checkpoint has n={n} but this run has n={cfg.n}")
    if (cfg.protocol == "pushpull" and "friends" in tree
            and tuple(tree["friends"].shape[1:]) != (1,)):
        # Push-pull never reads the friends table and runs on a
        # one-column placeholder: an older snapshot's full table is
        # replaced by it.
        tree["friends"] = np.full((n, 1), -1, np.int32)
        tree["friend_cnt"] = np.zeros((n,), np.int32)
    # --- the multi-rumor leaves (models/state.py's rumor axis) ----------
    ckpt_multi = ("rumor_words" in tree
                  and tuple(np.asarray(tree["rumor_words"]).shape) != (1, 1))
    if cfg.multi_rumor and not ckpt_multi:
        raise ValueError(
            "checkpoint was written by a single-rumor run but this run "
            f"has -rumors {cfg.rumors} -traffic {cfg.traffic}; the "
            "snapshot does not record which rumors were in flight -- "
            "restore it with -rumors 1 -traffic oneshot, or restart the "
            "multi-rumor run from scratch")
    if ckpt_multi and not cfg.multi_rumor:
        raise ValueError(
            "checkpoint carries multi-rumor state "
            f"({int(np.asarray(tree['rumor_recv']).shape[0])} rumor "
            "lanes) but this run is single-rumor; restore with the "
            "snapshot's -rumors / -traffic flags")
    if cfg.model == "pushsum":
        # PushSum's state has no rumor leaves.
        from gossip_simulator_tpu_torch.models import pushsum as _ps

        want_cols = np.asarray(tree["mass"]).shape[1]
        if want_cols != _ps.mass_cols(cfg):
            raise ValueError(
                f"checkpoint mass is {want_cols} limb column(s) wide but "
                f"-pushsum-dim {cfg.pushsum_dim} needs "
                f"{_ps.mass_cols(cfg)}; restore with the snapshot's "
                "-pushsum-dim")
    elif cfg.multi_rumor:
        ckpt_w = int(np.asarray(tree["rumor_words"]).shape[1])
        if ckpt_w != cfg.rumor_word_count:
            raise ValueError(
                f"checkpoint rumor bitmask is {ckpt_w} word(s) wide but "
                f"-rumors {cfg.rumors} needs {cfg.rumor_word_count} "
                "(= ceil(R/32)); restore with the snapshot's -rumors")
    else:
        # A snapshot from before the rumor axis, into a single-rumor run:
        # the 1-element placeholders (nothing was in flight on it).
        u1 = np.zeros((1, 1), np.uint32)
        fills = {"rumor_words": u1, "rumor_recv": np.zeros((1,), np.int32),
                 "rumor_done": np.full((1,), -1, np.int32)}
        if ckpt_engine == "event":
            fills["mail_words"] = u1
        else:
            fills["pending_rumors"] = np.zeros((1, 1, 1), np.int32)
        for k, v in fills.items():
            if k not in tree:
                tree[k] = v
    if ckpt_engine == "event":
        if cfg.model == "pushsum":
            # PushSum sizes its ring for the emission volume: its module
            # is the geometry authority, and the mass limb columns ride
            # the repack as the `words` companion.
            from gossip_simulator_tpu_torch.models import pushsum as geo
        else:
            geo = event
        n_local = n // n_shards
        dw = geo.ring_windows(cfg)
        ncap = geo.slot_cap(cfg, n_local)
        ntail = geo.ring_tail(cfg, n_local)
        per_new = dw * ncap + ntail
        geom = tree.pop("mail_geom", None)
        s_ckpt = (int(geom[2]) if geom is not None and len(geom) > 2 else 1)
        if tuple(tree["mail_cnt"].shape) != (s_ckpt, dw):
            raise ValueError(
                "checkpoint window-ring shape "
                f"{tuple(tree['mail_cnt'].shape)} does not match its "
                f"{s_ckpt} shard(s) x this config's {dw} windows; restore "
                "with the snapshot's -delaylow/-delayhigh")
        if "sup_cnt" not in tree:
            # A snapshot from before duplicate suppression: no deferred
            # duplicate credits pending.
            tree["sup_cnt"] = np.zeros((s_ckpt, dw), np.int32)
        mail_len = int(tree["mail_ids"].shape[0])
        if geom is None:
            # No geometry recorded: only the exact layout restores
            # (repacking blind would mis-index slots).
            if n_shards != 1 or mail_len != per_new:
                raise ValueError(
                    f"checkpoint mail-ring geometry ({mail_len},) does not "
                    f"match this config's ({n_shards * per_new},) and the "
                    "snapshot predates geometry metadata; restore with the "
                    "same -delaylow/-delayhigh/-event-slot-cap/-event-chunk "
                    "it was written with, single-device")
        else:
            ocap, ochunk = int(geom[0]), int(geom[1])
            # The tail is not stored: it is what the length leaves past
            # the slots, and no layout ever had it below the chunk.
            per_old = mail_len // s_ckpt
            otail = per_old - dw * ocap
            if mail_len % s_ckpt or otail < ochunk:
                raise ValueError(
                    f"checkpoint mail_ids length {mail_len} contradicts "
                    f"its stored geometry (cap={ocap}, chunk={ochunk}, "
                    f"{s_ckpt} shard(s))")
            comp_key = ("mail_mass" if cfg.model == "pushsum"
                        else ("mail_words" if cfg.multi_rumor else None))
            mw = np.asarray(tree[comp_key]) if comp_key else None
            if s_ckpt != n_shards:
                # Another shard count: every in-flight entry is decoded to
                # its global destination and re-bucketed, its companion
                # row with it.
                mail2, cnt2, sup2, lost, mw2 = reshard_mail_rings(
                    np.asarray(tree["mail_ids"]),
                    np.asarray(tree["mail_cnt"]),
                    np.asarray(tree["sup_cnt"]), cfg, s_ckpt, n_shards,
                    dw, ocap, otail, words=mw, geom=geo)
                tree["mail_ids"], tree["mail_cnt"] = mail2, cnt2
                tree["sup_cnt"] = sup2
                if mw2 is not None:
                    tree[comp_key] = mw2
                tree["mail_dropped"] = np.asarray(
                    tree["mail_dropped"]) + np.int32(lost)
            elif per_old != per_new or ocap != ncap:
                old = np.asarray(tree["mail_ids"])
                cnt = np.asarray(tree["mail_cnt"])
                mails, cnts, words, lost = [], [], [], 0
                for sh in range(n_shards):
                    m, c, sl, w2 = repack_mail_ring(
                        old[sh * per_old:(sh + 1) * per_old], cnt[sh],
                        ocap, otail, ncap, ntail, dw,
                        words=(mw[sh * per_old:(sh + 1) * per_old]
                               if mw is not None else None))
                    mails.append(m)
                    cnts.append(c)
                    if w2 is not None:
                        words.append(w2)
                    lost += sl
                tree["mail_ids"] = np.concatenate(mails)
                tree["mail_cnt"] = np.stack(cnts)
                if words:
                    tree[comp_key] = np.concatenate(words)
                tree["mail_dropped"] = np.asarray(
                    tree["mail_dropped"]) + np.int32(lost)
    else:
        d = epidemic.ring_depth(cfg)
        if tuple(tree["pending"].shape) != (d, n):
            raise ValueError(
                f"checkpoint delay ring {tuple(tree['pending'].shape)} "
                f"does not match this config's ({d}, {n}); restore with "
                "the snapshot's -delaylow/-delayhigh/-time-mode")
    tm = np.asarray(tree["total_message"])
    if tm.ndim == 0:
        # The scalar int32 counter of older snapshots -> [hi, lo]; the
        # mask also recovers a counter that had wrapped negative once.
        tree["total_message"] = np.asarray(
            [0, int(tm) & 0xFFFFFFFF], dtype=np.uint32)
    # --- the fault-scenario leaves (scenario.py) ---------------------------
    from gossip_simulator_tpu_torch import scenario as _scen

    want_down = _scen.down_shape(cfg.faults_enabled, n)
    if "down_since" not in tree:
        # A snapshot from before scenarios: no crash clock running.
        tree["down_since"] = np.full((want_down,), -1, np.int32)
    elif int(np.asarray(tree["down_since"]).shape[0]) != want_down:
        if int(np.asarray(tree["down_since"]).shape[0]) == 1:
            # A fault-free snapshot into a scenario run: every crash so
            # far has an unknown crash time, which -1 encodes.
            tree["down_since"] = np.full((want_down,), -1, np.int32)
        else:
            raise ValueError(
                "checkpoint carries a full fault-scenario crash clock "
                f"({int(np.asarray(tree['down_since']).shape[0])} rows) "
                "but this run's fault machinery is off; restore with the "
                "snapshot's -scenario/-overlay-heal flags")
    for f in ("scen_crashed", "scen_recovered", "part_dropped",
              "heal_repaired"):
        if f not in tree:
            tree[f] = np.zeros((), np.int32)
    # The spatial-telemetry exchange counters are gauges of the restoring
    # run's own shard count and flags, not trajectory state: rebuilt at 0.
    tree["exch_counts"] = np.zeros(
        (n_shards, exch_counts_width(cfg, n_shards)), np.int32)
    return tree


def prepare_overlay_restore_tree(tree: dict, cfg, n_shards: int) -> dict:
    """Validate a phase-1 state dict (the rounds overlay's or the
    tick-faithful overlay's) for a stepper of `n_shards` shards.  There
    is no repack: the ring's slot capacity and the emission buffers'
    widths are derived sizes, so a snapshot restores only under the same
    geometry, and each mismatch names the flag to fix.  The spill buffers
    of older or other-sized builds are re-padded, keeping their
    in-flight pairs."""
    from gossip_simulator_tpu_torch.models import overlay_ticks as ot

    ckpt_mode = "ticks" if "ring_dst" in tree else "rounds"
    if cfg.graph != "overlay":
        raise ValueError(
            "snapshot holds mid-construction overlay state but this run "
            f"has -graph {cfg.graph}; restore with -graph overlay")
    if ckpt_mode != cfg.overlay_mode_resolved:
        raise ValueError(
            f"overlay checkpoint was written by the {ckpt_mode} engine "
            f"but this run resolves to {cfg.overlay_mode_resolved}; pass "
            f"-overlay-mode {ckpt_mode} to restore it")
    tree = dict(tree)
    n, k = (int(d) for d in tree["friends"].shape)
    if n != cfg.n:
        raise ValueError(f"checkpoint has n={n} but this run has n={cfg.n}")
    if ckpt_mode == "rounds":
        from gossip_simulator_tpu_torch.models import overlay as _ov

        # The spill size init_state builds for this run (sharded: the
        # flat floor, its routed delivery never spills).
        sc = (_ov.spill_cap_for(cfg, n) if n_shards == 1
              else (_ov.SPILL_CAP
                    if _ov.spill_enabled(cfg.mailbox_cap_for(n // n_shards))
                    else 0))
        if n_shards > 1:
            for f in ("mk_spill", "bk_spill"):
                if f in tree and (np.asarray(tree[f])[1] >= 0).any():
                    raise ValueError(
                        f"snapshot holds undelivered {f} overflow pairs; "
                        "the sharded overlay engine cannot deliver them "
                        "-- finish phase 1 (or at least drain the spill) "
                        "single-device before resharding")
        for f in ("mk_spill", "bk_spill"):
            if f not in tree:
                tree[f] = np.full((2, sc + 1), -1, np.int32)
            elif tuple(tree[f].shape) != (2, sc + 1):
                old_arr = np.asarray(tree[f])
                live = old_arr[:, old_arr[1] >= 0]
                if live.shape[1] > sc:
                    raise ValueError(
                        f"checkpoint {f} holds {live.shape[1]} in-flight "
                        f"pairs but this build's spill capacity is {sc}")
                pad = np.full((2, sc + 1), -1, np.int32)
                pad[:, :live.shape[1]] = live
                tree[f] = pad
    if k != cfg.max_degree:
        raise ValueError(
            f"checkpoint friend lists have capacity {k} but this config's "
            f"max degree is {cfg.max_degree}; restore with the snapshot's "
            "-fanout/-fanin")
    n_local = n // n_shards
    if ckpt_mode == "ticks":
        sc = ot.ticks_spill_cap(cfg) if n_shards == 1 else 0
        if n_shards > 1 and "spill" in tree and (
                np.asarray(tree["spill"])[1] >= 0).any():
            raise ValueError(
                "snapshot holds undelivered ticks-overlay spill overflow "
                "pairs; the sharded overlay engine cannot deliver them -- "
                "finish phase 1 (or at least drain the spill) "
                "single-device before resharding")
        if "spill" not in tree:
            tree["spill"] = np.full((2, sc + 1), -1, np.int32)
        elif tuple(tree["spill"].shape) != (2, sc + 1):
            old_arr = np.asarray(tree["spill"])
            live = old_arr[:, old_arr[1] >= 0]
            if live.shape[1] > sc:
                raise ValueError(
                    f"checkpoint spill holds {live.shape[1]} in-flight "
                    f"pairs but this build's spill capacity is {sc}")
            pad = np.full((2, sc + 1), -1, np.int32)
            pad[:, :live.shape[1]] = live
            tree["spill"] = pad
        dw = ot.ring_windows(cfg)
        if tuple(tree["ring_cnt"].shape) != (n_shards, dw):
            raise ValueError(
                f"checkpoint window-ring shape {tuple(tree['ring_cnt'].shape)}"
                f" does not match this config's ({n_shards}, {dw}); restore "
                "on the snapshot's device count with its "
                "-delaylow/-delayhigh")
        cap = ot.slot_cap(cfg, n_local if n_shards > 1 else None)
        want = n_shards * (dw * cap + 1)
        if int(tree["ring_dst"].shape[0]) != want:
            raise ValueError(
                f"checkpoint ring length {int(tree['ring_dst'].shape[0])} "
                f"does not match this config's {want} (slot cap {cap} x "
                f"{dw} windows over {n_shards} shard(s))")
    else:
        cap_mb = cfg.mailbox_cap_for(n_local)
        if int(tree["mk_dst"].shape[0]) != cap_mb:
            width = int(tree["mk_dst"].shape[0])
            raise ValueError(
                f"checkpoint emission buffers are {width} wide but this "
                f"config's mailbox cap gives {cap_mb}; restore with the "
                "snapshot's -mailbox-cap / device count")
    return tree


def reshard_mail_rings(mail: np.ndarray, cnt: np.ndarray, sup: np.ndarray,
                       cfg, s_old: int, s_new: int, dw: int, ocap: int,
                       otail: int, words: Optional[np.ndarray] = None,
                       geom=None):
    """Re-bucket `s_old` concatenated per-shard mail rings onto `s_new`
    shards.  An entry packs its destination's local row (``dst_local * B
    + off``; a SIR trigger at ``trigger_base(n_local) + id * B + off``),
    which depends on the shard's row count, so each in-flight entry is
    decoded to its global destination and re-encoded.  In a new (shard,
    slot), entries keep old-shard-major order.  ``sup_cnt`` is only ever
    summed across shards: its per-slot totals land on shard 0.  Entries
    past the new slot capacity are dropped and counted.  `words` (the
    rumor-word or PushSum mass companion ring, any dtype) moves with its
    entries; `geom` is the slot-geometry module (default the event
    engine's).  Returns (mail, cnt, sup, lost, words) in the new geometry
    (words None when not given)."""
    from gossip_simulator_tpu_torch.models import event

    geo = geom if geom is not None else event
    n = cfg.n
    b = geo.batch_ticks(cfg)
    nlo, nln = n // s_old, n // s_new
    ncap = geo.slot_cap(cfg, nln)
    ntail = geo.ring_tail(cfg, nln)
    per_old, per_new = dw * ocap + otail, dw * ncap + ntail
    sir = cfg.protocol == "sir"
    tbo, tbn = event.trigger_base(nlo, b), event.trigger_base(nln, b)
    new_mail = np.zeros((s_new * per_new,), np.int32)
    new_cnt = np.zeros((s_new, dw), np.int32)
    new_words = (np.zeros((s_new * per_new, words.shape[1]), words.dtype)
                 if words is not None else None)
    lost = 0
    for slot in range(dw):
        segs = []
        for sh in range(s_old):
            c = int(cnt[sh, slot])
            at0 = sh * per_old + slot * ocap
            seg = mail[at0:at0 + c].astype(np.int64)
            trig = seg >= tbo if sir else np.zeros(seg.shape, bool)
            base = np.where(trig, seg - tbo, seg)
            gid = base // b + sh * nlo
            off = base % b
            segs.append((gid, off, trig, at0 + np.arange(c)))
        gid = np.concatenate([s[0] for s in segs])
        off = np.concatenate([s[1] for s in segs])
        trig = np.concatenate([s[2] for s in segs])
        pos = np.concatenate([s[3] for s in segs])
        nsh = gid // nln
        ndl = gid % nln
        ent = np.where(trig, tbn + ndl * b + off, ndl * b + off)
        for t in range(s_new):
            sel = nsh == t
            e = ent[sel].astype(np.int32)
            take = min(len(e), ncap)
            lost += len(e) - take
            at = t * per_new + slot * ncap
            new_mail[at:at + take] = e[:take]
            if new_words is not None:
                new_words[at:at + take] = words[pos[sel][:take].astype(
                    np.int64)]
            new_cnt[t, slot] = take
    new_sup = np.zeros((s_new, dw), np.int32)
    new_sup[0] = sup.astype(np.int64).sum(axis=0)
    return new_mail, new_cnt, new_sup, lost, new_words


def repack_mail_ring(mail: np.ndarray, cnt: np.ndarray, ocap: int,
                     otail: int, ncap: int, ntail: int, dw: int,
                     words: Optional[np.ndarray] = None):
    """Repack one packed mail ring (slot s at ``[s*cap, (s+1)*cap)``,
    then a `tail` of slack) from slot geometry (ocap, otail) to (ncap,
    ntail): a snapshot written under other ``-event-*`` flags or another
    auto sizing.  Entries past the new capacity are dropped and counted.
    `cnt` is the per-slot count, shape (dw,); `words` (the companion
    ring) moves with its entries.  Returns (new_mail, clamped_cnt, lost,
    new_words), words None when not given."""
    if mail.shape[0] != dw * ocap + otail:
        raise ValueError(
            f"mail ring length {mail.shape[0]} contradicts its geometry "
            f"(cap={ocap}, tail={otail}, dw={dw})")
    new = np.zeros((dw * ncap + ntail,), mail.dtype)
    new_words = (np.zeros((dw * ncap + ntail, words.shape[1]), words.dtype)
                 if words is not None else None)
    lost = 0
    for s in range(dw):
        take = min(int(cnt[s]), ncap)
        lost += int(cnt[s]) - take
        new[s * ncap:s * ncap + take] = mail[s * ocap:s * ocap + take]
        if new_words is not None:
            new_words[s * ncap:s * ncap + take] = \
                words[s * ocap:s * ocap + take]
    return new, np.minimum(cnt, ncap), lost, new_words
