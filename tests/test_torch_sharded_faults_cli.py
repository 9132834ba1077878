"""``-backend sharded`` with fault scenarios, healing and rumor traffic
through the user entry points, against the JAX package.

* The CLI at S = 1 (what ``-backend sharded`` runs on one card): the
  port's ``cli.main`` on ``-device cpu`` against the JAX package's
  ``run_simulation`` with ``ShardedStepper(cfg, n_devices=1)`` (its own
  CLI lays the backend out on the suite's 8 fake devices), with
  ``-run-dir``, ``-log-jsonl``, ``-trace`` and ``-telemetry-summary``
  (``torch_rundir.py``), under ``-telemetry on`` and ``off``: stdout
  byte-identical (the summary's wall lines masked), result.json's Stats
  and telemetry.npz equal, and ``scripts/compare_runs.py`` exits 0.
* Snapshots across shard counts: a mid-stream ``-rumors 16 -traffic
  stream`` state goes S = 1 -> 8 -> 1 in both packages, each step's tree
  equal leaf for leaf and every in-flight entry kept with its words; and
  mid-churn snapshots of the event engine and of PushSum, written by
  either package at S = 1, resume on 8 shards in both to the same Stats
  window for window.
"""

import io

import numpy as np
import pytest

import torch_ckpt as ck
import torch_rundir as rd
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.backends.sharded import ShardedStepper as JSharded
from gossip_simulator_tpu.config import parse_args as jparse
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TSharded
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.config import parse_cli as tparse
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.utils import checkpoint as tck
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from test_torch_rng import match_jax_threefry

CHURN = ('{"groups": 2, "downtime": 60, "events": [{"type": "churn", '
         '"start": 0, "end": 150, "rate": 2.0}, {"type": "crash", "at": '
         '30, "frac": 0.3, "group": 1}, {"type": "partition", "start": '
         '20, "end": 60}]}')
SHARDED = ["-backend", "sharded", "-exchange-pipeline", "off"]
KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6", "-crashrate", "0"]
SCEN = KOUT + ["-seed", "0", "-scenario", CHURN, "-coverage-target",
               "0.99", "-max-rounds", "600"]
HEAL = SCEN + ["-overlay-heal", "on"]
RUMORS = KOUT + ["-seed", "4", "-coverage-target", "0.95", "-rumors", "4"]
# name: argv (each under -telemetry on and off)
CLI = {"scenario": SCEN, "heal": HEAL, "rumors4": RUMORS}


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.fixture(scope="module")
def cli_twins(tmp_path_factory):
    """Each (case, telemetry) pair's (port, reference) runs, made on first
    use."""
    runs = {}

    def get(name, telemetry):
        key = (name, telemetry)
        if key not in runs:
            base = tmp_path_factory.mktemp(f"{name}_{telemetry}")
            argv = CLI[name] + SHARDED + ["-telemetry", telemetry]
            runs[key] = (rd.run_side("port", argv, base / "port"),
                         rd.run_side("ref", argv, base / "ref", shards=1))
        return runs[key]

    return get


@pytest.mark.parametrize("telemetry", ("on", "off"))
@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_at_one_shard_matches_the_jax_package(cli_twins, name,
                                                  telemetry, capsys):
    (prc, pout, pdir), (rrc, rout, rdir) = cli_twins(name, telemetry)
    assert prc == rrc
    assert rd.masked_stdout(pout) == rd.masked_stdout(rout)
    assert "covered" in pout
    rd.check_result_and_npz(pdir, rdir)
    code = rd.compare_runs_module().main([str(pdir / "run"),
                                          str(rdir / "run")])
    assert code == 0, capsys.readouterr().out


# --- snapshots across shard counts ------------------------------------------


def _stepper(side, argv, shards):
    """An initialized stepper of one package: one device (None) or
    `shards` shards."""
    if side == "port":
        cfg, _ = tparse(argv)
        st = (TorchStepper(cfg, device="cpu") if shards is None
              else TSharded(cfg, n_devices=shards, device="cpu"))
    else:
        cfg = jparse(argv)
        st = JaxStepper(cfg) if shards is None else JSharded(
            cfg, n_devices=shards)
    st.init()
    return st


def _words_of_entries(tree, cfg, s_ckpt):
    """The sorted in-flight (global destination, slot, offset) triples of
    an SI snapshot, each with its rumor-word row (uint32)."""
    from gossip_simulator_tpu_torch.models import event

    b, dw = event.batch_ticks(cfg), event.ring_windows(cfg)
    ocap = int(np.asarray(tree["mail_geom"])[0])
    mail, cnt = np.asarray(tree["mail_ids"]), np.asarray(tree["mail_cnt"])
    words = np.asarray(tree["mail_words"])
    per, nlo = mail.shape[0] // s_ckpt, cfg.n // s_ckpt
    rows = []
    for sh in range(s_ckpt):
        for slot in range(dw):
            at = sh * per + slot * ocap
            for e, w in zip(mail[at:at + int(cnt[sh, slot])],
                            words[at:at + int(cnt[sh, slot])]):
                gid = int(e) // b + sh * nlo
                rows.append(((gid * dw + slot) * b + int(e) % b,)
                            + tuple(int(x) for x in w))
    return sorted(rows)


STREAM = ["-graph", "kout", "-n", "4000", "-fanout", "6", "-seed", "3",
          "-crashrate", "0", "-coverage-target", "0.95", "-rumors", "16",
          "-traffic", "stream", "-stream-rate", "100", "-telemetry", "off",
          "-exchange-pipeline", "off"]


def test_mid_stream_reshard_1_to_8_to_1_keeps_every_entry_and_word():
    """The JAX package's test_multi_reshard_1_to_8_and_back_mid_stream in
    both packages: 12 windows at S = 1, the snapshot onto 8 shards for 2
    windows, back onto one device to the end.  Every tree equals its
    twin's, every restore keeps the in-flight entries with their words,
    and every rumor reaches the target."""
    trees, rows = {}, {}
    for side in ck.SIDES:
        cfg1 = STREAM + ["-backend", "jax"]
        cfg8 = STREAM + ["-backend", "sharded"]
        s1 = _stepper(side, cfg1, None)
        s1.seed()
        rows[side] = [s1.gossip_window().to_dict() for _ in range(12)]
        mid = s1.state_pytree()
        s8 = _stepper(side, cfg8, 8)
        s8.load_state_pytree(dict(mid))
        loaded8 = s8.state_pytree()
        rows[side] += [s8.gossip_window().to_dict() for _ in range(2)]
        back = s8.state_pytree()
        s1b = _stepper(side, cfg1, None)
        s1b.load_state_pytree(dict(back))
        loaded1 = s1b.state_pytree()
        while True:
            st = s1b.gossip_window()
            rows[side].append(st.to_dict())
            if st.coverage >= 0.95 or st.round >= 2000:
                break
        trees[side] = (mid, loaded8, back, loaded1, s1b.state_pytree())
    assert rows["port"] == rows["ref"]
    assert 0 < rows["port"][11]["rumors_done"] < 16
    assert rows["port"][-1]["rumors_done"] == 16
    for want, got in zip(trees["ref"], trees["port"]):
        ck.assert_same_leaves(
            {k: v for k, v in want.items() if k != "host_mailbox_dropped"},
            {k: v for k, v in got.items() if k != "host_mailbox_dropped"})
    cfg, _ = tparse(STREAM)
    mid, loaded8, back, loaded1, _ = trees["port"]
    want = _words_of_entries(mid, cfg, 1)
    assert want and _words_of_entries(loaded8, cfg, 8) == want
    assert _words_of_entries(loaded1, cfg, 1) == _words_of_entries(
        back, cfg, 8)


PS_CHURN = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout",
            "6", "-droprate", "0", "-crashrate", "0", "-seed", "1",
            "-scenario", CHURN, "-overlay-heal", "on", "-telemetry", "off",
            "-exchange-pipeline", "off"]
EV_CHURN = HEAL + ["-telemetry", "off", "-exchange-pipeline", "off"]
WRITE = ["-checkpoint-every", "6", "-max-rounds", "60"]
# name: (writer package, argv)
WRITERS = {"event_ref": ("ref", EV_CHURN), "event_port": ("port", EV_CHURN),
           "pushsum_ref": ("ref", PS_CHURN),
           "pushsum_port": ("port", PS_CHURN)}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            side, argv = WRITERS[name]
            d = tmp_path_factory.mktemp(name) / "ckpt"
            rc, _ = ck.run_cli(side, argv + WRITE + [
                "-backend", "jax", "-checkpoint-dir", str(d)])
            assert rc in (0, 2)
            made[name] = d
        return made[name]

    return get


class _Rows:
    def __init__(self, inner):
        self.inner, self.rows, self.loaded = inner, [], None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def load_state_pytree(self, tree):
        self.inner.load_state_pytree(tree)
        self.loaded = self.inner.state_pytree()

    def gossip_window(self):
        st = self.inner.gossip_window()
        self.rows.append(st.to_dict())
        return st


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_mid_churn_snapshot_resumes_on_8_shards(written, tmp_path, name):
    """A window-6 snapshot (mid-churn: the timeline runs to 150 ms) of one
    package at S = 1 resumes on 8 shards in both packages to the same
    restored tree, Stats window for window and transcript."""
    _, argv = WRITERS[name]
    runs = {}
    for side in ck.SIDES:
        src = ck.copy_dir(written(name), tmp_path / side)
        resume = argv + ["-backend", "sharded", "-max-rounds", "600",
                         "-resume", "-checkpoint-dir", str(src)]
        if side == "port":
            cfg, _ = tparse(resume)
            rec = _Rows(TSharded(cfg, n_devices=8, device="cpu"))
            printer, run = TPrinter, trun
        else:
            cfg = jparse(resume)
            rec = _Rows(JSharded(cfg, n_devices=8))
            printer, run = JPrinter, jrun
        out = io.StringIO()
        run(cfg, printer=printer(out=out), stepper=rec)
        runs[side] = (out.getvalue(), rec)
    (pout, prec), (rout, rrec) = runs["port"], runs["ref"]
    tree, meta = tck.load(tck.latest(str(written(name))))
    assert meta["window"] == 6
    assert int(np.asarray(tree["scen_crashed"])) > 0
    ck.assert_same_leaves(rrec.loaded, prec.loaded)
    assert int(np.asarray(prec.loaded["mail_cnt"]).sum()) == int(
        np.asarray(tree["mail_cnt"]).sum())
    assert prec.rows and prec.rows == rrec.rows
    assert pout == rout
