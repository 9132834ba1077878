"""Resharding and repacking under ``-backend sharded`` on the CPU: a
snapshot of S shards resumes onto S' shards through ``run_simulation``
with ``ShardedStepper(cfg, n_devices=S')`` (the port's laid out on the
CPU, the JAX package's on its fake 8-device mesh) or the single-device
steppers, both sides from the same snapshot.  The restored ring holds
the snapshot's in-flight entries exactly (the multiset of global
(destination, slot, tick offset) triples), the restored trees are equal
leaf for leaf, and the two resumed runs give the same Stats window for
window and the same transcript.  Cases: S = 1 -> 8 and 8 -> 1 (SI), 8 ->
8 at another ``-event-slot-cap`` (a per-shard repack), 1 -> 2, and
PushSum 1 -> 8 from a snapshot the port wrote."""

import io

import numpy as np
import pytest

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
import torch_ckpt as ck


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


# The JAX package resolves -exchange-pipeline auto to double on its fake
# mesh, the port to off: both run off (the note line then agrees).
KOUT = ["-graph", "kout", "-n", "4000", "-fanout", "6", "-seed", "5",
        "-telemetry", "off", "-exchange-pipeline", "off"]
PS = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout", "6",
      "-droprate", "0", "-crashrate", "0", "-seed", "1", "-telemetry", "off",
      "-exchange-pipeline", "off"]
WRITE = ["-checkpoint-every", "6", "-max-rounds", "60"]
# The writers: (writer package, argv, backend).  The JAX package's CLI
# lays -backend sharded out on its 8 fake devices, the port's on 1.
WRITERS = {"si_s1": ("ref", KOUT, "jax"), "si_s8": ("ref", KOUT, "sharded"),
           "pushsum_s1": ("port", PS, "jax")}
# name: (writer, the restoring backend's shard count (None: one
# device), extra flags of the restoring run)
CASES = {
    "si_1_to_8": ("si_s1", 8, []),
    "si_1_to_2": ("si_s1", 2, []),
    "si_8_to_1": ("si_s8", None, []),
    "si_8_to_8_repack": ("si_s8", 8, ["-event-slot-cap", "3000"]),
    "pushsum_1_to_8": ("pushsum_s1", 8, []),
}


class Recording:
    """A stepper as run_simulation sees it, recording the state dict
    right after the restore and each window's Stats."""

    def __init__(self, stepper):
        self.inner = stepper
        self.rows = []
        self.loaded = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def load_state_pytree(self, tree):
        self.inner.load_state_pytree(tree)
        self.loaded = self.inner.state_pytree()

    def gossip_window(self):
        st = self.inner.gossip_window()
        self.rows.append(st.to_dict())
        return st


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            side, argv, backend = WRITERS[name]
            d = tmp_path_factory.mktemp(name) / "ckpt"
            ck.run_cli(side, argv + WRITE + ["-backend", backend,
                                             "-checkpoint-dir", str(d)])
            made[name] = d
        return made[name]

    return get


def _resume(side, argv, shards):
    """One side's resumed run: (transcript, the Recording stepper)."""
    if side == "port":
        cfg, _ = tparse(argv)
        inner = (TorchStepper(cfg, device="cpu") if shards is None
                 else TSharded(cfg, n_devices=shards, device="cpu"))
        printer, run = TPrinter, trun
    else:
        cfg = jparse(argv)
        inner = (JaxStepper(cfg) if shards is None
                 else JSharded(cfg, n_devices=shards))
        printer, run = JPrinter, jrun
    rec = Recording(inner)
    out = io.StringIO()
    run(cfg, printer=printer(out=out), stepper=rec)
    return out.getvalue(), rec


@pytest.fixture(scope="module")
def resumed(written, tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            writer, shards, extra = CASES[name]
            _, argv, _ = WRITERS[writer]
            backend = "jax" if shards is None else "sharded"
            runs = {}
            for side in ck.SIDES:
                src = ck.copy_dir(written(writer),
                                  tmp_path_factory.mktemp(name) / side)
                runs[side] = _resume(side, argv + extra + [
                    "-backend", backend, "-resume", "-checkpoint-dir",
                    str(src)], shards)
            made[name] = runs
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_restore_conserves_every_entry(written, resumed, name):
    """The snapshot's in-flight entries, decoded to global (destination,
    slot, offset), are the restored ring's, and the two packages
    restore the same tree."""
    writer, shards, extra = CASES[name]
    _, argv, _ = WRITERS[writer]
    path = tck.latest(str(written(writer)))
    tree, meta = tck.load(path)
    geom = np.asarray(tree["mail_geom"])
    s_ckpt = int(geom[2]) if len(geom) > 2 else 1
    cfg, _ = tparse(argv + extra)
    runs = resumed(name)
    got = runs["port"][1].loaded
    ck.assert_same_leaves(runs["ref"][1].loaded, got)
    if "mass" not in tree:
        want = ck.decode_entries(tree, cfg, s_ckpt)
        assert want.size
        assert np.array_equal(
            ck.decode_entries(got, cfg, shards or 1), want)
    assert int(np.asarray(got["mail_cnt"]).sum()) == int(
        np.asarray(tree["mail_cnt"]).sum())
    assert int(got["mail_dropped"]) == int(tree["mail_dropped"])
    assert meta["window"] == 6


@pytest.mark.parametrize("name", sorted(CASES))
def test_resumed_runs_match_window_for_window(resumed, name):
    runs = resumed(name)
    (pout, prec), (rout, rrec) = runs["port"], runs["ref"]
    assert prec.rows and prec.rows == rrec.rows
    assert prec.rows[-1]["coverage"] >= 0.99
    assert pout == rout
