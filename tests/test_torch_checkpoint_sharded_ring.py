"""Snapshots of the sharded overlays and of the sharded ring engine
crossing between the packages (``ShardedStepper(cfg, n_devices=S)`` on
both sides: the port's shards on the CPU, the JAX package's on its fake
8-device mesh).

* Phase 1: a mid-construction snapshot of the tick-faithful overlay and
  of the rounds overlay, taken by either package on S shards, loads into
  the other package's stepper of the same S; the loaded tree is the
  snapshot leaf for leaf, and the rest of construction (each window's
  makeups, breakups and quiescence) and the phase-2 run after it (the
  per-window Stats, the final leaves) are the writer's own uninterrupted
  run's.
* Phase 2: the ring engine's state has no shard layout of its own, so a
  snapshot restores onto any S: one the JAX package wrote on 8 shards
  resumes on 1 and one the port wrote on 1 resumes on 8, in both
  packages, to the same Stats window for window and the same leaves;
  and the JAX package's 8-shard state continues in the port on 8 shards
  to the reference's own Stats and leaves.
"""

import numpy as np
import pytest

from gossip_simulator_tpu.backends.sharded import ShardedStepper as JSharded
from gossip_simulator_tpu.config import Config as JConfig
from gossip_simulator_tpu_torch.backends import ShardedStepper as TSharded
from gossip_simulator_tpu_torch.config import Config as TConfig
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry
from test_torch_sharded_twins import _assert_same_leaves, _row

OV = dict(n=2000, seed=1, coverage_target=0.9, telemetry="off",
          exchange_pipeline="off", backend="sharded")
# name: (Config fields, shards, overlay windows before the snapshot)
PHASE1 = {
    "ticks_s8": (OV, 8, 3),
    "rounds_s2": (dict(OV, time_mode="rounds", seed=3), 2, 2),
}
RING = dict(engine="ring", graph="kout", n=2000, fanout=6, seed=5,
            telemetry="off", exchange_pipeline="off", backend="sharded")
SNAP = 4  # gossip windows before a phase-2 snapshot
MORE = 5  # windows run after it


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


def _stepper(side, kw, shards):
    if side == "port":
        st = TSharded(TConfig(**kw).validate(), n_devices=shards,
                      device="cpu")
    else:
        st = JSharded(JConfig(**kw).validate(), n_devices=shards)
    st.init()
    return st


def _tree(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _finish(st, windows=MORE):
    """The rest of the overlay (each window's (makeups, breakups,
    quiesced)), then the seed and `windows` gossip windows' Stats."""
    overlay = []
    while not overlay or not overlay[-1][2]:
        overlay.append(tuple(int(x) for x in st.overlay_window()))
    st.seed()
    rows = [_row(st.gossip_window()) for _ in range(windows)]
    return overlay, rows, _tree(st.state_pytree())


@pytest.mark.parametrize("writer", ("port", "ref"))
@pytest.mark.parametrize("name", sorted(PHASE1))
def test_phase1_snapshot_crosses_at_the_same_shard_count(name, writer):
    kw, shards, windows = PHASE1[name]
    reader = "ref" if writer == "port" else "port"
    w = _stepper(writer, kw, shards)
    for _ in range(windows):
        assert not w.overlay_window()[2]
    tree = _tree(w.overlay_state_pytree())
    r = _stepper(reader, kw, shards)
    r.load_overlay_state_pytree(dict(tree), windows=windows)
    _assert_same_leaves(tree, _tree(r.overlay_state_pytree()))
    want, got = _finish(w), _finish(r)
    assert got[0] == want[0] and got[1] == want[1]
    _assert_same_leaves(want[2], got[2])


def _ring_tree(side, shards):
    st = _stepper(side, RING, shards)
    st.seed()
    rows = [_row(st.gossip_window()) for _ in range(SNAP)]
    return rows, _tree(st.state_pytree())


def _resume(side, tree, shards):
    st = _stepper(side, RING, shards)
    st.load_state_pytree(dict(tree))
    rows = [_row(st.gossip_window()) for _ in range(MORE)]
    return rows, _tree(st.state_pytree())


@pytest.mark.parametrize("write,read", ((("ref", 8), 1), (("port", 1), 8)),
                         ids=("8_to_1", "1_to_8"))
def test_ring_snapshot_reshards_in_both_packages(write, read):
    _, tree = _ring_tree(*write)
    want, got = _resume("ref", tree, read), _resume("port", tree, read)
    assert got[0] == want[0]
    _assert_same_leaves(want[1], got[1])


def test_jax_ring_state_continues_in_the_port():
    """The reference's 8-shard ring state after SNAP windows, loaded into
    the port, runs the reference's next windows to its Stats and
    leaves."""
    st = _stepper("ref", RING, 8)
    st.seed()
    for _ in range(SNAP):
        st.gossip_window()
    tree = _tree(st.state_pytree())
    want = [_row(st.gossip_window()) for _ in range(MORE)]
    got, leaves = _resume("port", tree, 8)
    assert got == want
    _assert_same_leaves(_tree(st.state_pytree()), leaves)
