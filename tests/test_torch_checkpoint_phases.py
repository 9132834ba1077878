"""Phase-1 snapshots and the slot repack, through both CLIs on the CPU
(``torch_ckpt.cross_run``): the tick-faithful and the rounds overlays
snapshot mid-construction, their phase-2 snapshots are deleted, and both
CLIs resume phase 1 from the JAX package's newest ``overlay_*`` with
byte-identical stdout and equal ``result`` records, ending on the
uninterrupted run's Stats and ``stabilize_ms``; and a phase-2 snapshot
resumes at another ``-event-slot-cap`` and another ``-event-chunk`` (the
ring repacked) in both packages alike, with no entry lost."""

import pytest

from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry
import torch_ckpt as ck


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


TICKS = ["-n", "2000", "-seed", "1", "-coverage-target", "0.9"]
ROUNDS = ["-overlay-mode", "rounds", "-n", "3000", "-fanout", "5",
          "-seed", "9", "-coverage-target", "0.9"]
KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6", "-seed", "3"]
EVERY = ["-checkpoint-every", "5"]
# name: (argv, write flags, resume flags, phase 1)
CASES = {
    "ticks_phase1": (TICKS, EVERY, [], True),
    "rounds_phase1": (ROUNDS, EVERY, [], True),
    "repack_slot_cap": (KOUT, ["-checkpoint-every", "6", "-max-rounds",
                               "70"], ["-event-slot-cap", "9000"], False),
    "repack_chunk": (KOUT, ["-checkpoint-every", "6", "-max-rounds", "70"],
                     ["-event-chunk", "1024"], False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            argv, write, resume, phase1 = CASES[name]
            made[name] = ck.cross_run(tmp_path_factory.mktemp(name), argv,
                                      write, resume, phase1)
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_snapshots_cross(runs, name):
    ck.check_cross(runs(name))


@pytest.mark.parametrize("name", ("ticks_phase1", "rounds_phase1"))
def test_phase1_resume_ends_on_the_uninterrupted_run(runs, name, tmp_path):
    run = runs(name)
    assert run["write"]["ref"][2][-1].startswith("overlay_")
    _, out, rec = run["resume"]["port"]
    assert "(overlay window " in out
    want = ck.plain_record(tmp_path, CASES[name][0])
    for key in ck.STATS + ("stabilize_ms", "overlay_windows", "makeups",
                           "breakups"):
        assert rec.get(key) == want.get(key), key


@pytest.mark.parametrize("name", ("repack_slot_cap", "repack_chunk"))
def test_repack_loses_no_entry(runs, name):
    """The snapshot's ring moves to the new geometry whole: the resumed
    run's drop count is the snapshot's plus what its own windows drop,
    and it converges."""
    import json

    run = runs(name)
    with open(run["newest"]["ref"] + ".json") as f:
        meta = json.load(f)
    _, _, rec = run["resume"]["port"]
    assert rec["converged"]
    assert rec["mailbox_dropped"] == meta["mailbox_dropped"] == 0
