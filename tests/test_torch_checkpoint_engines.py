"""Checkpoints of every phase-2 engine the port runs, through both CLIs
on the CPU (``torch_ckpt.cross_run``): the ring engine, PushSum,
``-rumors 4``, a resume in the middle of a fault scenario, and a
fault-free snapshot resumed into a scenario run.  Both packages write
one transcript and equal snapshots; both resume from the JAX package's
snapshot with byte-identical stdout and equal ``result`` records, and a
resumed run ends on the uninterrupted run's Stats.  PushSum's Sigma x
and Sigma w are those of the uninterrupted run's start, across the
restore and to the end."""

import pytest

from gossip_simulator_tpu_torch.models import pushsum
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.checkpoint import load
from test_torch_rng import match_jax_threefry
import torch_ckpt as ck


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6", "-seed", "0"]
CHURN = ('{"groups": 2, "downtime": 60, "events": ['
         '{"type": "churn", "start": 0, "end": 150, "rate": 2.0},'
         '{"type": "crash", "at": 30, "frac": 0.3, "group": 1},'
         '{"type": "partition", "start": 20, "end": 60}]}')
LATE = ('{"groups": 2, "downtime": 60, "events": ['
        '{"type": "crash", "at": 40, "frac": 0.2, "group": 1},'
        '{"type": "partition", "start": 40, "end": 70}]}')
PS = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout", "6",
      "-droprate", "0", "-crashrate", "0", "-seed", "1"]
# name: (argv, write flags, resume flags, held to the uninterrupted run)
CASES = {
    "ring": (["-engine", "ring", "-graph", "kout", "-n", "3000", "-fanout",
              "6", "-seed", "2"], ["-checkpoint-every", "3",
                                   "-max-rounds", "50"], [], True),
    "pushsum": (PS, ["-checkpoint-every", "2", "-max-rounds", "40"], [],
                True),
    "rumors4": (KOUT + ["-rumors", "4", "-crashrate", "0"],
                ["-checkpoint-every", "2", "-max-rounds", "50"], [], True),
    "mid_scenario": (KOUT + ["-crashrate", "0", "-scenario", CHURN,
                             "-overlay-heal", "on", "-coverage-target",
                             "0.99", "-max-rounds", "2000"],
                     ["-checkpoint-every", "3", "-max-rounds", "60"],
                     ["-max-rounds", "2000"], True),
    "faultfree_into_scenario": (KOUT + ["-crashrate", "0"],
                                ["-checkpoint-every", "2", "-max-rounds",
                                 "30"], ["-scenario", LATE], False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            argv, write, resume, _ = CASES[name]
            made[name] = ck.cross_run(tmp_path_factory.mktemp(name), argv,
                                      write, resume)
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_snapshots_cross(runs, name):
    ck.check_cross(runs(name))


@pytest.mark.parametrize("name", sorted(k for k, v in CASES.items() if v[3]))
def test_engine_resume_ends_on_the_uninterrupted_stats(runs, name,
                                                       tmp_path):
    argv, _, resume, _ = CASES[name]
    _, _, rec = runs(name)["resume"]["port"]
    want = ck.plain_record(tmp_path, argv + resume)
    assert {k: rec.get(k) for k in ck.STATS} == \
        {k: want.get(k) for k in ck.STATS}
    if name == "pushsum":
        for key in ("converged_eps", "eps_ticks", "relerr_ppb"):
            assert rec[key] == want[key], key


def test_pushsum_mass_conserved_across_the_restore(runs):
    """The JAX package's mid-run PushSum snapshot in a port stepper:
    Sigma x and Sigma w (masses and live ring rows) equal the
    uninterrupted run's after its seed, right after the load and at the
    end."""
    start = ck.port_stepper(PS)
    start.seed()
    want = pushsum.conserved_totals(start.state, start.cfg)
    tree, _ = load(runs("pushsum")["newest"]["ref"])
    st = ck.port_stepper(PS)
    st.load_state_pytree(tree)
    assert pushsum.conserved_totals(st.state, st.cfg) == want
    while st.gossip_window().coverage < st.cfg.coverage_target:
        pass
    assert pushsum.conserved_totals(st.state, st.cfg) == want
