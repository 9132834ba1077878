"""The spatial panels on the sharded backend against the JAX package: both
sides run ``ShardedStepper(cfg, n_devices=S)`` in process (the port's
shards on the CPU, the JAX package's on its fake 8-device mesh) with
``-run-dir`` (``torch_rundir.run_side``), ``-exchange-pipeline off``.
Cases: the event engine on 2 shards, the churn timeline with healing on
8 (two scenario groups; the seed's, the emission's and the heal's routes
all count), PushSum on 8, and the churn case on 8 with both packages'
route caps cut so that the overflow column moves.  The three panels,
the traffic matrix among them, are the JAX package's, and they keep the
JAX package's identities every window: the groups' received sum to the
received column, the shards' mail high-water maxes to mail_high, the
matrix's column sums are the shards' routed lanes received, it is
monotone, and the shards' overflow sums to the overflow column.  Under
those runs, the port's route counts (both rank paths, with and without
overflow) are the JAX package's ``route_multi(traffic=)``'s and, since
the port's ``double`` keeps that route, ``route_multi_pipelined``'s.

Then snapshots that carry the exchange counters: one written by the JAX
package on 8 shards resumes on 1 in both packages, one written by the
port on 1 resumes on 8 in both; the restored trees are equal (the
counters zeros shaped for the restoring run), and the resumed runs give
the same Stats window for window, the same transcript and final
counters."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ckpt as ck
import torch_rundir as rd
from gossip_simulator_tpu.backends.sharded import ShardedStepper as JSharded
from gossip_simulator_tpu.config import parse_args as jparse
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.parallel import exchange as jex
from gossip_simulator_tpu.parallel.mesh import node_mesh, shard_map
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TSharded
from gossip_simulator_tpu_torch.config import parse_cli as tparse
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.parallel import exchange as tex
from gossip_simulator_tpu_torch.utils import checkpoint as tck
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from gossip_simulator_tpu_torch.utils.telemetry import GCOL
from test_torch_rng import match_jax_threefry
from test_torch_sharded import _route_inputs
from test_torch_sharded_faults import CHURN, tight_caps

KOUT = ["-graph", "kout", "-n", "4000", "-fanout", "6", "-seed", "3",
        "-crashrate", "0", "-exchange-pipeline", "off"]
HEAL = ["-scenario", CHURN, "-overlay-heal", "on", "-coverage-target",
        "0.99", "-max-rounds", "300"]
PS = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout", "6",
      "-droprate", "0", "-crashrate", "0", "-seed", "1",
      "-exchange-pipeline", "off"]
SPATIAL = ["-telemetry-spatial", "on"]
# name: (argv, shards, groups)
CASES = {
    "event_s2": (KOUT, 2, 2),
    "churn_heal_s8": (KOUT + HEAL, 8, 2),
    "pushsum_s8": (PS, 8, 8),
    # Seed 5: no run of another case is reused.
    "overflow_s8": (KOUT + HEAL + ["-seed", "5"], 8, 2),
}


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


def _jax_traffic(d, s, cap, sort_buckets, pipelined):
    """The JAX package's route of `d` inside its shard_map, counting into
    a zero (1, S + 2) leaf a shard: (the first payload received, (S,
    S + 2) counts)."""
    width = d["rows"].shape[2]

    def body(wire, rows, dest, valid):
        pays = (wire[0],) + tuple(rows[0, :, c] for c in range(width))
        t0 = jnp.zeros((1, s + 2), jnp.int32)
        if pipelined:
            recvs, _, _, t = jex.route_multi_pipelined(
                pays, dest[0], valid[0], s, cap, (),
                sort_buckets=sort_buckets, traffic=t0)
        else:
            recvs, _, t = jex.route_multi(pays, dest[0], valid[0], s, cap,
                                          sort_buckets=sort_buckets,
                                          traffic=t0)
        return recvs[0][None], t

    spec = P("nodes", None)
    fn = jax.jit(shard_map(
        body, mesh=node_mesh(s),
        in_specs=(spec, P("nodes", None, None), spec, spec),
        out_specs=(spec, spec)))
    recv, counts = fn(d["wire"], d["rows"], d["dest"], d["valid"])
    return np.asarray(recv), np.asarray(counts)


@pytest.mark.parametrize("pipelined", (False, True))
@pytest.mark.parametrize("s,m,cap", ((2, 300, 200), (8, 512, 24)))
def test_route_traffic_counts_equal_the_jax_package(s, m, cap, pipelined):
    d = _route_inputs(s * m + cap, s, m)
    for sort_buckets in (False, True):
        want_recv, want = _jax_traffic(d, s, cap, sort_buckets, pipelined)
        traffic = [torch.zeros((1, s + 2), dtype=torch.int32)
                   for _ in range(s)]
        recvs, ovf = tex.route_multi(
            [(torch.from_numpy(w), torch.from_numpy(r))
             for w, r in zip(d["wire"], d["rows"])],
            [torch.from_numpy(x) for x in d["dest"]],
            [torch.from_numpy(x) for x in d["valid"]], s, cap,
            sort_buckets=sort_buckets, traffic=traffic)
        got = torch.cat(traffic).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(np.stack([r[0].numpy() for r in recvs]),
                              want_recv)
        assert got[:, :s].sum(axis=0).tolist() == got[:, s].tolist()
        assert got[:, s + 1].tolist() == [int(o) for o in ovf]
    if cap < 100:
        assert want[:, s + 1].sum() > 0  # the overflow column moves


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            argv, shards, _ = CASES[name]
            base = tmp_path_factory.mktemp(name)
            sides = {}
            for side, ex in (("port", tex), ("ref", jex)):
                if name == "overflow_s8":
                    with tight_caps(ex):
                        sides[side] = rd.run_side(side, argv + SPATIAL,
                                                  base / side, shards)
                else:
                    sides[side] = rd.run_side(side, argv + SPATIAL,
                                              base / side, shards)
            made[name] = sides
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_panels_equal_the_jax_package(runs, name):
    r = runs(name)
    (prc, pout, pdir), (rrc, rout, rdir) = r["port"], r["ref"]
    assert prc == rrc
    assert rd.masked_stdout(pout) == rd.masked_stdout(rout)
    rd.check_result_and_npz(pdir, rdir)
    health = [json.load(open(d / "run" / "health.json"))
              for d in (pdir, rdir)]
    assert health[0] == health[1]
    _, shards, groups = CASES[name]
    with np.load(pdir / "run" / "telemetry.npz") as z:
        cols, grp, shd, tr = (z[k] for k in ("gossip_cols", "spatial_group",
                                             "spatial_shard",
                                             "spatial_traffic"))
    count = cols.shape[0]
    assert grp.shape == (count, groups, 3)
    assert shd.shape == (count, shards, 5)
    assert tr.shape == (count, shards, shards)
    assert (grp[:, :, 0].sum(axis=1) == cols[:, GCOL["received"]]).all()
    assert (shd[:, :, 0].max(axis=1) == cols[:, GCOL["mail_high"]]).all()
    assert (shd[:, :, 1].sum(axis=1) == cols[:, GCOL["received"]]).all()
    rcvd = shd[:, :, 4]
    assert (tr.sum(axis=1) == rcvd).all()
    assert (np.diff(tr, axis=0) >= 0).all()
    assert tr[-1].sum() == rcvd[-1].sum() and (tr[-1] > 0).all()
    assert (shd[:, :, 2].sum(axis=1) == cols[:, GCOL["overflow"]]).all()
    if name == "overflow_s8":
        assert cols[-1, GCOL["overflow"]] > 0
    if name == "pushsum_s8":
        assert (shd[:, :, 3] == cols[:, None, GCOL["relerr_ppb"]]).all()


# Snapshot writers (package, argv, backend) and the resumes:
# name: (writer, the restoring run's shards).
WRITE = ["-checkpoint-every", "4", "-max-rounds", "40"]
WRITERS = {"ref_s8": ("ref", KOUT + SPATIAL, "sharded"),
           "port_s1": ("port", KOUT + SPATIAL, "sharded")}
RESUMES = {"8_to_1": ("ref_s8", 1), "1_to_8": ("port_s1", 8)}


class Recording:
    """A stepper as run_simulation sees it: the state dict right after the
    restore and each window's Stats."""

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


def _resume(side, argv, shards):
    if side == "port":
        cfg, _ = tparse(argv)
        rec = Recording(TSharded(cfg, n_devices=shards, device="cpu"))
        printer, run = TPrinter, trun
    else:
        cfg = jparse(argv)
        rec = Recording(JSharded(cfg, n_devices=shards))
        printer, run = JPrinter, jrun
    out = io.StringIO()
    run(cfg, printer=printer(out=out), stepper=rec)
    return out.getvalue(), rec


@pytest.mark.parametrize("name", sorted(RESUMES))
def test_exchange_counters_resume_across_shard_counts(tmp_path, name):
    writer, shards = RESUMES[name]
    side, argv, backend = WRITERS[writer]
    src = tmp_path / "ckpt"
    ck.run_cli(side, argv + WRITE + ["-backend", backend,
                                     "-checkpoint-dir", str(src)])
    tree, _ = tck.load(tck.latest(str(src)))
    wrote = np.asarray(tree["exch_counts"])
    assert wrote.shape == ((8, 10) if writer == "ref_s8" else (1, 1))
    assert wrote.any() == (writer == "ref_s8")
    runs = {}
    for s in ck.SIDES:
        d = ck.copy_dir(src, tmp_path / s)
        runs[s] = _resume(s, argv + ["-backend", "sharded", "-resume",
                                     "-checkpoint-dir", str(d)], shards)
    (pout, prec), (rout, rrec) = runs["port"], runs["ref"]
    ck.assert_same_leaves(rrec.loaded, prec.loaded)
    width = shards + 2 if shards > 1 else 1
    assert np.asarray(prec.loaded["exch_counts"]).shape == (shards, width)
    assert not np.asarray(prec.loaded["exch_counts"]).any()
    assert prec.rows and prec.rows == rrec.rows
    assert pout == rout
    ck.assert_same_leaves(rrec.state_pytree(), prec.state_pytree())
    if shards > 1:
        assert np.asarray(prec.state_pytree()["exch_counts"]).any()
