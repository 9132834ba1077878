"""The sharded backend's pieces on the CPU against the JAX package, with
exact equality:

* the exchange: the port's ``route_multi`` (every shard's
  buffers at once) against the JAX package's inside its ``shard_map`` on
  the fake 8-device mesh, on 2 and 8 shards, lossless and overflowing,
  both rank paths, a 2-D payload against its columns routed as
  separate payloads, and the wire word alone;
* the per-pair caps ``epidemic_cap`` and ``chernoff_cap``;
* ``recv_land_plain`` (``fused_recv_land``'s plain version) against the
  JAX package's Pallas ``fused_recv_land`` (Pallas's generic interpreter,
  as ``test_torch_ops.py`` runs the kernels) and against its unfused
  chain (decode, duplicate filter, ``ring_append``): the duplicate
  filter, word rows, overflow past cap, the trash cell, all-empty
  buffers, 40 ring slots;
* the sharded state's interop round trip, the stepper's shard layout and
  the refusals of what is not ported.

The whole runs, and a JAX sharded state that continues in the port, are
in ``test_torch_sharded_twins.py`` (one module fixture of reference
runs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.ops import mailbox as jmailbox
from gossip_simulator_tpu.ops import pallas_megakernel as jmk
from gossip_simulator_tpu.parallel import exchange as jex
from gossip_simulator_tpu.parallel.mesh import node_mesh, shard_map
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch import run_simulation
from gossip_simulator_tpu_torch.backends import ShardedStepper
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.ops import megakernel
from gossip_simulator_tpu_torch.parallel import exchange as tex
from gossip_simulator_tpu_torch.parallel import mesh as tmesh
from gossip_simulator_tpu_torch.utils import interop
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter
from test_torch_card import RECV_CASES, _recv_inputs, _recv_land
from test_torch_rng import match_jax_threefry

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


# --- the exchange ------------------------------------------------------------


def _route_inputs(seed, s, m, width=3):
    rng = np.random.default_rng(seed)
    return dict(wire=rng.integers(0, 1 << 20, (s, m)).astype(np.int32),
                rows=rng.integers(-5, 1 << 16, (s, m, width)).astype(
                    np.int32),
                dest=rng.integers(0, s, (s, m)).astype(np.int32),
                valid=rng.random((s, m)) < 0.8)


def _jax_route(d, s, cap, sort_buckets):
    """The JAX package's route_multi inside its shard_map: the wire word
    and each row column as a payload.  Returns (recv per payload (s,
    s*cap), overflow (s,))."""
    width = d["rows"].shape[2]

    def body(wire, rows, dest, valid):
        pays = (wire[0],) + tuple(rows[0, :, c] for c in range(width))
        recvs, ovf = jex.route_multi(pays, dest[0], valid[0], s, cap,
                                     sort_buckets=sort_buckets)
        return tuple(r[None] for r in recvs) + (ovf[None],)

    spec = P("nodes", None)
    fn = jax.jit(shard_map(
        body, mesh=node_mesh(s),
        in_specs=(spec, P("nodes", None, None), spec, spec),
        out_specs=(spec,) * (width + 1) + (P("nodes"),)))
    out = fn(d["wire"], d["rows"], d["dest"], d["valid"])
    return [np.asarray(x) for x in out[:-1]], np.asarray(out[-1])


@pytest.mark.parametrize("s,m,cap", ((2, 300, 200), (2, 300, 60),
                                     (8, 512, 128), (8, 512, 24)))
def test_route_matches_the_jax_package(s, m, cap):
    """Bucket order, -1 fill, overflow counts and the transposed delivery
    order, for a flat payload and a 2-D one, both rank paths."""
    d = _route_inputs(s + cap, s, m)
    want, want_ovf = _jax_route(d, s, cap, None)
    args = ([T(x) for x in d["dest"]], [T(x) for x in d["valid"]], s, cap)
    for sort_buckets in (False, True):
        recvs, ovf = tex.route_multi(
            [(T(w), T(r)) for w, r in zip(d["wire"], d["rows"])], *args,
            sort_buckets=sort_buckets)
        assert np.array_equal(np.stack([o.numpy() for o in ovf]), want_ovf)
        for dst in range(s):
            wire, rows = recvs[dst]
            assert np.array_equal(wire.numpy(), want[0][dst])
            for c in range(rows.shape[1]):
                assert np.array_equal(rows[:, c].numpy(), want[1 + c][dst])
        one, ovf1 = tex.route_multi([(T(w),) for w in d["wire"]], *args,
                                    sort_buckets=sort_buckets)
        assert all(np.array_equal(a[0].numpy(), want[0][i])
                   for i, a in enumerate(one))
        assert [int(o) for o in ovf1] == want_ovf.tolist()
    if cap < 100:
        assert want_ovf.sum() > 0  # the overflow case is exercised


@pytest.mark.parametrize("s,m,cap", ((2, 300, 60), (8, 512, 24)))
def test_route_one_and_the_wire_packing_match_the_jax_package(s, m, cap):
    """route_one is route_multi of one payload (the JAX package's
    route_one's buffers and overflow), and the ring engine's wire word
    packs (local destination, ring slot) as the JAX package's
    pack_dst_slot does, unpacking to the same pair."""
    d = _route_inputs(2 * s + cap, s, m)
    d["rows"] = d["rows"][:, :, :0]
    want, want_ovf = _jax_route(d, s, cap, None)
    recv, ovf = tex.route_one([T(w) for w in d["wire"]],
                              [T(x) for x in d["dest"]],
                              [T(x) for x in d["valid"]], s, cap)
    assert [int(o) for o in ovf] == want_ovf.tolist()
    assert all(np.array_equal(r.numpy(), want[0][i])
               for i, r in enumerate(recv))
    dst = np.arange(0, 4000, 7, dtype=np.int32)
    slot = (dst % 13).astype(np.int32)
    packed = jex.pack_dst_slot(jnp.asarray(dst), jnp.asarray(slot), 13)
    got = tex.pack_dst_slot(T(dst), T(slot), 13)
    assert np.array_equal(got.numpy(), np.asarray(packed))
    for a, b in zip(tex.unpack_dst_slot(got, 13),
                    jex.unpack_dst_slot(packed, 13)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_local,k,s", ((1250, 6, 8), (10, 3, 2),
                                         (1_250_000, 3, 8), (5, 1, 1),
                                         (100_000, 20, 16)))
def test_caps_match_the_jax_package(n_local, k, s):
    assert tex.epidemic_cap(n_local, k, s) == jex.epidemic_cap(n_local, k, s)
    for m in (1, 64, 6000, 196_608, 7_500_000):
        assert tex.chernoff_cap(m, s) == jex.chernoff_cap(m, s), m


def test_mesh_collectives_and_sizes():
    mesh = tmesh.node_mesh(4, "cpu")
    assert (mesh.n_shards, tmesh.node_mesh().n_shards) == (4, 1)
    assert tmesh.shard_size(4000, mesh) == 1000
    with pytest.raises(ValueError, match=r"must be divisible by the mesh "
                                         r"size \(4\)"):
        tmesh.shard_size(4001, mesh)
    xs = [torch.tensor(v) for v in (3, 9, 1)]
    assert int(tmesh.psum(xs)) == 13 and int(tmesh.pmax(xs)) == 9


# --- fused_recv_land ---------------------------------------------------------


@pytest.fixture
def generic_interpreter(monkeypatch):
    monkeypatch.setattr(jmk, "_interpret_param", bool)


def _jax_recv(d, kw, pallas):
    """The JAX package's receive side on the same inputs: its Pallas
    fused_recv_land, or the unfused chain of event_sharded's
    _route_and_append (decode, filter, ops/mailbox.ring_append).  Returns
    (ring, cnt, dropped, sup[, mail_words])."""
    dw, cap, b = kw["dw"], kw["cap"], kw["b"]
    n = d["flags"].shape[0] - 1 if "flags" in d else None
    flags = jnp.asarray(d["flags"][:n]) if "flags" in d else None
    recv = jnp.asarray(d["recv"])
    ring, cnt = jnp.asarray(d["ring"]), jnp.asarray(d["cnt"])
    dropped = jnp.asarray(3, jnp.int32)
    words = jnp.asarray(d["words"]) if "words" in d else None
    mw = jnp.asarray(d["mail_words"]) if "words" in d else None
    if pallas:
        out = jmk.fused_recv_land(ring, cnt, dropped, recv, dw=dw, cap=cap,
                                  b=b, words=words, mail_words=mw,
                                  flags=flags,
                                  received_bit=int(tevent.RECEIVED),
                                  interpret=True)
        return [np.asarray(x) for x in out]
    rvalid = recv >= 0
    r = jnp.maximum(recv, 0)
    rdstl, rw, roff = r // (dw * b), (r // b) % dw, r % b
    sup = jnp.zeros((dw,), jnp.int32)
    if flags is not None:
        dup = rvalid & ((flags[rdstl] & tevent.RECEIVED) > 0)
        sup = ((rw[:, None] == jnp.arange(dw)[None, :]) & dup[:, None]).sum(
            axis=0, dtype=jnp.int32)
        rvalid = rvalid & ~dup
    rings, pays = (ring,), (rdstl * b + roff,)
    if words is not None:
        rings += (mw,)
        pays += (jnp.where(rvalid[:, None], words, 0),)
    rings, cnt, dropped = jmailbox.ring_append(rings, cnt, dropped, pays, rw,
                                               rvalid, dw, cap)
    out = [rings[0], cnt, dropped, sup] + list(rings[1:])
    return [np.asarray(x) for x in out]


# The card's cases past the interpreter's reach (a serial lane loop) stay
# on the card; dw 1024 and the sharded_10m shape run there.
CPU_RECV_CASES = sorted(set(RECV_CASES) - {"dw1024", "wide"})


@pytest.mark.parametrize("case", CPU_RECV_CASES)
def test_recv_land_plain_matches_pallas_and_chain(generic_interpreter, case):
    d, kw = _recv_inputs(19, **RECV_CASES[case])
    got = [x.numpy() for x in _recv_land(megakernel.fused_recv_land, d, kw,
                                         torch.device("cpu"))]
    plain = [x.numpy() for x in _recv_land(megakernel.recv_land_plain, d, kw,
                                           torch.device("cpu"))]
    for pallas in (True, False):
        want = _jax_recv(d, kw, pallas)
        assert len(want) == len(got)
        for w, g, p in zip(want, got, plain):
            assert np.array_equal(np.asarray(w), g)
            assert np.array_equal(g, p)
    trash = kw["dw"] * kw["cap"]
    m, landed = d["recv"].size, int((got[1] - d["cnt"]).sum())
    if landed < m:  # some lane did not land: it zeroed the trash cell
        assert got[0][trash] == 0
    else:
        assert got[0][trash] == d["ring"][trash]
    if "overflow" in case:
        assert int(got[2]) > 3  # lanes past cap were dropped
    if "flags" in d and "overflow" not in case:
        assert got[3].sum() > 0  # the duplicate filter fired


def test_recv_land_refuses_what_it_does_not_take():
    d, kw = _recv_inputs(3)
    args = [T(d["ring"].copy()), T(d["cnt"].copy()),
            torch.tensor(0, dtype=torch.int32)]
    with pytest.raises(TypeError, match="recv must be 1-D"):
        megakernel.fused_recv_land(*args, T(d["recv"]).long(), **kw)
    # Any ring depth from 1 (past 1024 slots: the kernel's global form).
    with pytest.raises(ValueError, match=r"dw=0 or b=10 < 1"):
        megakernel.fused_recv_land(*args, T(d["recv"]),
                                   **dict(kw, dw=0))
    with pytest.raises(ValueError, match="go together"):
        megakernel.fused_recv_land(*args, T(d["recv"]),
                                   words=torch.zeros((1200, 2),
                                                     dtype=torch.int32),
                                   **kw)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        megakernel.fused_recv_land(*[a.to("meta") for a in args],
                                   T(d["recv"]).to("meta"), **kw)


# --- the stepper and its state -----------------------------------------------


def _stepper(shards, **kw):
    base = dict(n=2000, graph="kout", fanout=6, seed=3, backend="sharded",
                telemetry="off")
    cfg = tcfg.Config(**{**base, **kw}).validate()
    return cfg, ShardedStepper(cfg, n_devices=shards, device="cpu")


@pytest.mark.parametrize("kw", (dict(), dict(model="pushsum", droprate=0.0,
                                              crashrate=0.0)))
def test_sharded_state_round_trips(kw):
    """A mid-run sharded state crosses to the JAX package's global leaves
    and back unchanged, and a stepper loaded with it continues the run."""
    cfg, st = _stepper(4, **kw)
    st.init()
    st.seed()
    for _ in range(3):
        st.gossip_window()
    tree = st.state_pytree()
    assert tree["mail_geom"].tolist()[2] == 4
    assert tree["flags"].shape == (cfg.n,)
    assert tree["mail_cnt"].shape[0] == tree["exch_counts"].shape[0] == 4
    to_numpy = (interop.sharded_pushsum_state_to_numpy if kw
                else interop.sharded_state_to_numpy)
    from_numpy = (interop.sharded_pushsum_state_from_numpy if kw
                  else interop.sharded_state_from_numpy)
    back = to_numpy(from_numpy(tree, 4, "cpu"))
    assert set(back) | {"host_mailbox_dropped"} == set(tree)
    for k, v in back.items():
        assert np.array_equal(v, tree[k]), k
    _, other = _stepper(4, **kw)
    other.init()
    other.load_state_pytree(tree)
    assert other.gossip_window() == st.gossip_window()
    # On another shard count the rings are re-bucketed (utils/checkpoint.py
    # reshard_mail_rings): every in-flight entry kept.
    _, two = _stepper(2, **kw)
    two.init()
    two.load_state_pytree(tree)
    assert two.state_pytree()["mail_geom"].tolist()[2] == 2
    assert sum(int(x.mail_cnt.sum()) for x in two.state) == \
        int(tree["mail_cnt"].sum())


def test_one_shard_per_device_by_default():
    """n_devices=None: one shard on the stepper's one device, as the JAX
    package on one chip; the transcript says what the exchange runs."""
    import io

    cfg = tcfg.Config(n=2000, graph="kout", fanout=6, seed=3,
                      backend="sharded").validate()
    st = ShardedStepper(cfg, device="cpu")
    assert st.mesh.n_shards == 1
    buf = io.StringIO()
    res = run_simulation(cfg, printer=ProgressPrinter(out=buf), stepper=st)
    assert res.converged
    assert "(exchange-pipeline: off (requested auto))" in buf.getvalue()
    assert cfg.exchange_pipeline_resolved == "off"


# The overlay, the ring engine, rounds and push-pull run on the sharded
# backend (A13.4); across processes (-distributed and its flags) they do
# not.
@pytest.mark.parametrize("flags", (
    ["-graph", "overlay", "-distributed"],
    ["-engine", "ring", "-distributed"],
    ["-time-mode", "rounds", "-distributed"],
    ["-protocol", "pushpull", "-distributed"], ["-distributed"],
    ["-coordinator", "localhost:1"], ["-num-processes", "2"],
    ["-process-id", "0"]))
def test_unported_sharded_combinations_name_a13(flags):
    with pytest.raises(tcfg.NotYetPorted, match=r"ROADMAP A13\)"):
        tcfg.parse_cli(["-backend", "sharded", "-graph", "kout", "-n",
                        "800"] + flags)


@pytest.mark.parametrize("flags,engine", (
    (["-graph", "overlay"], "event"),
    (["-graph", "overlay", "-overlay-mode", "rounds"], "event"),
    (["-engine", "ring"], "ring"), (["-time-mode", "rounds"], "ring"),
    (["-protocol", "pushpull"], "ring")))
def test_sharded_overlay_and_ring_combinations_run(flags, engine):
    """What the rejections above used to refuse: validated as the JAX
    package validates it, and a window of it on 2 shards on the CPU."""
    argv = ["-backend", "sharded", "-graph", "kout", "-n", "800",
            "-seed", "3"] + flags
    cfg, _ = tcfg.parse_cli(argv)
    jcfg.parse_args(argv)
    assert cfg.engine_resolved == engine
    st = ShardedStepper(cfg, n_devices=2, device="cpu")
    st.init()
    while not st.overlay_window()[2]:
        pass
    st.seed()
    stats = st.gossip_window()
    assert stats.total_received > 0 and len(st.state) == 2


def test_shard_count_must_divide_n():
    cfg = tcfg.Config(n=4001, graph="kout", backend="sharded").validate()
    with pytest.raises(ValueError, match=r"n \(4001\) must be divisible"):
        ShardedStepper(cfg, n_devices=8, device="cpu")
