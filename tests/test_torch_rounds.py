"""The rounds overlay (the default run above n = 10M, and -overlay-mode
rounds) against the JAX package, with exact equality: the plain versions
of fused_request_round, fused_hosted_chunk and the spill form of
fused_chunk_step against the Pallas kernels and the XLA chains; the
delivery paths of every band; the sizing; and whole runs -- byte-identical
CLI transcripts, stepper twins in the lowered bands (column delivery, the
split round, the static-boot burst spill) compared leaf by leaf every
round, and a JAX rounds state carried into the port mid-construction.

The Pallas kernels run through Pallas's generic interpreter
(``interpret=True``): the TPU interpreter the JAX package selects fails on
jax 0.9.0 (ROADMAP §C).  ``_interpret_param`` is patched in all three
Pallas modules, and ``_occupancy_call``'s cache is cleared around each
test, since it keeps the interpreter closure of its first call.

The JAX package's kernel gates cannot run end to end on such a host, so
its xla chain is the reference run.  The two gates keep the spill pairs
in different orders (sorted, or lane order): where the port runs its
kernel gate, spill leaves are compared stable-sorted by destination."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.driver import run_simulation as jax_run
from gossip_simulator_tpu.models import overlay as jov
from gossip_simulator_tpu.ops import mailbox as jmb
from gossip_simulator_tpu.ops import pallas_deliver as jdeliver
from gossip_simulator_tpu.ops import pallas_megakernel as jmk
from gossip_simulator_tpu.ops import pallas_overlay_kernel as jpok
from gossip_simulator_tpu.utils import rng as jrng
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JaxPrinter
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch import run_simulation as torch_run
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.models import overlay as tov
from gossip_simulator_tpu_torch.ops import deliver, overlay_kernel
from gossip_simulator_tpu_torch.ops import mailbox as tmb
from gossip_simulator_tpu_torch.utils import interop
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TorchPrinter
from test_torch_card import (_hosted_inputs, _request_inputs, _spill_inputs,
                             _spill_step)
from test_torch_rng import match_jax_threefry
from torch_reference import jax_cli

T = torch.from_numpy
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.fixture(autouse=True)
def generic_interpreter(monkeypatch):
    for mod in (jdeliver, jpok, jmk):
        monkeypatch.setattr(mod, "_interpret_param", bool)
    jpok._occupancy_call.cache_clear()
    yield
    jpok._occupancy_call.cache_clear()


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(np.asarray(w), g)


def _by_dst(pairs):
    """Spill pairs stable-sorted by destination (the gate-neutral form)."""
    pairs = np.asarray(pairs)
    return pairs[:, np.argsort(pairs[1], kind="stable")]


# --- kernels: plain version == Pallas kernel == XLA chain ---------------------


@pytest.mark.parametrize("n", (37, 4099))
def test_request_round_plain_matches_pallas_and_xla(n):
    d, fanout = _request_inputs(31, n=n)
    fr, cnt, w = (jnp.asarray(d[x]) for x in ("friends", "cnt", "w"))
    want = jpok.fused_request_round(fr, cnt, w, fanout=fanout,
                                    interpret=True)
    # The JAX package's XLA form (models/overlay.py make_round_fn).
    k = d["friends"].shape[1]
    under = cnt < fanout
    xla = (jov._masked_set(fr, None, jnp.minimum(cnt, k - 1), w, under),
           cnt + under.astype(jnp.int32), jnp.where(under, w, -1),
           under.sum(dtype=jnp.int32))
    _same(want, xla)
    for fn in (overlay_kernel.request_round_plain,
               overlay_kernel.fused_request_round):
        _same(want, fn(T(d["friends"].copy()), T(d["cnt"].copy()),
                       T(d["w"]), fanout=fanout))
    assert 0 < int(want[3]) < n  # both kinds of rows


@pytest.mark.parametrize("shape", ((1, 37), (3, 4099), (9, 1024)))
def test_hosted_chunk_plain_matches_pallas_and_xla(shape):
    mat = _hosted_inputs(32, *shape)
    want = np.asarray(jpok.fused_hosted_chunk(jnp.asarray(mat),
                                              interpret=True))
    _same([want], [np.asarray([(r >= 0).sum() for r in mat], np.int32)])
    _same([want], [overlay_kernel.hosted_chunk_plain(T(mat))])
    _same([want], [overlay_kernel.fused_hosted_chunk(T(mat))])


SPILL_CASES = {"room": dict(), "fills": dict(scap=9),
               "carried_fills": dict(scap=30, scnt=25),
               "full_already": dict(scap=12, scnt=12)}


@pytest.mark.parametrize("rank_major", (False, True))
@pytest.mark.parametrize("case", sorted(SPILL_CASES))
def test_spill_chunk_step_matches_both_jax_gates(case, rank_major):
    """The kernel's plain version equals the Pallas kernel, pair order
    included; the port's xla chain equals the JAX xla chain; while the
    pairs fit, the two orders hold the same pairs."""
    d, kw = _spill_inputs(33, **SPILL_CASES[case])
    nk, cap = kw["nk"], kw["cap"]

    def jax_args():
        return (jnp.asarray(d["mbox"]), jnp.asarray(d["count"]),
                jnp.int32(5), jnp.asarray(d["key"]), jnp.asarray(d["s"]), nk,
                cap, rank_major)

    spill = (jnp.asarray(d["pairs"]), jnp.int32(d["scnt"]))
    mb, cn, dr, (pr, sc) = jdeliver.fused_chunk_step(
        *jax_args(), spill=spill, interpret=True)
    want_k = [mb, cn, dr, pr, sc]
    mb, cn, dr, (pr, sc) = jmb._compact_chunk_step(*jax_args(), spill=spill,
                                                   kernel="xla")
    want_x = [mb, cn, dr, pr, sc]
    _same(want_k, _spill_step(deliver.fused_chunk_step, d, kw, rank_major,
                              CPU))
    _same(want_x, _spill_step(
        lambda *a, **k: tmb._compact_chunk_step(*a, **k, kernel="xla"), d,
        kw, rank_major, CPU))
    _same(want_k[:3] + [want_k[4]], want_x[:3] + [want_x[4]])
    ovf = int(want_k[2]) - 5 + int(want_k[4]) - d["scnt"]
    assert ovf > 0  # overflow is exercised
    if case == "room":
        assert int(want_k[2]) == 5
        _same([_by_dst(want_k[3])], [_by_dst(want_x[3])])
    else:
        assert int(want_k[2]) > 5  # the pairs filled: drops counted


# --- delivery ---------------------------------------------------------------


def _emissions(seed, n, rows, density):
    """(rows, n) slot-major emission rows, -1 where nothing was sent."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, n, (rows, n)).astype(np.int32)
    mat[rng.random((rows, n)) >= density] = -1
    return mat


@pytest.mark.parametrize("kernel", ("xla", "pallas"))
def test_node_major_deliver_matches_jax(kernel):
    n, cap = 500, 4
    flat = _emissions(1, n, cap + 1, 0.5).reshape(-1)
    want = jmb.deliver(None, jnp.asarray(flat), jnp.asarray(flat >= 0), n,
                       cap, compact_chunk=300, src_mod=n, kernel="xla")
    got = tmb.deliver(None, T(flat), T(flat >= 0), n, cap, compact_chunk=300,
                      src_mod=n, kernel=kernel)
    _same(want, got)
    assert int(want[2]) > 0


@pytest.mark.parametrize("kernel", ("xla", "pallas"))
def test_deliver_columns_with_spill_matches_jax(kernel):
    """Two emission matrices, last round's pairs first, this round's
    overflow spilled: mailbox, load and drops equal; pairs equal in the
    xla order (sorted within chunks) or after the sort by destination."""
    n, cap, scap = 400, 3, 500
    mats = (_emissions(2, n, cap, 0.7), _emissions(3, n, 1, 0.9))
    spill_in = np.full((2, scap + 1), -1, np.int32)
    spill_in[0, :60] = np.arange(60)
    spill_in[1, :60] = np.random.default_rng(4).integers(0, n, 60)
    jspill = (jnp.full((2, scap + 1), -1, jnp.int32), jnp.int32(0))
    mbox, load, dropped, (pairs, _) = jmb.deliver_columns(
        tuple(jnp.asarray(m) for m in mats), n, cap, 128, flat=True,
        spill_in=jnp.asarray(spill_in), spill=jspill, kernel="xla")
    spill = tmb.new_spill(scap, CPU)
    got = tmb.deliver_columns(tuple(T(m) for m in mats), n, cap, 128,
                              spill_in=T(spill_in), spill=spill,
                              kernel=kernel)
    _same([mbox, load, dropped], got)
    want_p = np.asarray(pairs)
    assert (want_p[1] >= 0).sum() > 50 and int(dropped) == 0
    if kernel == "xla":
        _same([want_p], [spill[0]])
    else:
        _same([_by_dst(want_p)], [_by_dst(spill[0])])


@pytest.mark.parametrize("occupancy", ("xla", "pallas"))
@pytest.mark.parametrize("totals", (False, True))
def test_hosted_delivery_matches_jax(totals, occupancy):
    """The split round's delivery: a dense row, a sparse row, an empty row
    (skipped), rows wider than the fattest rung; with or without caller
    totals; the spill re-delivered first."""
    n, cap, scap = 900, 3, 700
    mat = _emissions(5, n, cap, 0.3)
    mat[0] = np.random.default_rng(6).integers(0, n, n)  # dense
    mat[2] = -1
    boot = _emissions(7, n, 1, 0.95)
    spill_in = np.full((2, scap + 1), -1, np.int32)
    spill_in[:, :5] = [[1, 2, 3, 4, 5], [7, 7, 7, 7, 8]]
    row_totals = ([int((r >= 0).sum()) for r in mat] + [int((boot >= 0).sum())]
                  if totals else None)
    widths = (64, 256)
    jrun = jmb.make_hosted_column_delivery(n, cap, widths, spill_cap=scap,
                                           kernel="xla",
                                           occupancy=occupancy)
    want = jrun((jnp.asarray(mat), jnp.asarray(boot)),
                spill_in=jnp.asarray(spill_in), row_totals=row_totals)
    for kernel in ("xla", "pallas"):
        trun = tmb.make_hosted_column_delivery(n, cap, widths, spill_cap=scap,
                                               kernel=kernel,
                                               occupancy=occupancy)
        got = trun((T(mat), T(boot)), spill_in=T(spill_in),
                   row_totals=row_totals)
        _same(want[:3], got[:3])
        if kernel == "xla":
            _same([want[3]], [got[3]])
        else:
            _same([_by_dst(want[3])], [_by_dst(got[3])])
    assert (np.asarray(want[3])[1] >= 0).sum() > 0


# --- sizing and initial state ---------------------------------------------------

SIZING = [dict(n=100_000_000), dict(n=40_000_000), dict(n=20_000_000),
          dict(n=10_000_000, overlay_mode="rounds"),
          dict(n=3000, overlay_mode="rounds"),
          dict(n=3000, overlay_mode="rounds", mailbox_cap=8,
               overlay_static_boot="on"),
          dict(n=50_000_000, overlay_adaptive_chunks="off"),
          dict(n=50_000_000, overlay_static_boot="off", compact_chunk=4096),
          dict(n=268_435_454, fanout=4)]


@pytest.mark.parametrize("kw", SIZING)
def test_sizing(kw):
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    assert jc.overlay_mode_resolved == tc.overlay_mode_resolved == "rounds"
    n = jc.n
    assert jc.mailbox_cap_for(n) == tc.mailbox_cap_for(n)
    assert jov.delivery_chunk(jc, n) == tov.delivery_chunk(tc, n)
    assert jov.hosted_chunk_widths(jc, n) == tov.hosted_chunk_widths(tc, n)
    assert jov.spill_cap_for(jc, n) == tov.spill_cap_for(tc, n)
    assert jov.static_boot_applies(jc, None) == tov.static_boot_applies(tc)
    assert jov.use_split_round(jc) == tov.use_split_round(tc)
    assert jov._poisson_excess(5.0, 8) == tov._poisson_excess(5.0, 8)


def test_two_phase_100m_shape():
    """The flagship row's bands, as the JAX Config computes them."""
    tc = tcfg.Config(n=100_000_000, coverage_target=0.9).validate()
    assert tc.mailbox_cap_for(tc.n) == 8 and tov.use_split_round(tc)
    assert tov.static_boot_applies(tc)
    assert tov.spill_cap_for(tc, tc.n) == 19_603_022
    assert tov.hosted_chunk_widths(tc, tc.n) == (781_250, 3_125_000,
                                                 8_388_608)


@pytest.mark.parametrize("boot", ("on", "off"))
def test_init_state_matches_jax(boot):
    kw = dict(n=3000, overlay_mode="rounds", seed=4, mailbox_cap=8,
              overlay_static_boot=boot)
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    want = {k: np.asarray(v) for k, v in
            jov.init_state(jc, base_key=jrng.base_key(4))._asdict().items()}
    got = interop.overlay_state_to_numpy(
        tov.init_state(tc, trng.base_key(4)))
    assert set(want) == set(got)
    for key in want:
        assert want[key].dtype == got[key].dtype and \
            np.array_equal(want[key], got[key]), key
    assert (want["mk_dst"][:5] >= 0).all() == (boot == "on")


# --- whole runs -----------------------------------------------------------------

ROUNDS = ["-overlay-mode", "rounds", "-n", "3000", "-fanout", "5", "-seed",
          "9", "-coverage-target", "0.9"]
XLA_GATES = ["-phase1-kernel", "xla", "-deliver-kernel", "xla"]


@pytest.fixture(scope="module")
def jax_transcripts():
    return {g: jax_cli(ROUNDS + list(g)) for g in ((), tuple(XLA_GATES))}


def _port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_main([*argv, "-device", "cpu"])
    return rc, out.getvalue()


@pytest.mark.parametrize("jax_gates", ((), tuple(XLA_GATES)))
@pytest.mark.parametrize("gates", ([], XLA_GATES,
                                   ["-phase1-kernel", "pallas",
                                    "-deliver-kernel", "pallas"]))
def test_cli_twin_byte_identical(gates, jax_gates, jax_transcripts):
    """The port's transcript under every gate setting equals the
    reference's under both of its phase-1 gate settings, the explicit-gate
    note line aside."""
    jrc, jout, jerr = jax_transcripts[jax_gates]
    assert jrc == 0, jerr
    rc, out = _port_cli(ROUNDS + gates)
    assert rc == 0
    strip = lambda t: [x for x in t.splitlines()  # noqa: E731
                       if not x.startswith("(phase1-kernel")]
    assert strip(out) == strip(jout)
    assert "break 534 makeup 887" in out  # phase-1 rounds are compared
    if list(jax_gates) == gates:
        assert out == jout


def _leaves_equal(want: dict, got: dict, sort_spill: bool):
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        if sort_spill and key.endswith("_spill"):
            w, g = _by_dst(w), _by_dst(g)
        assert w.dtype == g.dtype and np.array_equal(w, g), key


def _stepper_twin(jc, tc, js=None, ts=None):
    """Both steppers round by round to quiescence (leaves equal after
    every round), then the broadcast to the coverage target (Stats equal
    every window, the final leaves equal)."""
    sort_spill = tc.deliver_kernel_resolved != "xla"
    if js is None:
        js, ts = JaxStepper(jc), TorchStepper(tc, device="cpu")
        js.init()
        ts.init()
    for rnd in range(1, 200):
        want, got = js.overlay_window(), ts.overlay_window()
        assert want == got, rnd
        assert js.sim_time_ms() == ts.sim_time_ms()
        if want[2]:
            break
        _leaves_equal(js.overlay_state_pytree(), ts.overlay_state_pytree(),
                      sort_spill)
    assert want[2]
    js.seed()
    ts.seed()
    for _ in range(100):
        want, got = js.gossip_window(), ts.gossip_window()
        assert want.to_dict() == got.to_dict()
        if want.coverage >= jc.coverage_target:
            break
    _leaves_equal(js.state_pytree(), ts.state_pytree(), False)
    return rnd, want


BANDS = {
    "column": ([(tov, jov, "COLUMN_DELIVERY_MIN_ROWS", 0)],
               dict(n=3000, seed=9)),
    "column_cap8_static_boot": (
        [(tov, jov, "COLUMN_DELIVERY_MIN_ROWS", 0)],
        dict(n=3000, seed=2, mailbox_cap=8, overlay_static_boot="on")),
    "split": ([(tov, jov, "SPLIT_ROUND_MIN_ROWS", 0)],
              dict(n=3000, seed=9, compact_chunk=256)),
    "split_burst_spill": (
        [(tov, jov, "SPLIT_ROUND_MIN_ROWS", 0),
         (tcfg, jcfg, "MAILBOX_CAP_MEMORY_BAND", 1000)],
        dict(n=12_000, seed=0, overlay_static_boot="on")),
    "split_dead_skip_off": (
        [(tov, jov, "SPLIT_ROUND_MIN_ROWS", 0),
         (tcfg, jcfg, "MAILBOX_CAP_MEMORY_BAND", 1000)],
        dict(n=5000, seed=1, overlay_dead_skip="off",
             overlay_adaptive_chunks="off")),
}


@pytest.mark.parametrize("gate", ("auto", "xla"))
@pytest.mark.parametrize("band", sorted(BANDS))
def test_lowered_band_twins(band, gate, monkeypatch):
    """Each band of the rounds engine at a small n, its module constants
    lowered in both packages, against the reference's xla run."""
    patches, kw = BANDS[band]
    for tmod, jmod, name, value in patches:
        monkeypatch.setattr(tmod, name, value)
        monkeypatch.setattr(jmod, name, value)
    kw = dict(kw, overlay_mode="rounds", fanout=5, progress=False,
              coverage_target=0.9)
    gates = dict(phase1_kernel=gate, deliver_kernel=gate)
    jc = jcfg.Config(**kw).validate()
    tc = tcfg.Config(**kw, **gates).validate()
    rounds, stats = _stepper_twin(jc, tc)
    assert rounds > 5 and stats.mailbox_dropped == 0
    if "split" in band:
        assert tov.use_split_round(tc)


def test_auto_mode_picks_rounds_and_notes_the_clock(monkeypatch):
    """-overlay-mode auto above OVERLAY_TICKS_AUTO_MAX runs the rounds
    engine and prints the estimated-clock note, as the reference does."""
    monkeypatch.setattr(tcfg, "OVERLAY_TICKS_AUTO_MAX", 1000)
    monkeypatch.setattr(jcfg, "OVERLAY_TICKS_AUTO_MAX", 1000)
    argv = ["-n", "3000", "-seed", "3", "-coverage-target", "0.9"]
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jres = jax_run(jcfg.parse_args(argv), printer=JaxPrinter(out=jbuf))
    tc, _ = tcfg.parse_cli(argv)
    assert tc.overlay_mode_resolved == "rounds"
    tres = torch_run(tc, printer=TorchPrinter(out=tbuf), device="cpu")
    assert "(overlay clock estimated as rounds x mean delay" in tbuf.getvalue()
    assert tbuf.getvalue() == jbuf.getvalue()
    assert jres.stats.to_dict() == tres.stats.to_dict()


@pytest.mark.parametrize("gate", ("auto", "xla"))
def test_rounds_state_handover(gate):
    """A JaxStepper runs 3 rounds; its state carries into the port through
    numpy; both continue to the same quiescence round with equal leaves,
    and the broadcast matches."""
    kw = dict(n=2500, seed=9, overlay_mode="rounds", fanout=5,
              progress=False, coverage_target=0.9)
    jc = jcfg.Config(**kw).validate()
    tc = tcfg.Config(**kw, phase1_kernel=gate, deliver_kernel=gate).validate()
    js = JaxStepper(jc)
    js.init()
    for _ in range(3):
        assert not js.overlay_window()[2]
    tree = js.overlay_state_pytree()
    back = interop.overlay_state_to_numpy(
        interop.overlay_state_from_numpy(tree, "cpu"))
    _leaves_equal(tree, back, False)
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    ts.load_overlay_state_pytree(tree)
    assert js.sim_time_ms() == ts.sim_time_ms() == 45.0
    rounds, _ = _stepper_twin(jc, tc, js, ts)
    assert rounds > 5


def test_geometry_mismatch_is_named():
    tc = tcfg.Config(n=2500, overlay_mode="rounds").validate()
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    tree = interop.overlay_state_to_numpy(ts.ostate)
    tree["mk_dst"] = tree["mk_dst"][:8]
    # The reference's restore check (utils/checkpoint.py) names the
    # buffers and the flag to fix.
    with pytest.raises(ValueError, match="emission buffers are 8 wide"):
        ts.load_overlay_state_pytree(tree)
