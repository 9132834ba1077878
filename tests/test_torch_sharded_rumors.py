"""The sharded backend's rumor words against the JAX package:
``run_simulation(cfg, stepper=ShardedStepper(cfg, n_devices=S))`` on both
sides (the port's shards laid out on the CPU, the JAX package's on its
fake 8-device mesh), n <= 4000, ``-telemetry off -exchange-pipeline off``.

Each reference run is made once, by the module fixture, and the port is
held to it under ``-phase2-kernel auto`` (``fused_recv_land``'s plain
version with word rows) and ``xla`` (the decode and the word-ring
append): the same Stats every window (the per-rumor counts too), the same
transcript (note lines aside) and the same final state leaves.  Cases,
each on 2 and 8 shards: ``-rumors 16`` and ``-rumors 40`` (two words),
``-traffic stream`` under ``-arrivals fixed``, ``poisson`` and
``diurnal``, and ``-rumors 16`` under the churn timeline with healing;
two of them also under
``-telemetry on`` (the run-to-target loop).  The pieces: the owner-gated
injection against the JAX package's, and rumor words with bit 31 set
(all-ones words too) through the exchange.  ``fused_recv_land``'s word
cases against the JAX package's Pallas kernel are ``test_torch_sharded.py``'s
``rumor_*`` cases.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu.backends.sharded import ShardedStepper as JStepper
from gossip_simulator_tpu.config import Config as JConfig
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.models import event as jevent
from gossip_simulator_tpu.parallel import exchange as jex
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TStepper
from gossip_simulator_tpu_torch.config import Config as TConfig
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.parallel import exchange as tex
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from test_torch_rng import match_jax_threefry
from test_torch_sharded import _jax_route
from test_torch_sharded_faults import (CHURN, Recording, _twin_lines,
                                       tight_caps)

# bench.py's multirumor flags at a CPU size.
RUMOR = dict(graph="kout", n=4000, fanout=6, seed=4, crashrate=0.0,
             coverage_target=0.95)
STREAM = dict(RUMOR, rumors=16, traffic="stream", stream_rate=100)
# name: (Config fields), each on 2 and 8 shards
KINDS = {
    "r16": dict(RUMOR, rumors=16),
    "r40": dict(RUMOR, rumors=40),
    "stream_fixed": STREAM,
    "stream_poisson": dict(STREAM, arrivals="poisson"),
    "stream_diurnal": dict(STREAM, arrivals="diurnal"),
    # The JAX package's test_churn_partition_heal_r16 at n = 3000.
    "churn_heal_r16": dict(RUMOR, n=3000, seed=3, rumors=16,
                           coverage_target=0.99, max_rounds=600,
                           scenario=CHURN, overlay_heal="on"),
}
# name: (Config fields, shards)
CASES = {f"{kind}_s{s}": (kw, s) for kind, kw in KINDS.items()
         for s in (2, 8)}
# -rumors 16 under churn with healing on 8 shards, its route buffers cut
# (tight_caps), to a 0.9 target that some rumors reach; seed 5, so
# that no run of another case is reused.
CASES["overflow"] = (dict(KINDS["churn_heal_r16"], seed=5,
                             coverage_target=0.9), 8)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's run of each case (under -telemetry `t`), made on
    first use."""
    runs = {}

    def get(name, t="off"):
        if (name, t) not in runs:
            kw, shards = CASES[name]
            cfg = JConfig(**kw, backend="sharded", telemetry=t,
                          exchange_pipeline="off").validate()
            rec = Recording(JStepper(cfg, n_devices=shards))
            out = io.StringIO()
            with (tight_caps(jex) if name == "overflow"
                  else contextlib.nullcontext()):
                res = jrun(cfg, printer=JPrinter(out=out), stepper=rec)
            runs[name, t] = (out.getvalue(), rec, res, rec.state_pytree())
        return runs[name, t]

    return get


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.mark.parametrize("gate", ("auto", "xla"))
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_rumor_twin(reference, name, gate):
    """The "overflow" case cuts every route buffer far below its load in
    both packages (tight_caps): the word columns of the dropped entries
    go with them."""
    text, ref, res, leaves = reference(name)
    kw, shards = CASES[name]
    cfg = TConfig(**kw, backend="sharded", telemetry="off",
                  exchange_pipeline="off", phase2_kernel=gate).validate()
    rec = Recording(TStepper(cfg, n_devices=shards, device="cpu"))
    out = io.StringIO()
    with (tight_caps(tex) if name == "overflow"
          else contextlib.nullcontext()):
        got = trun(cfg, printer=TPrinter(out=out), stepper=rec)
    if name == "overflow":
        assert ref.rows[-1]["exchange_overflow"] > 0
    assert len(ref.rows) > 3 and rec.rows == ref.rows
    assert ref.rows[-1]["rumors_done"] > 0
    assert _twin_lines(out.getvalue()) == _twin_lines(text)
    assert (got.converged, got.coverage_ms) == (res.converged,
                                                res.coverage_ms)
    assert set(leaves) == set(tree := rec.state_pytree())
    for key in leaves:
        assert np.array_equal(np.asarray(leaves[key]),
                              np.asarray(tree[key])), key
    # The word leaves are full size and carry rumor 31's bit where R > 31.
    assert np.asarray(tree["rumor_words"]).shape == (
        cfg.n, cfg.rumor_word_count)
    if cfg.rumors > 32:
        assert (np.asarray(tree["rumor_words"])[:, 0] >> 31).any()


@pytest.mark.parametrize("name", ("stream_fixed_s8", "churn_heal_r16_s2"))
def test_sharded_rumor_run_to_target_twin(reference, name):
    """-telemetry on: the run-to-target loop (its test on the worst
    rumor, the stream kept alive on an empty ring until the last
    injection, no in-flight exit under healing) and the replayed history
    give the JAX package's transcript, Stats and final leaves."""
    text, _, res, leaves = reference(name, "on")
    kw, shards = CASES[name]
    cfg = TConfig(**kw, backend="sharded", telemetry="on",
                  exchange_pipeline="off").validate()
    st = TStepper(cfg, n_devices=shards, device="cpu")
    out = io.StringIO()
    got = trun(cfg, printer=TPrinter(out=out), stepper=st)
    assert _twin_lines(out.getvalue()) == _twin_lines(text)
    assert "covered" in text
    assert got.stats.to_dict() == res.stats.to_dict()
    tree = st.state_pytree()
    for key in leaves:
        assert np.array_equal(np.asarray(leaves[key]),
                              np.asarray(tree[key])), key


@pytest.mark.parametrize("shards", (2, 8))
@pytest.mark.parametrize("kw", (dict(rumors=40), dict(
    rumors=64, traffic="stream", stream_rate=500), dict(
    rumors=64, traffic="stream", stream_rate=100, arrivals="poisson")))
def test_injection_batch_owner_gated_matches_the_jax_package(kw, shards):
    """Each shard keeps the lanes whose source it owns, rows localized;
    the shards' lanes together are the one-device batch's."""
    base = dict(graph="kout", n=4000, fanout=6, seed=2, crashrate=0.0)
    jcfg = JConfig(**base, **kw).validate()
    tcfg = TConfig(**base, **kw).validate()
    b, dw = tevent.batch_ticks(tcfg), tevent.ring_windows(tcfg)
    n_local = tcfg.n // shards
    key = trng.base_key(2, "cpu")
    jkey = jax.random.PRNGKey(2)
    for tick in (0, 10, 200):
        one = tevent.injection_batch(tcfg, tick, key, b, dw)
        kept = torch.zeros_like(one[3])
        for shard in range(shards):
            got = tevent.injection_shard(one, b, n_local, shard)
            want = jevent.injection_batch(jcfg, jnp.int32(tick), jkey, b, dw,
                                          n_local=n_local,
                                          shard=jnp.int32(shard))
            v = np.asarray(want[3])
            assert np.array_equal(got[3].numpy(), v)
            for g, w in zip(got[:3], want[:3]):
                w = np.asarray(w)
                if w.dtype == np.uint32:
                    w = w.view(np.int32)
                assert np.array_equal(g.numpy()[v], w[v])
            assert np.array_equal(
                got[0].numpy()[v] // b + shard * n_local,
                one[0].numpy()[v] // b)
            assert not (kept & got[3]).any()
            kept |= got[3]
        assert torch.equal(kept, one[3])


@pytest.mark.parametrize("s,cap", ((2, 200), (8, 24)))
def test_rumor_words_with_bit_31_ride_the_route(s, cap):
    """Words whose int32 view is negative (rumor 31's bit, a full word)
    survive the exchange: only the wire word tells an empty slot.  The
    port's 2-D payload against the JAX package's word columns, routed
    as separate payloads."""
    rng = np.random.default_rng(s)
    m = 512
    words = rng.integers(0, 4, (s, m, 3))
    d = dict(wire=rng.integers(0, 1 << 20, (s, m)).astype(np.int32),
             rows=np.select([words == 0, words == 1], [-1, -2**31],
                            rng.integers(-2**31, 2**31, (s, m, 3))).astype(
                                np.int32),
             dest=rng.integers(0, s, (s, m)).astype(np.int32),
             valid=rng.random((s, m)) < 0.8)
    want, want_ovf = _jax_route(d, s, cap, None)
    recvs, ovf = tex.route_multi(
        [(torch.from_numpy(w), torch.from_numpy(r))
         for w, r in zip(d["wire"], d["rows"])],
        [torch.from_numpy(x) for x in d["dest"]],
        [torch.from_numpy(x) for x in d["valid"]], s, cap)
    assert [int(o) for o in ovf] == want_ovf.tolist()
    for dst in range(s):
        wire, rows = recvs[dst]
        assert np.array_equal(wire.numpy(), want[0][dst])
        live = wire.numpy() >= 0
        for c in range(3):
            assert np.array_equal(rows[:, c].numpy(), want[1 + c][dst])
        # Live lanes keep their words, all-ones words among them.
        assert (rows.numpy()[live] == -1).any()
        assert (rows.numpy()[live] == -2**31).any()
