"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card, exits 0 when all pass
    python3 chip_smoke.py --profile P [--profile-n N] [--profile-run R]
    python3 chip_smoke.py --phases parity,twins   # a subset (its last line says so)
    python3 chip_smoke.py --phases pushsum        # the PushSum runs alone
    python3 chip_smoke.py --phases graphs         # static graph generation
    python3 chip_smoke.py --phases sharded        # the sharded backend
    python3 chip_smoke.py --phases faults         # fault scenarios, healing
    python3 chip_smoke.py --phases rumors_event   # multi-rumor traffic
    python3 chip_smoke.py --phases checkpoint     # snapshots, -resume, SIGTERM
    python3 chip_smoke.py --phases sharded_faults # -backend sharded, faults, rumors
    python3 chip_smoke.py --phases sharded_overlay # -backend sharded, overlays, ring engine

Phases, each printing its own line:

1. card    -- nvidia-smi name and power limit, torch device and capability
              (must be 9.x);
2. build   -- nvcc builds every kernel in gossip_simulator_tpu_torch/csrc/
              (one process per source, all started together);
3. parity  -- each kernel at the main paths' shapes must be bit-exact to
              its plain PyTorch version on the card: fused_emit (m =
              131,072 senders, k = 6, dw = 3; the overlay's -1-padded
              friends rows and the kout graph's rows: SI, SI with the
              duplicate filter, SIR, a small-cap overflow case),
              fused_unique_set (786,432 lanes), fused_ring_append (m =
              262,144, dw = 3, cap = 1e8, and an overflow case),
              fused_chunk_step's drop form (the ticks drain: 2,097,152
              lanes, nk = 2e7, cap 16; the rounds band: 78,125 lanes, nk =
              1e7; both address forms) and spill form (nk = 1e8, cap 8,
              rank-major: an 8,388,608-lane burst chunk, the scap + 1-lane
              re-delivery chunk, and a small spill that fills),
              fused_negotiate (n = 1e7 and a ragged n, both kinds),
              fused_request_round (n = 1e7; its bound by the 32-byte
              sectors its scattered stores write), fused_hosted_chunk ((8,
              1e8) and (1, 1e8)), fused_deposit_add with the lanes' mask
              in both forms (the wrapper's first, then the other) at the
              rounds-mode deposit (2 x 1e7 ring, 6e7 lanes: the dense
              form), a compacted ticks chunk (20 x 1e7 ring, 468,750
              lanes) and the multi-rumor run's deposit (20 x 1e6 ring,
              6e6 lanes), each with the dense form's overflow count,
              fused_deposit_rows
              and fused_deposit_both (20 x 1e6 x 16 rings, 6e6 lanes);
              and PushSum's shapes at n = 1e7, fanout 6, dim 2 (C = 12
              limb columns, dw = 3, cap 7e7): fused_drain_sum over one
              slot of 6e7 live lanes and at pushsum10m_sharded's per-shard
              shape (n_local 1.25e6, 8.75e6 live lanes, the shard's cap),
              each in the form the wrapper takes there, the wide
              fused_ring_append (6e7 lanes, a 12-column mass ring) and
              fused_deposit_rows at (1, 1e7, 12) on a 524,288-lane drain
              chunk; the widths past the kernels' old limits (ROADMAP
              C1): fused_negotiate at k = 20 and 200 (1e6 rows),
              fused_emit at dw = 40, kw = 33 and kw = 112 (131,072
              senders) and at erdos1m_wide's batch (38 lanes a sender),
              fused_ring_append at dw = 40; the partition mask
              (fused_emit at the kout shape with half of its lanes
              blocked, the blocked count held too) and rings past 1024
              window slots (the appends' global form: fused_emit,
              fused_ring_append at 262,144 lanes and fused_recv_land at
              sharded_10m's batch, each at dw 1536 and 4096), and
              fused_deposit_add at the ring engine's heal deposit (6e7
              lanes over a 20 x 1e7 ring, 0.25 % valid); and the
              generators: kout_pallas at 1e8 rows x 3 (headline_jax) and
              erdos_pallas at 1e7 rows, lam 8 (sir_10m_erdos) and 1e6 rows,
              lam 60, held to their plain versions in row blocks;
              each kernel, its plain version and the
              one PyTorch call that computes the same function, where there
              is one, are timed with CUDA events, median of 25 (of 5, and
              2 for the generators' plain versions), beside the bound: the
              larger of the call's bytes over 3.35 TB/s and its
              instructions over the card's dispatch rate (128 lanes an SM;
              rotates, shifts and logic over the integer ALU pipe's 64);
              each case's kernel is also run 3 times under torch.profiler,
              its state restored before each call ("device" lines: device
              ms per call, launches per call, ms by kernel, the kernels
              line's device_ms), and the host time to
              enqueue one fused_unique_set and fused_chunk_step call on an
              idle card is printed ("host" lines, with index_put_'s and
              the parts of the unique_set wrapper, and those of the
              fused_ring_append (main, wide), fused_emit (overlay, si),
              fused_deposit_add (each shape, in its form),
              fused_deposit_rows (rumors), fused_deposit_both and
              erdos_pallas (lam 8 and 60) wrappers), and fused_emit's two
              forms (a thread and eight
              threads a sender row) are profiled at each shape
              ("forms" lines, device ms per call: ops/megakernel.py
              emit_group's measurement);
4. twins   -- n = 20,000 runs on cuda and on cpu must give identical
              transcripts and final state leaves, and launch their
              kernels (every kout table through kout_pallas, under every
              gate setting): kout fanout 6 (SI, SI crash 0, SIR, -phase2-kernel
              xla), the default overlay run (default gates and all-xla),
              and the rounds overlay's three bands, the port's band
              constants lowered in-process: the node-major band
              (-overlay-mode rounds: fused_request_round), the column band
              with -mailbox-cap 8 -overlay-static-boot on (the spill form),
              and the split round with -overlay-dead-skip off
              (fused_hosted_chunk three times a round); and the ring
              engine: -engine ring (SI, -compact off, SIR), -time-mode
              rounds (kout and the overlay), push-pull, and -rumors 16
              under the three gate settings; and PushSum (-model pushsum
              -graph kout) under the default gates (fused_drain_sum),
              -phase2-kernel xla with several drain chunks
              (fused_deposit_rows) and all-xla; and static graph
              generation: -graph erdos (lam 8; lam 60 SIR, 112 lanes a
              sender), -graph erdos -pallas (erdos_pallas), -graph kout
              -pallas (kout_pallas), and the widths past the old kernel
              limits: the overlay at -fanout 20, -delaylow 1 -delayhigh 40,
              -fanout 32 -protocol sir;
5. full    -- through the user entry point, seed 0, each run under the
              default gates and with every gate xla, which must give
              identical transcripts, phase-1 friends tables and
              mailbox_dropped: the kout run (n = 1e7, fanout 6, coverage
              0.99), the default run at n = 1e7 (tick-faithful overlay),
              -overlay-mode rounds at n = 1e7 (the column band), and the
              default run at n = 3.2e7 (two_phase_100m's split round,
              static bootstrap and cap 8, its n cut from 1e8 for the time
              limit) with its xla twin at 3.2e7; the 3.2e7 run also
              prints its rounds, spill peak, phase seconds and peak memory;
              then the ring engine: -time-mode rounds at n = 1e7 (the
              rounds overlay, then ring rounds with 6e7-lane deposits,
              which must take fused_deposit_add's dense form) and
              -engine ring -graph kout -fanout 6 at n = 1e7 (its direct
              form only), each under both gate settings; -protocol
              pushpull -fanout 23 at n = 1e7 (pushpull_10m_logn, no
              kernel: once); and -engine ring
              -rumors 16 -crashrate 0 -coverage-target 0.95 at n = 1e6
              (multirumor_1m_r16) under the default gates
              (fused_deposit_both), -phase2-kernel xla (fused_deposit_add,
              fused_deposit_rows) and all-xla, one transcript for the
              three;
6. pushsum -- -model pushsum -graph kout -fanout 6 -droprate 0 -crashrate 0
              -coverage-target 0.95 at n = 1e7 (pushsum10m), seed 0,
              nothing cut, under the default gates (fused_drain_sum and
              the wide fused_ring_append), -phase2-kernel xla
              (fused_deposit_rows, no fused_drain_sum) and all-xla (no
              kernel): identical transcripts, report() dicts and final
              state leaves, mail_dropped 0, and the mass (Sigma x, Sigma
              w over the node masses and the live ring rows) equal to the
              initial totals at the end;
7. graphs  -- static graph generation at the bench's sizes, seed 0,
              nothing cut: kout100m_pallas (headline_jax: -graph kout -n
              1e8 -fanout 3 -crashrate 0.001 -coverage-target 0.90
              -pallas; kout_pallas), erdos10m and erdos10m_pallas
              (sir_10m_erdos: -graph erdos -n 1e7 -fanout 8 -protocol sir
              -removal-rate 0.2 -coverage-target 0.8, without and with
              -pallas: erdos_pallas) and erdos1m_wide (-graph erdos -n 1e6
              -er-p 1.2e-5 -protocol sir: lam 12, 38 lanes a sender, the
              Poisson rejection branch), each printing its transcript, wall
              seconds and peak memory; then the rows where graphs.erdos's
              table on the card parts from the CPU's at n = 1e6, lam 5, 8,
              12 and 60, which must be none (the CPU's rows in the worker
              processes, beside the four runs);
8. sharded -- the sharded backend with SHARDS = 8 shards laid out on the
              card (config 5's mesh): fused_recv_land bit-exact to
              recv_land_plain at the sharded paths' shapes (sharded_10m's
              compacted batch, 8 x 25,831 lanes; the same with the
              duplicate filter, fanout 6 crash 0; pushsum10m's window, 8
              x 4,375,000 lanes x 12 mass columns; an overflow case),
              timed beside its bound, with the host's enqueue of the
              batch call ("host" line) -- run right after phase 3, before
              any full-size run, so the profiler records its device time;
              then cuda-vs-cpu twins on 2 and 8
              shards (SI, SIR, erdos, erdos -pallas; PushSum on 8 only;
              the crash-0 run moved to phase 11) in the worker processes,
              which must launch fused_recv_land, and beside them sharded_10m
              (bench.py's row: headline_jax's flags, -backend sharded) at
              n = 1e7 under the default gates, and at n = 1e6 under the
              default gates, -phase2-kernel xla and -exchange-pipeline
              double (one transcript; fused_recv_land not under the
              second; the third, which keeps the serial route, gives the
              first's Stats, history columns and launches,
              exchange_inflight_hwm 2, its wall printed beside the
              first's),
              pushsum10m with -backend sharded (mass conserved, nothing
              dropped), and config 5 cut to n = 1.2e7 with its wall seconds,
              peak memory and the host seconds spent in the
              fused_recv_land wrapper;
9. faults  -- fault scenarios and overlay healing under bench.py's
              CHURN_SCENARIO (2 groups, 60 ms reboots, churn 0-150 at
              2.0, a 0.3 crash wave in group 1 at 30, a partition 20-60)
              on -graph kout -fanout 6 -crashrate 0, seed 0: cuda-vs-cpu
              twins at n = 20,000 of the runs below (the heal-on run to
              -max-rounds 300); at n = 1e7
              churn10m_heal (-overlay-heal on -coverage-target 0.99
              -max-rounds 250: scen_crashed >= 0.2 n, heal_repaired > 0,
              fused_emit with the partition mask and the heal's
              fused_ring_append launched) and churn10m_noheal (not
              converged, nothing repaired); at n = 1e6, the JAX package's
              acceptance pair (bench.py's churn_1m rows, -max-rounds
              1000): churn1m_heal and its -phase2-kernel xla
              -deliver-kernel xla twin (one transcript and Stats, no
              kernel) and churn1m_noheal (not
              converged, coverage < 0.97, nothing repaired; heal on
              converged or above it); at 1e7 ring_churn10m_heal to
              -max-rounds 250 (-engine ring: fused_deposit_add) and
              pushsum_churn10m (-model
              pushsum, heal on: Sigma x and Sigma w exactly the initial
              totals); each printing its wall, peak memory and fault
              counters;
10. rumors_event -- multi-rumor traffic on the event engine: right after
              phase 3, fused_emit with rumor words (W = 1, 2, 32, with and
              without the partition mask, at the kout main shape and kw
              112), fused_unique_set over the id and word rings (W = 1, 2,
              beside two index_put_ calls) and fused_ring_append with the
              word ring at the injection batches and the heal's appends,
              bit-exact and timed as in phase 3; then, on bench.py's
              multirumor flags (-graph kout -fanout 6 -crashrate 0
              -coverage-target 0.95 -seed 0), cuda-vs-cpu twins at
              20,000, and at n = 2.5e5 (bench.py's 1e6, cut for the time
              limit) multirumor250k_r16 (-rumors 16) under the default
              gates, -phase2-kernel xla and all-xla, stream250k (-rumors
              64 -traffic stream -stream-rate 100) under the default gates
              and all-xla (one transcript, Stats and report a run family),
              stream250k_poisson, and churn250k_heal_r16 (the JAX package's
              test_churn_partition_heal_r16 at 2.5e5) and its xla twin, those
              eight and the twins side by side in the worker processes,
              while this process runs multirumor50m_r16 at n = 5e7 once,
              with
              -event-slot-cap 350000007 (7 n + 7, the largest slot the JAX
              package's sizing allows: all 16 rumors to the target; at 1e7,
              2e7 and 3e7 8, 10 and 11 of them), each printing its wall,
              peak memory, rumors done and report;
11. sharded_faults -- -backend sharded with fault scenarios, healing and
              rumor words on SHARDS = 8 shards of the card: right after
              phase 3, fused_recv_land with rumor words (W = 1, 2, 32 and
              an overflow, bit 31 set in half the words, all ones in a
              quarter) at a compacted emission batch of
              multirumor250k_r16_s8, bit-exact to recv_land_plain and
              timed as in phase 3; then, side by side in the worker
              processes, cuda-vs-cpu twins at n = 20,000 on 2 and 8
              shards (the churn timeline with and without healing, a
              partition alone, PushSum under churn with healing, -rumors
              16, a stream of 16 at 100 a second, -rumors 16 under churn
              with healing; the churn runs to -max-rounds 300), each
              launching fused_recv_land, and multirumor250k_r16_s8 and
              stream250k_s8 (the 2.5e5 family's argv, -backend sharded:
              every rumor to the target), while this process runs
              churn10m_heal_s8 (churn10m_heal's argv: heal_repaired and
              part_dropped > 0, its scenario counters phase 9's where both
              end at one tick) and pushsum_churn10m_s8 (pushsum_churn10m's:
              the same transcript, Stats and report, the mass conserved);
              alone, the phase runs phase 9's two references itself;
12. telemetry -- the run-to-target paths' records: kout 10M (the jax_10m
              argv) with -run-dir, -trace, -telemetry-summary and
              -telemetry-spatial on, its -telemetry off twin and
              unflagged (one transcript, one fingerprint, one result.json
              Stats), then the default run and PushSum at n = 1e5 with
              -telemetry-spatial on, on the card against the same argv
              on the CPU in worker processes (equal telemetry.npz arrays,
              the panels among them, health.json and fingerprints); each
              printing its wall and phases_s;
13. checkpoint -- snapshots, -resume and shutdown (the kout run's argv at
              n = 1e7, 17 windows): (a) its windowed twin in phase 12
              also takes -checkpoint-every 6 -ckpt-keep 2 (alone, the
              phase runs it): exactly state_00000006 and state_00000012
              are left, its transcript is the unflagged run's and its
              result.json Stats the run-to-target run's; (b) -resume from
              state_00000006 ends on (a)'s Stats with (a)'s lines for
              windows 7-17, and at -event-chunk 262144 (a repack) keeps
              every in-flight entry and converges; (c) the same snapshot
              onto 8 shards of the card (-backend sharded) keeps every
              in-flight (destination, slot, offset) entry, converges and
              launches fused_recv_land; (d) the CLI in a subprocess gets
              SIGTERM after its first coverage line: exit 2, reason
              interrupted, one snapshot marked interrupted, from which
              -resume ends on (a)'s Stats; (e) the default run at n = 1e6
              (cut from 1e7: the ticks overlay's ring) with
              -checkpoint-every 10, its state_* deleted, resumes from its
              newest overlay_* to the same Stats and stabilize_ms and
              launches the three phase-1 kernels; each printing the
              snapshot bytes, the checkpoint.save and checkpoint.load
              seconds (its -trace spans) and the wall;
14. sharded_overlay -- -backend sharded on the overlays and the ring
              engine, SHARDS = 8 shards of the card, seed 0, the
              reference's defaults otherwise: at n = 1e7
              sharded_default10m (the default run's argv: the
              tick-faithful overlay, then the event engine:
              fused_ring_append, fused_chunk_step, fused_negotiate,
              fused_recv_land), sharded_ring_rounds10m (ring_rounds10m's:
              the rounds overlay, then the ring engine in rounds:
              fused_chunk_step, fused_negotiate, fused_request_round,
              fused_deposit_add), sharded_ring_kout10m (ring_kout10m's
              with the spatial panels: kout_pallas, fused_deposit_add)
              and sharded_pushpull10m (pushpull10m's: no kernel), each
              reaching its target and printing its wall, peak memory,
              exchange_overflow and launches -- the second and third
              in the worker processes with ring_rounds10m's argv at n =
              1e6 under the default gates and all-xla (one transcript,
              no kernel under all-xla), then cuda-vs-cpu twins at n =
              20,000 of the four and of the ring engine under the churn
              timeline with healing, on 2 and 8 shards, beside the first
              and the fourth in this process.

The spatial panels (-telemetry-spatial on, with a run dir under
smoke_runs/spatial/) are also armed on ring_kout10m's and pushsum10m's
default-gate runs (phases 5, 6), on churn10m_heal_s8 and
pushsum_churn10m_s8 (phase 11) and on sharded_ring_kout10m (phase 14): at every window the groups' received
and removed sum to the history's columns, the shards' mail high-water
maxes to mail_high, the traffic matrix's column sums are the shards'
routed lanes received, the matrix never falls and its total is theirs;
each prints health.json's status and findings ("spatial" and "health"
lines).

The twins' runs, on the card and on the CPU (phases 4, 8, 9, 10, 11
and 14), run in WORKERS spawned worker processes.  Phase 4's run on their own
when phase 10 does not run, else in phase 10's workers after its 2.5e5
family, beside multirumor50m_r16; phases 8, 9, 10, 11 and 14 run their
twins (and phase 10 its 2.5e5 family) beside the full runs this process
makes, as
phase 7 runs its CPU erdos rows beside its four full runs and phase 13
its two CLI processes beside its resumes, so those walls are taken
beside busy workers; "time <phase>" lines say where the script's time
goes, and "time total" what it all took, the build included.

With --profile, a full-size run (--profile-run: the default run, one
of the ring engine's runs, pushsum, erdos or sharded, the last on 8
shards; n = --profile-n, 1e7 by default)
is repeated under torch.profiler (device busy share, kernels by device
time; the profiler's bookkeeping adds minutes).  Then the `kernels` JSON
line (launches summed over the full-size runs, each run counted from 0),
the card line and, last, {"ok": true, "device": {...}}.  Any failed check
exits nonzero before that line.  Tolerance everywhere is exact equality:
all state is integer and the randomness counter-based (phase 7's
card-vs-cpu erdos tables are held to ERDOS_CARD_CPU_PARTED parting rows,
0: see utils/rng.poisson).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# Integer atomic adds a second through L2 at random cells, as measured on
# the card (PERF.md section 6): the floor of the deposits' adds.
L2_ATOMICS_PER_S = 1.2e11
# Instruction rates of the 132 SMs at the 1.98 GHz boost clock: the
# integer ALU pipe (shifts, rotates, logic) has 64 lanes an SM; every
# instruction of any pipe dispatches at one warp instruction per SM
# sub-partition and clock, 128 lanes an SM.  (nvcc also sends integer
# adds and multiplies as IMAD on the FMA pipe, so the 64-lane rate bounds
# only what must run on the ALU.)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
DISPATCH_OPS_PER_S = 128 * 132 * 1.98e9
# Instructions (all, ALU-only) of the generator kernels' pieces: a
# threefry2x32 block is 20 rounds of add, funnel-shift rotate and xor plus
# the key injections; a 32-bit unsigned remainder by a loop-invariant
# divisor is a multiply-high, a subtract, two shifts, an add and a
# multiply-subtract (erdos_pallas's magic-number form; kout_pallas's is
# nvcc's IMAD.HI, IMAD and two compare-and-subtract steps once the
# reciprocal is hoisted, 17 with it).
THREEFRY_OPS = (72, 40)
UREM32_OPS = (6, 2)
REPS = 25  # CUDA-event timings per median
TWIN_N = 20_000  # cuda-vs-cpu twins
FULL_N = 10_000_000  # the main path's full size (the jax_10m shape)
OVERLAY = ["-coverage-target", "0.9"]  # plus the reference's defaults
XLA_GATES = ["-deliver-kernel", "xla", "-phase1-kernel", "xla"]
PHASE1_KERNELS = ("fused_ring_append", "fused_chunk_step", "fused_negotiate")
ROUNDS_KERNELS = ("fused_chunk_step", "fused_negotiate", "fused_emit")
SPILL = "fused_chunk_step:spill"  # the spill form's own count
DEPOSIT = "fused_deposit_add"
DEPOSIT_DENSE = "fused_deposit_add:dense"  # the dense form's own count
# -time-mode rounds: the rounds overlay (staggered bootstrap), then the
# ring engine's rounds.
RING_ROUNDS_KERNELS = ("fused_chunk_step", "fused_negotiate",
                       "fused_request_round", DEPOSIT)
ALL_XLA = XLA_GATES + ["-phase2-kernel", "xla"]
PUSHSUM_N = 10_000_000  # pushsum10m, the port's other cells' full n
DRAIN = "fused_drain_sum"
# Graph generation's kernels: kout_pallas makes every kout table on the
# card, under every gate setting (no -*-kernel gate covers generation).
GENERATORS = ("kout_pallas", "erdos_pallas")


def gated(counts: dict) -> dict:
    """The launches of the kernels the -*-kernel gates switch."""
    return {k: v for k, v in counts.items() if k not in GENERATORS}


def kout_argv(n: int) -> list:
    """The kout run of the full, telemetry and checkpoint phases (jax_10m's
    shape at coverage 0.99, seed 0)."""
    return ["-graph", "kout", "-n", str(n), "-fanout", "6",
            "-coverage-target", "0.99", "-seed", "0"]


def pushsum_argv(n: int, seed: int = 0) -> list:
    """-model pushsum on the kout graph (fanout 6, dim 2) to 95 % within
    eps: the bench's pushsum_1m flags at n."""
    return ["-model", "pushsum", "-graph", "kout", "-fanout", "6",
            "-droprate", "0", "-crashrate", "0", "-coverage-target", "0.95",
            "-n", str(n), "-seed", str(seed)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi gave no output (rc {out.returncode})"


def time_ms(fn, reps: int, setup=None) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up;
    `setup()` runs before each call, outside the timed span (it restores
    state that fn updates in place)."""
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


# Device ms per call of each case of phase 3, from torch.profiler.
DEVICE: dict = {}
DEVICE_REPS = 3  # calls profiled per case
# Lanes fused_deposit_add's dense form sent past a full bucket, by full run.
DEPOSIT_OVERFLOW: dict = {}


def _kernel_name(key: str) -> str:
    """A device event's kernel name without namespaces, template arguments
    and parameters; PyTorch's elementwise kernels keep their functor."""
    key = key.replace("(anonymous namespace)::", "")
    name = key.split("(")[0].split("<")[0].split("::")[-1].split()[-1]
    if "elementwise_kernel" in name:
        fn = re.search(r"(\w+Functor|\w+_kernel_cuda)", key)
        name = fn.group(1) if fn else name
    return name


def _profile_split(fn, reps: int) -> tuple[dict, int]:
    """Device ms per call by kernel, and launches, of `reps` calls of fn()
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, launches = {}, 0
    for e in _device_events(prof.key_averages()):
        nm = _kernel_name(e.key)
        split[nm] = split.get(nm, 0.0) + _dev_us(e) / 1e3 / reps
        launches += e.count
    return split, launches


def device_split(label: str, fn, reps: int = DEVICE_REPS,
                 setup=None) -> None:
    """Run fn() `reps` times under torch.profiler; print its device time
    per call, in all and by kernel (every kernel the call launches:
    scratch fills and copies included), and its launches per call, and
    record the device ms per call in DEVICE[label].  With `setup`, each
    call is preceded by setup() (it restores what fn updates in place, so
    every profiled call does the first call's work), whose own kernels,
    profiled alone, are taken off.  The profiler at times returns no
    device event for a case (phase 8's after the full-size runs, so
    phase 8's cases run before them): such a case prints "not measured"
    and records nothing."""
    if setup is None:
        split, launches = _profile_split(fn, reps)
    else:
        split, launches = _profile_split(lambda: (setup(), fn()), reps)
        own, own_launches = _profile_split(setup, reps)
        launches -= own_launches
        for k, v in own.items():
            split[k] = split.get(k, 0.0) - v
        split = {k: v for k, v in split.items() if v > 1e-6}
    if not split:
        say(f"device {label}: not measured (the profiler returned no "
            "device events)")
        return
    DEVICE[label] = sum(split.values())
    say(f"device {label}: {DEVICE[label]:.4f} ms per call, "
        f"{launches / reps:g} launches: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                              key=lambda kv: -kv[1])))


def bound_ms(nbytes: float, nops: float,
             alu_ops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' time: `nops`
    instructions at the dispatch rate, of which `alu_ops` must run on the
    integer ALU pipe at its rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(nops / DISPATCH_OPS_PER_S, alu_ops / INT32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --- phase 3: kernel parity at the main path's shapes ------------------------


def emit_shapes(cfg, k: int) -> tuple:
    """(n, k, b, dw, cap, m, ring_len) of the event engine's fused_emit
    calls under `cfg` on a friends table of k columns: m senders per
    compacted batch."""
    from gossip_simulator_tpu_torch.models import event

    dw, cap = event.ring_windows(cfg), event.slot_cap(cfg)
    return (cfg.n, k, event.batch_ticks(cfg), dw, cap,
            event.sender_compaction_cap(cfg, event.drain_chunk(cfg)),
            dw * cap + event.ring_tail(cfg))


def emit_case(gen, dev, n, m, k, dw, cap, b, ring_len, *, dup, sir, base_hi,
              cnt_lo=None, lam=None):
    """Random inputs of one fused_emit call at the main path's shapes.
    With `cnt_lo`, each row holds a friend count drawn in [cnt_lo, k] and
    is padded with -1 past it, as the overlay's friends table is; with
    `lam`, a Poisson(lam) count clipped to k, as an erdos table's."""
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    sf = ri(0, n, (m, k))
    cnt = None
    if cnt_lo is not None:
        cnt = ri(cnt_lo, k + 1, (m,))
    if lam is not None:
        cnt = torch.poisson(torch.full((m,), lam, device=dev),
                            generator=gen).clamp_max(k)
    if cnt is not None:
        sf[torch.arange(k, device=dev)[None, :] >= cnt[:, None]] = -1
    drop = torch.rand((m, k), generator=gen, device=dev) < 0.1
    svalid = torch.arange(m, device=dev) < (m - m // 10)  # dead tail rows
    case = dict(
        mail_ids=torch.zeros(ring_len, dtype=torch.int32, device=dev),
        mail_cnt=ri(0, base_hi, (1, dw)), sf=sf, drop=drop, svalid=svalid,
        wslot=ri(0, dw, (m,)), off=ri(0, b, (m,)))
    kw = dict(dw=dw, cap=cap, b=b)
    if dup:
        kw["flags"] = (torch.rand(n + 1, generator=gen, device=dev)
                       < 0.5).to(torch.uint8)
    if sir:
        kw["tb"] = (n + 1) * b
        kw["strig"] = svalid & (torch.rand(m, generator=gen, device=dev)
                                < 0.9)
        kw["sender_ids"] = ri(0, n, (m,))
    return case, kw


def emit_bytes(m, k, kw_lanes, dup, sir) -> tuple[float, float]:
    """The call's bytes and instructions: every one of the m * kw_lanes
    lanes is stored once, a kept lane of a sender that fits at its ring
    cell and every other lane (0, or an overflowed edge's payload) at its
    own trash lane, as the serial kernel and the plain version store
    them."""
    nbytes = m * k * 4 + m * k + m + 4 * m + 4 * m  # sf drop svalid wslot off
    nbytes += m * kw_lanes * 4
    if dup:
        nbytes += m * k  # one flags byte per edge
    if sir:
        nbytes += m + 4 * m  # strig, sender_ids
    nops = m * (12 * kw_lanes + 40)  # masks, prefix, addresses
    return nbytes, nops


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn(), the mean over `calls` calls,
    each started on an idle card (what the caller's thread spends to
    enqueue the call)."""
    fn()
    spent = 0.0
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        spent += time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def host_split(label: str, parts: dict) -> None:
    """Print host_us of each of `parts` (name -> call) on one line."""
    out = {k: host_us(f) for k, f in parts.items()}
    torch.cuda.synchronize()
    say(f"host {label}: " + ", ".join(f"{k} {v:.2f} us"
                                      for k, v in out.items()))


def emit_forms(label, ring, args, kw) -> None:
    """Device ms per call (torch.profiler, DEVICE_REPS calls) of
    fused_emit's two forms (1 and 8 threads a sender row) on one call's
    inputs; the wrapper takes megakernel.emit_group(kw) of them."""
    from gossip_simulator_tpu_torch.ops import megakernel

    opt = dict(tb=None, strig=None, sender_ids=None, flags=None,
               received_bit=1)
    opt.update(kw)
    parts = []
    for g in (1, 8):
        split, _ = _profile_split(lambda: megakernel._launch(  # noqa: B023
            ring, *args, group=g, **opt), DEVICE_REPS)  # noqa: B023
        parts.append(f"{g} a row " + (f"{sum(split.values()):.4f} ms"
                                      if split else "not measured"))
    k = args[1].shape[1] + (kw.get("strig") is not None)
    say(f"forms fused_emit[{label}]: device " + ", ".join(parts)
        + f" (the wrapper takes {megakernel.emit_group(k)})")


def emit_host(label, ring, args, kw) -> None:
    """The host time to enqueue one fused_emit call, and its parts: the
    checks, the workspace with its epoch, the outputs' torch.empty and the
    ctypes call (a new epoch each call, as the workspace gives)."""
    from gossip_simulator_tpu_torch.ops import deliver, megakernel

    dev = ring.device
    mail_cnt, sf, drop, svalid, wslot, off = args
    m, k = sf.shape
    dw, cap, b = kw["dw"], kw["cap"], kw["b"]
    strig, sids, flags = (kw.get(x) for x in ("strig", "sender_ids",
                                              "flags"))
    stream = deliver._stream(dev.index)
    words = deliver.workspace_words(m, dw, megakernel.EMIT_TILE)
    ws, _ = deliver.workspace(dev, stream, words)
    entry = deliver._WS[dev.index, stream]
    out = torch.empty(2 * dw + 2, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    head = (ring.data_ptr(), mail_cnt.data_ptr(), sf.data_ptr(),
            drop.data_ptr(), svalid.data_ptr(), wslot.data_ptr(),
            off.data_ptr(), ptr(flags), 1, ptr(strig), ptr(sids), None,
            None, None, kw.get("tb") or 0, m, k, dw, cap, b, 0,
            megakernel.emit_group(k + (strig is not None)), out.data_ptr(),
            ws.data_ptr(), ws.numel())
    fn = megakernel._emit_fn()

    def call():
        entry[1] += 1
        return fn(*head, entry[1], None, 0, stream)

    host_split(label, {
        "wrapper": lambda: megakernel.fused_emit(ring, *args, **kw),
        "checks": lambda: megakernel._emit_check(ring, *args, dw, cap, flags,
                                                 strig, sids),
        "workspace": lambda: deliver.workspace(dev, stream, words),
        "outputs": lambda: torch.empty(2 * dw + 2, dtype=torch.int32,
                                       device=dev),
        "ctypes call": call})


def host_enqueue_split(dev, ring, flat, vals) -> None:
    """What one fused_unique_set call spends on the host, in parts: the
    current stream as a torch.cuda.Stream object and as a raw handle,
    three data_ptr reads, the whole wrapper and index_put_ (enqueue only:
    the device runs behind)."""
    from gossip_simulator_tpu_torch.ops import deliver

    flat64 = flat.long()
    parts = {
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "data_ptr x3": lambda: (ring.data_ptr(), flat.data_ptr(),
                                vals.data_ptr()),
        "wrapper": lambda: deliver.fused_unique_set(ring, flat, vals),
        "index_put_": lambda: ring.index_put_((flat64,), vals),
    }
    host_split("fused_unique_set", parts)


def phase_parity(dev, reps: int) -> dict:
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.ops import deliver, megakernel

    # The main path's phase 2 runs on the overlay's friends table (the
    # defaults at FULL_N; rows hold fanout..k friends, -1 past them); the
    # kout cases are the first slice's static graph.
    ocfg = Config(n=FULL_N).validate()
    kcfg = Config(n=FULL_N, fanout=6, graph="kout").validate()
    # Friends-table widths: the overlay's max(fanout, fanin), kout's fanout.
    shapes = {"overlay": emit_shapes(ocfg, ocfg.max_degree),
              "kout": emit_shapes(kcfg, kcfg.fanout)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for graph, (n, k, b, dw, cap, m, ring_len) in shapes.items():
        say(f"parity shapes ({graph}): n={n} m={m} k={k} dw={dw} cap={cap} "
            f"b={b} ring={ring_len}")
    timings = {}
    emit_err = 0
    unique_case = None
    for name, graph, dup, sir, small_cap, cnt_lo in (
            ("overlay", "overlay", False, False, None, ocfg.fanout),
            ("si", "kout", False, False, None, None),
            ("si_dup", "kout", True, False, None, None),
            ("sir", "kout", False, True, None, None),
            ("overflow", "kout", False, False, 400_000, None)):
        n, k, b, dw, cap, m, ring_len = shapes[graph]
        vcap, base_hi, vlen = cap, cap // 2, ring_len
        if small_cap:
            vcap, base_hi = small_cap, 300_000
            vlen = dw * vcap + m * (k + 1)
        case, kw = emit_case(gen, dev, n, m, k, dw, vcap, b, vlen, dup=dup,
                             sir=sir, base_hi=base_hi, cnt_lo=cnt_lo)
        pad = float((case["sf"] < 0).float().mean())
        ring0 = case.pop("mail_ids")
        args = [case[x] for x in ("mail_cnt", "sf", "drop", "svalid",
                                  "wslot", "off")]
        ring_p = ring0.clone()
        _, adds_p, sup_p, lost_p, _ = megakernel.emit_plain(ring_p, *args,
                                                            **kw)
        ring_k = ring0.clone()
        _, adds_k, sup_k, lost_k, _ = megakernel.fused_emit(ring_k, *args,
                                                            **kw)
        torch.cuda.synchronize()
        err = int((ring_p.to(torch.int64) - ring_k.to(torch.int64)).abs()
                  .max())
        emit_err = max(emit_err, err)
        if not (err == 0 and torch.equal(adds_p, adds_k)
                and torch.equal(sup_p, sup_k)
                and int(lost_p) == int(lost_k)):
            fail(f"fused_emit[{name}] differs from its plain version "
                 f"(max ring err {err}; adds {adds_p.tolist()} vs "
                 f"{adds_k.tolist()}, sup {sup_p.tolist()} vs "
                 f"{sup_k.tolist()}, lost {int(lost_p)} vs {int(lost_k)})")
        t_k = time_ms(lambda: megakernel.fused_emit(ring_k, *args, **kw),
                      reps)
        t_p = time_ms(lambda: megakernel.emit_plain(ring_p, *args, **kw),
                      reps)
        device_split(f"fused_emit[{name}]",
                     lambda: megakernel.fused_emit(ring_k, *args, **kw))
        emit_forms(name, ring_k, args, kw)
        if name in ("overlay", "si"):
            emit_host(f"fused_emit[{name}]", ring_k, args, kw)
        bnd, by = bound_ms(*emit_bytes(m, k, k + (1 if sir else 0), dup,
                                       sir))
        say(f"fused_emit[{name}]: bit-exact ({100 * pad:.2f}% of sf -1, "
            f"lost {int(lost_k)}, adds {adds_k.tolist()}, sup "
            f"{sup_k.tolist()}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"bound {bnd:.5f} ms ({by})")
        timings[name] = (t_k, t_p, bnd, by)
        if name == "si":
            # The same batch's unfused layout feeds fused_unique_set at the
            # main path's lane count (m * k).
            flat, ivals, *_ = megakernel.emit_layout(*args, **kw)
            unique_case = (ring0, flat, ivals)
        del ring_p, ring_k, ring0, case, args
    ring0, flat, ivals = unique_case
    ring_p = ring0.clone()
    deliver.unique_set_plain(ring_p, flat, ivals)
    ring_k = ring0.clone()
    deliver.fused_unique_set(ring_k, flat, ivals)
    torch.cuda.synchronize()
    us_err = int((ring_p.to(torch.int64) - ring_k.to(torch.int64)).abs()
                 .max())
    if us_err != 0:
        fail(f"fused_unique_set differs from index_put_ (max err {us_err})")
    flat64 = flat.long()
    lanes = flat.numel()
    t_k = time_ms(lambda: deliver.fused_unique_set(ring_k, flat, ivals), reps)
    t_p = time_ms(lambda: deliver.unique_set_plain(ring_p, flat, ivals), reps)
    t_l = time_ms(lambda: ring_p.index_put_((flat64,), ivals), reps)
    bnd, by = bound_ms(lanes * 12, lanes * 2)
    say(f"fused_unique_set: bit-exact over {lanes} lanes; kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, index_put_ {t_l:.4f} ms, "
        f"bound {bnd:.5f} ms ({by})")
    device_split("fused_unique_set",
                 lambda: deliver.fused_unique_set(ring_k, flat, ivals))
    device_split("fused_unique_set[index_put_]",
                 lambda: ring_p.index_put_((flat64,), ivals))
    host_enqueue_split(dev, ring_k, flat, ivals)
    del ring_p, ring_k, ring0, unique_case
    torch.cuda.empty_cache()
    t_ek, t_ep, b_e, by_e = timings["overlay"]
    rows = {
        "fused_emit": dict(
            route="cuda",
            source="gossip_simulator_tpu_torch/csrc/fused_emit.cu",
            replaces="gossip_simulator_tpu/ops/pallas_megakernel.py:206",
            max_abs_err=emit_err, ms=t_ek, plain_ms=t_ep, bound_ms=b_e,
            bound_by=by_e, library_ms=None),
        "fused_unique_set": dict(
            route="cuda",
            source="gossip_simulator_tpu_torch/csrc/fused_unique_set.cu",
            replaces="gossip_simulator_tpu/ops/pallas_deliver.py:357",
            max_abs_err=us_err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
            bound_by=by, library_ms=t_l),
    }
    rows["fused_ring_append"] = ring_parity(dev, gen, reps)
    rows["fused_chunk_step"] = chunk_parity(dev, gen, reps)
    rows["fused_negotiate"] = negotiate_parity(dev, gen, reps)
    rows["fused_request_round"] = request_parity(dev, gen, reps)
    rows["fused_hosted_chunk"] = hosted_parity(dev, gen, reps)
    rows["fused_chunk_step"].update(spill_parity(dev, gen, reps))
    rows.update(deposit_parity(dev, gen, reps))
    rows["fused_ring_append"].update(wide_ring_parity(dev, gen, reps))
    rows[DRAIN] = drain_parity(dev, gen, reps)
    rows["fused_deposit_rows"].update(pushsum_rows_parity(dev, gen, reps))
    rows["fused_emit"].update(width_parity(dev, gen, reps))
    rows.update(graph_parity(dev))
    return rows


def max_err(want, got, piece: int = 1 << 26) -> int:
    """Largest absolute difference over aligned tensor lists, taken in
    pieces of `piece` elements (a 10 GB ring has no room for its int64
    copies)."""
    err = 0
    for w, g in zip(want, got):
        w, g = w.reshape(-1), g.reshape(-1)
        for lo in range(0, w.numel(), piece):
            d = (w[lo:lo + piece].to(torch.int64)
                 - g[lo:lo + piece].to(torch.int64))
            err = max(err, int(d.abs().max()))
    return err


def check_and_time(label, plain, kernel, fresh, call, restore, reps):
    """Run `call(fn, state)` with the plain version and the kernel, each on
    its own `fresh()` list of state tensors (updated in place); fail unless
    the states and the returned tensors agree; then time both on the
    kernel's state, `restore(state)` before each call outside the timed
    span (it resets every tensor a call updates, so the state ends as one
    call leaves it), and record the kernel's device time under `label`
    (``device_split``).  Returns (kernel's state + results, max abs error,
    kernel ms, plain ms)."""
    outs, states = [], []
    for fn in (plain, kernel):
        st = fresh()
        outs.append(st + list(call(fn, st) or ()))
        states.append(st)
    torch.cuda.synchronize()
    err = max_err(*outs)
    if err != 0:
        fail(f"{label} differs from its plain version (max err {err})")
    st = states[1]
    t_k = time_ms(lambda: call(kernel, st), reps, lambda: restore(st))
    t_p = time_ms(lambda: call(plain, st), reps, lambda: restore(st))
    device_split(label, lambda: call(kernel, st), setup=lambda: restore(st))
    restore(st)
    call(kernel, st)
    return outs[1], err, t_k, t_p


def ring_host(label, st, pays, wslot, valid, dw, cap) -> None:
    """The host time to enqueue one fused_ring_append call on the kernel's
    state `st` (rings, cnt, dropped), and its parts: the checks, the four
    .contiguous() calls and the workspace with its epoch."""
    from gossip_simulator_tpu_torch.ops import deliver

    rings, cnt, dropped = st[:2], st[2], st[3]
    dev = wslot.device
    stream = deliver._stream(dev.index)
    words = deliver.workspace_words(wslot.shape[0], dw)
    host_split(label, {
        "wrapper": lambda: deliver.fused_ring_append(
            rings, cnt, dropped, pays, wslot, valid, dw, cap),
        "checks": lambda: deliver._ring_check(rings, cnt, dropped, pays,
                                              wslot, valid, dw, cap),
        "contiguous x4": lambda: (pays[0].contiguous(), pays[1].contiguous(),
                                  wslot.contiguous(), valid.contiguous()),
        "workspace": lambda: deliver.workspace(dev, stream, words)})


def ring_parity(dev, gen, reps: int) -> dict:
    """fused_ring_append at the overlay's shapes: one emission chunk (m =
    262,144 lanes) into the 10M default run's two rings (dw = 3, cap =
    1e8), and a small-cap case that overflows."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.models import overlay_ticks as ot
    from gossip_simulator_tpu_torch.ops import deliver

    cfg = Config(n=FULL_N).validate()
    dw, cap, m = ot.ring_windows(cfg), ot.slot_cap(cfg), ot.emit_chunk(cfg)
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    row, err = None, 0
    for name, ccap, base_hi in (("main", cap, cap // 2),
                                ("overflow", 150_000, 100_000)):
        rings0 = [ri(0, 2**30, (dw * ccap + 1,)) for _ in range(2)]
        cnt0 = ri(0, base_hi, (1, dw))
        pays = (ri(0, cfg.n, (m,)), ri(0, 2**30, (m,)))
        wslot = ri(0, dw, (m,))
        valid = torch.rand(m, generator=gen, device=dev) < 0.9
        out, e, t_k, t_p = check_and_time(
            f"fused_ring_append[{name}]", deliver.ring_append_plain,
            deliver.fused_ring_append,
            lambda: [r.clone() for r in rings0] + [
                cnt0.clone(), torch.zeros((), dtype=torch.int32,
                                          device=dev)],
            lambda fn, st: fn(st[:2], st[2], st[3], pays, wslot, valid, dw,
                              ccap) and None,
            lambda st: (st[2].copy_(cnt0), st[3].zero_()), reps)
        err = max(err, e)
        lost = int(out[3])
        ok = int(valid.sum()) - lost
        if name == "main":
            ring_host("fused_ring_append[main]", out, pays, wslot, valid, dw,
                      ccap)
        bnd, by = bound_ms(m * 13 + ok * 8 + 8 * dw, m * 40)
        say(f"fused_ring_append[{name}]: bit-exact over {m} lanes (cap "
            f"{ccap}, dropped {lost}); kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        if name == "main":
            row = dict(ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by)
        del rings0, out
        torch.cuda.empty_cache()
    return dict(route="cuda",
                source="gossip_simulator_tpu_torch/csrc/fused_ring_append.cu",
                replaces="gossip_simulator_tpu/ops/pallas_deliver.py:226",
                max_abs_err=err, library_ms=None, **row)


def chunk_parity(dev, gen, reps: int) -> dict:
    """fused_chunk_step at the main paths' drop-form shapes, both address
    forms: the 10M ticks drain (2,097,152 lanes, keys in [0, 2n], 2n the
    sentinel, cap 16, a carried count, a hot key past cap; node-major is
    the main path's form) and the rounds band (the column delivery of
    -overlay-mode rounds at n = 1e7: 78,125 live lanes a chunk, nk = n,
    cap mailbox_cap_for(n), a Poisson(fanout / 2) carried count, as the
    middle rows of a round leave it; rank-major is its form).  Returns the
    fused_chunk_step row, the rounds band as rounds_* columns."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.models import overlay
    from gossip_simulator_tpu_torch.models import overlay_ticks as ot
    from gossip_simulator_tpu_torch.ops import deliver

    ri = lambda lo, hi, shape, g=gen: torch.randint(  # noqa: E731
        lo, hi, shape, generator=g, device=dev, dtype=torch.int32)
    cfg = Config(n=FULL_N).validate()
    nk = 2 * cfg.n
    cap = cfg.mailbox_cap_for(cfg.n, stacked=True)
    m = ot.ticks_delivery_chunk(cfg, cfg.n)
    key = ri(0, nk, (m,))
    key[torch.rand(m, generator=gen, device=dev) < 0.05] = nk
    key[torch.randperm(m, generator=gen, device=dev)[:2000]] = 12_345
    s = ri(0, 2**30, (m,))
    count0 = ri(0, 3, (nk + 1,))
    # The rounds band draws from a generator of its own, so the other
    # cases of the phase keep their inputs.
    rgen = torch.Generator(device=dev)
    rgen.manual_seed(1)
    rcfg = Config(n=FULL_N, overlay_mode="rounds").validate()
    rnk, rcap = rcfg.n, rcfg.mailbox_cap_for(rcfg.n)
    rm = overlay.delivery_chunk(rcfg, rnk)
    rcount = torch.poisson(torch.full((rnk + 1,), rcfg.fanout / 2,
                                      device=dev),
                           generator=rgen).to(torch.int32)
    cases = (("ticks", key, s, nk, cap, count0),
             ("rounds", ri(0, rnk, (rm,), rgen), ri(0, rnk, (rm,), rgen),
              rnk, rcap, rcount))
    row, err = {}, 0
    for band, key, s, nk, cap, count0 in cases:
        m = key.numel()
        distinct = int(torch.unique(key[key < nk]).numel())
        for rank_major in (False, True):
            label = (f"fused_chunk_step[{band}, "
                     f"{'rank' if rank_major else 'node'}-major]")
            out, e, t_k, t_p = check_and_time(
                label, deliver.chunk_step_plain, deliver.fused_chunk_step,
                lambda: [torch.full((nk * cap + 1,), -1,  # noqa: B023
                                    dtype=torch.int32, device=dev),
                         count0.clone(),  # noqa: B023
                         torch.zeros((), dtype=torch.int32, device=dev)],
                lambda fn, st: fn(*st, key, s, nk, cap,  # noqa: B023
                                  rank_major) and None,  # noqa: B023
                lambda st: (st[1].copy_(count0),  # noqa: B023
                            st[2].zero_()), reps)
            err = max(err, e)
            lost = int(out[2])
            ok = int((key < nk).sum()) - lost
            # Each lane's key and payload in, each touched count cell read
            # and written once, each delivered cell written once.
            bnd, by = bound_ms(m * 8 + distinct * 8 + ok * 4 + 4, m * 30)
            say(f"{label}: bit-exact over {m} lanes (nk {nk}, cap {cap}, "
                f"{distinct} distinct keys, dropped {lost}); kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms "
                f"({by})")
            enq = host_us(lambda: deliver.fused_chunk_step(  # noqa: B023
                *out[:3], key, s, nk, cap, rank_major))  # noqa: B023
            say(f"host {label}: {enq:.2f} us to enqueue a call")
            cols = dict(ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by)
            if band == "ticks" and not rank_major:
                row.update(cols)
            if band == "rounds" and rank_major:
                row.update({f"rounds_{c}": v for c, v in cols.items()})
            del out
            torch.cuda.empty_cache()
    return dict(route="cuda",
                source="gossip_simulator_tpu_torch/csrc/fused_chunk_step.cu",
                replaces="gossip_simulator_tpu/ops/pallas_deliver.py:131",
                max_abs_err=err, library_ms=None, **row)


def negotiate_parity(dev, gen, reps: int) -> dict:
    """fused_negotiate at the 10M run's shapes (friends int32[1e7, 6]) and
    a ragged n, both kinds, with draws shaped as the callers draw them."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.ops import overlay_kernel

    cfg = Config(n=FULL_N).validate()
    k, rows, err = cfg.max_degree, {}, 0
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    for n in (cfg.n, cfg.n + 3):
        cnt0 = ri(cfg.fanout - 1, k + 1, (n,))
        fr0 = ri(0, n, (n, k))
        fr0[torch.arange(k, device=dev)[None, :] >= cnt0[:, None]] = -1
        pick = fr0.gather(1, ri(0, k, (n, 1)).long())[:, 0]
        src = torch.where((torch.rand(n, generator=gen, device=dev) < 0.7)
                          & (pick >= 0), pick, ri(0, n, (n,)))
        has = torch.rand(n, generator=gen, device=dev) < 0.8
        for kind, limit in (("makeup", cfg.fanin_resolved),
                            ("breakup", cfg.fanout)):
            draw = ((torch.rand(n, generator=gen, device=dev)
                     * torch.clamp_min(cnt0, 1)).to(torch.int32)
                    if kind == "makeup" else ri(0, n, (n,)))

            def restore(st):
                st[0].copy_(fr0)
                st[1].copy_(cnt0)

            out, e, t_k, t_p = check_and_time(
                f"fused_negotiate[{kind}, n={n}]",
                overlay_kernel.negotiate_plain,
                overlay_kernel.fused_negotiate,
                lambda: [fr0.clone(), cnt0.clone()],
                lambda fn, st: fn(*st, src, has, draw, kind=kind,
                                  limit=limit)[2:],
                restore, reps)
            err = max(err, e)
            # Friends row, cnt, src, has, draw in; row, cnt, reply out.
            bnd, by = bound_ms(n * (8 * k + 21), n * (12 * k + 20))
            say(f"fused_negotiate[{kind}, n={n}]: bit-exact "
                f"({int((out[2] >= 0).sum())} replies); kernel {t_k:.4f} "
                f"ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
            if n == cfg.n:
                rows[kind] = dict(ms=t_k, plain_ms=t_p, bound_ms=bnd,
                                  bound_by=by)
            del out
        del fr0, cnt0, src, has, pick
        torch.cuda.empty_cache()
    # The row reports the makeup kind (the first of each window's two).
    return dict(route="cuda",
                source="gossip_simulator_tpu_torch/csrc/fused_negotiate.cu",
                replaces="gossip_simulator_tpu/ops/pallas_overlay_kernel.py"
                         ":190",
                max_abs_err=err, library_ms=None, **rows["makeup"],
                breakup_ms=rows["breakup"]["ms"])


SPLIT_N = 100_000_000  # the split-round band's full size (two_phase_100m)
# The split band's full run, cut from SPLIT_N to 3.2e7 for the script's
# time limit (PERF.md section 4): SPLIT_ROUND_MIN_ROWS, where the split
# round, the static bootstrap and the cap-8 band all begin.
SPLIT_RUN_N = 32_000_000
SPLIT_TWIN_N = 40_000_000  # the split band's twin pair when that run is slow
# The split run's xla twin runs at its n below this wall time, else as a
# pair at SPLIT_TWIN_N.
TWIN_LIMIT_S = 300.0


def request_parity(dev, gen, reps: int) -> dict:
    """fused_request_round at n = 1e7, k = 6, fanout 5, counts spread over
    0..6 (rows under fanout append and emit, the rest are untouched)."""
    from gossip_simulator_tpu_torch.ops import overlay_kernel

    n, k, fanout = FULL_N, 6, 5
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    cnt0 = ri(0, k + 1, (n,))
    fr0 = ri(0, n, (n, k))
    fr0[torch.arange(k, device=dev)[None, :] >= cnt0[:, None]] = -1
    w = ri(0, n, (n,))

    def restore(st):
        st[0].copy_(fr0)
        st[1].copy_(cnt0)

    out, err, t_k, t_p = check_and_time(
        "fused_request_round", overlay_kernel.request_round_plain,
        overlay_kernel.fused_request_round,
        lambda: [fr0.clone(), cnt0.clone()],
        lambda fn, st: fn(*st, w, fanout=fanout)[2:], restore, reps)
    under = int(out[3])
    # cnt and w read and em written for every row; an under row writes one
    # friends cell and its count, each a 4-byte store into a 32-byte
    # sector: the distinct sectors written, each friends sector only
    # written (the lower bound, the row's) or also read (a partial
    # sector's read-modify-write; cnt's sectors are read in full anyway).
    rows_u = torch.nonzero(cnt0 < fanout).flatten()
    cells = rows_u * k + torch.clamp_max(cnt0[rows_u], k - 1).long()
    f_sec = int(torch.unique(cells // 8).numel())
    c_sec = int(torch.unique(rows_u // 8).numel())
    reads, writes = n * 8, n * 4 + (f_sec + c_sec) * 32
    bnd, by = bound_ms(reads + writes, n * 10)
    rw, _ = bound_ms(reads + writes + f_sec * 32, n * 10)
    say(f"fused_request_round: bit-exact (n {n}, {under} rows under "
        f"fanout: {f_sec} friends and {c_sec} cnt sectors written); kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by}; "
        f"{rw:.5f} ms if each written sector is also read)")
    del fr0, cnt0, w, out, rows_u, cells
    torch.cuda.empty_cache()
    return dict(route="cuda",
                source="gossip_simulator_tpu_torch/csrc/fused_request_round.cu",
                replaces="gossip_simulator_tpu/ops/pallas_overlay_kernel.py"
                         ":260",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=None, read_write_bound_ms=rw)


def hosted_parity(dev, gen, reps: int) -> dict:
    """fused_hosted_chunk on the split round's emission matrices at n =
    1e8: the (8, n) slot rows and the (1, n) bootstrap row, about half of
    the entries live; beside it the one PyTorch call that computes the
    same counts."""
    from gossip_simulator_tpu_torch.ops import overlay_kernel

    mat = torch.randint(-2**30, 2**30, (8, SPLIT_N), generator=gen,
                        device=dev, dtype=torch.int32)
    row, err = None, 0
    for rows in (8, 1):
        m = mat[:rows]
        out, e, t_k, t_p = check_and_time(
            f"fused_hosted_chunk[{rows} x {SPLIT_N}]",
            overlay_kernel.hosted_chunk_plain,
            overlay_kernel.fused_hosted_chunk, list,
            lambda fn, st: [fn(m)], lambda st: None, reps)  # noqa: B023
        err = max(err, e)
        t_l = time_ms(lambda: (m >= 0).sum(1, dtype=torch.int32),  # noqa
                      reps)
        bnd, by = bound_ms(rows * SPLIT_N * 4, rows * SPLIT_N * 2)
        live = out[0].tolist()
        say(f"fused_hosted_chunk[{rows} x {SPLIT_N}]: bit-exact ({sum(live)} "
            f"live of {rows * SPLIT_N}); kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, (mat >= 0).sum(1) {t_l:.4f} ms, bound "
            f"{bnd:.5f} ms ({by})")
        if rows == 8:
            row = dict(ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by,
                       library_ms=t_l)
    del mat
    torch.cuda.empty_cache()
    return dict(route="cuda",
                source="gossip_simulator_tpu_torch/csrc/fused_hosted_chunk.cu",
                replaces="gossip_simulator_tpu/ops/pallas_overlay_kernel.py"
                         ":329",
                max_abs_err=err, **row)


def spill_parity(dev, gen, reps: int) -> dict:
    """The spill form of fused_chunk_step at the split band's shapes (nk =
    1e8, cap 8, rank-major, scap = spill_cap_for at 1e8 = 19,603,022): an
    8,388,608-lane burst chunk on a carried count (Poisson(4), the fifth
    burst row's) with half the burst's expected overflow already spilled;
    the re-delivery chunk (scap + 1 lanes, the expected overflow, ~12.2M,
    live; a fresh carry); and the burst chunk into a small spill that
    fills, so the drop path runs.  Returns the spill form's columns
    of the fused_chunk_step row."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.models import overlay
    from gossip_simulator_tpu_torch.ops import deliver

    cfg = Config(n=SPLIT_N, coverage_target=0.9).validate()
    nk, cap = cfg.n, cfg.mailbox_cap_for(cfg.n)
    scap = overlay.spill_cap_for(cfg, nk)
    m = overlay.hosted_chunk_widths(cfg, nk)[-1]
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    # The burst's expected overflow, n * E[(Poisson(fanout) - cap)+]:
    # ~12.2M pairs at 1e8.
    expected = int(nk * overlay._poisson_excess(float(cfg.fanout), cap))
    burst_count = torch.poisson(torch.full((nk + 1,), 4.0, device=dev),
                                generator=gen).to(torch.int32)
    burst_key, burst_s = ri(0, nk, (m,)), ri(0, nk, (m,))
    re_dst = torch.full((scap + 1,), -1, **i32)
    re_dst[:expected] = ri(0, nk, (expected,))
    re_key = torch.where(re_dst >= 0, re_dst, nk).to(torch.int32)
    re_s = ri(0, nk, (scap + 1,))
    small = min(200_000, scap // 10)
    cases = (("burst", burst_key, burst_s, burst_count, scap, expected // 2),
             ("redelivery", re_key, re_s, None, scap, 0),
             ("fills", burst_key, burst_s, burst_count, small,
              small * 3 // 4))
    row, err = None, 0
    for name, key, s, count0, sc, scnt0 in cases:
        pairs0 = torch.full((2, sc + 1), -1, **i32)
        pairs0[:, :scnt0] = ri(0, nk, (2, scnt0))
        count0 = count0 if count0 is not None else torch.zeros(nk + 1, **i32)

        def fresh():
            return [torch.full((nk * cap + 1,), -1, **i32), count0.clone(),
                    torch.zeros((), **i32), pairs0.clone(),
                    torch.tensor(scnt0, **i32)]

        def restore(st):
            st[1].copy_(count0)
            st[2].zero_()
            st[3].copy_(pairs0)
            st[4].fill_(scnt0)

        out, e, t_k, t_p = check_and_time(
            f"fused_chunk_step[spill, {name}]", deliver.chunk_step_plain,
            deliver.fused_chunk_step, fresh,
            lambda fn, st: fn(*st[:3], key, s, nk, cap,  # noqa: B023
                              True, spill=(st[3], st[4])) and None,
            restore, reps)
        err = max(err, e)
        lost, fits = int(out[2]), int(out[4]) - scnt0
        live = int((key < nk).sum())
        ovf = lost + fits
        distinct = int(torch.unique(key[key < nk]).numel())
        # Key and payload in per lane; each touched count cell read and
        # written; each delivered cell and each spilled pair written.
        bnd, by = bound_ms(key.numel() * 8 + distinct * 8
                           + (live - ovf) * 4 + fits * 8,
                           key.numel() * 40)
        say(f"fused_chunk_step[spill, {name}]: bit-exact over {key.numel()} "
            f"lanes ({live} live, nk {nk}, cap {cap}, scap {sc}; {ovf} "
            f"overflowed: {fits} spilled, {lost} dropped); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        if name == "burst":
            row = dict(spill_ms=t_k, spill_plain_ms=t_p, spill_bound_ms=bnd,
                       spill_bound_by=by)
        if name == "fills" and lost <= 0:
            fail("fused_chunk_step[spill, fills]: the spill did not fill")
        del out, pairs0
        torch.cuda.empty_cache()
    del burst_count, burst_key, burst_s, re_dst, re_key, re_s
    torch.cuda.empty_cache()
    return dict(spill_max_abs_err=err, **row)


RING_N = 10_000_000  # the ring engine's full size (the jax_10m shape)
RUMOR_N = 1_000_000  # the multirumor_1m_r16 shape


def _deposit_lanes(gen, dev, b, n, rows, k, valid, per_row_slot=True):
    """Lanes of one ring-engine deposit: k lanes a sender row, the row's
    slot on all its lanes (or slot 1 everywhere: rounds mode), random
    destinations, `valid` of the lanes kept and the others at dst = n."""
    m = rows * k
    if per_row_slot:
        slots = torch.randint(0, b, (rows,), generator=gen, device=dev,
                              dtype=torch.int32).repeat_interleave(k)
    else:
        slots = torch.ones(m, dtype=torch.int32, device=dev)
    dst = torch.randint(0, n, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    ok = torch.rand(m, generator=gen, device=dev) < valid
    return slots, dst, ok, torch.where(ok, dst, n).to(torch.int32)


def _touched(flat, ok, cols=None):
    """Distinct 32-byte sectors the in-range lanes touch (cells flat *
    width + column for the nonzero entries of `cols`), each read and
    written once: a 4-byte scattered add moves a whole sector."""
    cells = flat[ok]
    if cols is not None:
        v = cols[ok]
        w = v.shape[1]
        idx = (cells[:, None] * w + torch.arange(w, device=flat.device))
        cells = idx[v != 0]
    return int(torch.unique(cells // 8).numel())


def deposit_host(label, pend, slots, dst, vals) -> None:
    """The host time to enqueue one fused_deposit_rows call, and its parts:
    the checks and the three .contiguous() calls."""
    from gossip_simulator_tpu_torch.ops import deliver

    host_split(label, {
        "wrapper": lambda: deliver.fused_deposit_rows(pend, slots, dst,
                                                      vals),
        "checks": lambda: deliver._deposit_check(
            deliver.DEPOSIT_ROWS, pend, slots, dst, vals),
        "contiguous x3": lambda: (slots.contiguous(), dst.contiguous(),
                                  vals.contiguous())})


def both_host(st, dst, slots, valid, newbits) -> None:
    """The host time to enqueue one fused_deposit_both call on the kernel's
    state `st` (pending, pending_rumors), and its parts: the checks, the
    four .contiguous() calls and the ctypes call."""
    from gossip_simulator_tpu_torch.ops import _build, deliver, megakernel

    pend, prum = st[0], st[1]
    k = newbits.shape[0] and dst.shape[0] // newbits.shape[0]
    fn = _build.function(megakernel.BOTH, "gossip_fused_deposit_both",
                         megakernel.BOTH_ARGTYPES)
    b, n = pend.shape
    head = (pend.data_ptr(), prum.data_ptr(), slots.data_ptr(),
            dst.data_ptr(), valid.data_ptr(), newbits.data_ptr(),
            dst.shape[0], b, n, newbits.shape[1], k,
            deliver._stream(pend.get_device()))
    host_split("fused_deposit_both", {
        "wrapper": lambda: megakernel.fused_deposit_both(
            pend, prum, dst, slots, valid, newbits),
        "checks": lambda: megakernel._both_check(pend, prum, dst, slots,
                                                 valid, newbits),
        "contiguous x4": lambda: (dst.contiguous(), slots.contiguous(),
                                  valid.contiguous(), newbits.contiguous()),
        "ctypes call": lambda: fn(*head)})


def add_host(label, pend, slots, dst, valid) -> None:
    """The host time to enqueue one fused_deposit_add call with the mask
    (as models/epidemic.deposit_local makes it), and its parts: the checks,
    the dense form's workspace (where the call takes that form) and the
    ctypes call (on the direct form's arguments: a repeated dense call
    would add into cursors its partition blocks had not yet zeroed)."""
    from gossip_simulator_tpu_torch.ops import deliver

    b, n = pend.shape
    m = slots.shape[0]
    stream = deliver._stream(pend.get_device())
    bits = deliver.deposit_part_bits(m, b * n)
    parts = {
        "wrapper": lambda: deliver.fused_deposit_add(pend, slots, dst,
                                                     valid),
        "checks": lambda: deliver._add_check(pend, slots, dst, valid)}
    if bits:
        cells = (b * n + (1 << bits) - 1) >> bits
        elems = cells * deliver.deposit_bucket_cap(m, cells)
        parts["workspace"] = lambda: deliver.deposit_workspace(
            pend.device, stream, elems)
    else:
        fn = deliver._add_fn()
        head = (pend.data_ptr(), slots.data_ptr(), dst.data_ptr(),
                valid.data_ptr(), m, b, n, 0, None, None, 0, stream)
        parts["ctypes call"] = lambda: fn(*head)
    host_split(f"{label} ({'dense' if bits else 'direct'} form)", parts)


def deposit_add_parity(dev, gen, reps: int) -> dict:
    """fused_deposit_add as the ring engine calls it (the lanes and their
    mask: models/epidemic.deposit_local) at the full-size runs' three
    shapes: ring_rounds10m's rounds deposit (b = 2, n = 1e7, m = n * 6
    lanes, all into one slot, 35 % kept), ring_kout10m's compacted ticks
    chunk (b = 20, n = 1e7, 78,125 sender rows * 6, 90 % kept) and
    rumors1m_p2_xla's dense deposit (b = 20, n = 1e6, 6e6 lanes, a fifth
    of the rows sending, 90 % of their lanes kept).  At each, both forms
    (the wrapper's, then the other, forced through DEPOSIT_DENSE_MIN) are
    bit-exact to deposit_add_plain and timed, beside index_put_ with
    accumulate on the kept lanes and the bound: every lane's slot, dst and
    valid byte read once, and each touched 32-byte sector of the ring read
    and written once; the direct form's atomic floor is printed too.
    Returns the fused_deposit_add row (the rounds shape; chunk_* and
    rumors_* columns)."""
    from gossip_simulator_tpu_torch.ops import deliver

    i32 = dict(dtype=torch.int32, device=dev)
    row, err = {}, 0
    keep_min = deliver.DEPOSIT_DENSE_MIN
    for name, b, n, rows, keep, sending, per_row in (
            ("rounds", 2, RING_N, RING_N, 0.35, 1.0, False),
            ("chunk", 20, RING_N, RING_N // 128, 0.9, 1.0, True),
            ("rumors", 20, RUMOR_N, RUMOR_N, 0.9, 0.2, True)):
        slots, dst, ok, _ = _deposit_lanes(gen, dev, b, n, rows, 6, keep,
                                           per_row)
        if sending < 1.0:
            ok &= (torch.rand(rows, generator=gen, device=dev)
                   < sending).repeat_interleave(6)
        pend0 = torch.randint(0, 4, (b, n), generator=gen, **i32)
        m = slots.numel()
        bits = deliver.deposit_part_bits(m, b * n)
        forms = ("dense", "direct") if bits else ("direct", "dense")
        cols = {}
        for form in forms:
            deliver.DEPOSIT_DENSE_MIN = (keep_min if form == forms[0] else
                                         0.0 if form == "dense" else
                                         float("inf"))
            lost0 = deliver.deposit_overflow(dev)
            try:
                out, e, t_k, t_p = check_and_time(
                    f"fused_deposit_add[{name}"
                    + ("" if form == forms[0] else f", {form}") + "]",
                    deliver.deposit_add_plain, deliver.fused_deposit_add,
                    lambda: [pend0.clone()],  # noqa: B023
                    lambda fn, st: [fn(st[0], slots, dst,  # noqa: B023
                                       ok)][1:],  # noqa: B023
                    lambda st: None, reps)
                lost = deliver.deposit_overflow(dev) - lost0
                if form == forms[0]:
                    add_host(f"fused_deposit_add[{name}]", out[0], slots,
                             dst, ok)
            finally:
                deliver.DEPOSIT_DENSE_MIN = keep_min
            err = max(err, e)
            cols[form] = (t_k, t_p, lost)
            del out
        flat = slots.long() * n + dst.long()
        flat_ok = flat[ok]
        kept = int(flat_ok.numel())
        one = torch.ones(kept, **i32)
        pv = pend0.clone().view(-1)
        t_l = time_ms(lambda: pv.index_put_((flat_ok,),  # noqa: B023
                                            one, accumulate=True),  # noqa
                      reps)
        sectors = _touched(flat, ok)
        bnd, by = bound_ms(m * 9 + sectors * 64, m * 4)
        t_k, t_p, lost = cols[forms[0]]
        other = cols[forms[1]]
        say(f"fused_deposit_add[{name}]: both forms bit-exact over {m} "
            f"lanes ({b} x {n} ring, {kept} kept, {sectors} sectors "
            f"touched, {m / (b * n):.4f} lanes a cell); the wrapper's "
            f"{forms[0]} form {t_k:.4f} ms ({lost} lanes past a full "
            f"bucket), the {forms[1]} form {other[0]:.4f} ms ({other[2]}); "
            f"plain {t_p:.4f} ms, index_put_ {t_l:.4f} ms, bound "
            f"{bnd:.5f} ms ({by}); {kept} adds are "
            f"{kept / L2_ATOMICS_PER_S * 1e3:.5f} ms at the L2 atomic rate")
        c = dict(ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by,
                 library_ms=t_l, form=forms[0], other_form_ms=other[0],
                 overflow=lost)
        if name == "rounds":
            row.update(c)
        else:
            row.update({f"{name}_{k}": v for k, v in c.items()})
        del slots, dst, ok, pend0, flat, flat_ok, one, pv
        torch.cuda.empty_cache()
    return dict(route="cuda", source="gossip_simulator_tpu_torch/csrc/"
                "fused_deposit_add.cu",
                replaces="gossip_simulator_tpu/ops/pallas_deliver.py:291",
                max_abs_err=err, **row)


def deposit_parity(dev, gen, reps: int) -> dict:
    """The ring engine's three deposit kernels at the full-size runs'
    shapes, each bit-exact to its plain version and timed beside it, the
    one PyTorch call computing the same adds (index_put_ with accumulate
    on the in-range lanes, the mask taken outside the timed span) and the
    bound: fused_deposit_add at its three shapes (deposit_add_parity);
    fused_deposit_rows and fused_deposit_both at the multi-rumor 1M run's
    dense deposit (b = 20, n = 1e6, R = 16, m = 6e6, 20 % of the rows
    sending, their new-bit rows 25 % set)."""
    from gossip_simulator_tpu_torch.ops import deliver, megakernel

    i32 = dict(dtype=torch.int32, device=dev)
    rows_out = {"fused_deposit_add": deposit_add_parity(dev, gen, reps)}

    b, n, r, k, rows = 20, RUMOR_N, 16, 6, RUMOR_N
    slots, dst, ok, dst_n = _deposit_lanes(gen, dev, b, n, rows, k, 1.0)
    sending = torch.rand(rows, generator=gen, device=dev) < 0.2
    newbits = (torch.rand((rows, r), generator=gen, device=dev) < 0.25) \
        & sending[:, None]
    ok = ok & sending.repeat_interleave(k)
    dst_n = torch.where(ok, dst, n).to(torch.int32)
    vals = newbits.to(torch.int32).repeat_interleave(k, dim=0)
    pend0 = torch.randint(0, 4, (b, n), generator=gen, **i32)
    prum0 = torch.randint(0, 4, (b, n, r), generator=gen, **i32)
    flat = slots.long() * n + dst_n.long()
    m = slots.numel()
    touched = _touched(flat, ok)
    touched_r = _touched(flat, ok, vals)

    out, err_r, t_k, t_p = check_and_time(
        "fused_deposit_rows", deliver.deposit_rows_plain,
        deliver.fused_deposit_rows, lambda: [prum0.clone()],
        lambda fn, st: [fn(st[0], slots, dst_n, vals)][1:],
        lambda st: None, reps)
    deposit_host("fused_deposit_rows", out[0], slots, dst_n, vals)
    flat_ok, vals_ok = flat[ok], vals[ok]
    pr = out[0].view(b * n, r)
    t_l = time_ms(lambda: pr.index_put_((flat_ok,), vals_ok,
                                        accumulate=True), reps)
    kept = int(ok.sum())
    # Every lane's slot and dst; the value row of an in-range lane only.
    bnd, by = bound_ms(m * 8 + kept * r * 4 + touched_r * 64, kept * r)
    say(f"fused_deposit_rows: bit-exact over {m} lanes x {r} ({kept} "
        f"kept, {touched_r} sectors touched); kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms, index_put_ {t_l:.4f} ms, bound {bnd:.5f} ms ({by})")
    rows_out["fused_deposit_rows"] = dict(
        route="cuda", source="gossip_simulator_tpu_torch/csrc/"
        "fused_deposit_rows.cu",
        replaces="gossip_simulator_tpu/ops/pallas_deliver.py:308",
        max_abs_err=err_r, ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by,
        library_ms=t_l)
    del out, pr
    torch.cuda.empty_cache()

    out, err_b, t_k, t_p = check_and_time(
        "fused_deposit_both", megakernel.deposit_both_plain,
        megakernel.fused_deposit_both,
        lambda: [pend0.clone(), prum0.clone()],
        lambda fn, st: [fn(st[0], st[1], dst, slots, ok, newbits)][1:],
        lambda st: None, reps)
    one = torch.ones(flat_ok.numel(), **i32)
    pv, pr = out[0].view(-1), out[1].view(b * n, r)

    def library():
        pv.index_put_((flat_ok,), one, accumulate=True)
        pr.index_put_((flat_ok,), vals_ok, accumulate=True)

    t_l = time_ms(library, reps)
    both_host(out, dst, slots, ok, newbits)
    # Every lane's valid byte; slot and dst of a valid lane; the bit row
    # of a sender with a valid lane, once.
    senders = int(ok.view(rows, k).any(dim=1).sum())
    bnd, by = bound_ms(m + kept * 8 + senders * r + touched * 64
                       + touched_r * 64, kept * (r + 1))
    # The adds through L2 atomics: one a kept lane's count, one a set bit;
    # and the 32-byte sectors they fall in, each read and written once
    # from device memory (a random 4-byte add moves a whole sector).
    adds = kept + int(vals[ok].sum())
    cols = torch.arange(r, device=dev)
    sectors = (torch.unique(flat[ok] * 4 // 32).numel()
               + torch.unique((flat[ok, None] * r + cols)[vals[ok] != 0]
                              * 4 // 32).numel())
    say(f"fused_deposit_both: {adds} atomic adds, "
        f"{adds / L2_ATOMICS_PER_S * 1e3:.5f} ms at the L2 atomic rate; "
        f"{sectors} sectors touched, "
        f"{sectors * 64 / HBM_BYTES_PER_S * 1e3:.5f} ms to read and "
        f"write them")
    say(f"fused_deposit_both: bit-exact over {m} lanes x {r} ({kept} "
        f"kept, {senders} senders); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, the two "
        f"index_put_ {t_l:.4f} ms, bound {bnd:.5f} ms ({by})")
    rows_out["fused_deposit_both"] = dict(
        route="cuda", source="gossip_simulator_tpu_torch/csrc/"
        "fused_deposit_both.cu",
        replaces="gossip_simulator_tpu/ops/pallas_megakernel.py:465",
        max_abs_err=err_b, ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by,
        library_ms=t_l)
    del out, pv, pr, pend0, prum0, vals, vals_ok, flat, flat_ok, one
    torch.cuda.empty_cache()
    return rows_out


def pushsum_shapes() -> tuple:
    """(cfg, n, lanes a window, dw, cap, ring length, C, b, drain chunk)
    of pushsum10m: every node sends to its 6 friends each window, and all
    of a window's lanes land in the next window's slot (delays 10-19,
    B = 10)."""
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.models import pushsum as ps

    cfg, _ = parse_cli(pushsum_argv(PUSHSUM_N))
    return (cfg, cfg.n, cfg.n * cfg.fanout, ps.ring_windows(cfg),
            ps.slot_cap(cfg), ps.ring_len(cfg), ps.mass_cols(cfg),
            ps.batch_ticks(cfg), ps.drain_chunk(cfg))


def _limb_rows(gen, dev, rows, c):
    """Random normalized limbs, each block's top limb 0 (the run's values
    stay below 2^48), as the mass rows of a run look."""
    x = torch.randint(0, 2**16, (rows, c), generator=gen, device=dev,
                      dtype=torch.int32)
    x.view(rows, c // 4, 4)[..., 3] = 0
    return x


def wide_ring_parity(dev, gen, reps: int) -> dict:
    """The wide form of fused_ring_append at pushsum10m's shape: one
    window's 6e7 lanes, all into the next slot, into the id ring and the
    (dw*cap + tail, 12) mass ring (flat row offsets past 2^31).  Returns
    the wide form's columns of the fused_ring_append row."""
    from gossip_simulator_tpu_torch.ops import deliver

    _, n, m, dw, cap, length, c, b, _ = pushsum_shapes()
    i32 = dict(dtype=torch.int32, device=dev)
    pays = (torch.randint(0, n * b, (m,), generator=gen, **i32),
            _limb_rows(gen, dev, m, c))
    wslot = torch.ones(m, **i32)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    out, err, t_k, t_p = check_and_time(
        "fused_ring_append[wide]", deliver.ring_append_plain,
        deliver.fused_ring_append,
        lambda: [torch.zeros(length, **i32), torch.zeros((length, c), **i32),
                 torch.zeros((1, dw), **i32), torch.zeros((), **i32)],
        lambda fn, st: fn(st[:2], st[2], st[3], pays, wslot, valid, dw,
                          cap) and None,
        lambda st: (st[2].zero_(), st[3].zero_()), reps)
    lost = int(out[3])
    ok = m - lost
    ring_host("fused_ring_append[wide]", out, pays, wslot, valid, dw, cap)
    # Each lane's id, mass row, slot and flag in; id and row of each
    # appended lane out.
    bnd, by = bound_ms(m * (4 + 4 * c + 4 + 1) + ok * (4 + 4 * c), m * 40)
    say(f"fused_ring_append[wide]: bit-exact over {m} lanes x {c} columns "
        f"(cap {cap}, ring {length} rows, dropped {lost}); kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
    if lost:
        fail("fused_ring_append[wide]: the full-size window overflowed")
    del out, pays, wslot, valid
    torch.cuda.empty_cache()
    return dict(wide_max_abs_err=err, wide_ms=t_k, wide_plain_ms=t_p,
                wide_bound_ms=bnd, wide_bound_by=by)


def _drain_case(dev, gen, reps, label, n, m, dw, cap, length, c, b) -> dict:
    """fused_drain_sum over the last slot of a ring of `length` rows
    holding m live lanes, into an (n, c) accumulator: bit-exact to
    drain_sum_plain, timed beside it, beside the one index_add_ of the live
    lanes' rows and beside the bound, in the form the wrapper takes there
    (drain_part_rows).  Returns the case's columns."""
    from gossip_simulator_tpu_torch.ops import megakernel

    i32 = dict(dtype=torch.int32, device=dev)
    slot = dw - 1
    s0 = slot * cap
    ids = torch.zeros(length, **i32)
    dst = torch.randint(0, n, (m,), generator=gen, **i32)
    ids[s0:s0 + m] = dst * b + torch.randint(0, b, (m,), generator=gen, **i32)
    mass = torch.zeros((length, c), **i32)
    mass[s0:s0 + m] = _limb_rows(gen, dev, m, c)
    cnt = torch.zeros((1, dw), **i32)
    cnt[0, slot] = m
    acc0 = _limb_rows(gen, dev, n, c)

    def call(fn, st):
        fn(st[0], ids, mass, cnt, slot, cap=cap, b=b)

    out, err, t_k, t_p = check_and_time(
        label, megakernel.drain_sum_plain, megakernel.fused_drain_sum,
        lambda: [acc0.clone()], call, lambda st: st[0].copy_(acc0), reps)
    rows64, live = dst.long(), mass[s0:s0 + m]
    acc = out[0]
    t_l = time_ms(lambda: acc.index_add_(0, rows64, live), reps,
                  lambda: acc.copy_(acc0))
    touched = int(torch.unique(rows64).numel())
    nonzero = int((live != 0).sum())
    # Each live lane's id and mass row in; each touched accumulator row
    # read and written once; one add per nonzero limb.
    bnd, by = bound_ms(m * (4 + 4 * c) + touched * 8 * c, nonzero)
    rows = megakernel.drain_part_rows(n, c)
    say(f"{label}: bit-exact over {m} live lanes x {c} columns (n {n}, "
        f"slot {slot} of cap {cap}, {touched} rows touched, {nonzero} "
        f"nonzero limbs); kernel {t_k:.4f} ms (part_rows {rows}), plain "
        f"{t_p:.4f} ms, index_add_ {t_l:.4f} ms, bound {bnd:.5f} ms ({by})")
    del out, acc, acc0, ids, mass, dst, rows64, live
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                bound_by=by, library_ms=t_l, part_rows=rows)


def drain_parity(dev, gen, reps: int) -> dict:
    """fused_drain_sum at pushsum10m's shape (the last slot of the full
    ring, mass offsets past 2^31, one window's 6e7 live lanes into the
    (1e7, 12) accumulator) and at pushsum10m_sharded's per-shard shape
    (n_local 1.25e6, 8.75e6 live lanes, the shard's own cap)."""
    _, n, m, dw, cap, length, c, b, _ = pushsum_shapes()
    row = dict(route="cuda",
               source="gossip_simulator_tpu_torch/csrc/fused_drain_sum.cu",
               replaces="gossip_simulator_tpu/ops/pallas_megakernel.py:414")
    row.update(_drain_case(dev, gen, reps, DRAIN, n, m, dw, cap, length, c,
                           b))
    sh = pushsum_recv_shapes(PUSHSUM_N, SHARDS)
    nl = sh["n_local"]
    shard = _drain_case(dev, gen, reps, f"{DRAIN}[shard]", nl,
                        sh["fill"] * SHARDS, sh["dw"], sh["cap"],
                        sh["length"], sh["width"], sh["b"])
    row["shard_max_abs_err"] = shard.pop("max_abs_err")
    row.update({f"shard_{k}": v for k, v in shard.items()})
    return row


def pushsum_rows_parity(dev, gen, reps: int) -> dict:
    """fused_deposit_rows at PushSum's shape: one drain chunk (524,288
    lanes, every lane live) of 12-column mass rows into the (1, 1e7, 12)
    accumulator, as -phase2-kernel xla's chunked drain calls it.  Returns
    the pushsum_* columns of the fused_deposit_rows row."""
    from gossip_simulator_tpu_torch.ops import deliver

    _, n, _, _, _, _, c, _, ccap = pushsum_shapes()
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.zeros(ccap, **i32)
    dst = torch.randint(0, n, (ccap,), generator=gen, **i32)
    vals = _limb_rows(gen, dev, ccap, c)
    acc0 = _limb_rows(gen, dev, n, c).view(1, n, c)
    out, err, t_k, t_p = check_and_time(
        "fused_deposit_rows[pushsum]", deliver.deposit_rows_plain,
        deliver.fused_deposit_rows, lambda: [acc0.clone()],
        lambda fn, st: [fn(st[0], slots, dst, vals)][1:],
        lambda st: st[0].copy_(acc0), reps)
    flat = dst.long()
    pv = out[0].view(n, c)
    t_l = time_ms(lambda: pv.index_put_((flat,), vals, accumulate=True),
                  reps)
    ok = torch.ones(ccap, dtype=torch.bool, device=dev)
    touched = _touched(flat, ok, vals)
    bnd, by = bound_ms(ccap * 8 + ccap * c * 4 + touched * 64, ccap * c)
    say(f"fused_deposit_rows[pushsum]: bit-exact over {ccap} lanes x {c} "
        f"(1 x {n} accumulator, {touched} sectors touched); kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, index_put_ {t_l:.4f} ms, bound "
        f"{bnd:.5f} ms ({by})")
    del out, pv, acc0, slots, dst, vals, flat
    torch.cuda.empty_cache()
    return dict(pushsum_max_abs_err=err, pushsum_ms=t_k,
                pushsum_plain_ms=t_p, pushsum_bound_ms=bnd,
                pushsum_bound_by=by, pushsum_library_ms=t_l)


def width_parity(dev, gen, reps: int) -> dict:
    """ROADMAP C1: the widths past the kernels' old limits, bit-exact to
    the plain versions -- fused_negotiate at k = 20 and k = 200 (both
    past the 16-column register row) on 1e6 rows; fused_emit at dw = 40
    (-delaylow 1 -delayhigh 40), kw = 33 (-fanout 32 SIR) and kw = 112
    (erdos SIR at lam = 60) on the main path's 131,072 senders, and at
    erdos1m_wide's own batch (38 lanes a sender, Poisson(12) friend
    counts); fused_ring_append at dw = 40 on 262,144 lanes.  Returns the
    fused_emit row's kw112_* and erdos1m_wide_* columns (time, plain
    time, bound: every lane's store counted, at its ring cell or its
    trash lane); the other times are printed only."""
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.ops import deliver, megakernel
    from gossip_simulator_tpu_torch.ops import overlay_kernel

    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    n = 1_000_000
    for k in (20, 200):
        cnt0 = ri(k - 2, k + 1, (n,))
        fr0 = ri(0, n, (n, k))
        fr0[torch.arange(k, device=dev)[None, :] >= cnt0[:, None]] = -1
        pick = fr0.gather(1, ri(0, k, (n, 1)).long())[:, 0]
        src = torch.where(pick >= 0, pick, ri(0, n, (n,)))
        has = torch.rand(n, generator=gen, device=dev) < 0.8
        for kind, limit, draw in (
                ("makeup", k, (torch.rand(n, generator=gen, device=dev)
                               * cnt0).to(torch.int32)),
                ("breakup", k - 1, ri(0, n, (n,)))):
            out, _, t_k, t_p = check_and_time(
                f"fused_negotiate[{kind}, k={k}]",
                overlay_kernel.negotiate_plain,
                overlay_kernel.fused_negotiate,
                lambda: [fr0.clone(), cnt0.clone()],
                lambda fn, st: fn(*st, src, has, draw, kind=kind,  # noqa
                                  limit=limit)[2:],  # noqa: B023
                lambda st: (st[0].copy_(fr0), st[1].copy_(cnt0)), reps)
            say(f"fused_negotiate[{kind}, k={k}]: bit-exact on {n} rows "
                f"({int((out[2] >= 0).sum())} replies); kernel {t_k:.4f} "
                f"ms, plain {t_p:.4f} ms")
            del out
        del fr0, cnt0, pick, src, has
    m, b, nn = 131_072, 10, FULL_N
    # erdos1m_wide's own batch: -graph erdos -n 1e6 -er-p 1.2e-5 -protocol
    # sir (lam 12: 37 friend columns, 38 lanes a sender, Poisson counts).
    wcfg, _ = parse_cli(["-graph", "erdos", "-n", str(ERDOS_WIDE_N),
                         "-er-p", "1.2e-5", "-protocol", "sir"])
    wn, wk, wb, wdw, wcap, wm, wlen = emit_shapes(wcfg, wcfg.graph_width)
    emit_rows = {}
    for name, k, dw, sir, cnt_lo, lam, shape in (
            ("dw40", 6, 40, False, None, None, None),
            ("kw33", 32, 3, True, None, None, None),
            ("kw112", 111, 3, True, 30, None, None),
            ("erdos1m_wide", wk, wdw, True, None, 12.0,
             (wn, wm, wb, wcap, wlen))):
        cap = 3_000_000
        cn, cm, cb, ccap, clen = shape or (nn, m, b, cap,
                                           dw * cap + m * (k + 1))
        case, kw = emit_case(gen, dev, cn, cm, k, dw, ccap, cb, clen,
                             dup=False, sir=sir, base_hi=ccap // 2,
                             cnt_lo=cnt_lo, lam=lam)
        ring0 = case.pop("mail_ids")
        args = [case[x] for x in ("mail_cnt", "sf", "drop", "svalid",
                                  "wslot", "off")]
        out, _, t_k, t_p = check_and_time(
            f"fused_emit[{name}]", megakernel.emit_plain,
            megakernel.fused_emit, lambda: [ring0.clone()],
            lambda fn, st: fn(st[0], *args, **kw)[1:],  # noqa: B023
            lambda st: None, reps)
        written = int(out[1].sum())
        emit_forms(name, ring0, args, kw)
        bnd, by = bound_ms(*emit_bytes(cm, k, k + (1 if sir else 0), False,
                                       sir))
        say(f"fused_emit[{name}]: bit-exact (m {cm}, k {k}, dw {dw}, "
            f"{'SIR' if sir else 'SI'}, {written} entries written); "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms "
            f"({by})")
        if name in ("kw112", "erdos1m_wide"):
            emit_rows.update({f"{name}_ms": t_k, f"{name}_plain_ms": t_p,
                              f"{name}_bound_ms": bnd,
                              f"{name}_bound_by": by})
        del out, case, args, ring0
    dw, cap, m = 40, 2_000_000, 262_144
    rings0 = [ri(0, 2**30, (dw * cap + 1,)) for _ in range(2)]
    cnt0 = ri(0, cap // 2, (1, dw))
    pays = (ri(0, nn, (m,)), ri(0, 2**30, (m,)))
    wslot = ri(0, dw, (m,))
    valid = torch.rand(m, generator=gen, device=dev) < 0.9
    out, _, t_k, t_p = check_and_time(
        "fused_ring_append[dw40]", deliver.ring_append_plain,
        deliver.fused_ring_append,
        lambda: [r.clone() for r in rings0] + [
            cnt0.clone(), torch.zeros((), dtype=torch.int32, device=dev)],
        lambda fn, st: fn(st[:2], st[2], st[3], pays, wslot, valid, dw,
                          cap) and None,
        lambda st: (st[2].copy_(cnt0), st[3].zero_()), reps)
    say(f"fused_ring_append[dw40]: bit-exact over {m} lanes (cap {cap}); "
        f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    del out, rings0
    torch.cuda.empty_cache()
    return emit_rows


KOUT_N = 100_000_000  # headline_jax: 1e8 nodes, fanout 3
ERDOS_N = 10_000_000  # sir_10m_erdos: 1e7 nodes, lam = fanout 8
ERDOS_WIDE_N = 1_000_000  # lam = 60: cap 111, the JAX kernel's lam limit
PLAIN_ROWS = {"kout": 10_000_000, "erdos": 1_000_000}  # plain row blocks
# Rows of graphs.erdos's 1e6-row table where the card parts from the CPU:
# 0, as the Poisson sampler's XLA float32 log and lgamma are IEEE torch
# operations on both (utils/rng.py, ROADMAP C5).
ERDOS_CARD_CPU_PARTED = 0


def _ops(**counts) -> tuple[float, float]:
    """(all, ALU-only) instructions of the given number of pieces of each
    kind (threefry blocks, remainders)."""
    kinds = {"threefry": THREEFRY_OPS, "urem": UREM32_OPS}
    return (sum(kinds[k][0] * c for k, c in counts.items()),
            sum(kinds[k][1] * c for k, c in counts.items()))


def kout_ops(rows: int, k: int) -> tuple[float, float]:
    """(all, ALU-only) instructions kout_pallas needs in the default
    (partitionable) layout: a row derives its key and splits it (three
    threefry blocks); a cell draws two blocks, takes three remainders by
    n, and folds, patches and stores (~6 more, 2 of them on the ALU)."""
    cells = rows * k
    a, u = _ops(threefry=3 * rows + 2 * cells, urem=3 * cells)
    return a + 6 * cells, u + 2 * cells


def erdos_ops(rows: int, cap: int, live: int) -> tuple[float, float]:
    """(all, ALU-only) instructions erdos_pallas needs in the default
    layout: once, the stream key (one threefry block); a row derives its
    key and draws word 0 (two blocks), converts it (~3) and finds its
    degree in the nondecreasing cdf table (a compare, a select and two
    adds a step of a binary search: 4 * ceil(log2(cap + 1))); a cell is
    stored (~1); a live cell draws one block, takes a remainder by n and
    patches (~3 more, 2 on the ALU)."""
    a, u = _ops(threefry=1 + 2 * rows + live, urem=live)
    steps = max(1, math.ceil(math.log2(cap + 1)))
    return (a + rows * (3 + 4 * steps) + rows * cap + 3 * live,
            u + 2 * live)


def erdos_host(label, n, lam, key) -> None:
    """The host time to enqueue one erdos_pallas call of all n rows, and
    its parts: the two outputs' torch.empty, the cdf table's lookup (built
    once per lam) and the ctypes call (no device-to-host read)."""
    from gossip_simulator_tpu_torch.config import er_cap
    from gossip_simulator_tpu_torch.ops import deliver, graph

    dev = key.device
    cap = er_cap(lam)
    f = torch.empty((n, cap), dtype=torch.int32, device=dev)
    d = torch.empty(n, dtype=torch.int32, device=dev)
    fn = graph._erdos_fn()
    head = (f.data_ptr(), d.data_ptr(), key.data_ptr(),
            graph.erdos_cdf_param(lam, cap), n, cap, 0, n,
            int(graph._rng.partitionable()), deliver._stream(dev.index))
    host_split(label, {
        "wrapper": lambda: graph.erdos_pallas(n, lam, 0, n, key),
        "outputs": lambda: (torch.empty((n, cap), dtype=torch.int32,
                                        device=dev),
                            torch.empty(n, dtype=torch.int32, device=dev)),
        "cdf table": lambda: graph.erdos_cdf_param(lam, cap),
        "ctypes call": lambda: fn(*head)})
    del f, d


def _blocks(n: int, step: int):
    return [(r0, min(step, n - r0)) for r0 in range(0, n, step)]


def graph_parity(dev) -> dict:
    """kout_pallas at headline_jax's 1e8 rows x 3 and erdos_pallas at
    sir_10m_erdos's 1e7 rows (lam 8, cap 29) and 1e6 rows at lam 60 (cap
    111): each bit-exact to its plain version, which runs in row blocks
    (its int64 threefry chain would not fit in one).  Kernel ms are
    medians of 5 CUDA-event timings, plain ms of 2 over all the blocks;
    no PyTorch call draws the same stream (library_ms null)."""
    from gossip_simulator_tpu_torch.config import Config, er_cap
    from gossip_simulator_tpu_torch.models import graphs
    from gossip_simulator_tpu_torch.ops import graph

    key = graphs.graph_key(Config(seed=0), dev)
    rows = {}
    n, k = KOUT_N, 3
    got = graph.kout_pallas(n, k, 0, n, key)
    err = 0
    for r0, nr in _blocks(n, PLAIN_ROWS["kout"]):
        err = max(err, max_err([graph.kout_plain(n, k, r0, nr, key)],
                               [got[r0:r0 + nr]]))
    del got
    if err:
        fail(f"kout_pallas differs from its plain version (max err {err})")
    t_k = time_ms(lambda: graph.kout_pallas(n, k, 0, n, key), 5)
    device_split("kout_pallas", lambda: graph.kout_pallas(n, k, 0, n, key))
    t_p = time_ms(lambda: [graph.kout_plain(n, k, r0, nr, key)
                           for r0, nr in _blocks(n, PLAIN_ROWS["kout"])], 2)
    bnd, by = bound_ms(n * k * 4, *kout_ops(n, k))
    say(f"kout_pallas: bit-exact over {n} x {k} (row blocks of "
        f"{PLAIN_ROWS['kout']}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"bound {bnd:.5f} ms ({by})")
    rows["kout_pallas"] = dict(
        route="cuda", source="gossip_simulator_tpu_torch/csrc/kout_pallas.cu",
        replaces="gossip_simulator_tpu/ops/pallas_graph.py:182",
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by,
        library_ms=None)
    torch.cuda.empty_cache()
    er = None
    for name, n, lam in (("lam8", ERDOS_N, 8.0),
                         ("lam60", ERDOS_WIDE_N, 60.0)):
        cap = er_cap(lam)
        step = max(PLAIN_ROWS["erdos"] * 29 // cap, 1)
        gf, gd = graph.erdos_pallas(n, lam, 0, n, key)
        err = 0
        for r0, nr in _blocks(n, step):
            wf, wd = graph.erdos_plain(n, lam, r0, nr, key)
            err = max(err, max_err([wf, wd], [gf[r0:r0 + nr],
                                              gd[r0:r0 + nr]]))
        live = int(gd.sum())
        del gf, gd
        if err:
            fail(f"erdos_pallas[{name}] differs from its plain version "
                 f"(max err {err})")
        t_k = time_ms(lambda: graph.erdos_pallas(n, lam, 0, n, key),  # noqa
                      5)
        device_split(f"erdos_pallas[{name}]",
                     lambda: graph.erdos_pallas(n, lam, 0, n, key))  # noqa
        t_p = time_ms(lambda: [graph.erdos_plain(n, lam, r0, nr, key)  # noqa
                               for r0, nr in _blocks(n, step)], 2)  # noqa
        erdos_host(f"erdos_pallas[{name}]", n, lam, key)
        bnd, by = bound_ms(n * (cap + 1) * 4, *erdos_ops(n, cap, live))
        say(f"erdos_pallas[{name}]: bit-exact over {n} rows x cap {cap} "
            f"({live} live cells, row blocks of {step}); kernel {t_k:.4f} "
            f"ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        cols = dict(ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by)
        if er is None:
            er = dict(route="cuda",
                      source="gossip_simulator_tpu_torch/csrc/"
                             "erdos_pallas.cu",
                      replaces="gossip_simulator_tpu/ops/pallas_graph.py:141",
                      max_abs_err=err, library_ms=None, **cols)
        else:
            er.update({f"{name}_{c}": v for c, v in cols.items()},
                      **{f"{name}_max_abs_err": err})
        torch.cuda.empty_cache()
    rows["erdos_pallas"] = er
    return rows


# --- phases 4-5: the port's main path ----------------------------------------


def _mass_totals(state, cfg) -> list:
    """PushSum's Sigma x and Sigma w over one state or a list of shards."""
    from gossip_simulator_tpu_torch.models import pushsum

    shards = state if isinstance(state, list) else [state]
    per = [pushsum.conserved_totals(st, cfg) for st in shards]
    return [sum(col) for col in zip(*per)]


# Called with the stepper right after each phase-2 restore of run_port's
# runs (the checkpoint phase reads the restored state there).
LOAD_HOOKS: list = []


def run_port(argv, device, keep_friends: bool = False, shards=None):
    """One run through the user entry points (the JSONL log, when the argv
    asks for one, written as the CLI writes it); returns (transcript,
    RunResult, stepper, wall seconds).  With `shards`, the sharded backend
    lays that many shards out on the one device (``ShardedStepper(cfg,
    n_devices=shards)``).  The stepper also records the wall seconds of
    phase 1 (`phase1_s`, to quiescence on either phase-1 path), the rounds
    overlay's largest live spill after any round (`spill_peak`, pairs of
    both types) and, with `keep_friends`, the friends table at the end of
    phase 1 on the host (`friends_p1`)."""
    from gossip_simulator_tpu_torch import run_simulation
    from gossip_simulator_tpu_torch.backends import (ShardedStepper,
                                                     TorchStepper)
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.models.state import OverlayState
    from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter

    class Timed(TorchStepper if shards is None else ShardedStepper):
        spill_peak = 0

        def seed(self):
            super().seed()
            if self.cfg.model == "pushsum":
                # Sigma x, Sigma w before the first window (ring empty).
                self.initial_totals = _mass_totals(self.state, self.cfg)

        def _round(self, box, base_key):
            # Every window or round of phase 1, on either path.
            st = super()._round(box, base_key)
            if isinstance(st, OverlayState):
                live = int((st.mk_spill[1] >= 0).sum()
                           + (st.bk_spill[1] >= 0).sum())
                self.spill_peak = max(self.spill_peak, live)
            return st

        def _quiesced(self):
            if not hasattr(self, "phase1_s"):
                if device == "cuda":
                    torch.cuda.synchronize()
                self.phase1_s = time.perf_counter() - t0
                if keep_friends:
                    self.friends_p1 = self.state.friends.cpu()

        def overlay_window(self):
            out = super().overlay_window()
            if out[2]:
                self._quiesced()
            return out

        def overlay_run_to_quiescence(self, *args, **kw):
            out = super().overlay_run_to_quiescence(*args, **kw)
            if out[1]:
                self._quiesced()
            return out

        def load_state_pytree(self, tree):
            super().load_state_pytree(tree)
            for hook in LOAD_HOOKS:
                hook(self)

    cfg, _ = parse_cli(argv)
    out = io.StringIO()
    stepper = (Timed(cfg, device=device) if shards is None
               else Timed(cfg, n_devices=shards, device=device))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ProgressPrinter(cfg.progress, out=out,
                         jsonl_path=cfg.log_jsonl_resolved or None) as pr:
        res = run_simulation(cfg, printer=pr, stepper=stepper)
    if device == "cuda":
        torch.cuda.synchronize()
    return out.getvalue(), res, stepper, time.perf_counter() - t0


@contextlib.contextmanager
def lowered(*patches):
    """Set (module, name, value) constants for the duration of a block."""
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, value in patches:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in old:
            setattr(mod, name, value)


WORKERS = 6  # processes for the twins' runs and the CPU's erdos rows


@contextlib.contextmanager
def worker_pool():
    """Worker processes (spawned: this process holds the card) that run the
    twins' runs, on the card and on the CPU, and the CPU's erdos rows;
    all of them end with the block."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        try:
            yield pool
        except BaseException:
            pool.shutdown(wait=True, cancel_futures=True)
            raise


def _twin_side(argv, patches, shards, device):
    """One side of a twin, in a worker process, every launch count set to 0
    before it: (transcript, RunResult, final state leaves, wall s,
    launches).  `patches` name their modules."""
    import importlib

    from gossip_simulator_tpu_torch.ops import _build

    torch.set_num_threads(1)
    with lowered(*[(importlib.import_module(m), k, v)
                   for m, k, v in patches]):
        _build.reset_launches()
        out, res, st, wall = run_port(argv, device, shards=shards)
        launches = dict(_build.LAUNCHES)
    return out, res, st.state_pytree(), wall, launches


def submit_twins(pool, cases, shards=None) -> list:
    """Submit both sides of each (name, argv, patches, check) case to the
    worker pool; returns their (card, cpu) futures."""
    return [[pool.submit(_twin_side, argv,
                         [(m.__name__, k, v) for m, k, v in patches],
                         shards, device) for device in ("cuda", "cpu")]
            for _, argv, patches, _ in cases]


def check_twins(cases, runs) -> None:
    """Wait for each case's two sides (submit_twins); fail unless the
    transcripts and final state leaves agree, then call check(launches,
    RunResult) on the card run, which fails on what it does not
    accept."""
    import numpy as np

    for (name, argv, patches, check), (card, cpu) in zip(cases, runs):
        out_g, res_g, tg, wall_g, launches = card.result()
        out_c, _, tc, wall_c, _ = cpu.result()
        if out_g != out_c:
            fail(f"{name}: cuda and cpu transcripts differ:\n{out_g}\n"
                 f"---\n{out_c}")
        bad = [key for key in tc if not np.array_equal(tg[key], tc[key])]
        if bad or set(tg) != set(tc):
            fail(f"{name}: final state leaves differ: {bad}")
        check(launches, res_g)
        say(f"{name}: cuda == cpu (transcript, {len(tc)} leaves); "
            f"{res_g.stats.total_message} messages, converged="
            f"{res_g.converged}, {res_g.overlay_windows} overlay "
            f"windows; cuda {wall_g:.2f} s, cpu {wall_c:.2f} s (in "
            f"workers); launches {launches}")


def run_twins(cases, shards=None):
    """Each (name, argv, patches, check) case on the card and on the CPU,
    both sides in the worker pool, the cases side by side (check_twins
    holds them)."""
    with worker_pool() as pool:
        check_twins(cases, submit_twins(pool, cases, shards))


def twin_cases(n: int) -> list:
    """Phase 4's cuda-vs-cpu twins at n: (name, argv, patches, check)."""
    from gossip_simulator_tpu_torch import config
    from gossip_simulator_tpu_torch.models import overlay

    kout = ["-graph", "kout", "-n", str(n), "-fanout", "6", "-seed", "1"]
    ovl = ["-n", str(n), "-seed", "1", *OVERLAY]
    rounds = ovl + ["-overlay-mode", "rounds"]
    cases = [("si", kout, ("fused_emit",), ()),
             ("si_crash0", kout + ["-crashrate", "0"], ("fused_emit",), ()),
             ("sir", kout + ["-protocol", "sir", "-removal-rate", "0.3",
                             "-droprate", "0.3"], ("fused_emit",), ()),
             ("xla", kout + ["-phase2-kernel", "xla"], ("fused_unique_set",),
              ()),
             ("overlay", ovl, PHASE1_KERNELS + ("fused_emit",), ()),
             ("overlay_xla", ovl + XLA_GATES, ("fused_emit",), ()),
             # The rounds overlay's three bands, lowered to n = TWIN_N.
             ("rounds", rounds, ROUNDS_KERNELS + ("fused_request_round",),
              ()),
             ("rounds_column_spill", rounds + [
                 "-mailbox-cap", "8", "-overlay-static-boot", "on"],
              ROUNDS_KERNELS + (SPILL,),
              ((overlay, "COLUMN_DELIVERY_MIN_ROWS", 0),)),
             ("rounds_split", rounds + ["-overlay-dead-skip", "off"],
              ROUNDS_KERNELS + (SPILL, "fused_hosted_chunk",
                                "fused_request_round"),
              ((overlay, "SPLIT_ROUND_MIN_ROWS", 0),
               (config, "MAILBOX_CAP_MEMORY_BAND", 1000)))]
    # The ring engine (fourth slice); pushpull and the all-xla rumor run
    # launch no kernel.
    ring = kout + ["-engine", "ring"]
    rumors = ring + ["-rumors", "16", "-crashrate", "0",
                     "-coverage-target", "0.95"]
    cases += [
        ("ring", ring, (DEPOSIT,), ()),
        ("ring_compact_off", ring + ["-compact", "off"], (DEPOSIT,), ()),
        ("ring_sir", ring + ["-protocol", "sir", "-removal-rate", "0.2"],
         (DEPOSIT,), ()),
        ("ring_rounds", kout + ["-time-mode", "rounds"], (DEPOSIT,), ()),
        ("ring_rounds_overlay", ovl + ["-time-mode", "rounds"],
         RING_ROUNDS_KERNELS, ()),
        ("pushpull", ["-protocol", "pushpull", "-graph", "kout", "-n",
                      str(n), "-fanout", "15", "-seed", "1"], (), ()),
        ("rumors", rumors, ("fused_deposit_both",), ()),
        ("rumors_p2_xla", rumors + ["-phase2-kernel", "xla"],
         (DEPOSIT, "fused_deposit_rows"), ()),
        ("rumors_xla", rumors + ALL_XLA, (), ())]
    # PushSum (fifth slice): the drain kernel, or (several drain chunks a
    # window) the chunked deposit, and the wide ring append.
    ps = pushsum_argv(n, seed=1)
    cases += [
        ("pushsum", ps, (DRAIN, "fused_ring_append"), ()),
        ("pushsum_p2_xla", ps + ["-phase2-kernel", "xla", "-event-chunk",
                                 "16384"],
         ("fused_deposit_rows", "fused_ring_append"), ()),
        ("pushsum_xla", ps + ALL_XLA, (), ())]
    # Static graph generation (sixth slice), and the widths past the
    # kernels' old limits (ROADMAP C1).
    erdos = ["-graph", "erdos", "-n", str(n), "-seed", "1"]
    cases += [
        ("erdos", erdos + ["-fanout", "8"], ("fused_emit",), ()),
        ("erdos_pallas", erdos + ["-fanout", "8", "-pallas"],
         ("fused_emit", "erdos_pallas"), ()),
        ("erdos_lam60_sir", erdos + ["-er-p", str(60 / n), "-protocol",
                                     "sir"], ("fused_emit",), ()),
        ("kout_pallas", kout + ["-pallas"], ("fused_emit", "kout_pallas"),
         ()),
        ("overlay_fanout20", ovl + ["-fanout", "20"],
         PHASE1_KERNELS + ("fused_emit",), ()),
        ("kout_delay1_40", kout + ["-delaylow", "1", "-delayhigh", "40"],
         ("fused_emit",), ()),
        ("kout_fanout32_sir", kout + ["-fanout", "32", "-protocol", "sir"],
         ("fused_emit",), ())]

    def checker(name, argv, kernels):
        def check(launches, res_g):
            twin = f"twin {name}"
            if any(launches[k] <= 0 for k in kernels):
                fail(f"{twin}: a kernel of {kernels} was never launched "
                     f"({launches})")
            if not kernels and any(gated(launches).values()):
                fail(f"{twin}: a path without kernels launched one "
                     f"({launches})")
            if ("kout" in argv and "pushpull" not in argv
                    and launches["kout_pallas"] <= 0):
                fail(f"{twin}: the kout table was not made by kout_pallas "
                     f"({launches})")
            if name == "pushsum_p2_xla" and launches[DRAIN]:
                fail(f"{twin}: -phase2-kernel xla launched {DRAIN}")
            if name == "overlay_xla" and any(launches[k]
                                             for k in PHASE1_KERNELS):
                fail(f"{twin}: the xla gates launched a phase-1 kernel "
                     f"({launches})")
            # With -overlay-dead-skip off every round counts its three
            # emission matrices (breakups, makeups, bootstrap requests).
            if (name == "rounds_split" and launches["fused_hosted_chunk"]
                    != 3 * res_g.overlay_windows):
                fail(f"{twin}: fused_hosted_chunk launched "
                     f"{launches['fused_hosted_chunk']} times in "
                     f"{res_g.overlay_windows} rounds, not three a round")
        return check

    return [(f"twin {name}", argv, patches, checker(name, argv, kernels))
            for name, argv, kernels, patches in cases]


def phase_twins(n: int) -> None:
    run_twins(twin_cases(n))


def _full_line(name, n, out, res, st, wall, counts) -> str:
    s = res.stats
    p1 = getattr(st, "phase1_s", 0.0)
    return (f"full {name}: n={n} overlay {res.overlay_windows} windows, "
            f"stabilized at {res.stabilize_ms:g} simulated ms; converged in "
            f"{res.gossip_windows} windows ({res.coverage_ms:g} simulated "
            f"ms); wall {wall:.3f} s (phase 1 {p1:.3f} s, phase 2 "
            f"{wall - p1:.3f} s); total_message {s.total_message}; "
            f"{s.total_message / wall:.4g} messages/s; total_received "
            f"{s.total_received}; crashed {s.total_crashed}; mailbox_dropped "
            f"{s.mailbox_dropped}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B; launches {counts}")


def full_run(name, n, argv, keep_friends=False, shards=None):
    """One full-size run through the user entry points (on `shards` shards
    of the card with the sharded backend) with every launch count set to
    0 just before it; fails unless it converged.  Returns (transcript,
    RunResult, stepper, launches, wall seconds)."""
    from gossip_simulator_tpu_torch.ops import _build

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out, res, st, wall = run_port(argv, "cuda", keep_friends, shards)
    counts = dict(_build.LAUNCHES)
    if not res.converged:
        fail(f"full {name}: did not converge:\n{out}")
    say(_full_line(name, n, out, res, st, wall, counts))
    return out, res, st, counts, wall


SPATIAL = ["-telemetry-spatial", "on"]  # the panels (slice 18)
SPATIAL_DIR = "smoke_runs/spatial"  # the spatial runs' dirs (git-ignored)


def spatial_argv(name: str) -> list:
    """-telemetry-spatial on, writing the run dir SPATIAL_DIR/name."""
    return SPATIAL + ["-run-dir", f"{SPATIAL_DIR}/{name}"]


def spatial_check(name: str, rdir: str) -> None:
    """The JAX package's panel identities (its tests/test_spatial.py) at
    every window of the spatial run written to `rdir`: the groups'
    received and removed sum to the history's received and removed
    columns, the shards' mail high-water maxes to mail_high, the traffic
    matrix's column sums are the shards' routed lanes received
    (exch_rcvd), the matrix never falls, and its total is theirs; then
    health.json's status and findings."""
    import numpy as np

    from gossip_simulator_tpu_torch.utils.artifact import load_run
    from gossip_simulator_tpu_torch.utils.telemetry import GCOL

    run = load_run(rdir)
    t = run["telemetry"]
    if "spatial_group" not in t or "health" not in run:
        fail(f"spatial {name}: no panels or no health.json in {rdir}")
    cols, grp, shd, tr = (t["gossip_cols"], t["spatial_group"],
                          t["spatial_shard"], t["spatial_traffic"])
    rcvd = shd[:, :, 4]
    checks = {
        "group received": (grp[:, :, 0].sum(axis=1)
                           == cols[:, GCOL["received"]]).all(),
        "group removed": (grp[:, :, 2].sum(axis=1)
                          == cols[:, GCOL["removed"]]).all(),
        "shard mail_high": (shd[:, :, 0].max(axis=1)
                            == cols[:, GCOL["mail_high"]]).all(),
        "traffic columns": (tr.sum(axis=1) == rcvd).all(),
        "traffic monotone": (np.diff(tr, axis=0) >= 0).all(),
        "traffic total": tr[-1].sum() == rcvd[-1].sum(),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad or grp.shape[0] != cols.shape[0]:
        fail(f"spatial {name}: {bad} fail over {cols.shape[0]} windows")
    h = run["health"]
    say(f"spatial {name}: {cols.shape[0]} windows, group {grp.shape[1:]}, "
        f"shard {shd.shape[1:]}, traffic {tr.shape[1:]} (total "
        f"{int(tr[-1].sum())} routed lanes, overflow "
        f"{int(shd[-1, :, 2].sum())}); identities hold ({', '.join(checks)})")
    say(f"health {name}: {h['status']}, checks {h['checks']}, findings "
        f"{[(f['check'], f['subject'], f['index']) for f in h['findings']]}")


def strip_notes(t: str) -> list:
    """A transcript without the gates' note lines, for comparing runs
    across gate settings."""
    return [x for x in t.splitlines() if not x.startswith("(phase")]


def gate_pair(name, n, argv, kernels, spatial=False
              ) -> tuple[dict, dict, float]:
    """`argv` under the default gates, then with every gate xla: both
    converge with identical transcripts, identical friends tables at the
    end of phase 1 and equal mailbox_dropped; the default run launches
    each of `kernels`, the xla run none.  With `spatial` the default run
    records the spatial panels (spatial_check holds them), so its
    transcript is also held to an unarmed run's.  Returns (default run's
    launches, xla run's launches, default run's wall seconds)."""
    out_d, res_d, st_d, counts_d, wall_d = full_run(
        name, n, argv + (spatial_argv(name) if spatial else []), True)
    if spatial:
        spatial_check(name, f"{SPATIAL_DIR}/{name}")
    friends_d = st_d.friends_p1
    del st_d
    out_x, res_x, st_x, counts_x, _ = full_run(
        f"{name}_xla", n, argv + XLA_GATES + ["-phase2-kernel", "xla"], True)
    for k in kernels:
        if counts_d[k] <= 0:
            fail(f"full {name}: {k} was never launched ({counts_d})")
    if any(gated(counts_x).values()):
        fail(f"full {name}_xla: the xla gates launched a kernel ({counts_x})")
    if strip_notes(out_d) != strip_notes(out_x):
        fail(f"full {name}: default and xla-gate transcripts differ")
    if not torch.equal(friends_d, st_x.friends_p1):
        fail(f"full {name}: default and xla-gate friends tables differ at "
             "the end of phase 1")
    if res_d.stats.mailbox_dropped != res_x.stats.mailbox_dropped:
        fail(f"full {name}: mailbox_dropped differs between the gate "
             "settings")
    say(f"full {name}: default and xla-gate transcripts and phase-1 "
        f"friends tables identical; mailbox_dropped "
        f"{res_d.stats.mailbox_dropped} in both")
    return counts_d, counts_x, wall_d


def phase_full(n: int) -> dict:
    """The first slice's kout run twice (the default gate: fused_emit's
    path; -phase2-kernel xla: fused_unique_set's), then the main path of
    the second slice -- the default run, tick-faithful overlay -- under
    the default gates and with every gate xla (no kernel at all).
    Returns the launches of each run by name."""
    kout = kout_argv(n)
    outs, runs = {}, {}
    for name, gate, kernel in (("kout", [], "fused_emit"),
                               ("kout_xla", ["-phase2-kernel", "xla"],
                                "fused_unique_set")):
        outs[name], res, st, runs[name], _ = full_run(name, n, kout + gate)
        del st  # its state would count in the next run's peak memory
        if res.stats.mailbox_dropped != 0:
            fail(f"full {name}: mailbox_dropped {res.stats.mailbox_dropped}")
        for k in (kernel, "kout_pallas"):
            if runs[name][k] <= 0:
                fail(f"full {name}: {k} was never launched ({runs[name]})")
    if strip_notes(outs["kout"]) != strip_notes(outs["kout_xla"]):
        fail("full: kout default-gate and -phase2-kernel xla transcripts "
             "differ")
    KOUT_RUNS["plain_out"] = outs["kout"]  # the telemetry phase's too
    say("full: kout default-gate and -phase2-kernel xla transcripts "
        "identical")
    base = ["-n", str(n), "-seed", "0", *OVERLAY]
    runs["default"], runs["default_xla"], _ = gate_pair(
        "default", n, base, PHASE1_KERNELS + ("fused_emit",))
    return runs


# --- phase 12: the run-to-target paths' records ------------------------------

TELEMETRY_N = 100_000  # the card-vs-cpu records' size
TELEMETRY_DIR = "smoke_runs/telemetry"  # the phase's run dirs (git-ignored)
# result.json's deterministic fields (scripts/compare_runs.py STAT_FIELDS).
RESULT_STATS = ("round", "coverage", "converged", "reason", "stabilize_ms",
                "coverage_ms", "overlay_windows", "gossip_windows",
                "total_received", "total_message", "total_crashed",
                "total_removed", "makeups", "breakups", "mailbox_dropped",
                "exchange_overflow", "scen_crashed", "scen_recovered",
                "part_dropped", "heal_repaired", "exhausted", "rumors",
                "rumors_done", "shed", "fingerprint", "fingerprint_windows",
                "converged_eps", "eps_ticks", "relerr_ppb")


def _cpu_run_dir(argv, rdir):
    """A worker's CPU run of `argv` through the CLI, writing `rdir`;
    returns (exit code, stdout, wall s)."""
    from gossip_simulator_tpu_torch.cli import main as cli_main

    torch.set_num_threads(1)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv + ["-device", "cpu", "-run-dir", rdir])
    return rc, out.getvalue(), time.perf_counter() - t0


def _stats_of(run) -> dict:
    return {k: run["result"].get(k) for k in RESULT_STATS}


def _telemetry_line(name, wall, run, smi) -> None:
    r = run["result"]
    say(f"telemetry {name}: wall {wall:.3f} s, phases_s "
        f"{json.dumps(r.get('phases_s'))}, fingerprint {r['fingerprint']} "
        f"({r['fingerprint_basis']}, {r['fingerprint_windows']} windows), "
        f"{r['total_message']} messages [{smi}]")


def phase_telemetry(n_full: int, n_small: int, ckpt_argv=()) -> dict:
    """The run-to-target paths' records: (a) the kout run at n_full (the
    jax_10m shape: kout_pallas, fused_emit) on the run-to-target path
    with -run-dir, -trace and -telemetry-summary, on its windowed twin
    (-telemetry off, progress on) and with no recording flag: the first's
    transcript is the third's (its summary block aside), the first two
    give one fingerprint and one result.json Stats; (b) the default run
    and PushSum on kout at n_small on the card, the same argv on the CPU
    in worker processes: the same telemetry.npz arrays and fingerprints.
    Every run prints its wall and phases_s beside the card.  Returns the
    launches of each card run by name.  The windowed twin also takes
    `ckpt_argv` (the checkpoint phase's case (a)); its transcript, Stats
    and wall go into KOUT_RUNS, with the run-to-target run's."""
    import os
    import shutil

    import numpy as np

    from gossip_simulator_tpu_torch.utils.artifact import load_run

    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    os.makedirs(TELEMETRY_DIR)
    if ckpt_argv:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    smi = smi_line()
    small = {"default": ["-n", str(n_small), "-seed", "0", *OVERLAY,
                         *SPATIAL],
             "pushsum": pushsum_argv(n_small) + SPATIAL}
    runs = {}
    with worker_pool() as pool:
        cpu = {name: pool.submit(_cpu_run_dir, argv,
                                 f"{TELEMETRY_DIR}/{name}_cpu")
               for name, argv in small.items()}
        kout = kout_argv(n_full)
        fast_dir, win_dir = (f"{TELEMETRY_DIR}/kout_fast",
                             f"{TELEMETRY_DIR}/kout_windowed")
        out_f, res_f, _, runs["telemetry_kout"], wall_f = full_run(
            "telemetry_kout", n_full,
            kout + ["-run-dir", fast_dir, "-trace", f"{fast_dir}/trace.json",
                    "-telemetry-summary", *SPATIAL])
        out_w, res_w, _, runs["telemetry_kout_windowed"], wall_w = full_run(
            "telemetry_kout_windowed", n_full,
            kout + ["-telemetry", "off", "-run-dir", win_dir, *ckpt_argv])
        # The unflagged run's transcript: the full phase's kout run, the
        # same argv, when that phase ran.
        out_p = KOUT_RUNS.get("plain_out")
        if out_p is None:
            out_p, _, _, runs["telemetry_kout_plain"], wall_p = full_run(
                "telemetry_kout_plain", n_full, kout)
        fast, win = load_run(fast_dir), load_run(win_dir)
        KOUT_RUNS.update(
            windowed=dict(out=out_w, stats=res_w.stats.to_dict(),
                          wall=wall_w, run=win, trace=f"{win_dir}/trace.json"),
            fast=dict(stats=res_f.stats.to_dict(), run=fast), plain_out=out_p)
        _telemetry_line("kout_fast", wall_f, fast, smi)
        _telemetry_line("kout_windowed", wall_w, win, smi)
        if "telemetry_kout_plain" in runs:
            say(f"telemetry kout_plain: wall {wall_p:.3f} s [{smi}]")
        body, sep, block = out_f.partition("\n\n=== Telemetry ===\n")
        if not sep or body + "\n" != out_p:
            fail("telemetry: the recorded run's transcript is not the "
                 "unrecorded run's")
        say(f"telemetry kout_fast summary: {block.strip()!r}")
        if (fast["result"]["fingerprint_basis"],
                win["result"]["fingerprint_basis"]) != ("telemetry",
                                                        "windows"):
            fail("telemetry: the fingerprint bases are not telemetry and "
                 "windows")
        if _stats_of(fast) != _stats_of(win):
            fail(f"telemetry: the run-to-target and windowed runs differ: "
                 f"{_stats_of(fast)} vs {_stats_of(win)}")
        with open(f"{fast_dir}/trace.json") as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]}
        if not {"init", "phase2.run_to_target",
                "phase2.compile+run"} <= spans:
            fail(f"telemetry: the trace lacks a span ({sorted(spans)})")
        for k in ("kout_pallas", "fused_emit"):
            if runs["telemetry_kout"][k] <= 0:
                fail(f"telemetry: {k} was never launched "
                     f"({runs['telemetry_kout']})")
        say("telemetry kout: recorded transcript (spatial panels armed) == "
            "plain transcript, run-to-target fingerprint == windowed "
            f"fingerprint {fast['result']['fingerprint']}, result.json "
            "Stats equal")
        spatial_check("telemetry_kout", fast_dir)
        for name, argv in small.items():
            rdir = f"{TELEMETRY_DIR}/{name}_card"
            _, _, _, runs[f"telemetry_{name}"], wall = full_run(
                f"telemetry_{name}", n_small, argv + ["-run-dir", rdir])
            card = load_run(rdir)
            _telemetry_line(f"{name}_card", wall, card, smi)
            rc, _, cwall = cpu[name].result()
            host = load_run(f"{TELEMETRY_DIR}/{name}_cpu")
            _telemetry_line(f"{name}_cpu", cwall, host, "cpu, a worker")
            tc, th = card["telemetry"], host["telemetry"]
            bad = [k for k in th if k not in tc
                   or not np.array_equal(tc[k], th[k])]
            if "spatial_traffic" not in th or card.get("health") != \
                    host.get("health"):
                bad.append("the panels or health.json")
            if bad or set(tc) != set(th) or rc != 0:
                fail(f"telemetry {name}: card and cpu telemetry.npz differ "
                     f"({bad}, rc {rc})")
            if card["result"]["fingerprint"] != host["result"]["fingerprint"]:
                fail(f"telemetry {name}: card and cpu fingerprints differ")
            say(f"telemetry {name}: card == cpu (telemetry.npz "
                f"{sorted(th)}, fingerprint "
                f"{card['result']['fingerprint']})")
    return runs


# --- phase 13: checkpoints, -resume and shutdown -----------------------------

CKPT_DIR = "smoke_runs/checkpoint"  # the phase's snapshots (git-ignored)
# Phase-1 snapshots are taken at 1e6: at 1e7 the ticks overlay's ring alone
# is 3 windows of 1e8 slots.
CKPT_P1_N = 1_000_000
# Case (a): the kout run's windowed twin saves at windows 6 and 12 and
# keeps both.
CKPT_A = ["-checkpoint-every", "6", "-ckpt-keep", "2", "-checkpoint-dir",
          f"{CKPT_DIR}/kout"]
# The telemetry phase's kout runs (filled there, or by the checkpoint
# phase alone): the windowed twin with CKPT_A, the run-to-target run and
# the unflagged run's transcript.
KOUT_RUNS: dict = {}


def _npz_bytes(d: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.endswith(".npz"))


def _io_spans(trace: str) -> str:
    """The checkpoint.save and checkpoint.load spans of a -trace file:
    their count and seconds."""
    with open(trace) as f:
        evs = json.load(f)["traceEvents"]
    out = []
    for name in ("checkpoint.save", "checkpoint.load"):
        durs = [e["dur"] / 1e6 for e in evs if e["name"] == name]
        out.append(f"{name} {len(durs)} x "
                   f"{'/'.join(f'{d:.3f}' for d in durs) or '-'} s")
    return ", ".join(out)


def _entry_keys(stepper) -> "np.ndarray":
    """The sorted in-flight entries of a restored SI ring, one state or S
    shards, each decoded to (global destination, slot, tick offset) and
    packed into one int64 (tests/torch_ckpt.decode_entries), on the card."""
    from gossip_simulator_tpu_torch.models import event

    cfg = stepper.cfg
    states = stepper.state if isinstance(stepper.state, list) else [
        stepper.state]
    b, dw = event.batch_ticks(cfg), event.ring_windows(cfg)
    n_local = cfg.n // len(states)
    parts = []
    for sh, st in enumerate(states):
        cap = st.geom[0]
        for slot, c in enumerate(st.mail_cnt.reshape(-1).tolist()):
            e = st.mail_ids[slot * cap:slot * cap + c].to(torch.int64)
            parts.append(((e // b + sh * n_local) * dw + slot) * b + e % b)
    return torch.sort(torch.cat(parts)).values.cpu().numpy()


def _kout_alone(n: int) -> dict:
    """Case (a) without the telemetry phase: the kout run's windowed twin
    with CKPT_A, the run-to-target run and the unflagged one."""
    import shutil

    from gossip_simulator_tpu_torch.utils.artifact import load_run

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    kout = kout_argv(n)
    runs = {}
    win_dir, fast_dir = f"{CKPT_DIR}/a_windowed", f"{CKPT_DIR}/a_fast"
    out_w, res_w, _, runs["ckpt_kout_windowed"], wall_w = full_run(
        "ckpt_kout_windowed", n,
        kout + ["-telemetry", "off", "-run-dir", win_dir, *CKPT_A])
    _, res_f, _, runs["ckpt_kout_fast"], _ = full_run(
        "ckpt_kout_fast", n, kout + ["-run-dir", fast_dir])
    out_p, _, _, runs["ckpt_kout_plain"], _ = full_run(
        "ckpt_kout_plain", n, kout)
    KOUT_RUNS.update(
        windowed=dict(out=out_w, stats=res_w.stats.to_dict(), wall=wall_w,
                      run=load_run(win_dir), trace=f"{win_dir}/trace.json"),
        fast=dict(stats=res_f.stats.to_dict(), run=load_run(fast_dir)),
        plain_out=out_p)
    return runs


def _broadcast_lines(out: str, skip: int = 0) -> list:
    """The transcript's lines after its broadcast section header, the
    first `skip` coverage lines left out."""
    lines = out.split("=== Broadcast one message ===\n", 1)[1].splitlines()
    return lines[skip:]


class _SigtermChild:
    """A CLI process run in a thread: SIGTERM after its first coverage
    line, then its rest read to the end.  `result` gets the lines, the
    exit code and the perf_counter times of the launch, the signal and
    the exit."""

    def __init__(self, cmd: list):
        import threading

        self.cmd, self.proc, self.result = cmd, None, {}
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def _run(self) -> None:
        import signal

        r = self.result
        r["t0"] = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     text=True)
        lines = r["lines"] = []
        for line in self.proc.stdout:
            lines.append(line)
            if "% covered" in line:
                r["t_sig"] = time.perf_counter()
                self.proc.send_signal(signal.SIGTERM)
                break
        lines.append(self.proc.stdout.read())
        r["rc"] = self.proc.wait()
        r["t_end"] = time.perf_counter()


def _resume_cases(n: int, kout: list, a: dict, smi: str) -> dict:
    """Cases (b) and (c) of the checkpoint phase: -resume from (a)'s
    window-6 snapshot at the default geometry (Stats and windows 7-17 ==
    (a)'s), at -event-chunk 262144 (a repack keeping every in-flight
    entry), and onto 8 shards (every entry kept, fused_recv_land
    launched).  Returns the launches of each run by name."""
    import os
    import shutil

    import numpy as np

    runs = {}
    r6 = f"{CKPT_DIR}/resume6"
    shutil.rmtree(r6, ignore_errors=True)
    os.makedirs(r6)
    for x in ("", ".json"):
        shutil.copyfile(f"{CKPT_DIR}/kout/state_00000006.npz{x}",
                        f"{r6}/state_00000006.npz{x}")
    with open(f"{r6}/state_00000006.npz.json") as f:
        meta6 = json.load(f)
    snap6 = _npz_bytes(r6)
    seen = {}

    def restored(st):
        seen.update(stats=st.stats(), geom=tuple(st.state.geom)
                    if not isinstance(st.state, list) else None,
                    keys=_entry_keys(st))

    LOAD_HOOKS.append(restored)
    try:
        for name, extra in (("ckpt_resume6", []),
                            ("ckpt_resume6_chunk262144",
                             ["-event-chunk", "262144"])):
            trace = f"{CKPT_DIR}/{name}.trace.json"
            out, res, _, runs[name], wall = full_run(
                name, n, kout + extra + ["-resume", "-checkpoint-dir", r6,
                                         "-trace", trace])
            head = "=== Resumed from state_00000006.npz (window 6) ==="
            if head not in out:
                fail(f"checkpoint {name}: no '{head}' line:\n{out}")
            if seen["stats"].mailbox_dropped != meta6["mailbox_dropped"]:
                fail(f"checkpoint {name}: mailbox_dropped "
                     f"{seen['stats'].mailbox_dropped} after the load, "
                     f"{meta6['mailbox_dropped']} in the snapshot")
            if not extra:
                keys1, geom1 = seen["keys"], seen["geom"]
                if res.stats.to_dict() != a["stats"]:
                    fail(f"checkpoint {name}: final Stats "
                         f"{res.stats.to_dict()} differ from (a)'s "
                         f"{a['stats']}")
                if _broadcast_lines(out) != _broadcast_lines(a["out"], 6):
                    fail(f"checkpoint {name}: windows 7-17 differ from "
                         "(a)'s")
                verdict = "Stats == (a), windows 7-17 == (a)"
            else:
                if seen["geom"] == geom1 or len(seen["keys"]) != len(keys1):
                    fail(f"checkpoint {name}: geometry {seen['geom']} vs "
                         f"{geom1}, {len(seen['keys'])} entries vs "
                         f"{len(keys1)}: no repack, or entries lost")
                verdict = (f"repacked {geom1} -> {seen['geom']} with all "
                           f"{len(keys1)} in-flight entries; Stats "
                           f"{res.stats.to_dict()} [(a): {a['stats']}]")
            say(f"checkpoint {name}: snapshot {snap6} B, "
                f"{_io_spans(trace)}, wall {wall:.3f} s, "
                f"{res.gossip_windows} windows, converged; {verdict} [{smi}]")

        # (c) the same snapshot onto 8 shards of the card
        name = "ckpt_reshard_s8"
        out, res, _, runs[name], wall = full_run(
            name, n, kout + ["-backend", "sharded", "-resume",
                             "-checkpoint-dir", r6, "-trace",
                             f"{CKPT_DIR}/{name}.trace.json"], shards=8)
        if not np.array_equal(seen["keys"], keys1):
            fail(f"checkpoint {name}: the in-flight entries differ after "
                 "the reshard")
        if runs[name].get(RECV, 0) <= 0:
            fail(f"checkpoint {name}: {RECV} was never launched "
                 f"({runs[name]})")
        say(f"checkpoint {name}: S 1 -> 8, all {len(keys1)} in-flight "
            "(destination, slot, offset) entries kept, converged, "
            f"{RECV} x {runs[name][RECV]}; "
            f"{_io_spans(f'{CKPT_DIR}/{name}.trace.json')}, wall "
            f"{wall:.3f} s, total_message {res.stats.total_message} [{smi}]")
    finally:
        LOAD_HOOKS.remove(restored)
    return runs


def phase_checkpoint(n: int, n_p1: int) -> dict:
    """Checkpoints, -resume and shutdown on the card (ROADMAP A7), at the
    kout run's size n (jax_10m: 17 windows) and the default run at n_p1:
    (a) the kout run's windowed twin with CKPT_A keeps exactly
    state_00000006 and state_00000012 (and sidecars), prints the
    unflagged run's transcript and ends on the run-to-target run's
    result.json Stats; (b) -resume from state_00000006 converges to (a)'s
    Stats with (a)'s lines for windows 7-17, and a second resume at
    -event-chunk 262144 (the ring's tail changes: a repack) converges with
    no entry lost; (c) the same snapshot resumes onto 8 shards of the
    card with every in-flight (destination, slot, offset) kept, converges
    and launches fused_recv_land; (d) the CLI in a subprocess, SIGTERM
    after its first coverage line: exit 2, reason interrupted, one
    snapshot marked interrupted, from which -resume converges to (a)'s
    Stats; (e) the default run at n_p1 with -checkpoint-every 10 (the CLI
    in a subprocess), its state_* deleted, resumes from its newest
    overlay_* to the same Stats and stabilize_ms, launching the three
    phase-1 kernels.  The two CLI processes run beside (b) and (c): their
    saves are host work, the card is shared.  Each line
    prints the snapshot bytes, the checkpoint.save and checkpoint.load
    spans and the wall beside the card.  Returns the launches of each
    run by name."""
    import os

    smi = smi_line()
    runs = {} if "windowed" in KOUT_RUNS else _kout_alone(n)
    kout = kout_argv(n)
    # (a) periodic snapshots, pruned to two
    a = KOUT_RUNS["windowed"]
    names = sorted(os.listdir(f"{CKPT_DIR}/kout"))
    want = [f"state_{w:08d}.npz{x}" for w in (6, 12) for x in ("", ".json")]
    if names != want:
        fail(f"checkpoint (a): {names} left after the prune, not {want}")
    if [x for x in a["out"].splitlines() if not x.startswith("(")] != [
            x for x in KOUT_RUNS["plain_out"].splitlines()
            if not x.startswith("(")]:
        fail("checkpoint (a): the checkpointing run's transcript is not the "
             "unflagged run's")
    if _stats_of(a["run"]) != _stats_of(KOUT_RUNS["fast"]["run"]):
        fail(f"checkpoint (a): result.json Stats differ from the "
             f"run-to-target run's: {_stats_of(a['run'])} vs "
             f"{_stats_of(KOUT_RUNS['fast']['run'])}")
    say(f"checkpoint kout_every6_keep2: n={n} {names[::2]} kept, "
        f"{_npz_bytes(f'{CKPT_DIR}/kout')} B on disk, "
        f"{_io_spans(a['trace'])}, wall {a['wall']:.3f} s; transcript == "
        f"unflagged, result.json Stats == run-to-target [{smi}]")

    # (d) and (e) start as CLI processes now and run beside (b) and (c):
    # their snapshots are host work (deflate), the card is shared.
    term, p1 = f"{CKPT_DIR}/term", f"{CKPT_DIR}/p1"
    cli = [sys.executable, "-u", "-m", "gossip_simulator_tpu_torch"]
    term_child = _SigtermChild(cli + kout + [
        "-checkpoint-every", "1000", "-checkpoint-dir", term])
    term_child.start()
    p1_argv = ["-n", str(n_p1), "-seed", "0", *OVERLAY]
    p1_log = open(f"{CKPT_DIR}/ckpt_p1.out", "w")
    p1_child = subprocess.Popen(
        cli + p1_argv + ["-checkpoint-every", "10", "-checkpoint-dir", p1,
                         "-trace", f"{CKPT_DIR}/ckpt_p1.trace.json",
                         "-log-jsonl", f"{CKPT_DIR}/ckpt_p1.jsonl"],
        stdout=p1_log, stderr=subprocess.STDOUT)
    try:
        runs.update(_resume_cases(n, kout, a, smi))
        runs.update(_child_cases(n, n_p1, kout, a, smi, term_child,
                                 p1_child, p1_argv))
    finally:
        for proc in (term_child.proc, p1_child):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        p1_log.close()
    return runs


def _child_cases(n, n_p1, kout, a, smi, term_child, p1_child,
                 p1_argv) -> dict:
    """Cases (d) and (e) of the checkpoint phase, once their CLI
    processes have ended: the SIGTERM'd run's exit, reason and final
    snapshot, and its -resume to (a)'s Stats; the phase-1 run's
    snapshots, its state_* deleted, and its -resume from the newest
    overlay_* to the same Stats and stabilize_ms.  Returns the launches
    of the two resumed runs by name."""
    import os

    runs = {}
    term, p1 = f"{CKPT_DIR}/term", f"{CKPT_DIR}/p1"
    # (d) the SIGTERM'd CLI: its final snapshot, then -resume
    term_child.join(timeout=900)
    t = term_child.result
    text = "".join(t.get("lines", []))
    last = [x for x in text.splitlines() if x.startswith("--- ")]
    snaps = [f for f in sorted(os.listdir(term)) if f.endswith(".npz")] \
        if os.path.isdir(term) else []
    meta = {}
    if len(snaps) == 1:
        with open(f"{term}/{snaps[0]}.json") as f:
            meta = json.load(f)
    if (t.get("t_sig") is None or t.get("rc") != 2 or not last
            or "(interrupted)" not in last[-1] or len(snaps) != 1
            or meta.get("interrupted") is not True):
        fail(f"checkpoint sigterm: rc {t.get('rc')}, snapshots {snaps}, "
             f"sidecar {meta}:\n{text}")
    say(f"checkpoint sigterm: exit {t['rc']} {t['t_end'] - t['t_sig']:.3f} "
        f"s after SIGTERM ({t['t_sig'] - t['t0']:.3f} s from launch to the "
        f"first coverage line), '{last[-1]}', {snaps[0]} "
        f"({_npz_bytes(term)} B, window {meta['window']}, interrupted) "
        f"[{smi}]")
    name = "ckpt_term_resume"
    out, res, _, runs[name], wall = full_run(
        name, n, kout + ["-resume", "-checkpoint-dir", term, "-trace",
                         f"{CKPT_DIR}/{name}.trace.json"])
    if res.stats.to_dict() != a["stats"]:
        fail(f"checkpoint {name}: final Stats {res.stats.to_dict()} differ "
             f"from (a)'s {a['stats']}")
    say(f"checkpoint {name}: converged, Stats == (a), "
        f"{_io_spans(f'{CKPT_DIR}/{name}.trace.json')}, wall {wall:.3f} s "
        f"[{smi}]")

    # (e) the CLI's phase-1 snapshots at n_p1 have been written: delete
    # its state_*, resume from its newest overlay_*
    rc_e = p1_child.wait(timeout=900)
    if rc_e != 0:
        with open(f"{CKPT_DIR}/ckpt_p1.out") as f:
            fail(f"checkpoint ckpt_p1: exit {rc_e}:\n{f.read()}")
    with open(f"{CKPT_DIR}/ckpt_p1.jsonl") as f:
        rec_e = [r for r in map(json.loads, f)
                 if r.get("event") == "result"][-1]
    p1_bytes = _npz_bytes(p1)
    for f in os.listdir(p1):
        if f.startswith("state_"):
            os.remove(f"{p1}/{f}")
    overlays = sorted(f for f in os.listdir(p1) if f.endswith(".npz"))
    if not overlays:
        fail("checkpoint ckpt_p1: no overlay_* snapshot was written")
    name = "ckpt_p1_resume"
    out, res, _, runs[name], wall = full_run(
        name, n_p1, p1_argv + ["-resume", "-checkpoint-dir", p1, "-trace",
                               f"{CKPT_DIR}/{name}.trace.json"])
    if f"(overlay window {int(overlays[-1][8:16])})" not in out:
        fail(f"checkpoint {name}: did not resume from {overlays[-1]}")
    got = res.stats.to_dict()
    if (got, res.stabilize_ms) != ({k: rec_e[k] for k in got},
                                   rec_e["stabilize_ms"]):
        fail(f"checkpoint {name}: Stats or stabilize_ms differ from the "
             f"checkpointed run's ({got}, {res.stabilize_ms} vs {rec_e})")
    for k in PHASE1_KERNELS:
        if runs[name].get(k, 0) <= 0:
            fail(f"checkpoint {name}: {k} was never launched ({runs[name]})")
    say(f"checkpoint ckpt_p1: n={n_p1} (the CLI) overlay snapshots "
        f"{overlays}, {p1_bytes} B with its state_* "
        f"({_io_spans(f'{CKPT_DIR}/ckpt_p1.trace.json')}), wall "
        f"{rec_e['wall_s']:.3f} s; {name} from {overlays[-1]}: Stats and "
        f"stabilize_ms ({res.stabilize_ms:g} ms) == the checkpointed run's, "
        f"{_io_spans(f'{CKPT_DIR}/{name}.trace.json')}, wall {wall:.3f} s "
        f"[{smi}]")
    return runs


def phase_rounds(n: int, n_split: int, twin_limit_s: float) -> dict:
    """The third slice's paths: the rounds overlay at n (-overlay-mode
    rounds: the column band, staggered bootstrap) under both gate
    settings, then the default run at n_split (two_phase_100m's bands,
    its n cut: the split round, static bootstrap, cap 8, burst spill).  The split run's xla
    twin runs at n_split when the default-gate run took under
    `twin_limit_s`, else the pair runs again at 40M (same bands).  Returns
    the launches of each run by name."""
    runs = {}
    rounds = ["-overlay-mode", "rounds", "-n", str(n), "-seed", "0",
              *OVERLAY]
    runs["rounds10m"], runs["rounds10m_xla"], _ = gate_pair(
        "rounds10m", n, rounds, ROUNDS_KERNELS + ("fused_request_round",))
    split = ["-n", str(n_split), "-seed", "0", *OVERLAY]
    big = f"default{size_tag(n_split)}"
    out, res, st, runs[big], wall = full_run(
        big, n_split, split, keep_friends=True)
    say(f"full {big}: {res.overlay_windows} rounds, stabilized at "
        f"{res.stabilize_ms:g} ms, mailbox_dropped "
        f"{res.stats.mailbox_dropped}, spill peak {st.spill_peak} pairs, "
        f"phase 1 {st.phase1_s:.3f} s, phase 2 {wall - st.phase1_s:.3f} s, "
        f"peak {torch.cuda.max_memory_allocated()} B")
    for k in ROUNDS_KERNELS + (SPILL, "fused_hosted_chunk"):
        if runs[big][k] <= 0:
            fail(f"full {big}: {k} was never launched ({runs[big]})")
    friends = st.friends_p1
    del st
    if wall < twin_limit_s:
        out_x, res_x, st_x, runs[f"{big}_xla"], _ = full_run(
            f"{big}_xla", n_split,
            split + XLA_GATES + ["-phase2-kernel", "xla"], keep_friends=True)
        if any(gated(runs[f"{big}_xla"]).values()):
            fail(f"full {big}_xla: the xla gates launched a kernel")
        if (strip_notes(out) != strip_notes(out_x)
                or not torch.equal(friends, st_x.friends_p1)
                or res.stats.mailbox_dropped != res_x.stats.mailbox_dropped):
            fail(f"full {big}: default and xla-gate runs differ")
        say(f"full {big}: default and xla-gate transcripts and phase-1 "
            "friends tables identical")
        del st_x
    else:
        say(f"full {big} took {wall:.1f} s >= {twin_limit_s:g} s: the "
            f"xla twin pair runs at n = {SPLIT_TWIN_N}")
        runs["default40m"], runs["default40m_xla"], _ = gate_pair(
            "default40m", SPLIT_TWIN_N,
            ["-n", str(SPLIT_TWIN_N), "-seed", "0", *OVERLAY],
            ROUNDS_KERNELS + (SPILL,))
    return runs


def phase_ring(n: int, n_rumor: int) -> dict:
    """The fourth slice's paths, the ring engine: -time-mode rounds on the
    rounds overlay and -engine ring on the kout graph (the jax_10m shape)
    at n, each under the default gates (fused_deposit_add) and with every
    gate xla; push-pull at n with fanout 23 (pushpull_10m_logn; it
    launches no kernel, so it runs once); and the multirumor_1m_r16 shape
    at n_rumor on the ring engine under the default gates
    (fused_deposit_both), -phase2-kernel xla (fused_deposit_add and
    fused_deposit_rows) and all-xla, which must give one transcript.
    Returns the launches of each run by name."""
    from gossip_simulator_tpu_torch.ops import deliver

    runs = {}
    dev = torch.device("cuda", 0)
    rounds = ["-time-mode", "rounds", "-n", str(n), "-seed", "0", *OVERLAY]
    lost0 = deliver.deposit_overflow(dev)
    runs["ring_rounds10m"], runs["ring_rounds10m_xla"], _ = gate_pair(
        "ring_rounds10m", n, rounds, RING_ROUNDS_KERNELS)
    # Lanes the dense form sent past a full bucket to global adds (the
    # xla twin launches no kernel): the bucket sizing on real traffic.
    DEPOSIT_OVERFLOW["ring_rounds10m"] = (deliver.deposit_overflow(dev)
                                          - lost0)
    kout = ["-engine", "ring", "-graph", "kout", "-fanout", "6", "-n",
            str(n), "-seed", "0"]
    runs["ring_kout10m"], runs["ring_kout10m_xla"], _ = gate_pair(
        "ring_kout10m", n, kout, (DEPOSIT,), spatial=True)
    # The rounds deposit (6 lanes a cell of its two-slot ring) takes the
    # dense form, the compacted ticks chunks the direct one.
    dense = {r: runs[r][DEPOSIT_DENSE] for r in ("ring_rounds10m",
                                                  "ring_kout10m")}
    if dense["ring_rounds10m"] <= 0 or dense["ring_kout10m"] != 0:
        fail(f"full ring: fused_deposit_add's dense form launches {dense}, "
             "expected the rounds run's deposits only")
    say(f"full ring: fused_deposit_add's dense form launched {dense}; "
        f"lanes past a full bucket {DEPOSIT_OVERFLOW}")
    pp = ["-protocol", "pushpull", "-graph", "kout", "-fanout", "23", "-n",
          str(n), "-seed", "0"]
    _, _, st, runs["pushpull10m"], _ = full_run("pushpull10m", n, pp)
    del st
    if any(runs["pushpull10m"].values()):
        fail(f"full pushpull10m launched a kernel ({runs['pushpull10m']})")
    rum = ["-engine", "ring", "-graph", "kout", "-fanout", "6", "-n",
           str(n_rumor), "-seed", "0", "-rumors", "16", "-crashrate", "0",
           "-coverage-target", "0.95"]
    outs = {}
    for name, gate, kernels in (
            ("rumors1m", [], ("fused_deposit_both",)),
            ("rumors1m_p2_xla", ["-phase2-kernel", "xla"],
             (DEPOSIT, "fused_deposit_rows")),
            ("rumors1m_xla", ALL_XLA, ())):
        outs[name], _, st, runs[name], _ = full_run(name, n_rumor, rum + gate)
        del st
        if any(runs[name][k] <= 0 for k in kernels) or (
                not kernels and any(gated(runs[name]).values())):
            fail(f"full {name}: launches {runs[name]}, expected {kernels}")
    if len({tuple(strip_notes(t)) for t in outs.values()}) != 1:
        fail("full rumors1m: the three gate settings' transcripts differ")
    say("full rumors1m: default, -phase2-kernel xla and all-xla transcripts "
        "identical")
    return runs


def _host_leaves(state) -> dict:
    """A state's leaves on the host (tensors copied off the card)."""
    import dataclasses

    return {f.name: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(state)
            for v in (getattr(state, f.name),)}


def phase_pushsum(n: int) -> dict:
    """The fifth slice's path, PushSum: pushsum10m under the default gates
    (fused_drain_sum, the wide fused_ring_append), -phase2-kernel xla
    (fused_deposit_rows and the wide append; no fused_drain_sum) and
    all-xla (no kernel).  The three must give one transcript, one
    report() dict and the same final state leaves, drop nothing, and end
    with the initial Sigma x and Sigma w.  Returns the launches of each
    run by name."""
    runs, first = {}, None
    for name, gate, launched, idle in (
            ("pushsum10m", [], (DRAIN, "fused_ring_append"),
             ("fused_deposit_rows",)),
            ("pushsum10m_p2_xla", ["-phase2-kernel", "xla"],
             ("fused_deposit_rows", "fused_ring_append"), (DRAIN,)),
            ("pushsum10m_xla", ALL_XLA, (), None)):
        spatial = spatial_argv(name) if name == "pushsum10m" else []
        out, res, st, runs[name], _ = full_run(
            name, n, pushsum_argv(n) + gate + spatial)
        if spatial:
            spatial_check(name, f"{SPATIAL_DIR}/{name}")
        counts = runs[name]
        if any(counts[k] <= 0 for k in launched) or (
                idle is None and any(gated(counts).values())) or (
                idle and any(counts[k] for k in idle)):
            fail(f"full {name}: launches {counts}, expected {launched}")
        if res.stats.mailbox_dropped != 0:
            fail(f"full {name}: mail_dropped {res.stats.mailbox_dropped}")
        totals = _mass_totals(st.state, st.cfg)
        if totals != st.initial_totals:
            fail(f"full {name}: mass not conserved: {totals} after, "
                 f"{st.initial_totals} before")
        # Every window appends its n * fanout lanes, the valid ones
        # counted in total_message: the wide append's valid share.
        lanes = res.gossip_windows * st.cfg.n * st.cfg.fanout
        say(f"full {name}: report {res.report}; mass conserved "
            f"(Sigma x, Sigma w = {totals}); valid lanes "
            f"{res.stats.total_message} of {lanes} "
            f"({res.stats.total_message / lanes:.6f})")
        leaves = _host_leaves(st.state)
        del st
        if first is None:
            first = (strip_notes(out), res.report, leaves)
            continue
        if strip_notes(out) != first[0] or res.report != first[1]:
            fail(f"full {name}: transcript or report differs from "
                 "pushsum10m's")
        bad = [k for k, v in leaves.items() if not (
            torch.equal(v, first[2][k]) if isinstance(v, torch.Tensor)
            else v == first[2][k])]
        if bad:
            fail(f"full {name}: final state leaves differ: {bad}")
        del leaves
    say("full pushsum10m: default, -phase2-kernel xla and all-xla "
        "transcripts, reports and final state leaves identical")
    return runs


# bench.py's CHURN_SCENARIO (the JAX package's coverage-under-churn
# acceptance timeline): 2 groups, 60 ms reboots, churn at 2.0 a simulated
# second over [0, 150), a 0.3 crash wave in group 1 at 30, a partition of
# the two groups over [20, 60).
CHURN = ('{"groups": 2, "downtime": 60, "events": ['
         '{"type": "churn", "start": 0, "end": 150, "rate": 2.0},'
         '{"type": "crash", "at": 30, "frac": 0.3, "group": 1},'
         '{"type": "partition", "start": 20, "end": 60}]}')
HEAL_ON = ["-overlay-heal", "on", "-coverage-target", "0.99",
           "-max-rounds", "2000"]
HEAL_OFF = ["-coverage-target", "0.99", "-max-rounds", "2000"]
# The twins' heal-on churn runs stop at 300 ms, not 600 or 2000 (they
# stall short of 0.99; the timeline's last reboot is at 210 ms; the
# script's time limit, PERF.md section 4).
TWIN_MAX = ["-max-rounds", "300"]
PMASK = "fused_emit:pmask"  # fused_emit's launches with a partition mask
# The JAX package's heal on/off acceptance pair runs at 1M (bench.py
# capture_churn_healing); at 1e7 the wave outlasts the churn and heal-off
# ends above 0.97 (PERF.md section 6, PR 13), so the pair and the gate
# twin run here, the full-size runs at FULL_N.
FAULT_PAIR_N = 1_000_000


def churn_argv(n: int, *extra) -> list:
    """The kout graph (fanout 6, crash rate 0, seed 0) under CHURN."""
    return ["-graph", "kout", "-n", str(n), "-fanout", "6", "-crashrate",
            "0", "-seed", "0", "-scenario", CHURN, *extra]


# The single-device runs of phase 9 that phase 11 holds its S = 8 runs to:
# name -> (transcript, RunResult).
FAULT_REFS: dict = {}


def fault_run(name, n, argv, shards=None):
    """One full-size fault-scenario run through the user entry points (on
    `shards` shards of the card with the sharded backend) with every
    launch count set to 0 just before it (converged or not); prints its
    wall, peak memory and counters.  Returns (transcript, RunResult,
    stepper, launches)."""
    from gossip_simulator_tpu_torch.ops import _build

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out, res, st, wall = run_port(argv, "cuda", shards=shards)
    counts = dict(_build.LAUNCHES)
    s = res.stats
    say(f"faults {name}: n={n} {res.gossip_windows} windows "
        f"({res.coverage_ms:g} simulated ms), coverage {s.coverage:.6f}, "
        f"converged={res.converged}; wall {wall:.3f} s; total_message "
        f"{s.total_message}; scen_crashed {s.scen_crashed}, scen_recovered "
        f"{s.scen_recovered}, part_dropped {s.part_dropped}, heal_repaired "
        f"{s.heal_repaired}, mailbox_dropped {s.mailbox_dropped}, "
        f"exchange_overflow {s.exchange_overflow}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches {counts}")
    return out, res, st, counts


def phase_faults(n: int, n_pair: int, twin_n: int) -> dict:
    """The thirteenth slice's path, fault scenarios and overlay healing:
    first cuda-vs-cpu twins at twin_n of the runs below; then, under
    CHURN: churn10m_heal at n (the event engine, -overlay-heal on, to 0.99
    or -max-rounds 250: scen_crashed >= 0.2 n, heal_repaired > 0,
    fused_emit with the partition mask and the heal's fused_ring_append
    launched) and churn10m_noheal at n (not converged, nothing
    repaired); at n_pair the JAX package's acceptance pair, churn1m_heal
    (with its -phase2-kernel xla -deliver-kernel xla twin: one
    transcript, one Stats, no kernel) and churn1m_noheal (not converged,
    coverage < 0.97, nothing repaired; heal on converges or ends above
    it); ring_churn10m_heal at n to -max-rounds 250 (-engine ring:
    fused_deposit_add) and
    pushsum_churn10m at n (-model pushsum, heal on: Sigma x and Sigma w,
    parked mass included, exactly the initial totals).  The twins run in
    the worker processes beside the full-size runs, whose walls are taken
    beside them.  Returns the launches of each full-size run by name."""
    ps = pushsum_argv(twin_n, seed=1) + ["-scenario", CHURN,
                                         "-overlay-heal", "on"]
    cases = [
        ("churn_heal", churn_argv(twin_n, *HEAL_ON, *TWIN_MAX),
         ("fused_emit", PMASK, "fused_ring_append")),
        ("churn_noheal", churn_argv(twin_n, *HEAL_OFF),
         ("fused_emit", PMASK)),
        ("ring_churn_heal", churn_argv(twin_n, "-engine", "ring",
                                       *HEAL_ON), (DEPOSIT,)),
        ("pushsum_churn", ps, (DRAIN, "fused_ring_append"))]

    def checker(name, kernels):
        def check(launches, res_g):
            if any(launches[k] <= 0 for k in kernels):
                fail(f"twin {name}: a kernel of {kernels} was never "
                     f"launched ({launches})")
            if res_g.stats.scen_crashed <= 0:
                fail(f"twin {name}: no scenario crash")
        return check

    twins = [(f"twin {name}", argv, (), checker(name, kernels))
             for name, argv, kernels in cases]
    with worker_pool() as pool:
        tw = submit_twins(pool, twins)
        runs = _fault_runs(n, n_pair)
        check_twins(twins, tw)
    return runs


def _fault_runs(n: int, n_pair: int) -> dict:
    """Phase 9's full-size runs (phase_faults)."""
    runs = {}
    # -max-rounds 2000 cut to 250 at n (the script's time limit,
    # PERF.md section 4; the timeline's last reboot is at 210 ms): the
    # run stalls short of 0.99 either way.
    out_h, res_h, st, runs["churn10m_heal"] = fault_run(
        "churn10m_heal", n, churn_argv(n, *HEAL_ON, "-max-rounds", "250"))
    del st
    FAULT_REFS["churn10m_heal"] = (out_h, res_h)
    sh = res_h.stats
    if sh.scen_crashed < 0.2 * n or sh.heal_repaired <= 0:
        fail(f"faults churn10m_heal: scen_crashed {sh.scen_crashed}, "
             f"heal_repaired {sh.heal_repaired}")
    for k in ("fused_emit", PMASK, "fused_ring_append"):
        if runs["churn10m_heal"][k] <= 0:
            fail(f"faults churn10m_heal: {k} was never launched "
                 f"({runs['churn10m_heal']})")
    _, res_n, st, runs["churn10m_noheal"] = fault_run(
        "churn10m_noheal", n, churn_argv(n, *HEAL_OFF))
    del st
    if res_n.converged or res_n.stats.heal_repaired != 0:
        fail(f"faults churn10m_noheal: converged={res_n.converged}, "
             f"heal_repaired {res_n.stats.heal_repaired}")
    end = "converged" if res_h.converged else "stopped"
    say(f"faults at n={n}: heal on {end} at coverage {sh.coverage:.6f}, "
        f"heal off at {res_n.stats.coverage:.6f}")
    # The acceptance pair and the gate twin at n_pair, -max-rounds 2000
    # cut to 1000 (the script's time limit, PERF.md section 4: the heal
    # run has stalled long before).
    tag = f"churn{n_pair // 1_000_000}m"
    out_h, res_h, st, runs[f"{tag}_heal"] = fault_run(
        f"{tag}_heal", n_pair, churn_argv(n_pair, *HEAL_ON, "-max-rounds",
                                          "1000"))
    del st
    out_x, res_x, st, runs[f"{tag}_heal_xla"] = fault_run(
        f"{tag}_heal_xla", n_pair, churn_argv(
            n_pair, *HEAL_ON, "-max-rounds", "1000", "-phase2-kernel", "xla",
            "-deliver-kernel", "xla"))
    del st
    if any(gated(runs[f"{tag}_heal_xla"]).values()):
        fail(f"faults {tag}_heal_xla launched a kernel "
             f"({runs[f'{tag}_heal_xla']})")
    if strip_notes(out_h) != strip_notes(out_x) or \
            res_h.stats.to_dict() != res_x.stats.to_dict():
        fail(f"faults {tag}_heal: default and xla-gate transcripts or "
             "Stats differ")
    _, res_n, st, runs[f"{tag}_noheal"] = fault_run(
        f"{tag}_noheal", n_pair, churn_argv(n_pair, *HEAL_OFF))
    del st
    sh, sn = res_h.stats, res_n.stats
    if res_n.converged or sn.coverage >= 0.97 or sn.heal_repaired != 0:
        fail(f"faults {tag}_noheal: converged={res_n.converged}, coverage "
             f"{sn.coverage}, heal_repaired {sn.heal_repaired}")
    if sh.scen_crashed < 0.2 * n_pair or sh.heal_repaired <= 0 or not (
            res_h.converged or sh.coverage > sn.coverage):
        fail(f"faults {tag}_heal: converged={res_h.converged}, coverage "
             f"{sh.coverage} (heal off {sn.coverage}), scen_crashed "
             f"{sh.scen_crashed}, heal_repaired {sh.heal_repaired}")
    say(f"faults {tag}: default and xla-gate transcripts and Stats "
        f"identical; heal on {'converged' if res_h.converged else 'stopped'}"
        f" at coverage {sh.coverage:.6f}, heal off at {sn.coverage:.6f}")
    # The ring engine's heal run to -max-rounds 250, not 2000 (its time
    # goes by the window, not by n: the script's time limit, PERF.md
    # section 4; the timeline's last reboot is at 210 ms).
    rtag = "ring_churn10m_heal"
    _, res_r, st, runs[rtag] = fault_run(
        rtag, n, churn_argv(n, "-engine", "ring", *HEAL_ON, "-max-rounds",
                            "250"))
    del st
    if runs[rtag][DEPOSIT] <= 0 or res_r.stats.heal_repaired <= 0:
        fail(f"faults {rtag}: launches {runs[rtag]}, heal_repaired "
             f"{res_r.stats.heal_repaired}")
    out_p, res_p, st, runs["pushsum_churn10m"] = fault_run(
        "pushsum_churn10m", n, pushsum_argv(n) + ["-scenario", CHURN,
                                                 "-overlay-heal", "on"])
    FAULT_REFS["pushsum_churn10m"] = (out_p, res_p)
    totals = _mass_totals(st.state, st.cfg)
    if totals != st.initial_totals or res_p.stats.mailbox_dropped:
        fail(f"faults pushsum_churn10m: mass {totals} after, "
             f"{st.initial_totals} before, mail_dropped "
             f"{res_p.stats.mailbox_dropped}")
    if runs["pushsum_churn10m"][DRAIN] <= 0 or \
            res_p.stats.scen_crashed <= 0:
        fail(f"faults pushsum_churn10m: launches {runs['pushsum_churn10m']}")
    say(f"faults pushsum_churn10m: mass conserved (Sigma x, Sigma w = "
        f"{totals}, parked mass included); report {res_p.report}")
    del st
    return runs


# --- phase 10: multi-rumor traffic on the event engine -----------------------

# bench.py's multirumor rows: multirumor_1m_r16 and stream_1m (n = 1e6,
# capture_multirumor) and multirumor_50m_r16 (capture_multirumor_50m);
# the 1e6 family cut to 2.5e5 for the script's time limit (PERF.md
# section 4).  The 5e7 run is not cut: below it, 7 n + 7 slots leave
# rumors short.
RUMOR_FAMILY_N = 250_000
RUMOR_BIG_N = 50_000_000
RUMOR_FLAGS = ["-graph", "kout", "-fanout", "6", "-crashrate", "0",
               "-coverage-target", "0.95", "-seed", "0"]
STREAM_FLAGS = ["-rumors", "64", "-traffic", "stream", "-stream-rate", "100"]
WORDS = "fused_emit:words"  # fused_emit's launches with rumor words
UNIQUE_WORDS = "fused_unique_set:words"  # its launches over the word ring
# The JAX package's test_churn_partition_heal_r16 (tests/test_multirumor.py)
# at n: R = 16 under CHURN with healing, to 0.99 within 600 ms, seed 3.
CHURN_R16 = ["-graph", "kout", "-fanout", "6", "-seed", "3", "-crashrate",
             "0", "-coverage-target", "0.99", "-max-rounds", "600",
             "-rumors", "16", "-scenario", CHURN, "-overlay-heal", "on"]
# The kernels whose word forms this phase times, their sources, the TPU
# kernels they replace and the case whose columns head a row that phase 3
# did not make (--phases rumors_event alone).
RUMOR_ROWS = {
    "fused_emit": ("gossip_simulator_tpu_torch/csrc/fused_emit.cu",
                   "gossip_simulator_tpu/ops/pallas_megakernel.py:206", "w1"),
    "fused_unique_set": ("gossip_simulator_tpu_torch/csrc/fused_unique_set.cu",
                         "gossip_simulator_tpu/ops/pallas_deliver.py:357",
                         "w1"),
    "fused_ring_append": (
        "gossip_simulator_tpu_torch/csrc/fused_ring_append.cu",
        "gossip_simulator_tpu/ops/pallas_deliver.py:226", "heal_r16"),
}


def rumor_row(name: str, cols: dict) -> dict:
    """A kernels-line row of `name` headed by its RUMOR_ROWS case."""
    source, replaces, lbl = RUMOR_ROWS[name]
    return dict(route="cuda", source=source, replaces=replaces,
                max_abs_err=cols[f"{lbl}_max_abs_err"], ms=cols[f"{lbl}_ms"],
                plain_ms=cols[f"{lbl}_plain_ms"],
                bound_ms=cols[f"{lbl}_bound_ms"],
                bound_by=cols[f"{lbl}_bound_by"],
                library_ms=cols.get(f"{lbl}_library_ms"))


def rumor_argv(n: int, *extra) -> list:
    """bench.py's multirumor flags at n (R and traffic in `extra`)."""
    return RUMOR_FLAGS + ["-n", str(n), *extra]


def _rumor_words(gen, dev, rows, w, density=0.25):
    """int32 (rows, w) words, each bit set with about `density`."""
    bits = torch.rand((rows, w, 32), generator=gen, device=dev) < density
    sh = torch.arange(32, dtype=torch.int64, device=dev)
    return (bits.to(torch.int64) << sh).sum(-1).to(torch.int32)


def rumor_parity(dev, gen, reps: int) -> dict:
    """The fourteenth slice's kernel forms, bit-exact to their plain
    versions and timed: fused_emit with rumor words (W = 1, 2, 32; with and
    without the partition mask) at the kout main shape (131,072 senders, 6
    lanes, dw 3) and at kw 112 (131,072 senders at W = 1 and 2, 16,384 at
    32); fused_unique_set over the id and word rings (W = 1, 2) at the
    main shape's 786,432 lanes, beside two index_put_ calls; and
    fused_ring_append with the word ring at multirumor1m_r16's and
    stream1m's injection batches (16 lanes W = 1, 2 lanes W = 2, on the
    1e6 ring) and at churn1m_heal_r16's heal appends (n * k = 7e6 lanes,
    W = 1).  Bounds by bytes, a scattered 4-byte access as its 32-byte
    sector (the word stores of a sender's kept lanes are one contiguous
    run).  Returns the columns of each kernel's row by kernel name."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.models import event
    from gossip_simulator_tpu_torch.ops import deliver, megakernel

    cols = {name: {} for name in RUMOR_ROWS}
    kcfg = Config(n=FULL_N, fanout=6, graph="kout").validate()
    n, k, b, dw, cap, m, ring_len = emit_shapes(kcfg, 6)
    # A ring of the main shape's depth that holds every case's W words.
    wcap = 2 * m * 112 // dw
    unique_case = None
    for label, kk, mm, w, pm in (
            ("w1", k, m, 1, None), ("w2", k, m, 2, None),
            ("w32", k, m, 32, None), ("w1_pm", k, m, 1, 0.5),
            ("w2_pm", k, m, 2, 0.5), ("w32_pm", k, m, 32, 0.5),
            ("kw112_w1", 112, m, 1, None), ("kw112_w2", 112, m, 2, None),
            ("kw112_w32", 112, 16_384, 32, None)):
        rlen = dw * wcap + mm * kk
        case, kw = emit_case(gen, dev, n, mm, kk, dw, wcap, b, rlen,
                             dup=False, sir=False, base_hi=wcap // 2)
        if pm is not None:
            kw["pmask"] = torch.rand((mm, kk), generator=gen,
                                     device=dev) < pm
        kw["swords"] = _rumor_words(gen, dev, mm, w)
        ring0 = case.pop("mail_ids")
        words0 = torch.zeros((rlen, w), dtype=torch.int32, device=dev)
        args = [case[x] for x in ("mail_cnt", "sf", "drop", "svalid",
                                  "wslot", "off")]
        out, err, t_k, t_p = check_and_time(
            f"fused_emit[{label}]", megakernel.emit_plain,
            megakernel.fused_emit,
            lambda: [ring0.clone(), words0.clone()],  # noqa: B023
            lambda fn, st: fn(st[0], *args, mail_words=st[1],  # noqa: B023
                              **kw)[1:5],  # noqa: B023
            lambda st: None, reps)
        kept = int(out[2].sum())
        nbytes, nops = emit_bytes(mm, kk, kk, False, False)
        nbytes += mm * w * 4 + mm * kk * w * 4  # the rows' words, stored
        if pm is not None:
            nbytes += mm * kk  # one mask byte a lane
        bnd, by = bound_ms(nbytes, nops)
        say(f"fused_emit[{label}]: bit-exact (m {mm}, kw {kk}, W {w}, "
            f"{kept} entries written, blocked {int(out[5])}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        cols["fused_emit"].update({
            f"{label}_max_abs_err": err, f"{label}_ms": t_k,
            f"{label}_plain_ms": t_p, f"{label}_bound_ms": bnd,
            f"{label}_bound_by": by})
        if label in ("w1", "w2"):
            flat, ivals, *_, wvals = megakernel.emit_layout(
                *args, swords=kw["swords"], **{
                    x: kw[x] for x in ("dw", "cap", "b")})
            unique_case = unique_case or {}
            unique_case[w] = (ring0, words0, flat, ivals, wvals)
        del out, case, args, kw, ring0, words0
        torch.cuda.empty_cache()
    for w, (ring0, words0, flat, ivals, wvals) in unique_case.items():
        label = f"w{w}"
        flat64 = flat.long()
        out, err, t_k, t_p = check_and_time(
            f"fused_unique_set[{label}]",
            lambda rings, f, v: (deliver.unique_set_plain(rings[0], f, v[0]),
                                 deliver.unique_set_plain(rings[1], f,
                                                          v[1])),
            deliver.fused_unique_set,
            lambda: [ring0.clone(), words0.clone()],  # noqa: B023
            lambda fn, st: fn((st[0], st[1]), flat,  # noqa: B023
                              (ivals, wvals)) and None,  # noqa: B023
            lambda st: None, reps)
        t_l = time_ms(lambda: (out[0].index_put_((flat64,), ivals),
                               out[1].index_put_((flat64,), wvals)), reps)
        lanes = flat.numel()
        bnd, by = bound_ms(lanes * (12 + 8 * w), lanes * 2 * (1 + w))
        say(f"fused_unique_set[{label}]: bit-exact over {lanes} lanes and "
            f"their {w}-word rows; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"two index_put_ {t_l:.4f} ms, bound {bnd:.5f} ms ({by})")
        cols["fused_unique_set"].update({
            f"{label}_max_abs_err": err, f"{label}_ms": t_k,
            f"{label}_plain_ms": t_p, f"{label}_library_ms": t_l,
            f"{label}_bound_ms": bnd, f"{label}_bound_by": by})
        del out
    del unique_case
    torch.cuda.empty_cache()
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    rcfg = Config(n=RUMOR_N, fanout=6, graph="kout", crashrate=0.0,
                  rumors=16).validate()
    rdw, rcap = event.ring_windows(rcfg), event.slot_cap(rcfg)
    rlen = rdw * rcap + event.ring_tail(rcfg)
    hk = rcfg.max_degree
    for label, lanes, w, valid_p in (
            ("inject_r16", event.injection_lanes(rcfg), 1, 1.0),
            ("inject_stream", event.injection_lanes(Config(
                n=RUMOR_N, fanout=6, graph="kout", crashrate=0.0, rumors=64,
                traffic="stream", stream_rate=100).validate()), 2, 1.0),
            ("heal_r16", RUMOR_N * hk, 1, 0.05)):
        rings0 = [ri(0, 2**30, (rlen,)), ri(-2**31, 2**31 - 1, (rlen, w))]
        cnt0 = ri(0, rcap // 2, (1, rdw))
        pays = (ri(0, RUMOR_N * 10, (lanes,)),
                _rumor_words(gen, dev, lanes, w))
        wslot = ri(0, rdw, (lanes,))
        valid = torch.rand(lanes, generator=gen, device=dev) < valid_p
        out, err, t_k, t_p = check_and_time(
            f"fused_ring_append[{label}]", deliver.ring_append_plain,
            deliver.fused_ring_append,
            lambda: [r.clone() for r in rings0] + [  # noqa: B023
                cnt0.clone(),  # noqa: B023
                torch.zeros((), dtype=torch.int32, device=dev)],
            lambda fn, st: fn(st[:2], st[2], st[3], pays,  # noqa: B023
                              wslot, valid, rdw, rcap) and None,  # noqa: B023
            lambda st: (st[2].copy_(cnt0), st[3].zero_()),  # noqa: B023
            reps)
        landed = int(valid.sum()) - int(out[3])
        # Lanes read once (payload, words, slot, valid); a landed lane's id
        # and word row stored in their sectors.
        bnd, by = bound_ms(lanes * (4 + 4 * w + 4 + 1)
                           + landed * (32 + max(32, 4 * w)), lanes * 40)
        say(f"fused_ring_append[{label}]: bit-exact over {lanes} lanes, "
            f"{landed} landed, W {w}; kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        cols["fused_ring_append"].update({
            f"{label}_max_abs_err": err, f"{label}_ms": t_k,
            f"{label}_plain_ms": t_p, f"{label}_bound_ms": bnd,
            f"{label}_bound_by": by})
        del rings0, out, pays, wslot, valid
        torch.cuda.empty_cache()
    return cols


def _card_side(argv, shards=None):
    """One full-size run on the card, in a worker process or in this one
    (on `shards` shards with the sharded backend), every launch count set
    to 0 before it: (transcript, RunResult, launches, wall s, peak bytes
    allocated)."""
    from gossip_simulator_tpu_torch.ops import _build

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out, res, st, wall = run_port(argv, "cuda", shards=shards)
    return (out, res, dict(_build.LAUNCHES), wall,
            torch.cuda.max_memory_allocated())


def rumor_line(name, n, res, counts, wall, peak, converge=True) -> None:
    """Print one multi-rumor run's wall, peak memory, rumors done,
    coverage, counters and report; with `converge`, fail unless it
    converged."""
    s = res.stats
    say(f"rumors {name}: n={n} R={s.rumors} {res.gossip_windows} windows "
        f"({res.coverage_ms:g} simulated ms), rumors_done {s.rumors_done}, "
        f"worst-rumor coverage {s.coverage:.6f}, total_received "
        f"{s.total_received}, converged={res.converged}; wall {wall:.3f} s; "
        f"total_message {s.total_message} ({s.total_message / wall:.4g} "
        f"messages/s); mailbox_dropped {s.mailbox_dropped}; scen_crashed "
        f"{s.scen_crashed}, heal_repaired {s.heal_repaired}, part_dropped "
        f"{s.part_dropped}; max_memory_allocated {peak} B; launches "
        f"{counts}; report {json.dumps(res.report)}")
    if converge and not res.converged:
        fail(f"rumors {name}: did not converge")


def size_tag(n: int) -> str:
    """A run name's size: 500k, 1m, 20m."""
    return f"{n // 10**6}m" if n >= 10**6 else f"{n // 1000}k"


def phase_rumors_event(n: int, n_big: int, twin_n: int,
                       more_twins=()) -> dict:
    """The fourteenth slice's path, multi-rumor traffic on the event engine
    (bench.py's multirumor flags: -graph kout -fanout 6 -crashrate 0
    -coverage-target 0.95 -seed 0): cuda-vs-cpu twins at twin_n (R = 16,
    R = 40 under -phase2-kernel xla, a stream, the churn timeline with
    healing); at n multirumor_r16 (R = 16) under the default gates
    (fused_emit with words, the injection's fused_ring_append),
    -phase2-kernel xla (fused_unique_set over the word ring) and all-xla
    (no kernel), stream (R = 64 at 100 rumors a second) under the default
    gates and all-xla, each family with one transcript, Stats and report,
    stream_poisson once (-arrivals poisson), and churn_heal_r16 (the JAX
    package's test_churn_partition_heal_r16 at n: the partition mask and
    the heal's appends with words) under the default gates and its
    -phase2-kernel xla -deliver-kernel xla twin -- these eight runs and
    the twins side by side in the worker processes (each run's host, its
    enqueue of small launches, is what bounds it; the walls printed are
    under that sharing); meanwhile, in this process, multirumor_r16 at
    n_big, at the largest slot capacity the JAX package's sizing allows
    (-event-slot-cap 7 n + 7), which must bring all 16 rumors to the
    target (its wall taken beside the workers).  `more_twins` (phase 4's,
    when both phases run) join the workers' queue after this phase's
    runs: the 5e7 run leaves them idle most of its wall.  Each run's
    name carries its size (size_tag).  Returns the launches of each
    full-size run by name."""
    cases = [
        ("r16", rumor_argv(twin_n, "-rumors", "16"),
         ("fused_emit", WORDS, "fused_ring_append")),
        ("r40_p2_xla", rumor_argv(twin_n, "-rumors", "40",
                                  "-phase2-kernel", "xla"),
         ("fused_unique_set", UNIQUE_WORDS, "fused_ring_append")),
        ("stream", rumor_argv(twin_n, "-rumors", "16", "-traffic",
                              "stream", "-stream-rate", "100"),
         ("fused_emit", WORDS, "fused_ring_append")),
        ("churn_heal_r16", CHURN_R16 + ["-n", str(twin_n)],
         ("fused_emit", WORDS, PMASK, "fused_ring_append"))]

    def checker(name, kernels):
        def check(launches, res_g):
            if any(launches[k] <= 0 for k in kernels):
                fail(f"twin {name}: a kernel of {kernels} was never "
                     f"launched ({launches})")
            if res_g.stats.rumors_done <= 0:
                fail(f"twin {name}: no rumor reached the target")
        return check

    twins = [(f"twin rumors {name}", argv, (), checker(name, kernels))
             for name, argv, kernels in cases]
    default = ("fused_emit", WORDS, "fused_ring_append")
    tag = size_tag(n)
    families = {  # name: (argv, (suffix, flags, kernels) a gate, converge)
        f"stream{tag}": (rumor_argv(n, *STREAM_FLAGS), (
            ("", [], default), ("_xla", ALL_XLA, ())), True),
        f"stream{tag}_poisson": (rumor_argv(n, *STREAM_FLAGS, "-arrivals",
                                            "poisson"),
                                 (("", [], default),), False),
        f"churn{tag}_heal_r16": (CHURN_R16 + ["-n", str(n)], (
            ("", [], default + (PMASK,)),
            ("_xla", ["-phase2-kernel", "xla", "-deliver-kernel", "xla"],
             ())), False),
        f"multirumor{tag}_r16": (rumor_argv(n, "-rumors", "16"), (
            ("", [], default),
            ("_p2_xla", ["-phase2-kernel", "xla"],
             ("fused_unique_set", UNIQUE_WORDS, "fused_ring_append")),
            ("_xla", ALL_XLA, ())), True)}
    from gossip_simulator_tpu_torch.ops import _build

    # The largest slot capacity the JAX package's slot_cap allows an SI
    # ring, n * k + k (7 n + 7): its default (the 3 GB ring budget, 2^28
    # entries a slot at 5e7) drops so many sends that 5 of the 16 rumors
    # reach the target (PERF.md section 6).
    big = f"multirumor{size_tag(n_big)}_r16"
    big_cap = ["-event-slot-cap", str(7 * n_big + 7)]
    t0 = time.perf_counter()
    with worker_pool() as pool:
        tw = submit_twins(pool, twins)
        futs = {name + sfx: pool.submit(_card_side, argv + flags)
                for name, (argv, gates, _) in families.items()
                for sfx, flags, _ in gates}
        more = submit_twins(pool, more_twins)
        # The 5e7 run in this process, beside the workers.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        _, res_big, st, wall_big = run_port(
            rumor_argv(n_big, "-rumors", "16", *big_cap), "cuda")
        big_runs = dict(_build.LAUNCHES)
        peak_big = torch.cuda.max_memory_allocated()
        del st
        check_twins(twins, tw)
        done = {k: f.result() for k, f in futs.items()}
        check_twins(more_twins, more)
    say(f"rumors: the {len(done)} runs at n={n}, the twins "
        f"({len(more_twins)} of phase 4's among them) and {big} side by "
        f"side took {time.perf_counter() - t0:.1f} s")
    runs = {big: big_runs}
    for name, (argv, gates, converge) in families.items():
        seen = set()
        for sfx, _, kernels in gates:
            out, res, got, wall, peak = done[name + sfx]
            rumor_line(name + sfx, n, res, got, wall, peak, converge)
            runs[name + sfx] = got
            if any(got[k] <= 0 for k in kernels) or (
                    not kernels and any(gated(got).values())):
                fail(f"rumors {name + sfx}: launches {got}, expected "
                     f"{kernels}")
            seen.add(json.dumps((strip_notes(out), res.stats.to_dict(),
                                 res.report), sort_keys=True))
        if len(seen) != 1:
            fail(f"rumors {name}: the gate settings' transcripts, Stats or "
                 "reports differ")
        if len(gates) > 1:
            say(f"rumors {name}: "
                f"{', '.join(s or 'default' for s, _, _ in gates)}: one "
                "transcript, one Stats, one report")
    res = done[f"churn{tag}_heal_r16"][1].stats
    if res.heal_repaired <= 0 or res.scen_crashed < 0.2 * n:
        fail(f"rumors churn{tag}_heal_r16: heal_repaired "
             f"{res.heal_repaired}, scen_crashed {res.scen_crashed}")
    del done, futs
    rumor_line(big, n_big, res_big, big_runs, wall_big, peak_big)
    if res_big.stats.rumors_done != 16:
        fail(f"rumors {big}: rumors_done {res_big.stats.rumors_done}")
    return runs


# --- phase 11: the sharded backend's fault branches and rumor words ---------

# Partition only (the churn timeline's partition, alone).
PARTITION = ('{"groups": 2, "events": [{"type": "partition", "start": 20, '
             '"end": 60}]}')
SHARDED_ON = ["-backend", "sharded"]


def _no_notes(t: str) -> list:
    """A transcript without its note lines (the gates', the exchange's)."""
    return [x for x in t.splitlines() if not x.startswith("(")]


def sharded_fault_twins(twin_n: int) -> list:
    """The cuda-vs-cpu twins of the sharded fault and rumor paths at
    twin_n, each on 2 and SHARDS shards: (name, argv, patches, check,
    shards).  Every case must launch fused_recv_land; the rumor cases and
    the heal's also fused_ring_append (the injection, the pulls)."""
    ps = pushsum_argv(twin_n, seed=1) + ["-scenario", CHURN,
                                         "-overlay-heal", "on"]
    part = ["-graph", "kout", "-n", str(twin_n), "-fanout", "6",
            "-crashrate", "0", "-seed", "0", "-scenario", PARTITION,
            *HEAL_OFF]
    cases = (
        ("churn_heal", churn_argv(twin_n, *HEAL_ON, *TWIN_MAX),
         (RECV, "fused_ring_append"), "fault"),
        ("churn_noheal", churn_argv(twin_n, *HEAL_OFF, *TWIN_MAX), (RECV,),
         "fault"),
        ("partition", part + TWIN_MAX, (RECV,), "partition"),
        ("pushsum_churn", ps, (RECV, DRAIN), "fault"),
        ("r16", rumor_argv(twin_n, "-rumors", "16"),
         (RECV, "fused_ring_append"), "rumor"),
        ("stream", rumor_argv(twin_n, "-rumors", "16", "-traffic", "stream",
                              "-stream-rate", "100"),
         (RECV, "fused_ring_append"), "rumor"),
        ("churn_heal_r16", CHURN_R16 + ["-n", str(twin_n), *TWIN_MAX],
         (RECV, "fused_ring_append"), "rumor"))

    def checker(tag, kernels, kind):
        def check(launches, res_g):
            s = res_g.stats
            if any(launches[k] <= 0 for k in kernels):
                fail(f"{tag}: a kernel of {kernels} was never launched "
                     f"({launches})")
            if (kind == "fault" and s.scen_crashed <= 0) or (
                    kind == "partition" and s.part_dropped <= 0) or (
                    kind == "rumor" and s.rumors_done <= 0):
                fail(f"{tag}: nothing of the {kind} case happened "
                     f"({s.to_dict()})")
        return check

    return [(f"sharded twin {name} S={shards}", argv + SHARDED_ON, (),
             checker(f"sharded twin {name} S={shards}", kernels, kind),
             shards)
            for shards in (2, SHARDS) for name, argv, kernels, kind in cases]


def phase_sharded_faults(n: int, n_rumor: int, twin_n: int) -> dict:
    """The seventeenth slice's path, -backend sharded with fault scenarios,
    healing and rumor words, on SHARDS shards of the card (fused_recv_land's
    word cases run with phase 3).  In the worker processes, side by side:
    the cuda-vs-cpu twins at twin_n on 2 and SHARDS shards
    (sharded_fault_twins), multirumor_r16_s8 and stream_s8 at n_rumor
    (the 2.5e5 multi-rumor family's argv, -backend sharded: every rumor
    must reach the target).  Meanwhile, in this process: churn10m_heal_s8
    (churn10m_heal's argv, -backend sharded: heal_repaired and
    part_dropped > 0, and its scenario counters churn10m_heal's where
    both end at one tick) and pushsum_churn10m_s8 (pushsum_churn10m's:
    the same transcript, Stats and report, and the mass conserved).  The
    single-device references come from phase 9 (run here when it did
    not).  Returns the launches of each full-size run by name."""
    tag = size_tag(n_rumor)
    ps_argv = pushsum_argv(n) + ["-scenario", CHURN, "-overlay-heal", "on"]
    churn = churn_argv(n, *HEAL_ON, "-max-rounds", "250")
    runs = {}
    for name, argv in (("churn10m_heal", churn),
                       ("pushsum_churn10m", ps_argv)):
        if name not in FAULT_REFS:
            out, res, st, runs[name] = fault_run(name, n, argv)
            del st
            FAULT_REFS[name] = (out, res)
    twins = sharded_fault_twins(twin_n)
    rumor = {f"multirumor{tag}_r16_s8": (rumor_argv(n_rumor, "-rumors", "16",
                                                    *SHARDED_ON), 16),
             f"stream{tag}_s8": (rumor_argv(n_rumor, *STREAM_FLAGS,
                                            *SHARDED_ON), 64)}
    t0 = time.perf_counter()
    with worker_pool() as pool:
        futs = {name: pool.submit(_card_side, argv, SHARDS)
                for name, (argv, _) in rumor.items()}
        tw = [submit_twins(pool, [c[:4]], c[4])[0] for c in twins]
        # The full-size runs in this process, beside the workers.
        out_h, res_h, st, runs["churn10m_heal_s8"] = fault_run(
            "churn10m_heal_s8", n,
            churn + SHARDED_ON + spatial_argv("churn10m_heal_s8"),
            shards=SHARDS)
        del st
        out_p, res_p, st, runs["pushsum_churn10m_s8"] = fault_run(
            "pushsum_churn10m_s8", n,
            ps_argv + SHARDED_ON + spatial_argv("pushsum_churn10m_s8"),
            shards=SHARDS)
        totals = _mass_totals(st.state, st.cfg)
        initial = st.initial_totals
        del st
        check_twins([c[:4] for c in twins], tw)
        done = {k: f.result() for k, f in futs.items()}
    say(f"sharded_faults: the {len(twins)} twins, the {len(done)} runs at "
        f"n={n_rumor} and the two at n={n} side by side took "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("churn10m_heal_s8", "pushsum_churn10m_s8"):
        spatial_check(name, f"{SPATIAL_DIR}/{name}")
    for name, (_, r) in rumor.items():
        out, res, got, wall, peak = done[name]
        rumor_line(name, n_rumor, res, got, wall, peak)
        runs[name] = got
        if res.stats.rumors_done != r or got[RECV] <= 0 or \
                got["fused_ring_append"] <= 0:
            fail(f"rumors {name}: rumors_done {res.stats.rumors_done} of "
                 f"{r}, launches {got}")
    ref_out, ref = FAULT_REFS["churn10m_heal"]
    sh, s1 = res_h.stats, ref.stats
    if sh.heal_repaired <= 0 or sh.part_dropped <= 0 or \
            runs["churn10m_heal_s8"][RECV] <= 0:
        fail(f"faults churn10m_heal_s8: heal_repaired {sh.heal_repaired}, "
             f"part_dropped {sh.part_dropped}, launches "
             f"{runs['churn10m_heal_s8']}")
    same = (sh.round == s1.round and (sh.scen_crashed, sh.scen_recovered)
            == (s1.scen_crashed, s1.scen_recovered))
    if sh.round == s1.round and not same:
        fail(f"faults churn10m_heal_s8: scen_crashed/recovered "
             f"{sh.scen_crashed}/{sh.scen_recovered} at tick {sh.round}, "
             f"one device {s1.scen_crashed}/{s1.scen_recovered}")
    say(f"faults churn10m_heal_s8: ends at tick {sh.round} (one device "
        f"{s1.round}), scen_crashed {sh.scen_crashed} ({s1.scen_crashed}), "
        f"scen_recovered {sh.scen_recovered} ({s1.scen_recovered}), "
        f"coverage {sh.coverage:.6f} ({s1.coverage:.6f})"
        + ("; the scenario's counters equal" if same else ""))
    ref_out, ref = FAULT_REFS["pushsum_churn10m"]
    if (_no_notes(out_p) != _no_notes(ref_out)
            or res_p.stats.to_dict() != ref.stats.to_dict()
            or res_p.report != ref.report):
        fail("faults pushsum_churn10m_s8: transcript, Stats or report "
             "differ from pushsum_churn10m's")
    if totals != initial or res_p.stats.mailbox_dropped or \
            res_p.stats.exchange_overflow or \
            runs["pushsum_churn10m_s8"][RECV] <= 0:
        fail(f"faults pushsum_churn10m_s8: mass {totals} after, {initial} "
             f"before, mailbox_dropped {res_p.stats.mailbox_dropped}, "
             f"exchange_overflow {res_p.stats.exchange_overflow}, launches "
             f"{runs['pushsum_churn10m_s8']}")
    say(f"faults pushsum_churn10m_s8: transcript, Stats and report equal "
        f"pushsum_churn10m's; mass conserved (Sigma x, Sigma w = {totals})")
    return runs


def _transcript(name, out) -> None:
    for line in out.splitlines():
        say(f"  {name} | {line}")


def _erdos_parted(n, lam, r0, nr, card_f, card_d):
    """In a worker: graphs.erdos's rows [r0, r0 + nr) at n and lam on the
    CPU, the count of them that part from the card's (card_f, card_d),
    and the seconds it took."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.models import graphs

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cfg = Config(n=n, graph="erdos", er_p=lam / n).validate()
    cf, cd = graphs.generate(cfg, graphs.graph_key(cfg, "cpu"), r0, nr)
    parted = int(((torch.from_numpy(card_f) != cf).any(dim=1)
                  | (torch.from_numpy(card_d) != cd)).sum())
    return parted, time.perf_counter() - t0


def _graph_runs(n_kout: int, n_erdos: int, n_wide: int) -> dict:
    """phase_graphs' four full runs; returns their launches by name."""
    runs = {}
    sir = ["-protocol", "sir", "-seed", "0"]
    for name, n, argv, gen_kernel in (
            ("kout100m_pallas", n_kout,
             ["-graph", "kout", "-n", str(n_kout), "-fanout", "3",
              "-crashrate", "0.001", "-coverage-target", "0.90", "-pallas",
              "-seed", "0"], "kout_pallas"),
            ("erdos10m", n_erdos,
             ["-graph", "erdos", "-n", str(n_erdos), "-fanout", "8",
              "-removal-rate", "0.2", "-coverage-target", "0.8", *sir],
             None),
            ("erdos10m_pallas", n_erdos,
             ["-graph", "erdos", "-n", str(n_erdos), "-fanout", "8",
              "-removal-rate", "0.2", "-coverage-target", "0.8", "-pallas",
              *sir], "erdos_pallas"),
            ("erdos1m_wide", n_wide,
             ["-graph", "erdos", "-n", str(n_wide), "-er-p", "1.2e-5",
              *sir], None)):
        out, res, st, counts, wall = full_run(name, n, argv)
        del st
        runs[name] = counts
        _transcript(name, out)
        want = ("fused_emit",) + ((gen_kernel,) if gen_kernel else ())
        idle = [k for k in ("kout_pallas", "erdos_pallas")
                if k != gen_kernel]
        if any(counts[k] <= 0 for k in want) or any(counts[k] for k in idle):
            fail(f"full {name}: launches {counts}, expected {want}")
        say(f"full {name}: wall {wall:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated()} B")
    return runs


def phase_graphs(n_kout: int, n_erdos: int, n_wide: int) -> dict:
    """The sixth slice's paths, static graph generation: headline_jax
    (-graph kout -fanout 3 -crashrate 0.001 -coverage-target 0.90
    -pallas at n_kout: kout_pallas), sir_10m_erdos (-graph erdos -fanout 8
    -protocol sir -removal-rate 0.2 -coverage-target 0.8 at n_erdos)
    without -pallas (graphs.erdos) and with it (erdos_pallas), and
    -graph erdos -er-p 1.2e-5 -protocol sir at n_wide (lam = 12: 38 lanes
    a sender, the rejection branch).  Each prints its transcript, wall
    seconds and peak memory.  Beside them, in the worker processes (so
    their walls are taken beside six busy CPU workers), the rows where
    graphs.erdos's table on the card parts from the CPU's, at n = 1e6 for
    lam = 5, 8, 12 and 60 (utils/rng.poisson: XLA's float32 log and
    lgamma), held to ERDOS_CARD_CPU_PARTED.  Returns the launches of each run by name."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.models import graphs

    rows = 1_000_000
    with worker_pool() as pool:
        parts = []
        for lam in (5.0, 8.0, 12.0, 60.0):
            cfg = Config(n=rows, graph="erdos", er_p=lam / rows).validate()
            t0 = time.perf_counter()
            gf, gd = graphs.generate(cfg, graphs.graph_key(cfg, "cuda"))
            torch.cuda.synchronize()
            t_g = time.perf_counter() - t0
            gf, gd = gf.cpu(), gd.cpu()
            # Row blocks of ~2**19 cells keep the CPU's int64 chain in
            # cache (a row's draws do not depend on its block).
            step = max(4096, 2**19 // gf.shape[1])
            parts.append((lam, gf.shape[1], t_g, step, [
                pool.submit(_erdos_parted, rows, lam, r0, nr,
                            gf[r0:r0 + nr].numpy(), gd[r0:r0 + nr].numpy())
                for r0, nr in _blocks(rows, step)]))
            del gf, gd
        torch.cuda.empty_cache()
        runs = _graph_runs(n_kout, n_erdos, n_wide)
        for lam, cap, t_g, step, futs in parts:
            got = [f.result() for f in futs]
            parted = sum(p for p, _ in got)
            say(f"erdos card vs cpu: lam {lam:g}, n {rows}, cap {cap}: "
                f"{parted} rows part; generation cuda {t_g:.3f} s, cpu "
                f"{sum(t for _, t in got):.3f} s (row blocks of {step}, "
                f"summed over {WORKERS} workers)")
            if parted > ERDOS_CARD_CPU_PARTED:
                fail(f"erdos card vs cpu: {parted} rows part at lam "
                     f"{lam:g} (at most {ERDOS_CARD_CPU_PARTED} measured; "
                     "ROADMAP C5)")
    return runs


# --- phase 8: the sharded backend, S shards laid out on the one card --------

SHARDS = 8  # config 5's mesh (BASELINE.json: v5e-8), on one card
SHARDED_N = 10_000_000  # sharded_10m (bench.py's row at S = 8)
# sharded_10m's -phase2-kernel xla and -exchange-pipeline double twins,
# with a default-gate run of their own (cut from 1e7 for the time limit).
SHARDED_GATE_N = 1_000_000
# Config 5 ("100M nodes sharded") cut to 1.2e7: the script's time limit
# (PERF.md section 4 lists the cut).
SHARDED_BIG_N = 12_000_000
RECV = "fused_recv_land"


def sharded_argv(n: int) -> list:
    """sharded_10m's flags (headline_jax's, -backend sharded) at n."""
    return ["-backend", "sharded", "-graph", "kout", "-n", str(n),
            "-fanout", "3", "-crashrate", "0.001", "-coverage-target",
            "0.90", "-pallas", "-seed", "0"]


def recv_shapes(argv, shards: int) -> dict:
    """The sharded event engine's receive-side shapes under `argv` on
    `shards` shards: a compacted emission batch's wire buffer is shards x
    chernoff_cap(scap * k) lanes."""
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.models import event
    from gossip_simulator_tpu_torch.parallel import exchange

    cfg, _ = parse_cli(argv)
    nl, k = cfg.n // shards, cfg.fanout  # a kout table is fanout wide
    dw, b = event.ring_windows(cfg), event.batch_ticks(cfg)
    cap, ccap = event.slot_cap(cfg, nl), event.drain_chunk(cfg, nl)
    scap = event.sender_compaction_cap(cfg, ccap)
    rcap = exchange.chernoff_cap(scap * k, shards)
    return dict(n_local=nl, dw=dw, b=b, cap=cap, ccap=ccap, scap=scap,
                rcap=rcap, fill=-(-scap * k // shards),
                length=dw * cap + event.ring_tail(cfg, nl))


def pushsum_recv_shapes(n: int, shards: int) -> dict:
    """PushSum's receive-side shapes at n on `shards` shards: one window's
    wire buffer of shards x epidemic_cap lanes (sized, as in the JAX
    package, by the table's max_degree), 12 mass columns."""
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.models import pushsum
    from gossip_simulator_tpu_torch.parallel import exchange

    cfg, _ = parse_cli(pushsum_argv(n) + ["-backend", "sharded"])
    nl, k = n // shards, cfg.graph_width
    return dict(n_local=nl, dw=pushsum.ring_windows(cfg),
                b=pushsum.batch_ticks(cfg), cap=pushsum.slot_cap(cfg, nl),
                rcap=min(exchange.epidemic_cap(nl, k, shards), nl * k),
                fill=nl * k // shards, length=pushsum.ring_len(cfg, nl),
                width=pushsum.mass_cols(cfg))


def _wire(gen, dev, shards, rcap, fill, n_local, dw, b, width=None):
    """A received wire buffer: per source shard a bucket of rcap lanes
    whose first `fill` hold wire words (row, slot, offset) and the rest
    -1; with `width`, the (lanes, width) limb rows beside it (-1 in the
    empty slots, as the exchange leaves them)."""
    m = shards * rcap
    ri = lambda hi: torch.randint(0, hi, (m,), generator=gen,  # noqa: E731
                                  device=dev, dtype=torch.int32)
    live = torch.arange(m, device=dev) % rcap < fill
    recv = torch.where(live, ri(n_local) * (dw * b) + ri(dw) * b + ri(b),
                       -1).to(torch.int32)
    words = None
    if width is not None:
        words = torch.where(live[:, None], _limb_rows(gen, dev, m, width),
                            -1).to(torch.int32)
    return recv, words


def recv_bytes(m: int, live: int, landed: int, w: int = 0,
               flags: bool = False) -> int:
    """The bytes fused_recv_land must move: each of the `m` wire words
    read; per live lane a flag byte (with the duplicate filter) and its
    `w`-word row read; each landed entry's id cell and word row written.
    A slot's entries land side by side (the append), so a write counts at
    its own size, not as a scattered 32-byte sector."""
    return (m * 4 + live * ((1 if flags else 0) + 4 * w)
            + landed * (4 + 4 * w))


def recv_parity(dev, gen, reps: int) -> dict:
    """fused_recv_land at the sharded paths' shapes, S = 8: a compacted
    emission batch of sharded_10m (n_local 1.25e6, dw 3, b 10, scap
    65,536: 8 x 25,831 lanes) without the duplicate filter, the same batch
    of the fanout-6 crash-0 run (dup_suppress on: flags), PushSum's window
    at n = 1e7 (8 x 4.375e6 lanes, 12 mass columns), and an overflow case
    (a small cap: the trash cell and the drop count).  Each is bit-exact
    to recv_land_plain; the row times the first case."""
    from gossip_simulator_tpu_torch.ops import megakernel

    i32 = dict(dtype=torch.int32, device=dev)
    ev = recv_shapes(sharded_argv(SHARDED_N), SHARDS)
    dup = recv_shapes(["-backend", "sharded", "-graph", "kout", "-n",
                       str(SHARDED_N), "-fanout", "6", "-crashrate", "0"],
                      SHARDS)
    ps = pushsum_recv_shapes(PUSHSUM_N, SHARDS)
    say(f"recv shapes: sharded_10m {ev}; fanout-6 crash-0 {dup}; "
        f"pushsum10m {ps}")
    row = None
    for name, sh, flags, width, small_cap in (
            ("event", ev, False, None, None),
            ("event_dup", dup, True, None, None),
            ("pushsum", ps, False, ps["width"], None),
            ("overflow", ev, False, None, 30_000)):
        cap = small_cap or sh["cap"]
        length = sh["dw"] * cap + 1 if small_cap else sh["length"]
        recv, words = _wire(gen, dev, SHARDS, sh["rcap"], sh["fill"],
                            sh["n_local"], sh["dw"], sh["b"], width)
        cnt0 = torch.randint(cap // 4 if small_cap is None else cap - 3000,
                             cap // 2 if small_cap is None else cap - 2000,
                             (1, sh["dw"]), generator=gen, **i32)
        fl = ((torch.rand(sh["n_local"] + 1, generator=gen, device=dev)
               < 0.5).to(torch.uint8) if flags else None)
        kw = dict(dw=sh["dw"], cap=cap, b=sh["b"], flags=fl)

        def fresh():
            st = [torch.zeros(length, **i32), cnt0.clone(),
                  torch.zeros((), **i32)]
            if width:
                st.append(torch.zeros((length, width), **i32))
            return st

        def call(fn, st):
            out = fn(st[0], st[1], st[2], recv, words=words,
                     mail_words=st[3] if width else None, **kw)
            return [out[3]]

        out, err, t_k, t_p = check_and_time(
            f"{RECV}[{name}]", megakernel.recv_land_plain,
            megakernel.fused_recv_land, fresh, call,
            lambda st: (st[1].copy_(cnt0), st[2].zero_()), reps)
        m = recv.numel()
        live = int((recv >= 0).sum())
        landed = int((out[1] - cnt0).sum())
        dropped = int(out[2])
        if small_cap and not dropped:
            fail(f"{RECV}[{name}]: the overflow case dropped nothing")
        w = width or 0
        bnd, by = bound_ms(recv_bytes(m, live, landed, w, flags), m * 30)
        say(f"{RECV}[{name}]: bit-exact over {m} lanes ({live} live, "
            f"{landed} landed, {dropped} dropped, sup "
            f"{out[-1].tolist()}; cap {cap}, {w} word columns); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        if name == "event":
            hu = host_us(lambda: call(megakernel.fused_recv_land, out[:3]))
            say(f"host {RECV}[event]: {hu:.2f} us a call (the wrapper's "
                "enqueue on an idle card)")
        if row is None:
            row = dict(route="cuda",
                       source="gossip_simulator_tpu_torch/csrc/"
                              "fused_recv_land.cu",
                       replaces="gossip_simulator_tpu/ops/"
                                "pallas_megakernel.py:328",
                       max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bnd,
                       bound_by=by, library_ms=None, host_us=hu)
        else:
            row[f"{name}_max_abs_err"] = err
            row.update({f"{name}_ms": t_k, f"{name}_plain_ms": t_p,
                        f"{name}_bound_ms": bnd, f"{name}_bound_by": by})
        del out, recv, words, fl
        torch.cuda.empty_cache()
    return row


def _wire_rumor_words(gen, dev, recv, w):
    """(lanes, w) int32 rumor words beside a received wire buffer: in live
    lanes a quarter all ones (-1), a quarter rumor 31's bit alone (int32
    -2^31), the rest random 32-bit words; -1 in the empty slots, as the
    exchange leaves them."""
    m = recv.numel()
    kind = torch.randint(0, 4, (m, w), generator=gen, device=dev)
    rand = torch.randint(-2**31, 2**31, (m, w), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    words = torch.where(kind == 0, -1, torch.where(kind == 1, -2**31, rand))
    return torch.where((recv >= 0)[:, None], words, -1).to(torch.int32)


def recv_word_parity(dev, gen, reps: int) -> dict:
    """fused_recv_land with the event engine's rumor words at the shape of
    a compacted emission batch of multirumor250k_r16_s8 (-backend sharded
    on SHARDS shards: n_local 31,250, its scap and chernoff_cap): W 1, 2
    and 32 word columns, and W 2 with a small cap (an overflow); bit 31
    set in half the live words, all ones in a quarter.  Each is bit-exact
    to recv_land_plain.  Bound by bytes (recv_bytes).  Returns the
    columns of the B12 row (rumor_w1_ms, ...)."""
    from gossip_simulator_tpu_torch.ops import megakernel

    i32 = dict(dtype=torch.int32, device=dev)
    sh = recv_shapes(rumor_argv(RUMOR_FAMILY_N, "-rumors", "16",
                                "-backend", "sharded"), SHARDS)
    say(f"recv shapes: multirumor{size_tag(RUMOR_FAMILY_N)}_r16_s8 {sh}")
    cols = {}
    for name, w, small_cap in (("rumor_w1", 1, None), ("rumor_w2", 2, None),
                               ("rumor_w32", 32, None),
                               ("rumor_w2_overflow", 2, 600)):
        cap = small_cap or sh["cap"]
        length = sh["dw"] * cap + 1 if small_cap else sh["length"]
        recv, _ = _wire(gen, dev, SHARDS, sh["rcap"], sh["fill"],
                        sh["n_local"], sh["dw"], sh["b"])
        words = _wire_rumor_words(gen, dev, recv, w)
        lo, hi = (cap // 4, cap // 2) if small_cap is None else (
            cap - 300, cap - 200)
        cnt0 = torch.randint(lo, hi, (1, sh["dw"]), generator=gen, **i32)
        kw = dict(dw=sh["dw"], cap=cap, b=sh["b"])

        def fresh():
            return [torch.zeros(length, **i32), cnt0.clone(),  # noqa: B023
                    torch.zeros((), **i32),
                    torch.zeros((length, w), **i32)]  # noqa: B023

        def call(fn, st):
            return [fn(st[0], st[1], st[2], recv, words=words,  # noqa: B023
                       mail_words=st[3], **kw)[3]]  # noqa: B023

        out, err, t_k, t_p = check_and_time(
            f"{RECV}[{name}]", megakernel.recv_land_plain,
            megakernel.fused_recv_land, fresh, call,
            lambda st: (st[1].copy_(cnt0), st[2].zero_()),  # noqa: B023
            reps)
        m = recv.numel()
        live = int((recv >= 0).sum())
        landed = int((out[1] - cnt0).sum())
        dropped = int(out[2])
        neg = int((out[3] < 0).sum())
        if small_cap and not dropped:
            fail(f"{RECV}[{name}]: the overflow case dropped nothing")
        if not neg:
            fail(f"{RECV}[{name}]: no landed word has bit 31 set")
        bnd, by = bound_ms(recv_bytes(m, live, landed, w), m * 30)
        say(f"{RECV}[{name}]: bit-exact over {m} lanes ({live} live, "
            f"{landed} landed, {dropped} dropped; {neg} landed words with "
            f"bit 31 set; cap {cap}, W {w}); kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        cols.update({f"{name}_max_abs_err": err, f"{name}_ms": t_k,
                     f"{name}_plain_ms": t_p, f"{name}_bound_ms": bnd,
                     f"{name}_bound_by": by})
        del out, recv, words
        torch.cuda.empty_cache()
    return cols


# The ring depths past the shared form's 1024 slots (ROADMAP C1): the
# global form of the three single-pass appends.
DEEP_DW = (1536, 4096)


def fault_parity(dev, gen, reps: int) -> dict:
    """The tenth slice's kernel cases: fused_emit with the scenario's
    partition mask (half of the lanes blocked) at the kout main shape
    (131,072 senders, 6 lanes, dw 3), held to emit_plain (blocked count
    included); and the three single-pass appends past 1024 ring slots (dw
    1536 and 4096: the global form), each held to its plain version and
    timed: fused_emit (131,072 senders, 6 lanes), fused_ring_append
    (262,144 lanes, two flat rings: the overlay's chunk) and
    fused_recv_land (sharded_10m's batch, 8 x 25,831 lanes).  Returns the
    columns of each kernel's row by kernel name."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.ops import deliver, megakernel

    cols = {"fused_emit": {}, "fused_ring_append": {}, RECV: {}}
    kcfg = Config(n=FULL_N, fanout=6, graph="kout").validate()
    n, k, b, dw, cap, m, ring_len = emit_shapes(kcfg, 6)
    i32 = dict(dtype=torch.int32, device=dev)
    for label, ddw, dcap, pm in (("pmask", dw, cap, 0.5),
                                 *((f"dw{d}", d, 300, None)
                                   for d in DEEP_DW)):
        rlen = ring_len if ddw == dw else ddw * dcap + m * k
        case, kw = emit_case(gen, dev, n, m, k, ddw, dcap, b, rlen,
                             dup=False, sir=False, base_hi=dcap // 2)
        if pm is not None:
            kw["pmask"] = torch.rand((m, k), generator=gen,
                                     device=dev) < pm
        ring0 = case.pop("mail_ids")
        args = [case[x] for x in ("mail_cnt", "sf", "drop", "svalid",
                                  "wslot", "off")]
        ring_p, ring_k = ring0.clone(), ring0.clone()
        out_p = megakernel.emit_plain(ring_p, *args, **kw)
        out_k = megakernel.fused_emit(ring_k, *args, **kw)
        torch.cuda.synchronize()
        err = max_err([ring_p], [ring_k])
        same = all(torch.equal(a, c) for a, c in zip(out_p[1:3], out_k[1:3]))
        if not (err == 0 and same and int(out_p[3]) == int(out_k[3])
                and int(out_p[4]) == int(out_k[4])):
            fail(f"fused_emit[{label}] differs from its plain version (ring "
                 f"err {err}; lost {int(out_p[3])} vs {int(out_k[3])}, "
                 f"blocked {int(out_p[4])} vs {int(out_k[4])})")
        t_k = time_ms(lambda: megakernel.fused_emit(ring_k, *args, **kw),
                      reps)
        t_p = time_ms(lambda: megakernel.emit_plain(ring_p, *args, **kw),
                      reps)
        device_split(f"fused_emit[{label}]",
                     lambda: megakernel.fused_emit(ring_k, *args, **kw))
        nbytes, nops = emit_bytes(m, k, k, False, False)
        if pm is not None:
            nbytes += m * k  # one mask byte a lane
        bnd, by = bound_ms(nbytes, nops)
        say(f"fused_emit[{label}]: bit-exact (dw {ddw}, cap {dcap}, blocked "
            f"{int(out_k[4])} of {m * k} lanes, lost {int(out_k[3])}); "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms "
            f"({by})")
        cols["fused_emit"].update({
            f"{label}_max_abs_err": err, f"{label}_ms": t_k,
            f"{label}_plain_ms": t_p, f"{label}_bound_ms": bnd,
            f"{label}_bound_by": by})
        del ring0, ring_p, ring_k, case, args, kw
        torch.cuda.empty_cache()
    rm = 262_144
    for ddw in DEEP_DW:
        dcap = 2 * rm // ddw
        rings0 = [torch.randint(0, 2**30, (ddw * dcap + 1,), generator=gen,
                                **i32) for _ in range(2)]
        cnt0 = torch.randint(0, dcap // 2, (1, ddw), generator=gen, **i32)
        pays = (torch.randint(0, FULL_N, (rm,), generator=gen, **i32),
                torch.randint(0, 2**30, (rm,), generator=gen, **i32))
        wslot = torch.randint(0, ddw, (rm,), generator=gen, **i32)
        valid = torch.rand(rm, generator=gen, device=dev) < 0.9
        out, err, t_k, t_p = check_and_time(
            f"fused_ring_append[dw{ddw}]", deliver.ring_append_plain,
            deliver.fused_ring_append,
            lambda: [r.clone() for r in rings0] + [  # noqa: B023
                cnt0.clone(), torch.zeros((), **i32)],  # noqa: B023
            lambda fn, st: fn(st[:2], st[2], st[3], pays,  # noqa: B023
                              wslot, valid, ddw, dcap) and None,  # noqa: B023
            lambda st: (st[2].copy_(cnt0), st[3].zero_()),  # noqa: B023
            reps)
        ok = int(valid.sum()) - int(out[3])
        bnd, by = bound_ms(rm * 13 + ok * 8 + 8 * ddw, rm * 40)
        say(f"fused_ring_append[dw{ddw}]: bit-exact over {rm} lanes (cap "
            f"{dcap}, dropped {int(out[3])}); kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        cols["fused_ring_append"].update({
            f"dw{ddw}_max_abs_err": err, f"dw{ddw}_ms": t_k,
            f"dw{ddw}_plain_ms": t_p, f"dw{ddw}_bound_ms": bnd,
            f"dw{ddw}_bound_by": by})
        del rings0, out, pays, wslot, valid
        torch.cuda.empty_cache()
    ev = recv_shapes(sharded_argv(SHARDED_N), SHARDS)
    for ddw in DEEP_DW:
        dcap = 2 * SHARDS * ev["rcap"] // ddw
        # Rows whose wire words d * (dw * b) + w * b + o fit in int32.
        nl = min(ev["n_local"], (2**31 - 1) // (ddw * ev["b"]))
        recv, _ = _wire(gen, dev, SHARDS, ev["rcap"], ev["fill"], nl, ddw,
                        ev["b"])
        cnt0 = torch.randint(0, dcap // 2, (1, ddw), generator=gen, **i32)
        kw = dict(dw=ddw, cap=dcap, b=ev["b"])
        out, err, t_k, t_p = check_and_time(
            f"{RECV}[dw{ddw}]", megakernel.recv_land_plain,
            megakernel.fused_recv_land,
            lambda: [torch.zeros(ddw * dcap + 1, **i32),  # noqa: B023
                     cnt0.clone(), torch.zeros((), **i32)],  # noqa: B023
            lambda fn, st: [fn(st[0], st[1], st[2], recv,  # noqa: B023
                               **kw)[3]],  # noqa: B023
            lambda st: (st[1].copy_(cnt0), st[2].zero_()),  # noqa: B023
            reps)
        rmm = recv.numel()
        landed = int((out[1] - cnt0).sum())
        bnd, by = bound_ms(recv_bytes(rmm, 0, landed), rmm * 30)
        say(f"{RECV}[dw{ddw}]: bit-exact over {rmm} lanes ({landed} landed, "
            f"{int(out[2])} dropped; cap {dcap}, rows {nl}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {bnd:.5f} ms ({by})")
        cols[RECV].update({
            f"dw{ddw}_max_abs_err": err, f"dw{ddw}_ms": t_k,
            f"dw{ddw}_plain_ms": t_p, f"dw{ddw}_bound_ms": bnd,
            f"dw{ddw}_bound_by": by})
        del recv, out
        torch.cuda.empty_cache()
    cols[DEPOSIT] = heal_deposit_parity(dev, gen, reps)
    return cols


def heal_deposit_parity(dev, gen, reps: int) -> dict:
    """fused_deposit_add at the ring engine's heal deposit at n = 1e7
    (n * k = 6e7 lanes, one slot a healer row of the
    20 x 1e7 ring, a quarter of a percent of the lanes valid, about one
    heal's re-sends): 0.3 lanes a ring cell, so the wrapper takes the
    direct form.  Bit-exact to its plain version, timed beside it, the
    one index_put_ call and the bound.  Returns the heal_* columns of
    the fused_deposit_add row."""
    from gossip_simulator_tpu_torch.ops import deliver

    b, n, k = 20, RING_N, 6
    slots, dst, ok, _ = _deposit_lanes(gen, dev, b, n, n, k, 0.0025)
    pend0 = torch.randint(0, 4, (b, n), generator=gen, dtype=torch.int32,
                          device=dev)
    m = slots.numel()
    form = "dense" if deliver.deposit_part_bits(m, b * n) else "direct"
    out, err, t_k, t_p = check_and_time(
        "fused_deposit_add[heal]", deliver.deposit_add_plain,
        deliver.fused_deposit_add, lambda: [pend0.clone()],
        lambda fn, st: [fn(st[0], slots, dst, ok)][1:], lambda st: None,
        reps)
    flat = slots.long() * n + dst.long()
    flat_ok = flat[ok]
    one = torch.ones(flat_ok.numel(), dtype=torch.int32, device=dev)
    pv = out[0].view(-1)
    t_l = time_ms(lambda: pv.index_put_((flat_ok,), one, accumulate=True),
                  reps)
    sectors = _touched(flat, ok)
    # The function reads every lane's valid byte, and slot and dst of the
    # valid lanes only (0.25 % of them here), and each touched sector once.
    kept = int(ok.sum())
    bnd, by = bound_ms(m + kept * 8 + sectors * 64, m * 4)
    say(f"fused_deposit_add[heal]: bit-exact over {m} lanes ({b} x {n} "
        f"ring, {kept} kept, {sectors} sectors, {m / (b * n):.4f} lanes a "
        f"cell: the {form} form); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"index_put_ {t_l:.4f} ms, bound {bnd:.5f} ms ({by})")
    del slots, dst, ok, pend0, out, flat, flat_ok, one, pv
    torch.cuda.empty_cache()
    return dict(heal_max_abs_err=err, heal_ms=t_k, heal_plain_ms=t_p,
                heal_library_ms=t_l, heal_bound_ms=bnd, heal_bound_by=by,
                heal_form=form)


def sharded_twins(n: int) -> list:
    """cuda-vs-cpu twins of the sharded backend at n on 2 and 8 shards
    (identical transcripts and final state leaves, and fused_recv_land
    launched on the card): (name, argv, patches, check, shards).  The
    crash-0 kout run moved to phase 11, whose partition twin runs its
    path (the duplicate filter) with the scenario's on top; fault-free
    PushSum (the mass route) runs on SHARDS shards only, phase 11 twins
    it under churn on 2 and 8."""
    kout = ["-backend", "sharded", "-graph", "kout", "-n", str(n),
            "-fanout", "6", "-seed", "1"]
    erdos = ["-backend", "sharded", "-graph", "erdos", "-n", str(n),
             "-fanout", "8", "-seed", "1"]
    cases = (("si", kout, ()),
             ("sir", kout + ["-protocol", "sir", "-removal-rate", "0.3",
                             "-droprate", "0.3"], ()),
             ("erdos", erdos, ()),
             # The shards' slices take the fold_in generator (no
             # erdos_pallas), as the JAX package's traced row0 does.
             ("erdos_pallas", erdos + ["-pallas"], ("erdos_pallas",)))

    def checker(tag, idle):
        def check(launches, res_g):
            if launches[RECV] <= 0 or any(launches[k] for k in idle):
                fail(f"{tag}: launches {launches}")
        return check

    return [(f"sharded twin {name} S={shards}", argv, (),
             checker(f"sharded twin {name} S={shards}", idle), shards)
            for shards in (2, SHARDS) for name, argv, idle in cases] + [
        (f"sharded twin pushsum S={SHARDS}",
         pushsum_argv(n, seed=1) + ["-backend", "sharded"], (),
         checker(f"sharded twin pushsum S={SHARDS}", ()), SHARDS)]


def phase_sharded(n: int, n_ps: int, n_big: int) -> dict:
    """The seventh slice's path, the sharded backend on SHARDS shards of
    the card (fused_recv_land's parity runs before it, with phase 3: the
    profiler records its device time there): the cuda-vs-cpu twins in the
    worker processes, and meanwhile, in this process, sharded_10m under
    the default gates (fused_recv_land); at SHARDED_GATE_N the default
    gates, -phase2-kernel xla (the decode and ring-append chain: no
    fused_recv_land) and -exchange-pipeline double, which must give one
    transcript (double: the serial run's Stats, history and launches,
    exchange_inflight_hwm 2); PushSum at n_ps (pushsum10m's flags, -backend
    sharded), conserving the mass; and config 5 at n_big under the
    default gates, with wall seconds and peak memory (those walls taken
    beside the busy workers).  Returns the launches of each run."""
    twins = sharded_twins(TWIN_N)
    with worker_pool() as pool:
        futs = [submit_twins(pool, [c[:4]], c[4])[0] for c in twins]
        runs = _sharded_runs(n, n_ps, n_big)
        check_twins([c[:4] for c in twins], futs)
    return runs


def _sharded_runs(n: int, n_ps: int, n_big: int) -> dict:
    """Phase 8's full-size runs (phase_sharded)."""
    from gossip_simulator_tpu_torch.utils.telemetry import GCOL

    runs, outs, done, walls = {}, {}, {}, {}
    out, res, st, runs["sharded_10m"], wall = full_run(
        "sharded_10m", n, sharded_argv(n), shards=SHARDS)
    del st
    if runs["sharded_10m"][RECV] <= 0 or \
            runs["sharded_10m"]["kout_pallas"] <= 0 or \
            res.stats.exchange_overflow:
        fail(f"full sharded_10m: launches {runs['sharded_10m']}, "
             f"exchange_overflow {res.stats.exchange_overflow}")
    _transcript("sharded_10m", out)
    # The gate and schedule twins at SHARDED_GATE_N (the same code paths
    # as sharded_10m's; PERF.md section 4 lists the cut).
    g = SHARDED_GATE_N
    tag = f"sharded_{size_tag(g)}"
    for name, gate, recv_on in ((tag, [], True),
                                (f"{tag}_p2_xla",
                                 ["-phase2-kernel", "xla"], False),
                                (f"{tag}_double",
                                 ["-exchange-pipeline", "double"], True)):
        outs[name], res, st, runs[name], walls[name] = full_run(
            name, g, sharded_argv(g) + gate, shards=SHARDS)
        hist = st._telem.gossip_snapshot()
        done[name] = (res.stats.to_dict(), hist["cols"][:hist["count"]])
        del st
        if (runs[name][RECV] > 0) != recv_on or \
                runs[name]["kout_pallas"] <= 0:
            fail(f"full {name}: launches {runs[name]}")
        if res.stats.exchange_overflow:
            fail(f"full {name}: exchange_overflow "
                 f"{res.stats.exchange_overflow}")
    if len({tuple(_no_notes(t)) for t in outs.values()}) != 1:
        fail(f"full {tag}: default, -phase2-kernel xla and "
             "-exchange-pipeline double transcripts differ")
    # -exchange-pipeline double keeps the serial route: the serial run's
    # Stats, every history column but exchange_inflight_hwm (2, the serial
    # run's 1) and the same launches of every kernel.
    (s_stats, s_cols), (d_stats, d_cols) = (done[tag],
                                            done[f"{tag}_double"])
    hwm = GCOL["exchange_inflight_hwm"]
    keep = [c for c in range(s_cols.shape[1]) if c != hwm]
    serial, piped = runs[tag], runs[f"{tag}_double"]
    if (s_stats != d_stats or s_cols.shape != d_cols.shape
            or not (s_cols[:, keep] == d_cols[:, keep]).all()
            or not (s_cols[:, hwm] == 1).all()
            or not (d_cols[:, hwm] == 2).all()):
        fail(f"full {tag}_double: Stats or history differ from "
             f"{tag}'s")
    if piped != serial:
        fail(f"full {tag}_double: launches {piped} (serial {serial})")
    say(f"full {tag}: default, -phase2-kernel xla and -exchange-"
        "pipeline double transcripts identical; double: Stats and the "
        f"history's columns {tag}'s, exchange_inflight_hwm 2; "
        f"{RECV} {piped[RECV]} launches (serial {serial[RECV]}), "
        f"fused_ring_append {piped['fused_ring_append']} (serial "
        f"{serial['fused_ring_append']}); wall "
        f"{walls[f'{tag}_double']:.3f} s (serial {walls[tag]:.3f} s) "
        f"[{smi_line()}]")
    out, res, st, runs["pushsum10m_sharded"], _ = full_run(
        "pushsum10m_sharded", n_ps,
        pushsum_argv(n_ps) + ["-backend", "sharded"], shards=SHARDS)
    totals = _mass_totals(st.state, st.cfg)
    if (res.stats.mailbox_dropped or res.stats.exchange_overflow
            or totals != st.initial_totals
            or runs["pushsum10m_sharded"][RECV] <= 0):
        fail(f"full pushsum10m_sharded: dropped "
             f"{res.stats.mailbox_dropped}, overflow "
             f"{res.stats.exchange_overflow}, mass {totals} vs "
             f"{st.initial_totals}, launches {runs['pushsum10m_sharded']}")
    say(f"full pushsum10m_sharded: report {res.report}; mass conserved")
    del st
    # The host's share of the receive side: seconds spent inside the
    # fused_recv_land wrapper (its enqueue; the device runs behind).
    from gossip_simulator_tpu_torch.ops import megakernel
    land, spent = megakernel.fused_recv_land, [0.0, 0]

    def timed_land(*a, **kw):
        t0 = time.perf_counter()
        try:
            return land(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t0
            spent[1] += 1

    megakernel.fused_recv_land = timed_land
    big = f"sharded_{n_big // 10**6}m"
    try:
        out, res, st, runs[big], wall = full_run(
            big, n_big, sharded_argv(n_big), shards=SHARDS)
    finally:
        megakernel.fused_recv_land = land
    say(f"host {big}: {spent[0]:.3f} s in {spent[1]} "
        f"{RECV} calls ({1e6 * spent[0] / max(spent[1], 1):.2f} us each)")
    del st
    _transcript(big, out)
    say(f"full {big}: wall {wall:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated()} B")
    return runs


# --- phase 14: the sharded overlays and the sharded ring engine -----------

SHARDED_XLA_N = 1_000_000  # the phase's all-xla gate twins


def sharded_overlay_argv(n: int, seed: int = 0) -> dict:
    """Phase 14's runs at n on the sharded backend: name -> (argv, the
    kernels the run must launch).  The default run (the tick-faithful
    overlay, then the event engine), ring_rounds10m's (the rounds overlay,
    then the ring engine in rounds), ring_kout10m's and pushpull10m's
    (which draws no table and launches no kernel)."""
    base = ["-backend", "sharded", "-n", str(n), "-seed", str(seed)]
    return {
        "sharded_default10m": (base + OVERLAY, (
            "fused_ring_append", "fused_chunk_step", "fused_negotiate",
            RECV)),
        "sharded_ring_rounds10m": (base + ["-time-mode", "rounds", *OVERLAY],
                                   ("fused_chunk_step", "fused_negotiate",
                                    "fused_request_round", DEPOSIT)),
        "sharded_ring_kout10m": (base + ["-engine", "ring", "-graph", "kout",
                                         "-fanout", "6"],
                                 ("kout_pallas", DEPOSIT)),
        "sharded_pushpull10m": (base + ["-protocol", "pushpull", "-graph",
                                        "kout", "-fanout", "23"], ()),
    }


def sharded_overlay_twins(n: int) -> list:
    """cuda-vs-cpu twins of phase 14's paths at n on 2 and SHARDS shards
    (phase 14's four argv at n, seed 1, and the ring engine under the
    churn timeline with healing): (name, argv, patches, check, shards).
    Each launches its run's kernels; push-pull none."""
    cases = [(name.replace("10m", ""), argv, kernels) for name, (
        argv, kernels) in sharded_overlay_argv(n, seed=1).items()]
    cases.append(("sharded_ring_heal", churn_argv(n, *HEAL_ON, *TWIN_MAX)
                  + ["-engine", "ring", *SHARDED_ON], (DEPOSIT,)))

    def checker(tag, kernels):
        def check(launches, res_g):
            if any(launches[k] <= 0 for k in kernels) or (
                    not kernels and any(launches.values())):
                fail(f"{tag}: launches {launches}, expected {kernels}")
        return check

    return [(f"{name} twin S={shards}", argv, (),
             checker(f"{name} twin S={shards}", kernels), shards)
            for shards in (2, SHARDS) for name, argv, kernels in cases]


def phase_sharded_overlay(n: int, n_xla: int, twin_n: int) -> dict:
    """The nineteenth slice's paths, -backend sharded on the overlays and
    the ring engine, SHARDS shards of the card.  In the worker processes,
    sharded_ring_rounds10m and sharded_ring_kout10m (with the spatial
    panels, their identities held every window) at n, ring_rounds10m's
    argv at n_xla under the default gates and all-xla (one transcript, no
    kernel under all-xla), then the cuda-vs-cpu twins at twin_n on 2 and
    SHARDS shards (sharded_overlay_twins, the longest first); beside
    them, in this process, sharded_default10m and sharded_pushpull10m at
    n.  Each run at n under the default gates launches its kernels
    (push-pull none), reaches its target and prints its wall (taken
    beside the others), peak memory, exchange_overflow and launches.
    Returns the launches of each run at n by name."""
    twins = sharded_overlay_twins(twin_n)
    # The longest twins first (the heal and ring runs on SHARDS shards).
    twins.sort(key=lambda c: (c[4] != SHARDS, "heal" not in c[0],
                              "kout" not in c[0]))
    argvs = sharded_overlay_argv(n)
    small, small_kernels = sharded_overlay_argv(n_xla)[
        "sharded_ring_rounds10m"]
    tag = f"sharded_ring_rounds{size_tag(n_xla)}"
    in_workers = {name: argvs[name][0] + (
        spatial_argv(name) if name == "sharded_ring_kout10m" else [])
        for name in ("sharded_ring_rounds10m", "sharded_ring_kout10m")}
    in_workers.update({tag: small, f"{tag}_xla": small + ALL_XLA})
    runs, done = {}, {}
    t0 = time.perf_counter()
    with worker_pool() as pool:
        futs = {name: pool.submit(_card_side, argv, SHARDS)
                for name, argv in in_workers.items()}
        tw = [submit_twins(pool, [c[:4]], c[4])[0] for c in twins]
        for name in ("sharded_default10m", "sharded_pushpull10m"):
            torch.cuda.empty_cache()
            done[name] = _card_side(argvs[name][0], SHARDS)
        check_twins([c[:4] for c in twins], tw)
        done.update({k: f.result() for k, f in futs.items()})
    say(f"sharded_overlay: the {len(twins)} twins, the four runs at n={n} "
        f"and the pair at n={n_xla} side by side took "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (argv, kernels) in argvs.items():
        out, res, got, wall, peak = done[name]
        runs[name] = got
        s = res.stats
        say(f"full {name}: n={n} S={SHARDS} overlay {res.overlay_windows} "
            f"windows ({res.stabilize_ms:g} simulated ms), "
            f"{res.gossip_windows} gossip windows ({res.coverage_ms:g} "
            f"simulated ms); wall {wall:.3f} s (beside the others); peak "
            f"{peak} B; total_message {s.total_message}; coverage "
            f"{s.coverage:.6f}; exchange_overflow {s.exchange_overflow}; "
            f"mailbox_dropped {s.mailbox_dropped}; launches {got}")
        if not res.converged:
            fail(f"full {name}: did not converge:\n{out}")
        if any(got[k] <= 0 for k in kernels) or (
                not kernels and any(got.values())):
            fail(f"full {name}: launches {got}, expected {kernels}")
    spatial_check("sharded_ring_kout10m",
                  f"{SPATIAL_DIR}/sharded_ring_kout10m")
    (out_d, res_d, got, wall_d, _), (out_x, res_x, got_x, wall_x, _) = (
        done[tag], done[f"{tag}_xla"])
    if not (res_d.converged and res_x.converged) or \
            _no_notes(out_d) != _no_notes(out_x):
        fail(f"full {tag}: default and all-xla transcripts differ (or a "
             "run did not converge)")
    if any(got[k] <= 0 for k in small_kernels) or any(gated(got_x).values()):
        fail(f"full {tag}: launches {got} (all-xla {got_x})")
    say(f"full {tag}: default and all-xla transcripts identical; all-xla "
        f"launched no kernel; walls {wall_d:.3f} and {wall_x:.3f} s (beside "
        f"the others); launches {got}")
    return runs


def _dev_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _device_events(ka) -> list:
    """The device-side events of a profiler's key averages (an aten op's
    row repeats its kernels' time)."""
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in ka
            if getattr(e, "device_type", None) == cuda and _dev_us(e) > 0]
    if not kern:  # builds whose averages carry no device type
        kern = [e for e in ka
                if _dev_us(e) > 0 and not e.key.startswith("aten::")]
    return kern


PROFILE_KERNELS = (
    ("fused_emit", ("emit",)),
    ("fused_unique_set", ("unique_set_kernel",)),
    ("fused_ring_append", ("ring_append",)),
    ("fused_chunk_step", ("radix_hist", "radix_scan", "radix_scatter",
                          "chunk_write", "chunk_count", "scan_tiles",
                          "scan_sums", "scan_apply", "spill_write",
                          "spill_finish")),
    ("fused_negotiate", ("negotiate",)),
    ("fused_request_round", ("request_round",)),
    ("fused_hosted_chunk", ("occupancy",)),
    ("fused_deposit_add", ("deposit_add", "part_list", "part_apply")),
    ("fused_deposit_rows", ("deposit_rows",)),
    ("fused_deposit_both", ("deposit_both",)),
    (DRAIN, ("drain_sum", "part_hist", "part_scan", "part_scatter",
             "tile_accum")),
    (RECV, ("recv_land",)),
    ("kout_pallas", ("kout",)),
    ("erdos_pallas", ("erdos",)))


PROFILE_RUNS = {
    "default": lambda n: ["-n", str(n), "-seed", "0", *OVERLAY],
    "ring_rounds": lambda n: ["-time-mode", "rounds", "-n", str(n), "-seed",
                              "0", *OVERLAY],
    "ring_kout": lambda n: ["-engine", "ring", "-graph", "kout", "-fanout",
                            "6", "-n", str(n), "-seed", "0"],
    "pushpull": lambda n: ["-protocol", "pushpull", "-graph", "kout",
                           "-fanout", "23", "-n", str(n), "-seed", "0"],
    "rumors": lambda n: ["-engine", "ring", "-graph", "kout", "-fanout", "6",
                         "-n", str(n), "-seed", "0", "-rumors", "16",
                         "-crashrate", "0", "-coverage-target", "0.95"],
    "pushsum": pushsum_argv,
    "sharded": sharded_argv,
    "erdos": lambda n: ["-graph", "erdos", "-n", str(n), "-fanout", "8",
                        "-protocol", "sir", "-removal-rate", "0.2",
                        "-coverage-target", "0.8", "-seed", "0"],
}


def phase_profile(n: int, out_path: str, run: str = "default") -> None:
    """One full-size run (`run` of PROFILE_RUNS) under torch.profiler:
    device busy share and the kernels that take the device time, by name
    (table written to `out_path`)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from gossip_simulator_tpu_torch.ops import _build

    argv = PROFILE_RUNS[run](n) + ["-quiet"]
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, res, _, wall = run_port(
            argv, "cuda", shards=SHARDS if run == "sharded" else None)
    launches = dict(_build.LAUNCHES)
    ka = prof.key_averages()
    kern = _device_events(ka)
    busy_us = sum(_dev_us(e) for e in kern)
    kern.sort(key=_dev_us, reverse=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    say(f"profile: {run} n={n} wall {wall:.3f} s under the profiler, device "
        f"busy {busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}% of "
        f"wall), {res.overlay_windows} overlay + {res.gossip_windows} gossip "
        f"windows; table in {out_path}")
    say(f"profile: {sum(e.count for e in kern)} device events")
    for e in kern[:12]:
        say(f"profile:   {_dev_us(e) / 1e3:10.3f} ms  {e.count:7d}x  "
            f"{e.key[:110]}")
    for name, keys in PROFILE_KERNELS:
        evs = [e for e in kern if any(k in e.key for k in keys)]
        calls = launches[name]
        if evs and calls:
            us = sum(map(_dev_us, evs))
            say(f"profile: {name} device time {us / 1e3:.3f} ms over "
                f"{calls} launches ({us / calls:.2f} us per launch)")


PHASES = ("parity", "twins", "full", "rounds", "ring", "pushsum", "graphs",
          "sharded", "faults", "rumors_event", "sharded_faults", "telemetry",
          "checkpoint", "sharded_overlay")


# The launch counts of a kernel's forms (ops/_build.py FORMS).
FORMS = (SPILL, DEPOSIT_DENSE, PMASK, WORDS, UNIQUE_WORDS)


def kernel_rows(kernels: dict, runs: dict) -> list:
    """The `kernels` line: each row's launches summed over the full-size
    runs (every run starts from counts of 0), with the runs that launched
    it; the fused_chunk_step row carries its spill form's columns too."""
    rows = []
    for name, row in kernels.items():
        by_run = {run: c[name] for run, c in runs.items() if c.get(name)}
        out = {"name": name, "route": row["route"], "source": row["source"],
               "replaces": row["replaces"], "launches": sum(by_run.values()),
               "launches_by_run": by_run,
               "max_abs_err": max(v for k, v in row.items()
                                  if k.endswith("max_abs_err")),
               "ms": row["ms"], "plain_ms": row["plain_ms"],
               "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
               "library_ms": row["library_ms"], "parity": "bit-exact"}
        if "spill_ms" in row:
            out["spill_launches"] = sum(c.get(SPILL, 0)
                                        for c in runs.values())
        # Each counted form's launches by run (fused_deposit_add's dense
        # form, fused_emit's mask and words, fused_unique_set's words).
        for form in (f for f in FORMS if f.split(":")[0] == name):
            out[form.split(":")[1] + "_launches_by_run"] = {
                run: c[form] for run, c in runs.items() if c.get(form)}
        if name == DEPOSIT:
            out["dense_overflow_by_run"] = dict(DEPOSIT_OVERFLOW)
        # Device ms per call of each case of phase 3 (torch.profiler).
        out["device_ms"] = {lbl: round(ms, 5) for lbl, ms in DEVICE.items()
                            if lbl.split("[")[0] == name}
        # The other forms' and shapes' columns (spill_*, wide_*,
        # pushsum_*), as measured.
        out.update({k: v for k, v in row.items()
                    if k not in out and not k.endswith("max_abs_err")
                    and k not in ("route", "source", "replaces")})
        rows.append(out)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="",
                    help="also profile a full-size run and write "
                         "the kernel table to this path")
    ap.add_argument("--profile-n", type=int, default=FULL_N,
                    help="n of the profiled run (default %(default)s)")
    ap.add_argument("--profile-run", default="default",
                    choices=sorted(PROFILE_RUNS),
                    help="which run to profile (default %(default)s)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases after the build (default: "
                         "all of %(default)s); a partial run's last line "
                         "names its phases")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        ap.error(f"--phases takes a subset of {PHASES}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one NVIDIA H100", file=sys.stderr)
        return 1
    try:
        from gossip_simulator_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: gossip_simulator_tpu_torch is not importable "
              f"({e}); run from the root of the repository",
              file=sys.stderr)
        return 1

    # 1. card
    smi = smi_line()
    say(f"card: {smi}")
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.device_count()} device(s)")
    if cap[0] != 9:
        fail(f"capability {cap} is not 9.x (Hopper)")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    say(f"build: {len(_build.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.2f} s ({_build.BUILD_DIR})")
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:
        """Print the seconds since the last lap: where the script's time
        goes, phase by phase."""
        now = time.perf_counter()
        say(f"time {name}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    # 3. parity (and phase 8's, before any full-size run)
    kernels = phase_parity(dev, REPS) if "parity" in phases else {}
    if "sharded" in phases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        kernels[RECV] = recv_parity(dev, gen, REPS)
    if "sharded_faults" in phases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(19)
        cols = recv_word_parity(dev, gen, REPS)
        kernels.setdefault(RECV, dict(
            route="cuda",
            source="gossip_simulator_tpu_torch/csrc/fused_recv_land.cu",
            replaces="gossip_simulator_tpu/ops/pallas_megakernel.py:328",
            max_abs_err=cols["rumor_w1_max_abs_err"],
            ms=cols["rumor_w1_ms"], plain_ms=cols["rumor_w1_plain_ms"],
            bound_ms=cols["rumor_w1_bound_ms"],
            bound_by=cols["rumor_w1_bound_by"],
            library_ms=None)).update(cols)
    if "parity" in phases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)
        for name, cols in fault_parity(dev, gen, REPS).items():
            if name in kernels:
                kernels[name].update(cols)
    if "rumors_event" in phases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(17)
        for name, cols in rumor_parity(dev, gen, REPS).items():
            kernels.setdefault(name, rumor_row(name, cols)).update(cols)
    lap("parity")

    # 4. twins (beside phase 10's 5e7 run when both phases run)
    later_twins = []
    if "twins" in phases and "rumors_event" in phases:
        later_twins = twin_cases(TWIN_N)
        say(f"twins: {len(later_twins)} twins run in phase 10's workers, "
            "beside multirumor50m_r16")
    elif "twins" in phases:
        phase_twins(TWIN_N)
        lap("twins")

    # 5. full size: the kout and default runs, then the rounds overlay
    runs = {}
    for name, phase in (
            ("full", lambda: phase_full(FULL_N)),
            ("rounds", lambda: phase_rounds(FULL_N, SPLIT_RUN_N,
                                            TWIN_LIMIT_S)),
            ("ring", lambda: phase_ring(RING_N, RUMOR_N)),
            ("pushsum", lambda: phase_pushsum(PUSHSUM_N)),
            ("graphs", lambda: phase_graphs(KOUT_N, ERDOS_N,
                                            ERDOS_WIDE_N)),
            ("sharded", lambda: phase_sharded(SHARDED_N, PUSHSUM_N,
                                              SHARDED_BIG_N)),
            ("faults", lambda: phase_faults(FULL_N, FAULT_PAIR_N,
                                            TWIN_N)),
            ("rumors_event", lambda: phase_rumors_event(
                RUMOR_FAMILY_N, RUMOR_BIG_N, TWIN_N, later_twins)),
            ("sharded_faults", lambda: phase_sharded_faults(
                FULL_N, RUMOR_FAMILY_N, TWIN_N)),
            ("telemetry", lambda: phase_telemetry(
                FULL_N, TELEMETRY_N,
                CKPT_A if "checkpoint" in phases else ())),
            ("checkpoint", lambda: phase_checkpoint(FULL_N, CKPT_P1_N)),
            ("sharded_overlay", lambda: phase_sharded_overlay(
                FULL_N, SHARDED_XLA_N, TWIN_N))):
        if name in phases:
            runs.update(phase())
            lap(name)
    say(f"full-size runs: {', '.join(runs)} ({time.perf_counter() - t0:.1f} "
        "s since the build started)")
    say(f"time total: {time.perf_counter() - t_start:.1f} s (the script "
        "from its start, the build included)")

    if args.profile:
        phase_profile(args.profile_n, args.profile, args.profile_run)

    # 6. kernels line, card line, result line
    if kernels:
        missing = [k for k in kernels if not any(
            c.get(k) for c in runs.values())] if len(phases) == len(
                PHASES) else []
        if missing:
            fail(f"kernels never launched on a full-size path: {missing}")
        say(json.dumps({"kernels": kernel_rows(kernels, runs)}))
    say(smi)
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if len(phases) != len(PHASES):
        result["phases"] = phases
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
