"""The JAX package's CLI run inside the test process, for the port's CLI
twins: what ``python -m gossip_simulator_tpu ARGV`` prints, without a
subprocess (no second jax start-up, no recompile of a program the
process has already compiled, no extra process competing for the cores).

``jax_cli(argv)`` does what the JAX package's ``cli.main`` does for a
single-process run on the CPU platform (set up by the suite's
conftest): parse, name the deliver-kernel fallback on stderr, call
``run_simulation`` with a progress printer (and the ``-log-jsonl``
file), and return (exit code, stdout, stderr), stderr followed by the
text of every warning the run raised.  It installs no signal handlers
(``cli.main`` does)."""

import contextlib
import io
import sys
import warnings

from gossip_simulator_tpu.config import parse_args
from gossip_simulator_tpu.driver import run_simulation
from gossip_simulator_tpu.utils.metrics import ProgressPrinter


def jax_cli(argv):
    cfg = parse_args(list(argv))
    out, err = io.StringIO(), io.StringIO()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        warnings.simplefilter("always")
        why = cfg.deliver_kernel_fallback_reason
        if why and cfg.progress:
            print(f"deliver-kernel auto -> xla: {why}", file=sys.stderr)
        with ProgressPrinter(enabled=cfg.progress,
                             jsonl_path=cfg.log_jsonl_resolved or None
                             ) as printer:
            res = run_simulation(cfg, printer=printer)
    text = err.getvalue() + "".join(f"{w.category.__name__}: {w.message}\n"
                                    for w in caught)
    return (0 if res.converged else 2), out.getvalue(), text
