"""CLI entry point, flag-compatible with the JAX package's
(``python -m gossip_simulator_tpu_torch -graph kout -n 10000000 -fanout 6``),
plus ``-device {cuda,cpu}`` (default cuda).  Exit code 0 on convergence,
2 otherwise (an interrupted run too), 1 when the requested device does
not exist."""

from __future__ import annotations

import sys
from typing import Optional

from gossip_simulator_tpu_torch.backends import (DeviceUnavailable,
                                                 resolve_device)
from gossip_simulator_tpu_torch.config import parse_cli
from gossip_simulator_tpu_torch.driver import run_simulation
from gossip_simulator_tpu_torch.utils import lifecycle
from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter


def main(argv: Optional[list[str]] = None) -> int:
    cfg, device = parse_cli(argv)
    # The first SIGTERM or SIGINT ends the run at a window boundary, with
    # a final snapshot under -checkpoint-dir and exit 2; a second kills.
    lifecycle.install_signal_handlers()
    try:
        resolve_device(device)
    except DeviceUnavailable as e:
        print(f"gossip_simulator_tpu_torch: {e}", file=sys.stderr)
        return 1
    # Context-managed, so a run that raises still flushes its JSONL log.
    with ProgressPrinter(enabled=cfg.progress,
                         jsonl_path=cfg.log_jsonl_resolved or None
                         ) as printer:
        result = run_simulation(cfg, printer=printer, device=device)
    return 0 if result.converged else 2


if __name__ == "__main__":
    sys.exit(main())
