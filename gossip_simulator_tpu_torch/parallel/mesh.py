"""The node-axis mesh: S shards laid out on one device.

The JAX package shards the node axis over a 1-D mesh of devices and runs
each window as one ``shard_map`` program whose collectives ride the
interconnect (``parallel/mesh.py`` there).  The port keeps every shard on
the stepper's one device, as a list of per-shard states run in lockstep:
a shard-map body becomes a loop over the shards that breaks at every
collective, and each collective is a tensor operation over the list.

* ``all_to_all`` of per-shard ``(S, cap)`` buckets is a transpose of the
  list: shard d receives source 0's bucket for d, then source 1's, and
  so on (``parallel/exchange.py``).  That order is part of the
  trajectory: the drain's crash draws are keyed by ring position.
* ``psum`` and ``pmax`` are sums and maxima over the list (``psum``,
  ``pmax`` below); a pmax-agreed loop count is one host read.
* ``all_gather`` (tiled) is a concatenation of the shards' leaves in
  shard order (the heal's peer bits and rumor words).
* ``axis_index`` is the shard's position in the loop.

Every engine and both overlays run on this layout (the event engine,
PushSum, the ring engine, the tick-faithful and the rounds overlay).
Multi-process and multi-device layouts (``torch.distributed``) are not
yet ported (ROADMAP A13, A14).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shards of the node axis on one device."""

    n_shards: int
    device: torch.device


def node_mesh(n_devices: int | None = None, device="cpu") -> Mesh:
    """A mesh of `n_devices` shards on `device` (None: one shard per
    device the stepper uses, so 1)."""
    s = 1 if n_devices is None else int(n_devices)
    if s < 1:
        raise ValueError(f"need {n_devices} devices: a mesh has at least "
                         "one shard")
    return Mesh(s, torch.device(device))


def shard_size(n: int, mesh: Mesh) -> int:
    s = mesh.n_shards
    if n % s:
        raise ValueError(
            f"n ({n}) must be divisible by the mesh size ({s}); "
            f"pad n or change the device count")
    return n // s


def psum(xs) -> torch.Tensor:
    """Sum of one 0-d (or same-shape) tensor per shard."""
    return torch.stack(list(xs)).sum(dim=0)


def pmax(xs) -> torch.Tensor:
    """Maximum of one 0-d (or same-shape) tensor per shard."""
    return torch.stack(list(xs)).amax(dim=0)
