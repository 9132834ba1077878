"""Backend registry: the single-device torch stepper and the sharded
one."""

from gossip_simulator_tpu_torch.backends.base import Stepper, WINDOW_MS
from gossip_simulator_tpu_torch.backends.torch_backend import (
    DeviceUnavailable, TorchStepper, resolve_device)
from gossip_simulator_tpu_torch.backends.sharded import ShardedStepper

__all__ = ["Stepper", "WINDOW_MS", "TorchStepper", "ShardedStepper",
           "DeviceUnavailable", "resolve_device"]
