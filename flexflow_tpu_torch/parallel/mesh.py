"""The machine: one device (PyTorch port of ``flexflow_tpu/parallel/mesh.py``).

This slice runs on a single device.  A ``Machine`` of more than one
device raises until multi-GPU SOAP execution lands (ROADMAP A6).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class Machine:
    def __init__(self, devices: Optional[Sequence[torch.device]] = None,
                 num_devices: Optional[int] = None):
        if devices is None:
            devices = [torch.device("cuda", 0)]
        devices = [torch.device(d) for d in devices]
        if len(devices) != 1 or (num_devices is not None and num_devices != 1):
            raise NotImplementedError(
                "the port runs on one device; multi-GPU SOAP execution is "
                "ROADMAP A6")
        self.devices = devices

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def num_devices(self) -> int:
        return 1

    def __repr__(self):
        return f"Machine({self.device})"
