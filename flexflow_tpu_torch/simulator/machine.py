"""H100 node model for the execution simulator.

Counterpart of the JAX package's ``simulator/machine.py`` (reference:
src/runtime/simulator.cu:21-74, per-GPU compute devices plus comm devices
with hardcoded bandwidths).  One node holds up to 8 GPUs behind NVSwitch:
every pair of GPUs is one hop apart at NVLink4's per-direction rate, so a
transfer costs ``bytes / nvlink_bandwidth`` whatever the pair, and a
gradient all-reduce is a ring over NVLink, ``2(n-1)/n * bytes / bw``.

The roofline constants default to the H100 SXM data sheet (bf16 dense
989 TFLOP/s, HBM3 3.35 TB/s, 80 GB).  The link bandwidth is a spec-sheet
input too, never a measurement: a one-card machine has no link to time.
``H100MachineModel.calibrated()`` overrides the roofline constants with
``machine_h100.json`` beside this module when a calibration run on a
card (``tools/calibrate.py``) has written one; that file names the card
and its power limit.  Without it the model says "unfitted".

Multi-node machines (InfiniBand between nodes) are not modelled yet:
they come with ``hybrid_machine`` (ROADMAP A6).  ``dcn_spill_time`` is
kept, as 0 on one node, so that the cost model and the simulator call the
same methods on this model as on the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

# Roofline constants fitted to measurements on a card by tools/calibrate.py.
CALIBRATION_PATH = os.path.join(os.path.dirname(__file__), "machine_h100.json")

GPUS_PER_NODE = 8


@dataclasses.dataclass
class H100MachineModel:
    num_devices: int = 8
    peak_flops: float = 989e12          # bf16 dense tensor cores (spec)
    hbm_bandwidth: float = 3.35e12      # bytes/s, HBM3 (spec)
    nvlink_bandwidth: float = 450e9     # bytes/s per direction, NVLink4 (spec)
    kernel_launch_overhead: float = 4e-6  # s per op task (unfitted guess)
    matmul_efficiency: float = 0.6      # achievable share of peak for convs/matmuls
    backward_multiplier: float = 2.0    # bwd ~ dgrad + wgrad vs one fwd
    hbm_capacity: float = 80e9          # bytes per GPU
    # the host side of host-resident tables (the pipeline search's
    # heterogeneous head): PCIe Gen5 x16 per direction (spec) and the
    # host's DDR gather rate (an unfitted guess, the JAX package's)
    pcie_bandwidth: float = 64e9
    host_memory_bandwidth: float = 100e9
    host_xfer_latency: float = 0.0
    # Per-op-family overrides fitted by tools/calibrate.py (families absent
    # here use the global constants above).
    op_efficiency: Dict[str, float] = dataclasses.field(default_factory=dict)
    op_backward_multiplier: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Where the constants come from: "spec (unfitted)" or the fit's card.
    source: str = "spec (unfitted)"

    def __post_init__(self):
        if self.num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {self.num_devices}")
        if self.num_devices > GPUS_PER_NODE:
            raise NotImplementedError(
                f"{self.num_devices} GPUs span more than one node of {GPUS_PER_NODE}: "
                "multi-node machines come with hybrid_machine (ROADMAP A6)")

    @classmethod
    def calibrated(cls, path: Optional[str] = None, **kw) -> "H100MachineModel":
        """The model with roofline constants from ``machine_h100.json`` (or
        ``path``) where it exists; explicit kwargs win.  The file's
        ``device`` and ``power_limit`` entries label the fit."""
        path = CALIBRATION_PATH if path is None else path
        if os.path.exists(path):
            try:
                with open(path) as f:
                    fit = json.load(f)
            except (OSError, ValueError):
                fit = {}
            names = {f.name for f in dataclasses.fields(cls)}
            for k, v in fit.items():
                if k in names and k not in kw:
                    kw[k] = v
            if fit and "source" not in kw:
                kw["source"] = (f"fitted on {fit.get('device', 'an unnamed card')}, "
                                f"power limit {fit.get('power_limit', 'unknown')}")
        return cls(**kw)

    @property
    def fitted(self) -> bool:
        return self.source.startswith("fitted")

    def transfer_time(self, a: int, b: int, num_bytes: float) -> float:
        """Point-to-point transfer in seconds: one NVSwitch hop."""
        if a == b or num_bytes <= 0:
            return 0.0
        return num_bytes / self.nvlink_bandwidth

    def allreduce_time(self, devices, num_bytes: float) -> float:
        """Ring all-reduce over NVLink: 2(n-1)/n * bytes / bw (what NCCL's
        ring moves per GPU)."""
        n = len(set(devices))
        if n <= 1 or num_bytes <= 0:
            return 0.0
        return 2.0 * (n - 1) / n * num_bytes / self.nvlink_bandwidth

    def dcn_spill_time(self, degrees, part_bytes: float) -> float:
        """Inter-node resharding a config pays per step: none on one node."""
        return 0.0
