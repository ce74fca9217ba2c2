"""H100 machine model for the execution simulator: nodes of 8 GPUs.

Counterpart of the JAX package's ``simulator/machine.py`` (reference:
src/runtime/simulator.cu:21-74, per-GPU compute devices plus comm devices
with hardcoded bandwidths).  A node holds 8 GPUs behind NVSwitch: every
pair of GPUs of a node is one hop apart at NVLink4's per-direction rate,
so a transfer costs ``bytes / nvlink_bandwidth`` whatever the pair, and a
gradient all-reduce is a ring over NVLink, ``2(n-1)/n * bytes / bw``.
Nodes are joined by InfiniBand: each GPU has its own ConnectX-7 NDR port,
400 Gb/s (``ib_bandwidth`` 50 GB/s per direction, the spec sheet's rate),
so a transfer between two nodes and a ring that crosses nodes run at that
rate instead.

The roofline constants default to the H100 SXM data sheet (bf16 dense
989 TFLOP/s, HBM3 3.35 TB/s, 80 GB).  The link bandwidths are spec-sheet
inputs too, never measurements: a one-card machine has no link to time.
``H100MachineModel.calibrated()`` overrides the roofline constants with
``machine_h100.json`` beside this module when a calibration run on a
card (``tools/calibrate.py``) has written one; that file names the card
and its power limit.  Without it the model says "unfitted".

``dcn_spill_time`` prices what a config pays per step when a non-sample
dim of it lands on the ``dcn`` mesh dim of the hybrid nodes x GPUs mesh
(``parallel/distributed.hybrid_machine``): its part's bytes resharded
across nodes, the JAX package's formula (machine.py:131-167 there) at the
InfiniBand rate.  The lowering is the runtime's own
(``parallel/mesh.assign_axes``, role-aware as the JAX package's): the
batch takes ``dcn`` first, and a weight or activation split spills onto
``dcn`` only when its degree cannot be composed from a node's GPUs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

from ..parallel.mesh import assign_axes, hybrid_mesh_shape

# Roofline constants fitted to measurements on a card by tools/calibrate.py.
CALIBRATION_PATH = os.path.join(os.path.dirname(__file__), "machine_h100.json")

GPUS_PER_NODE = 8


@dataclasses.dataclass
class H100MachineModel:
    num_devices: int = 8
    peak_flops: float = 989e12          # bf16 dense tensor cores (spec)
    hbm_bandwidth: float = 3.35e12      # bytes/s, HBM3 (spec)
    nvlink_bandwidth: float = 450e9     # bytes/s per direction, NVLink4 (spec)
    ib_bandwidth: float = 50e9          # bytes/s per GPU, ConnectX-7 NDR 400 Gb/s (spec)
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
        if self.num_devices > GPUS_PER_NODE and self.num_devices % GPUS_PER_NODE:
            raise ValueError(f"{self.num_devices} GPUs do not fill whole nodes of "
                             f"{GPUS_PER_NODE}")
        # degrees -> dcn_spill result; the search asks again and again
        self._spill_cache: Dict[Tuple[int, ...], Tuple[Tuple[int, int], ...]] = {}

    @property
    def num_nodes(self) -> int:
        return max(1, -(-self.num_devices // GPUS_PER_NODE))

    def same_node(self, a: int, b: int) -> bool:
        return a // GPUS_PER_NODE == b // GPUS_PER_NODE

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
        """Point-to-point transfer in seconds: one NVSwitch hop within a
        node, the InfiniBand rate between nodes."""
        if a == b or num_bytes <= 0:
            return 0.0
        bw = self.nvlink_bandwidth if self.same_node(a, b) else self.ib_bandwidth
        return num_bytes / bw

    def allreduce_time(self, devices, num_bytes: float) -> float:
        """Ring all-reduce: 2(n-1)/n * bytes / bw (what NCCL's ring moves
        per GPU), over NVLink within a node and at the InfiniBand rate when
        the ring crosses nodes."""
        devices = list(devices)
        n = len(set(devices))
        if n <= 1 or num_bytes <= 0:
            return 0.0
        bw = self.nvlink_bandwidth
        if not all(self.same_node(devices[0], d) for d in devices):
            bw = self.ib_bandwidth
        return 2.0 * (n - 1) / n * num_bytes / bw

    def dcn_spill(self, degrees) -> Tuple[Tuple[int, int], ...]:
        """``((dim, dcn share), ...)``: the non-sample dims of a degree
        vector that land on the hybrid mesh's ``dcn`` dim (empty on one
        node, or when every non-sample degree fits the GPUs of a node)."""
        if self.num_nodes <= 1:
            return ()
        key = tuple(degrees)
        hit = self._spill_cache.get(key)
        if hit is None:
            sizes, names = hybrid_mesh_shape(self.num_devices, self.num_nodes)
            try:
                _, hit = assign_axes(names, sizes, key)
            except ValueError:
                hit = ()  # inexpressible degrees never run (legalize_pc first)
            self._spill_cache[key] = hit
        return hit

    def dcn_spill_time(self, degrees, part_bytes: float) -> float:
        """Seconds a step pays because a non-sample dim crossed nodes: each
        spilled dim reshards the part's bytes over the ``dcn`` dim (ring
        factor) at the InfiniBand rate; 0 on one node."""
        t = 0.0
        for _dim, share in self.dcn_spill(degrees):
            t += 2.0 * (share - 1) / share * part_bytes / self.ib_bandwidth
        return t

