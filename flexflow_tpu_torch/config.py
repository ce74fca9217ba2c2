"""Configuration and parallelization-config types (PyTorch port).

Counterpart of ``flexflow_tpu/config.py``: the same ``FFConfig`` field
names and CLI flag spellings, plus ``device``, the ``torch.device`` the
model runs on.  ``device`` defaults to ``"cuda"``; the CPU is used only
when the caller asks for it (``FFConfig(device="cpu")`` or
``--device cpu``), never as a silent fallback.

``workers_per_node`` left at 0 means every device of the machine that
``FFModel.compile`` runs on (every rank of the process group, or one
device when there is none); a count set by the caller must match that
machine.  Strategy files are read and written by ``parallel/strategy.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
from typing import Dict, List, Optional, Sequence, Tuple

MAX_DIM = 4


class DeviceType(enum.Enum):
    """Device kind an op is placed on.  Wire value 0 means "the
    accelerator" in strategy files of either package."""

    GPU = 0
    CPU = 1

    # Alias used when reading strategy files written for a TPU.
    TPU = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Per-op SOAP partition config (reference: include/config.h:42-51).

    ``dims`` holds the partition degree of each dimension of the op's
    output tensor, batch first (image tensors are NHWC)."""

    device_type: DeviceType = DeviceType.GPU
    dims: Tuple[int, ...] = (1,)
    device_ids: Tuple[int, ...] = ()
    memory_types: Tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.dims) == 0 or len(self.dims) > MAX_DIM:
            raise ValueError(f"ParallelConfig dims must have 1..{MAX_DIM} entries, got {self.dims}")
        if any(d < 1 for d in self.dims):
            raise ValueError(f"partition degrees must be >= 1, got {self.dims}")

    @classmethod
    def host_rowsparse(cls, ndims: int = 2) -> "ParallelConfig":
        """Host placement for an embedding table (the hetero DLRM
        strategies' CPU + zero-copy memory, dlrm_strategy_hetero.cc:28-35):
        the runtime's row-sparse host-resident path.  ``ndims`` is the
        rank of the embedding's output (a rank-mismatched entry is ignored
        by ``find_parallel_config``)."""
        return cls(DeviceType.CPU, (1,) * max(2, int(ndims)), (0,), ("host", "host", "host"))

    @property
    def host_placed(self) -> bool:
        """A CPU device type or a "host" memory type: weights that live on
        the host (runtime/host_tables.py)."""
        return self.device_type == DeviceType.CPU or "host" in self.memory_types

    @property
    def ndims(self) -> int:
        return len(self.dims)

    def with_device_ids(self, ids: Sequence[int]) -> "ParallelConfig":
        return dataclasses.replace(self, device_ids=tuple(ids))

    def num_parts(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @staticmethod
    def data_parallel(ndims: int, num_devices: int) -> "ParallelConfig":
        """Default data-parallel config: split the batch (first) dim only."""
        dims = (num_devices,) + (1,) * (ndims - 1)
        return ParallelConfig(DeviceType.GPU, dims, tuple(range(num_devices)))


@dataclasses.dataclass
class FFConfig:
    """Run-level configuration (reference: include/config.h:66-103).

    Fields outside the ported slice keep their names so that scripts
    written for the JAX package parse; ``FFModel.compile`` raises
    ``NotImplementedError`` for any of them that is set."""

    epochs: int = 1
    batch_size: int = 64
    iterations: int = -1
    print_freq: int = 10
    num_nodes: int = 1
    workers_per_node: int = 0  # 0: every device of the compiled machine
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    synthetic_input: bool = False
    profiling: bool = False
    search_budget: int = 0
    search_alpha: float = 0.05
    search_overlap_backward_update: bool = False
    search_engine: str = ""
    search_pipeline: bool = False
    grad_accum_steps: int = 1
    remat: bool = False
    dataset_path: str = ""
    import_strategy_file: str = ""
    import_strategy_reference_order: bool = False
    export_strategy_file: str = ""
    seed: int = 0
    # Activations run in compute_dtype; parameters stay float32.
    compute_dtype: str = "float32"
    # Route optimizer updates through the hand-written CUDA kernels
    # (kernels/fused_optimizer.py).
    fused_optimizer: bool = False
    zero_optimizer: bool = False
    sparse_host_embeddings: Optional[bool] = None
    lowered: Optional[bool] = None
    telemetry: bool = False
    telemetry_file: str = ""
    strategies: Dict[str, ParallelConfig] = dataclasses.field(default_factory=dict)
    device: str = "cuda"

    @property
    def num_devices(self) -> int:
        """The device count the caller asked for; 0 when
        ``workers_per_node`` is left at 0 (every device of the machine)."""
        return self.num_nodes * self.workers_per_node

    def parse_args(self, argv: Optional[List[str]] = None) -> List[str]:
        """Parse reference-style CLI flags; returns unrecognized args."""
        argv = list(sys.argv[1:] if argv is None else argv)
        rest: List[str] = []
        i = 0

        def take() -> str:
            nonlocal i
            i += 1
            return argv[i]

        while i < len(argv):
            a = argv[i]
            if a in ("-e", "--epochs"):
                self.epochs = int(take())
            elif a in ("-b", "--batch-size"):
                self.batch_size = int(take())
            elif a in ("--lr", "--learning-rate"):
                self.learning_rate = float(take())
            elif a in ("--wd", "--weight-decay"):
                self.weight_decay = float(take())
            elif a in ("--iterations",):
                self.iterations = int(take())
            elif a in ("--budget", "--search-budget"):
                self.search_budget = int(take())
            elif a in ("--alpha", "--search-alpha"):
                self.search_alpha = float(take())
            elif a in ("--overlap",):
                self.search_overlap_backward_update = True
            elif a in ("--import", "--import-strategy"):
                self.import_strategy_file = take()
            elif a in ("--import-reference-order",):
                self.import_strategy_reference_order = True
            elif a in ("--export", "--export-strategy"):
                self.export_strategy_file = take()
            elif a in ("--dataset", "-d"):
                self.dataset_path = take()
            elif a in ("--synthetic",):
                self.synthetic_input = True
            elif a in ("--profiling",):
                self.profiling = True
            elif a in ("--nodes",):
                self.num_nodes = int(take())
            elif a in ("-ll:tpu", "-ll:gpu"):
                self.workers_per_node = int(take())
            elif a in ("-ll:cpu", "-ll:util", "-ll:py", "-ll:fsize", "-ll:zsize", "-lg:prof"):
                take()  # accepted for compatibility with reference scripts
            elif a == "--seed":
                self.seed = int(take())
            elif a == "--bf16":
                self.compute_dtype = "bfloat16"
            elif a == "--fused-optimizer":
                self.fused_optimizer = True
            elif a == "--zero-optimizer":
                self.zero_optimizer = True
            elif a == "--search-pipeline":
                self.search_pipeline = True
            elif a == "--search-engine":
                self.search_engine = take()
            elif a == "--grad-accum":
                self.grad_accum_steps = int(take())
            elif a == "--remat":
                self.remat = True
            elif a == "--sparse-host-embeddings":
                self.sparse_host_embeddings = True
            elif a == "--no-sparse-host-embeddings":
                self.sparse_host_embeddings = False
            elif a == "--lowered":
                self.lowered = True
            elif a == "--no-lowered":
                self.lowered = False
            elif a == "--telemetry":
                self.telemetry = True
            elif a == "--telemetry-file":
                self.telemetry = True
                self.telemetry_file = take()
            elif a == "--device":
                self.device = take()
            else:
                rest.append(a)
            i += 1
        return rest

    def find_parallel_config(self, ndims: int, pcname: str,
                             num_devices: int) -> ParallelConfig:
        """Look up an op's config, falling back to data parallelism over
        the machine's ``num_devices``.  A rank-mismatched entry degrades to
        data parallelism too (the reference asserts; strategy.cc:28-85)."""
        pc = self.strategies.get(pcname)
        if pc is not None and pc.ndims == ndims:
            return pc
        return ParallelConfig.data_parallel(ndims, num_devices)
