"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX one, with the same module names and
public surface: graph build -> ``compile`` -> ``init_layers`` ->
``train_iteration``.  It imports torch and numpy, never jax and nothing
of ``flexflow_tpu``.  Models run on CUDA unless ``FFConfig.device`` asks
for the CPU; over several processes (``parallel.distributed``, one per
device) they train under per-op SOAP configs on a ``DeviceMesh``, an
attention op's sequence split running as ring or Ulysses attention
(``parallel/sequence.py``).  The optimizer updates and attention (forward and backward) on
the training path are hand-written CUDA kernels for Hopper
(``kernels/``); conv, pool, dense and embedding layers are library calls,
as the JAX package leaves them to XLA.  On one CUDA device each training
step is a replay of one captured CUDA graph (``runtime/step_graph.py``);
``disable_graphs()`` runs it eagerly.  ``FFModel.generate``/``beam_search``
decode with kv caches, each signature one captured graph
(``runtime/decode_graph.py``), and ``serving/`` holds the continuous-
batching ``InferenceEngine`` and its HTTP front.
"""

from .config import DeviceType, FFConfig, ParallelConfig
from .initializers import (ConstantInitializer, GlorotUniform, NormInitializer,
                           UniformInitializer, ZeroInitializer)
from .losses import Loss, LossType
from .metrics import MetricsType, PerfMetrics
from .model import FFModel
from .ops.base import Op
from .ops.conv2d import ActiMode, PoolType
from .ops.embedding import AggrMode
from .optimizers import AdamOptimizer, Optimizer, SGDOptimizer
from .parallel.mesh import Machine
from .parallel.strategy import load_strategies_from_file, save_strategies_to_file
from .runtime.dataloader import DataLoader
from .runtime.step_graph import disable_graphs
from .tensor import DataType, Parameter, Tensor

__version__ = "0.1.0"

__all__ = [
    "ActiMode", "AdamOptimizer", "AggrMode", "ConstantInitializer", "DataLoader",
    "DataType", "DeviceType", "FFConfig", "FFModel", "GlorotUniform", "Loss",
    "LossType", "Machine", "MetricsType", "NormInitializer", "Op",
    "Optimizer", "Parameter", "ParallelConfig", "PerfMetrics", "PoolType",
    "SGDOptimizer", "Tensor", "UniformInitializer", "ZeroInitializer",
    "disable_graphs", "load_strategies_from_file", "save_strategies_to_file",
]
