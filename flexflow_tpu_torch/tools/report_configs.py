"""One table of the report and calibration configurations (PyTorch port of
the JAX package's ``tools/report_configs.py``).

The calibration (``tools/calibrate.py``) and the SOAP reports
(``tools/soap_report.py``) must price and measure the same global batch
per model: cache keys encode part sub-shapes, so a batch mismatch means
no measured entry ever matches a priced op and the reports' measured
provenance stays at zero.  Both tools default from this table.

The global batches and device counts are the reference's configurations
(AlexNet's batch 64 is the reference default, src/runtime/model.cc:1238),
not a TPU's.  On the port's machine model (``simulator/machine.py``) a
device count above 8 means whole H100 nodes of 8 GPUs behind NVSwitch,
joined by InfiniBand: AlexNet, DLRM and NMT at 16 GPUs are two nodes,
ResNet-50 at 64 is eight, Inception-v3 at 8 is one node.
"""

import os

# global batch per model for the SOAP-vs-data-parallel comparison
REPORT_GLOBAL_BATCH = {
    "alexnet": 64,
    "dlrm": 1024,
    "nmt": 1024,
    "resnet": 2048,
    "inception": 256,
}

# GPUs each model's SOAP report simulates.  calibrate synthesizes targeted
# jobs for the report shapes of models whose candidate space at this
# scale it does not enumerate.
REPORT_DEVICES = {
    "alexnet": 16,
    "dlrm": 16,
    "nmt": 16,
    "resnet": 64,
    "inception": 8,
}

# single-card training batch of AlexNet (the port's first cell, and the
# simulated-vs-measured agreement config of the reports)
BENCH_SINGLE_CHIP_BATCH = 256

# Compute dtype the reports (and their measured-cache keys) are priced in:
# part of soap_report's canonical-scale guard, so that a float32 run never
# replaces the bfloat16 keys.
REPORT_COMPUTE_DTYPE = "bfloat16"

# A roofline fit from fewer points or op families than this extrapolates
# beyond its basis; calibrate warns and the reports say so.
THIN_FIT_POINTS = 16
THIN_FIT_OP_TYPES = 3

# chipwatch stops converting windows once the measured cache holds this
# many cuda entries: the size of calibrate's default job space (the
# data-parallel configs of 1, 2, 4 and 8 parts of
# ``--models alexnet:256,transformer:16 --devices 8``, forward and
# backward, deduplicated by cache key).  Recount it when that space
# changes (tests/test_torch_tools.py does).
CALIBRATION_TARGET_ENTRIES = 168


def report_keys_path() -> str:
    """The one resolution of the calibration-priority file (written by
    soap_report, read by calibrate): ``simulator/report_keys.json``, or
    ``FF_REPORT_KEYS_PATH``, which tests set to a scratch path so that a
    small run never overwrites the committed keys."""
    from ..simulator.machine import CALIBRATION_PATH

    return os.environ.get("FF_REPORT_KEYS_PATH",
                          os.path.join(os.path.dirname(CALIBRATION_PATH), "report_keys.json"))


# Annealing budget per model for the SOAP reports, and the restarts
# (independent seeds, the best plan kept) on top.  These are the JAX
# package's budgets, kept as starting values: they were chosen at each
# model's convergence knee on that package's machine model and have not
# been re-measured on the H100 model.
SEARCH_BUDGET = {"alexnet": 160000, "dlrm": 64000, "nmt": 64000}
SEARCH_BUDGET_DEFAULT = 4000
SEARCH_RESTARTS = 4
