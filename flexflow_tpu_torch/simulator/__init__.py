"""Execution simulator, cost model and strategy search (PyTorch port of
``flexflow_tpu/simulator/``), on an H100 node model."""
