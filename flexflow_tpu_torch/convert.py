"""Carry weights and optimizer state from the JAX package into the port.

Both packages keep one layout at every public surface (NHWC activations,
HWIO conv kernels, ``(in, out)`` dense kernels, NHWC flatten order) and
the same optimizer slot names, so carrying across is a copy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

Tree = Mapping[str, Mapping[str, np.ndarray]]


def load_jax_params(model, params: Tree,
                    opt_state: Optional[Mapping[str, Tree]] = None) -> None:
    """Load ``{op_name: {weight_name: array}}`` (what the JAX package's
    ``FFModel.get_parameter`` returns, leaf by leaf) into an initialized
    port model, and optionally optimizer state ``{slot: tree}`` ("v" for
    SGD momentum, "m"/"v" for Adam)."""
    for opn, ws in params.items():
        for wn, value in ws.items():
            model.set_parameter(opn, wn, value)
    if opt_state is None:
        return
    for slot, tree in opt_state.items():
        if slot not in model._opt_state:
            raise KeyError(f"the model's optimizer has no state slot {slot!r}")
        for opn, ws in tree.items():
            for wn, value in ws.items():
                model._assign(model._opt_state[slot][opn][wn], value)


def jax_params_to_numpy(jax_model) -> Dict[str, Dict[str, np.ndarray]]:
    """Every weight of an initialized JAX-package model, through its
    public ``get_parameter``, as ``{op_name: {weight_name: array}}``."""
    return {op.name: {w.name: np.asarray(jax_model.get_parameter(op.name, w.name))
                      for w in op.weights}
            for op in jax_model.ops if op.weights}
