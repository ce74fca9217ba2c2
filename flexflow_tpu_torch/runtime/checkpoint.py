"""Checkpoints in the JAX package's ``.npz`` format (PyTorch port of the
``.npz`` path of ``flexflow_tpu/runtime/checkpoint.py``).

A checkpoint is one ``.npz`` file of the flattened training-state tree,
the JAX package's layout leaf for leaf, so either package reads the
other's files:

    params/<op>/<weight>            float32, the weight's full shape
    opt_state/<slot>/<op>/<weight>  "v" (SGD momentum), "m" and "v" (Adam)
    step                            int64, the steps taken

(checkpoint.py:138-162 and 247-335 there).  The JAX package writes orbax
directories when orbax is installed and ``.npz`` otherwise; the port
writes ``.npz`` only: a path without the suffix becomes ``path + ".npz"``,
as the JAX package does without orbax.  Neither package's ``.npz`` holds
Adam's bias-correction schedule (``alpha_t``), which ``next_epoch()``
rebuilds.

Writes are atomic (a sibling temporary file, then ``os.replace``) and,
like reads, retried on ``OSError`` (``resilience.with_ckpt_retries``).
``load`` writes every leaf in place into the model's tensors, so a
captured step (runtime/step_graph.py) stays valid; on a mesh each rank
keeps its part of each leaf, and only rank 0 writes the file.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .resilience import with_ckpt_retries


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _full(t: torch.Tensor) -> np.ndarray:
    """A leaf's whole value as numpy (on a mesh a collective)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.cpu().numpy()


def state_arrays(model) -> Dict[str, np.ndarray]:
    """The model's training state as the flattened ``.npz`` entries (on a
    mesh every rank gathers every leaf: a collective)."""
    flat = {}
    for opn, ws in model._params.items():
        for wn, w in ws.items():
            flat[f"params/{opn}/{wn}"] = _full(w)
    for slot, tree in (model._opt_state or {}).items():
        for opn, ws in tree.items():
            for wn, t in ws.items():
                flat[f"opt_state/{slot}/{opn}/{wn}"] = _full(t)
    flat["step"] = np.full((), model._step_count, np.int64)
    return flat


def _write_npz(flat: Dict[str, np.ndarray], final: str) -> None:
    # atomic: a crash mid-write never leaves a partial checkpoint; the
    # temporary file is a sibling (one filesystem), named by pid
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def save_checkpoint(model, path: str) -> str:
    """Write the model's training state to ``path`` (``.npz`` appended when
    missing); returns the file's path.  On a mesh every rank calls it.
    With telemetry on, the save is a ``checkpoint_save`` span."""
    from ..observability.health import write_heartbeat

    # a no-op unless FF_HEARTBEAT_PATH is set: a wedged save gets named
    write_heartbeat("checkpoint_save", step=model._step_count)
    tel = model._telemetry
    if tel is None:
        return _save_checkpoint(model, path)
    with tel.span("checkpoint_save", path=path, step=model._step_count):
        final = _save_checkpoint(model, path)
    tel.flush()
    return final


def _save_checkpoint(model, path: str) -> str:
    final = _npz_path(path)
    flat = state_arrays(model)
    if not dist.is_initialized() or dist.get_rank() == 0:
        with_ckpt_retries(lambda: _write_npz(flat, final), model=model, site="ckpt_save",
                          path=final)
    if dist.is_initialized():
        dist.barrier()
    return final


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def load_arrays(model, flat: Dict[str, np.ndarray]) -> None:
    """Write a flattened state into the model, every leaf in place.  Every
    parameter must be present; a file with no optimizer state at all (a
    weights-only ``.npz``, the JAX package's interchange form) zeroes the
    model's, as a fresh start would have it; ``step`` defaults to 0."""
    for opn, ws in model._params.items():
        for wn, w in ws.items():
            key = f"params/{opn}/{wn}"
            if key not in flat:
                raise KeyError(f"checkpoint has no {key!r}")
            model._assign(w, flat[key])
    has_state = any(k.startswith("opt_state/") for k in flat)
    for slot, tree in (model._opt_state or {}).items():
        for opn, ws in tree.items():
            for wn, t in ws.items():
                key = f"opt_state/{slot}/{opn}/{wn}"
                if has_state and key not in flat:
                    raise KeyError(f"checkpoint has no {key!r}")
                with torch.no_grad():
                    if has_state:
                        model._assign(t, flat[key])
                    else:
                        (t.to_local() if isinstance(t, DTensor) else t).zero_()
    model._step_count = int(flat.get("step", 0))


def load_checkpoint(model, path: str) -> None:
    """Restore a state written by ``save_checkpoint`` or by the JAX
    package's ``.npz`` save; with telemetry on, a ``checkpoint_restore``
    span."""
    from ..observability.health import write_heartbeat

    write_heartbeat("checkpoint_restore")
    tel = model._telemetry
    if tel is None:
        return _load_checkpoint(model, path)
    with tel.span("checkpoint_restore", path=path):
        _load_checkpoint(model, path)
    tel.flush()


def _load_checkpoint(model, path: str) -> None:
    final = _npz_path(path)
    flat = with_ckpt_retries(lambda: _read_npz(final), model=model, site="ckpt_restore",
                             path=final)
    load_arrays(model, flat)


class CheckpointManager:
    """Rotation and interval policy over one ``.npz`` file per step
    (``ckpt_<step>.npz`` in ``directory``), with the API of the JAX
    package's orbax-backed manager: ``save`` writes when ``step`` is past
    the latest saved step and a multiple of ``save_interval_steps`` (or
    when forced), and keeps the ``max_to_keep`` newest files.  It cannot
    read an orbax directory the JAX package wrote; a ``.npz`` file of
    either package loads through ``FFModel.load``."""

    _NAME = re.compile(r"^ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep or 0)  # 0 or None: keep every file
        self.save_interval_steps = max(1, int(save_interval_steps))
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        return (latest is None or step > latest) and step % self.save_interval_steps == 0

    def save(self, model, step: Optional[int] = None, force: bool = False) -> bool:
        """Save at ``step`` (the model's step count by default); ``force``
        bypasses the interval, as a preemption save must."""
        step = model._step_count if step is None else int(step)
        if not force and not self.should_save(step):
            return False
        save_checkpoint(model, self._path(step))
        if self.max_to_keep and (not dist.is_initialized() or dist.get_rank() == 0):
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        if dist.is_initialized():
            dist.barrier()
        return True

    def restore_latest(self, model) -> Optional[int]:
        step = self.latest_step()
        if step is None:
            return None
        load_checkpoint(model, self._path(step))
        return step

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
