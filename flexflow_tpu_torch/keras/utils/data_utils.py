"""Dataset file resolution (reference: keras/utils/data_utils.py get_file).

The reference downloads from S3; the port downloads nothing, so
``get_file`` only resolves already-present local files and reports the
search path when missing.  Callers (datasets/*) fall back to synthetic
data when it returns None.
"""

from __future__ import annotations

import os
from typing import Optional


def _search_dirs():
    dirs = []
    env = os.environ.get("FF_DATASET_DIR")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(os.path.expanduser("~"), ".keras", "datasets"))
    return dirs


def locate_file(fname: str) -> Optional[str]:
    """Return the path of a cached dataset file, or None."""
    if os.path.isabs(fname) and os.path.exists(fname):
        return fname
    for d in _search_dirs():
        p = os.path.join(d, fname)
        if os.path.exists(p):
            return p
    return None


_warned: set = set()


def warn_synthetic(name: str) -> None:
    """LOUD one-line notice that a dataset loader substituted synthetic
    data (once per dataset per process).  Every accuracy threshold met
    on a synthetic stand-in proves learning on synthetic patterns only —
    drop the real file in ~/.keras/datasets (or $FF_DATASET_DIR) for a
    real-data run."""
    if name in _warned:
        return
    _warned.add(name)
    import sys

    print(f"flexflow_tpu_torch: WARNING: {name} not found in "
          f"{_search_dirs()} — using a DETERMINISTIC SYNTHETIC stand-in "
          f"(real shapes/dtypes, fake content)", file=sys.stderr, flush=True)


def get_file(fname: str, origin: str = "", file_hash: str = "",
             cache_subdir: str = "datasets") -> Optional[str]:
    """Reference-compatible signature; resolves locally only.

    Returns the local path if the file is cached, else None (the
    reference would download ``origin`` here).
    """
    del origin, file_hash, cache_subdir
    return locate_file(fname)
