"""Strategy-file I/O (PyTorch port of ``flexflow_tpu/parallel/strategy.py``).

Wire-compatible with the reference protobuf schema (src/runtime/
strategy.proto: message ``FFProtoBuf.Strategy`` = repeated ``Op{name=1,
device_type=2, dims=3, device_ids=4, memory_types=5}``; load/save in
src/runtime/strategy.cc:87-163), hand-rolled in the stdlib so that no
protobuf runtime is needed.  A file written by either package decodes to
the same map in the other, and both write the same bytes for one map.

Dims are in natural order (batch first, NHWC); a file exported by the
reference carries Legion adim order (innermost first), which
``reference_order=True`` reverses on import.

The optional ``<file>.meta.json`` sidecar (provenance of a searched
strategy) is written when ``provenance`` is given; the population search
reads sidecars back to pick its warm starts (``load_warm_starts``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

from ..config import DeviceType, ParallelConfig

PROVENANCE_VERSION = 1

_WIRE_VARINT = 0
_WIRE_LEN = 2


def _write_varint(buf: io.BytesIO, value: int) -> None:
    if value < 0:
        value += 1 << 64  # proto int32 negative -> 10-byte varint
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    if result >= (1 << 63):  # re-sign int64 -> int
        result -= 1 << 64
    return result, pos


def _write_tag(buf: io.BytesIO, field: int, wire: int) -> None:
    _write_varint(buf, (field << 3) | wire)


def _encode_op(name: str, pc: ParallelConfig) -> bytes:
    buf = io.BytesIO()
    _write_tag(buf, 1, _WIRE_LEN)
    nb = name.encode("utf-8")
    _write_varint(buf, len(nb))
    buf.write(nb)
    _write_tag(buf, 2, _WIRE_VARINT)
    _write_varint(buf, pc.device_type.value)
    for d in pc.dims:
        _write_tag(buf, 3, _WIRE_VARINT)
        _write_varint(buf, d)
    for d in pc.device_ids:
        _write_tag(buf, 4, _WIRE_VARINT)
        _write_varint(buf, d)
    for m in pc.memory_types:
        _write_tag(buf, 5, _WIRE_VARINT)
        _write_varint(buf, 1 if m in ("host", "ZCM", "zcm") else 0)
    return buf.getvalue()


def _decode_op(data: bytes) -> Tuple[str, ParallelConfig]:
    pos = 0
    name = ""
    device_type = DeviceType.GPU
    dims: List[int] = []
    device_ids: List[int] = []
    memory_types: List[str] = []
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(data, pos)
            if field == 2:
                device_type = DeviceType.CPU if val == 1 else DeviceType.GPU
            elif field == 3:
                dims.append(int(val))
            elif field == 4:
                device_ids.append(int(val))
            elif field == 5:
                memory_types.append("host" if val == 1 else "hbm")
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(data, pos)
            payload = data[pos:pos + ln]
            pos += ln
            if field == 1:
                name = payload.decode("utf-8")
            elif field in (3, 4, 5):  # packed repeated ints
                p = 0
                while p < len(payload):
                    v, p = _read_varint(payload, p)
                    if field == 3:
                        dims.append(int(v))
                    elif field == 4:
                        device_ids.append(int(v))
                    else:
                        memory_types.append("host" if v == 1 else "hbm")
        else:
            raise ValueError(f"unsupported wire type {wire} in strategy file")
    if not dims:
        dims = [1]
    return name, ParallelConfig(device_type, tuple(dims), tuple(device_ids),
                                tuple(memory_types))


def _encode_map(strategies: Dict[str, ParallelConfig], names) -> bytes:
    buf = io.BytesIO()
    for name in names:
        body = _encode_op(name, strategies[name])
        _write_tag(buf, 1, _WIRE_LEN)
        _write_varint(buf, len(body))
        buf.write(body)
    return buf.getvalue()


def save_strategies_to_file(filename: str, strategies: Dict[str, ParallelConfig],
                            provenance: Optional[Dict[str, Any]] = None) -> None:
    """Serialize (reference: strategy.cc:128-163), ops in the map's order.
    With ``provenance``, also stamp the ``<filename>.meta.json`` sidecar."""
    with open(filename, "wb") as f:
        f.write(_encode_map(strategies, list(strategies)))
    if provenance is not None:
        write_provenance(filename, provenance)


def load_strategies_from_file(filename: str,
                              reference_order: bool = False) -> Dict[str, ParallelConfig]:
    """Parse (reference: strategy.cc:87-126).  ``reference_order=True``
    reverses each op's dims from Legion adim order into natural order."""
    with open(filename, "rb") as f:
        data = f.read()
    out: Dict[str, ParallelConfig] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire != _WIRE_LEN:
            raise ValueError("malformed strategy file")
        ln, pos = _read_varint(data, pos)
        payload = data[pos:pos + ln]
        pos += ln
        if field == 1:
            name, pc = _decode_op(payload)
            if reference_order:
                pc = ParallelConfig(pc.device_type, tuple(reversed(pc.dims)),
                                    pc.device_ids, pc.memory_types)
            out[name] = pc
    return out


# ----------------------------------------------------------------------
# provenance sidecar (<file>.meta.json)
# ----------------------------------------------------------------------

def sidecar_path(filename: str) -> str:
    return filename + ".meta.json"


def strategy_content_hash(data: bytes) -> str:
    """Content hash binding a sidecar to its ``.pb`` bytes."""
    return "sha256:" + hashlib.sha256(data).hexdigest()


def strategies_fingerprint(strategies: Dict[str, ParallelConfig]) -> str:
    """Content hash of a strategy map, independent of insertion order: the
    ``.pb`` bytes of the map with its ops sorted by name."""
    return strategy_content_hash(_encode_map(strategies, sorted(strategies)))


def write_provenance(filename: str, meta: Dict[str, Any]) -> str:
    """Stamp ``<filename>.meta.json``: the caller's metadata plus the
    schema version, creation time and the ``.pb`` content hash.  Returns
    the sidecar path."""
    with open(filename, "rb") as f:
        data = f.read()
    out = dict(meta)
    out["provenance_version"] = PROVENANCE_VERSION
    out["strategy_file"] = os.path.basename(filename)
    out["content_hash"] = strategy_content_hash(data)
    out["created_unix"] = time.time()
    path = sidecar_path(filename)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def read_provenance(filename: str) -> Optional[Dict[str, Any]]:
    """The sidecar's metadata, or None when it is absent or unreadable (a
    corrupt sidecar warns; sidecars never break a strategy load)."""
    path = sidecar_path(filename)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            meta = json.load(f)
        if not isinstance(meta, dict):
            raise ValueError(f"expected a JSON object, got {type(meta).__name__}")
        return meta
    except (OSError, ValueError) as e:
        warnings.warn(f"ignoring corrupt strategy sidecar {path}: {e}", stacklevel=2)
        return None


# The shipped strategy files (the repo's strategies/), where the population
# search looks for warm starts.
DEFAULT_STRATEGY_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "strategies"))


def load_warm_starts(model, num_devices: int, strategies_dir: Optional[str] = None,
                     limit: Optional[int] = None
                     ) -> List[Tuple[str, Dict[str, ParallelConfig]]]:
    """Seed strategy maps for the population search: the ``.pb`` files of
    ``strategies_dir`` (default: the shipped ``strategies/``) whose
    ``.pb.meta.json`` sidecars claim this model (every op name in the map)
    and ``num_devices``, as ``[(filename, {op: ParallelConfig})]`` in sorted
    filename order.  A ``.pb`` without a sidecar is skipped; one whose
    sidecar's content hash no longer matches is skipped with a warning."""
    out: List[Tuple[str, Dict[str, ParallelConfig]]] = []
    d = DEFAULT_STRATEGY_DIR if strategies_dir is None else strategies_dir
    if not os.path.isdir(d):
        return out
    op_names = {op.name for op in model.ops}
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".pb"):
            continue
        path = os.path.join(d, fn)
        meta = read_provenance(path)
        if meta is None:
            continue
        with open(path, "rb") as f:
            data = f.read()
        if meta.get("content_hash") != strategy_content_hash(data):
            warnings.warn(f"skipping stale strategy sidecar {sidecar_path(path)}: "
                          f"content hash no longer matches {fn}", stacklevel=2)
            continue
        try:
            if int(meta.get("num_devices", -1)) != int(num_devices):
                continue
        except (TypeError, ValueError):
            continue
        try:
            strategies = load_strategies_from_file(path)
        except (ValueError, IndexError) as e:
            warnings.warn(f"skipping unreadable strategy file {path}: {e}", stacklevel=2)
            continue
        if not op_names.issubset(strategies):
            continue
        out.append((fn, {k: v for k, v in strategies.items() if k in op_names}))
        if limit is not None and len(out) >= limit:
            break
    return out
