"""CANDLE-Uno cancer drug-response model, built exactly as the JAX package
builds it (``flexflow_tpu/models/candle_uno.py``; reference:
examples/cpp/candle_uno/candle_uno.cc:28-130).

Multi-input MLP: per-feature encoder towers (3×1000 dense) for cell/drug
features, concat with scalar dose inputs, 3×1000 dense trunk, scalar
regression output, MSE loss.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..model import FFModel
from ..ops.conv2d import ActiMode

DEFAULT_FEATURE_SHAPES = {
    "dose": 1,
    "cell.rnaseq": 942,
    "drug.descriptors": 5270,
    "drug.fingerprints": 2048,
}
DEFAULT_INPUT_FEATURES = {
    "dose1": "dose",
    "dose2": "dose",
    "cell.rnaseq": "cell.rnaseq",
    "drug1.descriptors": "drug.descriptors",
    "drug1.fingerprints": "drug.fingerprints",
}


def build_candle_uno(ff: FFModel, batch_size: int,
                     dense_layers: Optional[List[int]] = None,
                     dense_feature_layers: Optional[List[int]] = None,
                     input_features: Optional[Dict[str, str]] = None,
                     feature_shapes: Optional[Dict[str, int]] = None):
    """Returns (inputs dict name->Tensor, final output tensor)."""
    dense_layers = dense_layers or [1000] * 3
    dense_feature_layers = dense_feature_layers or [1000] * 3
    input_features = input_features or dict(DEFAULT_INPUT_FEATURES)
    feature_shapes = feature_shapes or dict(DEFAULT_FEATURE_SHAPES)

    # cell.*/drug.* features get an encoder tower; dose passes through
    # (candle_uno.cc:94-121).
    encoder_types = {ft for ft in feature_shapes
                     if "." in ft and ft.split(".")[0] in ("cell", "drug")}

    inputs: Dict[str, object] = {}
    encoded = []
    for name, fea_type in sorted(input_features.items()):
        shape = feature_shapes[fea_type]
        t = ff.create_tensor((batch_size, shape), name=name, nchw=False)
        inputs[name] = t
        if fea_type in encoder_types:
            for width in dense_feature_layers:
                t = ff.dense(t, width, activation=ActiMode.RELU)
        encoded.append(t)
    out = ff.concat(encoded, axis=1)
    for width in dense_layers:
        out = ff.dense(out, width, activation=ActiMode.RELU)
    out = ff.dense(out, 1)
    return inputs, out
