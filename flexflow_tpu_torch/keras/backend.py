"""Keras backend identification (reference: python/flexflow/keras/backend/,
which reports its Legion backend; here the backend is PyTorch on CUDA)."""

_BACKEND = "flexflow_tpu_torch"


def backend() -> str:
    return _BACKEND


def image_data_format() -> str:
    # layer specs are channels-first (C, H, W), as the reference's; the core
    # stores images NHWC
    return "channels_first"
