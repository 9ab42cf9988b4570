"""Device ms of conv and GEMM kernels a training step in the traced window."""
from benchlib.readers import conv_ms_per_step as read  # noqa: F401
