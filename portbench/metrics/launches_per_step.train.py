"""Device kernels launched a training step in the traced window."""
from benchlib.readers import launches_per_step as read  # noqa: F401
