"""% of the peak: the least time of the units' operations over the traced window."""
from benchlib.readers import mfu as read  # noqa: F401
