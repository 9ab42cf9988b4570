"""Images a second over the measured window (end to end, host clock)."""
from benchlib.readers import images_per_s as read  # noqa: F401
