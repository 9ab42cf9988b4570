"""% of K2's roofline: the least time of its launches over their device time."""
from benchlib.readers import k2_roofline as read  # noqa: F401
