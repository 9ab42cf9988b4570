"""% of K1's roofline: the least time of its launches over their device time."""
from benchlib.readers import k1_roofline as read  # noqa: F401
