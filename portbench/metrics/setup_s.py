"""Seconds from the start of the process, torch imported, to the start of the window."""
from benchlib.readers import setup_s as read  # noqa: F401
