"""Device ms an image of the kernels outside convs and GEMMs in the traced window."""
from benchlib.readers import nonconv_ms_per_image as read  # noqa: F401
