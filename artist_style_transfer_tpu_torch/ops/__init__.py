"""Ops of the port: padding, image, conv, norm, Gram and losses (NCHW inside, NHWC at the Gram)."""
