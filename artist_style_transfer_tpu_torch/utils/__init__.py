"""Device, config, image I/O and JAX-parameter conversion helpers."""
