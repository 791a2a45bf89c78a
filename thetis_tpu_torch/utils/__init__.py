"""Numpy-only utilities carried over from ``thetis_tpu/utils``."""
