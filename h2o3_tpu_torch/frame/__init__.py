"""Frames and columns on one device (port of ``h2o3_tpu/frame``)."""
