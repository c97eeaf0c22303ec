"""Utilities of the port (twin of ``sicnav_tpu/utils``)."""
