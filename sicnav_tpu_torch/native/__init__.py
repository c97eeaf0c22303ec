"""Native (C++) host components, driven through ctypes."""

from sicnav_tpu_torch.native.orca_cpp import orca_step_native  # noqa: F401
