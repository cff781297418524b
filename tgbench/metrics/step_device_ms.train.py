"""Device-busy time in the traced window, per step (ms)."""
from tgbench.readers import step_device_ms as read  # noqa: F401
