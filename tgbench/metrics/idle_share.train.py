"""The share of the traced window in which no device op ran (%)."""
from tgbench.readers import idle_share as read  # noqa: F401
