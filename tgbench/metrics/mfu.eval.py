"""The model's FLOPs of the traced work over the traced window and the
card's data-sheet dense peak for the configuration's precision (%)."""
from tgbench.readers import mfu as read  # noqa: F401
