"""Runtime of the port: config system, session, optimizer, checkpoints,
trainer (train and test phases)."""
from .config import base_parser, load_config  # noqa: F401
from .session import Session  # noqa: F401
