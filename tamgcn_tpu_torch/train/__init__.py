"""Runtime of the port: config system, session, weights, trainer (test phase)."""
from .config import base_parser, load_config  # noqa: F401
from .session import Session  # noqa: F401
