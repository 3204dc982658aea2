"""Serving: ``batcher.py`` (cross-request micro-batching) and
``server.py`` (program tables from a live model)."""

from .batcher import MicroBatcher  # noqa: F401
from .server import build_programs_live  # noqa: F401
