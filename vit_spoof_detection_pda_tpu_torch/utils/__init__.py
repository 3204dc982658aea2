"""Cross-cutting utilities: telemetry, checkpointing, determinism."""

from .checkpoint import CheckpointManager  # noqa: F401
from .telemetry import MetricLogger  # noqa: F401
