"""Serving: ``batcher.py`` (cross-request micro-batching), ``server.py``
(program tables from a live model, the HTTP front) and ``loadgen.py``
(a stdlib HTTP load generator)."""

from .batcher import MicroBatcher  # noqa: F401
from .loadgen import run_load  # noqa: F401
from .server import (PADServer, build_programs_live,  # noqa: F401
                     make_server_from_programs, prometheus_text, run_server)
