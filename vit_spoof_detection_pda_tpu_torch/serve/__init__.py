"""Serving: ``batcher.py`` (cross-request micro-batching), ``server.py``
(program tables from serving artifacts or a live model, the HTTP front)
and ``loadgen.py`` (a stdlib HTTP load generator)."""

from .batcher import MicroBatcher  # noqa: F401
from .loadgen import run_load  # noqa: F401
from .server import (PADServer,  # noqa: F401
                     build_programs_from_artifacts, build_programs_live,
                     make_server, make_server_from_programs,
                     prometheus_text, run_server, serve)
