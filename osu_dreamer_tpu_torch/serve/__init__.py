"""Serving subsystem: resident generation service + HTTP front-end.

Counterpart of osu_dreamer_tpu/serve/ on one card: a process that owns the
card, batches concurrent requests through the sampler ``predict`` uses, and
streams ``.osz`` mapsets back over HTTP. See service.py for the batching
model and http.py for the wire surface; the CLI entry point is
``python -m osu_dreamer_tpu_torch serve``. Importing it loads no model and
touches no device.
"""

from .http import MapServer
from .service import GeneratorService

__all__ = ["GeneratorService", "MapServer"]
