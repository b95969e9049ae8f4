"""Console logging setup (port of ``cryovit_tpu/_logging_config.py``;
reference ``_logging_config.py:8-17``)."""

from __future__ import annotations

import logging

__all__ = ["setup_logging"]


def setup_logging(level: str = "INFO") -> None:
    """Root logger with a rich handler when available, plain otherwise."""
    handlers: list[logging.Handler] = []
    try:
        from rich.logging import RichHandler

        handlers.append(RichHandler(rich_tracebacks=True, show_path=False))
        fmt = "%(message)s"
    except ImportError:
        handlers.append(logging.StreamHandler())
        fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format=fmt,
        datefmt="[%X]",
        handlers=handlers,
        force=True,
    )
