"""Logger configuration.

The reference uses spdlog with an *empty* ``init_logger()`` stub (reference:
src/server/server_utils.cpp:3, include/server/server_utils.h:3). Here the
initializer actually configures a logger with an spdlog-like format.

Copy of prefhetch_tpu/utils/logging.py.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def init_logger(name: str = "prefhetch", level: int = logging.INFO) -> logging.Logger:
    """Configure the shared 'prefhetch' root once; children propagate to it."""
    root = logging.getLogger("prefhetch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        root.addHandler(handler)
    root.setLevel(level)
    return logging.getLogger(name)
