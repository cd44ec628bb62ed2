"""Leveled logger with source locations (reference ``source/logger.f90``)."""

from __future__ import annotations

import inspect
import os
import sys
import time
from typing import Optional, TextIO

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40, "fatal": 50}
_COLORS = {"debug": "\033[36m", "info": "\033[32m", "warning": "\033[33m",
           "error": "\033[31m", "fatal": "\033[41m"}
_RESET = "\033[0m"


class FatalError(RuntimeError):
    pass


class Logger:
    def __init__(self, stream: Optional[TextIO] = None, level: str = "info",
                 color: Optional[bool] = None):
        self.stream = stream or sys.stdout
        self.level = _LEVELS[level]
        self.color = self.stream.isatty() if color is None else color

    def _log(self, level: str, msg: str) -> None:
        if _LEVELS[level] < self.level:
            return
        frame = inspect.stack()[2]
        loc = f"{os.path.basename(frame.filename)}:{frame.lineno}"
        tag = f"[{level.upper():7s}]"
        if self.color:
            tag = _COLORS[level] + tag + _RESET
        self.stream.write(f"{tag} {time.strftime('%H:%M:%S')} {loc}  {msg}\n")

    def debug(self, msg: str) -> None:
        self._log("debug", msg)

    def info(self, msg: str) -> None:
        self._log("info", msg)

    def warning(self, msg: str) -> None:
        self._log("warning", msg)

    def error(self, msg: str) -> None:
        self._log("error", msg)

    def fatal(self, msg: str) -> None:
        self._log("fatal", msg)
        raise FatalError(msg)


g_logger = Logger()
