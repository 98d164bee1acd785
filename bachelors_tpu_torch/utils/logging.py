"""Leveled, module-tagged logging with console + file sinks.

The port's copy of ``bachelors_tpu/utils/logging.py`` (reference `log.h`):
levels INFO/OKAY/WARN/ERROR/FATAL/DEBUG/TRACE (`log.h:8-18`), module tags,
ANSI-colored console plus an optional per-run log file (`log.h:216-295`).
The reference's indentation groups and ``format_bytes`` have no caller in
the port yet and are left out.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional, TextIO

LEVELS = ("TRACE", "DEBUG", "INFO", "OKAY", "WARN", "ERROR", "FATAL")
_RANK = {name: i for i, name in enumerate(LEVELS)}

_COLORS = {
    "TRACE": "\x1b[90m",
    "DEBUG": "\x1b[90m",
    "INFO": "",
    "OKAY": "\x1b[32m",
    "WARN": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "FATAL": "\x1b[41m",
}
_RESET = "\x1b[0m"


class LogSystem:
    """Global sink registry; swap the file sink per run like the reference's
    ``log_system_set_logger`` (`main.cpp:279-281`)."""

    def __init__(self):
        # resolved at emit time so stream redirection (pytest capture, etc.)
        # is respected
        self.console: Optional[TextIO] = None
        self.file: Optional[TextIO] = None
        self.min_level = os.environ.get("BTPU_LOG_LEVEL", "INFO")
        self.use_color = True

    def set_file(self, path: Optional[str]):
        if self.file is not None:
            self.file.close()
            self.file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.file = open(path, "a")

    def emit(self, level: str, module: str, msg: str):
        if _RANK[level] < _RANK.get(self.min_level, 2):
            return
        stamp = time.strftime("%H:%M:%S")
        line = f"{stamp} {level:5s} [{module}] {msg}"
        color = _COLORS.get(level, "") if self.use_color else ""
        console = self.console if self.console is not None else sys.stderr
        print(f"{color}{line}{_RESET if color else ''}", file=console)
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()


SYSTEM = LogSystem()


class Logger:
    def __init__(self, module: str):
        self.module = module

    def _log(self, level, msg):
        SYSTEM.emit(level, self.module, msg)

    def trace(self, msg):
        self._log("TRACE", msg)

    def debug(self, msg):
        self._log("DEBUG", msg)

    def info(self, msg):
        self._log("INFO", msg)

    def okay(self, msg):
        self._log("OKAY", msg)

    def warn(self, msg):
        self._log("WARN", msg)

    def error(self, msg):
        self._log("ERROR", msg)

    def fatal(self, msg):
        self._log("FATAL", msg)


def get_logger(module: str) -> Logger:
    return Logger(module)
