"""Tee logger: timestamped lines to stdout (ANSI colours kept) and to a log
file (ANSI colours stripped).

Counterpart of ``ihgnn_tpu/utils/logging.py`` (the reference's
Helpers/IOHelper.py:25-77). ``start_logging`` / ``log_print`` /
``end_logging`` drive one process-wide logger, as the CLI of both packages
does.
"""

from __future__ import annotations

import re
import time
from typing import Optional

_ANSI = re.compile(r"\033\[[0-9;]*m")


class TeeLogger:
    def __init__(self, filename: Optional[str] = None, echo: bool = True):
        self._file = open(filename, "a", encoding="utf-8") if filename \
            else None
        self._echo = echo

    def log(self, text: str = "", put_time_in_single_line: bool = False
            ) -> None:
        stamp = time.strftime("[%H:%M:%S] ")
        if put_time_in_single_line and "\n" in text:
            out = stamp + "\n" + text
        else:
            out = ("\n".join(stamp + line for line in text.split("\n"))
                   if text else stamp)
        if self._echo:
            print(out, flush=True)
        if self._file:
            self._file.write(_ANSI.sub("", out) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


_logger = TeeLogger()


def start_logging(filename: Optional[str], echo: bool = True) -> None:
    """Tee every later ``log_print`` into ``filename`` (appended; None:
    no file); with ``echo`` False nothing reaches stdout either (the ranks
    of a mesh but rank 0)."""
    global _logger
    _logger.close()
    _logger = TeeLogger(filename, echo)


def log_print(text: str = "", put_time_in_single_line: bool = False) -> None:
    _logger.log(text, put_time_in_single_line)


def end_logging() -> None:
    """Close the log file; later lines go to stdout only."""
    global _logger
    _logger.close()
    _logger = TeeLogger()
