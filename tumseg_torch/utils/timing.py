"""Wall-clock helpers mirroring the reference's timePrint/CurrentTime
(localfunctions.py:104-117), without the pytz dependency."""

from __future__ import annotations

import time
from datetime import datetime

try:  # zoneinfo is stdlib on py>=3.9
    from zoneinfo import ZoneInfo

    _DEFAULT_TZ = ZoneInfo("Asia/Singapore")
except Exception:  # pragma: no cover
    _DEFAULT_TZ = None


def time_print(start: float) -> str:
    """Print and return the h:m:s elapsed since ``start`` (time.time())."""
    elapsed = time.time() - start
    sec = elapsed % 60
    t1 = elapsed / 60
    mint = t1 % 60
    hour = t1 / 60
    msg = "Time taken = %i:%i:%i" % (hour, mint, sec)
    print(msg)
    return msg


def current_time(tz=None) -> str:
    """Print and return the current wall-clock time in the given timezone."""
    now = datetime.now(tz or _DEFAULT_TZ)
    msg = now.strftime("%H:%M:%S")
    print("Current Time =", msg)
    return msg
