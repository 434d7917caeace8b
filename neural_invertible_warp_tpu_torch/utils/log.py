"""Console logger of the port: time-stamped lines, flushed at once."""

from __future__ import annotations

import sys
import time


def info(msg):
    print("[{}] {}".format(time.strftime("%H:%M:%S"), msg), flush=True)


def warn(msg):
    print("[{}] WARNING: {}".format(time.strftime("%H:%M:%S"), msg), flush=True)


def error(msg):
    print("[{}] ERROR: {}".format(time.strftime("%H:%M:%S"), msg), file=sys.stderr,
          flush=True)
