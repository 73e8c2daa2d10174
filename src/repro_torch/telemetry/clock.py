"""The two clocks of the serving plane, named.

``default_clock`` is the injectable monotonic clock every serving
component takes as a constructor parameter: tests replace it with a fake.

``wall_clock`` is the deliberate exception: watchdog heartbeats. A
watchdog that beats on the injectable clock is useless: a frozen fake
clock (or a wedged pump that stops advancing its own clock) would mask
the exact hang the watchdog exists to catch. Every heartbeat read goes
through this one helper.
"""
from __future__ import annotations

import time

__all__ = ["default_clock", "wall_clock"]

default_clock = time.monotonic


def wall_clock() -> float:
    """Raw wall-clock read for watchdog heartbeats only (see module
    docstring); everything else must use an injected clock."""
    return time.monotonic()
