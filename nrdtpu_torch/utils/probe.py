"""Pixel probe and SHOW capture - counterpart of `nrdtpu/utils/probe.py`, the reference's
shader printf at one debug pixel (`CommonSettings::printfAt`, Common.hlsli:152-164) and its
REBLUR_SHOW_* switches (REBLUR_Config.hlsli:39-50).

Passes tag named intermediate planes with `emit(name, plane)`. While a probe is active
(`collect((x, y))`, which the Engine enters when printfAt falls inside the frame's rect), each
tagged plane's value at that pixel is kept as a tensor on the plane's device (`plane[y, x]`,
no host sync); the Engine returns them under `Engine.PROBE_KEY`. While a SHOW capture is
active (`collect_show(tag)`, `Engine.set_debug_show`), the first plane emitted under `tag` is
kept whole and returned under `Engine.SHOW_KEY`. With neither active, `emit` does nothing.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

_active: Optional["_Collector"] = None
_show: Optional["_PlaneCollector"] = None


class _Collector:
    def __init__(self, xy: Tuple[int, int]):
        self.x, self.y = int(xy[0]), int(xy[1])
        self.values = {}

    def emit(self, name: str, arr):
        if arr is None:
            return
        h, w = arr.shape[0], arr.shape[1]
        if not (0 <= self.y < h and 0 <= self.x < w):
            return
        key = name
        i = 2
        while key in self.values:  # the same tag emitted twice: name#2, name#3, ...
            key = f"{name}#{i}"
            i += 1
        self.values[key] = arr[self.y, self.x]


class _PlaneCollector:
    """The whole plane of the first emit of one tag."""

    def __init__(self, tag: str):
        self.tag = tag
        self.plane = None

    def emit(self, name: str, arr):
        if name == self.tag and self.plane is None and arr is not None:
            self.plane = arr


def emit(name: str, arr) -> None:
    """Tag an intermediate plane: its value at the probe pixel while a probe is active, the
    whole plane while a SHOW capture of `name` is active."""
    if _active is not None:
        _active.emit(name, arr)
    if _show is not None:
        _show.emit(name, arr)


def active() -> bool:
    return _active is not None


def show_active() -> bool:
    return _show is not None


@contextmanager
def collect(xy: Tuple[int, int]):
    """Probe pixel (x, y) while the block runs."""
    global _active
    prev = _active
    _active = _Collector(xy)
    try:
        yield _active
    finally:
        _active = prev


@contextmanager
def collect_show(tag: str):
    """Capture the whole plane of `tag` while the block runs."""
    global _show
    prev = _show
    _show = _PlaneCollector(tag)
    try:
        yield _show
    finally:
        _show = prev
