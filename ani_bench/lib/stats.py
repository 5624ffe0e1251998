"""Arithmetic of the end-to-end metrics."""

from __future__ import annotations


def rate(units: float, start: float, end: float) -> float:
    """Units completed per second from the window's start to the last
    completion."""
    if end <= start:
        raise ValueError("an empty window")
    return units / (end - start)
