"""What a hand-written kernel's wrapper reports on meta tensors.

On a meta tensor (the dry run: shapes without storage) a wrapper launches
nothing and runs no plain version; it returns outputs of the right shape
and dtype and reports the kernel's work, ``(flops, bytes)`` from its
shape-only ``work`` function, to every collector installed here
(``launch.analysis.count_cost`` installs one). The plain version's own
operations would otherwise be counted in the kernel's place, and its work
is not the kernel's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

_SINKS: List[Callable[[str, float, float], None]] = []


def report(name: str, flops: float, nbytes: float) -> None:
    for sink in _SINKS:
        sink(name, flops, nbytes)


@contextlib.contextmanager
def collect(sink: Callable[[str, float, float], None]):
    """Call ``sink(kernel name, flops, bytes)`` for every report inside."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)
