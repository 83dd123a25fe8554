"""Host process-parallel list map (the reference's ``ListMultiProcessor``).

Counterpart of ``tpu3drecon/utils/multiprocess.py``: the reference drained
a Manager-list work queue with ``cpu_count`` processes to noise its
datasets object by object (reference: src/benchmark/multiprocesser.py:6-79).
The port's noiser draws in bulk and does not need it; the class stays on
the public surface for host-side work over many independent items (e.g.
one COLMAP export per scene).  The pool uses spawn: a fork after CUDA has
started leaves the child a broken CUDA context.
"""

from __future__ import annotations

import multiprocessing
from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class ListMultiProcessor:
    """Process a list with a function across worker processes.

    API-compatible with the reference class (construct with the list and a
    picklable function, call ``process()``); progress printing is replaced
    by an optional callback.
    """

    def __init__(
        self,
        items: Sequence[T],
        func: Callable[[T], R],
        num_processes: Optional[int] = None,
        progress: Optional[Callable[[int, int], None]] = None,
    ):
        self.items = list(items)
        self.func = func
        self.num_processes = num_processes or multiprocessing.cpu_count()
        self.progress = progress

    def process(self) -> List[R]:
        if not self.items:
            return []
        if self.num_processes <= 1 or len(self.items) == 1:
            return [self.func(item) for item in self.items]
        ctx = multiprocessing.get_context("spawn")
        chunk = max(1, len(self.items) // (self.num_processes * 4))
        with ctx.Pool(self.num_processes) as pool:
            out = []
            for i, r in enumerate(pool.imap(self.func, self.items, chunksize=chunk)):
                out.append(r)
                if self.progress:
                    self.progress(i + 1, len(self.items))
            return out
