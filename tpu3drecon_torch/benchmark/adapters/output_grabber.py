"""fd-level stdout/stderr capture for native-library baselines.

Counterpart of ``tpu3drecon/benchmark/adapters/output_grabber.py`` and of
the reference OutputGrabber (reference:
src/benchmark/colmap_benchmark/utils.py:7-81): Ceres prints its solver
report from C++ code, so Python-level redirection misses it; this grabs the
underlying file descriptor through a pipe.  Used by the pycolmap
single-pose adapter to recover per-call Ceres reports.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional


class OutputGrabber:
    """Capture everything written to a C-level stream during a with-block.

    >>> g = OutputGrabber()
    >>> with g:
    ...     some_native_call()
    >>> report = g.capturedtext
    """

    escape_char = "\b"

    def __init__(self, stream=None, threaded: bool = True):
        self.origstream = stream or sys.stdout
        self.origstreamfd = self.origstream.fileno()
        self.capturedtext = ""
        self.threaded = threaded
        self.pipe_out: Optional[int] = None
        self.pipe_in: Optional[int] = None
        self.streamfd_copy: Optional[int] = None
        self.worker: Optional[threading.Thread] = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self) -> None:
        self.capturedtext = ""
        self.pipe_out, self.pipe_in = os.pipe()
        self.streamfd_copy = os.dup(self.origstreamfd)
        os.dup2(self.pipe_in, self.origstreamfd)
        if self.threaded:
            self.worker = threading.Thread(target=self._read_all)
            self.worker.start()

    def stop(self) -> None:
        self.origstream.flush()
        # Sentinel so the reader knows the stream ended.
        os.write(self.pipe_in, self.escape_char.encode())
        if self.worker is not None:
            self.worker.join()
        else:
            self._read_all()
        os.close(self.pipe_in)
        os.close(self.pipe_out)
        os.dup2(self.streamfd_copy, self.origstreamfd)
        os.close(self.streamfd_copy)

    def _read_all(self) -> None:
        while True:
            chunk = os.read(self.pipe_out, 4096).decode(errors="replace")
            if self.escape_char in chunk:
                self.capturedtext += chunk.split(self.escape_char, 1)[0]
                break
            self.capturedtext += chunk
