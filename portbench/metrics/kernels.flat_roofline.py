"""``kernels.flat_roofline``: the flat kernels' least time (bytes or
operations, ``flat_roofline.py``) over their device time in the traced
window, in percent.

Device time and float size come from the trace, by the kernels' names
(``flat_lin_kernel<float, 10>``, ...); the launches and the shape of each
launch from the program's counters ``flat.<kernel>.np<n>`` and their
``.obs``, ``.cameras`` and ``.points`` (PERF.md §3), summed over the
window's launches.  None where the trace or the tally holds no such
kernel or counter (an untraced run, another engine, a tree before the
counters); it never raises."""

import re
import sys

from portbench.flat_roofline import launch_least_s

NAME = re.compile(r"flat_(lin_kernel|coupling_kernel)<(float|double), (\d+)>")
ITEMSIZE = {"float": 4, "double": 8}


def read(ctx):
    summary = ctx.get("trace")
    if summary is None:
        return None
    try:
        from tpu3drecon_torch.utils.timing import tally
    except ImportError:
        return None
    try:
        counts = tally()["counts"]
        busy = {}  # (kernel, np) -> [device us, float size]
        for name, (_, us) in summary["kernels"].items():
            m = NAME.search(name)
            if m is None:
                continue
            key = (m.group(1), int(m.group(3)))
            entry = busy.setdefault(key, [0.0, ITEMSIZE[m.group(2)]])
            if entry[1] != ITEMSIZE[m.group(2)]:
                return None  # two float sizes at one width: the tally cannot split them
            entry[0] += us
        least_s = busy_s = 0.0
        for (kernel, np_cam), (us, itemsize) in busy.items():
            key = f"flat.{kernel}.np{np_cam}"
            launches = counts.get(key, 0)
            if not launches:
                return None
            shape = [counts.get(f"{key}.{k}", 0) / launches
                     for k in ("obs", "cameras", "points")]
            least_s += launches * launch_least_s(kernel, *shape, np_cam, itemsize)
            busy_s += us * 1e-6
        if busy_s <= 0:
            return None
        return 100.0 * least_s / busy_s
    except Exception as e:  # a reader reports nothing rather than fail the run
        print(f"portbench: kernels.flat_roofline: {e!r}", file=sys.stderr)
        return None
