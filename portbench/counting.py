"""The hook between the reference's transition convs and the counter of ``counts.py``.

While a ``counts.Counter`` is active, ``transition`` books one polyphase conv call (its
multiply-adds and the elements it reads and writes) and keeps the counter's dispatch mode
from also booking the library calls inside it.  Without an active counter it does
nothing.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

ACTIVE: List = []  # the active counters (at most one in practice)


def polyphase_macs(n: int, cin: int, cout: int, fine_spatial, kernel) -> int:
    """Multiply-adds of conv(upscale(x), w) as the polyphase conv it equals: per output
    voxel (k + 1) // 2 taps along an axis of odd kernel size k > 1; along an axis of size
    1 both output phases are the same conv of the coarse input, done once."""
    macs = n * cin * cout
    for s, k in zip(fine_spatial, kernel):
        macs *= int(s) * ((int(k) + 1) // 2) if int(k) > 1 else int(s) // 2
    return macs


@contextlib.contextmanager
def transition(kind: str, a, w):
    """Book `kind` ("transition", "transition_dgrad" or "transition_wgrad"): `a` is the
    coarse input x, or for the dgrad the fine cotangent; `w` is (*kernel, in, out)."""
    counter: Optional[object] = ACTIVE[-1] if ACTIVE else None
    if counter is None:
        yield
        return
    kernel, (cin, cout) = tuple(w.shape[:3]), tuple(w.shape[3:])
    n = int(a.shape[0])
    if kind == "transition_dgrad":
        fine = tuple(int(s) for s in a.shape[2:])
        coarse = tuple(s // 2 for s in fine)
    else:
        coarse = tuple(int(s) for s in a.shape[2:])
        fine = tuple(2 * s for s in coarse)
    macs = polyphase_macs(n, cin, cout, fine, kernel)
    x_el = n * cin * math.prod(coarse)
    y_el = n * cout * math.prod(fine)
    w_el = math.prod(int(s) for s in w.shape)
    counter.book(kind, 2 * macs, x_el + y_el + w_el)
    with counter.suppressed():
        yield
