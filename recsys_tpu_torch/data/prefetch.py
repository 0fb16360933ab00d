"""Background-thread batch prefetch.

Host-side batch assembly (fancy-index copies, padding) runs in a daemon
thread a fixed number of batches ahead of the device, so it overlaps with
the asynchronously launched forward instead of serialising with it.  numpy
releases the GIL during the copies, so a single thread is enough.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_DONE = object()


def prefetch(gen: Iterable, depth: int = 2) -> Iterator:
    """Run ``gen`` in a daemon thread, buffering up to ``depth`` items.

    Exceptions in the generator are re-raised at the consuming site.  If
    the consumer abandons iteration, the worker is signalled to stop so it
    does not sit blocked on a full queue pinning buffered batches.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def worker():
        try:
            for item in gen:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - reraised on main thread
            if not stop.is_set():
                q.put(e)
            return
        q.put(_DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a worker mid-put can finish promptly
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
