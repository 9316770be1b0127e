"""The IBD text writer of the JAX package, with its writer-thread faults
repaired.

``fastsmc_tpu.io.writers.IbdTextWriter`` formats and deflates queued blocks
on a background thread. When the native formatter returns ``None`` (its C
side refuses a truncated buffer) the thread fails on ``write(None)`` and
exits with items still queued, so the next ``Queue.join()`` in ``close()``
never returns. This subclass reports the formatter's failure by name, keeps
marking the items left after an error as done, and makes ``close()`` raise
the error instead of hanging.
"""

from __future__ import annotations

import time

from fastsmc_tpu import native
from fastsmc_tpu.io import writers


class IbdTextWriter(writers.IbdTextWriter):
    """``fastsmc_tpu.io.writers.IbdTextWriter`` whose writer thread never
    leaves queued items behind and whose ``close()`` raises the thread's
    error."""

    def _deflate_loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._thr_err is not None:
                    continue            # after an error: drop, still done
                if isinstance(item, tuple):
                    t0 = time.perf_counter()
                    buf = native.format_ibd(self._id_blob, self._id_off,
                                            *item[:8], str(self.chr),
                                            *item[8:])
                    if buf is None:
                        raise RuntimeError(
                            f"native IBD formatter returned no output for a "
                            f"block of {len(item[0])} records")
                    self.fmt_s += time.perf_counter() - t0
                else:
                    buf = item
                t0 = time.perf_counter()
                self._f.buffer.write(buf)
                self.deflate_s += time.perf_counter() - t0
            except BaseException as e:      # raised on the main thread
                self._thr_err = e
            finally:
                self._q.task_done()

    def close(self):
        """Drain the queue, stop the thread and close the file; raise the
        writer thread's error, if it had one."""
        if self._q is not None:
            self._q.join()
            self._q.put(None)
            self._thr.join()
            self._q = None
        self._f.close()
        if self._thr_err is not None:
            raise self._thr_err
