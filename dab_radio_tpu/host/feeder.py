"""Compute-overlapped H2D ingest: double-buffered feeder with backpressure.

The reference sustains real-time ingest by decoupling its reader and
demodulator threads with a blocking ring buffer
(reference examples/app_helpers/app_io_buffers.h:189-245 ThreadedRingBuffer:
a bounded producer/consumer queue whose writes block when the consumer lags).
This is the serving analog: a staging THREAD reads fixed-size rounds
from the byte source and uploads them to the device (`jax.device_put`)
while the serving loop's CURRENT round computes, handing finished device
arrays over a bounded queue.

With depth=2 (double buffering) the steady state is: round r computing on
device, round r+1 uploading H2D, round r+2 waiting in the source — the
round time becomes max(compute, H2D) instead of their sum. Backpressure is
the queue bound in both directions: a slow consumer blocks the staging
thread (and through it the source — a pipe/SDR driver sees the stall), and
a slow source starves the consumer, which blocks in `get()`.

`FeederStats` separates the four times that matter when deciding whether a
deployment is compute- or ingest-bound:
  stage_busy_s    staging-thread time spent reading + uploading
  producer_wait_s staging-thread time blocked on a full queue
                  (compute-bound: the chip is the bottleneck)
  consumer_wait_s consumer time blocked on an empty queue
                  (ingest-bound: the link/source is the bottleneck)
`tools/bench_fleet.py --fused --overlap` uses these plus three timed loops
(compute-only, H2D-only, overlapped) to report the overlap efficiency.
"""

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


@dataclass
class FeederStats:
    rounds: int = 0
    bytes: int = 0
    stage_busy_s: float = 0.0
    producer_wait_s: float = 0.0
    consumer_wait_s: float = 0.0
    error: Optional[BaseException] = field(default=None, repr=False)


def shared_stream_source(f, nb_streams: int, round_bytes: int,
                         tail_bytes: int):
    """Round source over ONE byte stream broadcast to N streams (the
    fleet_serve --shared-input topology). Yields (blk, tail) host uint8
    arrays of shape (N, round_bytes) / (N, tail_bytes); the tail is the
    head of the NEXT round (the fused program's timing-margin lookahead),
    so the source keeps one round of lookahead buffered. Final (partial)
    round is dropped — the fused program wants whole rounds."""
    def read_exact(n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = f.read(n - len(out))
            if not chunk:
                break
            out.extend(chunk)
        return bytes(out)

    cur = read_exact(round_bytes)

    def next_round() -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
        nonlocal cur
        if len(cur) < round_bytes:
            return None
        nxt = read_exact(round_bytes)
        if len(nxt) >= tail_bytes:
            tail = np.broadcast_to(
                np.frombuffer(nxt[:tail_bytes], np.uint8)[None],
                (nb_streams, tail_bytes))
        else:
            tail = None
        blk = np.broadcast_to(np.frombuffer(cur, np.uint8)[None],
                              (nb_streams, round_bytes))
        cur = nxt
        return blk, tail

    return next_round


class DoubleBufferedFeeder:
    """Stage (blk, tail) rounds onto the device ahead of the consumer.

    source: callable returning (blk, tail) host uint8 arrays — blk of
        shape (N, round_bytes), tail (N, tail_bytes) or None — or None at
        end of stream. Called only from the staging thread.
    depth: bounded queue size = rounds in flight beyond the one computing.
        2 = classic double buffering.
    device_put: override for jax.device_put (e.g. a sharded put via
        jax.device_put(x, sharding)); identity for host-only tests.
    """

    _DONE = object()

    def __init__(self, source: Callable, depth: int = 2, device_put=None):
        if device_put is None:
            import jax
            device_put = jax.device_put
        self._source = source
        self._put = device_put
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self.stats = FeederStats()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ingest-feeder")
        self._thread.start()

    def _run(self):
        st = self.stats
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                item = self._source()
                if item is None:
                    break
                blk, tail = item
                dev = (self._put(np.ascontiguousarray(blk)),
                       None if tail is None
                       else self._put(np.ascontiguousarray(tail)))
                st.stage_busy_s += time.perf_counter() - t0
                st.rounds += 1
                st.bytes += blk.size + (0 if tail is None else tail.size)
                t0 = time.perf_counter()
                while not self._stop.is_set():
                    try:
                        self._q.put(dev, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                st.producer_wait_s += time.perf_counter() - t0
        except BaseException as e:          # surface in the consumer
            st.error = e
        finally:
            # after close() nobody reads the queue, so give up rather than
            # wait on a slot that the last staged round may still hold
            while True:
                try:
                    self._q.put(self._DONE, timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def get(self, timeout: Optional[float] = None):
        """Next (blk, tail) device pair, or None at end of stream.
        Re-raises any staging-thread exception."""
        t0 = time.perf_counter()
        try:
            item = self._q.get(timeout=timeout)
        finally:
            self.stats.consumer_wait_s += time.perf_counter() - t0
        if item is self._DONE:
            if self.stats.error is not None:
                raise self.stats.error
            return None
        return item

    def __iter__(self) -> Iterator:
        while True:
            item = self.get()
            if item is None:
                return
            yield item

    def close(self):
        """Stop staging; drop queued rounds. Idempotent."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
