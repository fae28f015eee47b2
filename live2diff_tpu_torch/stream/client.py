"""PipelinedStream: uploads overlapped with the stream step.

Port of ``live2diff_tpu/stream/client.py``. The synchronous loop uploads a
frame, runs the step, waits for the output, and repeats. This client
pipelines the three:

  uploader threads:  host frame -> pinned buffer -> device (upload stream)
  dispatch (caller): device frame -> the step (one graph replay on CUDA)
  completion:        a bounded window of outputs in flight; the caller
                     waits only for the oldest, when the window is full

so the steady frame time is the larger of the upload and the step, not
their sum. Frames may be uint8 (four times cheaper to move), normalised on
the device inside the step.

On CUDA an upload copies the frame into one of a ring of pinned host
buffers, then to the device with ``non_blocking=True`` on an upload
``torch.cuda.Stream``, and records an event. That event keeps the pinned
buffer from being refilled while its copy is in flight, and the compute
stream waits on it before the step reads the frame. Each output gets an
event on the compute stream, and ``_pop_ready`` waits on that event alone.
On the CPU an upload is ``torch.as_tensor`` and nothing waits.

``_transfer`` and ``_wait`` are the hooks a test replaces to fake the
transport (as the JAX tests fake ``jax.device_put``).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

# a frame (or a batch of frames) on the device, and the event its upload
# recorded (None where nothing is in flight)
Upload = Tuple[torch.Tensor, Optional["torch.cuda.Event"]]


class _UploadError:
    """Carries an exception from an uploader thread to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc


class _PinnedRing:
    """Pinned host buffers for uploads, each guarded by the event of the
    last copy that read it. A buffer is taken from the free list, waited
    on, filled, copied and handed back."""

    def __init__(self, size: int):
        self._free: queue.Queue = queue.Queue()
        for _ in range(size):
            self._free.put([None, None])  # [pinned buffer, event of its last copy]

    def upload(self, frames: np.ndarray, device: torch.device, stream) -> Upload:
        host = torch.from_numpy(frames)
        slot = self._free.get()
        try:
            buf, event = slot
            if event is not None:
                event.synchronize()  # its last copy has left the buffer
            if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                buf = slot[0] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            buf.copy_(host)
            with torch.cuda.stream(stream):
                dev = torch.empty(host.shape, dtype=host.dtype, device=device)
                dev.copy_(buf, non_blocking=True)
                event = slot[1] = torch.cuda.Event()
                event.record(stream)
            return dev, event
        finally:
            self._free.put(slot)


class PipelinedStream:
    """Throughput-oriented wrapper over ``StreamDiffusionDepth``, or over a
    ``MultiStream``, whose items are ``[S, H, W, 3]`` rounds (the upload
    path takes an item of any shape).

    Usage::

        ps = PipelinedStream(stream, state)
        for out in ps.map(frames):   # host frames, uint8 or float32 in [-1, 1]
            ...

    or incrementally with ``submit(frame)`` / ``drain()``. Outputs come in
    input order, whatever order the uploads finish in; none is dropped; an
    upload that fails twice raises to the caller, and the uploader threads
    are joined on an error and when the caller abandons the generator.
    ``upload_threads`` uploads run at once; ``upload_batch`` frames go up in
    one copy (adding ``upload_batch - 1`` frames of input latency);
    ``upload_depth`` bounds the uploads waiting for the step.
    """

    def __init__(
        self,
        stream,
        state,
        max_in_flight: int = 2,
        upload_depth: int = 2,
        upload_threads: int = 1,
        upload_batch: int = 1,
    ):
        self.stream = stream
        self.state = state
        self.max_in_flight = max_in_flight
        self.upload_depth = upload_depth
        self.upload_threads = upload_threads
        self.upload_batch = upload_batch
        self.device = torch.device(getattr(stream, "device", "cpu"))
        self._cuda = self.device.type == "cuda"
        self._window = max(2 * upload_threads, upload_depth, 4)  # uploads ahead of the step
        self._ring = _PinnedRing(max(upload_depth, upload_threads) + 1) if self._cuda else None
        self._upload_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._in_flight: collections.deque = collections.deque()
        self.frame_times: List[float] = []
        self._last_emit: Optional[float] = None

    # -- the transport: hooks a test may replace ------------------------------

    def _transfer(self, frames) -> Upload:
        """Host frames (or one frame) -> (the same on the device, the event
        of their copy). Frames already on the device are taken as they are."""
        if isinstance(frames, torch.Tensor) and frames.device == self.device:
            return frames, None
        if not self._cuda:
            return torch.as_tensor(frames), None
        host = frames.numpy() if isinstance(frames, torch.Tensor) else np.asarray(frames)
        return self._ring.upload(np.ascontiguousarray(host), self.device, self._upload_stream)

    def _wait(self, event) -> None:
        """Block until the work before ``event`` (an output's) is done."""
        if event is not None:
            event.synchronize()

    # -- incremental API ------------------------------------------------------

    def submit(self, frame):
        """Dispatch one frame; returns a ready output if the window is full."""
        return self._dispatch(self._transfer(frame))

    def drain(self) -> Iterator[torch.Tensor]:
        while self._in_flight:
            yield self._pop_ready()

    def _dispatch(self, upload: Upload):
        frame, event = upload
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            frame.record_stream(compute)  # made on the upload stream, read here
        self.state, out = self.stream(self.state, frame)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        self._in_flight.append((out, done))
        if len(self._in_flight) > self.max_in_flight:
            return self._pop_ready()
        return None

    def _pop_ready(self):
        out, done = self._in_flight.popleft()
        self._wait(done)
        now = time.perf_counter()
        if self._last_emit is not None:
            self.frame_times.append(now - self._last_emit)
        self._last_emit = now
        return out

    # -- bulk API with threaded uploads --------------------------------------

    def map(self, frames: Iterable) -> Iterator[torch.Tensor]:
        """Stream ``frames`` through the pipeline with background uploads.

        A feeder thread cuts the input into chunks of ``upload_batch``
        frames; ``upload_threads`` uploader threads move chunks to the
        device (a failed transfer is retried once), at most a window of
        chunks ahead of the step; the caller's thread dispatches them in
        input order from a reorder buffer."""
        batch = max(1, self.upload_batch)
        in_q: queue.Queue = queue.Queue(maxsize=max(self.upload_depth, self.upload_threads))
        ready: dict = {}
        cv = threading.Condition()
        n_chunks = None  # set by the feeder once the input is exhausted
        next_i = 0
        abort = False  # set when the consumer raises or abandons the generator

        def put(item) -> bool:
            while not abort:
                try:
                    in_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def feeder():
            nonlocal n_chunks
            i, chunk = 0, []
            for f in frames:
                chunk.append(f)
                if len(chunk) == batch:
                    if not put((i, chunk)):
                        break
                    i, chunk = i + 1, []
            else:
                if chunk and put((i, chunk)):
                    i += 1
            with cv:
                n_chunks = i
                cv.notify_all()
            for _ in range(self.upload_threads):
                if not put(None):
                    break

        def upload(chunk):
            if len(chunk) == 1:
                return self._transfer(chunk[0])
            first = chunk[0]
            stack = (torch.stack(chunk) if isinstance(first, torch.Tensor)
                     else np.stack([np.asarray(f) for f in chunk]))
            return self._transfer(stack)

        def uploader():
            while not abort:
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is None:
                    return
                i, chunk = item
                with cv:
                    # bound the reorder buffer; the chunk the consumer
                    # waits for (i == next_i) is never held back
                    cv.wait_for(lambda: abort or i < next_i + self._window)
                    if abort:
                        return
                try:
                    dev = (upload(chunk), len(chunk))
                except Exception:
                    try:  # one retry for a transient transport error
                        dev = (upload(chunk), len(chunk))
                    except Exception as e:  # raised in the consumer
                        dev = _UploadError(e)
                with cv:
                    ready[i] = dev
                    cv.notify_all()

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=uploader, daemon=True)
                    for _ in range(self.upload_threads)]
        for t in threads:
            t.start()
        try:
            while True:
                with cv:
                    cv.wait_for(lambda: next_i in ready
                                or (n_chunks is not None and next_i >= n_chunks))
                    if next_i not in ready:
                        break
                    dev = ready.pop(next_i)
                    next_i += 1
                    cv.notify_all()
                if isinstance(dev, _UploadError):
                    raise dev.exc
                (frame, event), n = dev
                for j in range(n):
                    out = self._dispatch((frame[j] if n > 1 else frame, event))
                    if out is not None:
                        yield out
            yield from self.drain()
        finally:
            # normal exit: the threads are done and join at once. On an
            # error or an abandoned generator, wake them all (the feeder and
            # uploaders poll every 0.1 s) and join, so no thread outlives
            # the generator.
            abort = True
            with cv:
                cv.notify_all()
            for t in threads:
                t.join()
            ready.clear()

    # -- stats ----------------------------------------------------------------

    def throughput_fps(self) -> float:
        times = self.frame_times
        return 1.0 / (sum(times) / len(times)) if times else 0.0
