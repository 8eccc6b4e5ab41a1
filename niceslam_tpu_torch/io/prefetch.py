"""Background frame prefetcher: overlap host decoding with the card's work.

A worker thread stays ``prefetch_depth`` frames ahead of the SLAM loop,
decoding ``reader[i]`` and, for a CUDA device, copying color and depth into
pinned host tensors. :meth:`Prefetcher.__iter__` starts their host-to-device
copies ``non_blocking`` on the consumer's current stream, so each copy is
ordered with the compute queued there and needs no event across streams;
the caching host allocator keeps a pinned block until its copy has run. For
the CPU (or ``device=None``) the worker neither pins nor copies. A failure
in the worker is raised again from ``__iter__``; :meth:`close` stops the
worker and drains its queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .datasets.base import Frame, FrameReader


def _pinned(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).pin_memory()


class Prefetcher:
    def __init__(
        self,
        reader: FrameReader,
        prefetch_depth: int = 4,
        device=None,
        start: int = 0,
        end: Optional[int] = None,
    ):
        self.reader = reader
        self.q: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self.device = None if device is None else torch.device(device)
        self._cuda = self.device is not None and self.device.type == "cuda"
        self.start = start
        self.end = len(reader) if end is None else end
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for i in range(self.start, self.end):
                if self._stop.is_set():
                    return
                frame = self.reader[i]
                if self._cuda:
                    frame = Frame(
                        idx=frame.idx, color=_pinned(frame.color),
                        depth=_pinned(frame.depth), gt_c2w=frame.gt_c2w,
                    )
                self.q.put(frame)
        except BaseException as e:  # noqa: BLE001 — raised again in __iter__
            # A decoding failure must end the run, not pass for the end of
            # the stream.
            self.q.put(e)
        finally:
            self.q.put(None)

    def __iter__(self) -> Iterator[Frame]:
        while True:
            frame = self.q.get()
            if frame is None:
                return
            if isinstance(frame, BaseException):
                raise RuntimeError("prefetch worker failed while decoding a frame") from frame
            if self._cuda:
                frame = Frame(
                    idx=frame.idx,
                    color=frame.color.to(self.device, non_blocking=True),
                    depth=frame.depth.to(self.device, non_blocking=True),
                    gt_c2w=frame.gt_c2w,
                )
            yield frame

    def close(self):
        """Stop the worker, draining the queue until it has ended."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
        while not self.q.empty():
            self.q.get_nowait()
