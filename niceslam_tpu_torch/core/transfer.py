"""Copies between the host and the card that do not wait for the stream.

A plain ``tensor.to("cuda")`` of host memory, and a plain ``.cpu()`` of a
card tensor, wait until everything queued on the stream has run: with one
stream that is all the work the host has queued so far. The SLAM loop moves
small things both ways every frame (poses, window indices, loss tails), so
both directions go through pinned host memory here:

- :func:`to_device` copies a host array into pinned memory and starts the
  host-to-device copy ``non_blocking``; the caching host allocator keeps the
  pinned block until the copy has run.
- :class:`HostCopy` starts a device-to-host copy into a pinned tensor,
  ``non_blocking``, and records an event; :meth:`HostCopy.numpy` waits for
  that event only, which has long completed when it is read one event later.

On the CPU both are plain copies with no event.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``a`` (a numpy array, a number sequence or a tensor) as a tensor on
    ``device``, in ``dtype`` if given; a no-op for a tensor already there."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    t = torch.as_tensor(np.asarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A copy of device tensor ``t`` on the host, started now, read later."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.detach().clone()

    def numpy(self) -> np.ndarray:
        """The values, after waiting for the copy's event (if it has not
        completed yet)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
