"""Host <-> device copies that do not make the host wait on the device.

On CUDA a copy from pageable host memory synchronizes with the device, and
so does a blocking readback, which also waits for everything enqueued on
the stream before it.  `upload` stages numpy arrays in pinned memory and
copies them without blocking (torch's caching host allocator keeps a
staging buffer alive until its copy has run); `upload_packed` sends several
arrays as one such copy; `Readback` enqueues a copy into pinned memory and
records an event, so the host later waits for exactly the work enqueued
before it, not for work enqueued after.  On the CPU they are plain copies.
"""
from __future__ import annotations

import numpy as np
import torch

TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8}


def upload(a: np.ndarray, device) -> torch.Tensor:
    """`a` on `device`, in its dtype; on the CPU it shares `a`'s memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def upload_packed(arrays: dict, device) -> dict:
    """Each array of `arrays` (name -> numpy array) on `device`, in its
    dtype and shape, from one host-to-device copy of a byte buffer (each
    array at an 8-byte aligned offset)."""
    arrays = {k: np.ascontiguousarray(a) for k, a in arrays.items()}
    offsets, end = {}, 0
    for k, a in arrays.items():
        offsets[k] = end
        end += -(-a.nbytes // 8) * 8
    buf = np.zeros(max(end, 8), np.uint8)
    for k, a in arrays.items():
        buf[offsets[k]: offsets[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = upload(buf, device)
    return {k: dev[offsets[k]: offsets[k] + a.nbytes].view(TORCH_DTYPE[a.dtype]).view(a.shape)
            for k, a in arrays.items()}


class Readback:
    """A device tensor's values on the host, copied when made and waited for
    when read (`numpy()`)."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
