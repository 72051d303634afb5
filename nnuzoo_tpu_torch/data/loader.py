"""Host -> device training data feed (port of ``nnuzoo_tpu/data/loader.py``).

A worker thread runs the host-side ``PatchSampler`` and stages its batches on
the device while augmentation and the train step run there. On a CUDA device
each array goes through pinned host memory and is copied on a side stream;
the batch carries the copy's event, which ``next()`` makes the caller's
current stream wait for, so the caller never reads an unfinished copy. On the
CPU the arrays are only converted to tensors.
"""

import queue
import threading

import numpy as np
import torch

from .._device import resolve_device


class DevicePrefetcher:
    """Pulls numpy batches from ``sampler``, transfers them to ``device`` and
    keeps ``buffer_size`` batches in flight. ``next()`` gives a batch dict of
    tensors on the device (values that are no arrays pass through)."""

    def __init__(self, sampler, buffer_size: int = 2, device="cuda"):
        self.sampler = sampler
        self.device = resolve_device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._exc = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _transfer(self, batch: dict):
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items() if isinstance(v, np.ndarray)}
        out = {k: v for k, v in batch.items() if k not in arrays}
        if self._copy_stream is None:
            out.update(arrays)
            return out, None
        with torch.cuda.stream(self._copy_stream):
            for k, t in arrays.items():
                out[k] = t.pin_memory().to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return out, done

    def _worker(self):
        try:
            while not self._stop.is_set():
                item = self._transfer(next(self.sampler))
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced on next()
            self._exc = e

    def __next__(self):
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                batch, done = self._queue.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive() and self._exc is None:
                    raise RuntimeError("prefetch thread died without an exception")
                continue
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            return batch

    def __iter__(self):
        return self

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
