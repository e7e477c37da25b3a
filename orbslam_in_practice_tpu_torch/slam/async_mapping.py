"""Asynchronous local mapping: the keyframe epochs in a worker thread.

Port of ``orbslam_in_practice_tpu/slam/async_mapping.py``. Tracking queues
each new keyframe and keeps tracking frames while the worker runs its
mapping epoch (cull, create, fuse, local BA, cull keyframes, refresh), then
a loop-closure attempt. The mapper's stages take ``SlamMap.lock`` only to
assemble and to apply; the waits for the device in between run without it,
so the two threads interleave on the lock.

On the GPU both threads queue their work on the default CUDA stream, so
the device runs it in the order the lock gave it: work queued under the
lock reads the map's device tables before any later mutation of them. The
worker sets its own device and ``torch.no_grad()`` (both belong to the
thread) and never runs the extractor, whose kernels count their launches.

Consistency, as in ORB-SLAM: frames tracked between a keyframe's insertion
and the end of its epoch see the pre-epoch map. A loop closure found by the
worker is posted as ``(ref_kf, ref_seq, pose_before)``; the tracker applies
it when it next takes the map lock to track, or before its keyframe
decision, re-anchoring its last pose through the corrected reference
keyframe (``Tracking._consume_async_events``).

Each epoch, with its loop-closure attempt, leaves an epoch record in the
tracker's record (``StageTimer.epoch``) with the time it waited in the
queue; none of its spans lands in a frame's record.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

import torch

from orbslam_in_practice_tpu_torch.utils.logging import StageTimer


class AsyncMapperDriver:
    """Owns the mapping worker thread and the keyframe queue of one tracker.

    ``enqueue`` never blocks; the tracker's keyframe decision throttles
    insertion once ``pending()`` reaches ``QUEUE_MAX`` (ORB-SLAM's
    SetAcceptKeyFrames gate). A worker exception is re-raised on the
    tracking thread by ``raise_errors`` (called each frame, and by
    ``drain``). Epoch records go to ``record`` (the tracker's; its own
    unless given).
    """

    QUEUE_MAX = 2  # in flight + queued

    def __init__(self, tracker, record: StageTimer | None = None):
        self.tracker = tracker
        self.record = record if record is not None else StageTimer()
        device = tracker.device
        if device.type == "cuda" and device.index is None:
            # the current device belongs to the thread: pin the tracker's
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device
        self._q: queue.Queue = queue.Queue()
        self._pending = 0  # queued + in flight, guarded by _count_lock
        self._count_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._errors: list = []
        self.n_processed = 0  # epochs finished (or skipped) by the worker
        self._thread = threading.Thread(target=self._run, name="local-mapping", daemon=True)
        self._thread.start()

    # ---------------- producer side (tracking thread) ----------------

    def enqueue(self, smap, kf_id: int):
        """Queue keyframe ``kf_id`` of ``smap`` (call with smap.lock held:
        its insertion number is read here)."""
        tr = self.tracker
        with self._count_lock:
            self._pending += 1
            self._idle.clear()
        self._q.put((smap, tr.mapper, tr.loop_closer, kf_id, int(smap.kf_seq[kf_id]), time.perf_counter_ns()))

    def pending(self) -> int:
        with self._count_lock:
            return self._pending

    def idle(self) -> bool:
        return self.pending() == 0

    def drain(self, timeout: float | None = None) -> bool:
        """Wait until every queued epoch has been applied; re-raise a worker
        error. Returns False when ``timeout`` ran out first; raises if the
        worker thread is gone with epochs still pending."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._idle.wait(0.5 if deadline is None else min(0.5, max(deadline - time.monotonic(), 0.0))):
            if not self._thread.is_alive():
                self.raise_errors()
                raise RuntimeError("async mapping worker exited with epochs pending")
            if deadline is not None and time.monotonic() >= deadline:
                break
        self.raise_errors()
        return self._idle.is_set()

    def raise_errors(self):
        if self._errors:
            err = self._errors[:]
            self._errors.clear()
            raise RuntimeError(f"async mapping worker failed: {err[0]!r}") from err[0]

    def shutdown(self, timeout: float = 60.0):
        """Drain, then stop and join the worker; the thread is stopped and
        joined even when the drain raises a worker error."""
        try:
            self.drain(timeout)
        finally:
            self._q.put(None)
            self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    # ---------------- consumer side (worker thread) ----------------

    def _run(self):
        with torch.no_grad():
            while True:
                item = self._q.get()
                if item is None:
                    return
                try:
                    if self._device.type == "cuda":
                        torch.cuda.set_device(self._device)
                    self._process(*item)
                except Exception as e:  # surfaced on the tracking thread
                    logging.getLogger("orbslam_tpu_torch").exception("async mapping epoch failed (kf %d)", item[3])
                    self._errors.append(e)
                finally:
                    with self._count_lock:
                        self.n_processed += 1
                        self._pending -= 1
                        if self._pending == 0:
                            self._idle.set()

    def _process(self, smap, mapper, loop_closer, kf_id: int, kf_seq: int, queued_ns: int):
        with self.record.epoch(kf_seq, queued_ns):
            if not mapper.process_new_keyframe(smap, kf_id, kf_seq) or loop_closer is None:
                return
            tr = self.tracker
            # loop closing moves poses and landmarks wholesale: it holds the
            # map lock throughout (a rare, one-off stall of tracking)
            with smap.lock:
                if not smap.kf_valid_host()[kf_id] or int(smap.kf_seq[kf_id]) != kf_seq:
                    return
                ref_kf = tr.ref_kf
                pose_before = smap.hview("kf_pose")[ref_kf].copy() if ref_kf >= 0 else None
                ref_seq = int(smap.kf_seq[ref_kf]) if ref_kf >= 0 else -1
                if loop_closer.attempt(smap, kf_id, mapper):
                    # the geometry jumped: tracking re-anchors when it next
                    # takes the lock (Tracking._consume_async_events)
                    tr._pending_closure_rebase = (ref_kf, ref_seq, pose_before)
