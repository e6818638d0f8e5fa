"""Live transcription service: a front door over the packed
(continuous-batching) scheduler (port of
enhance_cb_whisper_tpu/runtime/serving.py).

:class:`TranscriptionService` runs :meth:`..models.cb_whisper.CBWhisper.forward_packed`
in a background worker thread: callers ``submit()`` utterances at any time
and collect transcripts by ticket.  The card decodes full-width windows
whenever work is queued and the worker blocks (no busy spin) when idle.

From ``generate_packed`` it inherits: a finished utterance hands its slot to
the next submission, and transcripts do not depend on the schedule, so a
ticket's text does not depend on what else was in flight.

Threading: ONE worker thread does all device work.  It selects the
module's device (``torch.cuda.set_device`` on a card) and runs under
no-grad (grad mode is per thread).  ``submit``, ``result``, ``swap_params``
and ``close`` are safe from any thread.  The in-flight count decides
whether the scheduler's stream blocks on the queue (idle) or answers
"nothing right now" (keep decoding the rows in flight); only the worker
touches it, so the decision is exact.  An error in the worker reaches the
caller through ``result``, ``submit`` and ``close``.

Each utterance's wait from ``submit`` to the scheduler taking it is
recorded as an ``ecw.serving.queue_wait`` span (id: its ticket;
:mod:`.profiler`).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import profiler

_CLOSE = object()


class _SwapCmd:
    def __init__(self, params):
        self.params = params


class TranscriptionService:
    """Ticketed transcription over a continuously batched CBWhisper.

    ``module`` needs ``forward_packed(stream, slots)`` yielding ``(order,
    transcript)`` (orders count from 0 in stream order, which is ticket
    order: one FIFO queue feeds the scheduler), ``generator`` with
    ``swap_params``, ``whisper_config`` and ``device``."""

    def __init__(self, module, slots: int = 4):
        self._module = module
        self._slots = int(slots)
        self._queue: "queue.Queue[Any]" = queue.Queue()
        self._cv = threading.Condition()
        self._results: Dict[int, str] = {}
        self._error: Optional[BaseException] = None
        self._finished = False
        self._closed = False
        self._next_ticket = 0
        self._inflight = 0  # admitted to the scheduler, result not yet posted
        self._n_mels = int(module.whisper_config.num_mel_bins)
        # the worker works on the module's card; a bare "cuda" means the
        # caller's current one (read here, in the caller's thread)
        device = torch.device(module.device)
        self._cuda_index = None
        if device.type == "cuda":
            self._cuda_index = device.index if device.index is not None else torch.cuda.current_device()
        self._worker = threading.Thread(target=self._run, name="ecw-serving", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client API

    def submit(self, features, attention_mask=None) -> int:
        """Queue one utterance (log-mel [1, n_mels, T] or [n_mels, T], a
        tensor or an array); returns the ticket to pass to :meth:`result`."""
        if not isinstance(features, torch.Tensor):
            features = np.asarray(features, np.float32)
        if features.ndim == 2:
            features = features[None]
        if features.ndim != 3 or features.shape[1] != self._n_mels:
            raise ValueError(
                f"features must be [1, {self._n_mels}, T] log-mel; got shape {tuple(features.shape)}"
            )
        with self._cv:
            if self._closed:
                raise RuntimeError("TranscriptionService is closed")
            if self._error is not None:
                raise RuntimeError("serving worker died") from self._error
            ticket = self._next_ticket
            self._next_ticket += 1
            # enqueue UNDER the lock: ticket order must equal queue order (the
            # scheduler numbers results by stream position), and a ticket
            # issued before close() must land ahead of its sentinel
            self._queue.put((features, attention_mask, ticket, time.perf_counter_ns()))
        return ticket

    def result(self, ticket: int, timeout: Optional[float] = None) -> str:
        """Block until ``ticket``'s transcript is ready and return it.
        One-shot: the transcript is dropped once read, so a long-running
        service does not keep every transcript it made."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: ticket in self._results or self._error is not None or self._finished,
                timeout,
            )
            if ticket in self._results:
                return self._results.pop(ticket)
            if self._error is not None:
                raise RuntimeError("serving worker died") from self._error
            if not ok:
                raise TimeoutError(f"ticket {ticket} not ready within {timeout}s")
            raise RuntimeError(f"service finished without producing ticket {ticket}")

    def swap_params(self, params) -> None:
        """Hot checkpoint rollout into the LIVE service, queued like a
        submission and run on the worker thread as an epoch barrier: the
        scheduler first drains every utterance in flight or queued ahead
        (no transcript mixes checkpoints), then calls
        ``generator.swap_params``, then admits the work queued behind it
        under the new weights.  An architecture mismatch kills the worker
        like any decode error (it surfaces through :meth:`result`)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("TranscriptionService is closed")
            if self._error is not None:
                raise RuntimeError("serving worker died") from self._error
            self._queue.put(_SwapCmd(params))

    def close(self, wait: bool = True) -> None:
        """Stop taking work; the scheduler drains everything already
        submitted.  With ``wait`` (the default) blocks until it has."""
        with self._cv:
            if self._closed:
                if wait:
                    self._worker.join()
                return
            self._closed = True
            self._queue.put(_CLOSE)
        if wait:
            self._worker.join()
            with self._cv:
                if self._error is not None:
                    raise RuntimeError("serving worker died") from self._error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(wait=exc[0] is None)

    # ---------------------------------------------------------------- worker

    def _stream(self):
        pending_swap = None
        while True:
            if pending_swap is not None:
                if self._inflight > 0:
                    # epoch barrier: admit nothing, let the work in flight
                    # drain under the OLD weights
                    yield None
                    continue
                self._module.generator.swap_params(pending_swap)
                pending_swap = None
            # block on the queue only when the scheduler holds no rows;
            # otherwise answer None so the rows in flight keep decoding
            # (generate_packed's live protocol)
            try:
                item = self._queue.get(block=self._inflight == 0)
            except queue.Empty:
                yield None
                continue
            if item is _CLOSE:
                return
            if isinstance(item, _SwapCmd):
                pending_swap = item.params
                continue
            features, attention_mask, ticket, t_submit = item
            profiler.interval("ecw.serving.queue_wait", t_submit, id=ticket)
            self._inflight += 1
            yield features, attention_mask

    def _run(self):
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            with torch.no_grad():
                for order, text in self._module.forward_packed(self._stream(), slots=self._slots):
                    with self._cv:
                        self._results[order] = text
                        self._inflight -= 1
                        self._cv.notify_all()
        except BaseException as e:  # reaches the caller through result()/submit()/close()
            with self._cv:
                self._error = e
                self._cv.notify_all()
        finally:
            with self._cv:
                self._finished = True
                self._cv.notify_all()
