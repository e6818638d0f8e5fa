"""The port's live ``TranscriptionService`` vs the JAX package's
(``tests/test_serving.py`` case for case), on the CPU at tiny dims:
ticketed results equal to each utterance's own ``slots=1`` decode, an idle
worker that wakes for a late submission, close() draining what was
queued, shape validation, a worker error that reaches the caller, the hot
swap as an epoch barrier, and vacant slots kept out of int8 calibration.

Every transcript is held to the JAX service's for the same utterance; the
JAX services run once, in a module fixture.  Every wait has a timeout, so
a hung worker fails its test instead of stalling the run."""

import threading
import time

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.runtime.serving import TranscriptionService as JaxService
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.runtime import profiler
from enhance_cb_whisper_tpu_torch.runtime.serving import TranscriptionService

from test_torch_packed import cb_pipelines, mels, whisper_params

TIMEOUT = 120  # seconds: a first call of the JAX side compiles on one core

# the utterances of each case: mel lengths and the numpy seed of each
UTTERANCES = {
    "solo": [(130, 400), (60, 401), (200, 402), (90, 403)],
    "late": [(130, 500), (60, 501)],
    "drain": [(130, 600), (60, 601), (90, 602)],
    "swap_old": [(130, 900)],
}


def _mel(length, seed):
    return mels([length], seed)[0]


def _join(svc):
    svc.close(wait=False)
    svc._worker.join(TIMEOUT)
    assert not svc._worker.is_alive(), "the serving worker did not stop"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_texts():
    """The JAX service's transcript of every utterance the cases submit:
    all of them through one service of 2 slots, then a swap to the second
    checkpoint and the swap case's late utterance; then an int8 service of
    4 slots over one 3-window utterance."""
    jax_cb, _ = cb_pipelines()
    out = {}
    svc = JaxService(jax_cb, slots=2)
    keys = [(n, s) for case in UTTERANCES.values() for n, s in case]
    tickets = {key: svc.submit(_mel(*key)) for key in keys}
    tickets["zeros"] = svc.submit(np.zeros((8, 130), np.float32))
    svc.swap_params(whisper_params(1))
    tickets["swap_new"] = svc.submit(_mel(60, 901))
    for key, ticket in tickets.items():
        out[key] = svc.result(ticket, timeout=TIMEOUT)
    svc.close(wait=False)
    svc._worker.join(TIMEOUT)

    jax_cb.generator.swap_params(whisper_params())
    jax_cb.enable_int8_spotting(calibration_batches=4)
    with JaxService(jax_cb, slots=4) as svc:
        out["int8"] = svc.result(svc.submit(_mel(130, 950)), timeout=TIMEOUT)
    out["int8_calibration_rows"] = len(jax_cb._int8_calib_stacks)
    return out


@pytest.fixture(scope="module")
def port_cb():
    return cb_pipelines()[1]


def test_submit_result_matches_solo(port_cb, jax_texts):
    """Four utterances of unequal lengths through 2 slots: each ticket's
    text equals the utterance's own slots=1 decode and the JAX service's."""
    keys = UTTERANCES["solo"]
    solo = [dict(port_cb.forward_packed(iter([(_mel(*key), None)]), slots=1))[0] for key in keys]
    with TranscriptionService(port_cb, slots=2) as svc:
        tickets = [svc.submit(_mel(*key)) for key in keys]
        got = [svc.result(t, timeout=TIMEOUT) for t in tickets]
    assert got == solo == [jax_texts[key] for key in keys]
    assert any(got)


def test_idle_then_late_submission(port_cb, jax_texts):
    """The worker blocks when idle (alive, no error) and takes a
    submission that arrives later; a tensor is accepted as an array is."""
    first, second = UTTERANCES["late"]
    svc = TranscriptionService(port_cb, slots=2)
    try:
        assert svc.result(svc.submit(_mel(*first)), timeout=TIMEOUT) == jax_texts[first]
        time.sleep(0.3)  # the worker sits blocked on its queue
        assert svc._worker.is_alive() and svc._error is None
        ticket = svc.submit(torch.from_numpy(_mel(*second)))
        assert svc.result(ticket, timeout=TIMEOUT) == jax_texts[second]
    finally:
        _join(svc)


def test_close_drains_pending(port_cb, jax_texts):
    """close() refuses new work but drains everything already queued."""
    keys = UTTERANCES["drain"]
    svc = TranscriptionService(port_cb, slots=2)
    tickets = [svc.submit(_mel(*key)) for key in keys]
    _join(svc)
    assert [svc.result(t, timeout=5) for t in tickets] == [jax_texts[key] for key in keys]
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_mel(*keys[0]))
    with pytest.raises(RuntimeError, match="without producing"):
        svc.result(len(keys), timeout=5)


def test_submit_validates_shape(port_cb, jax_texts):
    svc = TranscriptionService(port_cb, slots=2)
    try:
        with pytest.raises(ValueError, match="log-mel"):
            svc.submit(np.zeros((1, 5, 60), np.float32))  # wrong n_mels
        with pytest.raises(ValueError, match="log-mel"):
            svc.submit(np.zeros((2, 1, 8, 60), np.float32))
        # a 2-D input becomes [1, n_mels, T]
        ticket = svc.submit(np.zeros((8, 130), np.float32))
        assert svc.result(ticket, timeout=TIMEOUT) == jax_texts["zeros"]
    finally:
        _join(svc)


def test_worker_error_propagates(port_cb, monkeypatch):
    """A decode failure reaches result(), submit() and close() instead of
    hanging the callers; the worker ends."""
    svc = TranscriptionService(port_cb, slots=2)

    def boom(*args, **kwargs):
        raise RuntimeError("injected decode failure")

    # every window computes its cross K/V, whichever hook encodes
    monkeypatch.setattr(svc._module.generator, "_cross_kv_fn", boom)
    ticket = svc.submit(_mel(130, 700))
    with pytest.raises(RuntimeError, match="worker died") as err:
        svc.result(ticket, timeout=TIMEOUT)
    assert "injected decode failure" in str(err.value.__cause__)
    with pytest.raises(RuntimeError, match="worker died"):
        svc.submit(_mel(60, 701))
    svc._worker.join(TIMEOUT)
    assert not svc._worker.is_alive()
    with pytest.raises(RuntimeError, match="worker died"):
        svc.close()


def test_worker_runs_without_grad(port_cb):
    """Grad mode is per thread: the worker decodes under no_grad even when
    the caller's thread has grad on (a graph kept per step would grow
    memory step by step)."""
    modes = []
    real = port_cb.generator._decode_prompted
    port_cb.generator._decode_prompted = lambda *a, **k: modes.append(torch.is_grad_enabled()) or real(*a, **k)
    try:
        assert torch.is_grad_enabled()
        svc = TranscriptionService(port_cb, slots=2)
        try:
            svc.result(svc.submit(_mel(60, 401)), timeout=TIMEOUT)
        finally:
            _join(svc)
    finally:
        del port_cb.generator._decode_prompted
    assert modes and not any(modes)


def test_service_hot_swap_epoch_barrier(jax_texts):
    """swap_params on the LIVE service: the utterance before the swap
    decodes under the old checkpoint, the one after under the new (each
    equal to the JAX service's), the swap waits for the work in flight,
    and a checkpoint of another architecture kills the worker with the
    mismatch as the cause."""
    old = UTTERANCES["swap_old"][0]
    _, fresh_new = cb_pipelines(params=whisper_params(1))
    solo_new = dict(fresh_new.forward_packed(iter([(_mel(60, 901), None)]), slots=1))[0]

    _, cb = cb_pipelines()
    svc = TranscriptionService(cb, slots=2)
    try:
        t1 = svc.submit(_mel(*old))
        svc.swap_params(from_jax_whisper_params(whisper_params(1), device="cpu"))
        t2 = svc.submit(_mel(60, 901))
        assert svc.result(t1, timeout=TIMEOUT) == jax_texts[old]
        assert svc.result(t2, timeout=TIMEOUT) == solo_new == jax_texts["swap_new"]
        assert jax_texts[old] != dict(fresh_new.forward_packed(iter([(_mel(*old), None)]), slots=1))[0]

        bad = whisper_params()
        bad["decoder"]["embed_tokens"]["weight"] = bad["decoder"]["embed_tokens"]["weight"][:, :16]
        t3 = svc.submit(_mel(60, 902))
        svc.swap_params(from_jax_whisper_params(bad, device="cpu"))
        assert isinstance(svc.result(t3, timeout=TIMEOUT), str)  # queued ahead of the swap
        with pytest.raises(RuntimeError, match="worker died") as err:
            svc.result(t3 + 1, timeout=TIMEOUT)
        assert isinstance(err.value.__cause__, ValueError)
        assert "architecture mismatch" in str(err.value.__cause__)
    finally:
        svc.close(wait=False)
        svc._worker.join(TIMEOUT)
    assert not svc._worker.is_alive()


def test_vacant_slots_excluded_from_int8_calibration(jax_texts):
    """One 3-window utterance through 4 slots: the calibration set gets its
    3 real segments and none of the vacant zero-mel rows (a leak would
    have completed a 4-segment calibration in the first window), as in the
    JAX service."""
    _, cb = cb_pipelines()
    cb.enable_int8_spotting(calibration_batches=4)
    with TranscriptionService(cb, slots=4) as svc:
        text = svc.result(svc.submit(_mel(130, 950)), timeout=TIMEOUT)
    assert text == jax_texts["int8"]
    assert cb._int8_pending, "calibration completed early: zero rows leaked in"
    assert len(cb._int8_calib_stacks) == 3 == jax_texts["int8_calibration_rows"]


def test_submit_is_safe_from_many_threads(port_cb, jax_texts):
    """Tickets submitted from several threads at once each get their own
    utterance's transcript."""
    keys = UTTERANCES["solo"] + UTTERANCES["drain"]
    tickets = {}
    svc = TranscriptionService(port_cb, slots=3)
    try:
        def submit(key):
            tickets[key] = svc.submit(_mel(*key))

        threads = [threading.Thread(target=submit, args=(key,)) for key in keys]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert sorted(tickets.values()) == list(range(len(keys)))
        for key, ticket in tickets.items():
            assert svc.result(ticket, timeout=TIMEOUT) == jax_texts[key]
    finally:
        _join(svc)


def test_queue_wait_span_per_ticket(port_cb):
    """Each ticket's wait from submit to the scheduler taking it is one
    ``ecw.serving.queue_wait`` span on the worker thread, its id the
    ticket; each launch's spotting nests in its ``ecw.scheduler.window``."""
    keys = UTTERANCES["drain"]
    t0 = time.perf_counter()
    with TranscriptionService(port_cb, slots=2) as svc:
        tickets = [svc.submit(_mel(*key)) for key in keys]
        for ticket in tickets:
            svc.result(ticket, timeout=TIMEOUT)
    got = profiler.spans(since_s=t0)
    waits = [s for s in got if s["name"] == "ecw.serving.queue_wait"]
    assert sorted(s["id"] for s in waits) == tickets
    assert all(t0 < s["start_s"] <= s["end_s"] and s["thread"] == "ecw-serving" for s in waits)
    windows = {s["seq"]: s for s in got if s["name"] == "ecw.scheduler.window"}
    assert windows and all(s["attrs"]["slots"] == 2 and set(s["attrs"]) == {"slots", "self_kv_bytes", "cross_kv_bytes"}
                           for s in windows.values())
    # the occupied slots' orders (stream order is ticket order); a
    # segment that takes a second window appears in two launches
    assert {o for s in windows.values() for o in s["id"]} == set(tickets)
    assert all(1 <= len(s["id"]) <= 2 for s in windows.values())
    for name in ("ecw.cbw.encoder", "ecw.cbw.spotter"):
        inner = [s for s in got if s["name"] == name]
        assert len(inner) == len(windows) and all(s["parent"] in windows for s in inner), name
        assert all(s["attrs"] == {"rows": 2} and s["device_ms"] is None for s in inner)
