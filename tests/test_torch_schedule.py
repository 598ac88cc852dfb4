"""The port's copy of the continuous-batching scheduler against the JAX
``repro.core.schedule``: the same random submit / admit / finish / release
sequences (with and without the paged-KV page gate) place the same requests
in the same slots at the same virtual times, ``poisson_arrivals`` replays
the same arrival times for the same seeds, and the page gate keeps the FIFO
head waiting until pages free (counting reservations made in the same
admit call)."""
import numpy as np
import pytest

from repro.core import kvstore as JK, schedule as J
from repro_torch.core import kvstore as KS, schedule as S


@pytest.mark.parametrize("n,rate,seed", [(6, 0.0, 0), (8, 0.5, 1), (12, 2.0, 7), (5, 0.1, 3)])
def test_poisson_arrivals_match_jax(n, rate, seed):
    np.testing.assert_array_equal(S.poisson_arrivals(n, rate, seed),
                                  J.poisson_arrivals(n, rate, seed))


def _drive(lib, klib, seed, slots, gated):
    """Replay one random serving trace; returns the event log."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 12))
    arrivals = np.sort(rng.integers(0, 8, n)).astype(float)[rng.permutation(n)]
    need = rng.integers(1, 5, n)
    alloc = klib.PageAllocator(8)
    held = {}
    kw = {}
    if gated:
        kw = dict(pages_for=lambda r: int(need[r.req_id]),
                  free_pages=lambda: alloc.free_count, total_pages=8)
    sched = lib.Scheduler(slots, **kw)
    for i in range(n):
        sched.submit(lib.Request(req_id=i, prompt=np.arange(4), arrival=float(arrivals[i])))
    log, clock = [], 0.0
    while not sched.idle() and clock < 200:
        for slot, req in sched.admit(clock):
            if gated:
                held[slot] = alloc.alloc(int(need[req.req_id]))
            sched.mark_decoding(slot)
            log.append(("admit", clock, slot, req.req_id))
        mask = sched.decoding_mask()
        log.append(("mask", clock, tuple(mask.tolist()), round(sched.occupancy(), 6),
                    round(sched.page_occupancy(), 6)))
        for slot in np.nonzero(mask)[0]:
            if rng.random() < 0.4:
                req = sched.finish(int(slot), now=clock + 1)
                if gated:
                    alloc.free(held.pop(int(slot)))
                sched.release(int(slot))
                log.append(("done", clock, int(slot), req.req_id, req.queue_delay))
        nxt = sched.next_arrival()
        log.append(("next", nxt))
        clock += 1.0
    return log


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_scheduler_traces_match_jax(seed, slots, gated):
    assert _drive(S, KS, seed, slots, gated) == _drive(J, JK, seed, slots, gated)


def test_page_gate_holds_the_fifo_head():
    """With the pool held, an arrived request stays queued; it admits as
    soon as pages free up, and FIFO order survives the wait; two requests
    whose pages fit only one are not both placed in one admit call."""
    alloc = KS.PageAllocator(6)
    sched = S.Scheduler(2, pages_for=lambda r: 3, free_pages=lambda: alloc.free_count,
                        total_pages=6)
    hold = alloc.alloc(5)
    for i in range(2):
        sched.submit(S.Request(req_id=i, prompt=np.arange(4)))
    assert sched.admit(0.0) == [] and len(sched.queue) == 2
    assert sched.page_occupancy() == pytest.approx(5 / 6)
    alloc.free(hold[:2])
    assert [r.req_id for _, r in sched.admit(1.0)] == [0]
    alloc.alloc(3)
    assert sched.admit(1.0) == []
    alloc.free(hold[2:])
    assert [r.req_id for _, r in sched.admit(2.0)] == [1]
    alloc2 = KS.PageAllocator(4)
    s2 = S.Scheduler(2, pages_for=lambda r: 3, free_pages=lambda: alloc2.free_count,
                     total_pages=4)
    for i in range(2):
        s2.submit(S.Request(req_id=i, prompt=np.arange(4)))
    assert [r.req_id for _, r in s2.admit(0.0)] == [0]


def test_transitions_and_arguments_are_checked():
    with pytest.raises(ValueError):
        S.Scheduler(0)
    with pytest.raises(ValueError, match="pair"):
        S.Scheduler(1, pages_for=lambda r: 1)
    with pytest.raises(ValueError, match="bucket_of"):
        S.Scheduler(1, policy="bucket")
    with pytest.raises(ValueError, match="policy"):
        S.Scheduler(1, policy="lifo")
    sched = S.Scheduler(1)
    with pytest.raises(RuntimeError):
        sched.mark_decoding(0)
    with pytest.raises(RuntimeError):
        sched.finish(0, now=0.0)
    sched.submit(S.Request(req_id=0, prompt=np.arange(3), arrival=2.0))
    assert sched.admit(1.0) == [] and sched.next_arrival() == 2.0
    with pytest.raises(ValueError, match="not in the queue"):
        sched.queue.remove(S.Request(req_id=9, prompt=np.arange(2)))
