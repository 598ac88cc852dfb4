"""Continuous-batching request admission and refresh/reuse schedule
calibration — the PyTorch port's copy of ``repro.core.schedule`` (pure
numpy; the port imports nothing of the JAX package, so it keeps its own
copy).

Part 1 — continuous batching.

`RequestQueue` is a FIFO of `Request`s with arrival times measured on the
serving loop's virtual clock (fused-step index); `Scheduler` owns a fixed
set of engine batch slots and tracks each through free -> prefilling ->
decoding -> finished -> free. The engine asks the scheduler which arrived
requests fit into freed slots (`admit`), marks them decoding once their
per-slot re-prefill has landed in the batch cache, and hands slots back on
completion (`finish`/`release`). With the paged KV store, admission is
gated on free pages too; under the bucket policy it prefers requests of a
context bucket that already has live rows. The scheduler never touches
device state.

Part 2 — refresh/reuse schedule calibration: training-free greedy search
(paper §5.2). Given an ``eval_fn`` that returns the verification logits of
a calibration batch under a schedule, greedily grow the set of REUSE
layers, each round keeping the candidate with the smallest output-logit KL
divergence against the all-refresh baseline while it stays under
``kl_budget``. Layer 0 is never a candidate (mandatory refresh).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------ continuous batching
class SlotState(enum.Enum):
    FREE = "free"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One queued generation request. ``arrival`` / ``admitted_at`` /
    ``finished_at`` are virtual-clock times (fused-step indices), so queue
    delays are deterministic and testable without wall-clock noise."""
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int = 0          # 0 = serve config default
    arrival: float = 0.0
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def queue_delay(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.arrival


class RequestQueue:
    """FIFO over arrived requests: pop order is (arrival, submission order) —
    submission order is the list order, kept stable by pop_arrived's strict
    ``<`` comparison."""

    def __init__(self):
        self._items: List[Request] = []

    def submit(self, req: Request) -> None:
        self._items.append(req)

    def __len__(self) -> int:
        return len(self._items)

    def pop_arrived(self, now: float) -> Optional[Request]:
        """Earliest-arrival request with arrival <= now (stable on ties)."""
        best_i = self._best_arrived(now)
        return self._items.pop(best_i) if best_i is not None else None

    def peek_arrived(self, now: float) -> Optional[Request]:
        """Like pop_arrived but non-destructive — admission gates (free
        slots AND free pages) inspect the head before committing to it."""
        best_i = self._best_arrived(now)
        return self._items[best_i] if best_i is not None else None

    def peek_arrived_where(self, now: float, pred) -> Optional[Request]:
        """Earliest arrived request satisfying ``pred`` (stable on ties), or
        None — the bucket-aware admission policy's preference probe."""
        best_i = self._best_arrived(now, pred)
        return self._items[best_i] if best_i is not None else None

    def remove(self, req: Request) -> None:
        """Identity-based removal: dataclass __eq__ would compare the
        ndarray prompt field (ambiguous truth value)."""
        for i, r in enumerate(self._items):
            if r is req:
                self._items.pop(i)
                return
        raise ValueError(f"request {req.req_id} is not in the queue")

    def _best_arrived(self, now: float, pred=None) -> Optional[int]:
        best_i = None
        for i, r in enumerate(self._items):
            if r.arrival <= now and (pred is None or pred(r)) and \
                    (best_i is None
                     or r.arrival < self._items[best_i].arrival):
                best_i = i
        return best_i

    def next_arrival(self) -> Optional[float]:
        return min((r.arrival for r in self._items), default=None)


class Scheduler:
    """Slot bookkeeping for mid-flight admission into a fixed batch.

    Lifecycle per slot: FREE --admit--> PREFILLING --mark_decoding-->
    DECODING --finish--> FINISHED --release--> FREE. Transition methods
    raise on invalid moves so engine bugs surface as errors, not silent
    double-assignments.

    Paged-KV gating: when ``pages_for`` / ``free_pages`` are supplied (the
    engine's page accounting), admission requires BOTH a free slot and
    enough free pages for the request's whole reservation. The FIFO head
    blocks admission while it does not fit (no overtaking — pages free as
    decoding rows finish, so head-of-line waits resolve; a request larger
    than the entire pool is rejected by the engine at submit time, which is
    what keeps the wait from becoming a deadlock). ``page_occupancy()``
    reports the allocated-page fraction for serving stats.

    Bucket-aware admission (``policy="bucket"``, needs ``bucket_of``): when
    filling a freed slot, prefer the earliest arrived request whose context
    bucket already has live rows in the batch — keeping execution groups
    homogeneous so the bucketed serving loop launches fewer, fuller groups.
    Falls back to the plain FIFO head when no arrived request matches (a new
    bucket is opened rather than starving it). The default policy stays
    plain FIFO; page gating applies to whichever candidate the policy picks.
    """

    def __init__(self, num_slots: int,
                 pages_for: Optional[Callable[[Request], int]] = None,
                 free_pages: Optional[Callable[[], int]] = None,
                 total_pages: Optional[int] = None,
                 bucket_of: Optional[Callable[[Request], int]] = None,
                 policy: str = "fifo"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if (pages_for is None) != (free_pages is None):
            raise ValueError("pages_for and free_pages come as a pair")
        if policy not in ("fifo", "bucket"):
            raise ValueError(f"unknown admission policy {policy!r}; "
                             "choose fifo or bucket")
        if policy == "bucket" and bucket_of is None:
            raise ValueError("policy='bucket' needs bucket_of to classify "
                             "requests into context buckets")
        self.num_slots = num_slots
        self.pages_for = pages_for
        self.free_pages = free_pages
        self.total_pages = total_pages
        self.bucket_of = bucket_of
        self.policy = policy
        self.queue = RequestQueue()
        self.states: List[SlotState] = [SlotState.FREE] * num_slots
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.completed: List[Request] = []

    # ------------------------------------------------------------ queue side
    def submit(self, req: Request) -> None:
        self.queue.submit(req)

    # ------------------------------------------------------------ admission
    def admit(self, now: float) -> List[Tuple[int, Request]]:
        """Assign arrived queued requests to FREE slots (FIFO), marking each
        slot PREFILLING. With page gating, a request is only placed while
        its page reservation fits the pool's free-page headroom (pages
        claimed by requests placed earlier in this same call are counted);
        otherwise the queue stays pending. Returns the (slot, request)
        assignments made."""
        placed: List[Tuple[int, Request]] = []
        reserved = 0
        for slot in range(self.num_slots):
            if self.states[slot] is not SlotState.FREE:
                continue
            req = self._pick_candidate(now)
            if req is None:
                break
            if self.pages_for is not None:
                need = self.pages_for(req)
                if need > self.free_pages() - reserved:
                    break            # head-of-line wait for pages, FIFO-fair
                reserved += need
            self.queue.remove(req)
            if self.slot_req[slot] is not None:
                raise RuntimeError(f"slot {slot} is FREE but still holds "
                                   f"request {self.slot_req[slot].req_id}")
            req.admitted_at = now
            self.states[slot] = SlotState.PREFILLING
            self.slot_req[slot] = req
            placed.append((slot, req))
        return placed

    def _pick_candidate(self, now: float) -> Optional[Request]:
        """The next request the admission policy would place: FIFO head, or —
        under the bucket policy — the earliest arrival whose bucket already
        has live rows (falling back to the FIFO head when none matches, so
        empty batches and fresh buckets still admit)."""
        if self.policy == "bucket":
            live = {self.bucket_of(r) for r in self.slot_req if r is not None}
            if live:
                req = self.queue.peek_arrived_where(
                    now, lambda r: self.bucket_of(r) in live)
                if req is not None:
                    return req
        return self.queue.peek_arrived(now)

    def mark_decoding(self, slot: int) -> None:
        if self.states[slot] is not SlotState.PREFILLING:
            raise RuntimeError(f"slot {slot} is {self.states[slot].value}, "
                               "expected prefilling")
        self.states[slot] = SlotState.DECODING

    def finish(self, slot: int, now: float) -> Request:
        if self.states[slot] is not SlotState.DECODING:
            raise RuntimeError(f"slot {slot} is {self.states[slot].value}, "
                               "expected decoding")
        req = self.slot_req[slot]
        req.finished_at = now
        self.states[slot] = SlotState.FINISHED
        self.completed.append(req)
        return req

    def release(self, slot: int) -> None:
        if self.states[slot] is not SlotState.FINISHED:
            raise RuntimeError(f"slot {slot} is {self.states[slot].value}, "
                               "expected finished")
        self.states[slot] = SlotState.FREE
        self.slot_req[slot] = None

    # ------------------------------------------------------------ queries
    def request_at(self, slot: int) -> Optional[Request]:
        return self.slot_req[slot]

    def decoding_mask(self) -> np.ndarray:
        return np.array([s is SlotState.DECODING for s in self.states], bool)

    def occupancy(self) -> float:
        busy = sum(s is not SlotState.FREE for s in self.states)
        return busy / self.num_slots

    def page_occupancy(self) -> float:
        """Allocated fraction of the KV page pool (0.0 when not page-gated)."""
        if self.free_pages is None or not self.total_pages:
            return 0.0
        return 1.0 - self.free_pages() / self.total_pages

    def bucket_occupancy(self) -> dict:
        """Decoding-slot fraction per context bucket (empty without a
        ``bucket_of`` classifier) — the per-bucket serving stat the bucketed
        engine reports next to plain slot occupancy."""
        if self.bucket_of is None:
            return {}
        occ: dict = {}
        for state, req in zip(self.states, self.slot_req):
            if state is SlotState.DECODING and req is not None:
                b = int(self.bucket_of(req))
                occ[b] = occ.get(b, 0.0) + 1.0 / self.num_slots
        return occ

    def next_arrival(self) -> Optional[float]:
        return self.queue.next_arrival()

    def idle(self) -> bool:
        return len(self.queue) == 0 and all(
            s is SlotState.FREE for s in self.states)


def poisson_arrivals(n: int, rate_per_step: float,
                     seed: int = 0) -> np.ndarray:
    """Deterministic Poisson-process arrival replay: n arrival times on the
    virtual step clock with exponential inter-arrival gaps of mean
    1/rate_per_step. rate <= 0 means everything arrives at t=0."""
    if rate_per_step <= 0:
        return np.zeros((n,), np.float64)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_per_step, size=n))


# ------------------------------------------------------ schedule calibration
def kl_divergence(p_logits: np.ndarray, q_logits: np.ndarray) -> float:
    """Mean KL(p || q) over leading dims; logits (..., V)."""
    p_logits = p_logits.astype(np.float64)
    q_logits = q_logits.astype(np.float64)
    p_logits = p_logits - p_logits.max(-1, keepdims=True)
    q_logits = q_logits - q_logits.max(-1, keepdims=True)
    lp = p_logits - np.log(np.exp(p_logits).sum(-1, keepdims=True))
    lq = q_logits - np.log(np.exp(q_logits).sum(-1, keepdims=True))
    p = np.exp(lp)
    return float((p * (lp - lq)).sum(-1).mean())


def greedy_calibrate(eval_fn: Callable[[Tuple[int, ...]], np.ndarray],
                     num_layers: int, kl_budget: float = 0.02,
                     max_reuse: Optional[int] = None) -> Tuple[int, ...]:
    """eval_fn(schedule) -> verification logits for the calibration batch.

    Returns the calibrated REUSE-layer index tuple (sorted)."""
    baseline = eval_fn(())
    schedule: List[int] = []
    candidates = list(range(1, num_layers))
    max_reuse = max_reuse if max_reuse is not None else num_layers - 1
    while candidates and len(schedule) < max_reuse:
        best = None
        best_kl = None
        for c in candidates:
            trial = tuple(sorted(schedule + [c]))
            kl = kl_divergence(baseline, eval_fn(trial))
            if best_kl is None or kl < best_kl:
                best, best_kl = c, kl
        if best_kl is None or best_kl > kl_budget:
            break
        schedule.append(best)
        candidates.remove(best)
    return tuple(sorted(schedule))
