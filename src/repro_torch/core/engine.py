"""SSVEngine and BatchedSSVEngine — the draft -> sparse-verify -> accept
serving loops (paper Fig. 3) in PyTorch; the counterparts of
``repro.core.engine``'s ``SSVEngine``, ``BatchedSSVEngine`` (without a
planner) and ``autoregressive_decode``.

Per generation step:
  1. the draft model expands a rooted token tree under the pending token;
  2. the target verifies all nodes in one tree-masked pass — NSA layers run
     the refresh/reuse schedule and exact/approx grouping through the Hopper
     kernels;
  3. accept/reject picks the longest valid path + a bonus token on the
     device, in the same step function as verification and the target
     commit (``verify_accept``); the (T, vocab) logits never leave the card;
  4. both models commit the accepted path's K/V in place.
Only the accepted tokens and n_accepted cross to the host, once per step.
The committed lengths are mirrored on the host from that transfer, so the
loop never waits on ``caches["length"]``.

The batched engine runs the same step at B rows: one draft expansion, one
verify, one batched accept, one commit, with per-row lengths and an
``active`` mask (finished rows commit nothing), and continuous batching
admits requests into freed slots mid-flight (``serve_continuous``). Both
engines serve from the dense or the paged KV store (``kv_backend``); the
target and the draft share one page table.

Not ported yet: the runtime planner and the bucketed serving it drives
(``BatchPlanner``, ``step_group``, ``warmup``, the AOT
``StepCompileCache``): they raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, ServeConfig, SSVConfig
from repro_torch.core import accept as accept_lib
from repro_torch.core import draft as draft_lib
from repro_torch.core import kvstore
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.tree import TreeTopology, build_topology, children_matrix
from repro_torch.device import resolve_device
from repro_torch.models import model


def _resolve_store(serve_cfg: ServeConfig, target_cfg: ModelConfig) -> kvstore.KVStoreConfig:
    """Pin the page size against the TARGET model once: target and draft
    share one page table, so both pools must tile tokens identically (the
    dense-attention draft has no sel_block constraint of its own)."""
    store = kvstore.KVStoreConfig(serve_cfg.kv_backend, serve_cfg.kv_page_size,
                                  serve_cfg.kv_num_pages)
    if store.is_paged:
        store = dataclasses.replace(store, page_size=store.resolved_page_size(target_cfg))
    return store


def max_draft_gamma(serve_cfg: ServeConfig) -> int:
    """Largest draft-tree size a step can run: the base strategy's (the
    JAX function also spans a planner's profile; no planner is ported)."""
    return serve_cfg.ssv.num_draft_tokens()


def step_headroom(serve_cfg: ServeConfig) -> int:
    """Tokens a request's cache region must leave free beyond its budget: a
    commit writes the whole padded accepted path before the budget check
    truncates it. Both engines size admission (the dense max_context bound
    and the paged page reservation) with this one bound."""
    return 2 * (max_draft_gamma(serve_cfg) + 2)


def request_pages(serve_cfg: ServeConfig, page_size: int, max_pages: int,
                  prompt_len: int, max_new_tokens: int = 0) -> int:
    """Pages a request reserves for its whole life: committed prompt + token
    budget + speculative-step overshoot, capped at the logical row capacity.
    One function sizes both engines' reservations, so page needs never grow
    mid-flight and a full pool can only delay admission."""
    budget = max_new_tokens or serve_cfg.max_new_tokens
    toks = min(prompt_len - 1 + budget + step_headroom(serve_cfg), serve_cfg.max_context)
    return min(kvstore.pages_needed(toks, page_size), max_pages)


def step_host_transfer_elems(ssv: SSVConfig) -> int:
    """Elements the fused step hands to the host per iteration: the padded
    accepted-token vector plus the (bonus, n_accepted) scalars."""
    topo = build_topology(ssv.tree_depth, ssv.tree_width, ssv.traversal,
                          ssv.tree_budget)
    maxd = int(topo.depths.max()) if topo.num_nodes else 0
    return (maxd + 1) + 2


@dataclasses.dataclass
class StepStats:
    accepted: int          # draft tokens accepted (A_t excludes the bonus)
    emitted: int           # new tokens emitted this step (accepted + 1 bonus)
    latency_s: float       # T_t
    gamma: int             # draft tokens verified
    strategy: Optional[SSVConfig]
    host_elems: int = 0    # device->host elements fetched this step


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray
    steps: List[StepStats]

    @property
    def accepted_token_throughput(self) -> float:
        tot_t = sum(s.latency_s for s in self.steps)
        tot_e = sum(s.emitted for s in self.steps)
        return tot_e / tot_t if tot_t > 0 else 0.0

    @property
    def mean_accepted(self) -> float:
        return float(np.mean([s.accepted for s in self.steps])) if self.steps else 0.0


class StepPlan:
    """A strategy's tree on one device: topology tensors for the draft
    expansion and the children matrix for the device accept."""

    def __init__(self, ssv: SSVConfig, device):
        self.topo: TreeTopology = build_topology(ssv.tree_depth, ssv.tree_width,
                                                 ssv.traversal, ssv.tree_budget)
        self.tree = draft_lib.TreeTensors(self.topo, device)
        self.child_mat = torch.as_tensor(children_matrix(self.topo), dtype=torch.long,
                                         device=device)
        self.max_depth = int(self.topo.depths.max()) if self.topo.num_nodes else 0


def _plan_of(plans: Dict[SSVConfig, StepPlan], ssv: SSVConfig, device) -> StepPlan:
    plan = plans.get(ssv)
    if plan is None:
        plan = plans[ssv] = StepPlan(ssv, device)
    return plan


def _uniforms(plan: StepPlan, rng: np.random.Generator, rows: int, device):
    """Per-row accept uniforms (rows, rounds, kmax) and bonus uniforms
    (rows,), drawn row by row as the JAX engines draw them. Uploaded while
    the stream is idle (the last step ended on its host transfer)."""
    us = [accept_lib.draw_uniforms(plan.topo, rng) for _ in range(rows)]
    return (torch.as_tensor(np.stack([u for u, _ in us]), dtype=torch.float32, device=device),
            torch.as_tensor([b for _, b in us], dtype=torch.float32, device=device))


@torch.no_grad()
def verify_accept(params, cfg: ModelConfig, caches, tokens, plan: StepPlan,
                  ssv: SSVConfig, node_q=None, accept_u=None, bonus_u=None,
                  temperature: float = 0.0, active=None):
    """Fused verify -> tree-accept -> commit step for the target model over
    B rows (the counterpart of the JAX ``jit_verify_accept``, and of the
    target half of ``jit_batched_step``). Greedy when ``node_q`` is None;
    else accept_u (B, rounds, kmax) and bonus_u (B,). Rows with ``active``
    False (a (B,) bool tensor) commit nothing. Everything stays on the
    device. Returns (caches, path (B, max_depth+1), tokens (B,
    max_depth+1), n_accepted (B,), n_commit (B,))."""
    B, T = tokens.shape
    positions = (plan.tree.depths[None] + caches["length"].reshape(-1, 1)) \
        .expand(B, T).to(torch.int32)
    logits, updates = model.verify_step(params, cfg, caches, tokens, positions,
                                        plan.tree.mask[None].expand(B, T, T), None, ssv)
    if node_q is None:
        path, out_tokens, _, n_acc = accept_lib.greedy_tree_accept_device(
            plan.child_mat, plan.max_depth, tokens, logits)
    else:
        path, out_tokens, _, n_acc = accept_lib.stochastic_tree_accept_device(
            plan.child_mat, plan.max_depth, tokens, logits, node_q, accept_u,
            bonus_u, temperature)
    n_commit = n_acc + 1
    if active is not None:
        n_commit = torch.where(active, n_commit, torch.zeros_like(n_commit))
    caches = model.commit(params, cfg, caches, updates, path, n_commit)
    return caches, path, out_tokens, n_acc, n_commit


class SSVEngine:
    """Single-sequence (B=1) speculative serving engine.

    ``device`` defaults to ``cuda``; pass ``device="cpu"`` to run the plain
    PyTorch path. The parameters must already live on that device. Under
    ``kv_backend="paged"`` the prefilled cache is re-homed into pages sized
    for the request (``request_pages``).
    """

    def __init__(self, target_params, target_cfg: ModelConfig, draft_params,
                 draft_cfg: ModelConfig, serve_cfg: ServeConfig, planner=None,
                 rng_seed: int = 0, device=None):
        if planner is not None:
            raise NotImplementedError("the runtime planner is not ported yet")
        model.check_supported(target_cfg)
        model.check_supported(draft_cfg)
        self.device = resolve_device(device)
        self.tp, self.tcfg = target_params, target_cfg
        self.dp, self.dcfg = draft_params, draft_cfg
        self.serve = serve_cfg
        self.rng = np.random.default_rng(rng_seed)
        self.t_caches = None
        self.d_caches = None
        self.pending: Optional[int] = None
        self.prompt_len = 0
        self.committed_len = 0   # host-side mirror of caches["length"]
        self.capacity = 0        # tokens the caches can hold for this request
        self._plans: Dict[SSVConfig, StepPlan] = {}
        self.store = _resolve_store(serve_cfg, target_cfg)
        self.allocator: Optional[kvstore.PageAllocator] = None
        if self.store.is_paged:
            self._page_size = self.store.page_size
            self._max_pages = self.store.logical_pages(serve_cfg.max_context,
                                                       self._page_size)

    def start(self, prompt_tokens: np.ndarray, max_new_tokens: int = 0):
        """Prefill both models on all but the last prompt token, which
        becomes the pending root of the first tree. Under the paged store
        the prefilled K/V is re-homed into freshly allocated pages sized for
        prompt + ``max_new_tokens`` (default: the serve budget) + the
        speculative headroom."""
        prompt_tokens = np.asarray(prompt_tokens)
        if prompt_tokens.ndim != 1 or len(prompt_tokens) < 2:
            raise ValueError("start() takes a 1-D prompt of at least 2 tokens")
        if len(prompt_tokens) > self.serve.max_context:
            raise ValueError(f"prompt of {len(prompt_tokens)} tokens exceeds "
                             f"max_context={self.serve.max_context}")
        toks = torch.as_tensor(prompt_tokens[:-1], dtype=torch.long,
                               device=self.device)[None]
        max_len = self.serve.max_context
        _, self.t_caches = model.prefill(self.tp, self.tcfg, toks, max_len)
        _, self.d_caches = model.prefill(self.dp, self.dcfg, toks, max_len)
        self.capacity = max_len
        if self.store.is_paged:
            need = request_pages(self.serve, self._page_size, self._max_pages,
                                 len(prompt_tokens), max_new_tokens)
            self.allocator = kvstore.PageAllocator(
                self.store.resolved_num_pages(1, self._max_pages))
            pg = self.allocator.alloc(need)
            if pg is None:
                raise ValueError(
                    f"kv_num_pages={self.allocator.num_pages} pages cannot "
                    f"hold this request ({need} pages needed)")
            row = np.full((self._max_pages,), -1, np.int32)
            row[:need] = pg
            pages = torch.as_tensor(row, device=self.device)[None]

            def rehome(cfg, dense):
                caches = model.init_caches(cfg, 1, max_len, self.device, self.store)
                kvstore.admit_row_paged(caches, dense, 0, row)
                caches["length"], caches["pages"] = dense["length"], pages
                return caches

            self.t_caches = rehome(self.tcfg, self.t_caches)
            self.d_caches = rehome(self.dcfg, self.d_caches)
            self.capacity = need * self._page_size
        self.pending = int(prompt_tokens[-1])
        self.prompt_len = len(prompt_tokens)
        self.committed_len = self.prompt_len - 1

    @torch.no_grad()
    def step(self, strategy: Optional[SSVConfig] = None) -> Tuple[List[int], StepStats]:
        ssv = strategy or self.serve.ssv
        plan = _plan_of(self._plans, ssv, self.device)
        T = plan.topo.num_nodes
        # a commit writes the whole padded path at the committed length;
        # torch indexing would neither clamp nor drop a write past the end,
        # and a paged write past the reservation would be dropped
        if self.committed_len + plan.max_depth + 1 > self.capacity:
            raise RuntimeError("no cache headroom left for another step")
        greedy = self.serve.temperature == 0.0
        t0 = time.perf_counter()
        pending = torch.full((1,), self.pending, dtype=torch.long, device=self.device)
        stoch = {} if greedy else dict(zip(("accept_u", "bonus_u"),
                                           _uniforms(plan, self.rng, 1, self.device)))

        def dverify(caches, tk, pos, tm):
            return model.verify_step(self.dp, self.dcfg, caches, tk, pos, tm)

        tokens, node_q, d_updates = draft_lib.expand_tree(
            dverify, self.d_caches, plan.tree, pending,
            temperature=self.serve.temperature)
        self.t_caches, path, out_tokens, n_acc, n_commit = verify_accept(
            self.tp, self.tcfg, self.t_caches, tokens, plan, ssv,
            None if greedy else node_q, temperature=self.serve.temperature, **stoch)
        self.d_caches = model.commit(self.dp, self.dcfg, self.d_caches, d_updates,
                                     path, n_commit)
        # the ONLY device->host transfer of the step: a few ints
        host = torch.cat([n_acc, out_tokens[0]]).cpu().numpy()
        n = int(host[0])
        emitted = host[1:n + 2]
        self.pending = int(emitted[-1])
        self.committed_len += n + 1
        dt = time.perf_counter() - t0
        stats = StepStats(accepted=n, emitted=n + 1, latency_s=dt, gamma=T - 1,
                          strategy=ssv, host_elems=int(host.size))
        return [int(t) for t in emitted], stats

    def generate(self, prompt_tokens: np.ndarray, max_new_tokens: int = 0,
                 eos_id: int = -1) -> GenerationResult:
        max_new = max_new_tokens or self.serve.max_new_tokens
        self.start(np.asarray(prompt_tokens), max_new_tokens=max_new)
        out: List[int] = []
        steps: List[StepStats] = []
        while len(out) < max_new:
            new_toks, st = self.step()
            steps.append(st)
            for t in new_toks:
                out.append(int(t))
                if t == eos_id or len(out) >= max_new:
                    break
            if out and out[-1] == eos_id:
                break
            if self.committed_len + 2 * (st.gamma + 2) >= self.serve.max_context:
                break
        return GenerationResult(tokens=np.asarray(out), steps=steps)

    def kv_cache_bytes(self) -> int:
        """Raw-KV footprint of the live caches (both models)."""
        return sum(kvstore.kv_cache_bytes(c) for c in (self.t_caches, self.d_caches)
                   if c is not None)


# ------------------------------------------------------------ batched engine
@dataclasses.dataclass
class BatchGenerationResult:
    """Per-request outputs plus aggregate throughput of a batched generate."""
    results: List[GenerationResult]
    steps: int
    wall_s: float

    @property
    def total_tokens(self) -> int:
        return int(sum(len(r.tokens) for r in self.results))

    @property
    def aggregate_throughput(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s > 0 else 0.0


@dataclasses.dataclass
class ContinuousServeResult:
    """Outputs + serving statistics of a continuous-batching run. ``results``
    aligns with the submitted request order; queue delay and occupancy are
    in virtual fused-step units (deterministic, wall-clock-free)."""
    results: List[GenerationResult]
    requests: List[schedule_lib.Request]
    steps: int
    wall_s: float
    occupancy: List[float]       # per-step busy-slot fraction
    # paged store only: per-step allocated-page fraction; both stores: the
    # raw KV footprint of the run's caches (pools, or slots x max_context)
    page_occupancy: List[float] = dataclasses.field(default_factory=list)
    kv_bytes: int = 0

    @property
    def total_tokens(self) -> int:
        return int(sum(len(r.tokens) for r in self.results))

    @property
    def aggregate_throughput(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancy)) if self.occupancy else 0.0

    @property
    def mean_page_occupancy(self) -> float:
        return float(np.mean(self.page_occupancy)) if self.page_occupancy else 0.0

    @property
    def peak_page_occupancy(self) -> float:
        return float(np.max(self.page_occupancy)) if self.page_occupancy else 0.0

    @property
    def mean_queue_delay_steps(self) -> float:
        delays = [r.queue_delay for r in self.requests if r.queue_delay is not None]
        return float(np.mean(delays)) if delays else 0.0


class BatchedSSVEngine:
    """Multi-request SSV engine: one step serves the whole batch, with
    per-request committed lengths, per-request acceptance and completion
    masks — the counterpart of the JAX ``BatchedSSVEngine`` without a
    planner.

    The JAX engine traces the single-stream step for one row and vmaps it;
    here the step runs at B rows directly: one draft expansion (5 draft
    verify passes for D4/k2), one target verify, one batched accept, one
    commit per model, and one device->host transfer of (R, pad+1) tokens
    plus (R,) counts. Lengths, pending roots and the page table stay on the
    device; the host mirrors them from that transfer and uploads the page
    table only when admission or completion changed it.

    Every request enters through ``admit`` (``start`` is ``start_empty``
    plus one ``admit`` per prompt): a fresh single-request prefill is copied
    into the slot's row (dense) or into pages allocated for it (paged), and
    the next step resets the row's device length and pending root.
    """

    def __init__(self, target_params, target_cfg: ModelConfig, draft_params,
                 draft_cfg: ModelConfig, serve_cfg: ServeConfig, planner=None,
                 rng_seed: int = 0, device=None):
        if planner is not None:
            raise NotImplementedError("the runtime / batch planner is not ported yet")
        model.check_supported(target_cfg)
        model.check_supported(draft_cfg)
        self.device = resolve_device(device)
        self.tp, self.tcfg = target_params, target_cfg
        self.dp, self.dcfg = draft_params, draft_cfg
        self.serve = serve_cfg
        self.rng = np.random.default_rng(rng_seed)
        self.t_caches = self.d_caches = None
        self.pending: Optional[np.ndarray] = None          # host (R,)
        self.committed_len: Optional[np.ndarray] = None    # host (R,)
        self.capacity: Optional[np.ndarray] = None         # host (R,) tokens per row
        self.batch = 0
        self._pending_dev = None                           # device (R,) long
        # per-row admission resets, consumed by the next step()
        self._admit_mask: Optional[np.ndarray] = None
        self._admit_len: Optional[np.ndarray] = None
        self._admit_pending: Optional[np.ndarray] = None
        self._plans: Dict[SSVConfig, StepPlan] = {}
        # one page pool per model, one page table shared by both
        self.store = _resolve_store(serve_cfg, target_cfg)
        self.allocator: Optional[kvstore.PageAllocator] = None
        self.pages: Optional[np.ndarray] = None            # host (R, max_pages)
        self._pages_dirty = False
        self._slot_pages: Dict[int, np.ndarray] = {}
        if self.store.is_paged:
            self._page_size = self.store.page_size
            self._max_pages = self.store.logical_pages(serve_cfg.max_context,
                                                       self._page_size)

    # -------------------------------------------------------------- setup
    def _check_prompt(self, p: np.ndarray, what: str = "prompt"):
        if len(p) < 2:
            raise ValueError(f"{what} has {len(p)} tokens — need at least 2")
        # the loops stop a row once committed_len + headroom reaches
        # max_context, but only after its first step — so the bound must hold
        # at admission, or the first commit would write past the cache end
        headroom = step_headroom(self.serve)
        if len(p) - 1 + headroom > self.serve.max_context:
            raise ValueError(
                f"{what} has {len(p)} tokens, exceeding "
                f"max_context={self.serve.max_context} minus the "
                f"{headroom}-token speculative-step headroom; truncate the "
                f"prompt or raise ServeConfig.max_context")

    def _reset_admission(self, R: int):
        self._admit_mask = np.zeros((R,), bool)
        self._admit_len = np.zeros((R,), np.int32)
        self._admit_pending = np.zeros((R,), np.int64)

    def pages_for(self, prompt_len: int, max_new_tokens: int = 0) -> int:
        """Full-life page reservation for one request (``request_pages``)."""
        return request_pages(self.serve, self._page_size, self._max_pages,
                             prompt_len, max_new_tokens)

    def _free_slot_pages(self, slot: int):
        pg = self._slot_pages.pop(slot, None)
        if pg is not None:
            self.allocator.free(pg)
            self.pages[slot] = -1
            self._pages_dirty = True

    def kv_cache_bytes(self) -> int:
        """Raw-KV footprint of the serving caches (both models) — dense:
        slots x max_context rows; paged: the shared page pools."""
        return kvstore.kv_cache_bytes(self.t_caches) + kvstore.kv_cache_bytes(self.d_caches)

    def start(self, prompts: Sequence[np.ndarray]):
        R = len(prompts)
        if R < 1:
            raise ValueError("prompt list is empty — nothing to serve")
        prompts = [np.asarray(p) for p in prompts]
        for i, p in enumerate(prompts):
            self._check_prompt(p, what=f"prompt {i}")
        self.start_empty(R)
        for i, p in enumerate(prompts):
            self.admit(i, p)

    def start_empty(self, num_slots: int):
        """Allocate ``num_slots`` empty batch slots (zeroed caches, length
        0); every request then enters through ``admit``."""
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        max_len, dev = self.serve.max_context, self.device
        self.t_caches = self.d_caches = None    # free the previous run's caches first
        self.t_caches = model.init_caches(self.tcfg, num_slots, max_len, dev, self.store)
        self.d_caches = model.init_caches(self.dcfg, num_slots, max_len, dev, self.store)
        self.pending = np.zeros((num_slots,), np.int64)
        self.committed_len = np.zeros((num_slots,), np.int64)
        self.capacity = np.zeros((num_slots,), np.int64)
        self._pending_dev = torch.zeros((num_slots,), dtype=torch.long, device=dev)
        self.batch = num_slots
        self._reset_admission(num_slots)
        if self.store.is_paged:
            self.d_caches["pages"] = self.t_caches["pages"]
            self.allocator = kvstore.PageAllocator(
                self.store.resolved_num_pages(num_slots, self._max_pages))
            self.pages = np.full((num_slots, self._max_pages), -1, np.int32)
            self._slot_pages = {}
            self._pages_dirty = False

    # -------------------------------------------------------------- admission
    def admit(self, slot: int, prompt: np.ndarray, max_new_tokens: int = 0):
        """Re-prefill ``prompt`` and land its K/V in batch row ``slot`` (other
        rows are untouched). The row's device length and pending root are
        reset by the next step. Paged: first allocate the request's pages
        (``pages_for``) and map them into the slot's page-table row;
        admitting past the pool raises (callers gate on free pages, as the
        scheduler does)."""
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} out of range for batch {self.batch}")
        prompt = np.asarray(prompt)
        self._check_prompt(prompt)
        max_len = self.serve.max_context
        toks = torch.as_tensor(prompt[:-1], dtype=torch.long, device=self.device)[None]
        _, tc = model.prefill(self.tp, self.tcfg, toks, max_len)
        _, dc = model.prefill(self.dp, self.dcfg, toks, max_len)
        if self.store.is_paged:
            self._free_slot_pages(slot)      # stale mapping of a past tenant
            need = self.pages_for(len(prompt), max_new_tokens)
            pg = self.allocator.alloc(need)
            if pg is None:
                raise RuntimeError(
                    f"page pool exhausted admitting into slot {slot}: need "
                    f"{need} pages, {self.allocator.free_count} free — gate "
                    "admission on free-page headroom (Scheduler pages_for)")
            self._slot_pages[slot] = pg
            self.pages[slot] = -1
            self.pages[slot, :need] = pg
            self._pages_dirty = True
            kvstore.admit_row_paged(self.t_caches, tc, slot, self.pages[slot])
            kvstore.admit_row_paged(self.d_caches, dc, slot, self.pages[slot])
            self.capacity[slot] = need * self._page_size
        else:
            kvstore.admit_row_dense(self.t_caches, tc, slot)
            kvstore.admit_row_dense(self.d_caches, dc, slot)
            self.capacity[slot] = max_len
        self._admit_mask[slot] = True
        self._admit_len[slot] = len(prompt) - 1
        self._admit_pending[slot] = int(prompt[-1])
        self.pending[slot] = int(prompt[-1])
        self.committed_len[slot] = len(prompt) - 1

    def _sync_device_state(self):
        """Apply pending admissions and page-table changes on the device
        (host-to-device copies, made only when something changed, while the
        stream is idle after the last step's host transfer)."""
        if self._pages_dirty:
            self.t_caches["pages"].copy_(torch.as_tensor(self.pages))
            self._pages_dirty = False
        if self._admit_mask.any():
            dev = self.device
            mask = torch.as_tensor(self._admit_mask, device=dev)
            alen = torch.as_tensor(self._admit_len, device=dev)
            apend = torch.as_tensor(self._admit_pending, device=dev)
            for caches in (self.t_caches, self.d_caches):
                caches["length"] = torch.where(mask, alen, caches["length"])
            self._pending_dev = torch.where(mask, apend, self._pending_dev)
            self._admit_mask[:] = False

    # -------------------------------------------------------------- one step
    @torch.no_grad()
    def step(self, active: np.ndarray,
             strategy: Optional[SSVConfig] = None) -> Tuple[np.ndarray, np.ndarray]:
        """active: (R,) bool — rows to advance. Returns (tokens (R, pad+1),
        n_accepted (R,)); inactive rows commit nothing (length frozen; under
        the paged store their writes are dropped). Rows admitted since the
        last step have their device length and pending root reset first."""
        ssv = strategy or self.serve.ssv
        plan = _plan_of(self._plans, ssv, self.device)
        live = np.asarray(active, bool)
        over = live & (self.committed_len + plan.max_depth + 1 > self.capacity)
        if over.any():
            raise RuntimeError(f"rows {np.nonzero(over)[0].tolist()}: no cache "
                               "headroom left for another step")
        self._sync_device_state()
        greedy = self.serve.temperature == 0.0
        active_dev = torch.as_tensor(live, device=self.device)
        stoch = {} if greedy else dict(zip(("accept_u", "bonus_u"),
                                           _uniforms(plan, self.rng, self.batch, self.device)))

        def dverify(caches, tk, pos, tm):
            return model.verify_step(self.dp, self.dcfg, caches, tk, pos, tm)

        tokens, node_q, d_updates = draft_lib.expand_tree(
            dverify, self.d_caches, plan.tree, self._pending_dev,
            temperature=self.serve.temperature)
        self.t_caches, path, out_tokens, n_acc, n_commit = verify_accept(
            self.tp, self.tcfg, self.t_caches, tokens, plan, ssv,
            None if greedy else node_q, temperature=self.serve.temperature,
            active=active_dev, **stoch)
        self.d_caches = model.commit(self.dp, self.dcfg, self.d_caches, d_updates,
                                     path, n_commit)
        last = torch.gather(out_tokens, 1, n_acc[:, None])[:, 0]
        self._pending_dev = torch.where(active_dev, last, self._pending_dev)
        # the ONLY device->host transfer of the step: (R, pad+1) + (R,) ints
        host = torch.cat([n_acc[:, None], out_tokens], 1).cpu().numpy()
        n_np, toks_np = host[:, 0], host[:, 1:]
        self.pending = np.where(live, toks_np[np.arange(self.batch), n_np], self.pending)
        self.committed_len = self.committed_len + np.where(live, n_np + 1, 0)
        return toks_np, n_np

    def step_group(self, rows, strategy):
        raise NotImplementedError("step_group (bucket-local execution groups) is "
                                  "not ported yet")

    def warmup(self, num_slots=None, strategies=None):
        raise NotImplementedError("warmup (the AOT StepCompileCache) is not ported yet")

    # -------------------------------------------------------------- generate
    def generate_batch(self, prompts: Sequence[np.ndarray], max_new_tokens: int = 0,
                       eos_id: int = -1) -> BatchGenerationResult:
        """Drain-mode batched generation: every prompt is admitted at t=0
        into its own slot and the batch runs to completion (sugar over
        ``serve_continuous``, one slot per prompt)."""
        if len(prompts) < 1:
            raise ValueError("prompt list is empty — nothing to serve")
        res = self.serve_continuous([np.asarray(p) for p in prompts],
                                    num_slots=len(prompts),
                                    max_new_tokens=max_new_tokens, eos_id=eos_id)
        return BatchGenerationResult(results=res.results, steps=res.steps,
                                     wall_s=res.wall_s)

    # -------------------------------------------------------------- continuous
    def serve_continuous(self, requests: Sequence, num_slots: int,
                         max_new_tokens: int = 0, eos_id: int = -1,
                         bucketed: Optional[bool] = None,
                         warmup: bool = False) -> ContinuousServeResult:
        """Continuous-batching serve loop: admit queued requests into freed
        slots mid-flight instead of draining the batch between waves.

        ``requests``: ``schedule.Request`` objects (arrival times on the
        virtual step clock) or raw prompt arrays (all arrive at t=0). Each
        row's tokens equal single-stream ``SSVEngine.generate``'s: admission
        never perturbs in-flight rows. Under the paged store admission waits
        for free pages too. ``bucketed`` / ``warmup`` (the planner's
        bucket-local groups) are not ported yet and raise."""
        if bucketed or warmup:
            raise NotImplementedError("bucketed serving and warmup need the "
                                      "BatchPlanner, which is not ported yet")
        max_new_default = max_new_tokens or self.serve.max_new_tokens
        reqs: List[schedule_lib.Request] = []
        for i, r in enumerate(requests):
            reqs.append(r if isinstance(r, schedule_lib.Request)
                        else schedule_lib.Request(req_id=i, prompt=np.asarray(r)))
        if not reqs:
            raise ValueError("request list is empty — nothing to serve")
        if len({r.req_id for r in reqs}) != len(reqs):
            raise ValueError("duplicate req_id in request list — outputs are "
                             "keyed by req_id and must not merge")
        for r in reqs:   # fail fast, before any slot state exists
            self._check_prompt(np.asarray(r.prompt), what=f"request {r.req_id} prompt")
        if self.store.is_paged:
            total_pages = self.store.resolved_num_pages(num_slots, self._max_pages)
            pages_of = lambda r: self.pages_for(len(r.prompt),
                                                r.max_new_tokens or max_new_default)
            for r in reqs:   # a request bigger than the POOL can never admit
                if pages_of(r) > total_pages:
                    raise ValueError(
                        f"request {r.req_id} needs {pages_of(r)} KV pages but "
                        f"the pool has {total_pages}; raise kv_num_pages or "
                        "shrink the prompt/token budget")
            sched = schedule_lib.Scheduler(
                num_slots, pages_for=pages_of,
                free_pages=lambda: self.allocator.free_count, total_pages=total_pages)
        else:
            sched = schedule_lib.Scheduler(num_slots)
        for r in reqs:
            sched.submit(r)
        self.start_empty(num_slots)

        outs: Dict[int, List[int]] = {r.req_id: [] for r in reqs}
        step_logs: Dict[int, List[StepStats]] = {r.req_id: [] for r in reqs}
        occupancy: List[float] = []
        page_occupancy: List[float] = []
        stop_margin = step_headroom(self.serve)
        ssv = self.serve.ssv
        gamma = _plan_of(self._plans, ssv, self.device).topo.num_nodes - 1
        clock = 0.0
        n_steps = 0
        t_start = time.time()
        budget = sum((r.max_new_tokens or max_new_default) for r in reqs)
        safety = 4 * budget + 16 * len(reqs) + 16

        def harvest(slot, n, toks_row, dt):
            """Record one stepped row, stream its new tokens, and finish and
            release the slot at eos / budget / the context bound."""
            req = sched.request_at(slot)
            out = outs[req.req_id]
            limit = req.max_new_tokens or max_new_default
            step_logs[req.req_id].append(StepStats(
                accepted=n, emitted=n + 1, latency_s=dt, gamma=gamma,
                strategy=ssv, host_elems=len(toks_row) + 1))
            finished = False
            for t in toks_row[: n + 1]:
                out.append(int(t))
                if int(t) == eos_id or len(out) >= limit:
                    finished = True
                    break
            if self.committed_len[slot] + stop_margin >= self.serve.max_context:
                finished = True
            if finished:
                sched.finish(slot, now=clock + 1.0)
                if self.store.is_paged:
                    self._free_slot_pages(slot)   # pages return to the pool
                sched.release(slot)

        while not sched.idle():
            for slot, req in sched.admit(clock):
                self.admit(slot, req.prompt,
                           max_new_tokens=req.max_new_tokens or max_new_default)
                sched.mark_decoding(slot)
            active = sched.decoding_mask()
            if not active.any():
                # arrival gap (or page-gated head-of-line wait): jump the
                # virtual clock to the next arrival
                nxt = sched.next_arrival()
                clock = max(clock + 1.0, float(nxt) if nxt is not None else clock + 1.0)
                continue
            occupancy.append(float(active.sum()) / num_slots)
            if self.store.is_paged:
                page_occupancy.append(sched.page_occupancy())
            t0 = time.perf_counter()
            toks, n_acc = self.step(active=active)
            dt = time.perf_counter() - t0
            for slot in np.nonzero(active)[0]:
                harvest(int(slot), int(n_acc[slot]), toks[slot], dt)
            clock += 1.0
            n_steps += 1
            if n_steps > safety:   # shapes guarantee progress; belt-and-braces
                break
        wall = time.time() - t_start
        results = [GenerationResult(tokens=np.asarray(outs[r.req_id]),
                                    steps=step_logs[r.req_id]) for r in reqs]
        return ContinuousServeResult(results=results, requests=reqs, steps=n_steps,
                                     wall_s=wall, occupancy=occupancy,
                                     page_occupancy=page_occupancy,
                                     kv_bytes=self.kv_cache_bytes())


@torch.no_grad()
def autoregressive_decode(params, cfg: ModelConfig, prompt_tokens: np.ndarray,
                          max_new_tokens: int, max_context: int,
                          temperature: float = 0.0, seed: int = 0,
                          device=None) -> GenerationResult:
    """Plain decode loop (the paper's NSA decode baseline shape)."""
    dev = resolve_device(device)
    prompt_tokens = np.asarray(prompt_tokens)
    toks = torch.as_tensor(prompt_tokens[:-1], dtype=torch.long, device=dev)[None]
    _, caches = model.prefill(params, cfg, toks, max_context)
    rng = np.random.default_rng(seed)
    cur = torch.full((1, 1), int(prompt_tokens[-1]), dtype=torch.long, device=dev)
    committed = len(prompt_tokens) - 1
    out: List[int] = []
    steps: List[StepStats] = []
    for _ in range(max_new_tokens):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, cfg, caches, cur)
        lg = logits[0, 0].float().cpu().numpy()
        if temperature == 0.0:
            nxt = int(lg.argmax())
        else:
            p = np.exp((lg - lg.max()) / temperature)
            nxt = int(rng.choice(len(p), p=p / p.sum()))
        dt = time.perf_counter() - t0
        out.append(nxt)
        steps.append(StepStats(accepted=0, emitted=1, latency_s=dt, gamma=0,
                               strategy=None))
        cur = torch.full((1, 1), nxt, dtype=torch.long, device=dev)
        committed += 1
        if committed + 2 >= max_context:
            break
    return GenerationResult(tokens=np.asarray(out), steps=steps)
