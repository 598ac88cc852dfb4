"""SSVEngine and BatchedSSVEngine — the draft -> sparse-verify -> accept
serving loops (paper Fig. 3) in PyTorch; the counterparts of
``repro.core.engine``'s ``SSVEngine``, ``BatchedSSVEngine`` and
``autoregressive_decode``.

Per generation step:
  1. the planner (when one is attached) supplies the strategy;
  2. the draft model expands a rooted token tree under the pending token;
  3. the target verifies all nodes in one tree-masked pass — NSA layers run
     the refresh/reuse schedule and exact/approx grouping through the Hopper
     kernels;
  4. accept/reject picks the longest valid path + a bonus token on the
     device, in the same step function as verification and the target
     commit (``verify_accept``); the (T, vocab) logits never leave the card;
  5. both models commit the accepted path's K/V in place;
  6. the step's acceptance and latency feed the planner's runtime guard.
Only the accepted tokens and n_accepted cross to the host, once per step.
The committed lengths are mirrored on the host from that transfer, so the
loop never waits on ``caches["length"]``.

The batched engine runs the same step at B rows: one draft expansion, one
verify, one batched accept, one commit, with per-row lengths and an
``active`` mask (finished rows commit nothing), and continuous batching
admits requests into freed slots mid-flight (``serve_continuous``). Both
engines serve from the dense or the paged KV store (``kv_backend``); the
target and the draft share one page table.

Bucketed serving (a ``planner.BatchPlanner``) partitions the live slots
into context-regime execution groups and runs one group step per group
under its bucket's strategy (``step_group``). Group steps come from a
``StepCompileCache`` keyed by (strategy, padded group size), the
counterpart of the JAX cache of AOT-compiled executables: on a CUDA engine
each entry is one captured CUDA graph of the whole group step, replayed
with its static inputs rewritten; ``warmup`` fills the cache before
serving, so a serve captures nothing mid-flight. The plain ``step`` stays
eager, as the JAX ``step`` has no explicit cache.
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
from repro_torch.core import overlap as overlap_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.tree import TreeTopology, build_topology, children_matrix
from repro_torch.device import gc_paused, resolve_device
from repro_torch.kernels import LaunchCounter, build
from repro_torch.models import model, recurrent


def _resolve_store(serve_cfg: ServeConfig, target_cfg: ModelConfig) -> kvstore.KVStoreConfig:
    """Pin the page size against the TARGET model once: target and draft
    share one page table, so both pools must tile tokens identically (the
    dense-attention draft has no sel_block constraint of its own)."""
    store = kvstore.KVStoreConfig(serve_cfg.kv_backend, serve_cfg.kv_page_size,
                                  serve_cfg.kv_num_pages)
    if store.is_paged:
        store = dataclasses.replace(store, page_size=store.resolved_page_size(target_cfg))
    return store


def _has_slstm(*cfgs: ModelConfig) -> bool:
    return any("slstm" in cfg.layer_kinds() for cfg in cfgs)


def max_draft_gamma(serve_cfg: ServeConfig, planner=None) -> int:
    """Largest draft-tree size any step can run: the base strategy plus —
    when a planner is attached — every strategy in its profile (a mid-run
    refinement can switch to any of them)."""
    g = serve_cfg.ssv.num_draft_tokens()
    profile = getattr(planner, "profile", None)
    if profile is not None:
        for entries in profile.table.values():
            for e in entries:
                g = max(g, e.strategy.num_draft_tokens())
    return g


def step_headroom(serve_cfg: ServeConfig, planner=None) -> int:
    """Tokens a request's cache region must leave free beyond its budget: a
    commit writes the whole padded accepted path before the budget check
    truncates it. Both engines size admission (the dense max_context bound
    and the paged page reservation) with this one bound."""
    return 2 * (max_draft_gamma(serve_cfg, planner) + 2)


def request_pages(serve_cfg: ServeConfig, planner, page_size: int, max_pages: int,
                  prompt_len: int, max_new_tokens: int = 0) -> int:
    """Pages a request reserves for its whole life: committed prompt + token
    budget + speculative-step overshoot over every strategy the planner can
    switch to, capped at the logical row capacity. One function sizes both
    engines' reservations, so page needs never grow mid-flight and a full
    pool can only delay admission."""
    budget = max_new_tokens or serve_cfg.max_new_tokens
    toks = min(prompt_len - 1 + budget + step_headroom(serve_cfg, planner),
               serve_cfg.max_context)
    return min(kvstore.pages_needed(toks, page_size), max_pages)


def kernel_cache_stats() -> Dict[str, int]:
    """Process-wide kernel-layer cache counters, reported in engine metrics
    next to ``kv_cache_bytes``, under the JAX package's keys:
    ``verify_call_*`` count the port's kernel load cache
    (``kernels.build.library``: a hit is a kernel launch that found its
    library loaded, a miss one that built or loaded it; ``_cached`` is the
    libraries loaded), where the JAX package counts its fused-verify build
    cache; ``group_layout_*`` count the (T, C) query-group layout cache
    (``overlap.group_queries``). Both are shared by every engine in the
    process."""
    hits, misses, loaded = build.library_cache_info()
    gq = overlap_lib.group_queries.cache_info()
    return {"verify_call_hits": hits, "verify_call_misses": misses,
            "verify_call_cached": loaded,
            "group_layout_hits": gq.hits, "group_layout_misses": gq.misses,
            "group_layout_cached": gq.currsize}


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


def _draw_uniforms(plan: StepPlan, rng: np.random.Generator, rows: int):
    """Per-row accept uniforms (rows, rounds, kmax) and bonus uniforms
    (rows,), float32 numpy, drawn row by row as the JAX engines draw them."""
    us = [accept_lib.draw_uniforms(plan.topo, rng) for _ in range(rows)]
    return (np.stack([u for u, _ in us]).astype(np.float32),
            np.asarray([b for _, b in us], np.float32))


def _uniforms(plan: StepPlan, rng: np.random.Generator, rows: int, device):
    """``_draw_uniforms`` on ``device``. Uploaded while the stream is idle
    (the last step ended on its host transfer)."""
    u, b = _draw_uniforms(plan, rng, rows)
    return torch.as_tensor(u, device=device), torch.as_tensor(b, device=device)


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
    # each row is its own request: MoE dispatch groups per row, as the JAX
    # batched step's per-row vmap has them
    logits, updates = model.verify_step(params, cfg, caches, tokens, positions,
                                        plan.tree.mask[None].expand(B, T, T),
                                        plan.topo.parents, ssv, moe_per_row=True)
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
    for the request (``request_pages``). A ``planner.RuntimePlanner``
    (``planner``) picks each step's strategy: ``begin_request`` at
    ``start``, ``current()`` each step, ``observe`` after it.
    """

    def __init__(self, target_params, target_cfg: ModelConfig, draft_params,
                 draft_cfg: ModelConfig, serve_cfg: ServeConfig, planner=None,
                 rng_seed: int = 0, device=None):
        if getattr(planner, "is_batch_planner", False):
            raise ValueError(
                "BatchPlanner plans bucket-local execution groups over a "
                "batch; the single-stream SSVEngine takes a RuntimePlanner — "
                "use BatchedSSVEngine for bucketed serving")
        model.check_supported(target_cfg)
        model.check_supported(draft_cfg)
        self.device = resolve_device(device)
        self.tp, self.tcfg = target_params, target_cfg
        self.dp, self.dcfg = draft_params, draft_cfg
        self.serve = serve_cfg
        self.planner = planner
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
        # a prompt's sLSTM scan replays captured chunks of steps on the card
        self.slstm_graphs = None
        if self.device.type == "cuda" and _has_slstm(target_cfg, draft_cfg):
            self.slstm_graphs = recurrent.SlstmGraphs(self.device)

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
        _, self.t_caches = model.prefill(self.tp, self.tcfg, toks, max_len,
                                         slstm_graphs=self.slstm_graphs)
        _, self.d_caches = model.prefill(self.dp, self.dcfg, toks, max_len,
                                         slstm_graphs=self.slstm_graphs)
        self.capacity = max_len
        if self.store.is_paged:
            need = request_pages(self.serve, self.planner, self._page_size,
                                 self._max_pages, len(prompt_tokens), max_new_tokens)
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
        if self.planner is not None:
            self.planner.begin_request(context_len=self.prompt_len)

    @torch.no_grad()
    def step(self, strategy: Optional[SSVConfig] = None) -> Tuple[List[int], StepStats]:
        ssv = strategy or (self.planner.current() if self.planner else self.serve.ssv)
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
            return model.verify_step(self.dp, self.dcfg, caches, tk, pos, tm,
                                     plan.topo.parents)

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
        if self.planner is not None:
            self.planner.observe(accepted=n, latency_s=dt)
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

    def kernel_cache_stats(self) -> Dict[str, int]:
        """Kernel-layer cache hit/miss counters (process-wide)."""
        return kernel_cache_stats()


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
    # bucketed serving only: mean decoding-slot fraction per context bucket
    # and the number of group steps launched (== steps when every round had
    # one homogeneous group)
    bucket_occupancy: Dict[int, float] = dataclasses.field(default_factory=dict)
    group_launches: int = 0
    # kernel-layer + group-step cache hit/miss counters at run end
    kernel_cache: Dict[str, int] = dataclasses.field(default_factory=dict)

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


# ------------------------------------------------- bucket-local group steps
class StepCompileCache:
    """Explicit cache of the bucketed engine's group steps, keyed by
    (strategy, padded group size) — the counterpart of the JAX cache of
    AOT-compiled executables. Entries (``GroupStep``) are built either
    lazily (a recorded miss) or up front by ``BatchedSSVEngine.warmup``;
    hit/miss counts surface in the engine's kernel-cache metrics."""

    def __init__(self):
        self._exe: Dict = {}
        self.hits = 0
        self.misses = 0

    @property
    def size(self) -> int:
        return len(self._exe)

    def get_or_build(self, key, build_fn):
        exe = self._exe.get(key)
        if exe is None:
            self.misses += 1
            exe = build_fn()
            self._exe[key] = exe
        else:
            self.hits += 1
        return exe

    def stats(self) -> Dict[str, int]:
        return {"step_cache_hits": self.hits,
                "step_cache_misses": self.misses,
                "step_cache_cached": len(self._exe)}


# rows of a group step's control tensor: gather index, scatter source and
# destination, active, admission mask / length / pending root, pending root
IDX, SRC, DST, ACTIVE, ADMIT, ADMIT_LEN, ADMIT_PENDING, PENDING = range(8)


def _row_leaves(caches, paged: bool) -> List[torch.Tensor]:
    """A model's row-batched cache tensors (row axis 0): dense K/V, the
    compressed cache, recurrent states and the lengths. The paged pool is
    shared by every row, and the page table is gathered but never written
    back."""
    out = []
    for layer in caches["layers"]:
        if "state" in layer:
            out += list(layer["state"].values())
            continue
        if not paged:
            out += [layer["kv"]["k"], layer["kv"]["v"]]
        if "cmp" in layer:
            out += [layer["cmp"]["k_cmp"], layer["cmp"]["v_cmp"]]
    return out + [caches["length"]]


def _alloc_group_buffers(caches, g: int, paged: bool, pages=None):
    """g-row buffers shaped like ``caches``' rows (recurrent states too):
    the paged pool is the batch pool itself (by reference); ``pages``
    shares a page table."""
    def rows(t):
        return t.new_zeros((g,) + tuple(t.shape[1:]))

    layers = []
    for layer in caches["layers"]:
        if "state" in layer:
            layers.append({"state": {n: rows(t) for n, t in layer["state"].items()}})
            continue
        out = {"kv": layer["kv"] if paged else {n: rows(t) for n, t in layer["kv"].items()}}
        if "cmp" in layer:
            out["cmp"] = {n: rows(t) for n, t in layer["cmp"].items()}
        layers.append(out)
    grp = {"layers": layers, "length": rows(caches["length"])}
    if paged:
        grp["pages"] = rows(caches["pages"]) if pages is None else pages
    return grp


class GroupStep:
    """One entry of the step cache: the group step of ``g`` rows under one
    strategy, with its static inputs (the (8, g) control tensor, and the
    uniforms under temperature > 0) and output.

    ``direct`` (g == the slot count) steps the engine's caches in place:
    the group's rows active, the others inactive (an inactive row keeps
    every byte of its caches). Otherwise the group's rows — padded to g
    with inactive duplicates of the first row — are gathered into the
    engine's g-row buffers (the paged pool by reference: only the
    compressed caches, lengths and page-table rows are row-batched), stepped
    and the real rows scattered back; a pad scatters its first row's new
    bytes again, so pads are never written back.

    On a CUDA engine with graphs the whole step — gather, draft expansion,
    target verify (routing / nsa_verify / flash), device accept, both
    commits, scatter — is one captured ``torch.cuda.CUDAGraph``: ``warm``
    runs the step once eagerly with every row inactive (it commits
    nothing) so libraries, plans and the kernels' merge tickets exist, then
    ``capture`` records it; ``run`` rewrites the static inputs with
    ``copy_``, replays, and makes the step's one device-to-host copy. A
    capture that fails raises. Otherwise (the CPU, or ``cuda_graphs=False``)
    ``run`` executes the same body eagerly."""

    def __init__(self, eng: "BatchedSSVEngine", ssv: SSVConfig, g: int):
        self.eng, self.ssv, self.g = eng, ssv, g
        self.plan = _plan_of(eng._plans, ssv, eng.device)
        self.direct = g == eng.batch
        self.greedy = eng.serve.temperature == 0.0
        dev = eng.device
        pin = dev.type == "cuda"
        self.ctrl = torch.zeros((8, g), dtype=torch.long, device=dev)
        self.ctrl_host = torch.zeros((8, g), dtype=torch.long, pin_memory=pin)
        if not self.greedy:
            kmax = self.plan.child_mat.shape[1]
            shape = (g, self.plan.max_depth + 1, kmax)
            self.accept_u = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.bonus_u = torch.zeros((g,), dtype=torch.float32, device=dev)
            self.u_host = (torch.zeros(shape, dtype=torch.float32, pin_memory=pin),
                           torch.zeros((g,), dtype=torch.float32, pin_memory=pin))
        if not self.direct:
            eng._group_buffers(g)
        self.graph = None
        self.out = None
        self.counts: Dict[LaunchCounter, int] = {}
        self.runs = 0               # group steps served by this entry

    @torch.no_grad()
    def _body(self):
        eng, c = self.eng, self.ctrl
        paged = eng.store.is_paged
        if self.direct:
            t, d = eng.t_caches, eng.d_caches
        else:
            t, d = eng._group_buffers(self.g)
            # (batch leaf, group leaf) pairs of both models
            pairs = list(zip(_row_leaves(eng.t_caches, paged) + _row_leaves(eng.d_caches, paged),
                             _row_leaves(t, paged) + _row_leaves(d, paged)))
            for batch_t, group_t in pairs:
                torch.index_select(batch_t, 0, c[IDX], out=group_t)
            if paged:
                torch.index_select(eng.t_caches["pages"], 0, c[IDX], out=t["pages"])
        admit = c[ADMIT].bool()
        for caches in (t, d):
            length = caches["length"]
            length.copy_(torch.where(admit, c[ADMIT_LEN].to(length.dtype), length))
        pending = torch.where(admit, c[ADMIT_PENDING], c[PENDING])
        stoch = {} if self.greedy else {"accept_u": self.accept_u, "bonus_u": self.bonus_u}
        out_tokens, n_acc = eng._step_core(t, d, self.plan, self.ssv, pending,
                                           c[ACTIVE].bool(), stoch)
        if not self.direct:
            for batch_t, group_t in pairs:
                batch_t.index_copy_(0, c[DST], group_t.index_select(0, c[SRC]))
        return torch.cat([n_acc[:, None], out_tokens], 1)

    def warm(self):
        """Run the step once eagerly on the capture stream with every row
        inactive: it commits nothing (lengths stay frozen, paged writes are
        dropped, dense rows write their own bytes back) and advances no
        live row."""
        eng = self.eng
        self.ctrl_host.zero_()
        self.ctrl_host[IDX] = self.ctrl_host[SRC] = self.ctrl_host[DST] = torch.arange(self.g)
        self.ctrl.copy_(self.ctrl_host)
        stream = eng._capture_stream()
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            self._body()
        torch.cuda.current_stream(eng.device).wait_stream(stream)
        torch.cuda.synchronize(eng.device)

    def capture(self):
        """Record the step as a CUDA graph in the engine's pool, on its
        capture stream. The launch counts the wrappers added while
        capturing are the graph's launches per replay: taken back here and
        added on every replay."""
        if self.graph is not None:
            return
        eng = self.eng
        snap = LaunchCounter.snapshot()
        graph = torch.cuda.CUDAGraph()
        try:
            with gc_paused(), torch.cuda.graph(graph, pool=eng._capture_pool(),
                                               stream=eng._capture_stream()):
                self.out = self._body()
        finally:
            self.counts = LaunchCounter.since(snap)
            LaunchCounter.restore(snap)
        self.graph = graph

    def run(self, ctrl: np.ndarray, uniforms=None) -> np.ndarray:
        """One group step: write the static inputs, replay (or run the
        body), return (g, pad+2) host ints [n_accepted, tokens...]."""
        self.ctrl_host.copy_(torch.from_numpy(ctrl))
        self.ctrl.copy_(self.ctrl_host, non_blocking=True)
        if uniforms is not None:
            for host, dev_t, val in zip(self.u_host, (self.accept_u, self.bonus_u), uniforms):
                host.copy_(torch.from_numpy(val))
                dev_t.copy_(host, non_blocking=True)
        self.runs += 1
        if self.graph is not None:
            self.graph.replay()
            LaunchCounter.add_counts(self.counts)
            out = self.out
        else:
            out = self._body()
        # the ONLY device->host transfer of the step
        return out.cpu().numpy()


class BatchedSSVEngine:
    """Multi-request SSV engine: one step serves the whole batch, with
    per-request committed lengths, per-request acceptance and completion
    masks — the counterpart of the JAX ``BatchedSSVEngine``.

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

    Planners: a ``planner.RuntimePlanner`` observes the mean acceptance over
    the active rows and switches ONE strategy for the whole batch; a
    ``planner.BatchPlanner`` instead partitions the live slots into
    context-regime execution groups, and ``serve_continuous`` runs one
    ``step_group`` per group under that bucket's strategy. Group steps come
    from ``step_cache`` (one ``GroupStep`` per (strategy, padded group
    size)); on a CUDA engine each is a captured CUDA graph unless
    ``cuda_graphs=False``.
    """

    def __init__(self, target_params, target_cfg: ModelConfig, draft_params,
                 draft_cfg: ModelConfig, serve_cfg: ServeConfig, planner=None,
                 rng_seed: int = 0, device=None, cuda_graphs: bool = True):
        model.check_supported(target_cfg)
        model.check_supported(draft_cfg)
        self.device = resolve_device(device)
        self.tp, self.tcfg = target_params, target_cfg
        self.dp, self.dcfg = draft_params, draft_cfg
        self.serve = serve_cfg
        self.planner = planner
        self.rng = np.random.default_rng(rng_seed)
        self.t_caches = self.d_caches = None
        self.pending: Optional[np.ndarray] = None          # host (R,)
        self.committed_len: Optional[np.ndarray] = None    # host (R,)
        self.capacity: Optional[np.ndarray] = None         # host (R,) tokens per row
        self.batch = 0
        self._pending_dev = None                           # device (R,) long
        self._pending_stale = False    # a group step moved the host mirror only
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
        # bucket-local execution groups: one GroupStep per (strategy, padded
        # group size); see step_group / warmup
        self.graphs = cuda_graphs and self.device.type == "cuda"
        self.step_cache = StepCompileCache()
        self._group_bufs: Dict[int, Tuple] = {}
        self._graph_pool = None
        self._graph_stream = None
        # a prompt's sLSTM scan replays captured chunks (this engine's pool)
        self.slstm_graphs = None
        if self.graphs and _has_slstm(target_cfg, draft_cfg):
            self.slstm_graphs = recurrent.SlstmGraphs(self.device, self._capture_pool,
                                                      self._capture_stream)

    # -------------------------------------------------------------- setup
    def _planner_begin(self, context_len: int):
        """Reset the attached planner for a fresh serving run: a BatchPlanner
        resets its per-bucket guards, a RuntimePlanner re-seeds from the
        batch's context regime."""
        if self.planner is None:
            return
        if getattr(self.planner, "is_batch_planner", False):
            self.planner.begin_serve()
        else:
            self.planner.begin_request(context_len=context_len)

    def _max_gamma(self) -> int:
        return max_draft_gamma(self.serve, self.planner)

    def _step_headroom(self) -> int:
        return step_headroom(self.serve, self.planner)

    def _check_prompt(self, p: np.ndarray, what: str = "prompt"):
        if len(p) < 2:
            raise ValueError(f"{what} has {len(p)} tokens — need at least 2")
        # the loops stop a row once committed_len + headroom reaches
        # max_context, but only after its first step — so the bound must hold
        # at admission, over every strategy the planner could switch to, or
        # the first commit would write past the cache end
        headroom = self._step_headroom()
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
        return request_pages(self.serve, self.planner, self._page_size, self._max_pages,
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

    def kernel_cache_stats(self) -> Dict[str, int]:
        """Engine cache metrics next to ``kv_cache_bytes``: the process-wide
        kernel load and layout caches plus this engine's group-step cache."""
        stats = kernel_cache_stats()
        stats.update(self.step_cache.stats())
        return stats

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
        self._planner_begin(int(np.max([len(p) for p in prompts])))

    def start_empty(self, num_slots: int):
        """Allocate ``num_slots`` empty batch slots (zeroed caches, length
        0); every request then enters through ``admit``. At the slot count
        the caches already have, they are cleared in place and the
        group-step cache stays valid (its CUDA graphs read these very
        buffers); another slot count reallocates them and drops the cache."""
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        max_len, dev = self.serve.max_context, self.device
        if self.t_caches is not None and num_slots == self.batch:
            model.clear_caches(self.tcfg, self.t_caches)
            model.clear_caches(self.dcfg, self.d_caches)    # its page table is the target's
            self._pending_dev.zero_()
        else:
            self.step_cache = StepCompileCache()
            self._group_bufs = {}
            self._graph_pool = None
            self.t_caches = self.d_caches = None    # free the previous run's caches first
            self.t_caches = model.init_caches(self.tcfg, num_slots, max_len, dev, self.store)
            self.d_caches = model.init_caches(self.dcfg, num_slots, max_len, dev, self.store)
            self._pending_dev = torch.zeros((num_slots,), dtype=torch.long, device=dev)
            if self.store.is_paged:
                self.d_caches["pages"] = self.t_caches["pages"]
        self.pending = np.zeros((num_slots,), np.int64)
        self.committed_len = np.zeros((num_slots,), np.int64)
        self.capacity = np.zeros((num_slots,), np.int64)
        self._pending_stale = False
        self.batch = num_slots
        self._reset_admission(num_slots)
        if self.store.is_paged:
            self.allocator = kvstore.PageAllocator(
                self.store.resolved_num_pages(num_slots, self._max_pages))
            self.pages = np.full((num_slots, self._max_pages), -1, np.int32)
            self._slot_pages = {}
            self._pages_dirty = False

    # -------------------------------------------------------------- admission
    def admit(self, slot: int, prompt: np.ndarray, max_new_tokens: int = 0):
        """Re-prefill ``prompt`` and land its K/V in batch row ``slot`` (other
        rows are untouched). The row's device length and pending root are
        reset by the next step that covers it. Paged: first allocate the
        request's pages (``pages_for``) and map them into the slot's
        page-table row; admitting past the pool raises (callers gate on free
        pages, as the scheduler does)."""
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} out of range for batch {self.batch}")
        prompt = np.asarray(prompt)
        self._check_prompt(prompt)
        max_len = self.serve.max_context
        toks = torch.as_tensor(prompt[:-1], dtype=torch.long, device=self.device)[None]
        _, tc = model.prefill(self.tp, self.tcfg, toks, max_len, slstm_graphs=self.slstm_graphs)
        _, dc = model.prefill(self.dp, self.dcfg, toks, max_len, slstm_graphs=self.slstm_graphs)
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

    def _sync_pages(self):
        """Upload the host page table when admission or completion changed
        it (in place: the group steps' graphs read this tensor)."""
        if self._pages_dirty:
            self.t_caches["pages"].copy_(torch.as_tensor(self.pages))
            self._pages_dirty = False

    def _sync_device_state(self):
        """Apply pending admissions and page-table changes on the device,
        in place (host-to-device copies, made only when something changed,
        while the stream is idle after the last step's host transfer)."""
        self._sync_pages()
        dev = self.device
        if self._pending_stale:
            self._pending_dev.copy_(torch.as_tensor(self.pending, device=dev))
            self._pending_stale = False
        if self._admit_mask.any():
            mask = torch.as_tensor(self._admit_mask, device=dev)
            alen = torch.as_tensor(self._admit_len, device=dev)
            apend = torch.as_tensor(self._admit_pending, device=dev)
            for caches in (self.t_caches, self.d_caches):
                caches["length"].copy_(torch.where(mask, alen, caches["length"]))
            self._pending_dev.copy_(torch.where(mask, apend, self._pending_dev))
            self._admit_mask[:] = False

    def _check_headroom(self, live: np.ndarray, plan: StepPlan):
        # a commit writes the whole padded path at the committed length;
        # torch indexing would neither clamp nor drop a dense write past the
        # end, and a paged write past the reservation would be dropped
        over = live & (self.committed_len + plan.max_depth + 1 > self.capacity)
        if over.any():
            raise RuntimeError(f"rows {np.nonzero(over)[0].tolist()}: no cache "
                               "headroom left for another step")

    @torch.no_grad()
    def _step_core(self, t_caches, d_caches, plan: StepPlan, ssv: SSVConfig, pending,
                   active, stoch):
        """Draft expansion -> target verify + accept + commit -> draft
        commit over the rows of ``t_caches`` / ``d_caches``, all on the
        device and in place. Returns (out_tokens (B, pad+1), n_acc (B,))."""
        greedy = self.serve.temperature == 0.0

        def dverify(caches, tk, pos, tm):
            return model.verify_step(self.dp, self.dcfg, caches, tk, pos, tm,
                                     plan.topo.parents)

        tokens, node_q, d_updates = draft_lib.expand_tree(
            dverify, d_caches, plan.tree, pending, temperature=self.serve.temperature)
        _, path, out_tokens, n_acc, n_commit = verify_accept(
            self.tp, self.tcfg, t_caches, tokens, plan, ssv, None if greedy else node_q,
            temperature=self.serve.temperature, active=active, **stoch)
        model.commit(self.dp, self.dcfg, d_caches, d_updates, path, n_commit)
        return out_tokens, n_acc

    # -------------------------------------------------------------- one step
    @torch.no_grad()
    def step(self, active: np.ndarray,
             strategy: Optional[SSVConfig] = None) -> Tuple[np.ndarray, np.ndarray]:
        """active: (R,) bool — rows to advance. Returns (tokens (R, pad+1),
        n_accepted (R,)); inactive rows commit nothing (length frozen; under
        the paged store their writes are dropped). Rows admitted since the
        last step have their device length and pending root reset first."""
        if strategy is None and getattr(self.planner, "is_batch_planner", False):
            raise ValueError(
                "a BatchPlanner has no single batch-wide strategy — pass "
                "strategy= explicitly, or serve through serve_continuous / "
                "step_group so each execution group gets its bucket's plan")
        ssv = strategy or (self.planner.current() if self.planner else self.serve.ssv)
        plan = _plan_of(self._plans, ssv, self.device)
        live = np.asarray(active, bool)
        self._check_headroom(live, plan)
        self._sync_device_state()
        greedy = self.serve.temperature == 0.0
        active_dev = torch.as_tensor(live, device=self.device)
        stoch = {} if greedy else dict(zip(("accept_u", "bonus_u"),
                                           _uniforms(plan, self.rng, self.batch, self.device)))
        out_tokens, n_acc = self._step_core(self.t_caches, self.d_caches, plan, ssv,
                                            self._pending_dev, active_dev, stoch)
        last = torch.gather(out_tokens, 1, n_acc[:, None])[:, 0]
        self._pending_dev.copy_(torch.where(active_dev, last, self._pending_dev))
        # the ONLY device->host transfer of the step: (R, pad+1) + (R,) ints
        host = torch.cat([n_acc[:, None], out_tokens], 1).cpu().numpy()
        n_np, toks_np = host[:, 0], host[:, 1:]
        self.pending = np.where(live, toks_np[np.arange(self.batch), n_np], self.pending)
        self.committed_len = self.committed_len + np.where(live, n_np + 1, 0)
        return toks_np, n_np

    # --------------------------------------------------------- group steps
    def _padded_group_sizes(self) -> List[int]:
        """The sizes a group step can take: powers of two up to the slot
        count (plus the slot count itself). A group is padded up to the next
        size, so the cache holds O(log slots) entries per strategy."""
        sizes, g = [], 1
        while g < self.batch:
            sizes.append(g)
            g *= 2
        sizes.append(self.batch)
        return sizes

    def _group_buffers(self, g: int):
        """The engine's g-row target and draft buffers that gathered group
        steps of size g share (one set per size; steps never overlap)."""
        bufs = self._group_bufs.get(g)
        if bufs is None:
            paged = self.store.is_paged
            t = _alloc_group_buffers(self.t_caches, g, paged)
            d = _alloc_group_buffers(self.d_caches, g, paged, pages=t.get("pages"))
            bufs = self._group_bufs[g] = (t, d)
        return bufs

    def _capture_stream(self):
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        return self._graph_stream

    def _capture_pool(self):
        """One memory pool for every graph of this engine (they replay one
        at a time on one stream)."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _group_step(self, ssv: SSVConfig, g: int, capture: bool = True) -> GroupStep:
        """The cache entry for a ``g``-row group under ``ssv`` (built on a
        miss: on a graph engine warmed and, with ``capture``, captured)."""
        def build_entry():
            entry = GroupStep(self, ssv, g)
            if self.graphs:
                entry.warm()
                if capture:
                    entry.capture()
            return entry

        return self.step_cache.get_or_build((ssv, int(g)), build_entry)

    def warmup(self, num_slots: Optional[int] = None,
               strategies: Optional[Sequence[SSVConfig]] = None) -> int:
        """Build the group step for every (strategy, padded group size)
        bucketed serving can launch, so a mid-serve strategy switch — or a
        group size first seen mid-flight — lands on a ready entry. On a
        graph engine every new entry is first warmed (all of them before the
        first capture, so the merge-ticket buffers have their final size),
        then captured. ``strategies`` defaults to the attached
        BatchPlanner's reachable set (per bucket: the top rank plus every
        refinement hop the guard can take). Returns the number of entries
        built."""
        if strategies is None:
            if not getattr(self.planner, "is_batch_planner", False):
                raise ValueError(
                    "warmup builds the bucketed group-step cache: attach a "
                    "planner.BatchPlanner (profile-backed) or pass the "
                    "strategies to build explicitly")
            strategies = self.planner.reachable_strategies()
        if self.t_caches is None or (num_slots is not None and num_slots != self.batch):
            self.start_empty(num_slots or self.serve.max_batch)
        before = self.step_cache.size
        entries = [self._group_step(ssv, g, capture=False)
                   for ssv in strategies for g in self._padded_group_sizes()]
        if self.graphs:
            for entry in entries:
                entry.capture()
        return self.step_cache.size - before

    @torch.no_grad()
    def step_group(self, rows: Sequence[int],
                   strategy: SSVConfig) -> Tuple[np.ndarray, np.ndarray]:
        """Advance one bucket-local execution group under ``strategy`` (from
        the step cache). Every listed row is stepped (the admission resets
        of freshly admitted rows are consumed, as ``step`` consumes them);
        rows outside the group keep every cache byte, their lengths, pending
        roots and admission resets, so groups can run different strategies
        in the same serving round. A group covering the slot count steps
        the caches directly; a smaller one is padded to the next cached size
        with an inactive duplicate of its first row, gathered, stepped and
        scattered back without the pads.

        Returns (tokens (r, pad+1), n_accepted (r,)) aligned with ``rows``.
        """
        rows = [int(s) for s in rows]
        if not rows:
            raise ValueError("empty execution group — nothing to step")
        if len(set(rows)) != len(rows):
            raise ValueError(f"duplicate rows in execution group {rows}")
        for s in rows:
            if not 0 <= s < self.batch:
                raise ValueError(f"row {s} out of range for batch {self.batch}")
        r = len(rows)
        g = next(s for s in self._padded_group_sizes() if s >= r)
        live = np.zeros((self.batch,), bool)
        live[rows] = True
        self._check_headroom(live, _plan_of(self._plans, strategy, self.device))
        entry = self._group_step(strategy, g)
        self._sync_pages()
        ctrl = np.zeros((8, g), np.int64)
        if entry.direct:
            order = rows + [s for s in range(self.batch) if s not in rows]
            ctrl[IDX] = ctrl[SRC] = ctrl[DST] = np.arange(g)
            ctrl[ACTIVE] = live
            ctrl[ADMIT] = self._admit_mask & live
            ctrl[ADMIT_LEN] = self._admit_len
            ctrl[ADMIT_PENDING] = self._admit_pending
            ctrl[PENDING] = self.pending
            out_rows = rows
        else:
            pad_rows = rows + [rows[0]] * (g - r)
            order = list(range(g))
            ctrl[IDX] = ctrl[DST] = pad_rows
            ctrl[SRC] = list(range(r)) + [0] * (g - r)
            ctrl[ACTIVE, :r] = 1
            ctrl[ADMIT, :r] = self._admit_mask[rows]       # pads never reset the real row
            ctrl[ADMIT_LEN] = self._admit_len[pad_rows]
            ctrl[ADMIT_PENDING] = self._admit_pending[pad_rows]
            ctrl[PENDING] = self.pending[pad_rows]
            out_rows = list(range(r))
        uniforms = None
        if self.serve.temperature != 0.0:
            # g draws; the group's j-th row takes the j-th, as in the JAX engine
            u, b = _draw_uniforms(entry.plan, self.rng, g)
            uniforms = (np.empty_like(u), np.empty_like(b))
            uniforms[0][order], uniforms[1][order] = u, b
        self._admit_mask[rows] = False   # consumed by this step
        host = entry.run(ctrl, uniforms)[out_rows]
        n_np, toks_np = host[:, 0], host[:, 1:]
        self.pending[rows] = toks_np[np.arange(r), n_np]
        self.committed_len[rows] = self.committed_len[rows] + n_np + 1
        self._pending_stale = True
        return toks_np, n_np

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
        for free pages too.

        Bucketed mode (``bucketed=None`` turns it on when the attached
        planner is a ``planner.BatchPlanner``): each round the live slots
        are partitioned into context-regime execution groups and one group
        step runs per group under the profile's strategy for that (bucket,
        precision class). The scheduler switches to the bucket-homogeneous
        admission policy, and each row's tokens equal single-stream
        generation under the row's bucket strategy. ``warmup=True`` builds
        every reachable (strategy, group size) step before serving starts.
        """
        max_new_default = max_new_tokens or self.serve.max_new_tokens
        is_bp = bool(getattr(self.planner, "is_batch_planner", False))
        if bucketed is None:
            bucketed = is_bp
        if bucketed and not is_bp:
            raise ValueError(
                "bucketed serving assigns each execution group its profile "
                "strategy — attach a planner.BatchPlanner (built from an "
                "offline Profile); got "
                f"{type(self.planner).__name__ if self.planner else 'no planner'}")
        if is_bp and not bucketed:
            raise ValueError("a BatchPlanner only drives bucketed serving; "
                             "pass bucketed=True (or leave it None)")
        if warmup and not bucketed:
            raise ValueError("warmup=True builds the bucketed group-step "
                             "cache; it needs bucketed serving")
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
        sched_kwargs = {}
        if bucketed:
            sched_kwargs = dict(policy="bucket",
                                bucket_of=lambda r: self.planner.bucket_of(len(r.prompt)))
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
                free_pages=lambda: self.allocator.free_count, total_pages=total_pages,
                **sched_kwargs)
        else:
            sched = schedule_lib.Scheduler(num_slots, **sched_kwargs)
        for r in reqs:
            sched.submit(r)
        self.start_empty(num_slots)
        if bucketed:
            self.planner.begin_serve()
            if warmup:
                self.warmup()
        elif self.planner is not None:
            self.planner.begin_request(context_len=int(max(len(r.prompt) for r in reqs)))

        outs: Dict[int, List[int]] = {r.req_id: [] for r in reqs}
        step_logs: Dict[int, List[StepStats]] = {r.req_id: [] for r in reqs}
        occupancy: List[float] = []
        page_occupancy: List[float] = []
        bucket_occ: List[Dict[int, float]] = []
        group_launches = 0
        # the context stop bound is sized for the LARGEST strategy the
        # planner can switch to (a switch lands one step after this check)
        stop_margin = self._step_headroom()
        clock = 0.0
        n_steps = 0
        t_start = time.time()
        budget = sum((r.max_new_tokens or max_new_default) for r in reqs)
        safety = 4 * budget + 16 * len(reqs) + 16

        def gamma_of(ssv):
            return _plan_of(self._plans, ssv, self.device).topo.num_nodes - 1

        def harvest(slot, n, toks_row, dt, gamma, ssv):
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
            if bucketed:
                bucket_occ.append(sched.bucket_occupancy())
                slot_buckets = {int(s): self.planner.bucket_of(
                    len(sched.request_at(int(s)).prompt)) for s in np.nonzero(active)[0]}
                for bucket, rows in self.planner.plan(slot_buckets):
                    strat = self.planner.strategy_for(bucket)
                    t0 = time.perf_counter()
                    toks_g, n_g = self.step_group(rows, strat)
                    dt = time.perf_counter() - t0
                    group_launches += 1
                    for j, slot in enumerate(rows):
                        harvest(slot, int(n_g[j]), toks_g[j], dt, gamma_of(strat), strat)
                    self.planner.observe(bucket, accepted=float(np.mean(n_g)),
                                         latency_s=dt)
            else:
                ssv = self.planner.current() if self.planner else self.serve.ssv
                t0 = time.perf_counter()
                toks, n_acc = self.step(active=active)
                dt = time.perf_counter() - t0
                for slot in np.nonzero(active)[0]:
                    harvest(int(slot), int(n_acc[slot]), toks[slot], dt, gamma_of(ssv), ssv)
                if self.planner is not None:
                    self.planner.observe(accepted=float(np.mean(n_acc[active])),
                                         latency_s=dt)
            clock += 1.0
            n_steps += 1
            if n_steps > safety:   # shapes guarantee progress; belt-and-braces
                break
        wall = time.time() - t_start
        results = [GenerationResult(tokens=np.asarray(outs[r.req_id]),
                                    steps=step_logs[r.req_id]) for r in reqs]
        # mean decoding-slot fraction per bucket over the stepped rounds
        bucket_means = {b: float(np.mean([occ.get(b, 0.0) for occ in bucket_occ]))
                        for b in sorted({b for occ in bucket_occ for b in occ})}
        return ContinuousServeResult(results=results, requests=reqs, steps=n_steps,
                                     wall_s=wall, occupancy=occupancy,
                                     page_occupancy=page_occupancy,
                                     kv_bytes=self.kv_cache_bytes(),
                                     bucket_occupancy=bucket_means,
                                     group_launches=group_launches,
                                     kernel_cache=self.kernel_cache_stats())


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
