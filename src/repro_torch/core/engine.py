"""SSVEngine — the single-stream draft -> sparse-verify -> accept serving
loop (paper Fig. 3) in PyTorch; the counterpart of ``repro.core.engine``'s
``SSVEngine`` and ``autoregressive_decode``.

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
The committed length is mirrored on the host from that transfer, so the
loop never waits on ``caches["length"]``.

Batched, continuous and bucketed serving, the paged KV store and the
runtime planner are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, ServeConfig, SSVConfig
from repro_torch.core import accept as accept_lib
from repro_torch.core import draft as draft_lib
from repro_torch.core.tree import TreeTopology, build_topology, children_matrix
from repro_torch.device import resolve_device
from repro_torch.models import model


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


@torch.no_grad()
def verify_accept(params, cfg: ModelConfig, caches, tokens, plan: StepPlan,
                  ssv: SSVConfig, node_q=None, accept_u=None, bonus_u=None,
                  temperature: float = 0.0):
    """Fused verify -> tree-accept -> commit step for the target model (the
    counterpart of the JAX ``jit_verify_accept``). Greedy when ``node_q`` is
    None. Everything stays on the device. Returns (caches, path
    (max_depth+1,), tokens (max_depth+1,), bonus, n_accepted)."""
    B, T = tokens.shape
    positions = (plan.tree.depths[None] + caches["length"]).expand(B, T).to(torch.int32)
    logits, updates = model.verify_step(params, cfg, caches, tokens, positions,
                                        plan.tree.mask[None].expand(B, T, T), None, ssv)
    if node_q is None:
        path, out_tokens, bonus, n_acc = accept_lib.greedy_tree_accept_device(
            plan.child_mat, plan.max_depth, tokens[0], logits[0])
    else:
        path, out_tokens, bonus, n_acc = accept_lib.stochastic_tree_accept_device(
            plan.child_mat, plan.max_depth, tokens[0], logits[0], node_q[0],
            accept_u, bonus_u, temperature)
    caches = model.commit(params, cfg, caches, updates, path[None], (n_acc + 1)[None])
    return caches, path, out_tokens, bonus, n_acc


class SSVEngine:
    """Single-sequence (B=1) speculative serving engine.

    ``device`` defaults to ``cuda``; pass ``device="cpu"`` to run the plain
    PyTorch path. The parameters must already live on that device.
    """

    def __init__(self, target_params, target_cfg: ModelConfig, draft_params,
                 draft_cfg: ModelConfig, serve_cfg: ServeConfig, planner=None,
                 rng_seed: int = 0, device=None):
        if planner is not None:
            raise NotImplementedError("the runtime planner is not ported yet")
        if serve_cfg.kv_backend != "dense":
            raise NotImplementedError("the paged KV store is not ported yet")
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
        self._plans: Dict[SSVConfig, StepPlan] = {}

    def _plan(self, ssv: SSVConfig) -> StepPlan:
        plan = self._plans.get(ssv)
        if plan is None:
            plan = self._plans[ssv] = StepPlan(ssv, self.device)
        return plan

    def start(self, prompt_tokens: np.ndarray, max_new_tokens: int = 0):
        """Prefill both models on all but the last prompt token, which
        becomes the pending root of the first tree."""
        del max_new_tokens
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
        self.pending = int(prompt_tokens[-1])
        self.prompt_len = len(prompt_tokens)
        self.committed_len = self.prompt_len - 1

    @torch.no_grad()
    def step(self, strategy: Optional[SSVConfig] = None) -> Tuple[List[int], StepStats]:
        ssv = strategy or self.serve.ssv
        plan = self._plan(ssv)
        T = plan.topo.num_nodes
        # a commit writes the whole padded path at the committed length;
        # torch indexing would neither clamp nor drop a write past the end
        if self.committed_len + plan.max_depth + 1 > self.serve.max_context:
            raise RuntimeError("no cache headroom left for another step")
        greedy = self.serve.temperature == 0.0
        t0 = time.perf_counter()
        pending = torch.full((1,), self.pending, dtype=torch.long, device=self.device)
        if not greedy:
            # copied while the stream is idle (the last step ended on a host
            # transfer), so the upload waits on no queued work
            accept_u, bonus_u = accept_lib.draw_uniforms(plan.topo, self.rng)
            accept_u = torch.as_tensor(accept_u, dtype=torch.float32, device=self.device)
            bonus_u = torch.full((), bonus_u, dtype=torch.float32, device=self.device)

        def dverify(caches, tk, pos, tm):
            return model.verify_step(self.dp, self.dcfg, caches, tk, pos, tm)

        tokens, node_q, d_updates = draft_lib.expand_tree(
            dverify, self.d_caches, plan.tree, pending,
            temperature=self.serve.temperature)
        if greedy:
            self.t_caches, path, out_tokens, bonus, n_acc = verify_accept(
                self.tp, self.tcfg, self.t_caches, tokens, plan, ssv)
        else:
            self.t_caches, path, out_tokens, bonus, n_acc = verify_accept(
                self.tp, self.tcfg, self.t_caches, tokens, plan, ssv, node_q,
                accept_u, bonus_u, self.serve.temperature)
        self.d_caches = model.commit(self.dp, self.dcfg, self.d_caches, d_updates,
                                     path[None], (n_acc + 1)[None])
        # the ONLY device->host transfer of the step: a few ints
        host = torch.cat([n_acc.reshape(1), out_tokens]).cpu().numpy()
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
