"""The recurrent blocks of the port (``models/recurrent.py``) held against
``repro.models.recurrent`` on the same weights: RG-LRU, mLSTM and sLSTM
over a sequence, one step, their initial states, the state replay over a
chain and a branching draft tree, the prefill state, a prefill that
continues from a given state, the chunkwise mLSTM at a chunk that divides
the sequence and one that does not, and the commit of the deepest accepted
node (rtol 2e-4 / atol 2e-5); then the models that hold
them (reduced recurrentgemma-9b, one (rglru, rglru, attn) period as its NSA
variant, and reduced xlstm-125m): prefill, ``verify_step`` and ``commit``
against the JAX model, and the engines' tokens and accepted counts against
the JAX engines, single stream and at 2 slots on the dense and the paged
store."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ServeConfig as JServe, SSVConfig as JSSV
from repro.core import draft as jdraft, engine as jengine
from repro.core.tree import build_topology
from repro.models import model as jmodel, recurrent as jrec
from repro_torch import configs
from repro_torch.bridge import from_jax, init_params
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft, engine
from repro_torch.models import model, recurrent
from repro_torch.optim import tree_leaves

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
ARCH_OF = {"rglru": "recurrentgemma-9b", "mlstm": "xlstm-125m", "slstm": "xlstm-125m"}
KINDS = tuple(ARCH_OF)
TREE = build_topology(3, 2, "bfs")
PARENTS = {"chain": np.arange(-1, 6, dtype=np.int32), "tree": TREE.parents.astype(np.int32)}


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


def close_tree(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        close(a[n], b[n])


def torch_tree(t):
    return {k: torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in t.items()}


@pytest.fixture(scope="module", params=KINDS)
def block(request):
    """(kind, cfg (JAX), cfg (port), JAX params, port params, inputs)."""
    kind = request.param
    jc, tc = jconfigs.reduced(ARCH_OF[kind], layers=2), configs.reduced(ARCH_OF[kind], layers=2)
    jp = jrec.INITS[kind](jax.random.PRNGKey(7), jc)
    tp = torch_tree(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(0).normal(size=(2, 32, tc.d_model)).astype(np.float32)
    return kind, jc, tc, jp, tp, x


def test_apply_train_and_prefill_state_match_jax(block):
    kind, jc, tc, jp, tp, x = block
    x = x[:, :24]
    close(jrec.TRAIN[kind](jp, jc, jnp.asarray(x)), recurrent.TRAIN[kind](tp, tc, torch.from_numpy(x)))
    if kind == "rglru":
        jout, jstate = jmodel._rglru_prefill(jp, jc, jnp.asarray(x))
    else:
        jout, jstate = jmodel._xlstm_prefill(kind, jp, jc, jnp.asarray(x))
    tout, tstate = recurrent.PREFILL[kind](tp, tc, torch.from_numpy(x))
    close(jout, tout)
    close_tree(jstate, tstate)


@pytest.mark.parametrize("chunk", [16, 20])
def test_chunkwise_mlstm_equals_the_jax_steps(chunk):
    """The mLSTM prefill, chunkwise (``mlstm_scan``) at a chunk that divides
    the 48 positions (16) and one that does not (20): from the initial state
    (m = -1e30) its outputs and state equal the JAX ``_xlstm_prefill``'s
    step by step; from the JAX state after 20 positions (non-zero C, n, m)
    its outputs over the other 28 and its state equal the same scan's."""
    jc, tc = jconfigs.reduced("xlstm-125m", layers=2), configs.reduced("xlstm-125m", layers=2)
    jp = jrec.INITS["mlstm"](jax.random.PRNGKey(3), jc)
    tp = torch_tree(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(1).normal(size=(2, 48, tc.d_model)).astype(np.float32)
    jout, jstate = jmodel._xlstm_prefill("mlstm", jp, jc, jnp.asarray(x))
    out, state = recurrent.mlstm_prefill(tp, tc, torch.from_numpy(x), chunk=chunk)
    close(jout, out)
    close_tree(jstate, state)
    _, j20 = jmodel._xlstm_prefill("mlstm", jp, jc, jnp.asarray(x[:, :20]))
    assert float(jnp.abs(j20["C"]).max()) > 0 and float(j20["m"].min()) > -1e3
    start = {n: torch.from_numpy(np.array(v, np.float32)) for n, v in j20.items()}
    out, state = recurrent.mlstm_prefill(tp, tc, torch.from_numpy(x[:, 20:]), start, chunk)
    close(jout[:, 20:], out)
    close_tree(jstate, state)


def test_prefill_continues_from_a_state(block):
    """Each kind's prefill from the JAX state after 20 positions (the RG-LRU
    with its h and conv window, the sLSTM and mLSTM with theirs) over the
    next 12 equals the JAX prefill of all 32 there, and leaves its state."""
    kind, jc, tc, jp, tp, x = block
    pre = (lambda xx: jmodel._rglru_prefill(jp, jc, jnp.asarray(xx))) if kind == "rglru" \
        else (lambda xx: jmodel._xlstm_prefill(kind, jp, jc, jnp.asarray(xx)))
    jout, jstate = pre(x)
    _, j20 = pre(x[:, :20])
    start = {n: torch.from_numpy(np.array(v, np.float32)) for n, v in j20.items()}
    out, state = recurrent.PREFILL[kind](tp, tc, torch.from_numpy(x[:, 20:]), state=start)
    close(jout[:, 20:], out)
    close_tree(jstate, state)


def test_init_state_and_step_match_jax(block):
    """The initial states, and one step (a one-node tree) from the state
    after 23 positions: the output and the state equal the JAX step's, and
    the output equals the 24th position of the sequence forward."""
    kind, jc, tc, jp, tp, x = block
    x = x[:, :24]
    close_tree(jrec.STATE_INITS[kind](jc, 2), recurrent.STATE_INITS[kind](tc, 2))
    _, jstate = (jmodel._rglru_prefill(jp, jc, jnp.asarray(x[:, :23])) if kind == "rglru"
                 else jmodel._xlstm_prefill(kind, jp, jc, jnp.asarray(x[:, :23])))
    jout, jnew = jrec.STEPS[kind](jp, jc, jnp.asarray(x[:, 23:]), jstate)
    tstate = {n: torch.from_numpy(np.array(v, np.float32)) for n, v in jstate.items()}
    tout, tbuf = recurrent.verify_states(kind, tp, tc, torch.from_numpy(x[:, 23:]), [-1],
                                         tstate)
    close(jout, tout)
    close_tree(jnew, {n: b[1] for n, b in tbuf.items()})
    close(recurrent.TRAIN[kind](tp, tc, torch.from_numpy(x))[:, 23:], tout)


@pytest.mark.parametrize("shape", PARENTS)
def test_verify_states_and_commit_match_jax(block, shape):
    """State replay over a chain and over the D3/k2 tree (node i from its
    parent's post-state), then the commit of a root-to-leaf path in row 0
    and of nothing in row 1 (that row keeps its state)."""
    kind, jc, tc, jp, tp, x = block
    parents = PARENTS[shape]
    T = len(parents)
    _, jstate = (jmodel._rglru_prefill(jp, jc, jnp.asarray(x[:, :16])) if kind == "rglru"
                 else jmodel._xlstm_prefill(kind, jp, jc, jnp.asarray(x[:, :16])))
    tstate = {n: torch.from_numpy(np.array(v, np.float32)) for n, v in jstate.items()}
    xs = x[:, 16:16 + T]
    jout, jbuf = jrec.verify_states(jrec.STEPS[kind], jp, jc, jnp.asarray(xs),
                                    jnp.asarray(parents), jstate)
    tout, tbuf = recurrent.verify_states(kind, tp, tc, torch.from_numpy(xs), parents, tstate)
    close(jout, tout)
    close_tree(jbuf, tbuf)
    leaf = T - 1
    path = [leaf]
    while parents[path[-1]] >= 0:
        path.append(int(parents[path[-1]]))
    path = path[::-1]
    accepted = np.array([path, [0] * len(path)])
    n_acc = np.array([len(path), 0], np.int32)
    want = jmodel._pick_recurrent({"state": jax.tree.map(lambda a: a[None], jstate)},
                                  {"state_buf": jax.tree.map(lambda a: a[None], jbuf)},
                                  jnp.asarray(accepted), jnp.asarray(n_acc))
    before = {n: t.clone() for n, t in tstate.items()}
    recurrent.pick_state(tstate, tbuf, torch.from_numpy(accepted), torch.from_numpy(n_acc))
    close_tree(jax.tree.map(lambda a: a[0], want), tstate)
    for n, t in tstate.items():
        torch.testing.assert_close(t[1], before[n][1], rtol=0, atol=0)
        close(t[0], tbuf[n][leaf + 1, 0])


# ------------------------------------------------------------------ models
PROMPT, MAX_CTX = 110, 160
MODEL_ARCHS = ("recurrentgemma-9b", "xlstm-125m")


def model_pair(arch, seed=0):
    """One period of the arch's block pattern, served as its NSA variant
    (attention-free xlstm stays as it is)."""
    period = len(configs.get_config(arch).block_pattern)
    jc = jconfigs.nsa_variant(jconfigs.reduced(arch, layers=period))
    tc = configs.nsa_variant(configs.reduced(arch, layers=period))
    jp = jmodel.init(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")


def jax_layer(jcache, jc, li, b=None):
    """Layer li's cache of a JAX cache tree (numpy leaves), row b or all."""
    segs = jmodel.segments(jc)
    base = 0
    for si, (kinds, n) in enumerate(segs):
        if li < base + n * len(kinds):
            g, j = divmod(li - base, len(kinds))
            return jax.tree.map(lambda a: np.asarray(a[g] if b is None else a[g, b]),
                                jcache["segments"][si][j])
        base += n * len(kinds)
    raise IndexError(li)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_prefill_verify_commit_match_jax(arch):
    """Two rows: prefill (hidden states, K/V and recurrent states), a D3/k2
    tree verify (logits), then a commit of the path 0-1-3 in row 0 and of
    nothing in row 1: lengths, K/V and the states after the committed
    node."""
    jc, tc, jp, tp = model_pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab_size, (2, PROMPT))
    jh, jcache = jmodel.prefill(jp, jc, jnp.asarray(toks), MAX_CTX)
    th, tcache = model.prefill(tp, tc, torch.from_numpy(toks), MAX_CTX)
    close(jh, th)
    for li, layer in enumerate(tcache["layers"]):
        want = jax_layer(jcache, jc, li)
        if "state" in layer:
            close_tree(want["state"], layer["state"])
        else:
            close(want["kv"]["k"][:, :PROMPT], layer["kv"]["k"][:, :PROMPT])
    T = TREE.num_nodes
    dtoks = rng.integers(0, tc.vocab_size, (2, T))
    pos = np.broadcast_to(PROMPT + TREE.depths, (2, T)).astype(np.int32)
    mask = np.broadcast_to(TREE.mask, (2, T, T))
    kw = dict(tree_depth=3, tree_width=2, group_size=2, group_mode="exact")
    jl, jup = jmodel.verify_step(jp, jc, jcache, jnp.asarray(dtoks), jnp.asarray(pos),
                                 jnp.asarray(mask), jnp.asarray(TREE.parents), JSSV(**kw))
    tl, tup = model.verify_step(tp, tc, tcache, torch.from_numpy(dtoks),
                                torch.from_numpy(pos.copy()), torch.from_numpy(mask.copy()),
                                TREE.parents, SSVConfig(**kw))
    close(jl, tl)
    np.testing.assert_array_equal(np.asarray(jl).argmax(-1), tl.numpy().argmax(-1))
    path = np.array([[0, 1, 3], [0, 0, 0]])
    n_acc = np.array([3, 0], np.int32)
    model.commit(tp, tc, tcache, tup, torch.from_numpy(path), torch.from_numpy(n_acc))
    for b in range(2):
        row = jax.tree.map(lambda a: a[:, b:b + 1] if getattr(a, "ndim", 0) > 1 else a, jcache)
        rup = jax.tree.map(lambda a: a[:, :, b:b + 1] if a.ndim > 3 and a.shape[1] == T + 1
                           else a[:, b:b + 1], jup)
        jc_b = jmodel.commit(jp, jc, row, rup, jnp.asarray(path[b:b + 1]),
                             jnp.asarray(n_acc[b:b + 1]))
        keep = PROMPT + n_acc[b]
        assert int(tcache["length"][b]) == keep
        for li, layer in enumerate(tcache["layers"]):
            want = jax_layer(jc_b, jc, li, 0)
            if "state" in layer:
                close_tree(want["state"], {n: t[b] for n, t in layer["state"].items()})
            else:
                close(want["kv"]["k"][:keep], layer["kv"]["k"][b, :keep])


def loss_and_grads_match_jax(arch, seq=40):
    """``loss_fn`` and the gradient of every leaf through autograd (each
    layer recomputed under remat) against ``jax.value_and_grad`` of the
    JAX ``loss_fn`` on the same weights and tokens, the JAX gradients
    unstacked through ``from_jax``. Returns the port's gradients."""
    jc, tc, jp, tp = model_pair(arch)
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (2, seq))
    lj, gj = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jc, jnp.asarray(toks)))(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    lt = model.loss_fn(tp, tc, torch.from_numpy(toks))
    # allow_unused: a block without an FFN (xlstm) never reads its norm2
    gt = [torch.zeros_like(t) if g is None else g
          for t, g in zip(leaves, torch.autograd.grad(lt, leaves, allow_unused=True))]
    close(lj, lt.detach())
    want = tree_leaves(from_jax(jax.tree.map(np.asarray, gj), tc, "cpu"))
    assert len(want) == len(gt) == len(leaves)
    for a, b in zip(gt, want):
        close(b, a)
    return dict(zip(map(id, leaves), gt)), tp


def test_xlstm_training_loss_and_grads_flow():
    """Reduced xlstm-125m (one (mlstm, slstm) period): the loss and every
    gradient equal JAX's (the mLSTM's chunkwise form against the JAX
    ``lax.scan`` of its cell, the sLSTM's steps against its scan), and
    every recurrent parameter's gradient is nonzero."""
    grads, tp = loss_and_grads_match_jax("xlstm-125m")
    for layer in tp["layers"]:
        for n, t in layer["mix"].items():
            assert float(grads[id(t)].abs().max()) > 0, n


def test_recurrentgemma_training_grads_match_jax():
    """One (rglru, rglru, attn) period of recurrentgemma-9b as its NSA
    variant: the loss and every gradient equal JAX's (the RG-LRU's
    doubling scan against ``associative_scan``)."""
    grads, tp = loss_and_grads_match_jax("recurrentgemma-9b")
    for layer in tp["layers"][:2]:
        for n, t in layer["mix"].items():
            assert float(grads[id(t)].abs().max()) > 0, n


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_init_params_keep_jax_dtypes(arch):
    """A bf16 model drawn from a seed has the JAX tree's leaves, shapes and
    dtypes (the recurrent gates' float32 leaves too)."""
    cfg = dataclasses.replace(configs.reduced(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.reduced(arch), dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = init_params(cfg, gen, "cpu")
    jp = from_jax(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg)), cfg, "cpu")
    flat_t = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: (t.shape, t.dtype), tp))
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: (t.shape, t.dtype), jp))
    assert flat_t == flat_j


# ------------------------------------------------------------------ engines
STRATEGY = dict(tree_depth=2, tree_width=2, group_size=2, group_mode="exact",
                precision_class="Strict")
NEW = 6
SERVE_CTX = 192           # a whole number of pages of 64 (the page size without NSA)


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def served(request):
    """One arch's pair, prompts and the JAX engines' results (computed once
    for every test below): single stream per prompt, and ``generate_batch``
    at 2 slots on the dense and the paged store."""
    arch = request.param
    jc, tc, jp, tp = model_pair(arch)
    jd, td = jdraft.draft_config(jc, num_layers=1), draft.draft_config(tc, num_layers=1)
    jdp = jmodel.init(jax.random.PRNGKey(1), jd)
    tdp = from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tc.vocab_size, n) for n in (PROMPT, PROMPT + 9)]
    want = {}
    je = jengine.SSVEngine(jp, jc, jdp, jd, jserve("dense"))
    want["single"] = [je.generate(p, NEW) for p in prompts]
    for backend in ("dense", "paged"):
        want[backend] = jengine.BatchedSSVEngine(jp, jc, jdp, jd, jserve(backend)) \
            .generate_batch(prompts, NEW).results
    return (tc, tp, td, tdp), prompts, want


def jserve(backend):
    return JServe(max_new_tokens=NEW, max_context=SERVE_CTX, ssv=JSSV(**STRATEGY),
                  use_planner=False, kv_backend=backend)


def tserve(backend):
    return ServeConfig(max_new_tokens=NEW, max_context=SERVE_CTX, ssv=SSVConfig(**STRATEGY),
                       kv_backend=backend)


def same(jres, tres):
    np.testing.assert_array_equal(jres.tokens, tres.tokens)
    assert [s.accepted for s in jres.steps] == [s.accepted for s in tres.steps]


def test_single_stream_matches_jax(served):
    (tc, tp, td, tdp), prompts, want = served
    te = engine.SSVEngine(tp, tc, tdp, td, tserve("dense"), device="cpu")
    for p, w in zip(prompts, want["single"]):
        same(w, te.generate(p, NEW))


@pytest.mark.parametrize("backend", ("dense", "paged"))
def test_batched_matches_jax_and_single_stream(served, backend):
    """2 slots: the JAX batched engine's tokens and accepted counts, which
    are the single stream's; the target's recurrent states land in and
    leave the batch rows with each request."""
    (tc, tp, td, tdp), prompts, want = served
    te = engine.BatchedSSVEngine(tp, tc, tdp, td, tserve(backend), device="cpu")
    got = te.generate_batch(prompts, NEW).results
    for w, s, g in zip(want[backend], want["single"], got):
        same(w, g)
        np.testing.assert_array_equal(s.tokens, g.tokens)
    if backend == "paged":
        assert te.allocator.free_count == te.allocator.num_pages
