"""The port's tree accept and draft expansion: device accept forms equal
the host forms on the same uniforms (and the JAX device forms), one row at
a time and row by row in a batch of rows sharing a topology, the copied
tree module matches the JAX one, and draft tree expansion on bridged
weights gives the JAX tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.core import accept as jaccept, draft as jdraft, tree as jtree
from repro.models import model as jmodel
from repro_torch.bridge import from_jax
from repro_torch.config import ModelConfig
from repro_torch.core import accept, draft, tree
from repro_torch.models import model

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)


def _case(seed):
    rng = np.random.default_rng(seed)
    topo = tree.build_topology(int(rng.integers(1, 5)), int(rng.integers(1, 4)),
                               ["bfs", "dfs"][int(rng.integers(0, 2))],
                               int(rng.integers(0, 2)) * int(rng.integers(3, 12)))
    V = int(rng.integers(5, 20))        # small vocab: sibling-duplicate tokens
    tokens = rng.integers(0, V, topo.num_nodes)
    logits = rng.normal(size=(topo.num_nodes, V)).astype(np.float32)
    q = rng.dirichlet(np.ones(V), size=topo.num_nodes).astype(np.float32)
    return rng, topo, tokens, logits, q


@pytest.mark.parametrize("block", range(2))
def test_greedy_device_matches_host_and_jax(block):
    for seed in range(block * 30, block * 30 + 30):
        rng, topo, tokens, logits, _ = _case(seed)
        cm = tree.children_matrix(topo)
        maxd = int(topo.depths.max())
        host = accept.greedy_tree_accept(topo, tokens, logits)
        path, toks, bonus, n = (x[0] for x in accept.greedy_tree_accept_device(
            torch.from_numpy(cm).long(), maxd, torch.from_numpy(tokens)[None],
            torch.from_numpy(logits)[None]))
        n = int(n)
        assert n == host.n_accepted, seed
        assert np.array_equal(path.numpy()[: n + 1], host.path), seed
        assert np.array_equal(toks.numpy()[: n + 1], host.tokens), seed
        assert int(bonus) == host.bonus, seed
        jpath, jtoks, _, _ = jaccept.greedy_tree_accept_device(cm, maxd, tokens, logits)
        assert np.array_equal(path.numpy(), np.asarray(jpath)), seed
        assert np.array_equal(toks.numpy(), np.asarray(jtoks)), seed


@pytest.mark.parametrize("block", range(2))
def test_stochastic_device_matches_host(block):
    for seed in range(block * 30, block * 30 + 30):
        rng, topo, tokens, logits, q = _case(seed)
        cm = tree.children_matrix(topo)
        maxd = int(topo.depths.max())
        accept_u, bonus_u = accept.draw_uniforms(topo, rng)
        temp = 0.5 + 0.5 * float(rng.uniform())
        host = accept.stochastic_tree_accept_uniforms(topo, tokens, logits, q, accept_u,
                                                      bonus_u, temp)
        path, toks, bonus, n = (x[0] for x in accept.stochastic_tree_accept_device(
            torch.from_numpy(cm).long(), maxd, torch.from_numpy(tokens)[None],
            torch.from_numpy(logits)[None], torch.from_numpy(q)[None],
            torch.from_numpy(accept_u.astype(np.float32))[None],
            torch.tensor([np.float32(bonus_u)]), temp))
        n = int(n)
        assert n == host.n_accepted, seed
        assert np.array_equal(path.numpy()[: n + 1], host.path), seed
        assert np.array_equal(toks.numpy()[: n + 1], host.tokens), seed
        assert int(bonus) == host.bonus, seed


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_device_accept_rows_match_host_row_by_row(seed, stochastic):
    """A batch of 12 rows on one topology (the batched engine's case): each
    row's walk equals the host walk on that row's tokens, logits and
    uniforms."""
    rng = np.random.default_rng(100 + seed)
    topo = tree.build_topology(4, 2, ["bfs", "dfs"][seed % 2])
    T, V, R = topo.num_nodes, 11, 12
    cm = torch.from_numpy(tree.children_matrix(topo)).long()
    maxd = int(topo.depths.max())
    tokens = rng.integers(0, V, (R, T))
    logits = rng.normal(size=(R, T, V)).astype(np.float32)
    q = rng.dirichlet(np.ones(V), size=(R, T)).astype(np.float32)
    us = [accept.draw_uniforms(topo, rng) for _ in range(R)]
    if stochastic:
        out = accept.stochastic_tree_accept_device(
            cm, maxd, torch.from_numpy(tokens), torch.from_numpy(logits), torch.from_numpy(q),
            torch.from_numpy(np.stack([u for u, _ in us]).astype(np.float32)),
            torch.tensor([b for _, b in us], dtype=torch.float32), 0.8)
    else:
        out = accept.greedy_tree_accept_device(cm, maxd, torch.from_numpy(tokens),
                                               torch.from_numpy(logits))
    path, toks, bonus, n = (x.numpy() for x in out)
    for r in range(R):
        host = (accept.stochastic_tree_accept_uniforms(topo, tokens[r], logits[r], q[r],
                                                       us[r][0], us[r][1], 0.8)
                if stochastic else accept.greedy_tree_accept(topo, tokens[r], logits[r]))
        k = int(n[r])
        assert k == host.n_accepted
        assert np.array_equal(path[r, : k + 1], host.path)
        assert np.array_equal(toks[r, : k + 1], host.tokens) and int(bonus[r]) == host.bonus


@pytest.mark.parametrize("depth,width,order,budget", [(4, 2, "bfs", 0), (3, 3, "dfs", 0),
                                                      (6, 4, "bfs", 20)])
def test_tree_topology_matches_jax(depth, width, order, budget):
    a = tree.build_topology(depth, width, order, budget)
    b = jtree.build_topology(depth, width, order, budget)
    for field in ("parents", "depths", "mask", "paths"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(tree.children_matrix(a), jtree.children_matrix(b))
    np.testing.assert_array_equal(draft.sibling_ranks(a), jdraft.sibling_ranks(b))


def test_expand_tree_matches_jax():
    kw = dict(name="d", num_layers=1, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
              vocab_size=97, dtype="float32", attention="dense", max_seq_len=256)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompt = np.random.default_rng(3).integers(0, 97, (1, 40))
    _, jc = jmodel.prefill(jp, jcfg, jnp.asarray(prompt), 128)
    _, tc = model.prefill(tp, cfg, torch.from_numpy(prompt), 128)
    topo = tree.build_topology(3, 2, "bfs")
    jt, jq, _ = jdraft.expand_tree(
        lambda c, t, p, m, par: jmodel.verify_step(jp, jcfg, c, t, p, m, par),
        jcfg, jc, jtree.build_topology(3, 2, "bfs"), jnp.asarray([5], jnp.int32))
    tt, tq, _ = draft.expand_tree(
        lambda c, t, p, m: model.verify_step(tp, cfg, c, t, p, m),
        tc, draft.TreeTensors(topo, "cpu"), torch.tensor([5]))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=2e-4, atol=2e-6)
