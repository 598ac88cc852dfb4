"""The port's mixture-of-experts FFN and activations against the JAX
package (``repro.models.moe`` / ``repro.models.layers``) on the same numpy
inputs: outputs within the float32 tolerance (rtol 2e-4, atol 2e-5), the
top-k experts, each assignment's place in its expert and the set of kept
assignments exactly equal. Cases: capacity drops forced by skewed routing,
an odd token count (the dispatch group halves to 1), 16 experts / top-8
with a shared expert, a model-level call of several rows (flattened, as
JAX) and per-row groups (the JAX batched engine's per-row vmap), both
expert paths (all experts at once, min(C, G) places per expert and group,
and one expert at a time). Also the MoE
weights through the bridge and through checkpoints across packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.models import layers as jlayers, model as jmodel, moe as jmoe
from repro_torch import configs
from repro_torch.bridge import from_jax, init_params, to_jax
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.models import layers, moe

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(jlayers.ACTIVATIONS) + sorted(jlayers.GATED))
def test_activations_match_jax(name):
    """Every activation of both tables; gelu is the tanh form, as
    ``jax.nn.gelu``'s default (PyTorch's default, erf, differs by ~1e-3)."""
    x = np.random.default_rng(0).normal(size=(4, 257)).astype(np.float32) * 3
    table, jtable = ((layers.ACTIVATIONS, jlayers.ACTIVATIONS) if name in jlayers.ACTIVATIONS
                     else (layers.GATED, jlayers.GATED))
    close(jtable[name](jnp.asarray(x)), table[name](torch.from_numpy(x)))


@pytest.mark.parametrize("activation", ["gelu", "swiglu", "squared_relu", "geglu"])
def test_ffn_gated_and_plain_match_jax(activation):
    rng = np.random.default_rng(1)
    p = jlayers.ffn_init(jax.random.PRNGKey(1), 64, 96, activation)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    assert ("w_gate" in p) == (activation in layers.GATED)
    close(jlayers.ffn(p, jnp.asarray(x), activation),
          layers.ffn(tp, torch.from_numpy(x), activation))


def moe_cfgs(E=4, K=2, group=64, shared=0, activation="swiglu"):
    jc = jconfigs.reduced("qwen3-moe-235b-a22b")
    jc = dataclasses.replace(jc, activation=activation, moe=dataclasses.replace(
        jc.moe, num_experts=E, top_k=K, dispatch_group=group, num_shared_experts=shared))
    tc = configs.reduced("qwen3-moe-235b-a22b")
    tc = dataclasses.replace(tc, activation=activation, moe=dataclasses.replace(
        tc.moe, num_experts=E, top_k=K, dispatch_group=group, num_shared_experts=shared))
    return jc, tc


def jax_dispatch(p, jc, x, group_tokens):
    """The reference's top-k and per-group places (``moe_apply``'s lines,
    repeated): (topk_idx, pos_in_e, keep)."""
    m = jc.moe
    N = x.shape[0]
    G = min(m.dispatch_group, group_tokens)
    while group_tokens % G:
        G //= 2
    C = max(int(np.ceil(G * m.top_k * m.capacity_factor / m.num_experts)), m.top_k)
    _, idx, _ = jmoe.router_probs(p, jnp.asarray(x), m)
    onehot = jax.nn.one_hot(idx.reshape(N // G, G * m.top_k), m.num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos = (pos * onehot).sum(-1).reshape(N, m.top_k)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < C)


CASES = {
    # name: (E, K, group, shared, B, S, skew)
    "skewed-drops": (4, 2, 64, 0, 1, 48, True),
    "odd-group-1": (4, 2, 16, 0, 1, 37, False),
    "e16-k8-shared": (16, 8, 64, 1, 1, 40, False),
    "rows-flattened": (4, 2, 64, 0, 3, 20, True),
}


@pytest.mark.parametrize("expert_path", ["all-at-once", "one-by-one"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, expert_path):
    E, K, group, shared, B, S, skew = CASES[case]
    jc, tc = moe_cfgs(E, K, group, shared)
    p = jmoe.moe_init(jax.random.PRNGKey(2), jc)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    if skew:      # every token prefers expert 0, so its capacity overflows
        x += 2.0
        p = dict(p, router=p["router"].at[:, 0].add(0.05))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    jy, jaux = jmoe.moe_apply(p, jc, jnp.asarray(x))
    ty, taux = moe.moe_apply(tp, tc, torch.from_numpy(x), by_expert=expert_path == "one-by-one")
    close(jy, ty)
    close(jaux, taux)
    # the same experts, places and kept set as the reference
    xf = x.reshape(B * S, -1)
    j_idx, j_pos, j_keep = jax_dispatch(p, jc, xf, B * S)
    _, t_idx, _ = moe.router_probs(tp, torch.from_numpy(xf), tc.moe)
    G = moe.group_size(B * S, tc.moe)
    t_pos, t_keep = moe.dispatch(t_idx, G, moe.capacity(G, tc.moe), E)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_pos.numpy(), j_pos)
    np.testing.assert_array_equal(t_keep.numpy(), j_keep)
    if skew:
        assert not j_keep.all()            # some assignments were dropped
    if case == "odd-group-1":
        assert G == 1


def test_moe_per_row_groups_match_jax_vmap():
    """``per_row``: each row's own dispatch groups, as the JAX batched
    engine's per-row vmap of a batch of one (here the groups differ from
    the flattened call's, and so do the kept sets)."""
    jc, tc = moe_cfgs(group=64)     # rows: one group of 24; flattened: groups of 8
    p = jmoe.moe_init(jax.random.PRNGKey(4), jc)
    x = np.random.default_rng(5).normal(size=(3, 24, jc.d_model)).astype(np.float32) + 2.0
    p = dict(p, router=p["router"].at[:, 1].add(0.05))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    jy = jax.vmap(lambda r: jmoe.moe_apply(p, jc, r[None])[0][0])(jnp.asarray(x))
    ty, _ = moe.moe_apply(tp, tc, torch.from_numpy(x), per_row=True)
    close(jy, ty)
    flat, _ = moe.moe_apply(tp, tc, torch.from_numpy(x))
    assert not torch.allclose(flat, ty, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def moe_model():
    jc = jconfigs.nsa_variant(jconfigs.reduced("qwen3-moe-235b-a22b", layers=3))
    tc = configs.nsa_variant(configs.reduced("qwen3-moe-235b-a22b", layers=3))
    jp = jmodel.init(jax.random.PRNGKey(6), jc)
    return jc, tc, jp


def test_moe_bridge_both_ways(moe_model):
    """The per-expert stacks (E, d, dff) inside the segment stacks: JAX ->
    port unstacks layer by layer, port -> JAX re-stacks to the same arrays."""
    jc, tc, jp = moe_model
    tp = from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    ffn = tp["layers"][1]["ffn"]
    m = tc.moe
    assert tuple(ffn["w_up"].shape) == (m.num_experts, tc.d_model, m.d_expert)
    assert tuple(ffn["w_down"].shape) == (m.num_experts, m.d_expert, tc.d_model)
    np.testing.assert_array_equal(ffn["router"].numpy(),
                                  np.asarray(jp["segments"][0][0]["ffn"]["router"][1]))
    back = to_jax(tp, tc)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp))


def test_moe_init_params_has_the_jax_leaves(moe_model):
    """``init_params`` draws every leaf the JAX ``model.init`` has, with its
    shape and dtype (the router in float32), and moments near JAX's."""
    jc, tc, jp = moe_model
    tp = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                       to_jax(tp, tc))
    assert got == want
    w = tp["layers"][0]["ffn"]["w_up"]
    assert abs(float(w.std()) * np.sqrt(tc.d_model) - 1) < 0.05


def test_moe_checkpoint_round_trips_across_packages(moe_model, tmp_path):
    """A JAX checkpoint of MoE params restores into the port bitwise, and
    the port's checkpoint restores into the JAX template bitwise."""
    jc, tc, jp = moe_model
    jckpt.save(str(tmp_path / "jax"), 1, {"params": jp})
    template = {"params": init_params(tc, torch.Generator().manual_seed(1), "cpu")}
    step, got = ckpt.restore(str(tmp_path / "jax"), template, tc)
    want = from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    assert step == 1
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want)):
        assert torch.equal(a, b)
    ckpt.save(str(tmp_path / "port"), 2, ckpt.jax_layout(got, tc))
    step, back = jckpt.restore(str(tmp_path / "port"), {"params": jp})
    assert step == 2
    for a, b in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
