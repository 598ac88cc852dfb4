"""The attention model zoo in the port, held against the JAX package on
bridged weights (the reduced variants of ``configs``): qwen3-8b (qk-norm),
granite-20b (MQA, gelu), mixtral-8x22b (MoE 8 / top-2, sliding window),
qwen3-moe-235b-a22b (MoE, qk-norm), musicgen-medium (audio frontend,
gelu), smollm-360m (Gq 3), pixtral-12b (vision frontend) and
nemotron-4-340b (squared ReLU), each as its NSA variant
(``configs.nsa_variant``, as the serve CLIs serve it), plus mixtral with
its own ``attention="swa"``: prefill, ``verify_step`` and ``commit``
(hidden states, logits and the committed caches within rtol 2e-4 / atol
2e-5, argmax tokens equal); the audio and vision frontends through
``prefill`` and ``loss_fn``; tied embeddings; the registry (all twelve JAX
ids; the recurrent archs' models are in ``test_torch_recurrent.py``); and
the engines' tokens equal to the JAX engines' for reduced qwen3-moe and
for granite with its query heads raised to 16 over 1 kv head (single
stream and batched, accepted counts too)."""
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
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.bridge import from_jax
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft, engine
from repro_torch.launch import serve
from repro_torch.models import model

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
ZOO = ("qwen3-8b", "granite-20b", "mixtral-8x22b", "qwen3-moe-235b-a22b", "musicgen-medium",
       "smollm-360m", "pixtral-12b", "nemotron-4-340b")
RECURRENT = ("recurrentgemma-9b", "xlstm-125m")   # their models: test_torch_recurrent.py
PROMPT = 110              # > window (32) + n_selected (4) * sel_block (16)
MAX_CTX = 160


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


def pair_of(arch, nsa=True, **over):
    jc, tc = jconfigs.reduced(arch, layers=2), configs.reduced(arch, layers=2)
    if nsa:
        jc, tc = jconfigs.nsa_variant(jc), configs.nsa_variant(tc)
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    jp = jmodel.init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")


@pytest.mark.parametrize("arch", ZOO + RECURRENT)
def test_registry_matches_jax(arch):
    """Each config, its DRYRUN / FRONTEND_LEN, its NSA variant and its
    reduced variant are the JAX package's."""
    asdict = dataclasses.asdict
    assert asdict(configs.get_config(arch)) == asdict(jconfigs.get_config(arch))
    assert configs.dryrun_overrides(arch) == jconfigs.dryrun_overrides(arch)
    assert configs.frontend_len(arch) == jconfigs.frontend_len(arch)
    assert asdict(configs.nsa_variant(configs.get_config(arch))) == \
        asdict(jconfigs.nsa_variant(jconfigs.get_config(arch)))
    assert asdict(configs.reduced(arch)) == asdict(jconfigs.reduced(arch))


def test_registry_holds_every_jax_arch():
    """The port's registry is the JAX package's, in its order, and the
    model takes every arch (and every arch's NSA variant)."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        model.check_supported(configs.get_config(arch))
        model.check_supported(configs.nsa_variant(configs.get_config(arch)))


@pytest.mark.parametrize("arch", ZOO + ("mixtral-8x22b-swa",))
def test_prefill_verify_commit_match_jax(arch):
    """Two rows: prefill, a D3/k2 tree verify under exact C=2, then a
    commit of a 3-node path in row 0 and of nothing in row 1."""
    swa = arch.endswith("-swa")
    jc, tc, jp, tp = pair_of(arch.removesuffix("-swa"), nsa=not swa)
    assert tc.attention == ("swa" if swa else "nsa")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab_size, (2, PROMPT))
    jh, jcache = jmodel.prefill(jp, jc, jnp.asarray(toks), MAX_CTX)
    th, tcache = model.prefill(tp, tc, torch.from_numpy(toks), MAX_CTX)
    close(jh, th)
    topo = build_topology(3, 2, "bfs")
    T = topo.num_nodes
    dtoks = rng.integers(0, tc.vocab_size, (2, T))
    pos = np.broadcast_to(PROMPT + topo.depths, (2, T)).astype(np.int32)
    mask = np.broadcast_to(topo.mask, (2, T, T))
    kw = dict(tree_depth=3, tree_width=2, group_size=2, group_mode="exact")
    jl, jup = jmodel.verify_step(jp, jc, jcache, jnp.asarray(dtoks), jnp.asarray(pos),
                                 jnp.asarray(mask), jnp.asarray(topo.parents), JSSV(**kw))
    tl, tup = model.verify_step(tp, tc, tcache, torch.from_numpy(dtoks),
                                torch.from_numpy(pos.copy()), torch.from_numpy(mask.copy()),
                                None, SSVConfig(**kw))
    close(jl, tl)
    np.testing.assert_array_equal(np.asarray(jl).argmax(-1), tl.numpy().argmax(-1))
    # commit a path in row 0; the JAX commit takes one scalar length, so
    # each row commits as a batch of one there
    path = np.array([[0, 1, 3], [0, 0, 0]])
    n_acc = np.array([3, 0], np.int32)
    model.commit(tp, tc, tcache, tup, torch.from_numpy(path), torch.from_numpy(n_acc))
    for b in range(2):
        row = jax.tree.map(lambda a: a[:, b:b + 1] if getattr(a, "ndim", 0) > 1 else a, jcache)
        rup = jax.tree.map(lambda a: a[:, b:b + 1], jup)
        jc_b = jmodel.commit(jp, jc, row, rup, jnp.asarray(path[b:b + 1]),
                             jnp.asarray(np.maximum(n_acc[b:b + 1], 1)))
        keep = PROMPT + n_acc[b]
        assert int(tcache["length"][b]) == keep
        for li, layer in enumerate(tcache["layers"]):
            jl_ = jax.tree.map(lambda a: np.asarray(a[li, 0]), jc_b["segments"][0][0])
            close(jl_["kv"]["k"][:keep], layer["kv"]["k"][b, :keep])
            close(jl_["kv"]["v"][:keep], layer["kv"]["v"][b, :keep])
            if "cmp" in layer:
                ncb = tc.nsa.num_cmp_blocks(keep)
                close(jl_["cmp"]["k_cmp"][:ncb], layer["cmp"]["k_cmp"][b, :ncb])


@pytest.mark.parametrize("arch,modality", [("musicgen-medium", "audio"),
                                           ("pixtral-12b", "vision")])
def test_frontend_prefill_and_loss_match_jax(arch, modality):
    """musicgen's audio and pixtral's vision frontends: projected frames
    ahead of the tokens in ``prefill`` (hidden states and caches) and in
    ``loss_fn`` (the tokens' next-token loss, counted after the frames)."""
    jc, tc, jp, tp = pair_of(arch)
    assert "frontend_proj" in tp and tc.modality == modality
    rng = np.random.default_rng(2)
    n_front = min(configs.frontend_len(arch), 64)
    front = rng.normal(size=(2, n_front, tc.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, tc.vocab_size, (2, 48))
    jh, jcache = jmodel.prefill(jp, jc, jnp.asarray(toks), MAX_CTX, frontend=jnp.asarray(front))
    th, tcache = model.prefill(tp, tc, torch.from_numpy(toks), MAX_CTX,
                               frontend=torch.from_numpy(front))
    assert th.shape[1] == n_front + 48 and int(tcache["length"][0]) == n_front + 48
    close(jh, th)
    close(np.asarray(jcache["segments"][0][0]["kv"]["k"][1]), tcache["layers"][1]["kv"]["k"])
    jloss = jmodel.loss_fn(jp, jc, jnp.asarray(toks), frontend=jnp.asarray(front))
    tloss = model.loss_fn(tp, tc, torch.from_numpy(toks), frontend=torch.from_numpy(front))
    close(jloss, tloss)


def test_tied_embeddings_and_moe_loss_match_jax():
    """Tied embeddings unembed through the embedding table (no lm_head),
    and a MoE model's training loss carries the load-balancing term."""
    jc, tc, jp, tp = pair_of("qwen3-moe-235b-a22b", tie_embeddings=True)
    assert "lm_head" not in tp
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 40))
    _, jaux, _ = jmodel.forward_train(jp, jc, jnp.asarray(toks))
    _, taux, _ = model.forward_train(tp, tc, torch.from_numpy(toks))
    assert float(taux) > 0
    close(jaux, taux)
    close(jmodel.loss_fn(jp, jc, jnp.asarray(toks)), model.loss_fn(tp, tc, torch.from_numpy(toks)))


def engine_pair(arch, **over):
    jc, tc, jp, tp = pair_of(arch, **over)
    jd, td = jdraft.draft_config(jc, num_layers=1), draft.draft_config(tc, num_layers=1)
    jdp = jmodel.init(jax.random.PRNGKey(1), jd)
    tdp = from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    return (jc, jp, jd, jdp), (tc, tp, td, tdp)


STRATEGY = dict(tree_depth=2, tree_width=2, group_size=2, group_mode="exact",
                precision_class="Strict")


@pytest.mark.parametrize("arch,over", [("qwen3-moe-235b-a22b", {}),
                                       ("granite-20b", dict(num_heads=16, num_kv_heads=1))],
                         ids=["qwen3-moe", "granite-gq16"])
def test_engines_match_jax(arch, over):
    """``SSVEngine.generate`` and ``BatchedSSVEngine.generate_batch`` (2
    rows: per-row MoE dispatch groups, as the JAX engine's per-row vmap)
    against the JAX engines: tokens and accepted counts equal."""
    (jc, jp, jd, jdp), (tc, tp, td, tdp) = engine_pair(arch, **over)
    if over:
        assert tc.num_heads // tc.num_kv_heads == 16
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tc.vocab_size, n) for n in (PROMPT, PROMPT + 9)]
    serve_kw = dict(max_new_tokens=6, max_context=MAX_CTX)
    je = jengine.SSVEngine(jp, jc, jdp, jd, JServe(**serve_kw, ssv=JSSV(**STRATEGY),
                                                   use_planner=False))
    te = engine.SSVEngine(tp, tc, tdp, td, ServeConfig(**serve_kw, ssv=SSVConfig(**STRATEGY)),
                          device="cpu")
    jr, tr = je.generate(prompts[0], 6), te.generate(prompts[0], 6)
    np.testing.assert_array_equal(jr.tokens, tr.tokens)
    assert [s.accepted for s in jr.steps] == [s.accepted for s in tr.steps]
    jb = jengine.BatchedSSVEngine(jp, jc, jdp, jd, JServe(
        **serve_kw, ssv=JSSV(**STRATEGY), use_planner=False)).generate_batch(prompts, 6)
    tb = engine.BatchedSSVEngine(tp, tc, tdp, td, ServeConfig(
        **serve_kw, ssv=SSVConfig(**STRATEGY)), device="cpu").generate_batch(prompts, 6)
    for a, b in zip(jb.results, tb.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert [s.accepted for s in a.steps] == [s.accepted for s in b.steps]
    np.testing.assert_array_equal(tb.results[0].tokens, tr.tokens)


def test_serve_cli_serves_a_zoo_arch_as_its_nsa_variant(capsys):
    serve.main(["--arch", "qwen3-moe-235b-a22b", "--reduced", "--device", "cpu",
                "--prompts", "1", "--tokens", "4", "--prompt-len", "40"])
    assert "prompt 0: 4 tokens" in capsys.readouterr().out
