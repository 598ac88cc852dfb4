"""Parity of the port's training math with the JAX package, on the CPU in
float32: the same numpy inputs and bridged weights go through both.

* ``forward_train`` hidden states and ``loss_fn`` for a reduced NSA target
  and its dense draft (every dense ``attention_impl``), remat on and off:
  rtol 2e-4 / atol 2e-5;
* the gradient of every leaf against ``jax.grad`` of ``loss_fn``
  (``attend_train_nsa`` included), unstacked through ``from_jax``: rtol
  1e-3 / atol 1e-6;
* ``attend_train_flash`` (a ``torch.autograd.Function``) forward and
  gradients against the JAX custom VJP, ``attend_train_online`` and the
  ``chunked_remat`` mode against JAX;
* the schedules, global-norm clipping and 3 AdamW steps against JAX;
* ``_quantize`` fed the JAX noise, and the error-feedback identity;
* ``bridge.to_jax``: the JAX layout, and ``from_jax(to_jax(p)) == p``
  bitwise in float32 and bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from repro.configs import reduced as jreduced
from repro.core import draft as jdraft
from repro.models import attention as jattn, model as jmodel
from repro.optim import adamw as jadamw, compress as jcompress
from repro_torch.bridge import from_jax, init_params, to_jax
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.configs import reduced
from repro_torch.core import draft as tdraft
from repro_torch.models import attention, model
from repro_torch.optim import adamw, compress, tree_leaves

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5          # forward and loss
GRTOL, GATOL = 1e-3, 1e-6        # gradients
S, ATTN_CHUNK = 96, 32           # 3 query chunks in every chunked attention


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small models: the tier-1 run puts
    several test workers on the machine's cores, and a pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def torch_grads_like_jax(jgrads, cfg):
    """JAX grads -> the port's layout (the check unstacks them too)."""
    return from_jax(jax.tree.map(np.asarray, jgrads), cfg, "cpu")


def configs(kind, impl="chunked"):
    jcfg, tcfg = jreduced("ssv-nsa-1b", layers=2), reduced("ssv-nsa-1b", layers=2)
    if kind == "draft":
        jcfg = dataclasses.replace(jdraft.draft_config(jcfg), attention_impl=impl)
        tcfg = dataclasses.replace(tdraft.draft_config(tcfg), attention_impl=impl)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, S))


def pair(kind, impl="chunked", seed=0):
    jcfg, tcfg = configs(kind, impl)
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("kind,impl", [("target", "chunked"), ("draft", "chunked"),
                                       ("draft", "chunked_remat"), ("draft", "online"),
                                       ("draft", "flash")])
def test_forward_train_and_loss_match_jax(kind, impl, remat, tokens):
    jcfg, jp, tcfg, tp = pair(kind, impl)
    kw = dict(remat=remat, attn_chunk=ATTN_CHUNK)
    (hj, auxj, npj), lj = jax.jit(lambda p, t: (
        jmodel.forward_train(p, jcfg, t, **kw),
        jmodel.loss_fn(p, jcfg, t, loss_chunk=40, **kw)))(jp, jnp.asarray(tokens))
    with torch.no_grad():
        ht, auxt, npt = model.forward_train(tp, tcfg, torch.as_tensor(tokens), **kw)
        lt = model.loss_fn(tp, tcfg, torch.as_tensor(tokens), loss_chunk=40, **kw)
    assert npt == npj == 0 and float(auxt) == float(auxj) == 0.0
    close(ht, hj)
    close(lt, lj)


@pytest.mark.parametrize("kind", ["target", "draft"])
def test_gradients_of_every_leaf_match_jax(kind, tokens):
    """Autograd through the port's loss (``attend_train_nsa`` with its Top-n
    selection on the target, each layer recomputed under remat) gives the
    JAX gradient of every parameter."""
    jcfg, jp, tcfg, tp = pair(kind, seed=1)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, t: jmodel.loss_fn(p, jcfg, t, remat=True, attn_chunk=ATTN_CHUNK)))(
        jp, jnp.asarray(tokens))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    lt = model.loss_fn(tp, tcfg, torch.as_tensor(tokens), remat=True, attn_chunk=ATTN_CHUNK)
    gt = torch.autograd.grad(lt, leaves)
    close(lt.detach(), lj)
    want = tree_leaves(torch_grads_like_jax(gj, tcfg))
    assert len(want) == len(gt) == len(leaves)
    for a, b in zip(gt, want):
        close(a, b, GRTOL, GATOL)
    assert max(float(g.abs().max()) for g in gt) > 1e-3


# ---------------------------------------------------------------- attentions
ATT_KW = dict(name="a", num_layers=1, d_model=128, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=97, dtype="float32", attention="dense")


def attention_inputs(seed=0, B=2, Sq=64):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = JModelConfig(**ATT_KW), ModelConfig(**ATT_KW)
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = rng.standard_normal((B, Sq, 128)).astype(np.float32)
    ct = rng.standard_normal((B, Sq, 128)).astype(np.float32)      # output cotangent
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32)[None], (B, Sq)).copy()
    return jcfg, tcfg, jp, x, ct, pos


def jax_attention_grads(fn, jp, x, ct, pos):
    """(out, d/dx, d/dparams) of mean(fn(params, x) * ct) in JAX (a loss's
    scale: the mean over outputs)."""
    def f(p, xx):
        out = fn(p, xx, jnp.asarray(pos))[0]
        return jnp.mean(out * ct), out
    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    return out, gx, gp


def torch_attention_grads(fn, jp, x, ct, pos):
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = fn(tp, tx, torch.from_numpy(pos))[0]
    gx, *gps = torch.autograd.grad((out * torch.from_numpy(ct)).mean(), [tx, *tp.values()])
    return out.detach(), gx, dict(zip(tp, gps))


def check_attention(jfn, tfn, seed=0):
    jcfg, tcfg, jp, x, ct, pos = attention_inputs(seed)
    oj, gxj, gpj = jax_attention_grads(lambda p, xx, ps: jfn(p, jcfg, xx, ps), jp, x, ct, pos)
    ot, gxt, gpt = torch_attention_grads(lambda p, xx, ps: tfn(p, tcfg, xx, ps), jp, x, ct, pos)
    close(ot, oj)
    for got, want in [(gxt, gxj)] + [(gpt[k], gpj[k]) for k in gpj]:
        close(got, want, GRTOL, GATOL)
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("window", [0, 24])
def test_attend_train_flash_matches_jax_custom_vjp(window):
    """The ``FlashCore`` autograd Function against ``_flash_core``'s
    custom VJP: output, input and weight gradients (4 tiles of 16)."""
    check_attention(
        lambda p, c, x, pos: jattn.attend_train_flash(p, c, x, pos, window=window, chunk=16),
        lambda p, c, x, pos: attention.attend_train_flash(p, c, x, pos, window=window,
                                                          chunk=16))


def test_flash_core_matches_dense_attention_in_torch():
    """``FlashCore``'s own backward against autograd through the plain
    masked softmax on the same tensors."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 48, 2, 2, 16), generator=g, requires_grad=True)
    k = torch.randn((1, 48, 2, 16), generator=g, requires_grad=True)
    v = torch.randn((1, 48, 2, 16), generator=g, requires_grad=True)
    do = torch.randn((1, 48, 2, 2, 16), generator=g)
    o = attention.FlashCore.apply(q, k, v, 0.25, 20, 16)
    got = torch.autograd.grad((o * do).sum(), [q, k, v])
    mask = attention.causal_mask(48, 48, "cpu", window=20)
    o_ref = attention._sdpa(q, k, v, mask, 0.25)
    want = torch.autograd.grad((o_ref * do).sum(), [q, k, v])
    close(o.detach(), o_ref.detach())
    for a, b in zip(got, want):
        close(a, b, GRTOL, GATOL)


@pytest.mark.parametrize("window", [0, 24])
def test_attend_train_online_matches_jax(window):
    check_attention(
        lambda p, c, x, pos: jattn.attend_train_online(p, c, x, pos, window=window,
                                                       q_chunk=16, kv_chunk=32),
        lambda p, c, x, pos: attention.attend_train_online(p, c, x, pos, window=window,
                                                           q_chunk=16, kv_chunk=32),
        seed=1)


def test_attend_train_chunked_remat_matches_jax():
    check_attention(
        lambda p, c, x, pos: jattn.attend_train(p, c, x, pos, chunk=16, remat_chunks=True),
        lambda p, c, x, pos: attention.attend_train(p, c, x, pos, chunk=16,
                                                    remat_chunks=True),
        seed=2)


# ---------------------------------------------------------------- optimizer
TC = dict(steps=20, learning_rate=3e-3, warmup_steps=4, weight_decay=0.1)


def test_schedules_match_jax():
    jt, tt = JTrainConfig(**TC), TrainConfig(**TC)
    for jf, tf in ((jadamw.cosine_schedule, adamw.cosine_schedule),
                   (jadamw.linear_schedule, adamw.linear_schedule)):
        for step in range(0, 25):
            close(tf(tt)(torch.tensor(step)), jf(jt)(step), 1e-6, 0)


def random_tree(jp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), jp)


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_global_norm_and_clip_match_jax(max_norm):
    jcfg, jp, tcfg, _ = pair("draft")
    jg = random_tree(jp, 3)
    tg = from_jax(jg, tcfg, "cpu")
    cj, nj = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, jg), max_norm)
    ct, nt = adamw.clip_by_global_norm(tg, max_norm)
    close(nt, nj)
    close(adamw.global_norm(tg), jadamw.global_norm(jg))
    for a, b in zip(tree_leaves(ct), tree_leaves(torch_grads_like_jax(cj, tcfg))):
        assert a.dtype == torch.float32
        close(a, b)


def test_three_adamw_steps_match_jax():
    jcfg, jp, tcfg, tp = pair("target")
    jt, tt = JTrainConfig(**TC), TrainConfig(**TC)
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    update = jax.jit(jadamw.adamw_update, static_argnums=3)
    for i in range(3):
        jg = random_tree(jp, 10 + i, scale=0.1)
        jp, js = update(jax.tree.map(jnp.asarray, jg), js, jp, jt)
        tp, ts = adamw.adamw_update(from_jax(jg, tcfg, "cpu"), ts, tp, tt)
    assert int(ts.count) == int(js.count) == 3 and ts.count.dtype == torch.int32
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(tree_leaves(got), tree_leaves(torch_grads_like_jax(want, tcfg))):
            close(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_keeps_float32_moments_and_decays_as_jax_stacks(dtype):
    """float32 moments and params back in their dtype. A zero gradient
    moves exactly the leaves the JAX update decays: 2+ dims in the JAX
    layout, where per-layer vectors are stacked over layers (they decay)
    and the final norm is not (it stays); in float32, where the decay of
    one step is not rounded away."""
    cfg = dataclasses.replace(reduced("ssv-nsa-1b", layers=1), dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for name in ("b_gate", "phi_k", "phi_v"):                # zero-initialised vectors
        params["layers"][0]["mix"][name] += 1.0
    state = adamw.adamw_init(params)
    zero = adamw.tree_map(torch.zeros_like, params)
    tc = TrainConfig(**dict(TC, warmup_steps=0))
    new, state = adamw.adamw_update(zero, state, params, tc)
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.mu) + tree_leaves(state.nu))
    assert all(q.dtype == p.dtype for p, q in zip(tree_leaves(params), tree_leaves(new)))
    if dtype == "bfloat16":
        return
    mask = adamw.decay_mask(params)
    for p, q, decays in zip(tree_leaves(params), tree_leaves(new), tree_leaves(mask)):
        assert torch.equal(p, q) != decays
    assert not mask["final_norm"]["scale"] and mask["layers"][0]["norm1"]["scale"]
    assert mask["layers"][0]["mix"]["b_gate"] and mask["embed"]["table"]


# ---------------------------------------------------------------- compression
def test_quantize_matches_jax_given_its_noise():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((33, 17)) * 0.3).astype(np.float32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 5), 7)
    qj, sj = jcompress._quantize(jnp.asarray(x), key)
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    qt, st = compress._quantize(torch.from_numpy(x), torch.from_numpy(noise))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    close(st, sj, 1e-7, 0)


def test_error_feedback_identity():
    """decompress(q) + new residual == grad + old residual, leaf by leaf;
    the noise is reproducible per (leaf, step)."""
    cfg = tdraft.draft_config(reduced("ssv-nsa-1b", layers=1))
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    grads = adamw.tree_map(lambda p: torch.randn(p.shape, generator=g) * 0.01, params)
    res = adamw.tree_map(lambda p: torch.randn(p.shape, generator=g) * 1e-4, params)
    quant, new_res = compress.compress_pytree(grads, res, step=3)
    deq = compress.decompress_pytree(quant)
    for a, b, r0, r1, q in zip(*map(tree_leaves, (grads, deq, res, new_res, quant[0]))):
        assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
        close(b + r1, a + r0, 1e-6, 1e-9)
    again, _ = compress.compress_pytree(grads, res, step=3)
    other, _ = compress.compress_pytree(grads, res, step=4)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(quant[0]), tree_leaves(again[0])))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(quant[0]),
                                                     tree_leaves(other[0])))


# ---------------------------------------------------------------- bridge
def test_to_jax_gives_the_jax_layout():
    jcfg, jp, tcfg, tp = pair("target")
    back = to_jax(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), np_leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_jax_round_trip_is_bitwise(dtype):
    cfg = dataclasses.replace(reduced("ssv-nsa-1b", layers=3), dtype=dtype)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    q = from_jax(to_jax(p, cfg), cfg, "cpu")
    for a, b in zip(tree_leaves(p), tree_leaves(q)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
