"""Card tests of the port's CUDA kernels (marker ``gpu``): each kernel
against its plain PyTorch version on the same CUDA tensors, with float32
and bfloat16 K/V (rtol=2e-4, atol=2e-5 for both), at small shapes and head
dims 64 and 128, plus the launch counters: routing, nsa_verify (full,
partial, and the vanilla single-branch launches, with the vanilla layer
against the fused layer's plain path), and flash tree-verify (up to 124
query rows, window 0 and 16, and on two streams at once); the wrappers
reject head dims other than 64 and 128 and K/V that are not 16-byte
aligned. Whether a card is present is decided in a fixture, so every worker
collects the same tests; without a card they skip. Run them on
the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``."""
import pytest
import torch

from repro_torch.config import ModelConfig, NSAConfig
from repro_torch.bridge import init_params
from repro_torch.core.tree import build_topology
from repro_torch.kernels.flash import ops as fops, ref as fref
from repro_torch.kernels.nsa_verify import ops as vops
from repro_torch.kernels.routing import ops as rops, ref as rref
from repro_torch.models import model as model_lib, nsa as nsa_lib

NSA = NSAConfig(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
# Both sides compute in float32 from the same values, so bf16 K/V are held
# to the float32 tolerance too.
TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2e-4, 2e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, T=7, Hq=8, Hkv=2, S=256, prefix=180, seed=0, Dh=64):
    g = torch.Generator(dev)
    g.manual_seed(seed)
    r = lambda *s, dt=dtype: torch.randn(s, generator=g, device=dev).to(dt)
    ncb = nsa_lib.num_cmp_blocks(S, NSA)
    pos = (prefix + torch.minimum(torch.arange(T, device=dev), torch.tensor(3, device=dev)))
    pos = pos[None].to(torch.int32)
    p_slc = torch.rand((1, T, Hkv, nsa_lib.num_sel_blocks(S, NSA)), generator=g, device=dev)
    plen = torch.tensor([prefix], dtype=torch.int32, device=dev)
    sel, val = nsa_lib.select_topn(p_slc, pos, plen, NSA)
    return dict(q=r(1, T, Hq, Dh, dt=torch.float32) / Dh ** 0.5, k_cache=r(1, S, Hkv, Dh),
                v_cache=r(1, S, Hkv, Dh), k_cmp=r(1, ncb, Hkv, Dh), v_cmp=r(1, ncb, Hkv, Dh),
                k_draft=r(1, T, Hkv, Dh), v_draft=r(1, T, Hkv, Dh), sel=sel, val=val,
                pos=pos, plen=plen, ncb_valid=nsa_lib.dyn_num_cmp_blocks(plen, NSA),
                tree=torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None],
                gates=torch.sigmoid(r(1, T, 3, Hq, dt=torch.float32)),
                o_cmp=r(1, T, Hq, Dh, dt=torch.float32))


def _close(a, b, dtype):
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routing_kernel_matches_plain(cuda, dtype, Dh):
    x = _inputs(cuda, dtype, Dh=Dh)
    nsb = nsa_lib.num_sel_blocks(256, NSA)
    before = rops.LAUNCHES.count
    o, p = rops.routing_fused(x["q"], x["k_cmp"], x["v_cmp"], x["pos"], x["ncb_valid"], NSA, 256)
    assert rops.LAUNCHES.count == before + 1
    M = nsa_lib.overlap_tensor(x["k_cmp"].shape[1], nsb, NSA, cuda)
    o_r, p_r = rref.ref_routing(x["q"], x["k_cmp"], x["v_cmp"], M, x["pos"],
                                x["ncb_valid"], cmp_block=8, cmp_stride=4)
    torch.cuda.synchronize()
    _close(o, o_r, dtype)
    _close(p, p_r, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,mode,full,Dh", [(1, "exact", True, 64), (2, "exact", False, 64),
                                            (4, "approx", True, 64), (2, "approx", False, 64),
                                            (2, "exact", True, 128), (4, "approx", False, 128)])
def test_verify_kernel_matches_plain(cuda, dtype, C, mode, full, Dh):
    x = _inputs(cuda, dtype, seed=C, Dh=Dh)
    args = (x["q"], x["k_cache"], x["v_cache"], x["k_cmp"], x["v_cmp"], x["k_draft"],
            x["v_draft"], x["sel"], x["val"], x["pos"], x["plen"], x["ncb_valid"],
            x["tree"], x["gates"], NSA)
    oc = None if full else x["o_cmp"]
    counter = vops.FULL_LAUNCHES if full else vops.PARTIAL_LAUNCHES
    before = counter.count
    got = vops.nsa_verify_fused(*args, C=C, mode=mode, include_cmp=full, o_cmp_in=oc)
    assert counter.count == before + 1
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    want = vops.nsa_verify_fused(*cpu, C=C, mode=mode, include_cmp=full,
                                 o_cmp_in=None if oc is None else oc.cpu())
    torch.cuda.synchronize()
    _close(got.cpu(), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_single_branch_launches_match_plain(cuda, dtype, Dh):
    """The vanilla mode: slc only and win + draft only, ungated."""
    x = _inputs(cuda, dtype, seed=5, Dh=Dh)
    args = (x["q"], x["k_cache"], x["v_cache"], x["k_cmp"], x["v_cmp"], x["k_draft"],
            x["v_draft"], x["sel"], x["val"], x["pos"], x["plen"], x["ncb_valid"],
            x["tree"], x["gates"], NSA)
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    for branch in ("slc", "win"):
        before = vops.VANILLA_LAUNCHES.count
        got = vops.nsa_verify_fused(*args, C=1, include_cmp=False, branch=branch)
        assert vops.VANILLA_LAUNCHES.count == before + 1
        want = vops.nsa_verify_fused(*cpu, C=1, include_cmp=False, branch=branch)
        torch.cuda.synchronize()
        _close(got.cpu(), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [64, 128])
def test_vanilla_layer_matches_fused_layer_plain_path(cuda, Dh):
    """Routing kernel + two single-branch launches + combine on the card
    against the fused refresh layer's plain path (CPU) on the same weights
    and caches: both compute the layer's NSA output."""
    cfg = ModelConfig(name="t", num_layers=1, d_model=4 * Dh, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=97, dtype="float32", attention="nsa", nsa=NSA)
    g = torch.Generator(cuda)
    g.manual_seed(Dh)
    params = init_params(cfg, g, cuda)
    toks = torch.randint(0, 97, (1, 150), generator=g, device=cuda)
    _, caches = model_lib.prefill(params, cfg, toks, 256)
    bp, cache = params["layers"][0]["mix"], caches["layers"][0]
    topo = build_topology(3, 2, "bfs")
    pos = (150 + torch.as_tensor(topo.depths, device=cuda))[None].to(torch.int32)
    tm = torch.as_tensor(topo.mask, device=cuda)[None]
    xin = torch.randn((1, topo.num_nodes, cfg.d_model), generator=g, device=cuda)
    plen = caches["length"]
    r0, v0 = rops.LAUNCHES.count, vops.VANILLA_LAUNCHES.count
    out, _, (si, _) = vops.nsa_verify_vanilla_layer(bp, cfg, xin, cache["kv"], cache["cmp"],
                                                    plen, pos, tm)
    assert (rops.LAUNCHES.count, vops.VANILLA_LAUNCHES.count) == (r0 + 1, v0 + 2)
    to_cpu = lambda tree: {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}
    want, _, (si_w, _) = vops.nsa_verify_kernel_layer(
        to_cpu(bp), cfg, xin.cpu(), to_cpu(cache["kv"]), to_cpu(cache["cmp"]), plen.cpu(),
        pos.cpu(), tm.cpu(), C=1, mode="exact", reuse=False)
    torch.cuda.synchronize()
    assert torch.equal(si.cpu(), si_w)
    _close(out.cpu(), want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Hq,Hkv,window,depth", [(31, 8, 8, 0, 4), (31, 32, 8, 16, 4),
                                                   (7, 4, 2, 16, 2)])
def test_flash_kernel_matches_plain(cuda, dtype, Dh, T, Hq, Hkv, window, depth):
    """Dense tree verify at D4/k2 (T=31: 31 rows at Gq 1, 124 at Gq 4) and
    D2/k2 trees, two rows of different prefix lengths in one launch."""
    g = torch.Generator(cuda)
    g.manual_seed(T + Hq + Dh)
    r = lambda *s, dt=dtype: torch.randn(s, generator=g, device=cuda).to(dt)
    S, B = 600, 2
    topo = build_topology(depth, 2, "bfs")
    assert topo.num_nodes == T
    plen = torch.tensor([517, 260], dtype=torch.int32, device=cuda)
    pos = (plen[:, None] + torch.as_tensor(topo.depths, device=cuda)[None]).to(torch.int32)
    tm = torch.as_tensor(topo.mask, device=cuda)[None].expand(B, T, T)
    args = (r(B, T, Hq, Dh, dt=torch.float32) / Dh ** 0.5, r(B, S, Hkv, Dh), r(B, S, Hkv, Dh),
            r(B, T, Hkv, Dh), r(B, T, Hkv, Dh), pos, plen, tm, window)
    before = fops.LAUNCHES.count
    got = fops.flash_verify(*args)
    got2 = fops.flash_verify(*args)             # the merge tickets were reset
    assert fops.LAUNCHES.count == before + 2
    want = fref.ref_flash_verify(*args)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    assert torch.equal(got, got2)


@pytest.mark.gpu
def test_flash_kernel_on_two_streams_at_once(cuda):
    """Launches queued on two streams may overlap; each stream has its own
    merge tickets, so both results equal the plain version."""
    g = torch.Generator(cuda)
    g.manual_seed(11)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    topo = build_topology(4, 2, "bfs")
    T, S = topo.num_nodes, 4096
    plen = torch.tensor([4000], dtype=torch.int32, device=cuda)
    pos = (plen[:, None] + torch.as_tensor(topo.depths, device=cuda)[None]).to(torch.int32)
    tm = torch.as_tensor(topo.mask, device=cuda)[None]
    cases = [(r(1, T, 32, 64) / 8, r(1, S, 8, 64), r(1, S, 8, 64), r(1, T, 8, 64),
              r(1, T, 8, 64), pos, plen, tm, 0) for _ in range(2)]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for args, s, o in zip(cases, streams, outs):
            with torch.cuda.stream(s):
                o.append(fops.flash_verify(*args))
    torch.cuda.synchronize()
    for args, o in zip(cases, outs):
        want = fref.ref_flash_verify(*args)
        for got in o:
            _close(got, want, torch.float32)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = _inputs(cuda, torch.float32)
    with pytest.raises(TypeError):
        rops.launch(x["q"].half(), x["k_cmp"], x["v_cmp"], x["pos"], x["ncb_valid"], NSA, 16)
    with pytest.raises(ValueError):
        rops.launch(x["q"], x["k_cmp"][:, ::2], x["v_cmp"][:, ::2], x["pos"],
                    x["ncb_valid"], NSA, 16)
    for Dh in (32, 96, 256):
        y = _inputs(cuda, torch.float32, Dh=Dh)
        with pytest.raises(ValueError, match="head_dim"):
            rops.routing_fused(y["q"], y["k_cmp"], y["v_cmp"], y["pos"], y["ncb_valid"], NSA, 256)
        with pytest.raises(ValueError, match="head_dim"):
            vops.nsa_verify_fused(y["q"], y["k_cache"], y["v_cache"], y["k_cmp"], y["v_cmp"],
                                  y["k_draft"], y["v_draft"], y["sel"], y["val"], y["pos"],
                                  y["plen"], y["ncb_valid"], y["tree"], y["gates"], NSA)
        with pytest.raises(ValueError, match="head_dim"):
            fops.flash_verify(y["q"], y["k_cache"], y["v_cache"], y["k_draft"], y["v_draft"],
                              y["pos"], y["plen"], y["tree"])
    x = _inputs(cuda, torch.float32)
    buf = torch.empty(x["k_cache"].numel() + 1, device=cuda)
    k_off = buf[1:].view(x["k_cache"].shape)      # contiguous, 4 bytes past 16
    k_off.copy_(x["k_cache"])
    with pytest.raises(ValueError, match="aligned"):
        vops.nsa_verify_fused(x["q"], k_off, x["v_cache"], x["k_cmp"], x["v_cmp"],
                              x["k_draft"], x["v_draft"], x["sel"], x["val"], x["pos"],
                              x["plen"], x["ncb_valid"], x["tree"], x["gates"], NSA)
    with pytest.raises(ValueError, match="aligned"):
        fops.flash_verify(x["q"], k_off, x["v_cache"], x["k_draft"], x["v_draft"],
                          x["pos"], x["plen"], x["tree"])
