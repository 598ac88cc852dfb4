"""Card tests of the port's CUDA kernels (marker ``gpu``): each kernel
against its plain PyTorch version on the same CUDA tensors, with float32
and bfloat16 K/V (rtol=2e-4, atol=2e-5 for both), at small shapes, plus the
launch counters. Whether a card is present is decided in a fixture, so
every worker collects the same tests; without a card they skip. Run them on
the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``."""
import pytest
import torch

from repro_torch.config import NSAConfig
from repro_torch.kernels.nsa_verify import ops as vops
from repro_torch.kernels.routing import ops as rops, ref as rref
from repro_torch.models import nsa as nsa_lib

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


def _inputs(dev, dtype, T=7, Hq=8, Hkv=2, S=256, prefix=180, seed=0):
    g = torch.Generator(dev)
    g.manual_seed(seed)
    r = lambda *s, dt=dtype: torch.randn(s, generator=g, device=dev).to(dt)
    ncb = nsa_lib.num_cmp_blocks(S, NSA)
    pos = (prefix + torch.minimum(torch.arange(T, device=dev), torch.tensor(3, device=dev)))
    pos = pos[None].to(torch.int32)
    p_slc = torch.rand((1, T, Hkv, nsa_lib.num_sel_blocks(S, NSA)), generator=g, device=dev)
    plen = torch.tensor([prefix], dtype=torch.int32, device=dev)
    sel, val = nsa_lib.select_topn(p_slc, pos, plen, NSA)
    return dict(q=r(1, T, Hq, 64, dt=torch.float32) / 8, k_cache=r(1, S, Hkv, 64),
                v_cache=r(1, S, Hkv, 64), k_cmp=r(1, ncb, Hkv, 64), v_cmp=r(1, ncb, Hkv, 64),
                k_draft=r(1, T, Hkv, 64), v_draft=r(1, T, Hkv, 64), sel=sel, val=val,
                pos=pos, plen=plen, ncb_valid=nsa_lib.dyn_num_cmp_blocks(plen, NSA),
                tree=torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None],
                gates=torch.sigmoid(r(1, T, 3, Hq, dt=torch.float32)),
                o_cmp=r(1, T, Hq, 64, dt=torch.float32))


def _close(a, b, dtype):
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routing_kernel_matches_plain(cuda, dtype):
    x = _inputs(cuda, dtype)
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
@pytest.mark.parametrize("C,mode,full", [(1, "exact", True), (2, "exact", False),
                                         (4, "approx", True), (2, "approx", False)])
def test_verify_kernel_matches_plain(cuda, dtype, C, mode, full):
    x = _inputs(cuda, dtype, seed=C)
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
def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = _inputs(cuda, torch.float32)
    with pytest.raises(TypeError):
        rops.launch(x["q"].half(), x["k_cmp"], x["v_cmp"], x["pos"], x["ncb_valid"], NSA, 16)
    with pytest.raises(ValueError):
        rops.launch(x["q"], x["k_cmp"][:, ::2], x["v_cmp"][:, ::2], x["pos"],
                    x["ncb_valid"], NSA, 16)
