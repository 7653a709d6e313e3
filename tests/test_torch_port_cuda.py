"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and skips without one. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: the kernels and the plain versions read the same bf16 values
and accumulate in f32 in another order, so rtol 1e-3 on the f32 outputs;
gradients that come back in the anchors' bf16 (ulp 2^-8) are held to
rtol 1e-2.
"""

import pytest
import torch

from arco_torch.kernels import infonce, launch_counts, pool_sims
from arco_torch.losses import contrastive
from arco_torch.ops import sampling

torch.set_num_threads(1)

K, Q, N, C, CAP, T = 3, 32, 64, 496, 1000, 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _normalized(shape, gen, device):
    x = torch.randn(shape, generator=gen, device=device)
    return torch.nn.functional.normalize(x, dim=-1).to(torch.bfloat16)


def _infonce_inputs(device, func="uniform", q=Q, n=N):
    """Normalized anchors, prototypes and bank; neg_idx drawn as the
    contrastive loss draws it: neg_idx[k, i, j] = rank[k, j * q + i]."""
    gen = torch.Generator(device=device).manual_seed(0)
    a_n = _normalized((K, q, C), gen, device)
    p_n = _normalized((K, C), gen, device)
    bank = _normalized((K, CAP, C), gen, device)
    ranks = sampling.draw_indices(torch.full((K,), CAP, device=device),
                                  q * n, func=func, generator=gen,
                                  device=device)
    idx = ranks.reshape(K, n, q).transpose(1, 2).to(torch.int32).contiguous()
    return a_n, p_n, bank, idx


def _pair_against_plain(a_n, bank, idx):
    invtot = torch.rand(a_n.shape[:2], device=a_n.device)
    before = launch_counts()
    denom, e = infonce.infonce_fwd(a_n, bank, idx, 1 / T)
    ga = infonce.infonce_bwd(e, bank, idx, invtot)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["infonce_fwd"] == before["infonce_fwd"] + 1
    assert after["infonce_bwd"] == before["infonce_bwd"] + 1
    denom_ref, e_ref = infonce.infonce_denom_plain(a_n, bank, idx, 1 / T)
    torch.testing.assert_close(denom, denom_ref, rtol=1e-3, atol=0)
    torch.testing.assert_close(e, e_ref, rtol=1e-3, atol=0)
    want = infonce.infonce_grad_plain(e_ref, bank, idx, invtot)
    torch.testing.assert_close(ga, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())
    return denom, e, ga, invtot


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["uniform", "smc", "asmc"])
def test_infonce_pair_matches_plain(cuda, func):
    """Q = 40 and N = 61: ragged against the 16-query groups and the 4
    chunks of samples."""
    a_n, _, bank, idx = _infonce_inputs(cuda, func, q=40, n=61)
    _pair_against_plain(a_n, bank, idx)


@pytest.mark.cuda
def test_infonce_pair_duplicate_rows(cuda):
    """Every query of a group draws the same row at each n: one staged copy
    serves all of them, and a row drawn twice adds twice."""
    a_n, _, bank, _ = _infonce_inputs(cuda, q=40, n=61)
    idx = (torch.arange(61, device=cuda) * 7 % 23).to(torch.int32)
    idx = idx.expand(K, 40, 61).contiguous()
    _pair_against_plain(a_n, bank, idx)


@pytest.mark.cuda
def test_infonce_pair_is_bit_identical(cuda):
    """The S partials are summed in a fixed order: two launches agree bit
    for bit."""
    a_n, _, bank, idx = _infonce_inputs(cuda, "smc")
    denom, e, ga, invtot = _pair_against_plain(a_n, bank, idx)
    denom2, e2 = infonce.infonce_fwd(a_n, bank, idx, 1 / T)
    ga2 = infonce.infonce_bwd(e2, bank, idx, invtot)
    assert torch.equal(denom, denom2) and torch.equal(e, e2) \
        and torch.equal(ga, ga2)


@pytest.mark.cuda
def test_fused_infonce_autograd_matches_plain(cuda):
    a_n, p_n, bank, idx = _infonce_inputs(cuda)

    def run(fn):
        a = a_n.clone().requires_grad_()
        p = p_n.clone().requires_grad_()
        loss = fn(a, p, bank, idx, T, bank_normalized=True)
        (loss * torch.arange(1.0, K + 1, device=cuda)).sum().backward()
        return loss.detach().float(), a.grad.float(), p.grad.float()

    got = run(infonce.fused_sampled_infonce)
    want = run(contrastive.sampled_infonce)
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-2,
                                   atol=1e-2 * w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(1, 5), (4, 36), (8, 3)])
def test_pool_sims_matches_plain(cuda, b, k):
    """F not a multiple of the kernel's 4096-element chunk."""
    f = 3 * 4096 + 8
    gen = torch.Generator(device=cuda).manual_seed(b)
    q = torch.randn((b, f), generator=gen, device=cuda).to(torch.bfloat16)
    p = torch.randn((k, f), generator=gen, device=cuda).to(torch.bfloat16)
    got = pool_sims.pool_similarities(q, p)
    torch.cuda.synchronize()
    want = pool_sims.pool_similarities_plain(q, p)
    torch.testing.assert_close(got, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = torch.randn(1, 2, 16, device=cuda)            # f32, not bf16
    with pytest.raises(ValueError):
        infonce.infonce_fwd(a, a.to(torch.bfloat16),
                            torch.zeros(1, 2, 3, dtype=torch.int32,
                                        device=cuda), 2.0)
    q = torch.randn(9, 64, device=cuda).to(torch.bfloat16)   # B > 8
    with pytest.raises(ValueError):
        pool_sims.pool_similarities(q, q)
    # a contiguous bank view 2 bytes into its storage: the kernel's 16-byte
    # row loads would be misaligned
    bank = torch.zeros(1 + 4 * 16, dtype=torch.bfloat16,
                       device=cuda)[1:].view(1, 4, 16)
    a_n = torch.zeros(1, 2, 16, dtype=torch.bfloat16, device=cuda)
    assert bank.is_contiguous() and bank.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        infonce.infonce_fwd(a_n, bank,
                            torch.zeros(1, 2, 3, dtype=torch.int32,
                                        device=cuda), 2.0)
