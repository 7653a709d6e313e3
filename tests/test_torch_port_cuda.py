"""The port on the card: the CUDA kernels against their plain PyTorch
versions (also at the 3D path's shapes), the GPU slice and volume banks
against the host pipeline, the strong augmentations against the CPU, a
small pretrain step against the CPU, the stage-2 step with ``remat``
against the step without it, the 3D pretrain's pooled patch grid and
the 3-D U-Nets' forwards against the CPU, and the serving surface: an
export round trip on the card, a one-rank NCCL sharded forward and
``Segmenter`` on the card against the CPU.

Every test here needs a CUDA GPU and skips without one. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: the kernels and the plain versions read the same bf16 values
and accumulate in f32 in another order, so rtol 1e-3 on the f32 outputs;
the f32 routes (f32 anchors and bank, f32 queries against a bf16 or f32
pool) sum exact f32 products in another order than the plain versions run
with TF32 off, so rtol 1e-5 (and atol 1e-5 of the largest |value| for ga
and the sims);
gradients that come back in the anchors' bf16 (ulp 2^-8) are held to
rtol 1e-2. Batches from the bank are compared exactly. The pretrain step
in bf16 autocast is held to the f32 CPU step at rtol 5e-2 / atol 2e-2 per
loss term (chip_smoke.py's phase 4 tolerance); ``remat`` on the card, where
cuDNN may pick other algorithms for the recompute, at 1e-3 relative on the
loss terms and the BatchNorm running statistics. The photometric
augmentation is held at atol 1e-5 (f32 on both devices, TF32 off);
AdvMorph grids at atol 1e-4 and smooth warped images at 2e-4, the bounds
of test_torch_port_augment.py (8 self-compositions double the f32
rounding 8 times).
"""

import numpy as np
import pytest
import torch

from arco_torch.augment import morph, photometric
from arco_torch.config import ArcoConfig, ISDConfig
from arco_torch.data import datasets, device_bank, pipeline, synthetic
from arco_torch.kernels import infonce, launch_counts, pool_sims
from arco_torch.losses import contrastive
from arco_torch.models import net_factory
from arco_torch.ops import sampling
from arco_torch.train import arco2d, pretrain

torch.set_num_threads(1)

K, Q, N, C, CAP, T = 3, 32, 64, 496, 1000, 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _normalized(shape, gen, device):
    x = torch.randn(shape, generator=gen, device=device)
    return torch.nn.functional.normalize(x, dim=-1).to(torch.bfloat16)


def _infonce_inputs(device, func="uniform", q=Q, n=N, k=K, c=C, cap=CAP):
    """Normalized anchors, prototypes and bank; neg_idx drawn as the
    contrastive loss draws it: neg_idx[k, i, j] = rank[k, j * q + i]."""
    gen = torch.Generator(device=device).manual_seed(0)
    a_n = _normalized((k, q, c), gen, device)
    p_n = _normalized((k, c), gen, device)
    bank = _normalized((k, cap, c), gen, device)
    ranks = sampling.draw_indices(torch.full((k,), cap, device=device),
                                  q * n, func=func, generator=gen,
                                  device=device)
    idx = ranks.reshape(k, n, q).transpose(1, 2).to(torch.int32).contiguous()
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
@pytest.mark.parametrize("func", ["uniform", "smc"])
def test_infonce_pair_at_the_3d_shapes(cuda, func):
    """The 3D path's pair: 2 classes, 256 anchors x 512 negatives of
    16-channel rows, banks of 50000 / 30000 normalized rows."""
    k, q, n, c, caps = 2, 256, 512, 16, (50000, 30000)
    gen = torch.Generator(device=cuda).manual_seed(1)
    a_n = _normalized((k, q, c), gen, cuda)
    bank = _normalized((k, max(caps), c), gen, cuda)
    ranks = sampling.draw_indices(torch.tensor(caps, device=cuda), q * n,
                                  func=func, generator=gen, device=cuda)
    idx = ranks.reshape(k, n, q).transpose(1, 2).to(torch.int32).contiguous()
    invtot = torch.rand((k, q), device=cuda)
    denom, e = infonce.infonce_fwd(a_n, bank, idx, 1 / T)
    ga = infonce.infonce_bwd(e, bank, idx, invtot)
    torch.cuda.synchronize()
    denom_ref, e_ref = infonce.infonce_denom_plain(a_n, bank, idx, 1 / T)
    torch.testing.assert_close(denom, denom_ref, rtol=1e-3, atol=0)
    torch.testing.assert_close(e, e_ref, rtol=1e-3, atol=0)
    want = infonce.infonce_grad_plain(e_ref, bank, idx, invtot)
    torch.testing.assert_close(ga, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


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
@pytest.mark.parametrize("k", [1, 2, 21])
@pytest.mark.parametrize("c", [8, 16, 24, 256, 496, 512])
def test_infonce_pair_at_each_width_and_class_count(cuda, c, k):
    """'smc' draws at Q = 40 and N = 61 (ragged against the 16-query groups
    and the sample chunks): C = 8 and 24 pad the last k-step, C = 16 is
    one k-step, 512 the widest; one class and two split the samples into
    more chunks than 21 classes."""
    a_n, _, bank, idx = _infonce_inputs(cuda, "smc", 40, 61, k=k, c=c)
    _pair_against_plain(a_n, bank, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["uniform", "asmc"])
@pytest.mark.parametrize("c", [16, 24, 256])
def test_infonce_pair_at_other_draws_and_widths(cuda, c, func):
    a_n, _, bank, idx = _infonce_inputs(cuda, func, 40, 61, k=2, c=c)
    _pair_against_plain(a_n, bank, idx)


def _staged_heads_idx(k, q, n, c, heads, cap, seed=0):
    """neg_idx [k, q, n] whose every block stages ``heads`` rows (as many
    as its queries and samples allow, at least one a sample): at each
    sample the group's queries fall into runs of one fresh row each."""
    from arco_torch.kernels import build
    lib = build.load_library()
    g = lib.arco_infonce_group()
    chunk = -(-n // lib.arco_infonce_splits(k, q, n, c))
    rows = np.random.RandomState(seed).permutation(cap)
    idx = np.empty((k, q, n), np.int32)
    fresh = 0
    for kk in range(k):
        for q0 in range(0, q, g):
            gq = min(g, q - q0)
            for n0 in range(0, n, chunk):
                nn = min(chunk, n - n0)
                extra = min(heads, gq * nn) - nn
                for nl in range(nn):
                    runs = 1 + min(gq - 1, max(extra, 0))
                    extra -= runs - 1
                    cuts = np.linspace(0, gq, runs + 1).astype(int)
                    for a, b in zip(cuts[:-1], cuts[1:]):
                        idx[kk, q0 + a:q0 + b, n0 + nl] = rows[fresh % cap]
                        fresh += 1
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("off", [-1, 1], ids=["short", "over"])
@pytest.mark.parametrize("fwd", [1, 0], ids=["fwd", "bwd"])
@pytest.mark.parametrize("c,n", [(16, 1100), (24, 1100), (256, 61),
                                 (496, 61)])
def test_infonce_pair_at_a_stage_edge(cuda, c, n, fwd, off):
    """Every block stages one row fewer than a stage of the forward (or the
    backward) kernel holds (its one stage short of full) or one more (a
    second stage of a single row), at widths whose stages hold hundreds of
    rows (C 16, 24) and tens (C 256, 496)."""
    from arco_torch.kernels import build
    k, q = 2, 40
    rows = build.load_library().arco_infonce_rows(k, q, n, c, fwd, 0)
    a_n, _, bank, _ = _infonce_inputs(cuda, "smc", q, n, k=k, c=c)
    idx = torch.from_numpy(
        _staged_heads_idx(k, q, n, c, rows + off, CAP)).to(cuda)
    _pair_against_plain(a_n, bank, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 496])
def test_infonce_pair_query_draws_a_row_at_several_n(cuda, c):
    """Each query draws its own row at every third n: the weights of one
    bank row add over the samples (and no two neighbouring queries share a
    row, so every pair is a run head)."""
    a_n, _, bank, _ = _infonce_inputs(cuda, "smc", 40, 61, k=2, c=c)
    q = torch.arange(40, device=cuda)[:, None]
    n = torch.arange(61, device=cuda)[None, :]
    idx = ((q * 7 + n % 3) % CAP).to(torch.int32).expand(2, 40, 61)
    _pair_against_plain(a_n, bank, idx.contiguous())


@pytest.mark.cuda
def test_infonce_pair_is_bit_identical_at_the_natural_shape(cuda):
    """21 classes of 256 anchors x 512 'smc' negatives of 256-channel rows
    over full 30000-row banks: against the plain pair, and two launches
    agree bit for bit."""
    a_n, _, bank, idx = _infonce_inputs(cuda, "smc", 256, 512, k=21, c=256,
                                        cap=30000)
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
@pytest.mark.parametrize("f", [3 * 4096 + 8, 296])
@pytest.mark.parametrize("k", [1, 16, 36, 37, 48, 49])
@pytest.mark.parametrize("b", [1, 4, 8, 9, 16, 17])
def test_pool_sims_matches_plain(cuda, b, k, f):
    """The kernel's edges: one n8 tile of query rows (1-8), two (9-16), a
    second group of 16 (17); pool rows inside one m16 tile, across tiles,
    a full 48-row group and a second group (49); F not a multiple of the
    32-feature step, and F = 296, whose 10 steps give fewer warps than the
    card has SMs."""
    gen = torch.Generator(device=cuda).manual_seed(100 * b + k)
    q = torch.randn((b, f), generator=gen, device=cuda).to(torch.bfloat16)
    p = torch.randn((k, f), generator=gen, device=cuda).to(torch.bfloat16)
    got = pool_sims.pool_similarities(q, p)
    torch.cuda.synchronize()
    want = pool_sims.pool_similarities_plain(q, p)
    torch.testing.assert_close(got, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,f", [(4, 496 * 64 * 64), (8, 41 * 41 * 256),
                                 (16, 496 * 64 * 64)])
def test_pool_sims_is_bit_identical_from_launch_to_launch(cuda, b, f):
    """The revisiting loss takes top-k of these sims: two launches on the
    same inputs give the same bits (fixed-order sums, no float atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(b)
    q = torch.randn((b, f), generator=gen, device=cuda).to(torch.bfloat16)
    p = torch.randn((36, f), generator=gen, device=cuda).to(torch.bfloat16)
    first = pool_sims.pool_similarities(q, p)
    assert torch.equal(first, pool_sims.pool_similarities(q, p))


@pytest.mark.cuda
def test_pool_sims_at_the_3d_shape(cuda):
    """The 3D path's revisiting loss: 2 x 2 reps of 16 x 112 x 112 x 80
    features against 36 pool rows."""
    f = 16 * 112 * 112 * 80
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = _normalized((36, f), gen, cuda)
    # each query near one pool row, so the sims span [0, ~0.7]
    q = torch.randn((4, f), generator=gen, device=cuda) / f ** 0.5 \
        + 0.7 * torch.arange(1, 5, device=cuda)[:, None] / 4 * p[:4].float()
    q = torch.nn.functional.normalize(q, dim=-1).to(torch.bfloat16)
    got = pool_sims.pool_similarities(q, p)
    torch.cuda.synchronize()
    want = pool_sims.pool_similarities_plain(q, p)
    torch.testing.assert_close(got, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 1])
def test_pool_sims_at_a_ranks_share_of_the_2d_step(cuda, b):
    """The data-parallel 2D step's revisiting loss: a rank's 2 * b_u rows
    (b_u = 1 at a global 2 + 2 over 2 ranks; 1 row where a rank holds one
    query) of 496 x 256 x 256 features against 36 pool rows."""
    f = 496 * 256 * 256
    gen = torch.Generator(device=cuda).manual_seed(20 + b)
    p = _normalized((36, f), gen, cuda)
    q = torch.randn((b, f), generator=gen, device=cuda) / f ** 0.5 \
        + 0.7 * torch.arange(1, b + 1, device=cuda)[:, None] / b \
        * p[:b].float()
    q = torch.nn.functional.normalize(q, dim=-1).to(torch.bfloat16)
    got = pool_sims.pool_similarities(q, p)
    torch.cuda.synchronize()
    want = pool_sims.pool_similarities_plain(q, p)
    torch.testing.assert_close(got, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())
    assert torch.equal(got, pool_sims.pool_similarities(q, p))


F32_TOL = dict(rtol=1e-5, atol=0.0)
CAPS_2D, CAPS_3D = (50000, 30000, 30000, 30000), (50000, 30000)


@pytest.fixture
def no_tf32(cuda):
    """The plain versions' f32 products in f32 (no TF32), as the f32 routes
    compute them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _f32_inputs(device, func="smc", q=Q, n=N, k=K, c=C, caps=None, seed=0):
    """f32 normalized anchors and bank over classes of capacities ``caps``
    (CAP each by default); neg_idx as _infonce_inputs draws it."""
    caps = caps or (CAP,) * k
    gen = torch.Generator(device=device).manual_seed(seed)
    norm = lambda shape: torch.nn.functional.normalize(
        torch.randn(shape, generator=gen, device=device), dim=-1)
    a_n, bank = norm((k, q, c)), norm((k, max(caps), c))
    ranks = sampling.draw_indices(torch.tensor(caps, device=device), q * n,
                                  func=func, generator=gen, device=device)
    idx = ranks.reshape(k, n, q).transpose(1, 2).to(torch.int32).contiguous()
    return a_n, bank, idx


def _f32_pair_against_plain(a_n, bank, idx):
    """The f32 pair against its plain versions at F32_TOL, each call one
    launch of its f32 route and none of the bf16 route."""
    invtot = torch.rand(a_n.shape[:2], device=a_n.device)
    before = launch_counts()
    denom, e = infonce.infonce_fwd(a_n, bank, idx, 1 / T)
    ga = infonce.infonce_bwd(e, bank, idx, invtot)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **{k: 0 for k in after}, "infonce_fwd_f32": 1, "infonce_bwd_f32": 1}
    denom_ref, e_ref = infonce.infonce_denom_plain(a_n, bank, idx, 1 / T)
    torch.testing.assert_close(denom, denom_ref, **F32_TOL)
    torch.testing.assert_close(e, e_ref, **F32_TOL)
    want = infonce.infonce_grad_plain(e_ref, bank, idx, invtot)
    torch.testing.assert_close(ga, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    return denom, e, ga, invtot


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["uniform", "smc", "asmc"])
def test_infonce_f32_pair_matches_plain(no_tf32, func):
    """Q = 40 and N = 61: ragged against the 16-query groups and the
    chunks of samples."""
    _f32_pair_against_plain(*_f32_inputs(no_tf32, func, q=40, n=61))


@pytest.mark.cuda
@pytest.mark.parametrize("c,caps", [(496, CAPS_2D), (16, CAPS_3D)],
                         ids=["2d", "3d"])
def test_infonce_f32_pair_at_the_main_paths_shapes(no_tf32, c, caps):
    """The f32 step's pair: 256 anchors x 512 'smc' negatives over full
    banks, 4 classes of 496 channels (2D) or 2 of 16 (3D); two launches
    agree bit for bit."""
    a_n, bank, idx = _f32_inputs(no_tf32, "smc", 256, 512, len(caps), c,
                                 caps)
    denom, e, ga, invtot = _f32_pair_against_plain(a_n, bank, idx)
    denom2, e2 = infonce.infonce_fwd(a_n, bank, idx, 1 / T)
    ga2 = infonce.infonce_bwd(e2, bank, idx, invtot)
    assert torch.equal(denom, denom2) and torch.equal(e, e2) \
        and torch.equal(ga, ga2)


@pytest.mark.cuda
def test_infonce_f32_pair_duplicate_rows(no_tf32):
    """Every query of a group draws the same row at each n: one staged copy
    serves all of them, and a row drawn twice adds twice."""
    a_n, bank, _ = _f32_inputs(no_tf32, q=40, n=61)
    idx = (torch.arange(61, device=no_tf32) * 7 % 23).to(torch.int32)
    _f32_pair_against_plain(a_n, bank, idx.expand(K, 40, 61).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 16, 24, 64, 256, 496, 512])
def test_infonce_f32_pair_at_each_width(no_tf32, c):
    """'smc' draws at Q = 40, N = 61 over 2 classes: C 8, 16 and 24 give
    2, 4 and 8 lanes a pair and several sample slices (C 24: threads past
    G * C / 4 idle in the backward), 64 and up 16 lanes and one slice, 512
    the widest."""
    _f32_pair_against_plain(*_f32_inputs(no_tf32, "smc", 40, 61, k=2, c=c))


@pytest.mark.cuda
@pytest.mark.parametrize("off", [-1, 1], ids=["short", "over"])
@pytest.mark.parametrize("fwd", [1, 0], ids=["fwd", "bwd"])
@pytest.mark.parametrize("c,n", [(16, 1100), (24, 1100), (256, 61),
                                 (496, 61)])
def test_infonce_f32_pair_at_a_stage_edge(no_tf32, c, n, fwd, off):
    """Every block stages one row fewer than a stage of the f32 route's
    forward (or backward) holds, or one more (a second stage of a single
    row), from arco_infonce_rows' f32 layout."""
    from arco_torch.kernels import build
    k, q = 2, 40
    rows = build.load_library().arco_infonce_rows(k, q, n, c, fwd, 1)
    a_n, bank, _ = _f32_inputs(no_tf32, "smc", q, n, k=k, c=c)
    idx = torch.from_numpy(
        _staged_heads_idx(k, q, n, c, rows + off, CAP)).to(no_tf32)
    _f32_pair_against_plain(a_n, bank, idx)


@pytest.mark.cuda
def test_fused_infonce_f32_autograd_matches_plain(no_tf32):
    """f32 anchors and bank: the loss and the gradients of the fused pair
    against autograd through the plain sampled_infonce."""
    a_n, bank, idx = _f32_inputs(no_tf32)
    gen = torch.Generator(device=no_tf32).manual_seed(3)
    p_n = torch.nn.functional.normalize(
        torch.randn((K, C), generator=gen, device=no_tf32), dim=-1)

    def run(fn):
        a = a_n.clone().requires_grad_()
        p = p_n.clone().requires_grad_()
        loss = fn(a, p, bank, idx, T, bank_normalized=True)
        (loss * torch.arange(1.0, K + 1, device=no_tf32)).sum().backward()
        return loss.detach(), a.grad, p.grad

    before = launch_counts()["infonce_fwd_f32"]
    got = run(infonce.fused_sampled_infonce)
    assert launch_counts()["infonce_fwd_f32"] == before + 1
    want = run(contrastive.sampled_infonce)
    torch.testing.assert_close(got[0], want[0], **F32_TOL)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item())


def _f32_sims_against_plain(q, p):
    before = launch_counts()
    got = pool_sims.pool_similarities(q, p)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **{k: 0 for k in after}, "pool_sims_f32": 1}
    want = pool_sims.pool_similarities_plain(q, p)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_pool", "f32_pool"])
@pytest.mark.parametrize("f", [3 * 4096 + 8, 296])
@pytest.mark.parametrize("k", [1, 36, 49])
@pytest.mark.parametrize("b", [1, 4, 5, 9, 17])
def test_pool_sims_f32_matches_plain(no_tf32, b, k, f, pool_dtype):
    """f32 queries: one group of 4 (1, 4) or 8 (5) query rows, several
    (9, 17); pool rows in one warp's share, a full 36 and a second 48-row
    group (49); F not a multiple of the 256-feature step, and F = 296."""
    gen = torch.Generator(device=no_tf32).manual_seed(100 * b + k)
    q = torch.randn((b, f), generator=gen, device=no_tf32)
    p = torch.randn((k, f), generator=gen, device=no_tf32).to(pool_dtype)
    _f32_sims_against_plain(q, p)


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_pool", "f32_pool"])
@pytest.mark.parametrize("f", [496 * 256 * 256, 16 * 112 * 112 * 80],
                         ids=["2d", "3d"])
def test_pool_sims_f32_at_the_main_paths_shapes(no_tf32, f, pool_dtype):
    """The f32 step's revisiting loss: 2 x 2 f32 reps against 36 pool rows
    of the 2D or 3D width, each query near one pool row (sims in [0,
    ~0.7]); two launches agree bit for bit."""
    gen = torch.Generator(device=no_tf32).manual_seed(6)
    p = torch.nn.functional.normalize(
        torch.randn((36, f), generator=gen, device=no_tf32),
        dim=-1).to(pool_dtype)
    q = torch.randn((4, f), generator=gen, device=no_tf32) / f ** 0.5 \
        + 0.7 * torch.arange(1, 5, device=no_tf32)[:, None] / 4 \
        * p[:4].float()
    q = torch.nn.functional.normalize(q, dim=-1)
    got = _f32_sims_against_plain(q, p)
    assert torch.equal(got, pool_sims.pool_similarities(q, p))


@pytest.mark.cuda
def test_f32_routes_refuse_mixed_dtypes(cuda):
    """f32 anchors need an f32 bank, bf16 queries a bf16 pool; f64 takes
    no route."""
    idx = torch.zeros(1, 2, 3, dtype=torch.int32, device=cuda)
    a = torch.randn(1, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        infonce.infonce_fwd(a.to(torch.bfloat16), a.new_zeros(1, 4, 16),
                            idx, 2.0)
    with pytest.raises(ValueError):
        infonce.infonce_fwd(a.double(), a.new_zeros(1, 4, 16).double(),
                            idx, 2.0)
    q = torch.randn(2, 64, device=cuda)
    with pytest.raises(ValueError):
        pool_sims.pool_similarities(q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        pool_sims.pool_similarities(q.double(), q.double())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = torch.randn(1, 2, 16, device=cuda)            # f32, not bf16
    with pytest.raises(ValueError):
        infonce.infonce_fwd(a, a.to(torch.bfloat16),
                            torch.zeros(1, 2, 3, dtype=torch.int32,
                                        device=cuda), 2.0)
    q = torch.randn(2, 60, device=cuda).to(torch.bfloat16)   # F % 8
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


@pytest.mark.cuda
def test_device_slice_bank_matches_the_host_pipeline(cuda, tmp_path):
    """Synapse npz slices zoomed 40 -> 32: the first 3 GPU batches equal
    the host pipeline's single-worker stream bit for bit."""
    root = synthetic.make_synapse_like(str(tmp_path), n_train=12,
                                       size=(40, 40), num_classes=4)
    ds = [datasets.SynapseDataset(root, root, "train", index=4,
                                  label_type=t, output_size=(32, 32))
          for t in (1, 0)]
    host = pipeline.TwoStreamPipeline(ds[0], ds[1], 3, seed=4, labeled_bs=1)
    gen = device_bank.two_stream_device_batches(
        *(device_bank.DeviceSliceBank.from_dataset(d, cuda) for d in ds),
        1, 2, seed=4)
    try:
        for _ in range(3):
            want, got = next(host), next(gen)
            for k in ("image_l", "image_u"):
                assert got[k].device.type == cuda.type
                np.testing.assert_array_equal(
                    got[k].permute(0, 2, 3, 1).cpu().numpy(), want[k])
            np.testing.assert_array_equal(got["label_l"].cpu().numpy(),
                                          want["label_l"])
    finally:
        host.close()


@pytest.mark.cuda
def test_device_volume_bank_on_the_card_matches_the_host_path(cuda):
    """LA-like volumes of 40x40x24 (in memory: the card has no h5py) and
    32x32x16 patches: the card's gathers equal the CPU bank's and the host
    transforms', with the same RandomState consumption."""
    rs = np.random.RandomState(0)
    ds = datasets.InMemoryVolumes(
        [synthetic.la_volume(rs, (40, 40, 24)) for _ in range(3)],
        (32, 32, 16))
    on_card = device_bank.DeviceVolumeBank.from_dataset(ds, ds.patch_size,
                                                        cuda)
    on_cpu = device_bank.DeviceVolumeBank.from_dataset(ds, ds.patch_size,
                                                       "cpu")
    rng, host_rng = np.random.RandomState(4), np.random.RandomState(4)
    params = on_card.draw_params(rng, [0, 2, 1, 2, 0])
    img, lab = on_card.gather(params)
    assert img.device.type == cuda.type
    want_img, want_lab = on_cpu.gather(params)
    assert torch.equal(img.cpu(), want_img) and torch.equal(lab.cpu(),
                                                            want_lab)
    host = [ds.get(i, host_rng) for i in (0, 2, 1, 2, 0)]
    np.testing.assert_array_equal(lab.cpu().numpy(),
                                  np.stack([s["label"] for s in host]))
    assert rng.randint(1 << 30) == host_rng.randint(1 << 30)


@pytest.mark.cuda
def test_photometric_on_the_card_matches_the_cpu(cuda):
    torch.backends.cudnn.allow_tf32 = False
    for c in (1, 3):
        x = torch.rand((6, c, 64, 64), generator=torch.Generator()
                       .manual_seed(c))
        draws = photometric.draw_photometric(6, torch.Generator()
                                             .manual_seed(7))
        want = photometric.batch_photometric(x, draws)
        got = photometric.batch_photometric(
            x.to(cuda), {k: v.to(cuda) for k, v in draws.items()})
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("coarse_exp", [True, False])
def test_adv_morph_on_the_card_matches_the_cpu(cuda, coarse_exp):
    b, hw = 2, 64
    t = torch.linspace(-1.0, 1.0, hw)
    x = 0.5 + 0.5 * torch.sin(0.5 * torch.pi * (t[:, None] + 0.5 * t[None])
                              + torch.arange(b)[:, None, None, None])
    draws = morph.draw_morph(b, (hw // 8, hw // 8),
                             torch.Generator().manual_seed(3))
    draws["p"] = torch.tensor(0.9)
    m = morph.AdvMorph((b, 1, hw, hw), (hw // 8, hw // 8),
                       coarse_exp=coarse_exp)
    want = m.deformation_grid(m.init_params(draws["velocity"]))
    got = m.deformation_grid(m.init_params(draws["velocity"].to(cuda)))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    want = morph.adv_morph_batch(x, coarse_exp=coarse_exp, draws=draws)
    got = morph.adv_morph_batch(x.to(cuda), coarse_exp=coarse_exp,
                                draws={k: v.to(cuda)
                                       for k, v in draws.items()})
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-4)
    assert (want - x).abs().max() > 1e-2


def _pretrain_step_on(device, dtype, hw=64, nc=4):
    """One small pretrain step (dropout-free U-Net, seeded weights and
    batch); the queues come from the CPU generator on both devices."""
    cfg = ISDConfig(K=4, latent_feature_size=64, output_pooling_size=4,
                    patch_size=32)
    torch.manual_seed(1)
    mods = pretrain.make_isd_modules(
        net_factory("unet", class_num=nc, dropout=(0.0,) * 5), nc,
        latent_feature_size=64, output_pooling_size=4)
    state = pretrain.init_pretrain_state(mods, cfg, (2, 1, hw, hw), seed=1,
                                         device=device, compute_dtype=dtype)
    cpu_state = pretrain.init_pretrain_state(
        pretrain.make_isd_modules(net_factory("unet", class_num=nc,
                                              dropout=(0.0,) * 5), nc,
                                  latent_feature_size=64,
                                  output_pooling_size=4),
        cfg, (2, 1, hw, hw), seed=1, device="cpu")
    state.queue.copy_(cpu_state.queue)
    state.queue_mask.copy_(cpu_state.queue_mask)
    step = pretrain.make_pretrain_step(cfg, 1, nc, 100, device=device)
    gen = torch.Generator().manual_seed(2)
    label = (torch.rand((2, hw, hw), generator=gen) * nc).to(torch.int32)
    image = label[:, None].float() / (nc - 1) \
        + 0.1 * torch.randn((2, 1, hw, hw), generator=gen)
    return step(state, {"student_image": image, "teacher_image": image,
                        "label": label})


@pytest.mark.cuda
def test_pretrain_step_on_the_card_matches_the_cpu(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    want = _pretrain_step_on("cpu", torch.float32)
    got = _pretrain_step_on(cuda, torch.bfloat16)
    for k, w in want.items():
        g = float(got[k])
        assert abs(g - float(w)) <= 2e-2 + 5e-2 * abs(float(w)), k


def _stage2_step_on_card(cuda, remat):
    cfg = ArcoConfig(K=4, num_queries=32, num_negatives=64,
                     memobank_size=256, memobank_size_bg=512,
                     memobank_enqueue=64, topk=2, remat=remat)
    torch.manual_seed(1)
    mods = arco2d.make_arco_modules(net_factory("unet", class_num=4), 64, 64,
                                    batch_size=2)
    state = arco2d.init_arco_state(mods, cfg, (2, 1, 64, 64), seed=1,
                                   device=cuda)
    step = arco2d.make_arco_step(mods, cfg, num_classes=4,
                                 max_iterations=100, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    label = (torch.rand((2, 64, 64), generator=gen, device=cuda) * 4).to(
        torch.int32)
    batch = {"image_l": label[:, None].float() / 3, "label_l": label,
             "image_u": torch.rand((2, 1, 64, 64), generator=gen,
                                   device=cuda)}
    return state, step(state, batch)


@pytest.mark.cuda
def test_remat_on_the_card_matches_remat_off(cuda):
    (a, ma), (b, mb) = (_stage2_step_on_card(cuda, r) for r in (False, True))
    for k in ma:
        if ma[k].ndim == 0:
            torch.testing.assert_close(mb[k], ma[k], rtol=1e-3, atol=1e-6)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        if "running" in k:
            torch.testing.assert_close(sb[k], sa[k], rtol=1e-3, atol=1e-6)
        elif "num_batches" in k:
            assert torch.equal(sb[k], sa[k])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_3d_pooled_patch_grid_on_the_card_matches_the_cpu(cuda, dtype):
    """The 3-D pretrain's pooled patch grid (700 patches of 20^3 pooled to
    8^3 over [2, 112, 112, 80, 2] logits), values and gradients: f32
    prefix sums on both devices, so atol 1e-5 in f32; in bf16 each pass
    rounds its means once to bf16 (ulp 2^-8 at 1-2), so atol 2e-2."""
    from arco_torch.ops.patches import pooled_patch_grid
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 112, 112, 80, 2), generator=gen).to(dtype)
    w = torch.randn((2, 700, 8, 8, 8, 2), generator=gen)
    outs = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        y = pooled_patch_grid(xd, 20, 10, 8)
        (y.float() * w.to(dev)).sum().backward()
        outs.append((y.detach().float().cpu(), xd.grad.float().cpu()))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert outs[0][0].shape == (2, 700, 8, 8, 8, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unet_3D", "unet_3D_dv_semi",
                                  "attention_unet"])
def test_unet3d_forward_on_the_card_matches_the_cpu(cuda, name):
    """An eval-mode forward at 64x64x32, bs 2: f32 with TF32 off against
    the CPU at atol 1e-4 (cuDNN's and the CPU's convolutions sum in another
    order; the InstanceNorms of the small maps amplify it, as in the CPU
    tests against JAX); and under bf16 autocast (8-bit mantissa through
    some 20 layers) within 1e-1 of the f32 logits in relative L2 norm
    (5.2e-2 for UNet3D and 5.8e-2 for UNet3DDVSemi measured on an
    H100)."""
    from arco_torch.models import net_factory_3d
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = net_factory_3d(name, in_chns=1, class_num=2).eval()
    x = torch.randn((2, 1, 64, 64, 32),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        model.to(cuda)
        got = model(x.to(cuda))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got_bf = model(x.to(cuda))
    # the logits, or the dv_semi model's finest supervision output
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    rel = (got_bf[0].float().cpu() - want[0]).norm() / want[0].norm()
    assert rel <= 1e-1, rel


ZOO = ("unet_stego", "unet_har", "unet_ds", "unet_cct", "unet_urpc", "pnet",
       "enet", "efficient_unet", "ViT_Seg", "swin_unet")


def _flat(out):
    flat = []
    for o in out:
        flat += _flat(o) if isinstance(o, (list, tuple)) else [o]
    return flat


@pytest.mark.cuda
@pytest.mark.parametrize("key", ZOO)
def test_zoo_forward_on_the_card_matches_the_cpu(cuda, key):
    """A seeded eval-mode forward of each 2D zoo model at 64x64, bs 2, f32
    with TF32 off, against the CPU: every output within atol 1e-4 + rtol
    1e-4 of its scale (chip_smoke.py's phase 10 bound). UNetCCT perturbs
    in eval mode too, so both sides take the same draws."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = net_factory(key, in_chns=1, class_num=4, img_size=64).eval()
    x = torch.randn((2, 1, 64, 64),
                    generator=torch.Generator().manual_seed(1))
    kw = {}
    if key == "unet_cct":
        gen = torch.Generator().manual_seed(2)
        shapes = [(2, c, 64 >> k, 64 >> k)
                  for k, c in enumerate((16, 32, 64, 128, 256))]
        kw["perturb"] = [
            [(torch.rand(s, generator=gen) * 2 - 1) * 0.3 for s in shapes],
            [torch.rand(s, generator=gen) < 0.7 for s in shapes],
            [0.7 + 0.2 * torch.rand((2,), generator=gen) for _ in shapes]]
    with torch.no_grad():
        want = _flat(model(x, **kw))
        model.to(cuda)
        kw = {"perturb": [[d.to(cuda) for d in k] for k in kw["perturb"]]} \
            if kw else {}
        got = _flat(model(x.to(cuda), **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 + 1e-4 * scale)


# ------------------------------------------------- the serving surface

def _seeded_unet():
    torch.manual_seed(0)
    return net_factory("unet", in_chns=1, class_num=4).eval()


@pytest.mark.cuda
def test_export_roundtrip_on_the_card(cuda, tmp_path):
    """A batch-dynamic argmax artifact traced on the card, saved and loaded
    with load_predictor, equals the eager model on the card at batch 1 and
    3; an artifact traced on the CPU and loaded onto the card
    (move_to_device_pass) equals it too."""
    from arco_torch.export import (export_predictor, load_predictor,
                                   make_predict_fn, save_predictor)
    torch.backends.cudnn.allow_tf32 = False
    model = _seeded_unet().to(cuda)
    eager = make_predict_fn(model)
    paths = {}
    for dev in ("cuda", "cpu"):
        paths[dev] = str(tmp_path / f"unet_{dev}.pt2")
        save_predictor(paths[dev], export_predictor(
            model, (1, 1, 64, 64), batch="dynamic", device=dev))
    on_card = load_predictor(paths["cuda"])
    moved = load_predictor(paths["cpu"], device="cuda")
    for b in (1, 3):
        x = torch.rand((b, 1, 64, 64), generator=torch.Generator()
                       .manual_seed(b)).to(cuda)
        want = eager(x)
        assert torch.equal(on_card(x), want)
        assert torch.equal(moved(x), want)


@pytest.mark.cuda
def test_sharded_forward_one_nccl_rank(cuda, tmp_path):
    """predict_volume_sharded over a one-rank NCCL process group against the
    unsharded whole-volume forward (tests/test_inference_sharded.py:24-41):
    the input's shape, int32, >= 97% agreement; in depth [24, 40) the
    scores within 1e-3 and the labels equal but where the unsharded
    forward's two scores lie within 2e-3 (chip_smoke.py phase 14f: the two
    forwards see inputs of other depths, for which cuDNN may pick other
    algorithms; there the scores differed by up to 7.66e-5 and one label
    in 1.8M flipped, at a margin of 2.3e-6)."""
    import torch.distributed as dist
    from arco_torch.inference import Segmenter3D
    from arco_torch.models import net_factory_3d
    from arco_torch.parallel import create_mesh
    from arco_torch.parallel.spatial import sharded_volume_forward
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    seg = Segmenter3D(net_factory_3d("vnet", in_chns=1, class_num=2),
                      device=cuda)
    vol = np.random.RandomState(0).randn(60, 32, 32).astype(np.float32)
    x = torch.from_numpy(np.pad(vol, ((0, 4), (0, 0), (0, 0))))[None, None]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh()
        pred = seg.predict_volume_sharded(vol, mesh=mesh)
        with torch.no_grad():
            got_p = sharded_volume_forward(seg._probs, mesh, halo=16,
                                           lattice=16)(x)
    finally:
        dist.destroy_process_group()
    with torch.no_grad():
        want_p = seg._probs(x)
    want = want_p.argmax(1)[0, :60].cpu().numpy()
    assert pred.shape == vol.shape and pred.dtype == np.int32
    assert (pred == want).mean() > 0.97
    torch.testing.assert_close(got_p[:, :, 24:40], want_p[:, :, 24:40],
                               atol=1e-3, rtol=0)
    margin = (want_p[0, 1] - want_p[0, 0]).abs()[24:40].cpu().numpy()
    flips = pred[24:40] != want[24:40]
    assert (margin[flips] <= 2e-3).all()


@pytest.mark.cuda
def test_segmenter_on_the_card_matches_the_cpu(cuda):
    """Segmenter.predict_volume on the card against the CPU (f32, TF32
    off): cuDNN's and the CPU's convolutions sum in other orders, so the
    labels are held to 99.9% agreement (a flip needs a near-tie of two
    logits)."""
    import copy
    from arco_torch.inference import Segmenter
    torch.backends.cudnn.allow_tf32 = False
    model = _seeded_unet()
    vol = np.random.RandomState(1).rand(4, 80, 72).astype(np.float32)
    want = Segmenter(copy.deepcopy(model), input_size=(64, 64),
                     device="cpu").predict_volume(vol)
    got = Segmenter(model, input_size=(64, 64),
                    device=cuda).predict_volume(vol)
    assert got.shape == vol.shape
    assert (got == want).mean() >= 0.999
