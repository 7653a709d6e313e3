"""The port's three kernels (arco_torch/kernels) against the JAX package.

On the CPU each wrapper computes its plain PyTorch version; those plain
versions are held here against the Pallas kernels in interpret mode and the
XLA formulations the JAX trainer uses. The CUDA kernels themselves are held
against the plain versions by tests/test_torch_port_cuda.py and by
chip_smoke.py at the main path's shapes.

Tolerances: float32 throughout; rtol 1e-5 on losses and sims and atol 1e-6
on gradients, for summation-order differences between XLA:CPU and PyTorch
(the Pallas interpret path sums a dense counts-weighted stream, the port
sums the gathered rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.losses import consistency as jcons
from arco_tpu.losses import contrastive as jcontra
from arco_tpu.ops.pallas.infonce import pallas_sampled_infonce
from arco_tpu.ops.pallas.pool_sims import pool_similarities as jpool_sims

from arco_torch.kernels import infonce, launch_counts, pool_sims
from arco_torch.losses import consistency, contrastive

torch.set_num_threads(1)

K, Q, N, C, CAP, T = 3, 8, 16, 32, 96, 0.5


def _infonce_inputs(seed, normalized_bank):
    rs = np.random.RandomState(seed)
    anchor = rs.randn(K, Q, C).astype(np.float32)
    proto = rs.randn(K, C).astype(np.float32)
    bank = rs.randn(K, CAP, C).astype(np.float32)
    if normalized_bank:
        bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    idx = rs.randint(0, CAP, size=(K, Q, N)).astype(np.int32)
    weights = rs.rand(K).astype(np.float32)   # distinct per-class cotangents
    return anchor, proto, bank, idx, weights


def _jax_losses_and_grads(fn, anchor, proto, bank, idx, weights):
    def total(a, p):
        losses = jnp.stack([fn(a[k], p[k], jnp.asarray(bank[k]),
                               jnp.asarray(idx[k])) for k in range(K)])
        return jnp.sum(losses * weights), losses
    (_, losses), (ga, gp) = jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True)(jnp.asarray(anchor),
                                             jnp.asarray(proto))
    return np.asarray(losses), np.asarray(ga), np.asarray(gp)


def _torch_losses_and_grads(fn, anchor, proto, bank, idx, weights):
    a = torch.from_numpy(anchor).requires_grad_()
    p = torch.from_numpy(proto).requires_grad_()
    losses = fn(a, p, torch.from_numpy(bank), torch.from_numpy(idx))
    (losses * torch.from_numpy(weights)).sum().backward()
    return losses.detach().numpy(), a.grad.numpy(), p.grad.numpy()


def _assert_triplet(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("normalized_bank", [False, True])
def test_fused_infonce_matches_pallas_interpret(normalized_bank):
    """K1 + K2 (forward denominator and backward key sum) through the
    autograd Function against the Pallas kernel pair in interpret mode."""
    args = _infonce_inputs(0, normalized_bank)
    jfn = lambda a, p, b, i: pallas_sampled_infonce(
        a, p, b, i, temp=T, tile=32, interpret=True,
        bank_normalized=normalized_bank)
    tfn = lambda a, p, b, i: infonce.fused_sampled_infonce(
        a, p, b, i, T, bank_normalized=normalized_bank)
    _assert_triplet(_torch_losses_and_grads(tfn, *args),
                    _jax_losses_and_grads(jfn, *args))


def test_fused_infonce_matches_xla_sampled_infonce():
    args = _infonce_inputs(1, normalized_bank=False)
    jfn = lambda a, p, b, i: jcontra.sampled_infonce(a, p, b, i, T)
    tfn = lambda a, p, b, i: infonce.fused_sampled_infonce(
        a, p, b, i, T, bank_normalized=False)
    _assert_triplet(_torch_losses_and_grads(tfn, *args),
                    _jax_losses_and_grads(jfn, *args))


# Sampler-shaped indices at a Q and N that no tile divides. On the CPU the
# wrappers run the plain pair, so these cases hold the plain pair against
# the Pallas pair in interpret mode at the main path's kind of draws; the
# kernels' own ragged tiles are tested on the card (test_torch_port_cuda.py).
Q_R, N_R = 20, 30


def _sampler_idx(rs, func, cap):
    """neg_idx [K, Q_R, N_R] as the contrastive loss draws it: Q_R * N_R
    ranks per class from the sampler's f32 arithmetic
    (ops/sampling.py), reshaped so that neg_idx[k, q, n] = rank[n*Q_R + q].
    Stratified ranks make neighbouring queries share rows at each n."""
    m = Q_R * N_R
    if func == "uniform":
        ranks = rs.randint(0, cap, size=(K, m))
    elif func == "smc":
        u = rs.rand(K, m).astype(np.float32)
        pos = (np.arange(m, dtype=np.float32) + u) / np.float32(m)
        ranks = (pos * np.float32(cap)).astype(np.int32)
    else:
        t = rs.rand(K, m // 2).astype(np.float32) * np.float32(2)
        base = np.float32(2) * np.arange(m // 2, dtype=np.float32)
        pos = np.concatenate([(base + t) / np.float32(m),
                              (base + (np.float32(2) - t)) / np.float32(m)],
                             axis=-1)
        ranks = (pos * np.float32(cap)).astype(np.int32)
    ranks = np.clip(ranks, 0, cap - 1).astype(np.int32)
    return np.ascontiguousarray(
        ranks.reshape(K, N_R, Q_R).transpose(0, 2, 1))


@pytest.mark.parametrize("normalized_bank", [False, True])
@pytest.mark.parametrize("func", ["smc", "asmc", "uniform"])
def test_fused_infonce_at_sampler_draws(func, normalized_bank):
    """The pair at the draws the main path makes ('smc'), 'asmc' and
    uniform, at a ragged Q and N, against the Pallas kernel pair in
    interpret mode."""
    rs = np.random.RandomState(7)
    anchor = rs.randn(K, Q_R, C).astype(np.float32)
    proto = rs.randn(K, C).astype(np.float32)
    bank = rs.randn(K, CAP, C).astype(np.float32)
    if normalized_bank:
        bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    idx = _sampler_idx(rs, func, CAP)
    weights = rs.rand(K).astype(np.float32)
    if func != "uniform":   # neighbouring queries share rows at each n
        assert (idx[:, 1:] == idx[:, :-1]).mean() > 0.5
    jfn = lambda a, p, b, i: pallas_sampled_infonce(
        a, p, b, i, temp=T, tile=32, interpret=True,
        bank_normalized=normalized_bank)
    tfn = lambda a, p, b, i: infonce.fused_sampled_infonce(
        a, p, b, i, T, bank_normalized=normalized_bank)
    args = (anchor, proto, bank, idx, weights)
    _assert_triplet(_torch_losses_and_grads(tfn, *args),
                    _jax_losses_and_grads(jfn, *args))


def test_plain_sampled_infonce_matches_xla():
    """The plain autograd version in losses/contrastive.py."""
    args = _infonce_inputs(2, normalized_bank=False)
    jfn = lambda a, p, b, i: jcontra.sampled_infonce(a, p, b, i, T)
    tfn = lambda a, p, b, i: contrastive.sampled_infonce(a, p, b, i, T)
    _assert_triplet(_torch_losses_and_grads(tfn, *args),
                    _jax_losses_and_grads(jfn, *args))


def test_duplicate_negatives_count_twice():
    """A row drawn twice adds twice to the denominator (counts = 2 in the
    TPU kernel's multiplicity matrix)."""
    rs = np.random.RandomState(3)
    a = torch.from_numpy(rs.randn(1, 2, C).astype(np.float32))
    bank = torch.from_numpy(rs.randn(1, 4, C).astype(np.float32))
    a_n = torch.nn.functional.normalize(a, dim=-1)
    twice = torch.tensor([[[1, 1], [2, 3]]], dtype=torch.int32)
    once = torch.tensor([[[1], [2]]], dtype=torch.int32)
    d2, _ = infonce.infonce_fwd(a_n, bank, twice, 1 / T)
    d1, _ = infonce.infonce_fwd(a_n, bank, once, 1 / T)
    torch.testing.assert_close(d2[0, 0], 2 * d1[0, 0])


def test_plain_grad_is_the_key_sum_autograd_gives():
    """infonce_bwd's plain version, fed the forward's e, is
    d(sum_q invtot_q * denom_q)/d a_n."""
    anchor, _, bank, idx, _ = _infonce_inputs(4, normalized_bank=True)
    a = torch.from_numpy(anchor)
    bank, idx = torch.from_numpy(bank), torch.from_numpy(idx)
    invtot = torch.from_numpy(
        np.random.RandomState(5).rand(K, Q).astype(np.float32))
    x = a.clone().requires_grad_()
    (infonce.infonce_denom_plain(x, bank, idx, 1 / T)[0] * invtot).sum() \
        .backward()
    _, e = infonce.infonce_fwd(a, bank, idx, 1 / T)
    ga = infonce.infonce_bwd(e, bank, idx, invtot)
    torch.testing.assert_close(ga / T, x.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,k,f", [(3, 5, 1000), (4, 36, 4096)])
def test_pool_sims_matches_pallas_interpret(b, k, f):
    rs = np.random.RandomState(b * k)
    q = rs.randn(b, f).astype(np.float32)
    p = rs.randn(k, f).astype(np.float32)
    want = np.asarray(jpool_sims(jnp.asarray(q), jnp.asarray(p), chunk=256,
                                 interpret=True))
    got = pool_sims.pool_similarities(torch.from_numpy(q),
                                      torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    plain = pool_sims.pool_similarities_plain(torch.from_numpy(q),
                                              torch.from_numpy(p), chunk=300)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-4)


def test_revisiting_loss_matches_xla():
    """K3 inside the revisiting loss: pool rows in the rep's shape
    [K, H, W, C], student and teacher reps [B, H, W, C]."""
    rs = np.random.RandomState(6)
    pool = rs.randn(6, 4, 4, 8).astype(np.float32)
    pool /= np.linalg.norm(pool.reshape(6, -1), axis=1)[:, None, None, None]
    rep_u = rs.randn(2, 4, 4, 8).astype(np.float32)
    rep_t = rs.randn(2, 4, 4, 8).astype(np.float32)
    want = float(jcons.revisiting_loss(jnp.asarray(pool), jnp.asarray(rep_u),
                                       jnp.asarray(rep_t), topk=3))
    got = float(consistency.revisiting_loss(
        torch.from_numpy(pool), torch.from_numpy(rep_u),
        torch.from_numpy(rep_t), topk=3))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cpu_wrappers_do_not_count_launches():
    before = launch_counts()
    a = torch.randn(1, 2, 8)
    infonce.infonce_fwd(a, torch.randn(1, 4, 8),
                        torch.zeros(1, 2, 3, dtype=torch.int32), 2.0)
    pool_sims.pool_similarities(torch.randn(2, 16), torch.randn(3, 16))
    assert launch_counts() == before
