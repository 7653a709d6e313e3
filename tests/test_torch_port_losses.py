"""Losses and augmentations of the ARCO stage in the PyTorch port against
the JAX package (CPU, float32), with the JAX random draws handed to the
port explicitly.

Tolerances: rtol 1e-5 on loss values and atol 1e-6 on gradients
(summation order); sampled indices, bank pointers/counts, ranks, cutout
boxes and class masks exactly. The TPS grid is held to atol 3e-5: it comes
from an ill-conditioned f32 solve (inverse-kernel entries up to 5.1), and
the JAX grid itself lies up to 1.4e-5 from a float64 solve of the same
draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.augment import mixing as jmixing
from arco_tpu.augment import tps as jtps
from arco_tpu.losses import consistency as jcons
from arco_tpu.losses import contrastive as jcontra

from arco_torch.augment import mixing, tps
from arco_torch.losses import consistency, contrastive

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---------------------------------------------------------- consistency

@pytest.mark.parametrize("conf_mask", [False, True])
def test_unsupervised_loss_and_gradient(conf_mask):
    rs = np.random.RandomState(0)
    pred = rs.randn(2, 6, 6, 4).astype(np.float32)
    target = rs.randint(-1, 4, size=(2, 6, 6)).astype(np.int32)
    conf = rs.rand(2, 6, 6).astype(np.float32)
    f = lambda p: jcons.compute_unsupervised_loss(
        p, jnp.asarray(target), jnp.asarray(conf), 0.5, conf_mask=conf_mask)
    want, jg = jax.value_and_grad(f)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = consistency.compute_unsupervised_loss(
        p, torch.from_numpy(target), torch.from_numpy(conf), 0.5,
        conf_mask=conf_mask)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_equivariance_loss_and_gradient():
    rs = np.random.RandomState(1)
    pred = rs.randn(3, 5, 5, 4).astype(np.float32)
    org = rs.randn(3, 5, 5, 4).astype(np.float32)
    mask = (rs.rand(3, 5, 5, 1) < 0.7).astype(np.float32)
    mask[2] = 0.0
    f = lambda p: jcons.equivariance_loss(p, jnp.asarray(org),
                                          jnp.asarray(mask))
    want, jg = jax.value_and_grad(f)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = consistency.equivariance_loss(p, torch.from_numpy(org),
                                        torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_revisiting_loss_bf16_pool_f32_reps(monkeypatch):
    """The step at --compute_dtype float32 with the CLIs' bf16 pool: JAX
    widens the pool to the reps' f32 (exact), the port hands the bf16 pool
    to pool_similarities as it is (its kernel widens in registers; no f32
    copy of the pool); the same loss at rtol 1e-5."""
    rs = np.random.RandomState(16)
    pool = rs.randn(6, 4, 4, 8).astype(np.float32)
    pool /= np.linalg.norm(pool.reshape(6, -1), axis=1)[:, None, None, None]
    pool_bf16 = torch.from_numpy(pool).to(torch.bfloat16)
    rep_u = rs.randn(2, 4, 4, 8).astype(np.float32)
    rep_t = rs.randn(2, 4, 4, 8).astype(np.float32)
    want = float(jcons.revisiting_loss(
        jnp.asarray(pool_bf16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(rep_u), jnp.asarray(rep_t), topk=3))
    handed = []
    sims_fn = consistency.pool_similarities

    def spy(queries, pool_rows):
        handed.append((queries.dtype, pool_rows.dtype))
        return sims_fn(queries, pool_rows)
    monkeypatch.setattr(consistency, "pool_similarities", spy)
    got = float(consistency.revisiting_loss(
        pool_bf16, torch.from_numpy(rep_u), torch.from_numpy(rep_t), topk=3))
    assert handed == [(torch.float32, torch.bfloat16)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------- contrastive

def test_create_memobank():
    j = jcontra.create_memobank(3, 8, capacity=10, capacity_bg=16)
    t = contrastive.create_memobank(3, 8, capacity=10, capacity_bg=16)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.ptr.numpy(), np.asarray(j.ptr))
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    assert t.capacities == j.capacities == (16, 10, 10)
    r = contrastive.create_memobank(3, 8, capacity=10, capacity_bg=16,
                                    init="randn",
                                    generator=torch.Generator())
    torch.testing.assert_close(r.data[:, 0].norm(dim=-1), torch.ones(3))
    assert (r.data[:, 1:] == 0).all()


def test_bank_enqueue_all_wraps_and_drops_disabled_classes():
    rs = np.random.RandomState(2)
    bank = jcontra.create_memobank(3, 4, capacity=5, capacity_bg=7)
    bank = bank._replace(ptr=jnp.array([6, 4, 0], jnp.int32),
                         count=jnp.array([7, 5, 2], jnp.int32))
    keys = rs.randn(3, 3, 4).astype(np.float32)
    enable = np.array([True, True, False])
    want = jcontra._bank_enqueue_all(bank, jnp.asarray(keys),
                                     jnp.asarray(enable))
    t = contrastive.create_memobank(3, 4, capacity=5, capacity_bg=7)
    t.ptr = torch.tensor([6, 4, 0], dtype=torch.int32)
    t.count = torch.tensor([7, 5, 2], dtype=torch.int32)
    contrastive._bank_enqueue_all(t, torch.from_numpy(keys),
                                  torch.from_numpy(enable))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(t.ptr.numpy(), np.asarray(want.ptr))
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(want.count))


@pytest.mark.parametrize("k", [4, 40])
def test_descending_rank_both_paths(k):
    """K <= 32 takes the comparison count, larger K two stable argsorts;
    ties break by ascending class index in both."""
    rs = np.random.RandomState(3)
    prob = rs.randint(0, 5, size=(2, 3, 3, k)).astype(np.float32)
    want = np.asarray(jcontra.descending_rank(jnp.asarray(prob)))
    got = contrastive.descending_rank(torch.from_numpy(prob))
    np.testing.assert_array_equal(got.numpy(), want)


def _uniforms(key, n_classes, num):
    """The uniforms sampling.stratified_indices draws from each class key."""
    out = []
    for k in jax.random.split(key, n_classes):
        k_u, _ = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(k_u, (num,))))
    return torch.from_numpy(np.stack(out))


def test_compute_contra_memobank_loss_and_gradient():
    """Masks, prototypes, the stratified enqueue and anchor/negative draws
    and the InfoNCE, on 2 labeled + 2 unlabeled 8x8 maps; the gradient
    w.r.t. the student rep flows through the kernel pair's autograd
    Function (its plain versions here)."""
    rs = np.random.RandomState(4)
    b, hw, nc, c, q, n, enq = 4, 8, 4, 16, 8, 6, 8
    rep = rs.randn(b, hw, hw, c).astype(np.float32)
    rep_t = rs.randn(b, hw, hw, c).astype(np.float32)
    logits = rs.randn(b, hw, hw, nc).astype(np.float32) * 2
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    labels = rs.randint(0, nc, size=(b, hw, hw))
    onehot = np.eye(nc, dtype=np.float32)[labels]
    onehot_l = onehot.copy()
    onehot_l[2:] = 0
    low = (rs.rand(b, hw, hw) < 0.7).astype(np.float32)
    high = (rs.rand(b, hw, hw) < 0.7).astype(np.float32)
    is_lab = np.array([True, True, False, False])
    rank = np.asarray(jcontra.descending_rank(jnp.asarray(prob)))
    kw = dict(delta_n=0.6, num_queries=q, num_negatives=n, temp=0.5,
              low_rank=1, high_rank=3, current_class_threshold=0.2,
              enqueue_per_class=enq)
    key = jax.random.PRNGKey(11)
    jbank = jcontra.create_memobank(nc, c, capacity=20, capacity_bg=24)

    def jloss(r):
        return jcontra.compute_contra_memobank_loss(
            key, r, jnp.asarray(onehot), jnp.asarray(prob),
            jnp.asarray(rank), jnp.asarray(is_lab), jnp.asarray(onehot_l),
            jnp.asarray(low), jnp.asarray(high), jnp.asarray(rep_t), jbank,
            **kw)[::-1]
    (want, new_bank), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(rep))

    k_anchor, k_neg, k_enq = jax.random.split(key, 3)
    draws = {"enq": _uniforms(k_enq, nc, enq),
             "anchor": _uniforms(k_anchor, nc, q),
             "neg": _uniforms(k_neg, nc, q * n)}
    tbank = contrastive.create_memobank(nc, c, capacity=20, capacity_bg=24)
    r = torch.from_numpy(rep).requires_grad_()
    t = torch.from_numpy
    _, got = contrastive.compute_contra_memobank_loss(
        r, t(onehot), t(prob), t(rank), t(is_lab), t(onehot_l), t(low),
        t(high), t(rep_t), tbank, draws=draws, **kw)
    got.backward()
    assert float(want) > 0
    np.testing.assert_array_equal(tbank.ptr.numpy(), np.asarray(new_bank.ptr))
    np.testing.assert_array_equal(tbank.count.numpy(),
                                  np.asarray(new_bank.count))
    np.testing.assert_allclose(tbank.data.numpy(), np.asarray(new_bank.data),
                               atol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jg), atol=1e-6)


# --------------------------------------------------------------- mixing

def _cutout_boxes(key, b, hw):
    """(rw, x0, y0) as generate_cutout_mask draws them from each key."""
    out = []
    for k in jax.random.split(key, b):
        k_w, k_x, k_y = jax.random.split(k, 3)
        rw = jax.random.randint(k_w, (), int(hw / 2.0) + 1, hw)
        rh = jnp.minimum(jnp.round(hw * hw / 2.0 / rw).astype(jnp.int32), hw)
        x0 = jax.random.randint(k_x, (), 0, jnp.maximum(hw - rw + 1, 1))
        y0 = jax.random.randint(k_y, (), 0, jnp.maximum(hw - rh + 1, 1))
        out.append([int(rw), int(x0), int(y0)])
    return torch.tensor(out)


@pytest.mark.parametrize("mode", ["cutout", "cutmix", "classmix", "none"])
def test_generate_unsup_data(mode):
    rs = np.random.RandomState(5)
    b, hw, nc = 3, 16, 4
    data = rs.randn(b, hw, hw, 1).astype(np.float32)
    target = rs.randint(0, nc, size=(b, hw, hw)).astype(np.int32)
    target[1] = np.where(target[1] == 3, 0, target[1])   # a class absent
    logits = rs.rand(b, hw, hw).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = jmixing.generate_unsup_data(key, jnp.asarray(data),
                                       jnp.asarray(target),
                                       jnp.asarray(logits), mode=mode,
                                       num_classes=nc)
    scores = torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (nc,)))
        for k in jax.random.split(key, b)]))
    got = mixing.generate_unsup_data(
        _nchw(data), torch.from_numpy(target), torch.from_numpy(logits),
        mode=mode, num_classes=nc, boxes=_cutout_boxes(key, b, hw),
        scores=scores)
    np.testing.assert_array_equal(got[0].permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_native_cutout_boxes_lie_in_range():
    gen = torch.Generator().manual_seed(0)
    boxes = mixing.draw_cutout_boxes(64, (16, 16), generator=gen)
    rw, x0, y0 = boxes.unbind(1)
    rh = torch.round(128 / rw.float()).long().clamp(max=16)
    assert ((9 <= rw) & (rw < 16)).all()
    assert ((0 <= x0) & (x0 <= 16 - rw)).all()
    assert ((0 <= y0) & (y0 <= 16 - rh)).all()


# ------------------------------------------------------------------ TPS

def test_tps_grid_gen_is_the_same_solve():
    cp = tps.default_control_points()
    np.testing.assert_array_equal(cp, jtps.default_control_points())
    j = jtps.TPSGridGen(12, 10, jtps.default_control_points())
    t = tps.TPSGridGen(12, 10, cp)
    np.testing.assert_array_equal(t.inverse_kernel.numpy(), j.inverse_kernel)
    np.testing.assert_array_equal(t.target_coordinate_repr.numpy(),
                                  j.target_coordinate_repr)


def test_rand_tps_reset_and_apply_with_jax_draws():
    b, hw, sigma = 4, 16, 0.01
    key = jax.random.PRNGKey(13)
    jt = jtps.RandTPS(hw, hw, batch_size=b, sigma=sigma)
    want_grid = np.asarray(jt.reset(key))
    k_pert, k_aff, k_mir = jax.random.split(key, 3)
    k_a, k_s, k_tx, k_ty = jax.random.split(k_aff, 4)
    u = lambda k, shape, lo, hi: torch.from_numpy(np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)))
    draws = {"pert": u(k_pert, (b, 25, 2), -sigma, sigma),
             "angle": u(k_a, (b,), -60.0, 60.0),
             "scale": u(k_s, (b,), 1.0 / 1.2, 1.0 / 0.8),
             "tx": u(k_tx, (b,), -0.1, 0.1),
             "ty": u(k_ty, (b,), -0.1, 0.1),
             "flip": torch.tensor(bool(jax.random.bernoulli(k_mir)))}
    t = tps.RandTPS(hw, hw, batch_size=b, sigma=sigma)
    grid = t.reset(draws)
    np.testing.assert_allclose(grid.numpy(), want_grid, atol=3e-5)
    x = np.random.RandomState(6).randn(b, hw, hw, 3).astype(np.float32)
    want = np.asarray(jt.apply(jnp.asarray(x), jnp.asarray(grid.numpy())))
    got = t.apply(_nchw(x), grid)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)


def test_native_tps_draws():
    gen = torch.Generator().manual_seed(0)
    d = tps.draw_tps(8, sigma=0.01, generator=gen)
    assert d["pert"].abs().max() <= 0.01
    assert d["angle"].abs().max() <= 60.0
    assert ((1 / 1.2 <= d["scale"]) & (d["scale"] <= 1 / 0.8)).all()
    assert tps.RandTPS(16, 16, batch_size=8).reset(generator=gen).shape \
        == (8, 16, 16, 2)
