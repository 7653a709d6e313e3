"""The library leftovers of the port against the JAX package, function by
function (CPU, f32): losses/extras.py (the ReCo baseline, OHEM CE,
SoftDice, the SupCon family, weighted MSE, InfoNCE, the Criterion
wrappers), augment/genesis.py (bezier remap, pixel shuffling, in- and
out-painting), the consistency losses of losses/supervised.py, the
generic ring buffer of ops/ring_buffer.py and utils/misc.py.

Every stochastic function is handed the draws JAX made: the uniforms
behind each class's stratified anchor draw and inverse-CDF negative draw
(``compute_reco_loss``), the sampled pixels (``sup_con_seg_loss``) and the
genesis augmentations' positions, sizes, rolls and noise, reproduced from
the same keys. Tolerances: rtol 1e-5 / atol 1e-6 for the losses (the same
f32 arithmetic in another summation order), exact for the augmentations
and the buffers, which only select and copy (the bezier remap at atol
1e-6: both frameworks' f32 interpolation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.augment import genesis as jgen
from arco_tpu.losses import extras as jext
from arco_tpu.losses import supervised as jsup
from arco_tpu.ops import ring_buffer as jrb
from arco_tpu.utils import misc as jmisc

from arco_torch.augment import genesis as tgen
from arco_torch.losses import extras as text
from arco_torch.losses import supervised as tsup
from arco_torch.ops import ring_buffer as trb
from arco_torch.utils import misc as tmisc

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if
                                          isinstance(got, torch.Tensor)
                                          else got),
                               np.asarray(want), **(tol or TOL))


# ------------------------------------------------------------------ extras

def test_info_nce():
    rs = np.random.RandomState(0)
    q, k = rs.randn(6, 16).astype(np.float32), \
        rs.randn(6, 16).astype(np.float32)
    for temp in (0.1, 0.5):
        _close(text.info_nce(_t(q), _t(k), temp),
               jext.info_nce(jnp.asarray(q), jnp.asarray(k), temp))


def _reco_draws(rng, num_classes, q, n):
    """The uniforms compute_reco_loss's key chain gives each class."""
    anchor, neg = [], []
    for _ in range(num_classes):
        rng, k_a, _, k_p = jax.random.split(rng, 4)
        anchor.append(np.asarray(jax.random.uniform(
            jax.random.split(k_a)[0], (q,))))
        neg.append(np.asarray(jax.random.uniform(k_p, (q * n,))))
    return {"anchor": _t(np.stack(anchor)), "neg": _t(np.stack(neg))}


@pytest.mark.parametrize("threshold,dead_class", [(1.0, False), (0.6, True)])
def test_compute_reco_loss(threshold, dead_class):
    rs = np.random.RandomState(1)
    b, h, w, c, k, q, n = 2, 9, 7, 8, 4, 16, 8
    rep = rs.randn(b, h, w, c).astype(np.float32)
    labels = rs.randint(0, k, (b, h, w))
    if dead_class:
        labels[labels == 2] = 1            # a class with no pixel
    onehot = np.eye(k, dtype=np.float32)[labels]
    logits = rs.randn(b, h, w, k).astype(np.float32)
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    valid = (rs.rand(b, h, w) > 0.1).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    want = jext.compute_reco_loss(rng, jnp.asarray(rep), jnp.asarray(valid),
                                  jnp.asarray(prob), jnp.asarray(onehot),
                                  threshold, 0.5, q, n)
    got = text.compute_reco_loss(_t(rep), _t(valid), _t(prob), _t(onehot),
                                 threshold, 0.5, q, n,
                                 draws=_reco_draws(rng, k, q, n))
    assert float(want) > 0
    _close(got, want)


@pytest.mark.parametrize("min_kept", [10, 100000])
def test_ohem_cross_entropy_and_criteria(min_kept):
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 6, 5, 4).astype(np.float32) * 2
    aux = rs.randn(2, 6, 5, 4).astype(np.float32)
    labels = rs.randint(0, 4, (2, 6, 5))
    labels[0, :2] = 255
    j = lambda a: jnp.asarray(a)
    _close(text.ohem_cross_entropy(_t(logits), _t(labels), 255, 0.7,
                                   min_kept),
           jext.ohem_cross_entropy(j(logits), j(labels), 255, 0.7,
                                   min_kept))
    _close(text.criterion_ohem((_t(logits), _t(aux)), _t(labels), 0.4,
                               min_kept=min_kept),
           jext.criterion_ohem((j(logits), j(aux)), j(labels), 0.4,
                               min_kept=min_kept))
    _close(text.criterion((_t(logits), _t(aux)), _t(labels), 0.4),
           jext.criterion((j(logits), j(aux)), j(labels), 0.4))
    _close(text.criterion(_t(logits), _t(labels)),
           jext.criterion(j(logits), j(labels)))


@pytest.mark.parametrize("do_bg,batch_dice", [(True, False), (False, True)])
def test_soft_dice_loss(do_bg, batch_dice):
    rs = np.random.RandomState(3)
    logits = rs.randn(2, 5, 6, 3).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (2, 5, 6))]
    _close(text.soft_dice_loss(_t(logits), _t(onehot), 1.0, do_bg,
                               batch_dice),
           jext.soft_dice_loss(jnp.asarray(logits), jnp.asarray(onehot), 1.0,
                               do_bg, batch_dice))


@pytest.mark.parametrize("with_labels,mode", [(True, "all"), (False, "all"),
                                              (True, "one")])
def test_sup_con_loss(with_labels, mode):
    rs = np.random.RandomState(4)
    f = rs.randn(6, 2, 8).astype(np.float32)
    lab = rs.randint(0, 3, 6) if with_labels else None
    _close(text.sup_con_loss(_t(f), None if lab is None else _t(lab),
                             contrast_mode=mode),
           jext.sup_con_loss(jnp.asarray(f),
                             None if lab is None else jnp.asarray(lab),
                             contrast_mode=mode))


def test_local_con_loss_and_weighted_mse():
    rs = np.random.RandomState(5)
    f = rs.randn(2, 2, 4, 8, 8).astype(np.float32)
    lab = rs.randint(0, 3, (2, 8, 8))
    _close(text.local_con_loss(_t(f), _t(lab), stride=4),
           jext.local_con_loss(jnp.asarray(f), jnp.asarray(lab), stride=4))
    a, b, wt = (rs.randn(3, 4).astype(np.float32) for _ in range(3))
    _close(text.weighted_mse_loss(_t(a), _t(b), _t(wt)),
           jext.weighted_mse_loss(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(wt)))


def test_sup_con_seg_loss():
    rs = np.random.RandomState(6)
    f = rs.randn(2, 6, 5, 8).astype(np.float32)
    lab = rs.randint(-1, 3, (2, 6, 5))
    rng = jax.random.PRNGKey(7)
    idx = np.asarray(jax.random.randint(rng, (2, 32), 0, 30))
    _close(text.sup_con_seg_loss(_t(f), _t(lab), num_samples=32,
                                 idx=_t(idx)),
           jext.sup_con_seg_loss(jnp.asarray(f), jnp.asarray(lab), rng,
                                 num_samples=32))


# -------------------------------------------------------------- supervised

def test_supervised_leftovers():
    rs = np.random.RandomState(8)
    a = rs.randn(2, 5, 4, 3).astype(np.float32)
    b = rs.randn(2, 5, 4, 3).astype(np.float32)
    lab = rs.randint(-1, 3, (2, 5, 4))
    j = jnp.asarray
    for tf, jf in ((tsup.softmax_mse_loss, jsup.softmax_mse_loss),
                   (tsup.softmax_kl_loss, jsup.softmax_kl_loss),
                   (tsup.symmetric_mse_loss, jsup.symmetric_mse_loss)):
        _close(tf(_t(a), _t(b)), jf(j(a), j(b)))
    p = np.asarray(jax.nn.softmax(j(a), -1))
    _close(tsup.entropy_loss(_t(p)), jsup.entropy_loss(j(p)))
    _close(tsup.focal_loss(_t(a), _t(lab)), jsup.focal_loss(j(a), j(lab)))
    _close(tsup.focal_loss(_t(a), _t(lab), gamma=0.5, alpha=1.0),
           jsup.focal_loss(j(a), j(lab), gamma=0.5, alpha=1.0))
    assert isinstance(tsup.DiceLossState(), tsup.DiceLossState)


# ----------------------------------------------------------------- genesis

def test_bezier_curve():
    pts = np.array([[0, 0], [0.2, 0.7], [0.6, 0.1], [1, 1]], np.float32)
    for g, w in zip(tgen.bezier_curve(_t(pts), 50),
                    jgen.bezier_curve(pts, 50)):
        _close(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nonlinear_transformation(seed):
    x = np.random.RandomState(seed).rand(2, 9, 7, 3).astype(np.float32) \
        * 1.2 - 0.1
    rng = jax.random.PRNGKey(seed)
    want = jgen.nonlinear_transformation(rng, jnp.asarray(x), prob=0.9)
    k_p, k_a, k_rev = jax.random.split(rng, 3)
    draws = {"points": _t(jax.random.uniform(k_p, (4,))),
             "reverse": bool(jax.random.bernoulli(k_rev)),
             "apply": float(jax.random.uniform(k_a))}
    got = tgen.nonlinear_transformation(_t(x).permute(0, 3, 1, 2), 0.9,
                                        draws=draws)
    _close(got.permute(0, 2, 3, 1), want, rtol=0, atol=1e-6)


def test_local_pixel_shuffling():
    h, w, nb, mb = 20, 24, 12, 6
    x = np.random.RandomState(9).rand(2, h, w, 3).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    want = jgen.local_pixel_shuffling(rng, jnp.asarray(x), prob=0.99,
                                      num_block=nb, max_block=mb)
    d = {k: [] for k in ("size", "y0", "x0", "dy", "dx")}
    key = rng
    for _ in range(nb):
        key, k_sz, k_pos, k_roll = jax.random.split(key, 4)
        d["size"].append(np.asarray(jax.random.randint(k_sz, (2,), 2,
                                                       mb + 1)))
        d["y0"].append(int(jax.random.randint(k_pos, (), 0, h - mb)))
        d["x0"].append(int(jax.random.randint(k_pos, (), 0, w - mb)))
        d["dy"].append(int(jax.random.randint(k_roll, (), 1, mb)))
        d["dx"].append(int(jax.random.randint(k_roll, (), 1, mb)))
    draws = {k: _t(np.stack(v) if k == "size" else v) for k, v in d.items()}
    draws["apply"] = _t(jax.random.uniform(jax.random.fold_in(rng, 12345)))
    got = tgen.local_pixel_shuffling(_t(x).permute(0, 3, 1, 2), 0.99, nb,
                                     mb, draws=draws)
    assert not np.array_equal(np.asarray(want), x)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_in_and_out_painting():
    h, w = 40, 36
    x = np.random.RandomState(10).rand(2, h, w, 3).astype(np.float32)
    nchw = lambda a: _t(a).permute(0, 3, 1, 2)
    rng = jax.random.PRNGKey(5)
    want = jgen.image_in_painting(rng, jnp.asarray(x), num_block=3, block=8)
    d = {"y0": [], "x0": [], "noise": []}
    key = rng
    for _ in range(3):
        key, k_pos, k_noise = jax.random.split(key, 3)
        d["y0"].append(int(jax.random.randint(k_pos, (), 0, h - 8)))
        d["x0"].append(int(jax.random.randint(jax.random.fold_in(k_pos, 1),
                                              (), 0, w - 8)))
        d["noise"].append(nchw(jax.random.uniform(k_noise, x.shape)))
    d["noise"] = torch.stack(d["noise"])
    got = tgen.image_in_painting(nchw(x), 3, 8, draws=d)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))

    rng = jax.random.PRNGKey(6)
    want = jgen.image_out_painting(rng, jnp.asarray(x), margin=8)
    k_pos, k_sz, k_noise = jax.random.split(rng, 3)
    bh = int(jax.random.randint(k_sz, (), h // 2, h - 8))
    bw = int(jax.random.randint(jax.random.fold_in(k_sz, 1), (), w // 2,
                                w - 8))
    draws = {"bh": bh, "bw": bw,
             "y0": int(jax.random.randint(k_pos, (), 0, h - bh + 1)),
             "x0": int(jax.random.randint(jax.random.fold_in(k_pos, 1), (),
                                          0, w - bw + 1)),
             "noise": nchw(jax.random.uniform(k_noise, x.shape))}
    got = tgen.image_out_painting(nchw(x), 8, draws=draws)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_genesis_draws_from_a_generator():
    """Without draws each function draws from the generator: the same seed
    gives the same result, and the shapes are kept."""
    x = torch.rand(2, 3, 32, 32)
    for fn in (tgen.nonlinear_transformation, tgen.local_pixel_shuffling,
               tgen.image_in_painting, tgen.image_out_painting):
        a = fn(x, generator=torch.Generator().manual_seed(1))
        b = fn(x, generator=torch.Generator().manual_seed(1))
        assert a.shape == x.shape and torch.equal(a, b), fn.__name__


# ------------------------------------------------------------ ring buffer

def test_ring_buffer():
    rs = np.random.RandomState(11)
    jb = jrb.create(5, 3)
    tb = trb.create(5, 3)
    for i, (b, en) in enumerate(((2, True), (2, False), (3, True),
                                 (4, True))):
        keys = rs.randn(b, 3).astype(np.float32)
        jb = jrb.enqueue(jb, jnp.asarray(keys), en)
        before = tb.data.clone()
        new = trb.enqueue(tb, _t(keys), torch.tensor(en))
        assert torch.equal(tb.data, before)      # the input is left alone
        tb = new
        np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
        assert int(tb.ptr) == int(jb.ptr) and int(tb.count) == int(jb.count)
    full = trb.create(4, 2, init=torch.ones(4, 2))
    assert int(full.count) == 4 == int(jrb.create(4, 2,
                                                  init=jnp.ones((4, 2))).count)
    assert full.capacity == 4


# -------------------------------------------------------------------- misc

def test_misc():
    rs = np.random.RandomState(12)
    for cls in (jmisc.AverageMeter, tmisc.AverageMeter):
        m = cls()
        for v, n in ((1.0, 2), (4.0, 1)):
            m.update(v, n)
        assert (m.val, m.avg, m.count) == (4.0, 2.0, 3)
    lists = [list(range(0, 5)), [], list(range(5, 7)), list(range(7, 20))]
    np.testing.assert_array_equal(
        tmisc.UnifLabelSampler(12, lists, seed=3).indexes(),
        jmisc.UnifLabelSampler(12, lists, seed=3).indexes())
    assert tmisc.learning_rate_decay(0.1, 500) == \
        jmisc.learning_rate_decay(0.1, 500)
    pred, gt = rs.randint(0, 4, (16, 16)), rs.randint(0, 4, (16, 16))
    gt[gt == 3] = 0                     # a class absent from gt
    np.testing.assert_array_equal(tmisc.get_iou(pred, gt, 5),
                                  jmisc.get_iou(pred, gt, 5))
    np.testing.assert_array_equal(tmisc.get_dice(pred, gt, 5),
                                  jmisc.get_dice(pred, gt, 5))
    np.testing.assert_array_equal(tmisc.post_processing(pred),
                                  jmisc.post_processing(pred))
