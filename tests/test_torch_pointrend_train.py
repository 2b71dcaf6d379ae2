"""PointRend's training side in the PyTorch port (`straps_tpu_torch/
perception/pointrend.py`: `importance_sample_points`, its selection
`select_importance_points`, `mask_point_loss`) against the JAX package's.

`jax.random` cannot be reproduced in torch, so the selection is fed the
JAX function's own draws (`jax.random.split(key)`, then its two
`jax.random.uniform` calls) and must choose the same points wherever the
uncertainty gap at the top-k cut clears 1e-6 (equal uncertainties go in
index order in both).  With a torch generator: shapes, bounds, and the
chosen points more uncertain than random ones (the JAX suite's check).
The loss and its gradient within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from straps_tpu.perception import pointrend as JPR
from straps_tpu_torch.perception import pointrend as TPR
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _jax_draws(key, R, num_points, oversample_ratio, importance_sample_ratio):
    """The draws of `straps_tpu.perception.pointrend.importance_sample_points`."""
    n_sampled = int(num_points * oversample_ratio)
    n_rand = num_points - int(importance_sample_ratio * num_points)
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.uniform(k1, (R, n_sampled, 2))),
            np.array(jax.random.uniform(k2, (R, n_rand, 2))))


@pytest.mark.parametrize("R,S,K,num_points,seed", [(3, 7, 1, 196, 0), (4, 7, 80, 196, 1),
                                                   (2, 14, 2, 100, 2)])
def test_selection_of_the_jax_draws_matches_jax(R, S, K, num_points, seed):
    coarse = np.random.RandomState(seed).randn(R, S, S, K).astype(np.float32) * 3
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JPR.importance_sample_points(key, jnp.asarray(coarse), num_points))
    cand, uniform = _jax_draws(key, R, num_points, 3.0, 0.75)
    n_unc = int(0.75 * num_points)
    got = TPR.select_importance_points(_nchw(coarse), torch.as_tensor(cand),
                                       torch.as_tensor(uniform), n_unc).numpy()
    assert got.shape == want.shape == (R, num_points, 2)
    # The margin at the cut: the gap between the last kept and the first
    # dropped uncertainty.
    unc = TPR.uncertainty(TPR.sample_mask_at_points(torch.as_tensor(coarse[..., :1]),
                                                    torch.as_tensor(cand))[..., 0])
    ordered = torch.sort(unc, dim=-1, descending=True).values
    gap = float((ordered[:, n_unc - 1] - ordered[:, n_unc]).min())
    assert gap > 1e-6
    np.testing.assert_array_equal(got, want)


def test_importance_sampling_with_a_generator():
    coarse = torch.as_tensor(np.random.RandomState(0).randn(3, 1, 7, 7).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    pts = TPR.importance_sample_points(coarse, num_points=196, generator=g)
    assert pts.shape == (3, 196, 2) and pts.dtype == torch.float32
    assert pts.min() >= 0.0 and pts.max() <= 1.0
    again = TPR.importance_sample_points(coarse, num_points=196,
                                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(pts, again)
    cand, uniform = TPR.importance_sample_draws(3, 196, generator=torch.Generator().manual_seed(0))
    assert cand.shape == (3, 588, 2) and uniform.shape == (3, 49, 2)
    assert torch.equal(pts[:, 147:], uniform)


def test_importance_points_more_uncertain_than_random():
    coarse = torch.as_tensor(np.random.RandomState(1).randn(2, 1, 7, 7).astype(np.float32) * 5)
    g = torch.Generator().manual_seed(2)
    pts = TPR.importance_sample_points(coarse, num_points=100, generator=g)
    nhwc = coarse.permute(0, 2, 3, 1)
    unc_chosen = TPR.uncertainty(TPR.sample_mask_at_points(nhwc, pts[:, :75])[..., 0])
    rand = torch.rand((2, 75, 2), generator=g)
    unc_rand = TPR.uncertainty(TPR.sample_mask_at_points(nhwc, rand)[..., 0])
    assert float(unc_chosen.mean()) > float(unc_rand.mean())


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_mask_point_loss_and_gradient_match_jax(scale):
    rng = np.random.RandomState(3)
    R, P, S = 4, 196, 28
    gt = (rng.rand(R, S, S) > 0.5).astype(np.float32)
    gt[:, :, 14:] = 1.0
    pts = rng.rand(R, P, 2).astype(np.float32)
    logits = (rng.randn(R, P) * scale).astype(np.float32)
    jl = lambda x: JPR.mask_point_loss(x[..., None], jnp.asarray(gt), jnp.asarray(pts))
    want, want_grad = jax.value_and_grad(jl)(jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_(True)
    got = TPR.mask_point_loss(x, torch.as_tensor(gt), torch.as_tensor(pts))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    assert np.abs(x.grad.numpy() - np.asarray(want_grad)).max() <= 1e-6


def test_point_loss_of_a_perfect_prediction_is_small():
    """The JAX suite's check: a half-plane mask and confident correct
    logits give a small loss, wrong ones a large one."""
    m = torch.zeros(2, 28, 28)
    m[:, :, 14:] = 1.0
    pts = torch.rand((2, 50, 2), generator=torch.Generator().manual_seed(0))
    gt_at = TPR.sample_mask_at_points(m[..., None], pts)[..., 0]
    perfect = (gt_at * 2 - 1) * 20.0
    assert float(TPR.mask_point_loss(perfect, m, pts)) < 0.5 < float(
        TPR.mask_point_loss(-perfect, m, pts))
