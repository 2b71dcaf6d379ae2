"""Rigid and similarity alignment for the evaluation metrics
(counterpart of `straps_tpu/geometry/alignment.py`)."""

import torch


def compute_similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Procrustes-align (B, N, 3) point sets S1 to S2: the scale s, rotation
    R and translation t minimising ||s R S1 + t - S2||^2, applied to S1."""
    mu1 = S1.mean(dim=1, keepdim=True)
    mu2 = S2.mean(dim=1, keepdim=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = torch.sum(X1 ** 2, dim=(1, 2))
    K = torch.einsum("bni,bnj->bij", X1, X2)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    # Fix the reflection so that det(R) = +1.
    det = torch.linalg.det(torch.einsum("bij,bkj->bik", U, V))
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).repeat(K.shape[0], 1, 1)
    Z[:, -1, -1] = torch.sign(det)
    R = torch.einsum("bij,bjk,blk->bil", V, Z, U)
    scale = torch.einsum("bii->b", torch.einsum("bij,bjk->bik", R, K)) / var1
    t = mu2 - scale[:, None, None] * torch.einsum("bij,bnj->bni", R, mu1)
    return scale[:, None, None] * torch.einsum("bij,bnj->bni", R, S1) + t


# The JAX package's alias of the batched entry point.
procrustes_align = compute_similarity_transform


def scale_and_translation_transform(P: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Match the mean and RMS scale of (B, N, 3) P to T."""
    P_mean = P.mean(dim=1, keepdim=True)
    P_trans = P - P_mean
    P_scale = torch.sqrt(torch.sum(P_trans ** 2, dim=(1, 2), keepdim=True) / P.shape[1])
    P_normalised = P_trans / P_scale
    T_mean = T.mean(dim=1, keepdim=True)
    T_scale = torch.sqrt(torch.sum((T - T_mean) ** 2, dim=(1, 2), keepdim=True) / T.shape[1])
    return P_normalised * T_scale + T_mean
