"""Low-rank factorization of the pre-RoPE key cache, K ~= U @ SV.

Counterpart of ``shadowkv_tpu/core/lowrank.py``: the same randomized
subspace iteration (one power pass, re-orthonormalizing each half-step by
symmetric whitening from a small eigh), then the top-``rank`` factors from
the range basis. U is shared across KV heads; SV is laid out per head.

The Gaussian sketch ``omega`` [K*Dh, p] is drawn by JAX from
``PRNGKey(7)``; here it is an argument, drawn from a ``torch.Generator``
seeded with 7 when absent (different numbers, same distribution), so tests
can hand both packages the same sketch. When ``rank + oversample >= K*Dh``
the sketch spans the whole feature space and the product U @ SV does not
depend on it. The small eigendecompositions run in float32, as in JAX.

Under tensor parallelism (``tp``, a process group) the keys hold this
rank's head slice of the feature axis (JAX ``lowrank.py:96-176``): the
rank takes its rows of one global sketch, every d-contraction ``y`` and
the d-sharded Grams of ``_orth`` and ``_finish_from_basis`` are summed over
the group, so U comes out the same on every rank and SV is exactly this
rank's head slice.
"""

from __future__ import annotations

import torch

SKETCH_SEED = 7


def _sum(x: torch.Tensor, tp) -> torch.Tensor:
    if tp is None:
        return x
    from shadowkv_tpu_torch.parallel.mesh import all_reduce

    return all_reduce(x.contiguous(), tp)


def _orth(y: torch.Tensor, tp=None) -> torch.Tensor:
    """Orthonormalize tall-skinny [B, S, p] by symmetric whitening:
    Q = Y W diag(1/sqrt(lam)) from eigh(Y^T Y). Directions below f32 Gram
    noise are dropped (zeroed), not amplified. With ``tp`` the S rows are
    a shard and the Gram is summed over the group."""
    g = _sum(torch.einsum("bsp,bsq->bpq", y, y), tp)
    lam, w = torch.linalg.eigh(g)
    good = lam > torch.clamp(lam[:, -1:], min=1e-30) * 1e-6
    inv_s = torch.where(good, torch.rsqrt(torch.clamp(lam, min=1e-30)), 0.0)
    return torch.einsum("bsp,bpq->bsq", y, w * inv_s[:, None, :])


def _finish_from_basis(kf: torch.Tensor, q: torch.Tensor, rank: int,
                       tp=None):
    """Top-``rank`` factors U [B, S, r], SV [B, r, d] from an orthonormal
    range basis Q [B, S, p]; with ``tp``, d is this rank's column block and
    the Gram is summed over the group."""
    b_small = torch.einsum("bsp,bsd->bpd", q, kf)
    g = _sum(torch.einsum("bpd,bqd->bpq", b_small, b_small), tp)
    _, eigvec = torch.linalg.eigh(g)  # ascending
    top = torch.flip(eigvec, dims=[-1])[:, :, :rank]
    u = torch.einsum("bsp,bpr->bsr", q, top)
    sv = torch.einsum("bpr,bpd->brd", top, b_small)
    return u, sv


def sketch(d: int, p: int, device=None) -> torch.Tensor:
    """The default Gaussian sketch [d, p] (seeded generator)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(SKETCH_SEED)
    return torch.randn(d, p, generator=gen, device=device, dtype=torch.float32)


def lowrank_kv_factors(
    k_pre_rope: torch.Tensor,
    rank: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    oversample: int = 32,
    omega: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor pre-RoPE keys [B, S, K*Dh] (or [B, S, K, Dh]) as U @ SV.

    Returns U [B, S, rank] and SV [B, K, rank, Dh], both in ``dtype``.
    ``omega`` [K*Dh, min(K*Dh, rank + oversample)] is the sketch. With a tp
    group the keys are this rank's K heads of the model's K * tp, ``omega``
    is the GLOBAL sketch [K*Dh*tp, p], and the rank takes its rows of it.
    """
    b, s = k_pre_rope.shape[:2]
    d = num_kv_heads * head_dim
    kf = k_pre_rope.reshape(b, s, d).float()
    n_tp, t = 1, 0
    if tp is not None:
        import torch.distributed as dist

        n_tp, t = dist.get_world_size(tp), dist.get_rank(tp)
    d_g = d * n_tp
    p = min(d_g, rank + oversample)
    if omega is None:
        omega = sketch(d_g, p, device=kf.device)
    if tuple(omega.shape) != (d_g, p):
        raise ValueError(
            f"sketch must be [{d_g}, {p}], got {tuple(omega.shape)}")
    omega = omega[t * d:(t + 1) * d]
    y = _sum(torch.matmul(kf, omega.to(kf.device, torch.float32)), tp)
    q = _orth(y)
    z = _orth(torch.einsum("bsd,bsp->bdp", kf, q), tp)
    y = _sum(torch.einsum("bsd,bdp->bsp", kf, z), tp)
    q = _orth(_orth(y))
    u, sv = _finish_from_basis(kf, q, rank, tp)
    sv = sv.reshape(b, rank, num_kv_heads, head_dim).transpose(1, 2)
    return u.to(dtype), sv.contiguous().to(dtype)


def reconstruct_keys(
    u: torch.Tensor, sv: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Pre-RoPE keys [B, K, N, Dh] of the given rows.

    Args:
      u: [B, S, r]; sv: [B, K, r, Dh]; positions: [B, K, N] rows.
    """
    b, kh, n = positions.shape
    u_rows = torch.gather(
        u[:, None].expand(b, kh, *u.shape[1:]), 2,
        positions.long()[..., None].expand(b, kh, n, u.shape[-1]),
    )
    return torch.matmul(u_rows.float(), sv.float()).to(u.dtype)
