"""Similarity Moving-Least-Squares deformation.

Schaefer et al., "Image Deformation Using Moving Least Squares" (similarity
variant), fully vectorized over all query points.  Behavioral spec:
vkit/mechanism/distortion/geometric/mls.py:31-164 (re-derived).
"""
import attr
import numpy as np

from ....element import PointTuple
from ..interface import DistortionConfig, GeometricDistortion
from ..warp_plan import WarpPlan, lattice_plan


@attr.define
class SimilarityMlsConfig(DistortionConfig):
    src_handle_points: PointTuple
    dst_handle_points: PointTuple
    grid_size: int
    resize_as_src: bool = False


def similarity_mls_map(
    np_src_handles: np.ndarray,
    np_dst_handles: np.ndarray,
    np_queries: np.ndarray,
) -> np.ndarray:
    """Vectorized similarity-MLS: (V, 2) queries -> (V, 2) deformed."""
    v = np.asarray(np_queries, dtype=np.float64)
    p = np.asarray(np_src_handles, dtype=np.float64)
    q = np.asarray(np_dst_handles, dtype=np.float64)

    # Component-wise (V, N) arrays throughout: the (V, N, 2) temporaries
    # (and their axis-reductions) dominated plan-sampling time on the
    # one-core host; the star points reduce via GEMM.
    dxv = v[:, 0][:, None] - p[None, :, 0]          # (V, N)
    dyv = v[:, 1][:, None] - p[None, :, 1]
    dist_sq = dxv * dxv + dyv * dyv
    exact = dist_sq < 1e-12                         # handle hits -> identity

    w = np.where(exact, 0.0, 1.0 / np.where(exact, 1.0, dist_sq))
    w_sum = w.sum(axis=1)
    w_sum = np.where(w_sum == 0, 1.0, w_sum)

    p_star = (w @ p) / w_sum[:, None]               # (V, 2)
    q_star = (w @ q) / w_sum[:, None]

    dx = v[:, 0] - p_star[:, 0]                     # (V,)
    dy = v[:, 1] - p_star[:, 1]
    phx = p[None, :, 0] - p_star[:, 0][:, None]     # (V, N)
    phy = p[None, :, 1] - p_star[:, 1][:, None]
    qhx = q[None, :, 0] - q_star[:, 0][:, None]
    qhy = q[None, :, 1] - q_star[:, 1][:, None]

    # d = (dx, dy), d_perp = (-dy, dx), p_hat_perp = (-phy, phx).
    a00 = phx * dx[:, None] + phy * dy[:, None]
    a01 = phx * dy[:, None] - phy * dx[:, None]
    a10 = phy * dx[:, None] - phx * dy[:, None]
    a11 = phy * dy[:, None] + phx * dx[:, None]

    fx = w * (qhx * a00 + qhy * a10)
    fy = w * (qhx * a01 + qhy * a11)

    mu = (w * (phx * phx + phy * phy)).sum(axis=1)
    mu = np.where(mu == 0, 1.0, mu)
    out = np.empty_like(v)
    out[:, 0] = fx.sum(axis=1) / mu + q_star[:, 0]
    out[:, 1] = fy.sum(axis=1) / mu + q_star[:, 1]

    if exact.any():
        idx_v, idx_n = np.nonzero(exact)
        out[idx_v] = q[idx_n]
    return out


def _similarity_mls_plan(config: SimilarityMlsConfig, shape, rng) -> WarpPlan:
    np_src = np.asarray(
        [(pt.smooth_x, pt.smooth_y) for pt in config.src_handle_points],
        dtype=np.float64,
    )
    np_dst = np.asarray(
        [(pt.smooth_x, pt.smooth_y) for pt in config.dst_handle_points],
        dtype=np.float64,
    )
    return lattice_plan(
        shape,
        config.grid_size,
        lambda queries: similarity_mls_map(np_src, np_dst, queries),
        resize_as_src=config.resize_as_src,
    )


similarity_mls = GeometricDistortion(SimilarityMlsConfig, _similarity_mls_plan)
