"""The port's k-d tree (vkit_tpu_torch/utility/kdtree.py) against
``sklearn.neighbors.KDTree``, which vkit_tpu's text-region steps use and
the port may not import (sklearn is imported here only, as the yardstick).

On distinct distances any exact tree answers alike.  On ties (integer
points, as the steps' region and char centers are) the answer depends on
the order in which a tree visits the tied points, and the port's tree is
sklearn's, built and walked alike: its node order and bounds equal
sklearn's ``get_arrays()``, and every query, tied or not, returns sklearn's
distances and indices.  ``scipy.spatial.cKDTree`` is shown to answer some
tied queries otherwise, which is why the port does not use it.
"""
import numpy as np
import pytest
from scipy.spatial import cKDTree
from sklearn.neighbors import KDTree as SklearnKDTree

from vkit_tpu_torch.utility.kdtree import KDTree


def tied_rows(points, queries, k):
    """Rows whose k nearest include a distance that another indexed point
    shares."""
    full = ((queries[:, None, :].astype(np.float64)
             - points[None].astype(np.float64)) ** 2).sum(-1)
    tied = 0
    for row in full:
        nearest = np.sort(row)[:k]
        tied += bool(np.isin(row, nearest).sum() > len(np.unique(nearest))
                     or len(np.unique(nearest)) < k)
    return tied


def assert_queries_match(points, queries, ks):
    ref, got = SklearnKDTree(points), KDTree(points)
    for k in ks:
        ref_dist, ref_ind = ref.query(queries, k=k)
        dist, ind = got.query(queries, k=k)
        assert dist.dtype == np.float64 and ind.dtype == np.int64
        np.testing.assert_array_equal(dist, ref_dist)
        np.testing.assert_array_equal(ind, ref_ind)


@pytest.mark.parametrize('count', [1, 2, 39, 40, 41, 81, 500, 3000])
def test_the_tree_is_sklearns(count):
    points = np.random.default_rng(count).integers(0, 640, (count, 2))
    _, order, _, bounds = SklearnKDTree(points).get_arrays()
    tree = KDTree(points)
    np.testing.assert_array_equal(tree._order, order)
    np.testing.assert_array_equal(tree._lo, bounds[0])
    np.testing.assert_array_equal(tree._hi, bounds[1])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_distinct_distances(seed):
    rng = np.random.default_rng(seed)
    points = rng.uniform(0, 640, (int(rng.integers(50, 400)), 2))
    queries = rng.uniform(0, 640, (300, 2))
    assert tied_rows(points, queries, len(points)) == 0
    assert_queries_match(points, queries, [1, 4, len(points)])


def test_ties_on_a_grid():
    """A 12 x 12 integer grid queried on a half-integer lattice around it:
    most queries tie, and cKDTree names another point on some of them."""
    grid = np.stack(np.meshgrid(np.arange(12), np.arange(12)),
                    -1).reshape(-1, 2)
    side = np.arange(-3, 15, 0.5)
    queries = np.stack(np.meshgrid(side, side), -1).reshape(-1, 2)
    assert tied_rows(grid, queries, 1) > len(queries) // 2
    assert_queries_match(grid, queries, [1, 2, 5, len(grid)])
    _, ind = SklearnKDTree(grid).query(queries, k=1)
    _, scipy_ind = cKDTree(grid).query(queries, k=1)
    assert (scipy_ind != ind[:, 0]).sum() > 0


@pytest.mark.parametrize('seed', range(6))
def test_integer_points_at_page_scale(seed):
    rng = np.random.default_rng(100 + seed)
    count = int(rng.integers(20, 3000))
    points = rng.integers(0, int(rng.integers(40, 640)), (count, 2))
    queries = rng.integers(0, 640, (400, 2))
    ks = [1, 3] + ([count] if count <= 300 else [])
    assert_queries_match(points, queries, ks)


def test_bad_k_raises():
    tree = KDTree(np.zeros((3, 2)))
    with pytest.raises(AssertionError):
        tree.query(np.zeros((1, 2)), k=4)
