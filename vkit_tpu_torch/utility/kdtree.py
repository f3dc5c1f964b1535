"""A k-d tree that answers ``sklearn.neighbors.KDTree``'s queries, ties
included, in numpy.

The text-region steps (pipeline/text_detection/page_text_region.py and
page_text_region_label.py) build one over region or char centers, which are
integer points, and ask for the ``k`` nearest of each query point.  On
integer points many distances tie, and which of the tied points a tree
names depends on the order in which it visits them: ``scipy``'s cKDTree,
or a stable sort by distance, names other points than sklearn's tree does
on tied queries (and so changes the labels those steps draw).  This tree is
built and walked as sklearn's (Euclidean metric, ``leaf_size=40``):

  - build: a node holds at most ``2 ** n_levels - 1`` descendants; each
    inner node splits its points at the middle index along the dimension of
    largest spread, by ``std::nth_element`` (libstdc++'s introselect) with
    the order (value, index);
  - query: depth first, the child with the smaller lower bound first (the
    left one on a tie), a node skipped when its lower bound exceeds the
    current k-th distance, each leaf's points pushed in order into a max
    heap that takes a point only if it is strictly nearer than its top;
    each row then sorted by ``sklearn.utils._sorting``'s introsort.

So each answer, distances and indices, is that of scikit-learn 1.9's
KDTree.  The tree is plain Python over numpy: ~0.1 ms a query at a few
thousand points, where sklearn's compiled tree takes ~2 us.
"""
import math

import numpy as np

_LEAF_SIZE = 40


# -- libstdc++'s std::nth_element, on a list of indices ordered by key -----

def _move_median_to_first(a, result, i, j, k, key):
    if key[a[i]] < key[a[j]]:
        if key[a[j]] < key[a[k]]:
            a[result], a[j] = a[j], a[result]
        elif key[a[i]] < key[a[k]]:
            a[result], a[k] = a[k], a[result]
        else:
            a[result], a[i] = a[i], a[result]
    elif key[a[i]] < key[a[k]]:
        a[result], a[i] = a[i], a[result]
    elif key[a[j]] < key[a[k]]:
        a[result], a[k] = a[k], a[result]
    else:
        a[result], a[j] = a[j], a[result]


def _unguarded_partition(a, first, last, pivot, key):
    pivot_key = key[a[pivot]]
    while True:
        while key[a[first]] < pivot_key:
            first += 1
        last -= 1
        while pivot_key < key[a[last]]:
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _adjust_heap(a, first, hole, length, value, key):
    top = hole
    child = hole
    while child < (length - 1) // 2:
        child = 2 * (child + 1)
        if key[a[first + child]] < key[a[first + child - 1]]:
            child -= 1
        a[first + hole] = a[first + child]
        hole = child
    if length % 2 == 0 and child == (length - 2) // 2:
        child = 2 * (child + 1)
        a[first + hole] = a[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and key[a[first + parent]] < key[value]:
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _heap_select(a, first, middle, last, key):
    length = middle - first
    if length >= 2:
        parent = (length - 2) // 2
        while True:
            _adjust_heap(a, first, parent, length, a[first + parent], key)
            if parent == 0:
                break
            parent -= 1
    for i in range(middle, last):
        if key[a[i]] < key[a[first]]:
            value = a[i]
            a[i] = a[first]
            _adjust_heap(a, first, 0, length, value, key)


def _insertion_sort(a, first, last, key):
    for i in range(first + 1, last):
        value = a[i]
        j = i
        while j > first and key[value] < key[a[j - 1]]:
            a[j] = a[j - 1]
            j -= 1
        a[j] = value


def _nth_element(a, first, nth, last, key):
    if first == last or nth == last:
        return
    depth_limit = 2 * ((last - first).bit_length() - 1)
    while last - first > 3:
        if depth_limit == 0:
            _heap_select(a, first, nth + 1, last, key)
            a[first], a[nth] = a[nth], a[first]
            return
        depth_limit -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(a, first, first + 1, mid, last - 1, key)
        cut = _unguarded_partition(a, first + 1, last, first, key)
        if cut <= nth:
            first = cut
        else:
            last = cut
    _insertion_sort(a, first, last, key)


# -- sklearn's heap_push and simultaneous_sort ------------------------------

def _heap_push(values, indices, value, index):
    size = len(values)
    if value >= values[0]:
        return
    current = 0
    while True:
        left = 2 * current + 1
        right = left + 1
        if left >= size:
            break
        if right >= size:
            if values[left] > value:
                swap = left
            else:
                break
        elif values[left] >= values[right]:
            if value < values[left]:
                swap = left
            else:
                break
        elif value < values[right]:
            swap = right
        else:
            break
        values[current] = values[swap]
        indices[current] = indices[swap]
        current = swap
    values[current] = value
    indices[current] = index


def _swap(values, indices, i, j):
    values[i], values[j] = values[j], values[i]
    indices[i], indices[j] = indices[j], indices[i]


def _simultaneous_sort(values, indices, lo, n, maxd):
    """sklearn.utils._sorting's introsort_2way on values[lo:lo + n]."""
    while n > 15:
        if maxd <= 0:
            _heapsort(values, indices, lo, n)
            return
        maxd -= 1
        # Median of three: the smallest to the front, the pivot to the
        # back, the largest to the middle.
        mid, last = lo + n // 2, lo + n - 1
        if values[lo] > values[last]:
            _swap(values, indices, lo, last)
        if values[last] > values[mid]:
            _swap(values, indices, last, mid)
            if values[lo] > values[last]:
                _swap(values, indices, lo, last)
        pivot = values[last]
        i, j = lo + 1, lo + n - 2
        while True:
            while i <= j and values[i] < pivot:
                i += 1
            while i <= j and values[j] > pivot:
                j -= 1
            if i >= j:
                break
            _swap(values, indices, i, j)
            i += 1
            j -= 1
        _swap(values, indices, i, last)
        _simultaneous_sort(values, indices, lo, i - lo, maxd)
        n -= i - lo + 1
        lo = i + 1
    for i in range(lo + 1, lo + n):
        value, index = values[i], indices[i]
        j = i
        while j > lo and values[j - 1] > value:
            values[j] = values[j - 1]
            indices[j] = indices[j - 1]
            j -= 1
        values[j] = value
        indices[j] = index


def _sift_down(values, indices, lo, start, end):
    root = start
    while True:
        child = root * 2 + 1
        top = root
        if child < end and values[lo + top] < values[lo + child]:
            top = child
        if child + 1 < end and values[lo + top] < values[lo + child + 1]:
            top = child + 1
        if top == root:
            return
        _swap(values, indices, lo + root, lo + top)
        root = top


def _heapsort(values, indices, lo, n):
    start = (n - 2) // 2
    while True:
        _sift_down(values, indices, lo, start, n)
        if start == 0:
            break
        start -= 1
    end = n - 1
    while end > 0:
        _swap(values, indices, lo, lo + end)
        _sift_down(values, indices, lo, 0, end)
        end -= 1


class KDTree:

    def __init__(self, points):
        data = np.asarray(points, dtype=np.float64)
        assert data.ndim == 2 and len(data), 'a non-empty (n, d) array'
        count = len(data)
        self._data = data
        n_levels = int(math.log2(max(1.0, (count - 1) / _LEAF_SIZE)) + 1)
        self._n_nodes = 2 ** n_levels - 1
        self._lo = np.empty((self._n_nodes, data.shape[1]))
        self._hi = np.empty((self._n_nodes, data.shape[1]))
        self._span = [(0, 0)] * self._n_nodes
        self._leaf = [True] * self._n_nodes
        # The order of each dimension: (value, index), a total order.
        self._keys = [list(zip(column, range(count)))
                      for column in data.T.tolist()]
        order = list(range(count))
        self._build(order, 0, 0, count)
        self._order = np.asarray(order, dtype=np.int64)

    def _build(self, order, node, start, end):
        members = self._data[order[start:end]]
        self._lo[node] = members.min(axis=0)
        self._hi[node] = members.max(axis=0)
        self._span[node] = (start, end)
        if 2 * node + 1 >= self._n_nodes or end - start < 2:
            return
        self._leaf[node] = False
        # The first dimension of largest spread.
        dim = int(np.argmax(self._hi[node] - self._lo[node]))
        mid = (end - start) // 2
        _nth_element(order, start, start + mid, end, self._keys[dim])
        self._build(order, 2 * node + 1, start, start + mid)
        self._build(order, 2 * node + 2, start + mid, end)

    def _lower_bound(self, node, point):
        d_lo = self._lo[node] - point
        d_hi = point - self._hi[node]
        d = (d_lo + np.abs(d_lo)) + (d_hi + np.abs(d_hi))
        return float(((0.5 * d) ** 2).sum())

    def _leaves(self, point, largest):
        """The leaves a depth-first query visits, in order, as (start,
        end); ``largest()`` is the heap's current top."""
        stack = [(0, self._lower_bound(0, point))]
        while stack:
            node, bound = stack.pop()
            if bound > largest():
                continue
            if self._leaf[node]:
                yield self._span[node]
                continue
            left, right = 2 * node + 1, 2 * node + 2
            bound_left = self._lower_bound(left, point)
            bound_right = self._lower_bound(right, point)
            if bound_left <= bound_right:
                stack += [(right, bound_right), (left, bound_left)]
            else:
                stack += [(left, bound_left), (right, bound_right)]

    def _rdist(self, point, start, end):
        delta = self._data[self._order[start:end]] - point
        return (delta * delta).sum(axis=1)

    def query(self, points, k: int = 1):
        """(dist (n, k) float64, ind (n, k) int64): the ``k`` nearest
        indexed points of each query point, nearest first."""
        count = len(self._data)
        assert 1 <= k <= count, f'k={k} outside [1, {count}]'
        points = np.asarray(points, dtype=np.float64).reshape(
            -1, self._data.shape[1]
        )
        dist = np.empty((len(points), k))
        ind = np.empty((len(points), k), dtype=np.int64)
        for row, point in enumerate(points):
            values = [math.inf] * k
            indices = [0] * k
            for start, end in self._leaves(point, lambda: values[0]):
                rdist = self._rdist(point, start, end)
                if k == 1:
                    # Sequential strict pushes keep the leaf's first
                    # minimum, if it beats the top.
                    at = int(np.argmin(rdist))
                    if rdist[at] < values[0]:
                        values[0] = float(rdist[at])
                        indices[0] = int(self._order[start + at])
                    continue
                for at, value in enumerate(rdist.tolist()):
                    _heap_push(values, indices, value,
                               int(self._order[start + at]))
            _simultaneous_sort(values, indices, 0, k,
                               2 * int(math.log2(k)))
            dist[row] = values
            ind[row] = indices
        return np.sqrt(dist), ind
