"""Host-side computational geometry backend.

Prefers the first-party C++ implementation (vkit_tpu/native, via ctypes) for
the hot entry points; falls back to the numpy implementation transparently.
"""
from ._numpy_impl import (
    convex_hull,
    disconnected_components,
    external_contours,
    fill_poly,
    fill_polys,
    min_area_rect,
    offset_polygon,
    point_in_polygon,
    polygon_area,
    polygon_centroid,
    polygon_perimeter,
    polygon_signed_area,
    polygons_intersect_area,
    unionize_polygons_raster,
)

import types as _types

from . import _numpy_impl as _py_impl

# Snapshot of the pure-python kernels (parity tests pin native against
# these; the module-level names may be rebound to native below).
pure = _types.SimpleNamespace(
    fill_poly=_py_impl.fill_poly,
    external_contours=_py_impl.external_contours,
    disconnected_components=_py_impl.disconnected_components,
)

try:  # pragma: no cover - exercised when the native lib is built.
    from . import _native  # noqa: F401
    from ._native import fill_poly, external_contours, disconnected_components  # type: ignore  # noqa: F811,E501
    HAS_NATIVE = True
    # Rebind inside _numpy_impl too, so its higher-level routines
    # (unionize_polygons_raster, offset_polygon, ...) ride the native
    # kernels as well.
    _py_impl.fill_poly = fill_poly
    _py_impl.external_contours = external_contours
    _py_impl.disconnected_components = disconnected_components
except Exception:  # noqa: BLE001
    HAS_NATIVE = False
