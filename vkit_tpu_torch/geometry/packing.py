"""2-D rectangle packing (shelf algorithm).

Capability parity: the rectpack usage at vkit/pipeline/text_detection/
page_text_region.py:748-858 (single-bin packing of flattened text regions).
Shelf-next-fit-decreasing-height: sort by height, fill rows left-to-right.
"""
from typing import List, Sequence, Tuple


def pack_rectangles(
    sizes: Sequence[Tuple[int, int]],
    bin_width: int,
) -> List[Tuple[int, int]]:
    """Pack (width, height) rects into a bin of ``bin_width``; returns
    (x, y) per input rect (input order preserved)."""
    order = sorted(range(len(sizes)), key=lambda idx: sizes[idx][1], reverse=True)

    placements: List[Tuple[int, int]] = [(0, 0)] * len(sizes)
    shelf_y = 0
    shelf_height = 0
    cursor_x = 0

    for idx in order:
        width, height = sizes[idx]
        if cursor_x + width > bin_width and cursor_x > 0:
            # Open a new shelf.
            shelf_y += shelf_height
            shelf_height = 0
            cursor_x = 0
        placements[idx] = (cursor_x, shelf_y)
        cursor_x += width
        shelf_height = max(shelf_height, height)

    return placements


class PolygonBoxIndex:
    """Bounding-box candidate index over polygons (STRtree query parity for
    the intersection-candidate use cases in the reference)."""

    def __init__(self, polygons):
        import numpy as np

        self.polygons = tuple(polygons)
        if self.polygons:
            self.np_bounds = np.asarray(
                [
                    (
                        polygon.bounding_box.up,
                        polygon.bounding_box.down,
                        polygon.bounding_box.left,
                        polygon.bounding_box.right,
                    )
                    for polygon in self.polygons
                ],
                dtype=np.int64,
            )
        else:
            self.np_bounds = None

    def query(self, polygon) -> List[int]:
        if self.np_bounds is None:
            return []
        box = polygon.bounding_box
        ups, downs, lefts, rights = self.np_bounds.T
        hit = (
            (ups <= box.down) & (box.up <= downs)
            & (lefts <= box.right) & (box.left <= rights)
        )
        import numpy as np

        return [int(idx) for idx in np.nonzero(hit)[0]]
