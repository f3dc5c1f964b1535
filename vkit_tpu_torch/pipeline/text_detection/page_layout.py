"""Page layout sampler: grid cells filled with text lines, plus images,
barcodes placed beside text, non-text symbols, seal impressions, and the
disconnected/negative regions used for labeling.

Behavioral spec: vkit/pipeline/text_detection/page_layout.py:31-1399
(re-derived; one axis-interval sampler serves both directions, a
GridSplitter struct owns the segment queue, and box placement shares two
helpers across images/symbols/seals/barcodes).
"""
import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box, BoxOverlappingValidator, Polygon
from ...engine.font import FontEngineRunConfigGlyphSequence
from ...utility import normalize_to_probs, rng_choice
from ..interface import PipelineStep, PipelineStepFactory
from .page_shape import PageShapeStepOutput


@attr.define
class PageLayoutStepConfig:
    # Text line heights.
    reference_aspect_ratio: float = 1 / 1.4142

    # Grid points.
    grid_pad_ratio_min: float = 0.01
    grid_pad_ratio_max: float = 0.05
    grid_step_ratio_min: float = 1.0
    grid_step_ratio_max: float = 1.1
    grid_vert_gap_ratio_min: float = 0.0
    grid_vert_gap_ratio_max: float = 0.5
    grid_hori_gap_ratio_min: float = 1.0
    grid_hori_gap_ratio_max: float = 1.15

    # Large text line.
    prob_add_large_text_line: float = 0.25
    large_text_line_height_ratio_min: float = 0.05
    large_text_line_height_ratio_max: float = 0.075
    large_text_line_length_ratio_min: float = 0.5
    large_text_line_length_ratio_max: float = 1.0

    # Normal text lines.
    num_normal_text_line_heights_min: int = 2
    num_normal_text_line_heights_max: int = 4
    normal_text_line_height_ratio_min: float = 0.006
    normal_text_line_height_ratio_max: float = 0.036
    force_add_normal_text_line_height_ratio_min: bool = True

    # Non-text symbols.
    num_non_text_symbols_min: int = 0
    num_non_text_symbols_max: int = 5
    num_retries_to_get_non_overlapped_non_text_symbol: int = 5
    non_text_symbol_height_ratio_min: float = 0.018
    non_text_symbol_height_ratio_max: float = 0.064
    non_text_symbol_aspect_ratio_min: float = 0.9
    non_text_symbol_aspect_ratio_max: float = 1.111
    non_text_symbol_non_overlapped_alpha_min: float = 0.8
    non_text_symbol_non_overlapped_alpha_max: float = 1.0
    non_text_symbol_overlapped_alpha_min: float = 0.15
    non_text_symbol_overlapped_alpha_max: float = 0.55

    prob_normal_text_line_diff_heights_gap: float = 0.5
    prob_normal_text_line_gap: float = 0.5
    normal_text_line_gap_ratio_min: float = 0.05
    normal_text_line_gap_ratio_max: float = 1.25
    normal_text_line_length_ratio_min: float = 0.5
    normal_text_line_length_ratio_max: float = 1.0

    # Images.
    num_images_min: int = 0
    num_images_max: int = 3
    image_height_ratio_min: float = 0.1
    image_height_ratio_max: float = 0.35
    image_width_ratio_min: float = 0.1
    image_width_ratio_max: float = 0.35

    # Barcode (qr).
    num_barcode_qrs_min: int = 0
    num_barcode_qrs_max: int = 2
    barcode_qr_length_ratio_min: float = 0.05
    barcode_qr_length_ratio_max: float = 0.15

    # Barcode (code39).
    num_barcode_code39s_min: int = 0
    num_barcode_code39s_max: int = 2
    barcode_code39_height_ratio_min: float = 0.025
    barcode_code39_height_ratio_max: float = 0.05
    barcode_code39_aspect_ratio: float = 0.2854396602149411
    barcode_code39_num_chars_min: int = 9
    barcode_code39_num_chars_max: int = 13

    # Seal impressions.
    num_seal_impressions_min: int = 1
    num_seal_impressions_max: int = 3
    seal_impression_angle_min: int = -45
    seal_impression_angle_max: int = 45
    seal_impression_height_ratio_min: float = 0.1
    seal_impression_height_ratio_max: float = 0.2
    seal_impression_weight_circle: float = 1
    seal_impression_weight_general_ellipse: float = 1
    seal_impression_general_ellipse_aspect_ratio_min: float = 0.75
    seal_impression_general_ellipse_aspect_ratio_max: float = 1.333

    # For char-level polygon regression.
    disconnected_text_region_polygons_height_ratio_max: float = 2.0


@attr.define
class PageLayoutStepInput:
    page_shape_step_output: PageShapeStepOutput


@attr.define
class LayoutTextLine:
    # grid_idx == -1 marks the large text line.
    grid_idx: int
    text_line_idx: int
    text_line_height: int
    box: Box
    glyph_sequence: FontEngineRunConfigGlyphSequence


@attr.define
class LayoutNonTextSymbol:
    box: Box
    alpha: float


@attr.define
class LayoutSealImpression:
    box: Box
    angle: int


@attr.define
class LayoutImage:
    box: Box


@attr.define
class LayoutBarcodeQr:
    box: Box


@attr.define
class LayoutBarcodeCode39:
    box: Box


@attr.define
class DisconnectedTextRegion:
    polygon: Polygon


@attr.define
class NonTextRegion:
    polygon: Polygon


@attr.define
class PageLayout:
    height: int
    width: int
    layout_text_lines: Sequence[LayoutTextLine]
    layout_non_text_symbols: Sequence[LayoutNonTextSymbol]
    layout_seal_impressions: Sequence[LayoutSealImpression]
    layout_images: Sequence[LayoutImage]
    layout_barcode_qrs: Sequence[LayoutBarcodeQr]
    layout_barcode_code39s: Sequence[LayoutBarcodeCode39]
    disconnected_text_regions: Sequence[DisconnectedTextRegion]
    non_text_regions: Sequence[NonTextRegion]


@attr.define
class PageLayoutStepOutput:
    page_layout: PageLayout
    debug_large_text_line_gird: Optional[Box]
    debug_grids: Sequence[Box]


# ----------------------------------------------------------------------------
# Grid machinery.
# ----------------------------------------------------------------------------

def sample_axis_intervals(
    pad_ratio: float,
    step: int,
    gap_max: int,
    gap_min: Optional[int],
    length: int,
    rng: RandomGenerator,
) -> Tuple[List[int], List[int]]:
    """Evenly stepped [begin, end] intervals along one axis.

    The pad is recomputed so the intervals center; a per-interval random
    gap in [gap_min, gap_max] applies when gap_min is given.
    """
    pad = min(length - step, length * pad_ratio)
    assert pad > 0

    count = (length - pad + gap_max) / (step + gap_max)
    count = int(count) if float(count).is_integer() else math.floor(count)
    pad = (length - step * count - gap_max * (count - 1)) // 2
    assert pad > 0

    begins: List[int] = []
    ends: List[int] = []
    begin = pad
    while begin + step - 1 < length - pad:
        begins.append(begin)
        ends.append(begin + step - 1)
        gap = gap_max if gap_min is None else int(rng.integers(gap_min, gap_max + 1))
        begin = begins[-1] + step + gap
    return begins, ends


class GridSplitter:
    """Recursive random subdivision of the grid-cell index plane.

    A segment is (row_idx, col_begin_idx, col_end_idx); the lowest rows
    split first, horizontally adjacent same-row segments merge, and each
    split emits one grid box spanning random row/column extents.
    """

    def __init__(self, num_rows: int, num_cols: int):
        self.num_rows = num_rows
        self._heap: List[Tuple[int, int, int]] = [(0, 0, num_cols - 1)]

    def _pop_merged(self) -> Tuple[int, int, int]:
        row, lo, hi = heapq.heappop(self._heap)
        peers = []
        while self._heap and self._heap[0][0] == row:
            peers.append(heapq.heappop(self._heap))
        if peers:
            spans = sorted(peers + [(row, lo, hi)], key=lambda s: s[1])
            runs: List[Tuple[int, int, int]] = []
            i = 0
            while i < len(spans):
                j = i
                while j + 1 < len(spans) and spans[j + 1][1] == spans[j][2] + 1:
                    j += 1
                runs.append((row, spans[i][1], spans[j][2]))
                i = j + 1
            row, lo, hi = runs[0]
            for run in runs[1:]:
                heapq.heappush(self._heap, run)
        return row, lo, hi

    def split(self, rng: RandomGenerator):
        """Yields (row_begin, row_end, col_begin, col_end) index spans."""
        while self._heap:
            row, col, col_end = self._pop_merged()
            while col <= col_end:
                row_end = int(rng.integers(row, self.num_rows))
                if col_end - col + 1 <= 3:
                    span_end = col_end
                else:
                    span_end = int(rng.integers(col + 1, col_end + 1))
                yield row, row_end, col, span_end
                if row_end + 1 < self.num_rows:
                    heapq.heappush(self._heap, (row_end + 1, col, span_end))
                col = span_end + 1


class BalancedHeights:
    """Area-balanced text-line height sampling: under-represented heights
    (relative to inverse-height expected shares) draw more often."""

    def __init__(self, heights: Sequence[int]):
        self.heights = list(heights)
        self.expected = normalize_to_probs([1 / h for h in heights])
        self.areas = [0] * len(heights)

    def pick(self, rng: RandomGenerator) -> Tuple[int, int]:
        if sum(self.areas) == 0:
            observed = [0.0] * len(self.areas)
        else:
            observed = normalize_to_probs(self.areas)
        probs = normalize_to_probs([
            max(0.0, want - got) for got, want in zip(observed, self.expected)
        ])
        idx = rng_choice(rng, list(range(len(self.heights))), probs=probs)
        return idx, self.heights[idx]

    def account(self, idx: int, area: int) -> None:
        self.areas[idx] += area


def _boxes_overlap(a: Box, b: Box) -> bool:
    return (a.down >= b.up and b.down >= a.up
            and a.right >= b.left and b.right >= a.left)


def _random_box_within(bounds: Box, box_height: int, box_width: int,
                       rng: RandomGenerator) -> Box:
    up = int(rng.integers(bounds.up, bounds.down + 1 - box_height + 1))
    left = int(rng.integers(bounds.left, bounds.right + 1 - box_width + 1))
    return Box(up, up + box_height - 1, left, left + box_width - 1)


class PageLayoutStep(
    PipelineStep[PageLayoutStepConfig, PageLayoutStepInput, PageLayoutStepOutput]
):

    # ------------------------------------------------------------------
    # Text lines.
    # ------------------------------------------------------------------

    def get_reference_height(self, height: int, width: int) -> int:
        return math.ceil(
            math.sqrt(height * width / self.config.reference_aspect_ratio)
        )

    def _sample_heights(self, reference_height: int, rng: RandomGenerator
                        ) -> List[int]:
        cfg = self.config
        heights: List[int] = []
        if cfg.force_add_normal_text_line_height_ratio_min:
            heights.append(
                round(cfg.normal_text_line_height_ratio_min * reference_height)
            )
        count = int(rng.integers(cfg.num_normal_text_line_heights_min,
                                 cfg.num_normal_text_line_heights_max + 1))
        span = (cfg.normal_text_line_height_ratio_max
                - cfg.normal_text_line_height_ratio_min) / count
        for i in range(count):
            lo = cfg.normal_text_line_height_ratio_min + i * span
            heights.append(round(rng.uniform(lo, lo + span) * reference_height))
        assert heights
        return sorted(heights)

    def _sample_axes(self, height: int, width: int, line_height_max: int,
                     rng: RandomGenerator):
        cfg = self.config
        pad_ratio = rng.uniform(cfg.grid_pad_ratio_min, cfg.grid_pad_ratio_max)
        step = round(line_height_max * rng.uniform(cfg.grid_step_ratio_min,
                                                   cfg.grid_step_ratio_max))
        vert = sample_axis_intervals(
            pad_ratio, step,
            gap_max=round(line_height_max * cfg.grid_vert_gap_ratio_max),
            gap_min=round(line_height_max * cfg.grid_vert_gap_ratio_min),
            length=height, rng=rng,
        )
        hori_gap = max(
            line_height_max,
            round(line_height_max * rng.uniform(cfg.grid_hori_gap_ratio_min,
                                                cfg.grid_hori_gap_ratio_max)),
        )
        hori = sample_axis_intervals(
            pad_ratio, step, gap_max=hori_gap, gap_min=None,
            length=width, rng=rng,
        )
        return vert, hori

    def _carve_large_text_line_band(self, band_height: int,
                                    vert: Tuple[List[int], List[int]],
                                    hori_left: int, hori_right: int):
        """Reserve the topmost rows tall enough for the large line."""
        vert_begins, vert_ends = vert
        idx = 0
        while idx < len(vert_begins) \
                and vert_ends[idx] + 1 - vert_begins[0] < band_height:
            idx += 1
        if idx >= len(vert_begins) - 1:
            return None, 0
        band = Box(vert_ends[idx] - band_height + 1, vert_ends[idx],
                   hori_left, hori_right)
        return band, idx + 1

    def _fill_grid(self, grid_idx: int, grid: Box, picker: BalancedHeights,
                   rng: RandomGenerator) -> List[LayoutTextLine]:
        cfg = self.config
        out: List[LayoutTextLine] = []
        cursor = grid.up
        prev_height: Optional[int] = None
        tallest = max(picker.heights)

        while cursor + tallest - 1 <= grid.down:
            idx, line_height = picker.pick(rng)

            # Optional vertical gap, more likely between equal heights.
            if prev_height:
                prob = (cfg.prob_normal_text_line_gap
                        if prev_height == line_height
                        else cfg.prob_normal_text_line_diff_heights_gap)
                if rng.random() < prob:
                    gap = round(rng.uniform(cfg.normal_text_line_gap_ratio_min,
                                            cfg.normal_text_line_gap_ratio_max)
                                * line_height)
                    cursor += min(grid.down - (cursor + line_height - 1), gap)
            down = cursor + line_height - 1
            assert down <= grid.down

            length = max(line_height, round(
                grid.width * rng.uniform(cfg.normal_text_line_length_ratio_min,
                                         cfg.normal_text_line_length_ratio_max)
            ))
            left = grid.left + int(rng.integers(0, grid.width - length + 1))
            box = Box(cursor, down, left, left + length - 1)
            assert box.right <= grid.right

            out.append(LayoutTextLine(
                grid_idx=grid_idx,
                text_line_idx=len(out),
                text_line_height=line_height,
                box=box,
                glyph_sequence=FontEngineRunConfigGlyphSequence.HORI_DEFAULT,
            ))
            picker.account(idx, length * line_height)
            prev_height = line_height
            cursor = down + 1
        return out

    def sample_layout_text_lines(self, height: int, width: int,
                                 rng: RandomGenerator):
        cfg = self.config
        reference_height = self.get_reference_height(height, width)
        heights = self._sample_heights(reference_height, rng)
        (vert_begins, vert_ends), (hori_begins, hori_ends) = self._sample_axes(
            height, width, heights[-1], rng
        )

        large_band: Optional[Box] = None
        if rng.random() < cfg.prob_add_large_text_line:
            band_height = round(
                rng.uniform(cfg.large_text_line_height_ratio_min,
                            cfg.large_text_line_height_ratio_max)
                * reference_height
            )
            large_band, trim = self._carve_large_text_line_band(
                band_height, (vert_begins, vert_ends),
                hori_begins[0], hori_ends[-1],
            )
            if large_band is not None:
                vert_begins = vert_begins[trim:]
                vert_ends = vert_ends[trim:]

        splitter = GridSplitter(len(vert_ends), len(hori_ends))
        grids = [
            Box(vert_begins[r0], vert_ends[r1], hori_begins[c0], hori_ends[c1])
            for r0, r1, c0, c1 in splitter.split(rng)
        ]

        picker = BalancedHeights(heights)
        text_lines: List[LayoutTextLine] = []
        for grid_idx, grid in enumerate(grids):
            text_lines.extend(self._fill_grid(grid_idx, grid, picker, rng))

        if large_band:
            length = max(large_band.height, round(
                large_band.width * rng.uniform(cfg.large_text_line_length_ratio_min,
                                               cfg.large_text_line_length_ratio_max)
            ))
            left = large_band.left + int(
                rng.integers(0, large_band.width - length + 1)
            )
            text_lines.append(LayoutTextLine(
                grid_idx=-1,
                text_line_idx=0,
                text_line_height=large_band.height,
                box=large_band._replace(left=left, right=left + length - 1),
                glyph_sequence=FontEngineRunConfigGlyphSequence.HORI_DEFAULT,
            ))

        assert text_lines
        return text_lines, large_band, grids

    # ------------------------------------------------------------------
    # Images / symbols / seals.
    # ------------------------------------------------------------------

    def sample_layout_images(self, height: int, width: int,
                             rng: RandomGenerator) -> List[LayoutImage]:
        cfg = self.config
        page = Box.from_shape((height, width))
        count = int(rng.integers(cfg.num_images_min, cfg.num_images_max + 1))
        out: List[LayoutImage] = []
        for _ in range(count):
            # Overlapping photos are acceptable.
            h = round(height * rng.uniform(cfg.image_height_ratio_min,
                                           cfg.image_height_ratio_max))
            w = round(width * rng.uniform(cfg.image_width_ratio_min,
                                          cfg.image_width_ratio_max))
            out.append(LayoutImage(box=_random_box_within(page, h, w, rng)))
        return out

    def sample_layout_non_text_symbols(
        self, height: int, width: int,
        layout_text_lines: Sequence[LayoutTextLine],
        rng: RandomGenerator,
    ) -> List[LayoutNonTextSymbol]:
        cfg = self.config
        reference_height = self.get_reference_height(height, width)
        page = Box.from_shape((height, width))

        out: List[LayoutNonTextSymbol] = []
        count = int(rng.integers(cfg.num_non_text_symbols_min,
                                 cfg.num_non_text_symbols_max + 1))
        for _ in range(count):
            h = round(reference_height * rng.uniform(
                cfg.non_text_symbol_height_ratio_min,
                cfg.non_text_symbol_height_ratio_max,
            ))
            w = round(h * rng.uniform(cfg.non_text_symbol_aspect_ratio_min,
                                      cfg.non_text_symbol_aspect_ratio_max))

            box = None
            clear_of_text = False
            for _ in range(cfg.num_retries_to_get_non_overlapped_non_text_symbol):
                box = _random_box_within(page, h, w, rng)
                if not any(_boxes_overlap(box, ltl.box)
                           for ltl in layout_text_lines):
                    clear_of_text = True
                    break
            assert box
            # Overlapping symbols fade out so text stays legible.
            alpha_lo, alpha_hi = (
                (cfg.non_text_symbol_non_overlapped_alpha_min,
                 cfg.non_text_symbol_non_overlapped_alpha_max)
                if clear_of_text else
                (cfg.non_text_symbol_overlapped_alpha_min,
                 cfg.non_text_symbol_overlapped_alpha_max)
            )
            out.append(LayoutNonTextSymbol(
                box=box, alpha=float(rng.uniform(alpha_lo, alpha_hi))
            ))
        return out

    def sample_layout_seal_impressions(
        self, height: int, width: int,
        layout_text_lines: Sequence[LayoutTextLine],
        rng: RandomGenerator,
    ) -> List[LayoutSealImpression]:
        cfg = self.config
        reference_height = self.get_reference_height(height, width)
        # Seals land on the text-covered area.
        text_area = Box(
            min(ltl.box.up for ltl in layout_text_lines),
            max(ltl.box.down for ltl in layout_text_lines),
            min(ltl.box.left for ltl in layout_text_lines),
            max(ltl.box.right for ltl in layout_text_lines),
        )
        prob_circle = normalize_to_probs([
            cfg.seal_impression_weight_circle,
            cfg.seal_impression_weight_general_ellipse,
        ])[0]

        out: List[LayoutSealImpression] = []
        count = int(rng.integers(cfg.num_seal_impressions_min,
                                 cfg.num_seal_impressions_max + 1))
        for _ in range(count):
            seal_h = round(reference_height * rng.uniform(
                cfg.seal_impression_height_ratio_min,
                cfg.seal_impression_height_ratio_max,
            ))
            seal_h = min(text_area.height, seal_h)
            seal_h -= seal_h % 2  # Even sizes center exactly.

            if rng.random() < prob_circle:
                seal_w = seal_h
            else:
                seal_w = round(seal_h * rng.uniform(
                    cfg.seal_impression_general_ellipse_aspect_ratio_min,
                    cfg.seal_impression_general_ellipse_aspect_ratio_max,
                ))
            seal_w = min(text_area.width, seal_w)
            seal_w -= seal_w % 2

            out.append(LayoutSealImpression(
                box=_random_box_within(text_area, seal_h, seal_w, rng),
                angle=int(rng.integers(cfg.seal_impression_angle_min,
                                       cfg.seal_impression_angle_max + 1)) % 360,
            ))
        return out

    # ------------------------------------------------------------------
    # Barcodes beside text lines.
    # ------------------------------------------------------------------

    def _beside_text_line(self, height: int, width: int,
                          box_height: int, box_width: int,
                          layout_text_lines: Sequence[LayoutTextLine],
                          rng: RandomGenerator) -> Optional[Box]:
        """A box touching a random text line on a random side, slid along
        that side around the anchor's center."""
        anchor = rng_choice(rng, layout_text_lines).box
        center = anchor.get_center_point()
        side = rng_choice(rng, ('up', 'down', 'left', 'right'))

        if side in ('up', 'down'):
            up = anchor.down + 1 if side == 'down' else anchor.up - box_height
            if up < 0 or up + box_height > height:
                return None
            slide_lo = max(0, center.x - box_width)
            slide_hi = min(width - box_width, center.x)
            if slide_lo > slide_hi:
                return None
            left = int(rng.integers(slide_lo, slide_hi + 1))
        else:
            left = anchor.right + 1 if side == 'right' else anchor.left - box_width
            if left < 0 or left + box_width > width:
                return None
            slide_lo = max(0, center.y - box_height)
            slide_hi = min(height - box_height, center.y)
            if slide_lo > slide_hi:
                return None
            up = int(rng.integers(slide_lo, slide_hi + 1))
        return Box(up, up + box_height - 1, left, left + box_width - 1)

    def _sample_barcodes(self, height: int, width: int, layout_text_lines,
                         rng: RandomGenerator):
        cfg = self.config
        reference_height = self.get_reference_height(height, width)

        def place_all(count: int, sample_shape) -> List[Box]:
            boxes: List[Box] = []
            retries = 3
            while count > 0 and retries > 0:
                bh, bw = sample_shape()
                box = self._beside_text_line(
                    height, width, bh, bw, layout_text_lines, rng
                )
                if box is None:
                    retries -= 1
                    continue
                boxes.append(box)
                count -= 1
            return boxes

        def qr_shape():
            side = round(reference_height * rng.uniform(
                cfg.barcode_qr_length_ratio_min, cfg.barcode_qr_length_ratio_max
            ))
            side = min(height, width, side)
            return side, side

        def code39_shape():
            bh = round(reference_height * rng.uniform(
                cfg.barcode_code39_height_ratio_min,
                cfg.barcode_code39_height_ratio_max,
            ))
            bh = min(height, width, bh)
            chars = int(rng.integers(cfg.barcode_code39_num_chars_min,
                                     cfg.barcode_code39_num_chars_max + 1))
            return bh, round(bh * cfg.barcode_code39_aspect_ratio * chars)

        qrs = [LayoutBarcodeQr(box=b) for b in place_all(
            int(rng.integers(cfg.num_barcode_qrs_min, cfg.num_barcode_qrs_max + 1)),
            qr_shape,
        )]
        code39s = [LayoutBarcodeCode39(box=b) for b in place_all(
            int(rng.integers(cfg.num_barcode_code39s_min,
                             cfg.num_barcode_code39s_max + 1)),
            code39_shape,
        )]

        if qrs or code39s:
            # Barcodes must not overlap text: drop overlapped text lines.
            validator = BoxOverlappingValidator(
                itertools.chain((q.box for q in qrs), (c.box for c in code39s))
            )
            layout_text_lines = [
                ltl for ltl in layout_text_lines
                if not validator.is_overlapped(ltl.box)
            ]
        return qrs, code39s, layout_text_lines

    # ------------------------------------------------------------------
    # Labeling regions.
    # ------------------------------------------------------------------

    def generate_disconnected_text_regions(
        self, layout_text_lines: Sequence[LayoutTextLine],
    ) -> List[DisconnectedTextRegion]:
        """Consecutive in-grid runs whose height spread stays bounded merge
        into one stepped boundary polygon."""
        by_grid: Dict[int, List[LayoutTextLine]] = {}
        for ltl in layout_text_lines:
            by_grid.setdefault(ltl.grid_idx, []).append(ltl)

        ratio_max = self.config.disconnected_text_region_polygons_height_ratio_max
        out: List[DisconnectedTextRegion] = []
        for grid_idx in sorted(by_grid):
            lines = sorted(by_grid[grid_idx], key=lambda ltl: ltl.text_line_idx)
            begin = 0
            while begin < len(lines):
                h_min = h_max = lines[begin].text_line_height
                end = begin + 1
                while end < len(lines):
                    h = lines[end].text_line_height
                    h_min, h_max = min(h_min, h), max(h_max, h)
                    if h_max / h_min > ratio_max:
                        break
                    end += 1
                run = lines[begin:end]
                bounding = Box.from_boxes(ltl.box for ltl in run)
                step = min(min(ltl.box.shape) for ltl in run)
                # Tiny pages can yield 1-px-thin runs whose bounding box is
                # degenerate (no polygon); a zero-area region carries no
                # information, so skip it (the reference never hits this —
                # its fixed 2522^2 page area keeps lines >= 2 px tall).
                if bounding.up < bounding.down and bounding.left < bounding.right:
                    out.append(DisconnectedTextRegion(
                        polygon=bounding.to_polygon(step=step)
                    ))
                begin = end
        return out

    def generate_non_text_regions(
        self, height: int, width: int,
        layout_text_lines: Sequence[LayoutTextLine],
        rng: RandomGenerator,
    ) -> List[NonTextRegion]:
        """Mirror each text line box into an adjacent empty spot."""
        validator = BoxOverlappingValidator(
            ltl.box for ltl in layout_text_lines
        )

        def mirrored(box: Box, side: str) -> Box:
            if side == 'up':
                return box.to_shifted_box(offset_y=-box.height)
            if side == 'down':
                return box.to_shifted_box(offset_y=box.height)
            if side == 'left':
                return box.to_shifted_box(offset_x=-box.width)
            return box.to_shifted_box(offset_x=box.width)

        sides = ('up', 'down', 'left', 'right')
        found: List[Box] = []
        for ltl in layout_text_lines:
            for side_idx in rng.permutation(len(sides)):
                candidate = mirrored(ltl.box, sides[int(side_idx)])
                if not candidate.valid:
                    continue
                if candidate.down >= height or candidate.right >= width:
                    continue
                if validator.is_overlapped(candidate):
                    continue
                found.append(candidate)
                break

        # 1-px-thin mirrors (tiny pages) have no polygon form; drop them.
        found = [box for box in found
                 if box.up < box.down and box.left < box.right]
        if not found:
            return []
        step = max(1, min(min(box.shape) for box in found))
        return [NonTextRegion(polygon=box.to_polygon(step=step)) for box in found]

    def run(self, input: PageLayoutStepInput, rng: RandomGenerator):
        height = input.page_shape_step_output.height
        width = input.page_shape_step_output.width

        text_lines, large_band, grids = self.sample_layout_text_lines(
            height, width, rng
        )
        images = self.sample_layout_images(height, width, rng)
        qrs, code39s, text_lines = self._sample_barcodes(
            height, width, text_lines, rng
        )
        symbols = self.sample_layout_non_text_symbols(height, width, text_lines, rng)
        seals = self.sample_layout_seal_impressions(height, width, text_lines, rng)

        return PageLayoutStepOutput(
            page_layout=PageLayout(
                height=height,
                width=width,
                layout_text_lines=text_lines,
                layout_non_text_symbols=symbols,
                layout_seal_impressions=seals,
                layout_images=images,
                layout_barcode_qrs=qrs,
                layout_barcode_code39s=code39s,
                disconnected_text_regions=self.generate_disconnected_text_regions(
                    text_lines
                ),
                non_text_regions=self.generate_non_text_regions(
                    height, width, text_lines, rng
                ),
            ),
            debug_large_text_line_gird=large_band,
            debug_grids=grids,
        )


page_layout_step_factory = PipelineStepFactory(PageLayoutStep)
