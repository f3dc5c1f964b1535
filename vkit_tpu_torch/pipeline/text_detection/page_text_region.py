"""Page text-region step: adaptive scaling via flatten-rotate-resize-stack.

Pipeline: precise text polygons (resized text-line mask components clipped
into disconnected text regions), char polygons assigned by max intersection
ratio, negative-region sampling, the TextRegionFlattener (dilation,
min-rotated-rect statistics, typicality by long-side ratio, KD-tree angle
propagation), per-region rotate-to-horizontal + resize to a char-height
median target, shelf-packed stacking, and an optional page-level rotation.

Behavioral spec: vkit/pipeline/text_detection/page_text_region.py:40-1301
(re-derived; bounding-rect statistics are one vectorized pass, the angle
propagation is a three-round resolver, and shapely STRtree / rectpack are
replaced by the first-party box index and shelf packer).

Port of vkit_tpu/pipeline/text_detection/page_text_region.py: the host code
is the reference's; the batched flatten (``flatten_text_regions_on_device``)
runs the two-shear warp on ``PageTextRegionStepConfig.device`` (the CUDA
row-shift kernels on a card), and the nearest-region queries go to
``utility.kdtree.KDTree``, which answers as sklearn's does.
"""
import logging
import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ... import convert
from ...element import (
    Box,
    Image,
    Mask,
    Polygon,
    mask_from_elements,
)
from ...geometry.packing import PolygonBoxIndex, pack_rectangles
from ...mechanism.distortion import rotate
from ...utility import rng_choice, rng_choice_with_size
from ...utility.kdtree import KDTree
from ..interface import PipelineStep, PipelineStepFactory
from .page_distortion import PageDistortionStepOutput
from .page_resizing import PageResizingStepOutput

logger = logging.getLogger(__name__)


@attr.define
class PageTextRegionStepConfig:
    use_adjusted_char_polygons: bool = False
    prob_drop_single_char_page_text_region_info: float = 0.5
    text_region_flattener_typical_long_side_ratio_min: float = 3.0
    text_region_flattener_text_region_polygon_dilate_ratio_min: float = 0.85
    text_region_flattener_text_region_polygon_dilate_ratio_max: float = 1.0
    text_region_resize_char_height_median_min: int = 32
    text_region_resize_char_height_median_max: int = 46
    prob_text_region_typical_post_rotate: float = 0.2
    prob_text_region_untypical_post_rotate: float = 0.2
    negative_text_region_ratio: float = 0.1
    prob_negative_text_region_post_rotate: float = 0.2
    stack_flattened_text_regions_pad: int = 2
    prob_post_rotate_90_angle: float = 0.5
    prob_post_rotate_random_angle: float = 0.0
    post_rotate_random_angle_min: int = -5
    post_rotate_random_angle_max: int = 5
    # Batch the per-region rotate + resize + post-rotate into a few device
    # programs (flatten_text_regions_on_device) instead of three host
    # resamples per region.  Same geometry/labels; rasters differ by the
    # single-resample filter shape only.
    enable_device_flatten: bool = True
    enable_debug: bool = False
    # Where the batched flatten runs: a card unless the caller asks for the
    # CPU.  No card raises; nothing falls back to the host path.
    device: str = 'cuda'


@attr.define
class PageTextRegionStepInput:
    page_distortion_step_output: PageDistortionStepOutput
    page_resizing_step_output: PageResizingStepOutput


@attr.define
class PageTextRegionInfo:
    precise_text_region_polygon: Polygon
    char_polygons: Sequence[Polygon]


@attr.define
class FlattenedTextRegion:
    is_typical: bool
    text_region_polygon: Polygon
    text_region_image: Image
    bounding_extended_text_region_mask: Mask
    flattening_rotate_angle: int
    shape_before_trim: Tuple[int, int]
    rotated_trimmed_box: Box
    shape_before_resize: Tuple[int, int]
    post_rotate_angle: int
    flattened_image: Image
    flattened_mask: Mask
    flattened_char_polygons: Optional[Sequence[Polygon]]

    @property
    def shape(self):
        return self.flattened_image.shape

    @property
    def height(self):
        return self.flattened_image.height

    @property
    def width(self):
        return self.flattened_image.width

    @property
    def area(self):
        return self.flattened_image.area

    def get_char_height_meidan(self) -> float:
        # (Reference-compatible spelling.)
        assert self.flattened_char_polygons
        return statistics.median(
            polygon.get_rectangular_height()
            for polygon in self.flattened_char_polygons
        )

    def to_resized_flattened_text_region(
        self,
        resized_height: Optional[int] = None,
        resized_width: Optional[int] = None,
    ) -> 'FlattenedTextRegion':
        char_polygons = None
        if self.flattened_char_polygons is not None:
            char_polygons = [
                polygon.to_conducted_resized_polygon(
                    self.shape,
                    resized_height=resized_height,
                    resized_width=resized_width,
                ) for polygon in self.flattened_char_polygons
            ]
        return attr.evolve(
            self,
            flattened_image=self.flattened_image.to_resized_image(
                resized_height, resized_width
            ),
            flattened_mask=self.flattened_mask.to_resized_mask(
                resized_height, resized_width
            ),
            flattened_char_polygons=char_polygons,
        )

    def to_post_rotated_flattened_text_region(
        self,
        post_rotate_angle: int,
    ) -> 'FlattenedTextRegion':
        assert self.post_rotate_angle == 0
        spun = rotate.distort(
            {'angle': post_rotate_angle},
            image=self.flattened_image,
            mask=self.flattened_mask,
            polygons=self.flattened_char_polygons,
        )
        assert spun.image and spun.mask
        return attr.evolve(
            self,
            post_rotate_angle=post_rotate_angle,
            flattened_image=spun.image,
            flattened_mask=spun.mask,
            flattened_char_polygons=spun.polygons,
        )


@attr.define
class PageTextRegionStepDebug:
    page_image: Image = attr.field(default=None)
    precise_text_region_candidate_polygons: Sequence[Polygon] = attr.field(default=None)
    page_text_region_infos: Sequence[PageTextRegionInfo] = attr.field(default=None)
    flattened_text_regions: Sequence[FlattenedTextRegion] = attr.field(default=None)


@attr.define
class PageTextRegionStepOutput:
    page_image: Image
    page_active_mask: Mask
    page_char_polygons: Sequence[Polygon]
    page_text_region_polygons: Sequence[Polygon]
    page_char_polygon_text_region_polygon_indices: Sequence[int]
    shape_before_rotate: Tuple[int, int]
    rotate_angle: int
    debug: Optional[PageTextRegionStepDebug]


# ----------------------------------------------------------------------------
# Mask intersection utilities.
# ----------------------------------------------------------------------------

def _box_intersection(a: Box, b: Box) -> Optional[Box]:
    out = Box(max(a.up, b.up), min(a.down, b.down),
              max(a.left, b.left), min(a.right, b.right))
    return out if out.up <= out.down and out.left <= out.right else None


def calculate_boxed_masks_intersected_ratio(
    anchor_mask: Mask,
    candidate_mask: Mask,
    use_candidate_as_base: bool = False,
) -> float:
    """Intersection area over the candidate (or the union) area."""
    anchor_box, candidate_box = anchor_mask.box, candidate_mask.box
    assert anchor_box and candidate_box
    window = _box_intersection(anchor_box, candidate_box)
    if window is None:
        return 0.0

    a = window.to_relative_box(anchor_box.up, anchor_box.left) \
        .extract_np_array(anchor_mask.mat)
    c = window.to_relative_box(candidate_box.up, candidate_box.left) \
        .extract_np_array(candidate_mask.mat)
    overlap = int((a & c).sum())

    if use_candidate_as_base:
        base = int(candidate_mask.np_mask.sum())
    else:
        base = (int(anchor_mask.np_mask.sum())
                + int(candidate_mask.np_mask.sum()) - overlap)
    return overlap / base if base else 0.0


# ----------------------------------------------------------------------------
# TextRegionFlattener.
# ----------------------------------------------------------------------------

def _analyze_rects(rect_polygons: Sequence[Polygon]):
    """Vectorized min-rect statistics: short side lengths, long/short side
    ratios, and long-side angles in [0, 180)."""
    corners = np.stack([p.np_xy[:4] for p in rect_polygons])  # (N, 4, 2)
    edge01 = np.linalg.norm(corners[:, 0] - corners[:, 1], axis=1)
    edge03 = np.linalg.norm(corners[:, 0] - corners[:, 3], axis=1)

    short_sides = np.minimum(edge01, edge03)
    ratios = np.maximum(edge01, edge03) / np.where(short_sides == 0, 1.0, short_sides)

    # Long-side direction: corner 0 toward whichever neighbor is farther.
    partner = np.where((edge01 > edge03)[:, None], corners[:, 1], corners[:, 3])
    delta = corners[:, 0] - partner
    theta = np.mod(np.arctan2(delta[:, 1], delta[:, 0]), np.pi)
    angles = np.mod(np.round(theta / np.pi * 180).astype(int), 180)

    return short_sides.tolist(), ratios.tolist(), angles.tolist()


class TextRegionFlattener:
    """Rotates every text region to horizontal and carves its local window.

    Stages: patch polygons to cover their chars -> dilate + min-rect ->
    rect statistics -> typicality -> angle propagation -> per-region window
    masks -> rotate + trim into FlattenedTextRegions.
    """

    def __init__(
        self,
        typical_long_side_ratio_min: float,
        text_region_polygon_dilate_ratio: float,
        image: Image,
        text_region_polygons: Sequence[Polygon],
        grouped_char_polygons: Optional[Sequence[Sequence[Polygon]]] = None,
        is_training: bool = False,
        defer_flatten: bool = False,
    ):
        self.grouped_char_polygons = grouped_char_polygons
        self.original_text_region_polygons = text_region_polygons
        self.text_region_polygons = self._patch_polygons(
            text_region_polygons, grouped_char_polygons
        )

        skip_dilation = None
        if is_training:
            assert grouped_char_polygons \
                and len(text_region_polygons) == len(grouped_char_polygons)
            # Negative (char-free) regions keep their sampled extent.
            skip_dilation = [not chars for chars in grouped_char_polygons]

        self.dilated_text_region_polygons, self.bounding_rectangular_polygons = (
            self._dilate_and_box(
                text_region_polygon_dilate_ratio, image.shape, skip_dilation
            )
        )

        (
            self.short_side_lengths,
            self.long_side_ratios,
            self.long_side_angles,
        ) = _analyze_rects(self.bounding_rectangular_polygons)

        self.typical_indices = tuple(
            idx for idx, ratio in enumerate(self.long_side_ratios)
            if ratio >= typical_long_side_ratio_min
        )

        self.main_angles, self.flattening_rotate_angles = self._resolve_angles()

        self.bounding_extended_text_region_masks = [
            self._region_window_mask(idx, image.shape)
            for idx in range(len(self.text_region_polygons))
        ]

        # With ``defer_flatten`` the per-region rotate+trim is left to the
        # caller (the batched device flatten folds rotate + resize +
        # post-rotate into one resampling pass per region).
        self.flattened_text_regions = () if defer_flatten else \
            self._flatten_all(image, grouped_char_polygons)

    # -- stages ---------------------------------------------------------

    @classmethod
    def _patch_polygons(cls, text_region_polygons, grouped_char_polygons):
        """Grow each region to cover its own char polygons."""
        if grouped_char_polygons is None:
            return text_region_polygons
        assert len(text_region_polygons) == len(grouped_char_polygons)
        patched: List[Polygon] = []
        for region, chars in zip(text_region_polygons, grouped_char_polygons):
            members = [region, *chars]
            hull_box = Box.from_boxes(p.bounding_box for p in members)
            canvas = Mask.from_shapable(hull_box).to_box_attached(hull_box)
            for polygon in members:
                polygon.fill_mask(canvas)
            patched.append(canvas.to_external_polygon())
        return patched

    def _dilate_and_box(self, dilate_ratio, shape, skip_dilation):
        dilated: List[Polygon] = []
        rects: List[Polygon] = []
        for idx, polygon in enumerate(self.text_region_polygons):
            if not (skip_dilation and skip_dilation[idx]):
                polygon = polygon.to_dilated_polygon(ratio=dilate_ratio)
                polygon = polygon.to_clipped_polygon(shape)
            dilated.append(polygon)
            rects.append(polygon.to_bounding_rectangular_polygon(shape))
        return dilated, rects

    def _dominates(self, first_idx: int, second_idx: int) -> bool:
        """A region can lend its angle only to smaller neighbors."""
        return (
            self.text_region_polygons[first_idx].area
            >= self.text_region_polygons[second_idx].area
            and self.short_side_lengths[first_idx]
            >= self.short_side_lengths[second_idx]
        )

    def _resolve_angles(self):
        """Typical regions keep their own angle; the rest borrow from a
        dominating typical neighbor (nearest-first), else the median."""
        count = len(self.long_side_angles)
        typical = set(self.typical_indices)
        main_angles: List[Optional[int]] = [
            angle if (not typical or idx in typical) else None
            for idx, angle in enumerate(self.long_side_angles)
        ]

        unresolved = [idx for idx in range(count) if main_angles[idx] is None]
        if unresolved:
            centers = np.asarray([
                self.text_region_polygons[idx].get_center_point().to_xy_pair()
                for idx in range(count)
            ], dtype=np.int32)
            typical_list = list(self.typical_indices)
            kd_tree = KDTree(centers[typical_list])

            # Round 1: the single nearest typical region, if it dominates.
            _, nearest = kd_tree.query(centers[unresolved])
            still = []
            for pos, idx in enumerate(unresolved):
                donor = typical_list[int(nearest[pos, 0])]
                if self._dominates(donor, idx):
                    main_angles[idx] = main_angles[donor]
                else:
                    still.append(idx)

            # Round 2: any dominating typical region, nearest first.
            fallback = []
            if still:
                _, ranked = kd_tree.query(centers[still], k=len(typical_list))
                for pos, idx in enumerate(still):
                    for donor_pos in ranked[pos].tolist():
                        donor = typical_list[int(donor_pos)]
                        if self._dominates(donor, idx):
                            main_angles[idx] = main_angles[donor]
                            break
                    else:
                        fallback.append(idx)

            # Round 3: the median typical angle.
            if fallback:
                median_angle = statistics.median_low(
                    self.long_side_angles[idx] for idx in self.typical_indices
                )
                for idx in fallback:
                    main_angles[idx] = median_angle

        rotate_angles = []
        for angle in main_angles:
            assert angle is not None
            rotate_angles.append(
                (360 - angle) % 360 if angle <= 90 else 180 - angle
            )
        return main_angles, rotate_angles

    def _region_window_mask(self, idx: int, shape) -> Mask:
        """The region's local window: its own (dilated) text plus all
        non-text background inside the bounding rectangle — other regions'
        text is carved out."""
        region = self.text_region_polygons[idx]
        dilated = self.dilated_text_region_polygons[idx]
        rect = self.bounding_rectangular_polygons[idx]
        typical = set(self.typical_indices)
        if typical and idx not in typical:
            # Align the window to the borrowed angle.
            rect = dilated.to_bounding_rectangular_polygon(
                shape=shape, angle=self.main_angles[idx]
            )

        all_text = mask_from_elements(shape, self.text_region_polygons) \
            .to_box_attached(Box.from_shape(shape))

        window = Box.from_boxes((dilated.bounding_box, rect.bounding_box))

        # Text belonging to OTHER regions inside the rectangle.
        other_text = Mask.from_shapable(window).to_box_attached(window)
        rect.fill_mask(other_text, all_text)
        region.fill_mask(other_text, 0)

        # This region's own (dilated) footprint.
        own = Mask.from_shapable(window).to_box_attached(window)
        dilated.fill_mask(own, value=1)

        np_keep = own.mat.astype(bool) & ~other_text.mat.astype(bool)

        # Non-text background inside the rectangle.
        non_text = Mask.from_shapable(window).to_box_attached(window)
        rect.fill_mask(non_text, all_text.to_inverted_mask())

        return Mask(
            mat=(np_keep | non_text.mat.astype(bool)).astype(np.uint8),
            box=window,
        )

    def _flatten_all(self, image: Image, grouped_char_polygons):
        typical = set(self.typical_indices)
        out: List[FlattenedTextRegion] = []
        for idx, window_mask in enumerate(self.bounding_extended_text_region_masks):
            window = window_mask.box
            assert window

            region_image = window_mask.extract_image(image)
            local_chars = None
            if grouped_char_polygons is not None:
                local_chars = [
                    p.to_relative_polygon(window.up, window.left)
                    for p in grouped_char_polygons[idx]
                ]

            spun = rotate.distort(
                {'angle': self.flattening_rotate_angles[idx]},
                image=region_image,
                mask=window_mask,
                polygons=local_chars,
            )
            assert spun.image and spun.mask

            trim = spun.mask.to_external_box()
            flattened_image = spun.image.to_cropped_image(
                up=trim.up, down=trim.down, left=trim.left, right=trim.right
            )
            flattened_mask = trim.extract_mask(spun.mask)
            flattened_chars = None
            if spun.polygons:
                flattened_chars = [
                    p.to_relative_polygon(trim.up, trim.left)
                    for p in spun.polygons
                ]

            out.append(FlattenedTextRegion(
                is_typical=(idx in typical),
                # The ORIGINAL polygon, for reversible labeling.
                text_region_polygon=self.original_text_region_polygons[idx],
                text_region_image=region_image,
                bounding_extended_text_region_mask=window_mask,
                flattening_rotate_angle=self.flattening_rotate_angles[idx],
                shape_before_trim=spun.image.shape,
                rotated_trimmed_box=trim,
                shape_before_resize=flattened_image.shape,
                post_rotate_angle=0,
                flattened_image=flattened_image,
                flattened_mask=flattened_mask,
                flattened_char_polygons=flattened_chars,
            ))
        return out


# ----------------------------------------------------------------------------
# Batched device flatten.
# ----------------------------------------------------------------------------

# Square source-tile ladder (each (src, dst) pair is one compiled program;
# the ladder bounds the compile set).
_FLATTEN_SRC_LADDER = (128, 192, 256, 384, 512, 768, 1024, 1536)


def _ladder_tile(size: int) -> int:
    for t in _FLATTEN_SRC_LADDER:
        if size <= t:
            return t
    return ((size + 127) // 128) * 128


def flatten_text_regions_on_device(
    image: Image,
    flattener: TextRegionFlattener,
    specs: Sequence[Tuple[int, float, int]],
    device='cuda',
) -> List[FlattenedTextRegion]:
    """Flatten the selected regions in a FEW device programs.

    ``specs``: (region_idx, scale, post_rotate_angle) per output region.
    The host path resamples three times per region (flattening rotate,
    resize to the char-height band, optional post-rotate by a multiple of
    90°); rotations compose, so all three fold into ONE affine per region
    and regions batch through the two-shear MXU program per source-tile
    bucket (ops/region.batch_flatten_regions).  Labels co-transform
    analytically through the same mats.  Output rasters differ from the
    host chain only by the single-resample filter shape; geometry and
    coordinate frames match (trim = warped-mask bbox, exactly the host's
    trim semantics).

    Each bucket's stack goes to ``device`` in one copy and its rasters come
    back in one; on a card the warp launches the row-shift kernels.

    Behavioral spec: vkit/pipeline/text_detection/page_text_region.py:
    561-730 (flatten + resize) and :139-157 (post rotate).
    """
    from ...ops.region import batch_flatten_regions, region_flatten_point_map

    device = convert.resolve_device(device)

    grouped_chars = flattener.grouped_char_polygons
    typical = set(flattener.typical_indices)

    # Bucket by padded square source tile.
    buckets: Dict[int, List[int]] = {}
    windows = []
    patches = []
    for pos, (idx, scale, post_angle) in enumerate(specs):
        wmask = flattener.bounding_extended_text_region_masks[idx]
        assert wmask.box is not None
        windows.append(wmask.box)
        patches.append(wmask.extract_image(image).mat)
        tile = _ladder_tile(max(wmask.box.height, wmask.box.width))
        buckets.setdefault(tile, []).append(pos)

    out: List[Optional[FlattenedTextRegion]] = [None] * len(specs)
    for tile, positions in sorted(buckets.items()):
        angles = []
        scales = []
        extents = []
        stack = np.zeros((len(positions), tile, tile, 4), dtype=np.float32)
        for row, pos in enumerate(positions):
            idx, scale, post_angle = specs[pos]
            window = windows[pos]
            wmask = flattener.bounding_extended_text_region_masks[idx]
            stack[row, :window.height, :window.width, :3] = patches[pos]
            stack[row, :window.height, :window.width, 3] = wmask.mat
            # The flattening rotate and the post rotate compose (both are
            # rotations about arbitrary centers; translation re-zeroing
            # makes the center irrelevant).
            angles.append(
                float(flattener.flattening_rotate_angles[idx] + post_angle)
            )
            scales.append(float(scale))
            extents.append((window.height, window.width))

        dst_need = 0
        from ...ops.region import plan_region_flatten
        _, need = plan_region_flatten(
            angles, scales, tile, 1 << 30,
            content_extents=np.asarray(extents),
        )
        dst_need = int(need.max())
        dst_tile = ((dst_need + 127) // 128) * 128

        warped, w_extents, mats = batch_flatten_regions(
            convert.to_tensor(stack, device), angles, scales, dst_tile,
            content_extents=np.asarray(extents), return_mats=True,
        )
        warped = warped.cpu().numpy()

        for row, pos in enumerate(positions):
            idx, scale, post_angle = specs[pos]
            window = windows[pos]
            eh, ew = (int(v) for v in w_extents[row])
            mask_f = warped[row, :eh, :ew, 3]
            np_mask = (mask_f > 0.5).astype(np.uint8)
            ys, xs = np.nonzero(np_mask)
            if not len(ys):
                # Degenerate (mask rounded away): keep the full extent.
                trim = Box(0, max(eh - 1, 0), 0, max(ew - 1, 0))
            else:
                trim = Box(int(ys.min()), int(ys.max()),
                           int(xs.min()), int(xs.max()))
            img = np.clip(
                np.round(warped[row, trim.up:trim.down + 1,
                                trim.left:trim.right + 1, :3]),
                0, 255,
            ).astype(np.uint8)
            msk = np_mask[trim.up:trim.down + 1, trim.left:trim.right + 1]

            flattened_chars = None
            if grouped_chars is not None and grouped_chars[idx]:
                chars = grouped_chars[idx]
                counts = [p.num_points for p in chars]
                xy = np.concatenate([p.np_xy for p in chars], axis=0)
                # Page coords -> window-tile coords -> flattened coords.
                xy = xy - np.asarray([window.left, window.up], np.float64)
                mapped = region_flatten_point_map(
                    mats[row:row + 1], np.zeros(len(xy), np.int64), xy
                )
                mapped -= np.asarray([trim.left, trim.up], np.float64)
                flattened_chars = []
                at = 0
                for count in counts:
                    flattened_chars.append(
                        Polygon.from_np_xy(mapped[at:at + count])
                    )
                    at += count

            out[pos] = FlattenedTextRegion(
                is_typical=(idx in typical),
                text_region_polygon=(
                    flattener.original_text_region_polygons[idx]
                ),
                text_region_image=Image(mat=patches[pos]),
                bounding_extended_text_region_mask=(
                    flattener.bounding_extended_text_region_masks[idx]
                ),
                flattening_rotate_angle=(
                    flattener.flattening_rotate_angles[idx]
                ),
                shape_before_trim=(eh, ew),
                rotated_trimmed_box=trim,
                shape_before_resize=(window.height, window.width),
                post_rotate_angle=post_angle,
                flattened_image=Image(mat=img),
                flattened_mask=Mask(mat=msk),
                flattened_char_polygons=flattened_chars,
            )
    return [ftr for ftr in out if ftr is not None]


# ----------------------------------------------------------------------------
# Stacking.
# ----------------------------------------------------------------------------

def build_background_image_for_stacking(height: int, width: int) -> Image:
    """RGB pinwheel pattern: row r, column c gets channel (r + c) % 3."""
    rows = np.arange(height)[:, None]
    cols = np.arange(width)[None, :]
    phase = (rows + cols) % 3
    np_image = np.zeros((height, width, 3), dtype=np.uint8)
    for channel in range(3):
        np_image[..., channel] = np.where(phase == channel, 255, 0)
    return Image(mat=np_image)


def stack_flattened_text_regions(
    page_pad: int,
    flattened_text_regions_pad: int,
    flattened_text_regions: Sequence[FlattenedTextRegion],
):
    """Shelf-pack the flattened regions into one page canvas."""
    inner_pad = flattened_text_regions_pad
    padded_sizes = [
        (ftr.width + 2 * inner_pad, ftr.height + 2 * inner_pad)
        for ftr in flattened_text_regions
    ]
    placements = pack_rectangles(
        padded_sizes, max(w for w, _ in padded_sizes)
    )

    page_height = max(
        y + h for (x, y), (w, h) in zip(placements, padded_sizes)
    ) + 2 * page_pad
    page_width = max(
        x + w for (x, y), (w, h) in zip(placements, padded_sizes)
    ) + 2 * page_pad

    image = build_background_image_for_stacking(page_height, page_width)
    active_mask = Mask.from_shapable(image)
    text_region_boxes: List[Box] = []
    char_polygons: List[Polygon] = []
    char_polygon_box_indices: List[int] = []

    for (x, y), ftr in zip(placements, flattened_text_regions):
        up = y + inner_pad + page_pad
        left = x + inner_pad + page_pad
        target = Box(up, up + ftr.height - 1, left, left + ftr.width - 1)
        text_region_boxes.append(target)

        target.fill_image(image, ftr.flattened_image,
                          image_mask=ftr.flattened_mask)
        target.fill_mask(active_mask, value=1, mask_mask=ftr.flattened_mask)

        for polygon in (ftr.flattened_char_polygons or ()):
            char_polygons.append(polygon.to_shifted_polygon(up, left))
            char_polygon_box_indices.append(len(text_region_boxes) - 1)

    return image, active_mask, text_region_boxes, char_polygons, \
        char_polygon_box_indices


# ----------------------------------------------------------------------------
# The step.
# ----------------------------------------------------------------------------

class PageTextRegionStep(
    PipelineStep[PageTextRegionStepConfig, PageTextRegionStepInput, PageTextRegionStepOutput]
):

    @staticmethod
    def _clip_into_regions(precise_mask: Mask, region_mask: Mask
                           ) -> Sequence[Polygon]:
        """Components of (precise ∧ region), in page coordinates."""
        assert precise_mask.box and region_mask.box
        window = _box_intersection(precise_mask.box, region_mask.box)
        assert window is not None
        a = window.extract_mask(precise_mask)
        b = window.extract_mask(region_mask)
        both = Mask(mat=(a.mat & b.mat).astype(np.uint8)).to_box_attached(window)
        return both.to_disconnected_polygons()

    @staticmethod
    def _intersections(box_index: PolygonBoxIndex, anchors: Sequence[Polygon],
                       candidate: Polygon):
        """(anchor_idx, anchor_mask, candidate_mask, ratio) per box hit."""
        candidate_mask = candidate.mask
        for anchor_idx in sorted(box_index.query(candidate)):
            anchor_mask = anchors[anchor_idx].mask
            yield (
                anchor_idx,
                anchor_mask,
                candidate_mask,
                calculate_boxed_masks_intersected_ratio(
                    anchor_mask, candidate_mask, use_candidate_as_base=True
                ),
            )

    def _collect_precise_regions(self, page_image: Image,
                                 resized_line_mask: Mask,
                                 region_polygons: Sequence[Polygon]
                                 ) -> List[Polygon]:
        """Text-line mask components, upscaled, clipped into regions."""
        region_index = PolygonBoxIndex(region_polygons)
        out: List[Polygon] = []
        for component in resized_line_mask.to_disconnected_polygons():
            precise = component.to_conducted_resized_polygon(
                resized_line_mask,
                resized_height=page_image.height,
                resized_width=page_image.width,
            )
            # One component may straddle several disconnected regions.
            for _, region_mask, precise_mask, _ in self._intersections(
                region_index, region_polygons, precise
            ):
                out.extend(self._clip_into_regions(precise_mask, region_mask))
        return out

    def _assign_chars(self, char_polygons: Sequence[Polygon],
                      region_polygons: Sequence[Polygon]
                      ) -> Dict[int, List[Polygon]]:
        """Each char joins the region it overlaps most."""
        region_index = PolygonBoxIndex(region_polygons)
        assigned: Dict[int, List[Polygon]] = {}
        for char_polygon in char_polygons:
            best_idx = None
            best_ratio = 0.0
            for idx, _, _, ratio in self._intersections(
                region_index, region_polygons, char_polygon
            ):
                if ratio > best_ratio:
                    best_ratio = ratio
                    best_idx = idx
            if best_idx is not None:
                assigned.setdefault(best_idx, []).append(char_polygon)
            else:
                # Rare: tiny delimiter-only text lines.
                logger.warning(f'no region takes char_polygon={char_polygon}')
        return assigned

    def _sample_negative_polygons(self, non_text_polygons: Sequence[Polygon],
                                  num_positive: int, rng: RandomGenerator):
        share = self.config.negative_text_region_ratio
        target = round(share * num_positive / (1 - share))
        if not non_text_polygons or target == 0:
            return ()
        return rng_choice_with_size(
            rng, non_text_polygons,
            size=min(target, len(non_text_polygons)), replace=False,
        )

    def _sample_post_rotate_angle(self, is_typical: bool,
                                  rng: RandomGenerator) -> int:
        if is_typical:
            if rng.random() < self.config.prob_text_region_typical_post_rotate:
                return 180
            return 0
        if rng.random() < self.config.prob_text_region_untypical_post_rotate:
            return rng_choice(rng, (180, 90, 270), probs=(0.5, 0.25, 0.25))
        return 0

    def _rescale_and_spin(self, ftr: FlattenedTextRegion, scale: float,
                          rng: RandomGenerator) -> FlattenedTextRegion:
        resized = ftr.to_resized_flattened_text_region(
            resized_height=round(ftr.height * scale),
            resized_width=round(ftr.width * scale),
        )
        angle = self._sample_post_rotate_angle(resized.is_typical, rng)
        if angle:
            resized = resized.to_post_rotated_flattened_text_region(angle)
        return resized

    def build_flattened_text_regions(
        self,
        page_image: Image,
        page_text_region_infos: Sequence[PageTextRegionInfo],
        page_non_text_region_polygons: Sequence[Polygon],
        rng: RandomGenerator,
    ) -> Sequence[FlattenedTextRegion]:
        cfg = self.config
        dilate_ratio = float(rng.uniform(
            cfg.text_region_flattener_text_region_polygon_dilate_ratio_min,
            cfg.text_region_flattener_text_region_polygon_dilate_ratio_max,
        ))

        region_polygons = [
            info.precise_text_region_polygon for info in page_text_region_infos
        ] + list(page_non_text_region_polygons)
        grouped_chars: List[Sequence[Polygon]] = [
            info.char_polygons for info in page_text_region_infos
        ] + [()] * len(page_non_text_region_polygons)

        flattener = TextRegionFlattener(
            typical_long_side_ratio_min=(
                cfg.text_region_flattener_typical_long_side_ratio_min
            ),
            text_region_polygon_dilate_ratio=dilate_ratio,
            image=page_image,
            text_region_polygons=region_polygons,
            grouped_char_polygons=grouped_chars,
            is_training=True,
            defer_flatten=cfg.enable_device_flatten,
        )
        if cfg.enable_device_flatten:
            return self._build_flattened_device(page_image, flattener, rng)

        positives: List[FlattenedTextRegion] = []
        ref_heights: List[float] = []
        ref_widths: List[float] = []
        num_negatives = 0
        for ftr in flattener.flattened_text_regions:
            if not ftr.flattened_char_polygons:
                num_negatives += 1
                continue
            if len(ftr.flattened_char_polygons) == 1 \
                    and rng.random() < cfg.prob_drop_single_char_page_text_region_info:
                continue
            # Normalize so the median char height lands in the target band.
            target = int(rng.integers(
                cfg.text_region_resize_char_height_median_min,
                cfg.text_region_resize_char_height_median_max + 1,
            ))
            scale = target / ftr.get_char_height_meidan()
            ref_heights.append(round(ftr.height * scale))
            ref_widths.append(round(ftr.width * scale))
            positives.append(self._rescale_and_spin(ftr, scale, rng))

        negatives: List[FlattenedTextRegion] = []
        if num_negatives and ref_heights:
            borrowed_heights = list(rng_choice_with_size(
                rng, ref_heights, size=num_negatives,
                replace=num_negatives > len(ref_heights),
            ))
            height_cap = max(ref_heights)
            width_cap = max(ref_widths)
            for ftr in flattener.flattened_text_regions:
                if ftr.flattened_char_polygons:
                    continue
                scale = borrowed_heights.pop() / ftr.height
                if round(ftr.height * scale) > height_cap \
                        or round(ftr.width * scale) > width_cap:
                    continue
                negatives.append(self._rescale_and_spin(ftr, scale, rng))

        return (*positives, *negatives)

    @staticmethod
    def _rotated_extent(height: int, width: int, angle_deg: float):
        """Analytic rotated-rect extent — the flattened (pre-resize) shape
        the host chain would measure after its trim, up to the mask's
        rasterized support (<= 2 px)."""
        rad = math.radians(angle_deg)
        c, s = abs(math.cos(rad)), abs(math.sin(rad))
        eh = int(math.ceil((height - 1) * c + (width - 1) * s - 1e-6)) + 1
        ew = int(math.ceil((width - 1) * c + (height - 1) * s - 1e-6)) + 1
        return eh, ew

    def _build_flattened_device(
        self,
        page_image: Image,
        flattener: TextRegionFlattener,
        rng: RandomGenerator,
    ) -> Sequence[FlattenedTextRegion]:
        """The host selection logic (single-char drop, char-height-median
        scale targets, negative scale borrowing, post-rotate draws) with
        the three per-region host resamples replaced by the batched device
        flatten.  Same rng draw order as the host path; scale targets use
        the char quads' rectangular heights, which rotations preserve, so
        the medians match the host path's post-flatten medians exactly."""
        cfg = self.config
        grouped_chars = flattener.grouped_char_polygons
        assert grouped_chars is not None
        typical = set(flattener.typical_indices)
        count = len(flattener.bounding_extended_text_region_masks)

        def pre_resize_extent(idx: int):
            window = flattener.bounding_extended_text_region_masks[idx].box
            assert window is not None
            return self._rotated_extent(
                window.height, window.width,
                flattener.flattening_rotate_angles[idx],
            )

        specs: List[Tuple[int, float, int]] = []
        ref_heights: List[float] = []
        ref_widths: List[float] = []
        num_negatives = 0
        for idx in range(count):
            chars = grouped_chars[idx]
            if not chars:
                num_negatives += 1
                continue
            if len(chars) == 1 \
                    and rng.random() < cfg.prob_drop_single_char_page_text_region_info:
                continue
            target = int(rng.integers(
                cfg.text_region_resize_char_height_median_min,
                cfg.text_region_resize_char_height_median_max + 1,
            ))
            median = statistics.median(
                p.get_rectangular_height() for p in chars
            )
            scale = target / median
            eh, ew = pre_resize_extent(idx)
            ref_heights.append(round(eh * scale))
            ref_widths.append(round(ew * scale))
            angle = self._sample_post_rotate_angle(idx in typical, rng)
            specs.append((idx, scale, angle))

        if num_negatives and ref_heights:
            borrowed_heights = list(rng_choice_with_size(
                rng, ref_heights, size=num_negatives,
                replace=num_negatives > len(ref_heights),
            ))
            height_cap = max(ref_heights)
            width_cap = max(ref_widths)
            for idx in range(count):
                if grouped_chars[idx]:
                    continue
                eh, ew = pre_resize_extent(idx)
                scale = borrowed_heights.pop() / eh
                if round(eh * scale) > height_cap \
                        or round(ew * scale) > width_cap:
                    continue
                angle = self._sample_post_rotate_angle(idx in typical, rng)
                specs.append((idx, scale, angle))

        if not specs:
            return ()
        return flatten_text_regions_on_device(page_image, flattener, specs,
                                              device=cfg.device)

    def _post_rotate(self, image, active_mask, char_polygons,
                     text_region_polygons, rng: RandomGenerator):
        cfg = self.config
        angle = 90 if rng.random() < cfg.prob_post_rotate_90_angle else 0
        if rng.random() < cfg.prob_post_rotate_random_angle:
            angle += int(rng.integers(cfg.post_rotate_random_angle_min,
                                      cfg.post_rotate_random_angle_max + 1))
        if angle == 0:
            return image, active_mask, char_polygons, text_region_polygons, 0

        num_chars = len(char_polygons)
        spun = rotate.distort(
            {'angle': angle},
            image=image,
            mask=active_mask,
            polygons=(*char_polygons, *text_region_polygons),
        )
        assert spun.image and spun.mask and spun.polygons
        return (
            spun.image, spun.mask,
            spun.polygons[:num_chars], spun.polygons[num_chars:], angle,
        )

    def run(self, input: PageTextRegionStepInput, rng: RandomGenerator):
        cfg = self.config
        distortion_out = input.page_distortion_step_output
        page_image = distortion_out.page_image
        char_collection = distortion_out.page_char_polygon_collection
        resized_line_mask = input.page_resizing_step_output.page_text_line_mask

        debug = PageTextRegionStepDebug() if cfg.enable_debug else None

        precise_polygons = self._collect_precise_regions(
            page_image,
            resized_line_mask,
            list(distortion_out.page_disconnected_text_region_collection.to_polygons()),
        )
        if debug:
            debug.page_image = page_image
            debug.precise_text_region_candidate_polygons = precise_polygons

        selected_chars = (
            char_collection.adjusted_char_polygons
            if cfg.use_adjusted_char_polygons
            else char_collection.char_polygons
        )
        assigned = self._assign_chars(selected_chars, precise_polygons)
        page_text_region_infos = [
            PageTextRegionInfo(
                precise_text_region_polygon=precise_polygons[idx],
                char_polygons=assigned[idx],
            )
            for idx in range(len(precise_polygons)) if idx in assigned
        ]
        if debug:
            debug.page_text_region_infos = page_text_region_infos

        negatives = self._sample_negative_polygons(
            tuple(distortion_out.page_non_text_region_collection.to_polygons()),
            len(page_text_region_infos),
            rng,
        )
        flattened = self.build_flattened_text_regions(
            page_image, page_text_region_infos, negatives, rng
        )
        if debug:
            debug.flattened_text_regions = flattened

        image, active_mask, boxes, char_polygons, char_box_indices = (
            stack_flattened_text_regions(
                page_pad=0,
                flattened_text_regions_pad=cfg.stack_flattened_text_regions_pad,
                flattened_text_regions=flattened,
            )
        )
        region_polygons = [box.to_polygon() for box in boxes]

        shape_before_rotate = image.shape
        image, active_mask, char_polygons, region_polygons, rotate_angle = (
            self._post_rotate(
                image, active_mask, char_polygons, region_polygons, rng
            )
        )

        return PageTextRegionStepOutput(
            page_image=image,
            page_active_mask=active_mask,
            page_char_polygons=char_polygons,
            page_text_region_polygons=region_polygons,
            page_char_polygon_text_region_polygon_indices=char_box_indices,
            shape_before_rotate=shape_before_rotate,
            rotate_angle=rotate_angle,
            debug=debug,
        )


page_text_region_step_factory = PipelineStepFactory(PageTextRegionStep)
