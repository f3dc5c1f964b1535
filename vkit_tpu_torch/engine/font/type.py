"""Font data model: FontMeta / FontVariant / FontCollection and the rendered
text-line structures (CharBox / CharGlyph / TextLine).

Behavioral spec: vkit/engine/font/type.py:54-755 (re-derived; the
horizontal/vertical method pairs collapse into axis-generic helpers).
"""
import json
import os
from enum import Enum, unique
from pathlib import Path
from typing import (
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Set,
    Tuple,
    Union,
)

import attr
import numpy as np

from ...element import (
    Box,
    Image,
    Interpolation,
    Mask,
    Point,
    PointList,
    Polygon,
    ScoreMap,
    Shapable,
)
from ...utility import PathType, dyn_structure


@attr.define(frozen=True)
class FontGlyphInfo:
    tags: Sequence[str]
    ascent_plus_pad_up_min_to_font_size_ratio: float
    height_min_to_font_size_ratio: float
    width_min_to_font_size_ratio: float


@attr.define
class FontGlyphInfoCollection:
    font_glyph_infos: Sequence[FontGlyphInfo]
    _tag_index: Optional[Dict[str, FontGlyphInfo]] = attr.field(
        default=None, repr=False, init=False
    )

    @property
    def tag_to_font_glyph_info(self) -> Mapping[str, FontGlyphInfo]:
        if self._tag_index is None:
            index: Dict[str, FontGlyphInfo] = {}
            for info in self.font_glyph_infos:
                assert info.tags
                for tag in info.tags:
                    assert tag not in index, f'duplicate glyph tag {tag!r}'
                    index[tag] = info
            self._tag_index = index
        return self._tag_index


@attr.define
class FontVariant:
    char_to_tags: Mapping[str, Sequence[str]]
    font_file: PathType
    font_glyph_info_collection: FontGlyphInfoCollection
    is_ttc: bool = False
    ttc_font_index: Optional[int] = None


@unique
class FontMode(Enum):
    TTC = 'ttc'     # One ttc file holding every variant.
    VTTC = 'vttc'   # A group of ttf files.
    VOTC = 'votc'   # A group of otf files.


@attr.define
class FontMeta:
    name: str
    mode: FontMode
    char_to_tags: Mapping[str, Sequence[str]]
    font_files: Sequence[str]
    font_glyph_info_collection: FontGlyphInfoCollection
    # Inclusive.
    ttc_font_index_max: Optional[int] = None
    _sorted_chars: Optional[Sequence[str]] = attr.field(
        default=None, repr=False, init=False
    )

    @property
    def chars(self) -> Sequence[str]:
        if self._sorted_chars is None:
            self._sorted_chars = sorted(self.char_to_tags)
        return self._sorted_chars

    def __repr__(self):
        return (
            f'FontMeta(name="{self.name}", mode={self.mode}, '
            f'num_chars={len(self.char_to_tags)}, font_files={self.font_files}, '
            f'ttc_font_index_max={self.ttc_font_index_max})'
        )

    @classmethod
    def from_file(cls, path: PathType,
                  font_file_prefix: Optional[PathType] = None) -> 'FontMeta':
        meta = dyn_structure(path, FontMeta, force_path_type=True)
        if font_file_prefix:
            prefix = Path(os.path.expandvars(os.fspath(font_file_prefix)))
            resolved = []
            for name in meta.font_files:
                full = prefix / name
                assert full.exists()
                resolved.append(str(full))
            meta = attr.evolve(meta, font_files=resolved)
        return meta

    def to_file(self, path: PathType,
                font_file_prefix: Optional[PathType] = None) -> None:
        font_files = list(self.font_files)
        if font_file_prefix:
            prefix = Path(os.fspath(font_file_prefix))
            font_files = [str(Path(f).relative_to(prefix)) for f in font_files]
        payload = {
            'name': self.name,
            'mode': self.mode.value,
            'char_to_tags': {
                char: list(tags) for char, tags in self.char_to_tags.items()
            },
            'font_files': font_files,
            'font_glyph_info_collection': {
                'font_glyph_infos': [
                    attr.asdict(info)
                    for info in self.font_glyph_info_collection.font_glyph_infos
                ],
            },
            'ttc_font_index_max': self.ttc_font_index_max,
        }
        with open(os.fspath(path), 'w') as fout:
            json.dump(payload, fout, indent=2, ensure_ascii=False)

    @property
    def num_font_variants(self) -> int:
        if self.mode is FontMode.TTC:
            assert self.ttc_font_index_max is not None
            return self.ttc_font_index_max + 1
        return len(self.font_files)

    def get_font_variant(self, variant_idx: int) -> FontVariant:
        assert variant_idx < self.num_font_variants
        if self.mode is FontMode.TTC:
            return FontVariant(
                char_to_tags=self.char_to_tags,
                font_file=self.font_files[0],
                font_glyph_info_collection=self.font_glyph_info_collection,
                is_ttc=True,
                ttc_font_index=variant_idx,
            )
        return FontVariant(
            char_to_tags=self.char_to_tags,
            font_file=self.font_files[variant_idx],
            font_glyph_info_collection=self.font_glyph_info_collection,
        )


class FontCollectionFolderTree:
    FONT = 'font'
    FONT_META = 'font_meta'


@attr.define
class FontCollection:
    font_metas: Sequence[FontMeta]
    _by_name: Optional[Dict[str, FontMeta]] = attr.field(
        default=None, repr=False, init=False
    )
    _names_by_char: Optional[Dict[str, Set[str]]] = attr.field(
        default=None, repr=False, init=False
    )

    def _index(self) -> None:
        by_name: Dict[str, FontMeta] = {}
        names_by_char: Dict[str, Set[str]] = {}
        for meta in self.font_metas:
            assert meta.name not in by_name
            by_name[meta.name] = meta
            for char in meta.chars:
                names_by_char.setdefault(char, set()).add(meta.name)
        self._by_name = by_name
        self._names_by_char = names_by_char

    @property
    def name_to_font_meta(self) -> Mapping[str, FontMeta]:
        if self._by_name is None:
            self._index()
        assert self._by_name is not None
        return self._by_name

    @property
    def char_to_font_meta_names(self) -> Mapping[str, Set[str]]:
        if self._names_by_char is None:
            self._index()
        assert self._names_by_char is not None
        return self._names_by_char

    def filter_font_metas(self, chars: Iterable[str]) -> List[FontMeta]:
        """Fonts whose glyph sets cover every non-space char."""
        required = [c for c in chars if not c.isspace()]
        if not required:
            return list(self.font_metas)
        covering = set.intersection(*(
            self.char_to_font_meta_names.get(c, set()) for c in required
        ))
        return [self.name_to_font_meta[name] for name in sorted(covering)]

    @classmethod
    def from_folder(cls, folder: PathType) -> 'FontCollection':
        root = Path(os.path.expandvars(os.fspath(folder)))
        font_fd = root / FontCollectionFolderTree.FONT
        meta_fd = root / FontCollectionFolderTree.FONT_META
        return cls(font_metas=[
            FontMeta.from_file(meta_json, font_fd)
            for meta_json in sorted(meta_fd.glob('*.json'))
        ])


@attr.define
class FontEngineRunConfigStyle:
    # Font size.
    font_size_ratio: float = 1.0
    font_size_min: int = 12
    font_size_max: int = 96

    # Space between chars.
    prob_set_char_space_min: float = 0.5
    char_space_min: float = 0.0
    char_space_max: float = 0.2
    char_space_mean: float = 0.1
    char_space_std: float = 0.03

    # Space between words.
    word_space_min: float = 0.3
    word_space_max: float = 1.0
    word_space_mean: float = 0.6
    word_space_std: float = 0.1

    # Effect.
    glyph_color: Tuple[int, int, int] = (0, 0, 0)
    glyph_color_gamma: float = 1.0

    # Renderer options.
    freetype_force_autohint: bool = False


@unique
class FontEngineRunConfigGlyphSequence(Enum):
    HORI_DEFAULT = 'hori_default'
    VERT_DEFAULT = 'vert_default'


@attr.define
class FontEngineRunConfig:
    height: int
    width: int
    chars: Sequence[str]
    font_variant: FontVariant

    glyph_sequence: FontEngineRunConfigGlyphSequence = (
        FontEngineRunConfigGlyphSequence.HORI_DEFAULT
    )
    style: FontEngineRunConfigStyle = attr.field(factory=FontEngineRunConfigStyle)

    # For debugging.
    return_font_variant: bool = False


class CharBox(Shapable):
    """A single char bound to its box.

    Plain slots class (not attrs): tens of thousands are built per page
    in the layout planners, where the generated frozen-attrs __init__
    dominated the profile.
    """

    __slots__ = ('char', 'box')

    def __init__(self, char: str, box: Box):
        assert len(char) == 1 and not char.isspace()
        object.__setattr__(self, 'char', char)
        object.__setattr__(self, 'box', box)

    def __setattr__(self, name, value):
        raise AttributeError('CharBox is immutable')

    def __repr__(self):
        return f'CharBox(char={self.char!r}, box={self.box!r})'

    def __eq__(self, other):
        if not isinstance(other, CharBox):
            return NotImplemented
        return self.char == other.char and self.box == other.box

    def __hash__(self):
        return hash((self.char, self.box))

    # Geometry reads delegate to the box.
    up = property(lambda self: self.box.up)
    down = property(lambda self: self.box.down)
    left = property(lambda self: self.box.left)
    right = property(lambda self: self.box.right)
    height = property(lambda self: self.box.height)
    width = property(lambda self: self.box.width)

    def to_conducted_resized_char_box(self, shapable_or_shape,
                                      resized_height: Optional[int] = None,
                                      resized_width: Optional[int] = None,
                                      ) -> 'CharBox':
        # Direct construction: attr.evolve re-resolves the field list on
        # every call, which dominates in the per-char hot loops.
        return CharBox(self.char, self.box.to_conducted_resized_box(
            shapable_or_shape, resized_height, resized_width
        ))

    def to_resized_char_box(self, resized_height: Optional[int] = None,
                            resized_width: Optional[int] = None) -> 'CharBox':
        return CharBox(self.char, self.box.to_resized_box(
            resized_height, resized_width
        ))

    def to_shifted_char_box(self, offset_y: int = 0, offset_x: int = 0) -> 'CharBox':
        return CharBox(self.char, self.box.to_shifted_box(offset_y, offset_x))


@attr.define
class CharGlyph:
    char: str
    image: Image
    score_map: Optional[ScoreMap]
    # Baseline-relative metrics (see build_char_glyph in pil_font.py).
    ascent: int
    pad_up: int
    pad_down: int
    pad_left: int
    pad_right: int
    # Per-tag reference metrics for char polygon expansion.
    ref_ascent_plus_pad_up: int
    ref_char_height: int
    ref_char_width: int

    def __attrs_post_init__(self):
        # ascent may be negative (e.g. '_'); pads may not.
        assert min(self.pad_up, self.pad_down, self.pad_left, self.pad_right) >= 0

    @property
    def height(self) -> int:
        return self.image.height

    @property
    def width(self) -> int:
        return self.image.width

    def get_glyph_mask(self, box: Optional[Box] = None,
                       enable_resize: bool = False,
                       interpolation: Interpolation = Interpolation.CUBIC) -> Mask:
        np_active = self.image.mat > 0
        if np_active.ndim == 3:
            np_active = np_active.any(axis=2)
        mask = Mask(mat=np_active.astype(np.uint8))
        if box:
            if mask.shape != box.shape:
                assert enable_resize
                mask = mask.to_resized_mask(box.height, box.width, interpolation)
            mask = mask.to_box_attached(box)
        return mask


def _expand_span(lo: float, hi: float, target: float,
                 clamp_lo: float, clamp_hi: float) -> Tuple[float, float]:
    """Grow [lo, hi] symmetrically to `target` length, clamped."""
    span = hi - lo + 1
    if span < target:
        grow = (target - span) / 2
        lo = max(clamp_lo, lo - grow)
        hi = min(clamp_hi, hi + grow)
    return lo, hi


@attr.define
class TextLine:
    image: Image
    mask: Mask
    score_map: Optional[ScoreMap]
    char_boxes: Sequence[CharBox]
    # NOTE: char_glyphs may not share shapes with char_boxes.
    char_glyphs: Sequence[CharGlyph]
    resize_interpolation: Interpolation
    style: FontEngineRunConfigStyle
    font_size: int
    text: str
    is_hori: bool

    # Set once bound to a page.
    shifted: bool = False

    # For debugging.
    font_variant: Optional[FontVariant] = None

    @property
    def box(self) -> Box:
        assert self.mask.box
        return self.mask.box

    @property
    def glyph_color(self) -> Tuple[int, int, int]:
        return self.style.glyph_color

    def to_shifted_text_line(self, offset_y: int = 0, offset_x: int = 0) -> 'TextLine':
        self.shifted = True
        return attr.evolve(
            self,
            image=self.image.to_shifted_image(offset_y, offset_x),
            mask=self.mask.to_shifted_mask(offset_y, offset_x),
            score_map=(
                self.score_map.to_shifted_score_map(offset_y, offset_x)
                if self.score_map else None
            ),
            char_boxes=[
                cb.to_shifted_char_box(offset_y, offset_x) for cb in self.char_boxes
            ],
        )

    def split(self) -> List['TextLine']:
        """One TextLine per whitespace-separated word."""
        words = self.text.split()
        if len(words) == 1:
            return [self]
        assert len(words) > 1

        out: List[TextLine] = []
        begin = 0
        for word in words:
            end = begin + len(word)
            char_boxes = self.char_boxes[begin:end]
            char_glyphs = self.char_glyphs[begin:end]
            word_box = Box.from_boxes(cb.box for cb in char_boxes)
            out.append(attr.evolve(
                self,
                image=word_box.extract_image(self.image),
                mask=word_box.extract_mask(self.mask),
                score_map=(
                    word_box.extract_score_map(self.score_map)
                    if self.score_map else None
                ),
                char_boxes=char_boxes,
                char_glyphs=char_glyphs,
                text=word,
            ))
            begin = end
        return out

    # ------------------------------------------------------------------
    # Axis-generic geometry helpers.  For a horizontal line the main axis
    # is x; a vertical line transposes every role.
    # ------------------------------------------------------------------

    def _main_axis_steps(self) -> List[int]:
        """Staircase coordinates along the main axis, tracking char boxes."""
        if self.is_hori:
            lo, hi = self.box.left, self.box.right
            spans = [(cb.left, cb.right) for cb in self.char_boxes]
        else:
            lo, hi = self.box.up, self.box.down
            spans = [(cb.up, cb.down) for cb in self.char_boxes]
        steps = [lo]
        for span_lo, span_hi in spans:
            if steps[-1] < span_lo:
                steps.append(span_lo)
            if span_lo < span_hi:
                steps.append(span_hi)
        if steps[-1] < hi:
            steps.append(hi)
        return steps

    def _point_at(self, main: float, cross: float) -> Point:
        if self.is_hori:
            return Point.create(y=cross, x=main)
        return Point.create(y=main, x=cross)

    def to_polygon(self) -> Polygon:
        """Staircase outline around the char boxes, with mid-edge anchors."""
        steps = self._main_axis_steps()
        if self.is_hori:
            cross_a, cross_b = self.box.up, self.box.down
        else:
            cross_a, cross_b = self.box.right, self.box.left
        cross_mid = (cross_a + cross_b) // 2 if self.is_hori \
            else (self.box.left + self.box.right) // 2
        has_mid = min(cross_a, cross_b) < cross_mid < max(cross_a, cross_b)

        # Assemble the ring as a flat xy array (Point objects per vertex
        # dominate in the per-word hot loop).
        k = len(steps)
        extra = 2 if has_mid else 0
        mains = np.empty(2 * k + extra, dtype=np.float64)
        crosses = np.empty(2 * k + extra, dtype=np.float64)
        mains[:k] = steps
        crosses[:k] = cross_a
        idx = k
        if has_mid:
            mains[idx] = steps[-1]
            crosses[idx] = cross_mid
            idx += 1
        mains[idx:idx + k] = steps[::-1]
        crosses[idx:idx + k] = cross_b
        idx += k
        if has_mid:
            mains[idx] = steps[0]
            crosses[idx] = cross_mid
        arr = np.empty((2 * k + extra, 2), dtype=np.float64)
        if self.is_hori:
            arr[:, 0] = mains
            arr[:, 1] = crosses
        else:
            arr[:, 0] = crosses
            arr[:, 1] = mains
        return Polygon(np_xy=arr)

    @classmethod
    def build_char_polygon(cls, up: float, down: float,
                           left: float, right: float) -> Polygon:
        return Polygon.from_xy_pairs(
            [(left, up), (right, up), (right, down), (left, down)]
        )

    def to_char_quad_spans(self, page_height: int, page_width: int,
                           ref_char_height_ratio: float = 1.0,
                           ref_char_width_ratio: float = 1.0,
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized char-quad extents: (ups, downs, lefts, rights) as a
        (4, N) float64 array plus the same rounded to int64.

        The quads are axis-aligned rects, so these spans ARE the polygon
        bounds — callers that only need bounding windows (label-channel
        slice fills) can skip Polygon construction entirely.
        """
        assert len(self.char_boxes) == len(self.char_glyphs)
        n = len(self.char_boxes)
        raw = np.empty((6, n), dtype=np.float64)
        for i, (cb, glyph) in enumerate(zip(self.char_boxes, self.char_glyphs)):
            b = cb.box
            raw[0, i] = b.up
            raw[1, i] = b.down
            raw[2, i] = b.left
            raw[3, i] = b.right
            raw[4, i] = glyph.ref_char_height
            raw[5, i] = glyph.ref_char_width

        def expand(lo, hi, target, clamp_lo, clamp_hi):
            # Matches _expand_span: grow only when span < target, and the
            # clamp applies only on the grown branch.
            span = hi - lo + 1
            grow = (target - span) * 0.5
            need = span < target
            new_lo = np.where(need, np.maximum(clamp_lo, lo - grow), lo)
            new_hi = np.where(need, np.minimum(clamp_hi, hi + grow), hi)
            return new_lo, new_hi

        ref_h = raw[4] * ref_char_height_ratio
        ref_w = raw[5] * ref_char_width_ratio
        if self.is_hori:
            ups, downs = expand(raw[0], raw[1], ref_h, 0, page_height - 1)
            lefts, rights = expand(raw[2], raw[3], ref_w, 0, page_width - 1)
        else:
            # Vertical layout: the glyph's height metric runs across.
            lefts, rights = expand(raw[2], raw[3], ref_h, 0, page_width - 1)
            ups, downs = expand(raw[0], raw[1], ref_w,
                                self.box.up, page_height - 1)
        spans = np.stack([ups, downs, lefts, rights])
        # Banker's rounding, matching int(round(x)) on the scalar path.
        return spans, np.round(spans).astype(np.int64)

    @staticmethod
    def quad_spans_to_polygons(spans: np.ndarray) -> List[Polygon]:
        """Build the char quad Polygons from to_char_quad_spans output."""
        ups, downs, lefts, rights = spans
        n = spans.shape[1]
        quads = np.empty((n, 4, 2), dtype=np.float64)
        quads[:, 0, 0] = lefts
        quads[:, 0, 1] = ups
        quads[:, 1, 0] = rights
        quads[:, 1, 1] = ups
        quads[:, 2, 0] = rights
        quads[:, 2, 1] = downs
        quads[:, 3, 0] = lefts
        quads[:, 3, 1] = downs
        return [Polygon(np_xy=quads[i]) for i in range(n)]

    @staticmethod
    def batch_char_quad_spans(words: Sequence['TextLine'],
                              page_height: int, page_width: int,
                              ref_char_height_ratio: float = 1.0,
                              ref_char_width_ratio: float = 1.0,
                              ):
        """to_char_quad_spans over many words in ONE vectorized pass.

        Per-word calls see ~4-char arrays where numpy per-op overhead
        dominates; a page has hundreds of words, so flattening across
        words is ~20x cheaper.  Bitwise-identical to the per-word path
        (same elementwise op order).  Returns (spans, ispans, offsets)
        where word k owns columns offsets[k]:offsets[k+1].
        """
        counts = [len(w.char_boxes) for w in words]
        total = sum(counts)
        # Rows: up, down, left, right, target_y, target_x, clamp_lo_y.
        raw = np.empty((7, total), dtype=np.float64)
        i = 0
        for w in words:
            is_hori = w.is_hori
            clamp_lo_y = 0.0 if is_hori else float(w.box.up)
            for cb, glyph in zip(w.char_boxes, w.char_glyphs):
                b = cb.box
                raw[0, i] = b.up
                raw[1, i] = b.down
                raw[2, i] = b.left
                raw[3, i] = b.right
                rc_h = glyph.ref_char_height * ref_char_height_ratio
                rc_w = glyph.ref_char_width * ref_char_width_ratio
                if is_hori:
                    raw[4, i] = rc_h
                    raw[5, i] = rc_w
                else:
                    # Vertical layout: the glyph's height metric runs
                    # across.
                    raw[4, i] = rc_w
                    raw[5, i] = rc_h
                raw[6, i] = clamp_lo_y
                i += 1

        def expand(lo, hi, target, clamp_lo, clamp_hi):
            span = hi - lo + 1
            grow = (target - span) * 0.5
            need = span < target
            new_lo = np.where(need, np.maximum(clamp_lo, lo - grow), lo)
            new_hi = np.where(need, np.minimum(clamp_hi, hi + grow), hi)
            return new_lo, new_hi

        spans = np.empty((4, total), dtype=np.float64)
        spans[0], spans[1] = expand(raw[0], raw[1], raw[4],
                                    raw[6], page_height - 1)
        spans[2], spans[3] = expand(raw[2], raw[3], raw[5],
                                    0, page_width - 1)
        offsets = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return spans, np.round(spans).astype(np.int64), offsets

    @staticmethod
    def batch_quad_spans_to_polygons(spans: np.ndarray) -> List[Polygon]:
        """Alias of quad_spans_to_polygons for flattened batch spans."""
        return TextLine.quad_spans_to_polygons(spans)

    def to_char_polygons(self, page_height: int, page_width: int,
                         ref_char_height_ratio: float = 1.0,
                         ref_char_width_ratio: float = 1.0) -> List[Polygon]:
        """Char quads grown to the glyph reference metrics."""
        spans, _ = self.to_char_quad_spans(
            page_height, page_width, ref_char_height_ratio,
            ref_char_width_ratio,
        )
        return self.quad_spans_to_polygons(spans)

    def get_height_points(self, num_points: int, is_up: bool) -> PointList:
        """Evenly spread anchor points on the up (or down) long edge."""
        if self.is_hori:
            lo, hi = 0, self.box.right
            extent = self.box.width
            cross = self.box.up if is_up else self.box.down
        else:
            lo, hi = self.box.up, self.box.down
            extent = self.box.height
            cross = self.box.right if is_up else self.box.left
        step = max(1, extent // num_points)
        mains = list(range(lo, hi + 1, step))
        if len(mains) >= num_points:
            mains = mains[:num_points - 1] + [hi]
        return PointList(self._point_at(m, cross) for m in mains)

    def get_char_level_height_points(self, is_up: bool) -> PointList:
        """One anchor at each char box center on the up (or down) edge."""
        if self.is_hori:
            cross = self.box.up if is_up else self.box.down
            mains = [(cb.left + cb.right) / 2 for cb in self.char_boxes]
        else:
            cross = self.box.right if is_up else self.box.left
            mains = [(cb.up + cb.down) / 2 for cb in self.char_boxes]
        return PointList(self._point_at(m, cross) for m in mains)
