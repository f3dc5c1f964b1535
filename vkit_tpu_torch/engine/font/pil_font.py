"""Text-line rendering via PIL's FreeType binding.

Behavioral spec: vkit/engine/font/freetype.py:41-1175 (re-derived) — per-char
glyph build (tight trim, baseline metrics, gamma->alpha score map, per-tag
reference metrics), kerning-limit detection by sliding mask overlap, random
char/word spacing, horizontal + vertical layout, resize/pad/trim with
residual-pixel cleanup, and three renderers:

* ``freetype_default``    — grayscale antialiased,
* ``freetype_lcd``        — subpixel RGB coverage (3x horizontal oversampling),
* ``freetype_monochrome`` — 1-bit.

The reference drives freetype-py directly; here glyphs rasterize through
PIL/FreeType (same library underneath) with metrics from ``getbbox`` /
``getlength`` / ``getmetrics``.  Glyph placement computes all gaps up front
and lays chars by cumulative offsets instead of a stateful advance loop.
"""
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator
from PIL import Image as PilImage
from PIL import ImageDraw, ImageFont

from ...element import Box, Image, Interpolation, Mask, ScoreMap
from ...utility import sample_resize_interpolation
from ..interface import (
    Engine,
    EngineExecutorFactory,
    NoneTypeEngineInitConfig,
    NoneTypeEngineInitResource,
)
from .type import (
    CharBox,
    CharGlyph,
    FontEngineRunConfig,
    FontEngineRunConfigGlyphSequence,
    TextLine,
)


def estimate_font_size(config: FontEngineRunConfig) -> int:
    style = config.style
    if config.glyph_sequence == FontEngineRunConfigGlyphSequence.HORI_DEFAULT:
        font_size = round(config.height * style.font_size_ratio)
    elif config.glyph_sequence == FontEngineRunConfigGlyphSequence.VERT_DEFAULT:
        font_size = round(config.width * style.font_size_ratio)
    else:
        raise NotImplementedError()
    return int(np.clip(font_size, style.font_size_min, style.font_size_max))


@functools.lru_cache(maxsize=256)
def _load_pil_font(font_file: str, font_size: int, ttc_index: int) -> ImageFont.FreeTypeFont:
    return ImageFont.truetype(font_file, size=font_size, index=ttc_index)


def load_pil_font(run_config: FontEngineRunConfig, scale: int = 1) -> ImageFont.FreeTypeFont:
    font_variant = run_config.font_variant
    ttc_index = font_variant.ttc_font_index if font_variant.is_ttc else 0
    return _load_pil_font(
        str(font_variant.font_file),
        estimate_font_size(run_config) * scale,
        ttc_index or 0,
    )


def _rasterize_char(
    font: ImageFont.FreeTypeFont,
    char: str,
    mode: str,
) -> Tuple[np.ndarray, int, int, float]:
    """Render one char; returns (np_image, ascent, left_bearing, advance).

    ``np_image`` is the tight ink bitmap; ``ascent`` is the distance from the
    baseline up to the top-most ink scanline (may be negative, e.g. '_').
    """
    ascent_font, descent = font.getmetrics()
    # Canvas large enough for any glyph incl. negative bearings.
    advance = font.getlength(char)
    pad = max(8, int(font.size))
    canvas_w = int(advance) + 2 * pad
    canvas_h = ascent_font + descent + 2 * pad
    canvas = PilImage.new('L', (canvas_w, canvas_h), 0)
    draw = ImageDraw.Draw(canvas)
    draw.text((pad, pad), char, fill=255, font=font)
    np_canvas = np.array(canvas, dtype=np.uint8)

    if mode == 'mono':
        np_canvas = np.where(np_canvas >= 128, 255, 0).astype(np.uint8)

    ys, xs = np.nonzero(np_canvas)
    if len(ys) == 0:
        raise RuntimeError(f'empty glyph for char={char!r}')
    top, bottom = int(ys.min()), int(ys.max())
    left, right = int(xs.min()), int(xs.max())
    np_image = np_canvas[top:bottom + 1, left:right + 1]

    baseline_y = pad + ascent_font
    ascent = baseline_y - top
    left_bearing = left - pad
    return np_image, ascent, left_bearing, advance


def build_char_glyph(
    config: FontEngineRunConfig,
    char: str,
    np_image: np.ndarray,
    ascent: int,
    left_bearing: int,
    advance: float,
) -> CharGlyph:
    """Assemble a CharGlyph with baseline metrics + per-tag reference stats
    (freetype.py:136-221 semantics; bitmaps arrive pre-trimmed here so the
    vertical trim pads are zero by construction)."""
    assert not char.isspace()

    pad_left = max(0, left_bearing)
    pad_right = max(0, round(advance) - pad_left - np_image.shape[1])

    score_map = None
    if np_image.ndim == 2:
        np_alpha = np.power(
            np_image.astype(np.float32) / 255.0,
            config.style.glyph_color_gamma,
        )
        score_map = ScoreMap(mat=np_alpha)

    font_variant = config.font_variant
    tag_to_info = font_variant.font_glyph_info_collection.tag_to_font_glyph_info
    assert char in font_variant.char_to_tags

    glyph_info = None
    for tag in font_variant.char_to_tags[char]:
        candidate = tag_to_info[tag]
        if glyph_info is None:
            glyph_info = candidate
        else:
            assert glyph_info == candidate
    assert glyph_info is not None

    font_size = estimate_font_size(config)
    return CharGlyph(
        char=char,
        image=Image(mat=np_image),
        score_map=score_map,
        ascent=ascent,
        pad_up=0,
        pad_down=0,
        pad_left=pad_left,
        pad_right=pad_right,
        ref_ascent_plus_pad_up=round(
            glyph_info.ascent_plus_pad_up_min_to_font_size_ratio * font_size
        ),
        ref_char_height=round(glyph_info.height_min_to_font_size_ratio * font_size),
        ref_char_width=round(glyph_info.width_min_to_font_size_ratio * font_size),
    )


def render_char_glyphs_from_text(
    run_config: FontEngineRunConfig,
    font: ImageFont.FreeTypeFont,
    func_render_char_glyph: Callable[..., CharGlyph],
    chars: Sequence[str],
):
    """Rasterize non-space chars, tracking how many spaces precede each."""
    char_glyphs: List[CharGlyph] = []
    preceding_spaces: List[int] = []
    pending = 0
    for idx, char in enumerate(chars):
        if char.isspace():
            if idx == 0:
                raise RuntimeError('leading space')
            pending += 1
            continue
        char_glyphs.append(func_render_char_glyph(run_config, font, char))
        preceding_spaces.append(pending)
        pending = 0
    if pending:
        raise RuntimeError('trailing space')
    return char_glyphs, preceding_spaces


def _pair_kerning_limit(np_prev: np.ndarray, prev_up: int,
                        np_cur: np.ndarray, cur_up: int) -> int:
    """Max slide-left of `cur` before its ink touches `prev`'s ink."""
    overlap_up = max(prev_up, cur_up)
    overlap_down = min(prev_up + np_prev.shape[0] - 1,
                       cur_up + np_cur.shape[0] - 1)
    if overlap_up > overlap_down:
        return 0
    band_prev = np_prev[overlap_up - prev_up:overlap_down - prev_up + 1]
    band_cur = np_cur[overlap_up - cur_up:overlap_down - cur_up + 1]

    slide_max = min(np_prev.shape[1] / 2, np_cur.shape[1] / 2)
    slide = 1
    while slide < slide_max:
        if (band_prev[:, -slide:] & band_cur[:, :slide]).any():
            return slide - 1
        slide += 1
    return slide


# Kerning limits depend only on the glyph PAIR and their relative
# vertical offset (the band math is shift-invariant), so pairs recur
# constantly across lines.  Values cache keyed by glyph identity; the
# cached strong references pin the objects, so ids cannot recycle, and
# the `is` checks make hits exact.
_KERN_CACHE = {}


def get_kerning_limits_hori_default(
    char_glyphs: Sequence[CharGlyph],
    preceding_spaces: Sequence[int],
) -> List[int]:
    """Per-glyph slide-left allowance against its predecessor."""
    assert char_glyphs
    ascent_max = max(glyph.ascent for glyph in char_glyphs)
    ups = [ascent_max - glyph.ascent for glyph in char_glyphs]

    limits = [0]
    masks = [None] * len(char_glyphs)

    def mask(i):
        if masks[i] is None:
            masks[i] = char_glyphs[i].get_glyph_mask().mat
        return masks[i]

    if len(_KERN_CACHE) > 200_000:
        _KERN_CACHE.clear()
    for idx in range(1, len(char_glyphs)):
        if preceding_spaces[idx] > 0:
            limits.append(0)
            continue
        a = char_glyphs[idx - 1]
        b = char_glyphs[idx]
        key = (id(a), id(b), ups[idx] - ups[idx - 1])
        hit = _KERN_CACHE.get(key)
        if hit is not None and hit[1] is a and hit[2] is b:
            limits.append(hit[0])
            continue
        value = _pair_kerning_limit(
            mask(idx - 1), ups[idx - 1], mask(idx), ups[idx]
        )
        _KERN_CACHE[key] = (value, a, b)
        limits.append(value)
    return limits


def render_char_glyphs_in_text_line(
    style,
    text_line_height: int,
    text_line_width: int,
    char_glyphs: Sequence[CharGlyph],
    char_boxes: Sequence[CharBox],
):
    np_image = np.full((text_line_height, text_line_width, 3), 255, dtype=np.uint8)
    np_mask = np.zeros((text_line_height, text_line_width), dtype=np.uint8)
    score_map = None

    if char_glyphs[0].image.mat.ndim == 2:
        # Grayscale / mono: alpha-composite the glyph color.
        score_map = ScoreMap.from_shape((text_line_height, text_line_width))
        for char_glyph, char_box in zip(char_glyphs, char_boxes):
            assert char_glyph.score_map
            char_glyph_mask = char_glyph.get_glyph_mask(box=char_box.box)

            alpha = char_glyph.score_map.mat[..., None]
            np_char_image = (
                (1 - alpha) * 255.0 + alpha * np.asarray(style.glyph_color)
            )
            np_char_image = np.clip(np.round(np_char_image), 0, 255).astype(np.uint8)

            char_glyph_mask.fill_np_array(np_image, np_char_image)
            char_glyph_mask.fill_np_array(np_mask, 1)
            char_box.box.fill_score_map(
                score_map, char_glyph.score_map, keep_max_value=True
            )
    elif char_glyphs[0].image.mat.ndim == 3:
        # LCD subpixel coverage (glyph_color ignored, as the reference).
        for char_glyph, char_box in zip(char_glyphs, char_boxes):
            char_glyph_mask = char_glyph.get_glyph_mask(box=char_box.box)
            np_char_image = np.power(
                char_glyph.image.mat / 255.0, style.glyph_color_gamma
            )
            np_char_image = ((1 - np_char_image) * 255).astype(np.uint8)
            char_glyph_mask.fill_np_array(np_image, np_char_image)
            char_glyph_mask.fill_np_array(np_mask, 1)
    else:
        raise NotImplementedError()

    return Image(mat=np_image), Mask(mat=np_mask), score_map, char_boxes


def _sample_space(style, char_widths_avg, prev_num_spaces, rng) -> int:
    """Word gap for prev_num_spaces > 0, else a char gap."""
    if prev_num_spaces > 0:
        return sum(
            round(np.clip(
                rng.normal(loc=char_widths_avg * style.word_space_mean,
                           scale=char_widths_avg * style.word_space_std),
                char_widths_avg * style.word_space_min,
                char_widths_avg * style.word_space_max,
            )) for _ in range(prev_num_spaces)
        )
    if rng.random() < style.prob_set_char_space_min:
        return round(char_widths_avg * style.char_space_min)
    return round(np.clip(
        rng.normal(loc=char_widths_avg * style.char_space_mean,
                   scale=char_widths_avg * style.char_space_std),
        char_widths_avg * style.char_space_min,
        char_widths_avg * style.char_space_max,
    ))


def _sample_all_spaces(style, char_glyphs, preceding_spaces, rng) -> List[int]:
    """Vectorized twin of per-gap _sample_space calls (thousands of
    scalar rng.normal draws per page dominated layout planning).  Batched
    draws consume the generator differently than sequential scalars —
    per-draw distributions and the clip/round semantics are identical."""
    widths_avg = float(np.mean([glyph.width for glyph in char_glyphs]))
    pre = np.asarray(list(preceding_spaces), dtype=np.int64)
    out = np.zeros(len(pre), dtype=np.int64)

    word_pos = np.flatnonzero(pre > 0)
    if len(word_pos):
        counts = pre[word_pos]
        draws = np.round(np.clip(
            rng.normal(widths_avg * style.word_space_mean,
                       widths_avg * style.word_space_std,
                       int(counts.sum())),
            widths_avg * style.word_space_min,
            widths_avg * style.word_space_max,
        )).astype(np.int64)
        splits = np.cumsum(counts)[:-1]
        out[word_pos] = [int(seg.sum()) for seg in np.split(draws, splits)]

    char_pos = np.flatnonzero(pre == 0)
    if len(char_pos):
        use_min = rng.random(len(char_pos)) < style.prob_set_char_space_min
        vals = np.full(len(char_pos),
                       round(widths_avg * style.char_space_min),
                       dtype=np.int64)
        rest = np.flatnonzero(~use_min)
        if len(rest):
            vals[rest] = np.round(np.clip(
                rng.normal(widths_avg * style.char_space_mean,
                           widths_avg * style.char_space_std, len(rest)),
                widths_avg * style.char_space_min,
                widths_avg * style.char_space_max,
            )).astype(np.int64)
        out[char_pos] = vals
    return out.tolist()


def compute_char_boxes_hori(
    style,
    char_glyphs: Sequence[CharGlyph],
    prev_num_spaces_for_char_glyphs: Sequence[int],
    kerning_limits: Sequence[int],
    rng: RandomGenerator,
):
    """Baseline-aligned horizontal packing by cumulative offsets.

    Pure layout math (no painting) — shared by the host renderer below and
    the device glyph-compositing path (engine/font/atlas.py), so both
    produce IDENTICAL char boxes for the same rng stream."""
    assert char_glyphs
    spaces = _sample_all_spaces(style, char_glyphs, prev_num_spaces_for_char_glyphs, rng)

    baseline = max(
        max(g.ascent + g.pad_up for g in char_glyphs),
        max(g.ref_ascent_plus_pad_up for g in char_glyphs),
    )

    # left[i] = left[i-1] + width[i-1] + pad_right[i-1]
    #           + space[i] - kerning[i] + pad_left[i];  left[0] = 0.
    lefts: List[int] = [0]
    for idx in range(1, len(char_glyphs)):
        prev = char_glyphs[idx - 1]
        lefts.append(
            lefts[-1] + prev.width + prev.pad_right
            + spaces[idx] - kerning_limits[idx] + char_glyphs[idx].pad_left
        )

    char_boxes: List[CharBox] = []
    for glyph, left in zip(char_glyphs, lefts):
        up = baseline - glyph.ascent
        char_boxes.append(CharBox(
            char=glyph.char,
            box=Box(up, up + glyph.height - 1, left, left + glyph.width - 1),
        ))

    line_height = max(
        max(g.ref_char_height for g in char_glyphs),
        max(cb.down + 1 + g.pad_down for cb, g in zip(char_boxes, char_glyphs)),
    )
    line_width = char_boxes[-1].right + 1
    return char_boxes, line_height, line_width


def place_char_glyphs_in_text_line_hori_default(
    run_config: FontEngineRunConfig,
    char_glyphs: Sequence[CharGlyph],
    prev_num_spaces_for_char_glyphs: Sequence[int],
    kerning_limits: Sequence[int],
    rng: RandomGenerator,
):
    style = run_config.style
    char_boxes, line_height, line_width = compute_char_boxes_hori(
        style, char_glyphs, prev_num_spaces_for_char_glyphs,
        kerning_limits, rng,
    )
    return render_char_glyphs_in_text_line(
        style=style,
        text_line_height=line_height,
        text_line_width=line_width,
        char_glyphs=char_glyphs,
        char_boxes=char_boxes,
    )


def compute_char_boxes_vert(
    style,
    char_glyphs: Sequence[CharGlyph],
    prev_num_spaces_for_char_glyphs: Sequence[int],
    rng: RandomGenerator,
):
    """Center-aligned vertical packing by cumulative offsets (layout only;
    see compute_char_boxes_hori)."""
    assert char_glyphs
    spaces = _sample_all_spaces(style, char_glyphs, prev_num_spaces_for_char_glyphs, rng)

    line_width = max(
        max(g.pad_left + g.width + g.pad_right for g in char_glyphs),
        max(g.ref_char_width for g in char_glyphs),
    )
    center = line_width // 2

    ups: List[int] = [0]
    for idx in range(1, len(char_glyphs)):
        prev = char_glyphs[idx - 1]
        ups.append(
            ups[-1] + prev.height + prev.pad_down
            + spaces[idx] + char_glyphs[idx].pad_up
        )

    char_boxes: List[CharBox] = []
    for glyph, up in zip(char_glyphs, ups):
        left = center - glyph.width // 2
        char_boxes.append(CharBox(
            char=glyph.char,
            box=Box(up, up + glyph.height - 1, left, left + glyph.width - 1),
        ))

    return char_boxes, char_boxes[-1].down + 1, line_width


def place_char_glyphs_in_text_line_vert_default(
    run_config: FontEngineRunConfig,
    char_glyphs: Sequence[CharGlyph],
    prev_num_spaces_for_char_glyphs: Sequence[int],
    rng: RandomGenerator,
):
    style = run_config.style
    char_boxes, line_height, line_width = compute_char_boxes_vert(
        style, char_glyphs, prev_num_spaces_for_char_glyphs, rng,
    )
    return render_char_glyphs_in_text_line(
        style=style,
        text_line_height=line_height,
        text_line_width=line_width,
        char_glyphs=char_glyphs,
        char_boxes=char_boxes,
    )


def _fit_cross_axis(run_config, image, mask, score_map, char_boxes,
                    interpolation_enlarge, interpolation_shrink, is_hori):
    """Resize to the target cross extent and center-pad the remainder."""
    target = run_config.height if is_hori else run_config.width
    current = image.height if is_hori else image.width
    too_small = current / target < 0.8
    too_large = current > target
    interpolation = interpolation_shrink if too_large else interpolation_enlarge

    if too_small or too_large:
        resize_kw = {'resized_height': target} if is_hori else {'resized_width': target}
        char_boxes = [
            cb.to_conducted_resized_char_box(image, **resize_kw) for cb in char_boxes
        ]
        if score_map:
            score_map = score_map.to_resized_score_map(
                **resize_kw, interpolation=interpolation
            )
        new_image = image.to_resized_image(**resize_kw, interpolation=interpolation)
        mask = mask.to_resized_mask(**resize_kw, interpolation=interpolation)
        image = new_image

    current = image.height if is_hori else image.width
    if current != target:
        pad = target - current
        assert pad > 0
        pad_lo = pad // 2
        pad_hi = pad - pad_lo

        if is_hori:
            shape3 = (target, image.width, 3)
            shape2 = (target, image.width)
            sel = (slice(pad_lo, -pad_hi), slice(None))
            shift = {'up': pad_lo, 'down': pad_lo}
        else:
            shape3 = (image.height, target, 3)
            shape2 = (image.height, target)
            sel = (slice(None), slice(pad_lo, -pad_hi))
            shift = {'left': pad_lo, 'right': pad_lo}

        np_image = np.full(shape3, 255, dtype=np.uint8)
        np_image[sel] = image.mat
        image.assign_mat(np_image)
        np_mask = np.zeros(shape2, dtype=np.uint8)
        np_mask[sel] = mask.mat
        mask.assign_mat(np_mask)
        char_boxes = [
            CharBox(cb.char, cb.box._replace(
                **{k: getattr(cb.box, k) + v for k, v in shift.items()}
            )) for cb in char_boxes
        ]
        if score_map:
            np_sm = np.zeros(shape2, dtype=np.float32)
            np_sm[sel] = score_map.mat
            score_map = ScoreMap(mat=np_sm)

    return image, mask, score_map, char_boxes, interpolation


def _find_last_fitting_char(char_boxes, limit: int, is_hori: bool) -> int:
    """Index of the last char box fully inside [0, limit); -1 if none."""
    edge = (lambda cb: cb.right) if is_hori else (lambda cb: cb.down)
    last = len(char_boxes) - 1
    while last >= 0 and edge(char_boxes[last]) >= limit:
        last -= 1
    if last == len(char_boxes) - 1:
        # Overflow caused by trailing glyph padding: drop the last char.
        last -= 1
    if last >= 0 and edge(char_boxes[last]) >= limit:
        return -1
    return last


def _erase_residual_glyph(image, mask, score_map, char_boxes, char_glyphs,
                          last_idx, interpolation):
    """Scrub pixels of the first dropped char that bleed into the kept span."""
    kept_box = char_boxes[last_idx]
    dropped_box = char_boxes[last_idx + 1]
    if dropped_box.left > kept_box.right:
        return

    dropped_glyph = char_glyphs[last_idx + 1]
    dropped_mask = dropped_glyph.get_glyph_mask(
        box=dropped_box.box, enable_resize=True, interpolation=interpolation
    )
    dropped_mask.fill_image(image, (255, 255, 255))
    dropped_mask.fill_mask(mask, 0)

    if dropped_glyph.score_map and score_map:
        kept_sm = char_glyphs[last_idx].score_map
        assert kept_sm
        if kept_sm.shape != kept_box.shape:
            kept_sm = kept_sm.to_resized_score_map(
                resized_height=kept_box.height,
                resized_width=kept_box.width,
                interpolation=interpolation,
            )
        # Zero the dropped char's area, then restore the kept char's alpha.
        dropped_box.box.fill_score_map(score_map, 0)
        kept_box.box.fill_score_map(score_map, kept_sm, keep_max_value=True)


def resize_and_trim_text_line_hori_default(
    run_config: FontEngineRunConfig,
    interpolation_enlarge: Interpolation,
    interpolation_shrink: Interpolation,
    image: Image,
    mask: Mask,
    score_map: Optional[ScoreMap],
    char_boxes: Sequence[CharBox],
    char_glyphs: Sequence[CharGlyph],
):
    image, mask, score_map, char_boxes, interpolation = _fit_cross_axis(
        run_config, image, mask, score_map, char_boxes,
        interpolation_enlarge, interpolation_shrink, is_hori=True,
    )

    if image.width > run_config.width:
        last_idx = _find_last_fitting_char(char_boxes, run_config.width, True)
        if last_idx < 0:
            return None, None, None, None, None
        _erase_residual_glyph(image, mask, score_map, char_boxes, char_glyphs,
                              last_idx, interpolation)
        edge = char_boxes[last_idx].right
        char_boxes = char_boxes[:last_idx + 1]
        image.assign_mat(image.mat[:, :edge + 1])
        mask.assign_mat(mask.mat[:, :edge + 1])
        if score_map:
            score_map.assign_mat(score_map.mat[:, :edge + 1])

    return image, mask, score_map, char_boxes, interpolation


def resize_and_trim_text_line_vert_default(
    run_config: FontEngineRunConfig,
    interpolation_enlarge: Interpolation,
    interpolation_shrink: Interpolation,
    image: Image,
    mask: Mask,
    score_map: Optional[ScoreMap],
    char_boxes: Sequence[CharBox],
):
    image, mask, score_map, char_boxes, interpolation = _fit_cross_axis(
        run_config, image, mask, score_map, char_boxes,
        interpolation_enlarge, interpolation_shrink, is_hori=False,
    )

    if image.height > run_config.height:
        last_idx = _find_last_fitting_char(char_boxes, run_config.height, False)
        if last_idx < 0:
            return None, None, None, None, None
        edge = char_boxes[last_idx].down
        char_boxes = char_boxes[:last_idx + 1]
        image.assign_mat(image.mat[:edge + 1])
        mask.assign_mat(mask.mat[:edge + 1])
        if score_map:
            score_map.assign_mat(score_map.mat[:edge + 1])

    return image, mask, score_map, char_boxes, interpolation


def render_text_line_meta(
    run_config: FontEngineRunConfig,
    font: ImageFont.FreeTypeFont,
    func_render_char_glyph: Callable[..., CharGlyph],
    rng: RandomGenerator,
    interpolation_enlarge: Interpolation = Interpolation.CUBIC,
    interpolation_shrink: Interpolation = Interpolation.AREA,
) -> Optional[TextLine]:
    char_glyphs, preceding_spaces = render_char_glyphs_from_text(
        run_config=run_config,
        font=font,
        func_render_char_glyph=func_render_char_glyph,
        chars=run_config.chars,
    )
    if not char_glyphs:
        return None

    is_hori = (
        run_config.glyph_sequence == FontEngineRunConfigGlyphSequence.HORI_DEFAULT
    )
    if is_hori:
        kerning_limits = get_kerning_limits_hori_default(char_glyphs, preceding_spaces)
        placed = place_char_glyphs_in_text_line_hori_default(
            run_config, char_glyphs, preceding_spaces, kerning_limits, rng
        )
        image, mask, score_map, char_boxes, interpolation = (
            resize_and_trim_text_line_hori_default(
                run_config, interpolation_enlarge, interpolation_shrink,
                *placed[:3], placed[3], char_glyphs,
            )
        )
    else:
        placed = place_char_glyphs_in_text_line_vert_default(
            run_config, char_glyphs, preceding_spaces, rng
        )
        image, mask, score_map, char_boxes, interpolation = (
            resize_and_trim_text_line_vert_default(
                run_config, interpolation_enlarge, interpolation_shrink,
                *placed[:3], placed[3],
            )
        )

    if image is None:
        return None
    assert mask is not None and char_boxes is not None

    # The rendered text covers chars up to the last kept glyph.
    char_idx = 0
    kept = 0
    while char_idx < len(run_config.chars) and kept < len(char_boxes):
        if not run_config.chars[char_idx].isspace():
            kept += 1
        char_idx += 1
    assert kept == len(char_boxes)

    anchor = Box.from_shapable(image)
    image = image.to_box_attached(anchor)
    mask = mask.to_box_attached(anchor)
    if score_map:
        score_map = score_map.to_box_attached(anchor)

    return TextLine(
        image=image,
        mask=mask,
        score_map=score_map,
        char_boxes=char_boxes,
        char_glyphs=char_glyphs[:len(char_boxes)],
        resize_interpolation=interpolation or Interpolation.CUBIC,
        font_size=estimate_font_size(run_config),
        style=run_config.style,
        text=''.join(run_config.chars[:char_idx]),
        is_hori=is_hori,
        font_variant=run_config.font_variant if run_config.return_font_variant else None,
    )


def _run_renderer(engine_cls, run_config: FontEngineRunConfig,
                  rng: RandomGenerator, scale: int = 1) -> Optional[TextLine]:
    font = load_pil_font(run_config, scale=scale)
    return render_text_line_meta(
        run_config=run_config,
        font=font,
        func_render_char_glyph=engine_cls.render_char_glyph,
        rng=rng,
        interpolation_enlarge=sample_resize_interpolation(rng),
        interpolation_shrink=sample_resize_interpolation(rng, include_area=True),
    )


class FontFreetypeDefaultEngine(
    Engine[NoneTypeEngineInitConfig, NoneTypeEngineInitResource, FontEngineRunConfig, Optional[TextLine]]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'freetype_default'

    @classmethod
    def render_char_glyph(cls, run_config, font, char: str) -> CharGlyph:
        np_image, ascent, left_bearing, advance = _rasterize_char(font, char, 'aa')
        return build_char_glyph(run_config, char, np_image, ascent, left_bearing, advance)

    def run(self, run_config: FontEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Optional[TextLine]:
        assert rng is not None
        return _run_renderer(type(self), run_config, rng)


font_freetype_default_engine_executor_factory = EngineExecutorFactory(
    FontFreetypeDefaultEngine
)


class FontFreetypeLcdEngine(
    Engine[NoneTypeEngineInitConfig, NoneTypeEngineInitResource, FontEngineRunConfig, Optional[TextLine]]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'freetype_lcd'

    @classmethod
    def render_char_glyph(cls, run_config, font, char: str) -> CharGlyph:
        # Subpixel coverage from 3x oversampling: the big grayscale glyph's
        # column triplets become the R/G/B coverage channels.
        np_big, ascent3, left_bearing3, advance3 = _rasterize_char(font, char, 'aa')
        height3 = np_big.shape[0]
        height = max(1, round(height3 / 3))
        width3_pad = (-np_big.shape[1]) % 3
        if width3_pad:
            np_big = np.pad(np_big, ((0, 0), (0, width3_pad)))
        width = np_big.shape[1] // 3

        from ...ops.resize_taps import resize_np
        np_rows = resize_np(np_big, (height, np_big.shape[1]), Interpolation.AREA)
        np_image = np_rows.reshape(height, width, 3)

        return build_char_glyph(
            run_config,
            char,
            np_image,
            round(ascent3 / 3),
            round(left_bearing3 / 3),
            advance3 / 3,
        )

    def run(self, run_config: FontEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Optional[TextLine]:
        assert rng is not None
        return _run_renderer(type(self), run_config, rng, scale=3)


font_freetype_lcd_engine_executor_factory = EngineExecutorFactory(FontFreetypeLcdEngine)


class FontFreetypeMonochromeEngine(
    Engine[NoneTypeEngineInitConfig, NoneTypeEngineInitResource, FontEngineRunConfig, Optional[TextLine]]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'freetype_monochrome'

    @classmethod
    def render_char_glyph(cls, run_config, font, char: str) -> CharGlyph:
        np_image, ascent, left_bearing, advance = _rasterize_char(font, char, 'mono')
        return build_char_glyph(run_config, char, np_image, ascent, left_bearing, advance)

    def run(self, run_config: FontEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Optional[TextLine]:
        assert rng is not None
        return _run_renderer(type(self), run_config, rng)


font_freetype_monochrome_engine_executor_factory = EngineExecutorFactory(
    FontFreetypeMonochromeEngine
)
