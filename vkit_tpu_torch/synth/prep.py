"""Host-side page prep for the batched device synthesis pipeline.

Per page (all cheap, numpy/host): sample a layout (the same PageLayoutStep
the 17-step pipeline uses), sample chars + font per layout line, lay the
line out with the glyph atlas (NO host painting), and rasterize the
pre-distortion label channels from the label polygons.  The output is a
HostPage of flat tensors + glyph placement entries that synth.device
consumes.

Behavioral spec: vkit/pipeline/text_detection/{page_layout,page_text_line,
page_text_line_label,page_distortion}.py — the label channels here are the
pre-warp form of what page_distortion regenerates post-warp; synth.device
warps them alongside the image and corrects heights by the local stretch.
"""
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ..element import Box, LexiconCollection, Polygon, ScoreMap
from ..engine.char_and_font_sampler import (
    CharAndFontSamplerEngineRunConfig,
    char_and_font_sampler_engine_executor_factory,
)
from ..engine.char_sampler import (
    char_sampler_engine_executor_aggregator_factory,
)
from ..engine.font import (
    FontCollection,
    FontEngineRunConfig,
    FontEngineRunConfigStyle,
    TextLine,
)
from ..engine.font.atlas import (
    get_glyph_atlas,
    layout_to_text_line,
    plan_text_line_layout,
)
from ..pipeline.text_detection.page_layout import (
    PageLayoutStep,
    PageLayoutStepConfig,
    PageLayoutStepInput,
)
from ..pipeline.text_detection.page_shape import PageShapeStepOutput
from ..utility import PathType, normalize_to_keys_and_probs, rng_choice

# Same gates as PageTextLineStep (page_text_line.py _GLYPH_COLOR_GATES).
_GLYPH_COLOR_GATES = {
    'grayscale': None,
    'red': (1, 0, 0),
    'green': (0, 1, 0),
    'blue': (0, 0, 1),
}

# Label channel indices in HostPage.label_stack / SynthBatchResult.
TEXT_LINE_MASK = 0
TEXT_LINE_HEIGHT = 1
CHAR_MASK = 2
CHAR_HEIGHT = 3
NUM_LABEL_CHANNELS = 4


@attr.define
class SynthPlannerConfig:
    lexicon_collection_json: str
    font_collection_folder: str
    char_sampler_configs: Union[Sequence[Mapping[str, Any]], PathType]
    page_height: int = 640
    page_width: int = 640
    font_style: FontEngineRunConfigStyle = attr.field(
        factory=FontEngineRunConfigStyle
    )
    layout_config: Optional[Mapping[str, Any]] = None
    background_grayscale_min: int = 127
    background_grayscale_max: int = 255
    # Auxiliary page content (page_assembler.py layer parity).  None
    # disables a layer; the defaults reproduce the flat-tone text-only
    # pages of earlier rounds.
    background_image_configs: Optional[
        Union[Sequence[Mapping[str, Any]], PathType]
    ] = None
    weight_background_image: float = 0.8
    image_configs: Optional[
        Union[Sequence[Mapping[str, Any]], PathType]
    ] = None
    symbol_image_folders: Optional[Sequence[str]] = None
    enable_barcodes: bool = False
    enable_seal_impressions: bool = False
    seal_impression_configs: Optional[
        Union[Sequence[Mapping[str, Any]], PathType]
    ] = None
    seal_text_font_configs: Optional[
        Union[Sequence[Mapping[str, Any]], PathType]
    ] = None
    enable_text_line_bounding_boxes: bool = False
    # Glyph color sampling (page_text_line.py defaults).
    weight_glyph_color_grayscale: float = 0.9
    glyph_color_grayscale_min: int = 0
    glyph_color_grayscale_max: int = 100
    weight_glyph_color_red: float = 0.06
    weight_glyph_color_green: float = 0.01
    weight_glyph_color_blue: float = 0.03
    glyph_color_rgb_min: int = 100
    glyph_color_rgb_max: int = 255
    # Char polygon expansion (page_text_line_label.py semantics).
    ref_char_height_ratio: float = 1.0
    ref_char_width_ratio: float = 1.0


@attr.define
class OverlayEntry:
    """One ABOVE-TEXT patch for the device overlay compositor (symbols,
    seal stamps — page_assembler.py's post-text layers)."""
    alpha: np.ndarray                 # (h, w) float32 in [0, 1]
    up: int
    left: int
    color: Tuple[int, int, int]       # mono blend color...
    rgb: Optional[np.ndarray] = None  # ...or an (h, w, 3) RGB patch


@attr.define
class HostPage:
    """One prepared page: the flat-tensor input of the device program."""
    background: np.ndarray            # (H, W, 3) uint8
    label_stack: np.ndarray           # (H, W, 4) float32
    # (layout, (up, left), color, atlas) per PLACED text line.
    line_entries: List[Tuple]
    text_lines: List[TextLine]        # word-split, blank-raster lines
    word_polygons: List[Polygon]
    char_polygons: List[Polygon]
    overlay_entries: List[OverlayEntry] = attr.field(factory=list)


class SynthPlanner:

    def __init__(self, config: SynthPlannerConfig):
        self.config = config
        lexicon_collection = LexiconCollection.from_file(
            config.lexicon_collection_json
        )
        font_collection = FontCollection.from_folder(
            config.font_collection_folder
        )
        aggregator = (
            char_sampler_engine_executor_aggregator_factory
            .create_with_repeated_init_resource(
                config.char_sampler_configs,
                {'lexicon_collection': lexicon_collection},
            )
        )
        self.char_and_font_sampler = (
            char_and_font_sampler_engine_executor_factory.create(
                {},
                {
                    'lexicon_collection': lexicon_collection,
                    'font_collection': font_collection,
                    'char_sampler_engine_executor_aggregator': aggregator,
                },
            )
        )
        self.layout_step = PageLayoutStep(
            PageLayoutStepConfig(**(config.layout_config or {}))
        )
        self.color_keys, self.color_probs = normalize_to_keys_and_probs([
            ('grayscale', config.weight_glyph_color_grayscale),
            ('red', config.weight_glyph_color_red),
            ('green', config.weight_glyph_color_green),
            ('blue', config.weight_glyph_color_blue),
        ])

        # Auxiliary content steps (page_assembler.py layer parity),
        # instantiated only when configured.
        self.background_step = None
        if config.background_image_configs:
            from ..pipeline.text_detection.page_background import (
                PageBackgroundStep,
                PageBackgroundStepConfig,
            )
            self.background_step = PageBackgroundStep(PageBackgroundStepConfig(
                image_configs=config.background_image_configs,
                weight_image=config.weight_background_image,
                weight_random_grayscale=1.0 - config.weight_background_image,
                grayscale_min=config.background_grayscale_min,
                grayscale_max=config.background_grayscale_max,
            ))
        self.image_step = None
        if config.image_configs:
            from ..pipeline.text_detection.page_image import (
                PageImageStep,
                PageImageStepConfig,
            )
            self.image_step = PageImageStep(
                PageImageStepConfig(image_configs=config.image_configs)
            )
        self.barcode_step = None
        if config.enable_barcodes:
            from ..pipeline.text_detection.page_barcode import (
                PageBarcodeStep,
                PageBarcodeStepConfig,
            )
            self.barcode_step = PageBarcodeStep(PageBarcodeStepConfig())
        self.symbol_step = None
        if config.symbol_image_folders:
            from ..pipeline.text_detection.page_non_text_symbol import (
                PageNonTextSymbolStep,
                PageNonTextSymbolStepConfig,
            )
            self.symbol_step = PageNonTextSymbolStep(
                PageNonTextSymbolStepConfig(
                    symbol_image_folders=list(config.symbol_image_folders)
                )
            )
        self.bounding_box_step = None
        if config.enable_text_line_bounding_boxes:
            from ..pipeline.text_detection.page_text_line_bounding_box import (
                PageTextLineBoundingBoxStep,
                PageTextLineBoundingBoxStepConfig,
            )
            self.bounding_box_step = PageTextLineBoundingBoxStep(
                PageTextLineBoundingBoxStepConfig()
            )
        self.seal_step = None
        self.seal_text_step = None
        if config.enable_seal_impressions:
            from ..pipeline.text_detection.page_seal_impression import (
                PageSealImpresssionStep,
                PageSealImpresssionStepConfig,
            )
            from ..pipeline.text_detection.page_text_line import (
                PageTextLineStep,
                PageTextLineStepConfig,
            )
            self.seal_step = PageSealImpresssionStep(
                PageSealImpresssionStepConfig(
                    seal_impression_configs=(
                        config.seal_impression_configs
                        or [{'type': 'ellipse', 'weight': 1, 'config': {}}]
                    )
                )
            )
            # Seal slot text renders through the host font engine (arc
            # char slots need real rasters, not atlas tiles); reuse
            # PageTextLineStep's seal-resource machinery.
            self.seal_text_step = PageTextLineStep(PageTextLineStepConfig(
                lexicon_collection_json=config.lexicon_collection_json,
                font_collection_folder=config.font_collection_folder,
                char_sampler_configs=config.char_sampler_configs,
                font_configs=(
                    config.seal_text_font_configs
                    or [{'type': 'freetype_default', 'weight': 1,
                         'config': {}}]
                ),
            ))

    # -- sampling helpers (page_text_line.py semantics) -------------------

    def _sample_glyph_color(self, rng: RandomGenerator) -> Tuple[int, int, int]:
        cfg = self.config
        gate = _GLYPH_COLOR_GATES[
            rng_choice(rng, self.color_keys, probs=self.color_probs)
        ]
        if gate is None:
            tone = int(rng.integers(cfg.glyph_color_grayscale_min,
                                    cfg.glyph_color_grayscale_max + 1))
            return (tone, tone, tone)
        value = int(rng.integers(cfg.glyph_color_rgb_min,
                                 cfg.glyph_color_rgb_max + 1))
        return tuple(value * g for g in gate)  # type: ignore[return-value]

    def _sample_char_and_font(self, box: Box, rng: RandomGenerator):
        for _ in range(3):
            out = self.char_and_font_sampler.run(
                run_config=CharAndFontSamplerEngineRunConfig(
                    height=box.height, width=box.width,
                ),
                rng=rng,
            )
            if out:
                return out
        return None

    # -- page prep ---------------------------------------------------------

    def prepare_page(self, rng: RandomGenerator) -> HostPage:
        cfg = self.config
        height, width = cfg.page_height, cfg.page_width

        layout_out = self.layout_step.run(
            PageLayoutStepInput(
                page_shape_step_output=PageShapeStepOutput(
                    height=height, width=width
                )
            ),
            rng,
        )
        layout = layout_out.page_layout

        # Below-text layers (page_assembler.py order: background <- photos
        # <- barcodes <- decorative boxes), composited on host — small
        # irregular patches, exactly the work that does NOT belong on the
        # MXU.  Text glyphs and the above-text layers ride the device
        # compositor instead.
        from ..element import Image as _Image
        if self.background_step is not None:
            from ..pipeline.text_detection.page_background import (
                PageBackgroundStepInput,
            )
            canvas = self.background_step.run(
                PageBackgroundStepInput(
                    page_shape_step_output=PageShapeStepOutput(
                        height=height, width=width
                    )
                ),
                rng,
            ).background_image.copy()
        else:
            tone = int(rng.integers(cfg.background_grayscale_min,
                                    cfg.background_grayscale_max + 1))
            canvas = _Image(
                mat=np.full((height, width, 3), tone, dtype=np.uint8)
            ).copy()

        if self.image_step is not None:
            from ..pipeline.text_detection.page_image import (
                PageImageStepInput,
            )
            photos = self.image_step.run(
                PageImageStepInput(page_layout_step_output=layout_out), rng
            ).page_image_collection
            for photo in photos.page_images:
                photo.box.fill_image(canvas, photo.image, alpha=photo.alpha)

        if self.barcode_step is not None:
            from ..pipeline.text_detection.page_barcode import (
                PageBarcodeStepInput,
            )
            barcodes = self.barcode_step.run(
                PageBarcodeStepInput(page_layout_step_output=layout_out), rng
            )
            for score_map in (*barcodes.barcode_qr_score_maps,
                              *barcodes.barcode_code39_score_maps):
                canvas[score_map] = (0, 0, 0)

        line_entries: List[Tuple] = []
        text_lines: List[TextLine] = []
        for layout_text_line in layout.layout_text_lines:
            box = layout_text_line.box
            char_and_font = self._sample_char_and_font(box, rng)
            if char_and_font is None:
                continue
            color = self._sample_glyph_color(rng)
            style = attr.evolve(cfg.font_style, glyph_color=color)
            run_config = FontEngineRunConfig(
                height=box.height,
                width=box.width,
                chars=char_and_font.chars,
                font_variant=char_and_font.font_variant,
                glyph_sequence=layout_text_line.glyph_sequence,
                style=style,
            )
            try:
                text_layout = plan_text_line_layout(run_config, rng)
            except RuntimeError:
                continue
            if text_layout is None:
                continue
            atlas = get_glyph_atlas(run_config)
            line_entries.append(
                (text_layout, (box.up, box.left), color, atlas)
            )
            placed = layout_to_text_line(
                text_layout, atlas, style, run_config.chars
            ).to_shifted_text_line(offset_y=box.up, offset_x=box.left)
            text_lines.extend(placed.split())

        if self.bounding_box_step is not None and text_lines:
            # Decorative frames draw below the glyphs; host-composite into
            # the background (the device compositor adds glyphs on top).
            from ..pipeline.text_detection.page_text_line import (
                PageTextLineCollection,
            )
            from ..pipeline.text_detection.page_text_line_bounding_box import (
                PageTextLineBoundingBoxStepInput,
            )

            class _TLWrap:
                page_text_line_collection = PageTextLineCollection(
                    height=height, width=width, text_lines=text_lines,
                    short_text_line_flags=[False] * len(text_lines),
                )
            frames = self.bounding_box_step.run(
                PageTextLineBoundingBoxStepInput(
                    page_text_line_step_output=_TLWrap()
                ),
                rng,
            )
            for score_map, color in zip(frames.score_maps, frames.colors):
                canvas[score_map] = color

        # Above-text layers -> device overlay patches (symbols, seals).
        overlay_entries: List[OverlayEntry] = []
        if self.symbol_step is not None:
            from ..pipeline.text_detection.page_non_text_symbol import (
                PageNonTextSymbolStepInput,
            )
            symbols = self.symbol_step.run(
                PageNonTextSymbolStepInput(page_layout_step_output=layout_out),
                rng,
            )
            for image, box, alpha in zip(symbols.images, symbols.boxes,
                                         symbols.alphas):
                np_img = np.asarray(image.mat)
                if np_img.ndim == 2:
                    np_img = np.repeat(np_img[:, :, None], 3, axis=2)
                if isinstance(alpha, np.ndarray):
                    alpha_map = alpha.astype(np.float32)
                else:
                    alpha_map = np.full(np_img.shape[:2], float(alpha),
                                        dtype=np.float32)
                overlay_entries.append(OverlayEntry(
                    alpha=alpha_map, up=box.up, left=box.left,
                    color=(0, 0, 0), rgb=np_img.astype(np.float32),
                ))
        if self.seal_step is not None:
            overlay_entries.extend(
                self._prepare_seals(layout_out, rng, height, width)
            )

        # Pre-distortion label channels, filled IN PLACE in the final
        # (H, W, 4) buffer: a separate-mats-then-stack build pays a full
        # fresh-allocation fault + copy per page (~32 ms at 640^2) while
        # the fills only touch label windows.
        label_stack = np.zeros((height, width, 4), dtype=np.float32)
        tl_mask_mat = label_stack[..., 0]
        tl_height_mat = label_stack[..., 1]
        ch_mask_mat = label_stack[..., 2]
        ch_height_mat = label_stack[..., 3]

        word_polygons: List[Polygon] = []
        kept_words: List = []
        for word in text_lines:
            if word.box.height < 2 or word.box.width < 2:
                continue  # degenerate sliver (e.g. a lone 1-px-wide glyph)
            kept_words.append(word)
            word_polygons.append(word.to_polygon())
            # The word outline region IS its bounding rect (to_polygon's
            # anchors ride the box edges): direct slice fills replace the
            # generic polygon rasterizer, like the char channels below.
            wb = word.box
            w_up = max(int(wb.up), 0)
            w_down = min(int(wb.down), height - 1)
            w_left = max(int(wb.left), 0)
            w_right = min(int(wb.right), width - 1)
            if w_down >= w_up and w_right >= w_left:
                window = (slice(w_up, w_down + 1),
                          slice(w_left, w_right + 1))
                tl_mask_mat[window] = 1.0
                tl_height_mat[window] = float(wb.height)

        # One vectorized quad-span pass over every kept word (per-word
        # calls see ~4-char arrays where numpy overhead dominates).
        char_polygons: List[Polygon] = []
        if kept_words:
            from ..engine.font.type import TextLine
            spans, ispans, offsets = TextLine.batch_char_quad_spans(
                kept_words, page_height=height, page_width=width,
                ref_char_height_ratio=cfg.ref_char_height_ratio,
                ref_char_width_ratio=cfg.ref_char_width_ratio,
            )
            char_polygons = TextLine.quad_spans_to_polygons(spans)
            # Char polygons are axis-aligned rectangles (ref-metric box
            # expansion), so the quad spans ARE the fill windows: direct
            # slice fills are ~50x the generic polygon rasterizer here
            # (tens of thousands of tiny fills per page batch).
            ups = np.maximum(ispans[0], 0)
            downs = np.minimum(ispans[1], height - 1)
            lefts = np.maximum(ispans[2], 0)
            rights = np.minimum(ispans[3], width - 1)
            for w_idx, word in enumerate(kept_words):
                base = offsets[w_idx]
                for k, char_box in enumerate(word.char_boxes):
                    j = base + k
                    up, down = ups[j], downs[j]
                    left, right = lefts[j], rights[j]
                    if right < left or down < up:
                        continue
                    window = (slice(up, down + 1), slice(left, right + 1))
                    ch_mask_mat[window] = 1.0
                    np.maximum(
                        ch_height_mat[window], float(char_box.height),
                        out=ch_height_mat[window],
                    )

        return HostPage(
            background=np.asarray(canvas.mat),
            label_stack=label_stack,
            line_entries=line_entries,
            text_lines=text_lines,
            word_polygons=word_polygons,
            char_polygons=char_polygons,
            overlay_entries=overlay_entries,
        )

    def _prepare_seals(self, layout_out, rng: RandomGenerator,
                       height: int, width: int) -> List[OverlayEntry]:
        """Seal stamps as overlay entries: engine-generated impression,
        slot text via the host font engine, rotation, two alpha layers
        (page_assembler.py _stamp_seal semantics — border mask at the
        seal alpha, then the filled text score map)."""
        from ..engine.seal_impression import fill_text_line_to_seal_impression
        from ..mechanism.distortion import rotate
        from ..pipeline.text_detection.page_seal_impression import (
            PageSealImpresssionStepInput,
        )

        out: List[OverlayEntry] = []
        seal_out = self.seal_step.run(
            PageSealImpresssionStepInput(page_layout_step_output=layout_out),
            rng,
        )
        for seal_impression, box, angle in zip(
            seal_out.seal_impressions, seal_out.boxes, seal_out.angles
        ):
            resource = self.seal_text_step._collect_seal_resource(
                seal_impression, box, angle, rng
            )
            if resource is None:
                continue
            filled_score_map, _char_polygons = (
                fill_text_line_to_seal_impression(
                    seal_impression,
                    resource.text_line_slot_indices,
                    resource.text_lines,
                    resource.internal_text_line,
                )
            )
            spun = rotate.distort(
                {'angle': resource.angle},
                mask=seal_impression.background_mask,
                score_map=filled_score_map,
            )
            assert spun.mask is not None and spun.score_map is not None
            center = resource.box.get_center_point()
            up = center.y - spun.mask.height // 2
            left = center.x - spun.mask.width // 2
            if (up < 0 or left < 0 or up + spun.mask.height > height
                    or left + spun.mask.width > width):
                continue  # assembler parity: skip out-of-bounds stamps
            out.append(OverlayEntry(
                alpha=(spun.mask.mat.astype(np.float32)
                       * float(seal_impression.alpha)),
                up=up, left=left, color=tuple(seal_impression.color),
            ))
            out.append(OverlayEntry(
                alpha=np.asarray(spun.score_map.mat, dtype=np.float32),
                up=up, left=left, color=tuple(seal_impression.color),
            ))
        return out

    def prepare_batch(self, batch_size: int,
                      rng: RandomGenerator) -> List[HostPage]:
        return [self.prepare_page(rng) for _ in range(batch_size)]
