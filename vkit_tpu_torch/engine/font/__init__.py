"""Font engine family registry."""
from ..interface import EngineExecutorAggregatorFactory
from . import pil_font
from .pil_font import (
    FontFreetypeDefaultEngine,
    FontFreetypeLcdEngine,
    FontFreetypeMonochromeEngine,
    font_freetype_default_engine_executor_factory,
    font_freetype_lcd_engine_executor_factory,
    font_freetype_monochrome_engine_executor_factory,
)
from .type import (
    CharBox,
    CharGlyph,
    FontCollection,
    FontEngineRunConfig,
    FontEngineRunConfigGlyphSequence,
    FontEngineRunConfigStyle,
    FontGlyphInfo,
    FontGlyphInfoCollection,
    FontMeta,
    FontMode,
    FontVariant,
    TextLine,
)

font_engine_executor_aggregator_factory = EngineExecutorAggregatorFactory([
    pil_font.font_freetype_default_engine_executor_factory,
    pil_font.font_freetype_lcd_engine_executor_factory,
    pil_font.font_freetype_monochrome_engine_executor_factory,
])
