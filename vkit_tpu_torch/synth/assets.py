"""Page assets made at run time: a font, a lexicon, a corpus, background
and symbol images, and the page planner over them.

The same set that tests/pipeline/fixtures.py builds for vkit_tpu's tests,
written by the port's entry points (``entry.dryrun_multichip``), its
example and chip_smoke.py, so that they run from a checkout with no asset
download; and that file's configuration of the 17-step text-detection
pipeline over them (``build_step_configs``).
"""
import importlib.util
import json
import shutil
import string
from pathlib import Path

import numpy as np

ASCII_CHARS = sorted(set(
    string.ascii_letters + string.digits + string.punctuation
))


def find_font(root) -> Path:
    """A DejaVu Sans TTF (matplotlib's data or /usr/share/fonts); without
    one, the FreeType font Pillow bundles, written out under ``root``."""
    candidates = []
    spec = importlib.util.find_spec('matplotlib')
    if spec is not None and spec.origin:
        candidates += sorted(
            (Path(spec.origin).parent / 'mpl-data' / 'fonts' / 'ttf')
            .glob('DejaVuSans*.ttf')
        )
    candidates += sorted(Path('/usr/share/fonts').rglob('DejaVuSans*.ttf'))
    sans = sorted(
        (p for p in candidates
         if 'Mono' not in p.name and 'Display' not in p.name),
        key=lambda p: (p.name != 'DejaVuSans.ttf', str(p)),
    )
    if sans:
        return sans[0]
    from PIL import ImageFont

    font = ImageFont.load_default(size=32)
    data = getattr(font, 'font_bytes', None)
    if not data:
        raise FileNotFoundError('no TTF font found and Pillow bundles none')
    family = '-'.join(font.getname())
    path = Path(root) / 'fonts' / f'{family}.ttf'
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path


def build_assets(root, font_file: Path) -> dict:
    """Lexicon, font collection, corpus, background and symbol images for
    the page planner, written under ``root``; returns their paths."""
    from PIL import Image

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    lexicon_json = root / 'lexicon.json'
    lexicon_json.write_text(json.dumps([
        {'char': char, 'aliases': [], 'tags': ['ascii']}
        for char in ASCII_CHARS
    ]))
    font_fd = root / 'font_collection' / 'font'
    meta_fd = root / 'font_collection' / 'font_meta'
    font_fd.mkdir(parents=True, exist_ok=True)
    meta_fd.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(font_file, font_fd / font_file.name)
    (meta_fd / 'font.json').write_text(json.dumps({
        'name': font_file.stem,
        'mode': 'vttc',
        'char_to_tags': {char: ['ascii'] for char in ASCII_CHARS},
        'font_files': [font_file.name],
        'font_glyph_info_collection': {'font_glyph_infos': [{
            'tags': ['ascii'],
            'ascent_plus_pad_up_min_to_font_size_ratio': 0.8,
            'height_min_to_font_size_ratio': 1.0,
            'width_min_to_font_size_ratio': 0.6,
        }]},
    }))
    corpus_txt = root / 'corpus.txt'
    corpus_txt.write_text('\n'.join([
        'the quick brown fox jumps over the lazy dog 0123456789',
        'pack my box with five dozen liquor jugs',
        'sphinx of black quartz judge my vow',
        'how vexingly quick daft zebras jump',
    ] * 25))
    rng = np.random.default_rng(0)
    bg_fd = root / 'bg_images'
    bg_fd.mkdir(exist_ok=True)
    for idx in range(2):
        small = rng.integers(140, 235, (8, 8, 3), dtype=np.uint8)
        mat = np.kron(small, np.ones((40, 40, 1), dtype=np.uint8))
        Image.fromarray(mat).save(bg_fd / f'bg_{idx}.png')
    symbol_fd = root / 'symbol_images'
    symbol_fd.mkdir(exist_ok=True)
    for idx in range(2):
        mat = np.zeros((32, 32), dtype=np.uint8)
        mat[4:28, 14:18] = 255
        mat[14:18, 4:28] = 255
        Image.fromarray(mat.T.copy() if idx else mat).save(
            symbol_fd / f'symbol_{idx}.png'
        )
    return {
        'lexicon_json': str(lexicon_json),
        'font_collection_folder': str(root / 'font_collection'),
        'corpus_txt': str(corpus_txt),
        'bg_image_folder': str(bg_fd),
        'symbol_image_folder': str(symbol_fd),
    }


def make_planner(assets: dict, side: int, full_content: bool = True):
    """The page planner over ``assets`` for ``side`` x ``side`` pages.
    ``full_content`` adds every page_assembler layer (symbols, barcodes,
    seal impressions, text-line boxes) to the background, images and text
    that vkit_tpu's multi-chip dry run composes."""
    from .prep import SynthPlanner, SynthPlannerConfig

    selector = [{'type': 'selector', 'weight': 1,
                 'config': {'image_folders': [assets['bg_image_folder']]}}]
    extra = {}
    if full_content:
        extra = dict(
            symbol_image_folders=[assets['symbol_image_folder']],
            enable_barcodes=True,
            enable_seal_impressions=True,
            enable_text_line_bounding_boxes=True,
        )
    return SynthPlanner(SynthPlannerConfig(
        lexicon_collection_json=assets['lexicon_json'],
        font_collection_folder=assets['font_collection_folder'],
        char_sampler_configs=[{
            'type': 'corpus', 'weight': 1,
            'config': {'txt_files': [assets['corpus_txt']]},
        }],
        page_height=side, page_width=side,
        background_image_configs=selector,
        image_configs=selector,
        **extra,
    ))


def build_step_configs(assets: dict, side: int = 640,
                       device: str = 'cuda') -> list:
    """The 17 steps of the text-detection pipeline over ``assets``, as
    tests/pipeline/fixtures.py configures them, on ``side`` x ``side``
    pages; step 15 flattens its regions on ``device``."""
    selector = [{'type': 'selector', 'weight': 1,
                 'config': {'image_folders': [assets['bg_image_folder']]}}]
    return [
        {'name': 'text_detection.page_shape_step',
         'config': {'area': side * side}},
        {'name': 'text_detection.page_background_step',
         'config': {'image_configs': selector}},
        {'name': 'text_detection.page_layout_step'},
        {'name': 'text_detection.page_image_step',
         'config': {'image_configs': selector}},
        {'name': 'text_detection.page_barcode_step'},
        {'name': 'text_detection.page_seal_impresssion_step',
         'config': {'seal_impression_configs': [
             {'type': 'ellipse', 'weight': 1, 'config': {}},
         ]}},
        {'name': 'text_detection.page_text_line_step',
         'config': {
             'lexicon_collection_json': assets['lexicon_json'],
             'font_collection_folder': assets['font_collection_folder'],
             'char_sampler_configs': [{
                 'type': 'corpus', 'weight': 1,
                 'config': {'txt_files': [assets['corpus_txt']]},
             }],
             'font_configs': [
                 {'type': 'freetype_default', 'weight': 1, 'config': {}},
             ],
         }},
        {'name': 'text_detection.page_non_text_symbol_step',
         'config': {'symbol_image_folders': [assets['symbol_image_folder']]}},
        {'name': 'text_detection.page_text_line_bounding_box_step'},
        {'name': 'text_detection.page_text_line_label_step',
         'config': {
             'enable_text_line_mask': True,
             'enable_boundary_mask': True,
             'enable_boundary_score_map': True,
         }},
        {'name': 'text_detection.page_assembler_step'},
        {'name': 'text_detection.page_distortion_step',
         'config': {'random_distortion_factory_config': {
             'disabled_policy_names': ['defocus_blur', 'zoom_in_blur'],
             'num_photometric_max': 1,
         }}},
        {'name': 'text_detection.page_resizing_step'},
        {'name': 'text_detection.page_cropping_step',
         'config': {'core_size': 256, 'pad_size': 32, 'num_samples': 2}},
        {'name': 'text_detection.page_text_region_step',
         'config': {'device': device}},
        {'name': 'text_detection.page_text_region_label_step'},
        {'name': 'text_detection.page_text_region_cropping_step',
         'config': {
             'core_size': 256,
             'pad_size': 32,
             'num_centroid_points_min': 5,
             'num_deviate_points_min': 5,
         }},
    ]
