"""The page assets of the synth cells, made at run time: a font, a
lexicon, a corpus, background and symbol images, and the page planner's
configuration over them.

``find_font`` and ``build_assets`` are frozen copies of the functions of
the same names in ``vkit_tpu_torch/synth/assets.py`` at commit 0d25b46
(the set that tests/pipeline/fixtures.py builds for vkit_tpu's tests),
and ``planner_config`` is the configuration that ``make_planner`` of that
file gives with every page layer on; so a later change of the program's
assets leaves the benchmark's pages as they are.
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


def planner_config(assets: dict, side: int) -> dict:
    """The keyword arguments of the port's ``SynthPlannerConfig`` for
    ``side`` x ``side`` pages over ``assets`` with every page_assembler
    layer: background and image selectors, symbols, barcodes, seal
    impressions and text-line boxes (bench.py's config 6)."""
    selector = [{'type': 'selector', 'weight': 1,
                 'config': {'image_folders': [assets['bg_image_folder']]}}]
    return dict(
        lexicon_collection_json=assets['lexicon_json'],
        font_collection_folder=assets['font_collection_folder'],
        char_sampler_configs=[{
            'type': 'corpus', 'weight': 1,
            'config': {'txt_files': [assets['corpus_txt']]},
        }],
        page_height=side, page_width=side,
        background_image_configs=selector,
        image_configs=selector,
        symbol_image_folders=[assets['symbol_image_folder']],
        enable_barcodes=True,
        enable_seal_impressions=True,
        enable_text_line_bounding_boxes=True,
    )
