"""Corpus char sampler: a random line drawn by byte position from weighted
text files.

Behavioral spec: vkit/engine/char_sampler/corpus.py:31-158 (re-derived;
the enclosing line is located with block reads, not byte-at-a-time seeks).
"""
import logging
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import attr
from numpy.random import Generator as RandomGenerator

from ...utility import normalize_to_probs, rng_choice
from ..interface import Engine, EngineExecutorFactory
from .type import (
    CharSamplerEngineInitResource,
    CharSamplerEngineRunConfig,
    fill_chars_to_num,
)

logger = logging.getLogger(__name__)

_BLOCK = 4096


@attr.define
class CharSamplerCorpusEngineInitConfig:
    txt_files: Sequence[str]


CharSamplerCorpusEngineInitResource = CharSamplerEngineInitResource


def read_enclosing_line(path: Path, size: int, pos: int) -> str:
    """The text line containing byte ``pos``, located with block reads."""
    with path.open('rb') as fin:
        # Scan forward for the line end (inclusive bound at EOF).
        end = pos + 1
        fin.seek(end)
        while end < size:
            block = fin.read(_BLOCK)
            if not block:
                break
            hit = block.find(b'\n')
            if hit >= 0:
                end += hit
                break
            end += len(block)
        end = min(end, size)

        # Scan backward for the preceding newline.
        begin = pos
        while begin > 0:
            lo = max(0, begin - _BLOCK)
            fin.seek(lo)
            block = fin.read(begin - lo)
            hit = block.rfind(b'\n')
            if hit >= 0:
                begin = lo + hit + 1
                break
            begin = lo

        fin.seek(begin)
        raw = fin.read(end - begin)
    try:
        return raw.decode()
    except UnicodeError:
        logger.exception(f'undecodable corpus line {raw[:64]!r}')
        return ''


class CharSamplerCorpusEngine(
    Engine[CharSamplerCorpusEngineInitConfig, CharSamplerCorpusEngineInitResource, CharSamplerEngineRunConfig, Sequence[str]]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'corpus'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        assert init_resource
        self.lexicon_collection = init_resource.lexicon_collection

        self.files: List[Tuple[Path, int]] = []
        for txt_file in init_config.txt_files:
            path = Path(os.path.expandvars(os.fspath(txt_file)))
            assert path.exists()
            self.files.append((path, os.path.getsize(path)))
        # Larger files hold more lines: weight by byte size.
        self.file_probs = normalize_to_probs([size for _, size in self.files])
        # In-memory byte cache for small corpora (thousands of draws per
        # prepared batch otherwise reopen + seek the file each time);
        # larger files keep the block-read path.
        self._bytes_cache: dict = {}

    def _read_line(self, path: Path, size: int, pos: int) -> str:
        if size <= (8 << 20):
            data = self._bytes_cache.get(path)
            if data is None:
                data = path.read_bytes()
                self._bytes_cache[path] = data
            # Same bounds as read_enclosing_line: forward scan starts at
            # pos + 1, backward scan covers [0, pos).
            end = data.find(b'\n', pos + 1)
            end = size if end < 0 else min(end, size)
            begin = data.rfind(b'\n', 0, pos) + 1
            try:
                return data[begin:end].decode()
            except UnicodeError:
                logger.exception(
                    f'undecodable corpus line {data[begin:begin + 64]!r}'
                )
                return ''
        return read_enclosing_line(path, size, pos)

    def sample_and_prep_text(self, rng: RandomGenerator) -> str:
        """Draw lines until one survives lexicon filtering."""
        while True:
            path, size = rng_choice(rng, self.files, probs=self.file_probs)
            line = self._read_line(path, size, int(rng.integers(0, size)))
            words = []
            for word in line.split():
                kept = ''.join(
                    c for c in word if self.lexicon_collection.has_char(c)
                )
                if kept:
                    words.append(kept)
            if words:
                return ' '.join(words)

    def run(self, run_config: CharSamplerEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Sequence[str]:
        assert rng is not None
        if run_config.enable_aggregator_mode:
            return self.sample_and_prep_text(rng)
        return fill_chars_to_num(self.sample_and_prep_text, run_config.num_chars, rng)


char_sampler_corpus_engine_executor_factory = EngineExecutorFactory(CharSamplerCorpusEngine)
