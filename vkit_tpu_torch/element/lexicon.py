"""Lexicon catalog: char + aliases + tags, with char/tag indices.

Behavioral spec: vkit/element/lexicon.py:25-117 (re-derived).
"""
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..utility.type import PathType

KEY_NO_TAG = '__no_tag'


@dataclass(frozen=True)
class Lexicon:
    char: str
    aliases: Tuple[str, ...] = ()
    tags: Tuple[str, ...] = ()
    meta: Optional[Mapping[str, str]] = None

    def __post_init__(self):
        # Normalize list inputs from JSON into tuples.
        object.__setattr__(self, 'aliases', tuple(self.aliases))
        object.__setattr__(self, 'tags', tuple(self.tags))

    @property
    def char_and_aliases(self) -> List[str]:
        return [self.char, *self.aliases]

    @property
    def unicode_id(self) -> str:
        return f'{ord(self.char):X}'


@dataclass
class LexiconCollection:
    lexicons: Sequence[Lexicon]
    _by_char: Optional[Dict[str, Lexicon]] = field(default=None, repr=False)
    _by_tag: Optional[Dict[str, List[Lexicon]]] = field(default=None, repr=False)

    def _index(self) -> None:
        by_char: Dict[str, Lexicon] = {}
        by_tag: Dict[str, List[Lexicon]] = {}
        for lexicon in self.lexicons:
            for char in lexicon.char_and_aliases:
                assert char not in by_char, f'duplicate char {char!r}'
                by_char[char] = lexicon
            for tag in (lexicon.tags or (KEY_NO_TAG,)):
                by_tag.setdefault(tag, []).append(lexicon)
        self._by_char = by_char
        self._by_tag = by_tag

    @property
    def char_to_lexicon(self) -> Mapping[str, Lexicon]:
        if self._by_char is None:
            self._index()
        assert self._by_char is not None
        return self._by_char

    @property
    def tag_to_lexicons(self) -> Mapping[str, Sequence[Lexicon]]:
        if self._by_tag is None:
            self._index()
        assert self._by_tag is not None
        return self._by_tag

    @property
    def tags(self) -> Sequence[str]:
        return sorted(self.tag_to_lexicons)

    def has_char(self, char: str) -> bool:
        return char in self.char_to_lexicon

    def get_lexicon(self, char: str) -> Lexicon:
        return self.char_to_lexicon[char]

    @classmethod
    def from_file(cls, path: PathType) -> 'LexiconCollection':
        with open(os.path.expandvars(os.fspath(path))) as fin:
            raw = json.load(fin)
        return cls(lexicons=[
            Lexicon(
                char=item['char'],
                aliases=tuple(item.get('aliases') or ()),
                tags=tuple(item.get('tags') or ()),
                meta=item.get('meta'),
            ) for item in raw
        ])

    def to_file(self, path: PathType) -> None:
        raw = [
            {
                'char': lx.char,
                'aliases': list(lx.aliases),
                'tags': list(lx.tags),
                'meta': dict(lx.meta) if lx.meta else None,
            } for lx in self.lexicons
        ]
        with open(os.path.expandvars(os.fspath(path)), 'w') as fout:
            json.dump(raw, fout, indent=2, ensure_ascii=False)

    def get_hash(self) -> str:
        digest = hashlib.sha256()
        for lexicon in self.lexicons:
            for char in lexicon.char_and_aliases:
                digest.update(char.encode())
        return digest.hexdigest()
