"""Unicode normalization + per-char lexicon classification.

Capability parity: vkit/utility/text/opt.py:14-99 (normalize, LexiconType,
get_lexicon_type) and the codepoint range tables under
vkit/utility/text/const/.  Instead of shipping hand-maintained interval
tables, classification here derives from the Unicode database
(``unicodedata``) directly: block-range checks for CJK, category checks for
letters / digits / punctuation / whitespace.  NFKC normalization already folds
CJK fullwidth forms and compatibility ideographs (U+F900..U+FAD9) to their
canonical codepoints, which subsumes the reference's explicit
CJK_COMPATIBILITY_IDEOGRAPH mapping table.
"""
import unicodedata
from enum import Enum, unique


def normalize_cjk_fullwidth(text: str) -> str:
    return unicodedata.normalize('NFKC', text)


def normalize_cjk_compatibility_ideograph(text: str) -> str:
    # NFKC maps compatibility ideographs to unified ones; run it again so this
    # function is also usable standalone.
    return unicodedata.normalize('NFKC', text)


def normalize(text: str) -> str:
    return unicodedata.normalize('NFKC', text)


@unique
class LexiconType(Enum):
    CHINESE = 'chinese'
    ENGLISH = 'english'
    DELIMITER = 'delimiter'
    DIGIT = 'digit'
    WHITESPACE = 'whitespace'
    UNKNOWN = 'unknown'


# CJK ideograph blocks (inclusive ranges).
_CJK_RANGES = (
    (0x2E80, 0x2EFF),    # CJK Radicals Supplement
    (0x3007, 0x3007),    # Ideographic number zero
    (0x3400, 0x4DBF),    # CJK Extension A
    (0x4E00, 0x9FFF),    # CJK Unified Ideographs
    (0xF900, 0xFAFF),    # CJK Compatibility Ideographs
    (0x20000, 0x2A6DF),  # CJK Extension B
    (0x2A700, 0x2EBEF),  # CJK Extensions C-F
    (0x2F800, 0x2FA1F),  # CJK Compatibility Supplement
)


def _is_cjk(code_point: int) -> bool:
    for begin, end in _CJK_RANGES:
        if begin <= code_point <= end:
            return True
    return False


def get_lexicon_type(char: str) -> LexiconType:
    assert len(char) == 1
    code_point = ord(char)
    if _is_cjk(code_point):
        return LexiconType.CHINESE

    category = unicodedata.category(char)
    if category == 'Nd':
        return LexiconType.DIGIT
    if category in ('Zs', 'Zl', 'Zp') or char in '\t\n\r\v\f':
        return LexiconType.WHITESPACE
    if category.startswith('P') or category.startswith('S'):
        return LexiconType.DELIMITER
    if category.startswith('L'):
        # Non-CJK letters; the reference scopes this to Latin, which covers
        # the corpora it ships with.  Keep the broader letter class but name
        # it ENGLISH for config compatibility.
        return LexiconType.ENGLISH
    return LexiconType.UNKNOWN
