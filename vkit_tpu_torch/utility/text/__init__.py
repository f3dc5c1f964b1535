from .opt import (
    LexiconType,
    get_lexicon_type,
    normalize,
    normalize_cjk_compatibility_ideograph,
    normalize_cjk_fullwidth,
)
