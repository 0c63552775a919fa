"""Query/title text preprocessing.

Counterpart of ``ihgnn_tpu/data/preprocess/text.py``, with its own copy
of the stopword list and tokenizer, and the same choice of nltk's pieces
where they import.

Mirrors Helpers/PreProcessHelper.py:17-39: lowercase → strip digits and
CN/EN punctuation → tokenize → drop stopwords → Snowball-stem. The nltk
Snowball stemmer ships as pure code; the punkt tokenizer and stopwords
corpus require downloads, so in offline environments we fall back to a
regex tokenizer and a built-in English stopword list (same list content as
nltk's english stopwords circa 3.x).
"""

from __future__ import annotations

import gzip
import json
import re
from typing import Dict, Iterator, List, Sequence

_PUNCT = re.compile(
    r"[0-9!\"#$%&'()*+,\-./:;<=>?@\[\]\\^_`{|}~"
    r"！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣、〃《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏]+")

# nltk english stopwords (public-domain word list)
FALLBACK_STOPWORDS = frozenset("""
i me my myself we our ours ourselves you you're you've you'll you'd your
yours yourself yourselves he him his himself she she's her hers herself it
it's its itself they them their theirs themselves what which who whom this
that that'll these those am is are was were be been being have has had
having do does did doing a an the and but if or because as until while of
at by for with about against between into through during before after
above below to from up down in out on off over under again further then
once here there when where why how all any both each few more most other
some such no nor not only own same so than too very s t can will just don
don't should should've now d ll m o re ve y ain aren aren't couldn
couldn't didn didn't doesn doesn't hadn hadn't hasn hasn't haven haven't
isn isn't ma mightn mightn't mustn mustn't needn needn't shan shan't
shouldn shouldn't wasn wasn't weren weren't won won't wouldn wouldn't
""".split())


class TextPreprocessor:
    def __init__(self):
        try:
            from nltk.stem.snowball import SnowballStemmer
            self._stem = SnowballStemmer("english").stem
        except Exception:  # pragma: no cover - nltk is a baked dependency
            self._stem = lambda w: w
        self._stopwords = self._load_stopwords()
        self._tokenize = self._load_tokenizer()

    @staticmethod
    def _load_stopwords() -> frozenset:
        try:
            from nltk.corpus import stopwords
            return frozenset(stopwords.words("english"))
        except Exception:
            return FALLBACK_STOPWORDS

    @staticmethod
    def _load_tokenizer():
        try:
            from nltk.tokenize import word_tokenize
            word_tokenize("probe")  # raises if punkt is missing
            return word_tokenize
        except Exception:
            token_re = re.compile(r"[a-z]+")
            return lambda s: token_re.findall(s)

    def preprocess(self, text: str) -> List[str]:
        """lowercase, strip digits/punctuation, tokenize, drop stopwords,
        stem (PreProcessHelper.py:17-29)."""
        text = _PUNCT.sub(" ", text.lower())
        return [self._stem(w) for w in self._tokenize(text)
                if w not in self._stopwords]


def reverse_lookup(items: Sequence[str]) -> Dict[str, int]:
    """value → index dict (PreProcessHelper.py:32-39)."""
    return {v: i for i, v in enumerate(items)}


def iter_json_lines(path: str) -> Iterator[dict]:
    """Amazon metadata/review files: (gzipped) JSON-ish lines
    (PreProcessHelper.py:42-57)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                # the original Amazon dumps are python literals, not JSON
                yield eval(line)  # noqa: S307 - matches reference behavior
