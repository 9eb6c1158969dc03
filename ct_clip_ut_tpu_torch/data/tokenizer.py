"""A BERT WordPiece tokenizer over a local vocabulary, in plain Python.

The JAX scripts tokenise reports and prompts with
`transformers.BertTokenizer.from_pretrained(path, do_lower_case=True)`
(CXR-BERT's vocabulary); the card's machine has no `transformers`, so this
module restates that tokenizer, as utils/metrics.py restates scikit-learn.
`BertWordPiece.from_dir(DIR)` reads `DIR/vocab.txt` (one token a line, its
id the line's index) and runs what BertTokenizer runs:

- the basic tokenizer: drop NUL, U+FFFD and control characters, whitespace
  to spaces; spaces around CJK ideographs; NFC; split on whitespace; lower
  case and strip accents (NFD, combining marks dropped); split every
  punctuation character off as a token of its own. The special tokens are
  never split;
- greedy longest-match-first WordPiece, continuations prefixed `##`, a word
  of more than 100 characters or one with no match as `[UNK]`;
- [CLS] ... [SEP] around each text, truncated to `max_length`, padded with
  [PAD] to `max_length` or to the longest text.

Called as the package calls an HF tokenizer (`tokenize_prompts`, the
trainer, the attribution suite, `compute_diff_embeddings`), it returns
input_ids, token_type_ids and attention_mask: numpy arrays with
`return_tensors="np"`, lists otherwise; `convert_ids_to_tokens` and
`convert_tokens_to_ids` map between ids and tokens.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Iterable, List, Sequence, Union

import numpy as np

SPECIALS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")
MAX_WORD_CHARS = 100       # longer words are [UNK] (BertTokenizer's max_input_chars_per_word)


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def basic_tokens(text: str, never_split: Iterable[str] = SPECIALS) -> List[str]:
    """BertTokenizer's basic tokenizer with do_lower_case=True."""
    never_split = set(never_split)
    chars = []
    for ch in text:
        if ord(ch) in (0, 0xFFFD) or _is_control(ch):
            continue
        if _is_cjk(ch):
            chars += [" ", ch, " "]
        else:
            chars.append(" " if _is_whitespace(ch) else ch)
    out = []
    for token in unicodedata.normalize("NFC", "".join(chars)).split():
        if token in never_split:
            out.append(token)
            continue
        token = "".join(c for c in unicodedata.normalize("NFD", token.lower())
                        if unicodedata.category(c) != "Mn")
        word = ""
        for ch in token:
            if _is_punctuation(ch):
                out += [word, ch] if word else [ch]
                word = ""
            else:
                word += ch
        if word:
            out.append(word)
    return out


class BertWordPiece:
    """BertTokenizer(vocab_file, do_lower_case=True) over `vocab` (token ->
    id). See the module doc."""

    def __init__(self, vocab: dict):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        missing = [t for t in ("[UNK]", "[SEP]", "[PAD]", "[CLS]") if t not in self.vocab]
        if missing:
            raise ValueError(f"the vocabulary lacks the special tokens {missing}")
        self.unk_token_id = self.vocab["[UNK]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.pad_token_id = self.vocab["[PAD]"]
        self._pieces: dict = {}

    @classmethod
    def from_dir(cls, path) -> "BertWordPiece":
        """The tokenizer of `path`/vocab.txt (or of `path` itself, a
        vocab.txt): a line's token has the line's index for its id."""
        path = Path(path)
        vocab_file = path / "vocab.txt" if path.is_dir() else path
        if not vocab_file.is_file():
            raise FileNotFoundError(f"no WordPiece vocabulary at {vocab_file} (the directory "
                                    "of a BERT tokenizer holds its vocab.txt)")
        vocab = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    def wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first pieces of one basic token."""
        if word not in self._pieces:
            pieces, start = [], 0
            while start < len(word) and len(word) <= MAX_WORD_CHARS:
                end = len(word)
                while end > start:
                    sub = word[start:end] if start == 0 else "##" + word[start:end]
                    if sub in self.vocab:
                        break
                    end -= 1
                if end == start:
                    break
                pieces.append(sub)
                start = end
            self._pieces[word] = pieces if start == len(word) else ["[UNK]"]
        return self._pieces[word]

    def tokenize(self, text: str) -> List[str]:
        out = []
        for token in basic_tokens(text):
            out += [token] if token in SPECIALS else self.wordpiece(token)
        return out

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, (int, np.integer)):
            return self.ids_to_tokens.get(int(ids), "[UNK]")
        return [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]

    def __call__(self, texts, max_length: int = 512, padding=False, truncation: bool = False, add_special_tokens: bool = True,
                 return_tensors=None, **hf_options) -> dict:
        """input_ids, token_type_ids and attention_mask of `texts` (a string
        or a list of them). padding: "max_length", "longest" / True, or
        False / "do_not_pad" (BertTokenizer's default); truncation to
        max_length (the special tokens counted). numpy arrays with return_tensors="np"; lists otherwise (a
        string's lists unnested)."""
        single = isinstance(texts, str)
        rows = []
        for text in [texts] if single else texts:
            ids = self.convert_tokens_to_ids(self.tokenize(text))
            if truncation:
                ids = ids[:max(max_length - (2 if add_special_tokens else 0), 0)]
            if add_special_tokens:
                ids = [self.cls_token_id, *ids, self.sep_token_id]
            rows.append(ids)
        if padding in (True, "longest"):
            width = max(len(r) for r in rows)
        elif padding == "max_length":
            width = max(max_length, *(len(r) for r in rows))
        else:
            width = None
        masks = [[1] * len(r) for r in rows]
        if width is not None:
            masks = [m + [0] * (width - len(r)) for m, r in zip(masks, rows)]
            rows = [r + [self.pad_token_id] * (width - len(r)) for r in rows]
        enc = {"input_ids": rows, "token_type_ids": [[0] * len(r) for r in rows],
               "attention_mask": masks}
        if return_tensors is not None:
            if return_tensors != "np":
                raise ValueError(f"return_tensors={return_tensors!r}: this tokenizer returns "
                                 "numpy arrays (return_tensors='np') or lists")
            return {k: np.asarray(v, np.int64) for k, v in enc.items()}
        return {k: v[0] for k, v in enc.items()} if single else enc
