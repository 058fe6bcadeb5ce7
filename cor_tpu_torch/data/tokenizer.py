"""Text tokenization for the SigLIP text tower: the port's own copy of
``cor_tpu.data.tokenizer`` (numpy only), kept equal to it id for id
(``tests/test_torch_serve.py`` holds the two against each other).

The reference tokenizes in-dataset with open_clip's SigLIP tokenizer — a
T5-style sentencepiece model wrapped by open_clip's HFTokenizer with
``clean='canonicalize'`` (reference: utils/dataloader.py:128,185;
lib/support_model/siglip_openclip.py:15). The exact framing that produces:

    canonicalize(text) -> sentencepiece ids -> append eos(=1)
    -> truncate so (ids + eos) fits context_length (HF truncation keeps the
       eos as the final kept token)
    -> right-pad with pad(=0) to context_length

so the id layout is ``[t0 .. tn, eos, 0, 0, ...]`` — position -1 is a PAD
token unless the text fills the context. SigLIP applies NO attention mask and
pools the literal last position (open_clip pool_type='last'; HF
SiglipTextModel reads last_hidden_state[:, -1]), so pads are contextual
summary positions by construction. Both tokenizers here reproduce that
framing exactly.

Offline/zero-egress environments can't fetch the sentencepiece vocab, so the
tokenizer is an interface:

- ``SentencePieceTokenizer``: exact parity when a local vocab file or a HF
  tokenizer directory is available (uses `transformers`).
- ``HashTokenizer``: deterministic hashing fallback (whitespace words ->
  stable vocab buckets) so the full pipeline runs and tests are meaningful
  without external artifacts. Same framing, different word->id map.
"""

from __future__ import annotations

import hashlib
import re
import string
from typing import Sequence

import numpy as np

PAD_ID = 0
EOS_ID = 1


def canonicalize_text(text: str) -> str:
    """SigLIP canonicalization: underscores to spaces, strip punctuation,
    lowercase, squeeze spaces (open_clip `canonicalize_text`, selected for
    SigLIP models via tokenizer_kwargs clean='canonicalize')."""
    text = text.replace("_", " ")
    text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


def frame_ids(ids: Sequence[int], context_length: int) -> np.ndarray:
    """Apply the SigLIP framing to raw content ids: truncate to leave room
    for eos, append eos, right-pad with 0."""
    ids = list(ids)[: context_length - 1]
    ids.append(EOS_ID)
    out = np.full((context_length,), PAD_ID, np.int32)
    out[: len(ids)] = ids
    return out


class HashTokenizer:
    """Deterministic word-hash tokenizer: id = stable_hash(word) % (vocab-2) + 2.

    Reserves 0 = pad, 1 = eos (the T5/SigLIP sentencepiece convention). Uses
    the exact SigLIP framing (see module docstring): content prefix, eos
    immediately after, zero padding to the right; position -1 is pad for
    short texts.
    """

    is_exact = False

    def __init__(self, context_length: int = 64, vocab_size: int = 32000):
        self.context_length = context_length
        self.vocab_size = vocab_size

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return 2 + (h % (self.vocab_size - 2))

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            words = canonicalize_text(t).split(" ")
            out[i] = frame_ids([self._word_id(w) for w in words if w], self.context_length)
        return out


class SentencePieceTokenizer:
    """Exact SigLIP tokenizer via a local HF tokenizer artifact.

    Mirrors open_clip HFTokenizer.__call__: clean each text with
    canonicalize, then batch-encode with max_length padding + truncation
    (reference: utils/dataloader.py:128 via open_clip.get_tokenizer).
    """

    is_exact = True

    def __init__(self, path: str, context_length: int = 64):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path)
        self.context_length = context_length

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        texts = [canonicalize_text(t) for t in texts]
        enc = self.tok(
            texts,
            return_tensors="np",
            max_length=self.context_length,
            padding="max_length",
            truncation=True,
        )
        return enc["input_ids"].astype(np.int32)


def get_tokenizer(
    tokenizer_path: str | None = None,
    context_length: int = 64,
    vocab_size: int = 32000,
):
    """Tokenizer factory: exact sentencepiece when an artifact is configured,
    hash fallback otherwise.

    An explicitly configured ``tokenizer_path`` that fails to load RAISES —
    silently hashing would feed a pretrained text tower ids unrelated to its
    trained vocab (garbage conditioning on the flagship COR127K path).
    """
    if tokenizer_path:
        try:
            return SentencePieceTokenizer(tokenizer_path, context_length)
        except Exception as e:
            raise RuntimeError(
                f"tokenizer_path={tokenizer_path!r} could not be loaded ({e}); "
                "refusing to fall back to the hash tokenizer for a configured "
                "artifact — fix the path or unset tokenizer_path."
            ) from e
    return HashTokenizer(context_length, vocab_size)
