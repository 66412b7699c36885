"""Tokenizer wrapper: HuggingFace umT5 tokenizer with a deterministic
hash-based fallback. The port's own copy of yume_tpu/data/tokenizer.py
(pinned equal to it by ``tests/test_torch_configs.py``).

The reference wraps HF tokenizers (`HuggingfaceTokenizer`,
wan/modules/tokenizers.py; 'google/umt5-xxl'). In zero-egress environments
without local tokenizer files, the fallback produces deterministic ids so
smoke runs and tests exercise the full text path (real deployments pass a
local tokenizer path).
"""

from __future__ import annotations

import hashlib
import re
import warnings
from typing import List, Optional, Tuple

import numpy as np


def resolve_tokenizer_path(explicit, ckpt_dir):
    """Explicit path wins; ``--tokenizer hash`` forces the fallback (the
    escape hatch when a ckpt_dir ships a tokenizer this env cannot load);
    otherwise the reference checkpoint layout ships the umt5 tokenizer
    inside checkpoint_dir (config.t5_tokenizer = 'google/umt5-xxl',
    wan/text2video.py:74)."""
    import os

    if explicit == "hash":
        return None
    if explicit or not ckpt_dir:
        return explicit
    cand = os.path.join(ckpt_dir, "google", "umt5-xxl")
    return cand if os.path.isdir(cand) else None


class Tokenizer:
    def __init__(self, name_or_path: Optional[str] = None, *, seq_len: int = 512,
                 vocab_size: int = 256384, clean: str = "whitespace",
                 strict: bool = True, warn_fallback: bool = True):
        """``strict`` (default): an explicit ``name_or_path`` that fails to
        load RAISES instead of silently degrading — with real T5 weights the
        hash fallback produces garbage conditioning (the reference
        hard-requires its tokenizer, wan/modules/tokenizers.py). The hash
        fallback only engages when NO tokenizer path was given, and then
        warns once."""
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.clean = clean
        self._hf = None
        self._warned = not warn_fallback
        if name_or_path:
            try:
                from transformers import AutoTokenizer

                self._hf = AutoTokenizer.from_pretrained(name_or_path)
            except Exception as e:
                if strict:
                    raise RuntimeError(
                        f"tokenizer {name_or_path!r} failed to load: {e}. "
                        "Pass a valid local umt5-xxl tokenizer dir, or omit "
                        "the path to use the hash fallback (tests/smoke "
                        "only).") from e
                self._hf = None

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return re.sub(r"\s+", " ", text).strip()
        return text

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """texts → (ids [B, seq_len] int32, mask [B, seq_len] int32)."""
        texts = [self._clean(t) for t in texts]
        if self._hf is not None:
            enc = self._hf(texts, padding="max_length", truncation=True,
                           max_length=self.seq_len, return_tensors="np",
                           add_special_tokens=True)
            return (enc["input_ids"].astype(np.int32),
                    enc["attention_mask"].astype(np.int32))
        # deterministic fallback: word-hash ids (+1 eos)
        if not self._warned:
            self._warned = True
            warnings.warn(
                "Tokenizer: no tokenizer path given — using the "
                "deterministic hash fallback (fine for tests/smoke; with "
                "real T5 weights pass --tokenizer <local umt5-xxl dir>)",
                stacklevel=2)
        ids = np.zeros((len(texts), self.seq_len), np.int32)
        mask = np.zeros((len(texts), self.seq_len), np.int32)
        for i, t in enumerate(texts):
            words = t.split()[: self.seq_len - 1]
            for j, w in enumerate(words):
                h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                ids[i, j] = h % (self.vocab_size - 2) + 2
            ids[i, len(words)] = 1  # eos
            mask[i, : len(words) + 1] = 1
        return ids, mask
