"""Vendored data assets (byte copies of text2loc_tpu/assets).

`tiny_t5_tokenizer/`: a small Unigram tokenizer in the T5 wire format
(Metaspace pre-tokenization, `<pad>`=0 / `</s>`=1 / `<unk>`=2, `</s>`
appended by the post-processor), trained over the closed hint vocabulary and
the paraphrase banks by scripts/build_tiny_tokenizer.py. It stands in for
the t5-large tokenizer where no snapshot is at hand, so the online encoder's
front door (tokenizer.py -> models/t5_encoder.T5Encoder) runs end to end.
"""

from __future__ import annotations

import os


def tiny_t5_tokenizer_path() -> str:
    """The directory of the vendored tokenizer's three JSON files."""
    return os.path.join(os.path.dirname(__file__), "tiny_t5_tokenizer")


def load_tiny_tokenizer():
    """The vendored tokenizer, read by the port's own UnigramTokenizer."""
    from text2loc_tpu_torch.tokenizer import UnigramTokenizer

    return UnigramTokenizer.from_file(os.path.join(tiny_t5_tokenizer_path(),
                                                   "tokenizer.json"))
