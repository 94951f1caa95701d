"""Token <-> id vocabulary encoder.

Port of ``dicttts_tpu/utils/text_encoder.py``: reserved ids 0=<pad>,
1=<EOS>, 2=<UNK>; '|' is the segment token. The binarized corpus stores the
non-reserved vocab as a plain list (phone_set.json / word_set.json), so the
id layout must match the JAX package's exactly.
"""

from __future__ import annotations

import json

PAD, EOS, UNK, SEG = "<pad>", "<EOS>", "<UNK>", "|"
RESERVED_TOKENS = [PAD, EOS, UNK]
PAD_ID, EOS_ID, UNK_ID = 0, 1, 2


class TokenTextEncoder:
    """Vocabulary-based encoder over space-separated token strings."""

    def __init__(self, vocab_list: list[str], replace_oov: str | None = None):
        self._replace_oov = replace_oov
        tokens = [t for t in vocab_list if t not in RESERVED_TOKENS]
        self.id_to_token: dict[int, str] = dict(enumerate(RESERVED_TOKENS))
        self.id_to_token.update(enumerate(tokens, start=len(RESERVED_TOKENS)))
        self.token_to_id = {t: i for i, t in self.id_to_token.items()}
        self.pad_index = PAD_ID
        self.eos_index = EOS_ID
        self.unk_index = UNK_ID
        self.seg_index = self.token_to_id.get(SEG, EOS_ID)

    @classmethod
    def from_json(cls, path: str, **kw) -> "TokenTextEncoder":
        with open(path) as f:
            return cls(json.load(f), **kw)

    def encode(self, s: str) -> list[int]:
        tokens = s.strip().split()
        if self._replace_oov is not None:
            tokens = [t if t in self.token_to_id else self._replace_oov for t in tokens]
        return [self.token_to_id[t] for t in tokens]

    def decode(self, ids, strip_eos: bool = False, strip_padding: bool = False) -> str:
        ids = list(ids)
        if strip_padding and PAD_ID in ids:
            ids = ids[: ids.index(PAD_ID)]
        if strip_eos and EOS_ID in ids:
            ids = ids[: ids.index(EOS_ID)]
        return " ".join(self.id_to_token.get(i, f"ID_{i}") for i in ids)

    def decode_list(self, ids) -> list[str]:
        return [self.id_to_token.get(i, f"ID_{i}") for i in ids]

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)

    def __len__(self) -> int:
        return self.vocab_size

    def store_to_file(self, path: str):
        """Save the full vocab (reserved tokens included), one per line."""
        with open(path, "w") as f:
            for i in range(self.vocab_size):
                f.write(self.id_to_token[i] + "\n")
