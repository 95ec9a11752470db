"""Minimal symbolic tokenizer for the synthetic verifiable tasks.

The RL substrate needs *some* tokenization; the paper's technique only
sees token ids, so a compact symbol vocabulary is sufficient and keeps
the e2e CPU runs fast. Ids 0..3 are reserved control tokens.
"""

from __future__ import annotations

from typing import Dict, List

PAD, EOS, BOS, SEP = 0, 1, 2, 3

_SYMBOLS = (
    list("0123456789")
    + list("abcdefghijklmnopqrstuvwxyz")
    + list("+-*/=()[]{}<>.,:;!?|&^%$#@_~ ")
)


class Tokenizer:
    def __init__(self) -> None:
        self._tok2id: Dict[str, int] = {}
        self._id2tok: Dict[int, str] = {PAD: "<pad>", EOS: "<eos>", BOS: "<bos>", SEP: "<sep>"}
        nid = 4
        for s in _SYMBOLS:
            self._tok2id[s] = nid
            self._id2tok[nid] = s
            nid += 1
        self.vocab_size = nid

    def encode(self, text: str, bos: bool = False) -> List[int]:
        ids = [BOS] if bos else []
        for ch in text:
            if ch not in self._tok2id:
                raise ValueError(f"unknown symbol {ch!r}")
            ids.append(self._tok2id[ch])
        return ids

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in (PAD, EOS, BOS):
                continue
            if i == SEP:
                out.append("|")
            else:
                out.append(self._id2tok.get(i, "?"))
        return "".join(out)


TOKENIZER = Tokenizer()
