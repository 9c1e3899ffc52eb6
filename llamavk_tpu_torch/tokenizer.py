"""SentencePiece-style greedy bigram-merge tokenizer.

Behavioral re-implementation of the reference tokenizer
(`llama.cpp:1199-1350`): split text into UTF-8 characters, repeatedly merge
the adjacent pair whose merged string is the vocab token with the highest
score (ties broken toward the leftmost pair), and emit byte-fallback tokens
(id = byte value + 3) for any leftover symbol not in the vocab.
BOS id = 1, EOS id = 2 (sentencepiece convention).

Copy of `llamavk_tpu/tokenizer.py`, with its C++ fast path from the port's
`native.py`; the Python path is that fast path's bit-identical twin and runs
where the library does not build or LLAMAVK_NO_NATIVE is set.
"""

from __future__ import annotations

import heapq

from .formats.ggml_io import TokenEntry

BOS_ID = 1
EOS_ID = 2

_UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


def _utf8_len(b: int) -> int:
    return _UTF8_LEN[b >> 4]


class Tokenizer:
    def __init__(self, vocab: list[TokenEntry]):
        self.vocab = vocab
        # later duplicates overwrite earlier ids, matching map assignment order
        self.token_to_id: dict[bytes, int] = {}
        for i, tok in enumerate(vocab):
            self.token_to_id[tok.text] = i
        self._native = None  # built lazily on first encode
        self._native_tried = False

    @property
    def n_vocab(self) -> int:
        return len(self.vocab)

    def encode(self, text: str | bytes, bos: bool = True) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else text
        out = [BOS_ID] if bos else []
        if not data:
            return out if bos else []

        # C++ fast path (the reference tokenizer is C++, llama.cpp:1199-1350)
        if not self._native_tried:
            self._native_tried = True
            from . import native as _nv

            self._native = _nv.make_tokenizer(
                [t.text for t in self.vocab],
                [t.score for t in self.vocab],
            )
        if self._native is not None:
            ids = self._native.encode(data)
            if ids is not None:
                out.extend(ids)
                return out

        # split into utf-8 characters (clamped at end of data)
        starts: list[int] = []
        lens: list[int] = []
        offs = 0
        while offs < len(data):
            n = min(len(data) - offs, _utf8_len(data[offs]))
            starts.append(offs)
            lens.append(n)
            offs += n
        count = len(starts)
        prev = list(range(-1, count - 1))
        nxt = [i + 1 for i in range(count)]
        nxt[-1] = -1

        heap: list[tuple[float, int, int, int]] = []  # (-score, left, right, size)

        def try_add(left: int, right: int) -> None:
            if left == -1 or right == -1:
                return
            s = starts[left]
            size = lens[left] + lens[right]
            tok_id = self.token_to_id.get(bytes(data[s : s + size]))
            if tok_id is None:
                return
            heapq.heappush(heap, (-self.vocab[tok_id].score, left, right, size))

        for i in range(1, count):
            try_add(i - 1, i)

        while heap:
            _, left, right, size = heapq.heappop(heap)
            if lens[left] == 0 or lens[right] == 0 or lens[left] + lens[right] != size:
                continue  # stale entry: a symbol was already merged
            lens[left] += lens[right]
            lens[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        i = 0
        while i != -1:
            s, n = starts[i], lens[i]
            piece = bytes(data[s : s + n])
            tok_id = self.token_to_id.get(piece)
            if tok_id is None:
                out.extend(b + 3 for b in piece)  # byte fallback
            else:
                out.append(tok_id)
            i = nxt[i]
        return out

    def decode_token(self, token_id: int) -> bytes:
        return self.vocab[token_id].text

    def decode(self, ids: list[int]) -> bytes:
        return b"".join(self.vocab[i].text for i in ids)


def load_tokenizer(path: str) -> Tokenizer:
    from .formats.ggml_io import CheckpointReader

    return Tokenizer(CheckpointReader(path).vocab)
