"""Tokenization for the LM data path.

Reference parity: the reference's text recipes lean on HuggingFace
tokenizers installed by the ai runtime (SURVEY.md §2.3 frameworks
install).  Here one interface with two backends:

* `ByteTokenizer` — reversible byte-level vocab (256 + specials), no
  downloads, no deps; the default for air-gapped corpus prep and tests.
* `HFTokenizer` — wraps a local `transformers` tokenizer directory when
  a real subword vocab is wanted (`from_pretrained(path)`; this image
  has no egress, so the path must be a local snapshot).

`encode_corpus` streams a text file into the flat int32 token file
`train/data.py::tokenized_file_batches` consumes.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258


class ByteTokenizer:
    """UTF-8 bytes as tokens; ids 0-255 are bytes, 256+ specials."""

    vocab_size = 259
    pad_id, bos_id, eos_id = PAD_ID, BOS_ID, EOS_ID

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids.insert(0, self.bos_id)
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if i < 256).decode(
            "utf-8", errors="replace")


class HFTokenizer:
    """Local transformers tokenizer (no network: pass a snapshot dir)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path)
        self.vocab_size = len(self._tok)
        self.pad_id = self._tok.pad_token_id or 0
        self.bos_id = self._tok.bos_token_id or 0
        self.eos_id = self._tok.eos_token_id or 0

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos:
            ids.insert(0, self.bos_id)
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return self._tok.decode(list(ids))


def get_tokenizer(spec: Optional[str] = None):
    """None/'byte' -> ByteTokenizer; anything else is a local HF path."""
    if spec in (None, "byte"):
        return ByteTokenizer()
    return HFTokenizer(spec)


def encode_corpus(text_path: str, out_path: str,
                  tokenizer=None, *, doc_separator: str = "\n\n",
                  chunk_chars: int = 1 << 20) -> int:
    """Stream a text file into a flat int32 token file (documents
    separated by EOS).  Returns the token count.

    Genuinely streaming: tokens append to disk as they are produced
    (peak memory is one text chunk + one document's ids), so multi-GB
    corpora for the large presets prepare in flat memory.  `.bin`
    outputs are raw int32 (np.memmap-readable); `.npy` outputs are
    finalized from the streamed data without loading it back whole."""
    import os

    tok = tokenizer or ByteTokenizer()
    total = 0
    if not out_path.endswith((".npy", ".bin")):
        out_path = out_path + ".npy"
    raw_path = out_path if out_path.endswith(".bin") else \
        out_path + ".tmp.bin"
    with open(text_path, "r", errors="replace") as f, \
            open(raw_path, "wb") as out:
        buffer = ""
        while True:
            chunk = f.read(chunk_chars)
            buffer += chunk
            done = not chunk
            docs = buffer.split(doc_separator)
            buffer = "" if done else docs.pop()
            for doc in docs:
                if not doc.strip():
                    continue
                ids = np.asarray(tok.encode(doc, add_eos=True), np.int32)
                out.write(ids.tobytes())
                total += len(ids)
            if done:
                break
    if out_path.endswith(".npy"):
        src = (np.memmap(raw_path, dtype=np.int32, mode="r")
               if total else np.zeros((0,), np.int32))
        np.save(out_path, src)       # tofile streams from the memmap
        del src
        os.unlink(raw_path)
    return total
