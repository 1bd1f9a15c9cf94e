"""Text tokenizer layer.

Production path wraps a local HF Qwen2 tokenizer with the three speech
control tokens (ref `vibevoice/modular/modular_vibevoice_text_tokenizer.py:111-209`:
`<|vision_start|>` = speech start, `<|vision_end|>` = speech end,
`<|vision_pad|>` = speech diffusion; pad = `<|image_pad|>`).

`ByteFallbackTokenizer` provides a dependency-free deterministic tokenizer
(byte-level) with the same interface for tests and offline smoke runs.
The PyTorch port's own copy of `vibevoice_tpu/processor/text_tokenizer.py`.
"""
from __future__ import annotations

from typing import List, Optional


class TextTokenizerBase:
    eos_id: int
    pad_id: int
    speech_start_id: int
    speech_end_id: int
    speech_diffusion_id: int
    bos_id: Optional[int] = None

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: List[int]) -> str:
        raise NotImplementedError


class QwenTextTokenizer(TextTokenizerBase):
    """HF Qwen2(+Fast) tokenizer with VibeVoice speech tokens added."""

    def __init__(self, pretrained_path: str):
        from transformers import AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(pretrained_path)
        self.tok.add_special_tokens({
            "additional_special_tokens": [
                "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
            ]
        })
        self.speech_start_id = self.tok.convert_tokens_to_ids("<|vision_start|>")
        self.speech_end_id = self.tok.convert_tokens_to_ids("<|vision_end|>")
        self.speech_diffusion_id = self.tok.convert_tokens_to_ids("<|vision_pad|>")
        self.eos_id = self.tok.eos_token_id
        pad = self.tok.convert_tokens_to_ids("<|image_pad|>")
        self.pad_id = pad if pad is not None else self.tok.eos_token_id
        self.bos_id = self.tok.bos_token_id

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self.tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids) -> str:
        return self.tok.decode(ids)

    @property
    def vocab_size(self) -> int:
        return len(self.tok)


class ByteFallbackTokenizer(TextTokenizerBase):
    """UTF-8 byte tokenizer: byte b -> id b. Control ids live above 256."""

    vocab_size = 300
    eos_id = 256
    pad_id = 257
    speech_start_id = 258
    speech_end_id = 259
    speech_diffusion_id = 260
    bos_id = None

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


__all__ = ["TextTokenizerBase", "QwenTextTokenizer", "ByteFallbackTokenizer"]
