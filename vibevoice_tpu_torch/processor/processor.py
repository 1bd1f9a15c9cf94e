"""VibeVoiceProcessor: multi-speaker script -> packed token/speech batch.

Behavioural port of `vibevoice/processor/vibevoice_processor.py:17-691`:
system prompt + ` Voice input:\n` per-speaker voice segments
(`speech_start + [diffusion]*ceil(samples/hop) + speech_end`) + ` Text
input:\n` + per-turn ` Speaker N: text\n` + ` Speech output:\n` +
speech_start; left-padded batching.  Outputs are numpy with static shapes —
optionally right-padded to length buckets.
The PyTorch port's own copy of `vibevoice_tpu/processor/processor.py`.
"""
from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .audio import AudioNormalizer, load_audio, save_audio
from .text_tokenizer import TextTokenizerBase

SYSTEM_PROMPT = (" Transform the text provided by various speakers into speech output, "
                 "utilizing the distinct voice of each respective speaker.\n")


@dataclass
class ProcessorOutput:
    input_ids: np.ndarray          # [B, T] int32 (left padded)
    attention_mask: np.ndarray     # [B, T] int32
    speech_input_mask: np.ndarray  # [B, T] bool
    speech_tensors: Optional[np.ndarray]  # [N, Ta] fp32
    speech_masks: Optional[np.ndarray]    # [N, F] bool
    parsed_scripts: List[List[Tuple[int, str]]] = field(default_factory=list)
    all_speakers_list: List[List[int]] = field(default_factory=list)


class VibeVoiceProcessor:
    def __init__(self, tokenizer: TextTokenizerBase,
                 speech_tok_compress_ratio: int = 3200,
                 db_normalize: bool = True,
                 sampling_rate: int = 24000,
                 target_dB_FS: float = -25,
                 eps: float = 1e-6,
                 language_model_pretrained_name: Optional[str] = None):
        self.tokenizer = tokenizer
        self.speech_tok_compress_ratio = speech_tok_compress_ratio
        self.db_normalize = db_normalize
        self.sampling_rate = sampling_rate
        self.target_dB_FS = target_dB_FS
        self.eps = eps
        self.language_model_pretrained_name = language_model_pretrained_name
        self.audio_normalizer = AudioNormalizer(target_dB_FS=target_dB_FS,
                                                eps=eps) if db_normalize else None
        self.system_prompt = SYSTEM_PROMPT

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, tokenizer: Optional[TextTokenizerBase] = None,
                        **kw) -> "VibeVoiceProcessor":
        """Load from a directory holding the reference's
        `preprocessor_config.json` (schema: ref vibevoice_processor.py:44-127);
        missing file falls back to defaults like the reference does."""
        import json
        cfg: Dict[str, Any] = {}
        cfg_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        audio_cfg = cfg.get("audio_processor", {})
        lm_name = cfg.get("language_model_pretrained_name") or kw.pop(
            "language_model_pretrained_name", None)
        if tokenizer is None:
            from .text_tokenizer import ByteFallbackTokenizer, QwenTextTokenizer
            try:
                tokenizer = QwenTextTokenizer(lm_name or path)
            except Exception:
                tokenizer = ByteFallbackTokenizer()
        return cls(
            tokenizer,
            speech_tok_compress_ratio=cfg.get("speech_tok_compress_ratio", 3200),
            db_normalize=cfg.get("db_normalize", True),
            sampling_rate=audio_cfg.get("sampling_rate", 24000),
            target_dB_FS=audio_cfg.get("target_dB_FS", -25),
            eps=audio_cfg.get("eps", 1e-6),
            language_model_pretrained_name=lm_name,
            **kw,
        )

    def save_pretrained(self, save_directory: str) -> str:
        """Write `preprocessor_config.json` in the reference's schema
        (ref vibevoice_processor.py:129-161) so either implementation can
        reload it."""
        import json
        os.makedirs(save_directory, exist_ok=True)
        cfg = {
            "processor_class": "VibeVoiceProcessor",
            "speech_tok_compress_ratio": self.speech_tok_compress_ratio,
            "db_normalize": self.db_normalize,
            "audio_processor": {
                "feature_extractor_type": "VibeVoiceTokenizerProcessor",
                "sampling_rate": self.sampling_rate,
                "normalize_audio": self.db_normalize,
                "target_dB_FS": self.target_dB_FS,
                "eps": self.eps,
            },
        }
        if self.language_model_pretrained_name:
            cfg["language_model_pretrained_name"] = self.language_model_pretrained_name
        out = os.path.join(save_directory, "preprocessor_config.json")
        with open(out, "w") as f:
            json.dump(cfg, f, indent=2)
        return out

    # ------------------------------------------------------------------
    def __call__(self, text, voice_samples=None, pad_to_multiple: Optional[int] = None,
                 max_length: Optional[int] = None) -> ProcessorOutput:
        if isinstance(text, str):
            texts = [text]
        else:
            texts = list(text)
        if voice_samples is not None and len(voice_samples) > 0 and \
                isinstance(voice_samples[0], (str, np.ndarray)):
            voice_list = [voice_samples]
        else:
            voice_list = voice_samples if voice_samples is not None else [None] * len(texts)

        encodings = [self._process_single(t, v) for t, v in zip(texts, voice_list)]
        return self._batch_encode(encodings, pad_to_multiple=pad_to_multiple,
                                  max_length=max_length)

    # ------------------------------------------------------------------
    def _process_single(self, text: str, voice_samples) -> Dict[str, Any]:
        script = text
        if isinstance(text, str) and text.endswith(".json") and os.path.exists(text):
            script = self._convert_json_to_script(text)
        elif isinstance(text, str) and text.endswith(".txt") and os.path.exists(text):
            script = self._convert_text_to_script(text)

        parsed = self._parse_script(script)
        all_speakers = list({sid for sid, _ in parsed})

        tk = self.tokenizer
        full = tk.encode(self.system_prompt)
        mask: List[bool] = [False] * len(full)

        voice_speech: List[np.ndarray] = []
        if voice_samples:
            vt, vs, vm = self._create_voice_prompt(voice_samples[: len(all_speakers)])
            full += vt
            mask += vm
            voice_speech = vs

        ti = tk.encode(" Text input:\n")
        full += ti
        mask += [False] * len(ti)
        for sid, stext in parsed:
            t = tk.encode(f" Speaker {sid}:{stext}\n")
            full += t
            mask += [False] * len(t)
        so = tk.encode(" Speech output:\n")
        full += so + [tk.speech_start_id]
        mask += [False] * (len(so) + 1)
        return {"input_ids": full, "speech_inputs": voice_speech or None,
                "speech_input_mask": mask, "parsed_script": parsed,
                "all_speakers": all_speakers}

    # ------------------------------------------------------------------
    def _create_voice_prompt(self, speaker_samples):
        """ref _create_voice_prompt :406-459."""
        tk = self.tokenizer
        hop = self.speech_tok_compress_ratio
        tokens = tk.encode(" Voice input:\n")
        masks: List[bool] = [False] * len(tokens)
        speech: List[np.ndarray] = []
        for sid, sample in enumerate(speaker_samples):
            prefix = tk.encode(f" Speaker {sid}:")
            wav = load_audio(sample, self.sampling_rate) if isinstance(sample, str) \
                else np.asarray(sample, np.float32)
            if self.db_normalize and self.audio_normalizer is not None:
                wav = self.audio_normalizer(wav)
            n_frames = math.ceil(wav.shape[0] / hop)
            tokens += prefix + [tk.speech_start_id] + [tk.speech_diffusion_id] * n_frames \
                + [tk.speech_end_id] + tk.encode("\n")
            masks += [False] * len(prefix) + [False] + [True] * n_frames + [False] \
                + [False] * len(tk.encode("\n"))
            speech.append(wav)
        return tokens, speech, masks

    # ------------------------------------------------------------------
    def _batch_encode(self, encodings, pad_to_multiple=None, max_length=None) -> ProcessorOutput:
        tk = self.tokenizer
        hop = self.speech_tok_compress_ratio
        max_len = max(len(e["input_ids"]) for e in encodings)
        if max_length is not None:
            max_len = max(max_len, max_length)
        if pad_to_multiple:
            max_len = ((max_len + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple

        b = len(encodings)
        ids = np.full((b, max_len), tk.pad_id, np.int32)
        att = np.zeros((b, max_len), np.int32)
        sim = np.zeros((b, max_len), bool)
        for i, e in enumerate(encodings):
            n = len(e["input_ids"])
            ids[i, max_len - n:] = e["input_ids"]
            att[i, max_len - n:] = 1
            sim[i, max_len - n:] = e["speech_input_mask"]

        all_speech = []
        for e in encodings:
            if e["speech_inputs"]:
                all_speech.extend(e["speech_inputs"])
        if all_speech:
            # right-pad audio to a common hop multiple
            frame_lens = [math.ceil(len(s) / hop) for s in all_speech]
            max_frames = max(frame_lens)
            padded = np.zeros((len(all_speech), max_frames * hop), np.float32)
            fmask = np.zeros((len(all_speech), max_frames), bool)
            for i, (s, fl) in enumerate(zip(all_speech, frame_lens)):
                padded[i, : len(s)] = s
                fmask[i, :fl] = True
            speech_tensors, speech_masks = padded, fmask
        else:
            speech_tensors, speech_masks = None, None

        return ProcessorOutput(
            input_ids=ids, attention_mask=att, speech_input_mask=sim,
            speech_tensors=speech_tensors, speech_masks=speech_masks,
            parsed_scripts=[e["parsed_script"] for e in encodings],
            all_speakers_list=[e["all_speakers"] for e in encodings],
        )

    # ------------------------------------------------------------------
    def _parse_script(self, script: str) -> List[Tuple[int, str]]:
        """ref _parse_script :596-631 incl. 1-based -> 0-based normalization."""
        lines = script.strip().split("\n")
        parsed, sids = [], []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            m = re.match(r"^Speaker\s+(\d+)\s*:\s*(.*)$", line, re.IGNORECASE)
            if m:
                sid = int(m.group(1))
                parsed.append((sid, " " + m.group(2).strip()))
                sids.append(sid)
        if not parsed:
            raise ValueError("No valid speaker lines found in script")
        if min(sids) > 0:
            parsed = [(sid - 1, t) for sid, t in parsed]
        return parsed

    def _convert_json_to_script(self, json_file: str) -> str:
        import json
        with open(json_file, encoding="utf-8") as f:
            data = json.load(f)
        lines = []
        for item in data:
            if not isinstance(item, dict):
                continue
            sp, tx = item.get("speaker"), item.get("text")
            if sp is None or tx is None:
                continue
            try:
                sid = int(sp)
            except (TypeError, ValueError):
                continue
            tx = tx.strip()
            if tx:
                lines.append(f"Speaker {sid}: {tx}")
        if not lines:
            raise ValueError("No valid entries found in JSON file")
        return "\n".join(lines)

    def _convert_text_to_script(self, text_file: str) -> str:
        with open(text_file, encoding="utf-8") as f:
            raw = f.readlines()
        lines = []
        for line in raw:
            line = line.strip()
            if not line:
                continue
            m = re.match(r"^Speaker\s+(\d+)\s*:\s*(.*)$", line, re.IGNORECASE)
            if m:
                if m.group(2).strip():
                    lines.append(f"Speaker {int(m.group(1))}: {m.group(2).strip()}")
            else:
                lines.append(f"Speaker 1: {line}")
        if not lines:
            raise ValueError("No valid content found in text file")
        return "\n".join(lines)

    def save_audio(self, audio, output_path: str = "output.wav") -> str:
        return save_audio(np.asarray(audio), output_path, self.sampling_rate)


__all__ = ["VibeVoiceProcessor", "ProcessorOutput", "SYSTEM_PROMPT"]
