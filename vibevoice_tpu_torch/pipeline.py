"""High-level TTS pipeline on PyTorch: processor + engine + audio.

Port of `vibevoice_tpu/pipeline.py` (the reference's `from_pretrained` +
processor + generate flow, demo/inference_from_file.py:182-400).  Engines are
cached per (batch, bucketed prompt length, max steps).  Runs on CUDA unless
`device="cpu"` is given.  Quantized modes and the fused sigma-VAE stages are
later slices of the port and raise `NotImplementedError`; `from_pretrained`
waits for the checkpoint slice.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .configs import VibeVoiceConfig, vibevoice_1_5b
from .engine import generate as G
from .engine.streamer import AudioStreamer
from .models import vibevoice as V
from .processor.processor import VibeVoiceProcessor
from .processor.text_tokenizer import ByteFallbackTokenizer


class VibeVoiceTTS:
    def __init__(self, params, cfg: VibeVoiceConfig, tokenizer,
                 dtype=torch.bfloat16, ddpm_steps: int = 10, cfg_scale: float = 1.3,
                 prompt_bucket: int = 256, quantize: Optional[str] = None,
                 do_sample: bool = False, refresh_negative: bool = True,
                 algorithm_type: str = "dpmsolver++", kv_dtype: str = "model",
                 int4_group_size: Optional[int] = None,
                 quantize_tokenizer: Optional[str] = None,
                 quantize_diffusion: Optional[str] = None,
                 use_fused_stages: bool = False,
                 keep_audio: bool = True,
                 processor: Optional[VibeVoiceProcessor] = None,
                 device="cuda"):
        for name, value in (("quantize", quantize), ("quantize_tokenizer", quantize_tokenizer),
                            ("quantize_diffusion", quantize_diffusion),
                            ("int4_group_size", int4_group_size)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}={value!r}: quantized modes are not ported yet (ROADMAP A7)")
        if use_fused_stages:
            raise NotImplementedError(
                "use_fused_stages: the fused stage kernel is not ported yet (ROADMAP B4)")
        self.device = G.resolve_device(device)
        self.do_sample = do_sample
        self.refresh_negative = refresh_negative
        self.algorithm_type = algorithm_type
        self.kv_dtype = kv_dtype
        # keep_audio=False drops the [B, max_steps, hop] waveform buffer;
        # results then carry audio=None and callers must attach a streamer
        self.keep_audio = keep_audio
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.ddpm_steps = ddpm_steps
        self.cfg_scale = cfg_scale
        self.prompt_bucket = prompt_bucket
        self.processor = processor or VibeVoiceProcessor(
            tokenizer, speech_tok_compress_ratio=cfg.speech_compress_ratio)
        self._engines: Dict[tuple, G.Engine] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_random(cls, cfg: Optional[VibeVoiceConfig] = None, seed: int = 0,
                    dtype=torch.bfloat16, device="cuda", **kw) -> "VibeVoiceTTS":
        """Random-weight instance (smoke tests / benchmarking), made on the
        device from a seeded generator."""
        cfg = cfg or vibevoice_1_5b()
        device = G.resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = V.init_model(cfg, dtype=dtype, device=device, generator=gen)
        params["speech_scaling_factor"] = torch.tensor(1.0, device=device)
        params["speech_bias_factor"] = torch.tensor(0.0, device=device)
        return cls(params, cfg, ByteFallbackTokenizer(), dtype=dtype, device=device, **kw)

    # ------------------------------------------------------------------
    def _engine(self, batch: int, prompt_len: int, max_steps: int) -> G.Engine:
        bucket = max(self.prompt_bucket,
                     -(-prompt_len // self.prompt_bucket) * self.prompt_bucket)
        key = (batch, bucket, max_steps)
        if key not in self._engines:
            gen = G.GenerationConfig(
                speech_start_id=self.tokenizer.speech_start_id,
                speech_end_id=self.tokenizer.speech_end_id,
                speech_diffusion_id=self.tokenizer.speech_diffusion_id,
                eos_id=self.tokenizer.eos_id,
                cfg_scale=self.cfg_scale, ddpm_steps=self.ddpm_steps,
                do_sample=self.do_sample, refresh_negative=self.refresh_negative,
                algorithm_type=self.algorithm_type,
            )
            self._engines[key] = G.Engine(self.params, self.cfg, gen,
                                          max_steps=max_steps, batch=batch,
                                          prompt_len=bucket, dtype=self.dtype,
                                          kv_dtype=self.kv_dtype,
                                          keep_audio=self.keep_audio,
                                          device=self.device)
        return self._engines[key]

    # ------------------------------------------------------------------
    def generate(self, script, voice_samples=None, max_new_tokens: Optional[int] = None,
                 seed: int = 0, audio_streamer: Optional[AudioStreamer] = None,
                 stop_check_fn=None, on_step=None):
        """script: str | list[str]; voice_samples: paths or arrays (or nested
        per-script lists).  Returns (GenerationResult, timing metrics)."""
        if not self.keep_audio and audio_streamer is None:
            raise ValueError(
                "keep_audio=False discards the buffered waveform — attach an "
                "audio_streamer to receive the audio")
        enc = self.processor(script, voice_samples)
        b, t0 = enc.input_ids.shape
        if max_new_tokens is None:
            # reference default: min(ctx_limit - prompt, 2x prompt)
            # (modeling_vibevoice_inference.py:371-372, :421), bucketed
            limit = self.cfg.decoder.max_position_embeddings - t0
            want = min(limit, 2 * t0)
            max_new_tokens = max(64, -(-want // 256) * 256)
        eng = self._engine(b, t0, max_new_tokens)

        # re-pad the prompt to the engine's bucketed length (left padding)
        bucket = eng.prompt_len
        if bucket < t0:
            raise ValueError(f"engine prompt bucket {bucket} is smaller than the encoded "
                             f"prompt ({t0} tokens)")
        ids = np.full((b, bucket), self.tokenizer.pad_id, np.int32)
        att = np.zeros((b, bucket), np.int32)
        sim = np.zeros((b, bucket), bool)
        ids[:, bucket - t0:] = enc.input_ids
        att[:, bucket - t0:] = enc.attention_mask
        sim[:, bucket - t0:] = enc.speech_input_mask
        # masked-off pad ids must still index the embedding table
        ids = np.where(ids < 0, 0, ids)

        t_start = time.perf_counter()
        res = G.generate(eng, ids, att, sim,
                         speech_tensors=enc.speech_tensors,
                         speech_frame_masks=enc.speech_masks,
                         generator=torch.Generator(device=self.device).manual_seed(seed),
                         audio_streamer=audio_streamer,
                         stop_check_fn=stop_check_fn, on_step=on_step)
        wall = time.perf_counter() - t_start
        audio_sec = sum(0 if a is None else len(a) / 24000.0 for a in res.audio)
        metrics = {"wall_s": wall, "audio_sec": audio_sec,
                   "rtf": audio_sec / wall if wall > 0 else 0.0,
                   "steps": res.steps}
        return res, metrics

    def warm(self, batch_sizes: Sequence[int] = (1,),
             prompt_buckets: Optional[Sequence[int]] = None,
             max_new_tokens: Sequence[int] = (256,)) -> List[tuple]:
        """Build the serving engines for a shape grid and run one dummy
        prefill + 1-step decode on each (builds the kernels and warms the
        allocator before the first request).  Returns the warmed engine keys."""
        warmed = []
        for b in batch_sizes:
            for p in (prompt_buckets or [self.prompt_bucket]):
                for m in max_new_tokens:
                    eng = self._engine(b, p, m)
                    ids = np.zeros((b, eng.prompt_len), np.int32)
                    att = np.ones((b, eng.prompt_len), np.int32)
                    sim = np.zeros((b, eng.prompt_len), bool)
                    state, _ = eng.prefill(ids, att, sim)
                    state, _ = eng.decode_chunk(state, 1)
                    int(state.frames.sum())  # wait for the device
                    warmed.append((b, eng.prompt_len, m))
        return warmed

    def save_audio(self, audio, path: str) -> str:
        return self.processor.save_audio(audio, path)


__all__ = ["VibeVoiceTTS"]
