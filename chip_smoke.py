#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vibevoice_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit:
  1. build every kernel of `vibevoice_tpu_torch/csrc/` (one nvcc per source,
     all started together);
  2. each kernel against its plain PyTorch version at the 1.5B shapes (bf16
     and int8 KV, layers 0 and 27, a partial and a full live length, a
     visibility mask with holes), with its time, the plain version's, the
     library yardstick's and the bound;
  3. the long-cache engine as `bench.py` drives it (1.5B, bf16, B=1, prompt
     256, 3840 steps -> a 4096-slot cache, so decode attention runs on the
     kernel): prefill, a 16-step warm-up chunk and two timed 32-step chunks;
  4. the same engine with `kv_dtype="int8"` for 16 steps;
  5. `VibeVoiceTTS.from_random(vibevoice_1_5b())` serving three scripts (one
     with two speakers) with a streamer, each stopped after 24 steps;
  6. a tiny model on the card against the same model on the CPU (plain
     versions), as the reference on a small input.

Weights are random, made from a seed.  Prints one JSON line per measurement,
then the `kernels` line, the card's name and power limit, and as the last line
`{"ok": true, "device": {...}}`.  Exits non-zero without a GPU.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
KERNEL_TOL = 2e-3  # bf16 output (|out| < 0.5: one rounding step ~2e-3) + fp32 sum order
SEED = 0


def emit(tag, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn(i)` over `iters` calls, by CUDA events.  A
    sleep kernel holds the device while the host enqueues every call, so the
    events time the calls back to back on the device, not the host's pace of
    launching them."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * iters)  # ~0.5 ms per call: more than any call's host time
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# phase 2: decode attention against its plain version
# ---------------------------------------------------------------------------

def attention_inputs(s, lengths, quant, copies, gen, dev, n_layers=28, b=2, h=12, kvh=2, d=128):
    """q, `copies` stacked caches (so that a timing loop over copy x layer
    reads more than the 50 MB L2 holds, as a decode step finds it), the
    visibility mask with holes and the lengths."""
    from vibevoice_tpu_torch.models.qwen2 import _quantize_slots
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    caches = []
    for _ in range(copies):
        k = torch.randn((n_layers, b, s, kvh * d), generator=gen, device=dev)
        v = torch.randn((n_layers, b, s, kvh * d), generator=gen, device=dev)
        if quant:
            kq, ks = _quantize_slots(k.view(n_layers * b, s, -1))
            vq, vs = _quantize_slots(v.view(n_layers * b, s, -1))
            caches.append((kq.view(k.shape), vq.view(v.shape),
                           ks.view(n_layers, b, 1, s).expand(-1, -1, 8, -1).contiguous(),
                           vs.view(n_layers, b, 1, s).expand(-1, -1, 8, -1).contiguous()))
        else:
            caches.append((k.to(torch.bfloat16), v.to(torch.bfloat16), None, None))
        del k, v
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    vis = (torch.arange(s, device=dev)[None] < lengths[:, None]).to(torch.int32)
    # holes like those the negative stream's reset leaves
    vis[1, 1:min(40, s)] = 0
    vis[1, min(999, s - 1)] = 0
    return q, caches, vis.contiguous(), lengths


def bound_ms(q, k_full, lengths, quant: bool):
    """Least time for one call: the bytes it must move over HBM's rate, or
    its flops over the bf16 peak, whichever is larger."""
    from vibevoice_tpu_torch.ops.decode_attention import live_bytes
    nbytes = live_bytes(q, k_full, lengths, quant)
    _, h, d = q.shape
    live = int(lengths.clamp(0, k_full.shape[2]).sum())
    flops = 4 * live * h * d  # q.k and p.v: 2*D each, per live slot and query head
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_attention(q, caches, vis, lengths, quant):
    """Error of the kernel against its plain version at the first and the
    last layer, and the times of the kernel, the plain version and (bf16
    only) SDPA over the layer slice."""
    import torch.nn.functional as F
    from vibevoice_tpu_torch.ops import decode_attention as da
    k, v, ks, vs = caches[0]
    n_layers = k.shape[0]
    err = 0.0
    for layer in (0, n_layers - 1):
        got = da.decode_attention(q, k, v, layer, vis, lengths, ks, vs)
        torch.cuda.synchronize()
        want = da.decode_attention_ref(q, k, v, layer, vis, lengths, ks, vs)
        if not torch.isfinite(got).all():
            raise RuntimeError("decode_attention kernel returned non-finite values")
        err = max(err, (got.float() - want.float()).abs().max().item())
    slots = [(c, l) for c in caches for l in range(n_layers)]

    def kern(i):
        kk, vv, kss, vss = slots[i % len(slots)][0]
        da.decode_attention(q, kk, vv, slots[i % len(slots)][1], vis, lengths, kss, vss)

    def plain(i):
        kk, vv, kss, vss = slots[i % len(slots)][0]
        da.decode_attention_ref(q, kk, vv, slots[i % len(slots)][1], vis, lengths, kss, vss)

    ms = cuda_ms(kern, len(slots))
    plain_ms = cuda_ms(plain, n_layers)
    lib_ms = None
    if not quant:
        b, h, d = q.shape
        s, f = k.shape[2], k.shape[3]
        mask = ((vis > 0) & (torch.arange(s, device=q.device)[None] < lengths[:, None]))
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]

        def lib(i):
            kk, vv, _, _ = slots[i % len(slots)][0]
            layer = slots[i % len(slots)][1]
            kl = kk[layer].view(b, s, f // d, d).transpose(1, 2)
            vl = vv[layer].view(b, s, f // d, d).transpose(1, 2)
            F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask, enable_gqa=True)

        lib_ms = cuda_ms(lib, len(slots))
    bms, by = bound_ms(q, k, lengths, quant)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def phase_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for s in (4096, 8192):
        for quant in (False, True):
            for live in (1500, s):
                q, caches, vis, lengths = attention_inputs(s, [live, live], quant, 4, gen, dev)
                r = measure_attention(q, caches, vis, lengths, quant)
                emit("kernel_vs_plain", kernel="decode_attention", S=s,
                     kv="int8" if quant else "bf16", live=live, tol=KERNEL_TOL, **r)
                if not r["max_abs_err"] <= KERNEL_TOL:
                    raise RuntimeError(f"decode_attention disagrees with its plain version: "
                                       f"{r['max_abs_err']} > {KERNEL_TOL}")
                del caches
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3-4: the long-cache engine
# ---------------------------------------------------------------------------

def bench_gen(G):
    # the reference's production serving setting (as bench.py drives it)
    return G.GenerationConfig(
        speech_start_id=151652, speech_end_id=151653, speech_diffusion_id=151654,
        eos_id=151643, cfg_scale=1.3, ddpm_steps=5, algorithm_type="sde-dpmsolver++",
        force_diffusion=True, max_length_times=64.0)


def run_engine(params, cfg, dev, kv_dtype, warm_steps, timed_chunks, card):
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.ops import decode_attention as da
    batch, prompt_len, max_steps = 1, 256, 3840
    eng = G.Engine(params, cfg, bench_gen(G), max_steps=max_steps, batch=batch,
                   prompt_len=prompt_len, dtype=torch.bfloat16, kv_dtype=kv_dtype, device=dev)
    if not (eng.use_flash_decode and eng.cache_len >= 4096):
        raise RuntimeError(f"engine is off the long-cache path: cache {eng.cache_len}")
    ids = np.random.default_rng(SEED).integers(0, 1000, (batch, prompt_len)).astype(np.int32)
    mask = np.ones((batch, prompt_len), np.int32)
    sim = np.zeros((batch, prompt_len), bool)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    da.decode_attention.launches = 0
    t0 = time.perf_counter()
    state, _ = eng.prefill(ids, mask, sim, generator=gen)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = da.decode_attention.launches
    state, _ = eng.decode_chunk(state, warm_steps)
    f_prev = int(state.frames.sum())
    chunks = []
    for n in timed_chunks:
        t0 = time.perf_counter()
        state, _ = eng.decode_chunk(state, n)
        f_now = int(state.frames.sum())  # waits for the device
        dt = time.perf_counter() - t0
        chunks.append({"steps": n, "frames": f_now - f_prev, "wall_s": dt})
        f_prev = f_now
    launches = da.decode_attention.launches
    steps = warm_steps + sum(timed_chunks)
    n_layers = cfg.decoder.num_hidden_layers

    emitted = state.emitted[:, : state.step]
    audio = state.audio[:, : state.step]
    if prefill_launches != 0:
        raise RuntimeError(f"prefill launched decode attention {prefill_launches} times")
    if launches != n_layers * steps:
        raise RuntimeError(f"decode attention ran {launches} times, want {n_layers} x {steps}")
    if not bool(emitted.all()):
        raise RuntimeError("a forced-diffusion step emitted no frame")
    if not bool(torch.isfinite(audio).all()) or float(audio.abs().max()) == 0.0:
        raise RuntimeError("engine audio is not finite or is all zero")
    hop = cfg.speech_compress_ratio
    frames = sum(c["frames"] for c in chunks)
    wall = sum(c["wall_s"] for c in chunks)
    emit("engine", kv=kv_dtype, cache_slots=eng.cache_len, prefill_s=prefill_s,
         decode_steps=steps, kernel_launches=launches, launches_per_step=launches / steps,
         chunks=chunks, ms_per_frame=(1e3 * wall / frames) if frames else None,
         audio_s_per_s=(frames * hop / 24000.0 / wall) if frames else None,
         audio_absmax=float(audio.abs().max()), card=card)
    # the decode step's own operands, for the kernel's entry in the kernels line
    lengths = torch.full((2 * batch,), state.write_pos + 1, dtype=torch.int32, device=dev)
    vis = state.visible.clone()
    vis[:, state.write_pos] = 1
    return launches, state.cache, vis, lengths


def kernel_entry(name, launches, cache, vis, lengths, quant, dev, dec):
    """The kernels-line entry of decode attention at the engine's own cache,
    visibility and lengths (the cache is cloned 3 times so that the timing
    loop reads more than L2 holds)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((vis.shape[0], dec.num_attention_heads, dec.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    base = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    caches = [base] + [tuple(None if x is None else x.clone() for x in base) for _ in range(3)]
    r = measure_attention(q, caches, vis, lengths, quant)
    if not r["max_abs_err"] <= KERNEL_TOL:
        raise RuntimeError(f"{name}: {r['max_abs_err']} > {KERNEL_TOL} at the engine's shapes")
    return {"name": name, "route": "cuda",
            "source": "vibevoice_tpu_torch/csrc/decode_attention.cu",
            "replaces": "vibevoice_tpu/ops/decode_attention.py:98",
            "launches": launches, **r, "tol": KERNEL_TOL,
            "shape": {"q": list(q.shape), "cache": list(cache.k.shape),
                      "live": int(lengths[0])}}


# ---------------------------------------------------------------------------
# phase 5: the pipeline
# ---------------------------------------------------------------------------

def register_forced_engine(tts, G, script, voices, max_new_tokens):
    """A force_diffusion engine under the key `generate` will ask for (random
    weights almost never pick the diffusion token by themselves)."""
    t0 = tts.processor(script, voices).input_ids.shape[1]
    bucket = max(tts.prompt_bucket, -(-t0 // tts.prompt_bucket) * tts.prompt_bucket)
    key = (1, bucket, max_new_tokens)
    if key not in tts._engines:
        gen = G.GenerationConfig(
            speech_start_id=tts.tokenizer.speech_start_id,
            speech_end_id=tts.tokenizer.speech_end_id,
            speech_diffusion_id=tts.tokenizer.speech_diffusion_id,
            eos_id=tts.tokenizer.eos_id, cfg_scale=tts.cfg_scale, ddpm_steps=tts.ddpm_steps,
            algorithm_type=tts.algorithm_type, force_diffusion=True, max_length_times=64.0)
        tts._engines[key] = G.Engine(tts.params, tts.cfg, gen, max_steps=max_new_tokens,
                                     batch=1, prompt_len=bucket, dtype=tts.dtype,
                                     device=tts.device)
    return tts._engines[key]


def phase_pipeline(dev, card):
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.engine.streamer import AudioStreamer
    from vibevoice_tpu_torch.ops import decode_attention as da
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    tts = VibeVoiceTTS.from_random(vibevoice_1_5b(), seed=SEED + 2, dtype=torch.bfloat16,
                                   ddpm_steps=5, cfg_scale=1.3,
                                   algorithm_type="sde-dpmsolver++", device=dev)
    rng = np.random.default_rng(SEED)
    voices = [rng.normal(0, 0.05, 48000).astype(np.float32),
              rng.normal(0, 0.05, 36000).astype(np.float32)]
    scripts = [("Speaker 1: Good morning, and welcome to the show.", voices[:1]),
               ("Speaker 1: Did you hear the news?\nSpeaker 2: I did, it is remarkable.\n"
                "Speaker 1: Tell me more.", voices),
               ("Speaker 1: " + "This is a longer passage read aloud. " * 6, voices[1:])]
    max_new, stop_after, hop = 3840, 24, tts.cfg.speech_compress_ratio
    total = 0
    for i, (script, vs) in enumerate(scripts):
        eng = register_forced_engine(tts, G, script, vs, max_new)
        if not (eng.use_flash_decode and eng.cache_len >= 4096):
            raise RuntimeError(f"pipeline engine is off the long-cache path: {eng.cache_len}")
        streamer = AudioStreamer(batch_size=1)
        seen = []
        da.decode_attention.launches = 0
        res, metrics = tts.generate(script, vs, max_new_tokens=max_new, seed=i,
                                    audio_streamer=streamer,
                                    stop_check_fn=lambda: len(seen) >= stop_after,
                                    on_step=seen.append)
        launches = da.decode_attention.launches
        chunks = list(streamer.get_stream(0))
        audio = res.audio[0]
        if audio is None or not np.isfinite(audio).all() or np.abs(audio).max() == 0:
            raise RuntimeError(f"request {i}: audio missing, non-finite or all zero")
        if len(chunks) != res.steps or not np.array_equal(np.concatenate(chunks), audio):
            raise RuntimeError(f"request {i}: streamed chunks differ from the buffered audio")
        if len(audio) != res.steps * hop or res.steps < stop_after:
            raise RuntimeError(f"request {i}: {res.steps} steps, {len(audio)} samples")
        if launches != tts.cfg.decoder.num_hidden_layers * (res.steps - 1):
            raise RuntimeError(f"request {i}: decode attention ran {launches} times "
                               f"for {res.steps - 1} decode steps")
        total += launches
        emit("pipeline", request=i, speakers=len(vs), prompt_bucket=eng.prompt_len,
             cache_slots=eng.cache_len, steps=res.steps, kernel_launches=launches,
             wall_s=metrics["wall_s"], audio_sec=metrics["audio_sec"], rtf=metrics["rtf"],
             card=card)
    del tts
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 6: a small model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def _live_audio_path(params, gen):
    """Give a random tiny model an audio path that carries signal and depends
    on the LM: lift the tokenizers' 1e-6 layer scales, and replace the
    diffusion head's zero-initialised adaLN and final layers."""
    def boost(tree):
        if isinstance(tree, dict):
            return {k: (v * 0.5e6 if k in ("gamma", "ffn_gamma") else boost(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [boost(v) for v in tree]
        return tree

    for name in ("acoustic_decoder", "semantic_encoder"):
        params[name] = boost(params[name])
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = torch.randn(lp["ada_w"].shape, generator=gen) * 0.05
    for k in ("final_ada_w", "final_linear"):
        head[k] = torch.randn(head[k].shape, generator=gen) * 0.05
    params["speech_scaling_factor"] = torch.tensor(0.8)
    params["speech_bias_factor"] = torch.tensor(0.1)


def phase_reference(dev):
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.ops import decode_attention as da
    cfg = tiny_config(hidden_size=256, vocab_size=320)  # head_dim 64: the kernel's
    gen = torch.Generator().manual_seed(SEED)
    params = V.init_model(cfg, generator=gen)
    _live_audio_path(params, gen)
    rng = np.random.default_rng(SEED)
    b, t, steps = 2, 40, 24
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    ids[:, -1] = 258
    mask = np.ones((b, t), np.int32)
    mask[1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(steps, b, cfg.acoustic_vae_dim)).astype(np.float32)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                             eos_id=256, cfg_scale=1.3, ddpm_steps=3, force_diffusion=True,
                             max_length_times=64.0)
    out = {}
    for where in ("cpu", dev):
        eng = G.Engine(params, cfg, gcfg, max_steps=steps, batch=b, prompt_len=t,
                       inject_latent_noise=True, use_flash_decode=True, device=where)
        da.decode_attention.launches = 0
        out[str(where)] = (G.generate(eng, ids, mask, sim, latent_noise=noise),
                           da.decode_attention.launches)
    (ref, cpu_launches), (got, gpu_launches) = out["cpu"], out[str(dev)]
    if cpu_launches != 0 or gpu_launches != cfg.decoder.num_hidden_layers * (steps - 1):
        raise RuntimeError(f"launches: cpu {cpu_launches}, gpu {gpu_launches}")
    if not np.array_equal(got.tokens, ref.tokens):
        raise RuntimeError(f"tokens differ: {got.tokens} vs {ref.tokens}")
    a, w = np.concatenate(got.audio), np.concatenate(ref.audio)
    if not (np.isfinite(a).all() and np.isfinite(w).all()):
        raise RuntimeError("tiny-model audio is not finite")
    err, scale = float(np.abs(a - w).max()), float(np.abs(w).max())
    tol = 1e-3 * scale  # fp32 on both; sums in another order on the card
    emit("reference", model="tiny_config(hidden_size=256)", steps=steps,
         audio_max_abs_err=err, audio_absmax=scale, tol=tol)
    if not (scale > 0 and err <= tol):
        raise RuntimeError(f"card and CPU disagree: {err} > {tol}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU only",
              file=sys.stderr)
        return 2
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine.generate import resolve_device
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    emit("setup", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # 1. build
    build_s, logs = cuda_build.build_all()
    emit("build", seconds=build_s, sources=sorted(cuda_build.SOURCES.values()),
         ptxas=[ln.strip() for log in logs.values() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln][:12])

    # 2. kernel against plain
    phase_kernels(dev)

    # 3-4. engine, bf16 then int8 KV
    cfg = vibevoice_1_5b()
    t0 = time.perf_counter()
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    torch.cuda.synchronize()
    emit("init", model="vibevoice_1_5b", dtype="bf16", seconds=time.perf_counter() - t0)
    n_main, cache, vis, lengths = run_engine(params, cfg, dev, "model", 16, (32, 32), card)
    entries = [kernel_entry("decode_attention", n_main, cache, vis, lengths, False, dev,
                            cfg.decoder)]
    del cache
    n_int8, cache, vis, lengths = run_engine(params, cfg, dev, "int8", 8, (8,), card)
    entries.append(kernel_entry("decode_attention[int8 KV]", n_int8, cache, vis, lengths,
                                True, dev, cfg.decoder))
    del cache, params
    torch.cuda.empty_cache()

    # 5. pipeline
    phase_pipeline(dev, card)

    # 6. reference on a small input
    phase_reference(dev)

    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
