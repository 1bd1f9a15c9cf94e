#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vibevoice_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit:
  1. build every kernel of `vibevoice_tpu_torch/csrc/` (one nvcc per source,
     all started together), with ptxas's registers and spills of each;
  2. each kernel against its plain PyTorch version at the 1.5B shapes, with
     its time, the plain version's, the library yardstick's and the bound:
     decode attention (bf16 and int8 KV, layers 0 and 27, a partial and a full
     live length, a visibility mask with holes; then ~340 live slots of 4096,
     40 000 of 40 960 in bf16 and int8 KV, the 7B grouping H=28, KVH=4, and a
     TP=2 rank's lanes H=6, KVH=1 in bf16 and int8 KV, each with its share of
     the bound and two calls bit-equal); int4_matmul at the four LM
     projections with M=2 (per channel and with 128-row groups) and at M=64
     and M=128; the int4 Block1D chain at the 1.5B stage shapes with B=1 and
     B=4, two calls bit-equal; the fused int4 head at N=2, two calls
     bit-equal; the large-T stage kernel at the eight folded B=1 stage
     calls of a 1.5B decode step (two chunks each, states carried), with
     the folded tail, and unfolded at B=2; the row-lane stage kernel at B=2,
     3 (three lane groups), 4 and 32, each followed by the plain stage kernel
     on the same rows and required bit-equal to it; flash prefill (bf16, H=12, KVH=2, D=128) at B=1 with T=1024
     and 4096 and at B=2, T=1024 with one row left-padded by 333 tokens, and
     at the 7B shape (H=28, KVH=4) with B=1, T=4096, and at phase 10's
     shapes (a TP=2 rank's H=6, KVH=1 at T=1024; a CP rank's 4096 rows over
     S=8192 keys at row_offset 0 and 4096), each query row against its own
     scale, at the CTA height it picks and at both (64 and 128
     rows), against its bound and SDPA; the plain-pack (bf16) chain at the
     four packed stages of a step, B=1 and B=2, two chunks with the context
     carried, two calls bit-equal, with its share of the bound; the
     latent-attention decode kernel (`phase_mla`) at the 45k DeepSeek-V2-Lite
     cell's operands (27 layers, 8 rows of 53 248 latent slots, the
     negative rows' sparse visibility), layers 0 and 26, two calls
     bit-equal, its time against its bound, the plain version's and SDPA's,
     and its nodes in the captured step of a DeepSeek-V2-Lite VibeVoice,
     all 27 layers (equal to its eager step), with the grouped expert
     kernel's; the grouped expert kernel (`phase_moe`) at the cell's expert
     layers (64 experts of H 2 048, F 1 408, 8 rows hitting 24), against the
     plain version in fp32 with the plain bf16 version's error beside it, two
     calls bit-equal, its time a layer against its bound and the plain
     version's;
  3. the long-cache engine as `bench.py` drives it (1.5B, bf16, B=1, prompt
     256, 3840 steps -> a 4096-slot cache, so decode attention runs on the
     kernel): prefill, a 16-step warm-up chunk and two timed 32-step chunks.
     Every engine run of phases 3-5 goes in turns eager, graph, graph, eager:
     `Engine(eager=True)` launches each step from the host, the default
     engine replays its decode step from the CUDA graph it captured in its
     first chunk (the second graph turn is a second request on the same
     graph); a graph turn also gives the capture's seconds, the graph's
     kernel nodes by kernel (held against one step's launches) and its
     device time per replay;
  4. the same engine with `kv_dtype="int8"` for 8 + 8 steps, then at B=2 with
     `use_fused_stages=True` for 8 + 16 steps, on stage packs without the
     row-lane layout handed in (eight stage-kernel calls per step) and by
     default (4 + 4 row-lane), the codec half of a step of each kind also
     captured alone in a CUDA graph (nodes, device time per replay);
     then the long-prompt engine: a 4096-token prompt (flash prefill by the
     auto rule, 28 launches) with `use_fused_chains` on plain bf16 packs (4 chain launches per step), prefill and 8 + 16
     steps; the same prompt's prefill through the dense path, its last hidden
     state held against the flash prefill's; and a 16 384-token flash prefill
     with its peak memory;
  5. the quantized engine, full width and depth: the same weights through
     `VibeVoiceTTS(quantize="int4", quantize_tokenizer="int4k",
     quantize_diffusion="int4k")`, prefill, a 16-step warm-up and two timed
     32-step chunks, every kernel's launches asserted per step; the same
     quantized weights with `use_fused_stages=True` (eight stage-kernel calls
     per step, the transition convs folded), as long; then `quantize="int4f"`
     for 8 + 8 steps;
  6. `VibeVoiceTTS.from_random(vibevoice_1_5b())` serving three scripts (one
     with two speakers) with a streamer, each stopped after 24 steps, in bf16
     and then in the quantized configuration, which also serves one script
     with `use_fused_stages=True`, every engine decoding through its graph;
  7. a tiny model on the card against the same model on the CPU (plain
     versions), as the reference on a small input: bf16-free fp32, plain and
     in the int4 modes (group scales, int8 tokenizer stages), and with
     `use_fused_stages=True` at B=1 (folds) and B=2 (row-lane, the default),
     and with flash prefill forced on (B=2, one row left-padded) and the
     plain chain, at head_dim 128 (`tiny_config(hidden_size=512)`);
  8. the serving deployment: a full-width 1.5B bf16 checkpoint (random,
     from the seed, with a live audio path) written in the reference's names
     as two safetensors shards with an index, `config.json` and
     `preprocessor_config.json`, by the smoke's own writer; loaded bit-equal
     to its source (`utils.checkpoint.load_hf_checkpoint`) and through
     `VibeVoiceTTS.from_pretrained` in int4 + int4k + head int4k with the
     fused stages; forced-diffusion engines of 64 steps on decode attention
     for the batches below, warmed (each step captured) but for B=3; then
     `TTSServer` (max_batch 4, max_wait_ms 500, demo/voices presets) serving
     client threads: one request alone, a batch of 4, a batch of 3 (its
     engine captured on the worker thread under traffic; one request
     streamed with buffer_sec 0.5), the same 3 through /tts, a four-speaker
     request past 1024 prompt tokens (flash prefill), one request alone
     again, /metrics and /healthz.  Every response is a mono 24 kHz PCM16
     WAV of 64 x 3200 samples, not silent, equal to `tts.generate` of the
     same batch and seed after the server stops; the stream equals its
     request through /tts and its first bytes leave before its batch ends;
     each engine was captured once, its graph's kernel nodes one eager
     step's launches;
  9. the training path: with what earlier phases held released,
     `init_model(vibevoice_1_5b(), float32)` on the card, a batch of 2 rows
     x 6 turns (one ~70-byte line and one 8 s demo voice each, 1024 tokens a
     row, 720 frames) built by `data.build_training_batch` with the byte
     tokenizer and the card's semantic encoder, `init_scaling_stats`, then
     `make_optimizer(lr=1e-4, warmup_steps=2, total_steps=100)` and 4
     `train_step`s, each printed (wall s, device ms, tokens/s, losses, peak
     memory, model FLOP/s and its share of the fp32 peak) and split into the
     audio encode, forward, backward and optimizer by CUDA events.  It holds
     that every loss is finite, step 1 (lr 0) leaves every parameter
     bit-equal, step 2 decays each >=2-d frozen-tokenizer weight by exactly
     (1 - lr1 * wd), ce_loss falls, no kernel wrapper launches and TF32 is
     off; then, with the same params and optimizer, 4 steps of the captured
     train step (`make_train_step`'s default on the card: a warm-up step and
     the capture, then 3 replays), each timed, with the capture's seconds,
     the graph pool's bytes and the peak memory, finite losses, ce_loss
     falling and no kernel launches; then a tiny model trains two steps on
     the card (captured) as on the CPU;
 10. the parallel paths as two ranks on this one card over gloo (NCCL
     refuses two ranks on one device; gloo stages every collective through
     the host, so no time here is a TP or DP speed), spawned after this
     process ran the unsharded references and released what it held:
     10a TP=2, the bf16 1.5B (live audio path), B=1, a 1024-token prompt
     (flash prefill on each rank's H=6, KVH=1) and a 4096-slot cache, 8 + 16
     eager steps, and the same weights in fp32; tokens equal to the
     unsharded engine's, the prompt's last hidden state and the first frame
     within twice the unsharded bf16-vs-fp32 distance (fp32: within 1e-3 of
     the unsharded fp32 engine's; later frames are reported: the random
     model grows any difference ~5x a frame), 28 flash
     launches a prefill and 28 decode-attention launches a step per rank,
     the all-reduces per step and their bytes and host time; 10b the same
     with int8 weights and int8 KV, 8 + 8 steps, both ranks' slot scales
     equal and every written slot's largest |int8| over both ranks 127; 10c
     DP=2, the served configuration (int4 + int4k + head int4k + fused
     stages) on a global B=4, 2 rows a rank, each rank its own captured step
     (its stage packs chosen from the global batch, as the JAX DP engine's:
     row groups of 4, which a rank's 2 rows do not fill, so those stages run
     the plain stage kernel; nodes asserted, no collective in a step), its
     rows bit-equal to an unsharded B=2 engine's on them and its tokens to
     the B=4 engine's,
     `dp_scaling_report`; 10d `cp_prefill_attention` at T=8192
     (4096 rows a rank, flash at row_offset 0 and 4096 over S=8192) and
     `ring_prefill_attention` at T=4096, every query row against the plain
     version of flash prefill over all rows in one process;
 11. the captured train step against the eager one on the fp32 1.5B at full
     width with its LM cut to 4 layers, unsharded: 4 eager and 4 captured
     steps from one set of weights, one batch and one generator seed, with
     injected and with drawn noise, the losses and every parameter
     afterwards bit-equal; then the sharded training step (eager: gloo's
     collectives are not captured) as two gloo ranks on this card: this process
     takes two unsharded steps of the fp32 1.5B at full width with its LM
     cut to 4 layers (2 rows x 3 turns of the demo voices, 576 tokens a
     row, the VAE at fix_std 0, injected noise; lr 0, then 1e-4), keeps
     each trained leaf's update and releases the model; the ranks run 11a
     TP=2 and 11b DP=2 (`shard_params`, `data.shard_batch`,
     `make_train_step(mesh=)`) from the same weights, batch and noise, each
     step split by CUDA events into forward / backward / gradient
     all-reduce / optimizer, with each rank's peak memory ("gloo on one
     card": not a TP or DP speed).  Every rank's losses equal each other's
     and the unsharded step's within 1e-5, every gathered update within
     2 lr of the unsharded one (Adam's first moves are ~lr sign(g)) and each
     leaf's mean difference within lr/100, the frozen tokenizers' decay
     exact, the DP ranks' scaling statistics the mean of their shares', no
     kernel launches; then the tiny model's TP=2 steps (untied `lm_head`,
     its logits gathered) on the card as on the CPU; 11c the sharded step
     captured over NCCL, in a child process whose NCCL group of one rank is
     both the data and the model group of a (1, 1) mesh, so that every
     collective the sharded step guards is issued (NCCL refuses two ranks on
     one card): on the same model, batch and injected noise, 2 captured and
     2 eager steps bit-equal (losses, every leaf) and both within 1e-5 (the
     losses) and 2 lr / lr/100 (the updates) of the unsharded captured step,
     the graph's kernel, NCCL and other nodes printed (one rank: not a TP or
     DP speed);
 12. the caption and quality-evaluation path through the port's own entry
     points, on a full-width 1.5B bf16 checkpoint (random, from the seed,
     with a live audio path; phase 8's writer) that each run loads with
     `--model_path`, every engine forced to diffuse (`PathRecorder`; the
     program has no such flag): 12a `scripts.quality_eval.main` with
     `--canonical` (the fifteen candidates against the bf16 baseline), 5
     solver steps and 32 new tokens on the builtin two-speaker script, every
     candidate's mel_l2 / lsd_db / snr_db finite, `decide`'s three ladders,
     and each request's launches at `expected_launches`' counts (B2 in the
     int4/int4f candidates, B3 in int4k, B4 in fs, B8 in dh4), with its RTF;
     12b `demo.inference_simple_captions.main` on a four-speaker script of
     the demo voices (a prompt past 1024 tokens: 28 flash-prefill launches)
     with steps to a 4096-slot cache (28 decode-attention launches a step,
     the graph's nodes), a mono 24 kHz wav, not silent, its SRT, VTT and JSON
     tiling [0, its duration], and a `FrameClockCaptionTracker` fed by the
     same `generate` call whose clock is the steps' audio; 12c
     `demo.batch_inference_simple_captions.main` on three scripts at
     `--batch_size 2`, its stdout ending in one `Saved audio to:` line per
     file;
 13. the web demos, the warm CLI and the podcast pipeline on phase 12's
     checkpoint (`phase_demos_pipelines`): 13a
     `scripts.warm_serving_cache.main --batch_sizes 1 2 --quantize int4`
     (every kernel library already present, both engines captured); 13b the
     web demo's event function from its UI built on the gradio stub
     (`tests/_gradio_stub.py`), int4, on `demo/text_examples/2p_dialogue.txt`:
     the streamed chunks concatenate to the complete audio, "Done", 112
     int4_matmul launches a step, and a second request stopped after its
     first chunk ends with "Generation stopped."; 13c the captions demo on
     `4p_roundtable.txt` (a 1024-token bucket: 28 flash-prefill launches)
     to a 4096-slot cache (28 decode-attention launches a step), live
     captions with every chunk, its SRT/VTT/JSON tiling the audio; 13d
     `vibevoice_tpu_torch/pipelines/run_podcast_pipeline.sh` for real with
     MODEL_PATH the checkpoint and BATCH_SIZE=2 over two scripts (its batch
     CLI forced to diffuse through `forced_module` in place of `python`):
     one wav and one srt per script, both upload hooks fired for each.

Weights are random, made from a seed.  Prints one JSON line per measurement,
then the `kernels` line (each kernel also with its launches while phase 8
served: through its wrapper, and on the device with each graph replay's
nodes; and its launches on each rank of phase 10, counted by its wrapper
and, for a DP rank's captured step, from its graph's nodes times its
replays; and its launches on the device over phase 12, and over phase 13),
the card's name and power limit, and as the last line
`{"ok": true, "device": {...}}`.  Exits non-zero without a GPU.
"""
import json
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
KERNEL_TOL = 2e-3  # bf16 output (|out| < 0.5: one rounding step ~2e-3) + fp32 sum order
SEED = 0
L2_BYTES = 50e6
QUANT_MODES = dict(quantize="int4", quantize_tokenizer="int4k", quantize_diffusion="int4k")


def emit(tag, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def ptxas_report(log: str):
    """[{kernel, registers, spill_stores, spill_loads}] of each entry function
    in one source's `nvcc -Xptxas -v` output."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"kernel": ln.split("'")[1]}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            words = ln.replace(",", "").split()
            cur["spill_stores"] = int(words[words.index("spill") - 2])
            cur["spill_loads"] = int(words[-4])
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
    return out


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


# decode attention's phase-2 cases beyond the 1.5B S=4096/8192 grid of
# `phase_kernels`: (cache slots, live slots of both rows, int8 KV, H, KVH,
# layers, cache copies), each loop over copy x layer reading more than L2: the
# engine's own live length (~340 of a 4096-slot cache), a 90-minute request
# (40 000 live of 40 960) in bf16 and int8 KV, the 7B grouping (G=7), and a
# 1.5B TP=2 rank's own lanes (H=6, KVH=1: G=6) at phase 10's live length
# (its 1024-token prompt and steps) in bf16 and int8 KV
ATTN_CASES = ((4096, 340, False, 12, 2, 28, 4), (40960, 40000, False, 12, 2, 4, 1),
              (40960, 40000, True, 12, 2, 4, 1), (4096, 1500, False, 28, 4, 28, 1),
              (40960, 40000, False, 28, 4, 2, 1), (4096, 1050, False, 6, 1, 28, 4),
              (4096, 1050, True, 6, 1, 28, 4))


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
    for s, live, quant, h, kvh, n_layers, copies in ATTN_CASES:
        q, caches, vis, lengths = attention_inputs(s, [live, live], quant, copies, gen, dev,
                                                   n_layers=n_layers, h=h, kvh=kvh)
        r = measure_attention(q, caches, vis, lengths, quant)
        k, v, ks, vs = caches[0]
        stable = torch.equal(*(da_call(q, k, v, vis, lengths, ks, vs) for _ in range(2)))
        emit("kernel_vs_plain", kernel="decode_attention", S=s, kv="int8" if quant else "bf16",
             live=live, H=h, KVH=kvh, layers=n_layers, copies=copies, bit_stable=stable,
             bound_share=r["bound_ms"] / r["ms"], tol=KERNEL_TOL, **r)
        if not (r["max_abs_err"] <= KERNEL_TOL and stable):
            raise RuntimeError(f"decode_attention at S={s} live={live}: error "
                               f"{r['max_abs_err']} > {KERNEL_TOL} or two calls differ")
        del caches, k, v, ks, vs
    torch.cuda.empty_cache()


def da_call(q, k, v, vis, lengths, ks, vs):
    from vibevoice_tpu_torch.ops import decode_attention as da
    return da.decode_attention(q, k, v, k.shape[0] - 1, vis, lengths, ks, vs)


# ---------------------------------------------------------------------------
# phase 2, the int4 kernels: int4_matmul, the Block1D chain, the fused head
# ---------------------------------------------------------------------------

def rel_tol(want) -> float:
    """bf16 outputs: one rounding step of the largest output (2^-7 of it),
    after fp32 sums taken in another order."""
    return 2 ** -7 * float(want.float().abs().max())


def agree(name, got, want):
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name} kernel returned non-finite values")
    err, tol = float((got.float() - want.float()).abs().max()), rel_tol(want)
    if not err <= tol:
        raise RuntimeError(f"{name} disagrees with its plain version: {err} > {tol}")
    return err, tol


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def copies_for(size: int) -> int:
    """Weight copies a timing loop rotates over so that it reads about twice
    what the 50 MB L2 holds, as a decode step finds its weights cold."""
    return max(2, -(-int(2 * L2_BYTES) // max(1, size)))


def measure_int4(x, weights):
    """int4_matmul on x [M, K] bf16 against weight copies of one shape: error
    against the plain version, kernel / plain / library (torch.matmul against
    the pre-dequantized bf16 weight) times, and the bound (per call)."""
    from vibevoice_tpu_torch.ops import int4_matmul as im
    w0 = weights[0]
    err, tol = agree("int4_matmul", im.int4_matmul(x, w0["qint4"], w0["scale4"]),
                     im.int4_matmul_ref(x, w0["qint4"], w0["scale4"]))
    n = len(weights)
    ms = cuda_ms(lambda i: im.int4_matmul(x, weights[i % n]["qint4"], weights[i % n]["scale4"]),
                 2 * n)
    plain_ms = cuda_ms(lambda i: im.int4_matmul_ref(x, weights[i % n]["qint4"],
                                                    weights[i % n]["scale4"]), min(n, 8))
    dense = [im.dequant_int4(w["qint4"], w["scale4"], x.dtype) for w in weights]
    lib_ms = cuda_ms(lambda i: torch.matmul(x, dense[i % n]), 2 * n)
    del dense
    bms, by = int4_bound(x, w0)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def int4_bound(x, w):
    """x, the packed weight and its scales read once, y written once, or
    2*M*K*N flops."""
    m, k = x.shape
    cols = w["qint4"].shape[1]
    return bound(nbytes(x, w["qint4"], w["scale4"]) + m * cols * x.element_size(),
                 2 * m * k * cols)


# int4_matmul's phase-2 cases: the 1.5B projections (K, N) at M=2, per
# channel and per group of 128, then M=64 and 128
INT4_SHAPES = {"qkv": (1536, 2048), "o": (1536, 1536), "gateup": (1536, 17920),
               "down": (8960, 1536)}
INT4_CASES = ([(name, 2, gs) for name in INT4_SHAPES for gs in (None, 128)]
              + [("qkv", 64, None), ("qkv", 128, None), ("qkv", 128, 128)])


def int4_inputs(name, m, gs, gen, dev):
    """bf16 x [M, K] and copies of a random int4 weight of projection
    `name` (enough to read twice what L2 holds per timing loop)."""
    from vibevoice_tpu_torch.ops import int4_matmul as im
    k, n = INT4_SHAPES[name]
    weights = [im.quantize_int4(torch.randn((k, n), generator=gen, device=dev) * 0.02, gs)
               for _ in range(copies_for(k * n // 2))]
    return torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16), weights


def chain_inputs(pack, b, t, gen, dev):
    n, _, d = pack["vecs"].shape
    x = (0.5 * torch.randn((b, t, d), generator=gen, device=dev)).to(torch.bfloat16)
    ctx = (0.5 * torch.randn((b, n, 6, d), generator=gen, device=dev)).to(torch.bfloat16)
    return x, ctx


def measure_chain(packs, x, ctx):
    """A chain kernel over pack copies of one stage shape (per call): the int4
    chain for int4 packs, the plain-pack chain for plain ones; two calls on
    the same inputs must give the same bits (sums in a fixed order).  Its
    error, times, bound and share of the bound."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    plain = "w1q" not in packs[0]
    run = fb.fused_block_chain_plain if plain else fb.fused_block_chain_batched
    ref = fb.fused_block_chain_plain_ref if plain else fb.fused_block_chain_batched_ref
    name = "fused_block_chain" if plain else "fused_block_chain_batched"
    y, new_ctx = run(packs[0], x, ctx)
    y_ref, ctx_ref = ref(packs[0], x, ctx)
    err, tol = agree(name, y, y_ref)
    err_c, tol_c = agree(f"{name}[ctx]", new_ctx, ctx_ref)
    y2, ctx2 = run(packs[0], x, ctx)  # sums in a fixed order: a second call gives the same bits
    if not (torch.equal(y, y2) and torch.equal(new_ctx, ctx2)):
        raise RuntimeError(f"{name}: two calls on the same inputs differ")
    n = len(packs)
    ms = cuda_ms(lambda i: run(packs[i % n], x, ctx), 2 * n)
    plain_ms = cuda_ms(lambda i: ref(packs[i % n], x, ctx), min(n, 4))
    bms, by = chain_bound(packs[0], x, ctx)
    return dict(max_abs_err=max(err, err_c), tol=min(tol, tol_c), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None, bit_stable=True,
                bound_share=bms / ms)


def chain_bound(pack, x, ctx):
    """The pack, x and ctx read once, y and the new ctx written once, or
    4*rows*D*F flops per block."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    b, t, d = x.shape
    nb, f = pack["vecs"].shape[0], pack["w1" if "w1q" not in pack else "w1q"].shape[2]
    return bound(fb.pack_bytes(pack) + 2 * nbytes(x, ctx), 4 * b * t * d * f * nb)


def head_inputs(pack, n, lat, gen, dev):
    nl, _, h = pack["norms"].shape
    bf = torch.bfloat16
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return (r(n, h).to(bf), (0.3 * r(nl, n, 3 * h)).to(bf), (0.3 * r(n, 2 * h)).to(bf),
            (0.05 * r(h, lat)).to(bf))


def measure_head(packs, x, mods, fmod, fl, eps=1e-5):
    """The fused int4 head step over pack copies (per call); two calls on the
    same inputs must give the same bits (sums in a fixed order)."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    got = fh.fused_head_solver_step(packs[0], x, mods, fmod, fl, eps)
    err, tol = agree("fused_head", got,
                     fh.fused_head_solver_step_ref(packs[0], x, mods, fmod, fl, eps))
    if not torch.equal(got, fh.fused_head_solver_step(packs[0], x, mods, fmod, fl, eps)):
        raise RuntimeError("fused_head: two calls on the same inputs differ")
    n = len(packs)
    ms = cuda_ms(lambda i: fh.fused_head_solver_step(packs[i % n], x, mods, fmod, fl, eps), 2 * n)
    plain_ms = cuda_ms(lambda i: fh.fused_head_solver_step_ref(packs[i % n], x, mods, fmod, fl,
                                                               eps), min(n, 4))
    bms, by = head_bound(packs[0], x, mods, fmod, fl)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def head_bound(pack, x, mods, fmod, fl):
    """The pack, x, the modulations and the final linear read once, the
    output written once, or 6*N*H*F flops per layer and 2*N*H*latent."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    rows, h = x.shape
    nl, f = pack["norms"].shape[0], pack["wgq"].shape[2]
    return bound(fh.pack_bytes(pack) + nbytes(x, mods, fmod, fl)
                 + rows * fl.shape[1] * x.element_size(),
                 6 * rows * h * f * nl + 2 * rows * h * fl.shape[1])


# the bf16 head kernel's phase-2 shapes (H, F): the 1.5B and Large heads, one
# solver step at N = 16 (B = 8, the podcast cells' batch)
HEAD_BF16_SHAPES = ((1536, 4608), (3584, 10752))


def random_head_bf16(h, f, lat, gen, dev):
    """A 4-layer bf16 head at width h, FFN width f: the layers' FFN weights
    and norms, noisy_proj and final_linear."""
    bf = torch.bfloat16
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {"layers": [{"norm_w": (1 + 0.1 * r(h)).to(bf), "gate": (0.03 * r(h, f)).to(bf),
                        "up": (0.03 * r(h, f)).to(bf), "down": (0.03 * r(f, h)).to(bf)}
                       for _ in range(4)],
            "noisy_proj": (0.05 * r(lat, h)).to(bf), "final_linear": (0.05 * r(h, lat)).to(bf)}


def measure_head_bf16(heads, n, gen, dev, eps=1e-5):
    """The bf16 head kernel at one shape over copies of the head (per call):
    its error against the plain version, two calls bit-equal; its time, the
    plain version's, the library yardstick's (the plain bf16
    `apply_with_modulations` chain the kernel replaced: cuBLAS matmuls and
    elementwise ops, from the noisy latent) and the bound."""
    from vibevoice_tpu_torch.configs import DiffusionHeadConfig
    from vibevoice_tpu_torch.models import diffusion_head as dh
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    h, f = heads[0]["layers"][0]["gate"].shape
    lat = heads[0]["final_linear"].shape[1]
    cfg = DiffusionHeadConfig(hidden_size=h, latent_size=lat, head_layers=4,
                              head_ffn_ratio=f / h, rms_norm_eps=eps)
    pks = [fhb.pack(hd) for hd in heads]
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    noisy = r(n, lat).to(torch.bfloat16)
    mods, fmod = (0.3 * r(4, n, 3 * h)).to(torch.bfloat16), (0.3 * r(n, 2 * h)).to(torch.bfloat16)
    x, fl = noisy @ heads[0]["noisy_proj"], heads[0]["final_linear"]
    got = fhb.fused_head_bf16_step(pks[0], x, mods, fmod, fl, eps)
    err, tol = agree("fused_head_bf16", got,
                     fhb.fused_head_bf16_step_ref(pks[0], x, mods, fmod, fl, eps))
    if not torch.equal(got, fhb.fused_head_bf16_step(pks[0], x, mods, fmod, fl, eps)):
        raise RuntimeError("fused_head_bf16: two calls on the same inputs differ")
    k = len(heads)
    ms = cuda_ms(lambda i: fhb.fused_head_bf16_step(pks[i % k], x, mods, fmod, fl, eps), 2 * k)
    plain_ms = cuda_ms(lambda i: fhb.fused_head_bf16_step_ref(pks[i % k], x, mods, fmod, fl,
                                                              eps), k)
    lib_ms = cuda_ms(lambda i: dh.apply_with_modulations(heads[i % k], cfg, noisy, list(mods),
                                                         fmod), 2 * k)
    bms, by = bound(fhb.weight_bytes(pks[0]) + nbytes(x, mods, fmod, fl, *pks[0]["norm_w"])
                    + n * lat * 2, 6 * n * h * f * 4 + 2 * n * h * lat)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def phase_head_bf16(dev):
    """The bf16 head kernel against its plain version at the 1.5B and Large
    shapes, N = 16, on random weights made from the seed; returns each
    shape's result."""
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    for h, f in HEAD_BF16_SHAPES:
        heads = [random_head_bf16(h, f, 64, gen, dev) for _ in range(copies_for(6 * 4 * h * f))]
        r = measure_head_bf16(heads, 16, gen, dev)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        emit("kernel_vs_plain", kernel="fused_head_bf16", N=16, H=h, F=f, layers=4,
             plan=fhb.plan_for(heads[0]["final_linear"].new_empty(16, h), f, 64)._asdict(), **r)
        out[(h, f)] = r
        del heads
    torch.cuda.empty_cache()
    return out


def bf16_head_route(eng):
    """Whether `eng` must run its head on the bf16 head kernel, from its
    configuration and not from the route it set: plain bf16 head weights at
    widths the kernel takes (H a multiple of 128 up to 4096), on the card,
    with no TP mesh and no int4k pack."""
    layers = eng.params["diffusion_head"]["layers"]
    h = layers[0]["gate"].shape[0] if isinstance(layers[0]["gate"], torch.Tensor) else 0
    return (eng.device.type == "cuda" and eng.tp_mesh is None
            and "_diffusion_head_packq" not in eng.params and h % 128 == 0 and 0 < h <= 4096
            and all(isinstance(lp[k], torch.Tensor) and lp[k].dtype == torch.bfloat16
                    for lp in layers for k in ("gate", "up", "down")))


def head_bf16_entry(results, eng, launches):
    """The kernels-line entry of the bf16 head kernel: the 1.5B shape's
    numbers (N = 16), the Large shape's beside them, and the launches of the
    phase-3 bf16 engine, which must hold the route and have launched it."""
    if "_diffusion_head_bf16" not in eng.params or launches <= 0:
        raise RuntimeError(f"the bf16 engine ran its head off the bf16 head kernel: route "
                           f"{'_diffusion_head_bf16' in eng.params}, {launches} launches")
    (h, f), (h7, f7) = HEAD_BF16_SHAPES
    return {"name": "fused_head_bf16", "route": "cuda",
            "source": "vibevoice_tpu_torch/csrc/fused_head_bf16.cu",
            "replaces": "none (the JAX package leaves the bf16 head to XLA)",
            "launches": launches, **results[(h, f)],
            "per": f"launch: one solver step at N=16, H={h}, F={f}",
            "large": dict(results[(h7, f7)], per=f"N=16, H={h7}, F={f7}")}


# the int4 chain's phase-2 cases (D, blocks, T, B): the four 1.5B stages are
# two shapes (decoder 0 / encoder 6: D=2048, 8 blocks, T=1; decoder 1 /
# encoder 5: D=1024, 3 blocks, T=8), plus B=4
CHAIN_CASES = ((2048, 8, 1, 1), (1024, 3, 8, 1), (1024, 3, 8, 4))


def random_stage(d, n, gen, dev):
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return [{"norm_w": 1 + 0.1 * r(d), "mixer": {"w": 0.2 * r(7, 1, d), "b": 0.1 * r(d)},
             "gamma": 0.3 * r(d), "ffn_norm_w": 1 + 0.1 * r(d),
             "ffn1": {"w": 0.02 * r(d, 4 * d), "b": 0.1 * r(4 * d)},
             "ffn2": {"w": 0.02 * r(4 * d, d), "b": 0.1 * r(d)}, "ffn_gamma": 0.3 * r(d)}
            for _ in range(n)]


def random_head(h, f, gen, dev):
    """A 4-layer head's FFN weights and norms at width h, FFN width f."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {"layers": [{"norm_w": 1 + 0.1 * r(h), "gate": 0.03 * r(h, f), "up": 0.03 * r(h, f),
                        "down": 0.03 * r(f, h)} for _ in range(4)]}


def phase_int4_kernels(dev):
    """The three int4 kernels against their plain versions at the 1.5B
    shapes, on random weights made from the seed."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb, fused_head as fh
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for name, m, gs in INT4_CASES:
        x, weights = int4_inputs(name, m, gs, gen, dev)
        k, n = INT4_SHAPES[name]
        emit("kernel_vs_plain", kernel="int4_matmul", proj=name, M=m, K=k, N=n,
             group_size=gs, **measure_int4(x, weights))
        del weights
    for d, nblk, t, b in CHAIN_CASES:
        packs = [fb.pack_stage_q(random_stage(d, nblk, gen, dev))
                 for _ in range(copies_for(nblk * d * 4 * d))]
        x, ctx = chain_inputs(packs[0], b, t, gen, dev)
        emit("kernel_vs_plain", kernel="fused_block_chain_batched", D=d, blocks=nblk, T=t, B=b,
             **measure_chain(packs, x, ctx))
        del packs
    h, f = 1536, 4608
    packs = [fh.pack_head_solver_q(random_head(h, f, gen, dev))
             for _ in range(copies_for(6 * h * f))]
    emit("kernel_vs_plain", kernel="fused_head_solver_step", N=2, H=h, F=f, layers=4,
         **measure_head(packs, *head_inputs(packs[0], 2, 64, gen, dev)))
    del packs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2, the large-T stage kernels: fused_stage_chain and its row-lane form
# ---------------------------------------------------------------------------

# (name, B, stage T, D, folded conv (kind, s, k, cin), folded tail, row-lane R);
# 3 blocks each, as every large-T stage of the 1.5B stacks
STAGE_CASES = [
    ("decoder 3", 1, 200, 256, ("up", 5, 10, 512), False, None),
    ("decoder 4", 1, 800, 128, ("up", 4, 8, 256), False, None),
    ("decoder 5", 1, 1600, 64, ("up", 2, 4, 128), False, None),
    ("decoder 6", 1, 3200, 32, ("up", 2, 4, 64), False, None),
    ("encoder 0", 1, 3200, 32, ("down", 1, 7, 1), False, None),
    ("encoder 1", 1, 1600, 64, ("down", 2, 4, 32), False, None),
    ("encoder 2", 1, 800, 128, ("down", 2, 4, 64), False, None),
    ("encoder 3", 1, 200, 256, ("down", 4, 8, 128), False, None),
    ("decoder 6 + tail", 1, 3200, 32, ("up", 2, 4, 64), True, None),
    ("decoder 4", 2, 800, 128, None, False, None),
    ("decoder 3", 2, 200, 256, None, False, None),
    ("decoder 6", 2, 3200, 32, None, False, 2),
    ("decoder 5", 2, 1600, 64, None, False, 2),
    ("decoder 6", 3, 3200, 32, None, False, 3),
    ("decoder 6", 4, 3200, 32, None, False, 4),
    ("decoder 5", 4, 1600, 64, None, False, 2),
    ("decoder 6", 32, 3200, 32, None, False, 4),
    ("decoder 5", 32, 1600, 64, None, False, 2),
]


def stage_inputs(pack, b, t, gen, dev):
    """Two chunks of x, the block contexts and the folds' states of a stage
    pack at batch b and stage T (the activation dtype is the pack's)."""
    n, _, d = pack["vecs"].shape
    rnd = lambda *shape: (0.5 * torch.randn(shape, generator=gen, device=dev)).to(
        pack["vecs"].dtype)
    conv, states = pack.get("conv"), {}
    xshape = (b, t, d)
    if conv is not None and conv.kind == "up":
        xshape, states["conv_state"] = (b, t // conv.s, conv.cin), (b, conv.s, d)
    elif conv is not None:
        xshape, states["conv_state"] = (b, t * conv.s, conv.cin), (b, conv.k - conv.s, conv.cin)
    if "head" in pack:
        states["head_state"] = (b, pack["head"].k - 1, d)
    return ([rnd(*xshape) for _ in range(2)], rnd(b, n, 6, d),
            {k: rnd(*shape) for k, shape in states.items()})


def clone_pack(pack):
    from vibevoice_tpu_torch.ops import fused_stage as fs
    out = {}
    for k, v in pack.items():
        if isinstance(v, dict):
            out[k] = clone_pack(v)
        elif isinstance(v, fs.ConvPack):
            out[k] = fs.ConvPack(v.kind, v.w.clone(), v.b.clone(), v.s, v.k, v.cin)
        elif isinstance(v, fs.HeadPack):
            out[k] = fs.HeadPack(v.w.clone(), None if v.b is None else v.b.clone(), v.k,
                                 v.has_norm)
        else:
            out[k] = v.clone()
    return out


def uses_rowlane(pack, batch) -> bool:
    """Whether `fused_stage_chain` sends this pack to the row-lane kernel."""
    if "rowlane" not in pack or "conv" in pack or "head" in pack:
        return False
    r = pack["rowlane"]["vecs"].shape[2] // pack["vecs"].shape[2]
    return r > 1 and batch % r == 0


def measure_stage(pack, b, t, gen, dev, inputs=None):
    """A stage kernel over two chunks (each chunk's returned states feed the
    next call, on either side) against its plain version, then its time over
    pack copies that exceed L2, the plain version's and the bound (per call).
    `inputs` (`stage_inputs`'s) are drawn from `gen` unless given."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    rowlane = uses_rowlane(pack, b)
    plain = fs.fused_stage_chain_rowlane_ref if rowlane else fs.fused_stage_chain_ref
    xs, ctx, states = inputs or stage_inputs(pack, b, t, gen, dev)
    names = list(states)
    got_st = want_st = (ctx, *states.values())
    err, tol = 0.0, 1.0  # the output closest to its tolerance
    for x in xs:
        got = fs.fused_stage_chain(pack, x, got_st[0], **dict(zip(names, got_st[1:])))
        want = plain(pack, x, want_st[0], **dict(zip(names, want_st[1:])))
        for j, (g, w) in enumerate(zip(got, want)):
            e, tl = agree(f"fused_stage_chain{'_rowlane' if rowlane else ''}[{j}]", g, w)
            if e * tol >= err * tl:
                err, tol = e, tl
        got_st, want_st = got[1:], want[1:]
    nbytes, flops = fs.stage_work(pack, xs[0])
    copies = [pack] + [clone_pack(pack) for _ in range(min(63, copies_for(nbytes) - 1))]
    n = len(copies)
    ms = cuda_ms(lambda i: fs.fused_stage_chain(copies[i % n], xs[0], ctx, **states), 2 * n)
    plain_ms = cuda_ms(lambda i: plain(copies[i % n], xs[0], ctx, **states), min(n, 4))
    bms, by = bound(nbytes, flops)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def random_stage_pack(d, conv, head, r, gen, dev):
    """A bf16 pack of a random 3-block stage of width d, with a folded conv
    (kind, s, k, cin), the folded tail and a row-lane pack for r rows as
    asked."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    bf = torch.bfloat16
    blocks = random_stage(d, 3, gen, dev)
    pack = fs.pack_stage(blocks, dtype=bf)
    if r:
        pack["rowlane"] = fs.pack_stage_rowlane(blocks, r, dtype=bf)
    if conv and conv[0] == "up":
        pack["conv"] = fs.pack_up_conv({"w": rnd(conv[3], conv[2], d) / conv[3] ** 0.5,
                                        "b": 0.1 * rnd(d)}, conv[1], bf)
    elif conv:
        pack["conv"] = fs.pack_down_conv({"w": rnd(conv[2], conv[3], d) / conv[3] ** 0.5,
                                          "b": 0.1 * rnd(d)}, conv[1], bf)
    if head:
        pack["head"] = fs.pack_head({"w": 0.1 * rnd(7, d, 1), "b": 0.1 * rnd(1)},
                                    1 + 0.1 * rnd(d))
    return pack


def phase_stage_kernels(dev):
    """Both stage kernels against their plain versions at the 1.5B stage
    shapes in bf16, on random weights made from the seed.  Each row-lane case
    is followed by the plain stage kernel on the same rows and inputs (the
    pack without its row-lane entry), the two readings the engine's row-lane
    policy rests on; the row-lane line says whether its outputs are bit-equal
    to the stage kernel's."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for name, b, t, d, conv, head, r in STAGE_CASES:
        pack = random_stage_pack(d, conv, head, r, gen, dev)
        inputs = stage_inputs(pack, b, t, gen, dev)
        same_rows = {k: v for k, v in pack.items() if k != "rowlane"}
        extra = {}
        if r:
            xs, ctx, states = inputs
            got = fs.fused_stage_chain(pack, xs[0], ctx, **states)
            want = fs.fused_stage_chain(same_rows, xs[0], ctx, **states)
            extra["bit_equal_to_stage_kernel"] = all(torch.equal(g, w) for g, w in zip(got, want))
            if not extra["bit_equal_to_stage_kernel"]:
                raise RuntimeError(f"row-lane {name} B={b} R={r} differs from the stage kernel "
                                   "on the same rows")
        emit("kernel_vs_plain",
             kernel="fused_stage_chain_rowlane" if uses_rowlane(pack, b) else "fused_stage_chain",
             stage=name, B=b, T=t, D=d, blocks=3, conv=conv, head=head, rows=r, **extra,
             **measure_stage(pack, b, t, gen, dev, inputs))
        if r:
            emit("kernel_vs_plain", kernel="fused_stage_chain", stage=name, B=b, T=t, D=d,
                 blocks=3, conv=conv, head=head, rows=None, same_rows_as_rowlane=r,
                 **measure_stage(same_rows, b, t, gen, dev, inputs))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2, the kernels of the long-prompt path: flash prefill, the plain chain
# ---------------------------------------------------------------------------

# flash prefill's phase-2 cases: (B, T, left pad of the last row, H, KVH);
# the 1.5B attention shape, then the 7B one (seven query heads per KV head)
FLASH_CASES = ((1, 1024, 0, 12, 2), (1, 4096, 0, 12, 2), (2, 1024, 333, 12, 2),
               (1, 4096, 0, 28, 4))
# and at the shapes phase 10 gives it, B=1, D=128: (T query rows, S keys,
# row_offset, H, KVH): a 1.5B TP=2 rank's heads over the 1024-token prompt,
# and each context-parallel rank's 4096 rows of the 8192-token prompt over
# all its keys (T != S)
FLASH_SHARD_CASES = ((1024, 1024, 0, 6, 1), (4096, 8192, 0, 12, 2), (4096, 8192, 4096, 12, 2))
ROW_REL_TOL = 2 ** -7  # one bf16 rounding step of a row's own largest output


def flash_inputs(b, t, pad, gen, dev, h=12, kvh=2, d=128, s=None):
    """bf16 q [B, T, H, D], k/v [B, S, KVH, D] (S = T by default) and the pad
    mask [B, S], the last row left-padded by `pad` tokens."""
    rnd = lambda *shape: (0.5 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
    s = t if s is None else s
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[b - 1, :pad] = 0
    return rnd(b, t, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), mask


def agree_rows(name, got, want, mask, tol=ROW_REL_TOL):
    """Flash prefill's output against its plain version, row by row: every
    row finite, each real query row (position, head) within one bf16 step of
    its own largest output (a late row averages over thousands of keys and is
    far smaller than the largest of all), the rows that see no key zero.
    Returns (max abs error, worst row's error over its scale, median |want|
    over the real rows)."""
    if got.is_cuda:
        torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name} kernel returned non-finite values")
    real = mask > 0
    g, w = got[real].float(), want[real].float()          # [real positions, H, D]
    err_row = (g - w).abs().amax(dim=-1)
    scale_row = w.abs().amax(dim=-1)
    worst = float((err_row / scale_row.clamp_min(1e-30)).max())
    if not worst <= tol:
        raise RuntimeError(f"{name} disagrees with its plain version: a row is off by {worst} "
                           f"of its scale > {tol}")
    if bool(got[~real].any()):
        raise RuntimeError(f"{name}: a row that sees no key is not zero")
    return float(err_row.max()), worst, float(w.abs().median())


def flash_library(q, k, v, mask, row_offset=0):
    """One SDPA call computing the same function (causal, GQA; with the pad
    mask where a row is padded, and query row i at position row_offset + i
    of the keys)."""
    import torch.nn.functional as F
    t, s = q.shape[1], k.shape[1]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    real = mask > 0
    if bool(real.all()) and t == s:
        return lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                        enable_gqa=True)
    pos = row_offset + torch.arange(t, device=q.device)
    allowed = ((torch.arange(s, device=q.device)[None] <= pos[:, None])[None]
               & real[:, None, :])[:, None]
    return lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                    enable_gqa=True)


def flash_bound(q, k, v, mask, row_offset=0):
    """The real rows' causal (row, key) pairs at 4*D*H flops each, or q, k,
    v, the mask and the output once over HBM."""
    from vibevoice_tpu_torch.ops import flash_attention as fa
    _, t, h, d = q.shape
    pairs = fa.attended_pairs(mask, t, row_offset=row_offset)
    return bound(nbytes(q, k, v, mask) + nbytes(q), 4 * d * h * pairs)


def measure_flash(q, k, v, mask, row_offset=0):
    """Flash prefill against its plain version (`agree_rows`, on the query
    rows' own positions row_offset + i of the mask), then the kernel's time
    at the CTA height it picks and at both heights, the plain version's and
    SDPA's times, and the bound."""
    from vibevoice_tpu_torch.ops import cuda_build, flash_attention as fa
    off = dict(row_offset=row_offset)
    rows_mask = mask[:, row_offset:row_offset + q.shape[1]]
    want = fa.flash_attention_prefill_ref(q, k, v, mask, **off)
    err, worst, typical = agree_rows("flash_attention_prefill",
                                     fa.flash_attention_prefill(q, k, v, mask, **off), want,
                                     rows_mask)
    for rows in (64, 128):
        agree_rows(f"flash_attention_prefill[{rows} rows]",
                   fa.flash_attention_prefill_at(q, k, v, mask, rows, **off), want, rows_mask)
    del want
    ms = cuda_ms(lambda i: fa.flash_attention_prefill(q, k, v, mask, **off), 20)
    ms_at = {str(rows): cuda_ms(lambda i: fa.flash_attention_prefill_at(q, k, v, mask, rows,
                                                                        **off), 20)
             for rows in (64, 128)}
    plain_ms = cuda_ms(lambda i: fa.flash_attention_prefill_ref(q, k, v, mask, **off), 3)
    lib_ms = cuda_ms(flash_library(q, k, v, mask, row_offset), 20)
    bms, by = flash_bound(q, k, v, mask, row_offset)
    b, t, h, _ = q.shape
    rows = fa.cta_rows(b, t, h, k.shape[2], cuda_build.sm_count(q.device))
    return dict(max_abs_err=err, worst_row_err_rel=worst, row_rel_tol=ROW_REL_TOL,
                median_abs_want=typical, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, cta_rows=rows, ms_at_cta_rows=ms_at)


def phase_flash_kernel(dev):
    """Flash prefill at the 1.5B attention shape (H=12, KVH=2, D=128), bf16,
    at the 7B one (H=28, KVH=4: seven query heads per KV head), and at the
    shapes of phase 10's ranks (`FLASH_SHARD_CASES`)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for b, t, pad, h, kvh in FLASH_CASES:
        r = measure_flash(*flash_inputs(b, t, pad, gen, dev, h, kvh))
        emit("kernel_vs_plain", kernel="flash_attention_prefill", B=b, T=t, H=h, KVH=kvh, D=128,
             left_pad=pad, model="7B" if h == 28 else "1.5B", **r)
    for t, s, off, h, kvh in FLASH_SHARD_CASES:
        r = measure_flash(*flash_inputs(1, t, 0, gen, dev, h, kvh, s=s), row_offset=off)
        emit("kernel_vs_plain", kernel="flash_attention_prefill", B=1, T=t, S=s, row_offset=off,
             H=h, KVH=kvh, D=128, model="1.5B", path="TP rank" if h == 6 else "CP rank", **r)
    torch.cuda.empty_cache()


def phase_plain_chain(dev):
    """The plain-pack chain at the four packed stages of a 1.5B step (bf16
    packs of random weights; two per shape: decoder 0 / encoder 6 at D=2048,
    8 blocks, T=1; decoder 1 / encoder 5 at D=1024, 3 blocks, T=8), B=1 and
    B=2: each pack over two chunks with the context carried on both sides,
    then two calls bit-equal and the time per call rotating over the shape's
    two packs (each pair is over 100 MB, twice L2), with its share of the
    bound."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for (d, nblk, t), stages in (((2048, 8, 1), ("decoder 0", "encoder 6")),
                                 ((1024, 3, 8), ("decoder 1", "encoder 5"))):
        packs = [fb.pack_stage(random_stage(d, nblk, gen, dev), dtype=torch.bfloat16)
                 for _ in stages]
        for b in (1, 2):
            worst = (0.0, 1.0)
            for pack in packs:
                got_c = want_c = chain_inputs(pack, b, t, gen, dev)[1]
                for _ in range(2):
                    x = chain_inputs(pack, b, t, gen, dev)[0]
                    y, got_c = fb.fused_block_chain_plain(pack, x, got_c)
                    y_ref, want_c = fb.fused_block_chain_plain_ref(pack, x, want_c)
                    for e in (agree("fused_block_chain", y, y_ref),
                              agree("fused_block_chain[ctx]", got_c, want_c)):
                        worst = max(worst, e, key=lambda et: et[0] / et[1])
            x, ctx = chain_inputs(packs[0], b, t, gen, dev)
            r = measure_chain(packs, x, ctx)
            r["max_abs_err"], r["tol"] = max(worst, (r["max_abs_err"], r["tol"]),
                                             key=lambda et: et[0] / et[1])
            emit("kernel_vs_plain", kernel="fused_block_chain", stages=stages, D=d, blocks=nblk,
                 T=t, B=b, chunks=2, **r)
        del packs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3-5: the long-cache engine, bf16 and quantized
# ---------------------------------------------------------------------------

def bench_gen(G):
    # the reference's production serving setting (as bench.py drives it)
    return G.GenerationConfig(
        speech_start_id=151652, speech_end_id=151653, speech_diffusion_id=151654,
        eos_id=151643, cfg_scale=1.3, ddpm_steps=5, algorithm_type="sde-dpmsolver++",
        force_diffusion=True, max_length_times=64.0)


def kernel_counters():
    """name -> the wrapper whose `launches` counts that kernel's launches."""
    from vibevoice_tpu_torch.ops import decode_attention as da, flash_attention as fa
    from vibevoice_tpu_torch.ops import fused_blocks as fb, fused_head as fh
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    from vibevoice_tpu_torch.ops import fused_stage as fs, int4_matmul as im
    return {"decode_attention": da.decode_attention, "int4_matmul": im.int4_matmul,
            "fused_block_chain_batched": fb.fused_block_chain_batched,
            "fused_head_solver_step": fh.fused_head_solver_step,
            "fused_head_bf16": fhb.fused_head_bf16_step,
            "fused_stage_chain": fs.fused_stage_chain,
            "fused_stage_chain_rowlane": fs.fused_stage_chain_rowlane,
            "flash_attention_prefill": fa.flash_attention_prefill,
            "fused_block_chain": fb.fused_block_chain_plain}


def codec_launches(eng):
    """Launches per diffusing step of the streaming codecs' four kernels,
    walking each stage of the vocoder and the re-encode as the tokenizer
    does with the packs in the engine's params: a large-T pack with a
    folded conv runs the stage kernel; else a small-T chain pack runs its
    chain (int4 packs `fused_block_chain_batched`, plain ones
    `fused_block_chain`); else a large-T pack runs the stage kernel, in its
    row-lane form where `uses_rowlane` says so."""
    out = dict.fromkeys(("fused_stage_chain", "fused_stage_chain_rowlane",
                         "fused_block_chain_batched", "fused_block_chain"), 0)
    for key in ("_vocoder_packs", "_semantic_packs"):
        chain, large = eng.params.get(key) or {}, eng.params.get(key + "_large") or {}
        for i in set(chain) | set(large):
            lp = large.get(i)
            if i in chain and not (lp is not None and "conv" in lp):
                out["fused_block_chain_batched" if "w1q" in chain[i] else "fused_block_chain"] += 1
            elif uses_rowlane(lp, eng.batch):
                out["fused_stage_chain_rowlane"] += 1
            else:
                out["fused_stage_chain"] += 1
    return out


def stage_launches(eng):
    """Launches of the two stage kernels per diffusing step (`codec_launches`)."""
    c = codec_launches(eng)
    return {k: c[k] for k in ("fused_stage_chain", "fused_stage_chain_rowlane")}


def expected_launches(cfg, quant, eng, head=None):
    """(prefill, per decode step) launches of each kernel of `eng` with
    force_diffusion: decode attention once per layer per decode step where
    the engine takes it (a cache of 4096+ slots); flash
    prefill once per layer in the prompt's forward where the engine takes it
    (prompts of 1024 tokens or more), never in a step; the int4 GEMVs (qkv,
    o, gateup, down; only gateup and down under int4f) once per layer in the
    negative stream's M=B prefill forward and in every step (the 256-row
    prompt forward takes the dequantized route); the chains and the stage
    kernels as `codec_launches` counts them (at 1.5B: a chain on 2 stages of
    the vocoder and 2 of the re-encode) and the head once per solver step, on
    every diffusing step, step 0 (in prefill) included: 5 solver steps with
    `quant` unless `head` gives the count (0 without the head pack); the
    bf16 head kernel once per solver step where the engine took its route."""
    n_layers = cfg.decoder.num_hidden_layers
    gemv = {None: 0, "int8": 0, "int4": 4, "int4f": 2}[quant] * n_layers
    if head is None:
        head = 5 if quant else 0
    bf16_head = eng.sched.num_steps if bf16_head_route(eng) else 0
    per_step = dict(codec_launches(eng), fused_head_solver_step=head,
                    fused_head_bf16=bf16_head)
    prefill = dict(per_step, decode_attention=0, int4_matmul=gemv,
                   flash_attention_prefill=n_layers if eng.use_flash_prefill else 0)
    step = dict(per_step, decode_attention=n_layers if eng.use_flash_decode else 0,
                int4_matmul=gemv, flash_attention_prefill=0)
    return prefill, step


# each engine run: an eager request, two requests on the graph engine (the
# first captures its step), an eager request again
TURNS = ("eager", "graph", "graph", "eager")


class Run(NamedTuple):
    """What `run_engine` hands on: the wrappers' launches by kernel in the
    graph engine's first turn (the prefill, the warm-up step and the
    captured step), the launches that ran on the device in that turn (the
    prefill's, then one step's per executed step), the last turn's final
    state and the graph engine."""
    launches: dict
    device_launches: dict
    state: Any
    eng: Any


def run_engine(params, cfg, dev, kv_dtype, warm_steps, timed_chunks, card, quant=None,
               batch=1, stages=False, want_stages=None, rowlane=None, prompt_len=256,
               max_steps=3840, chain=False):
    """The long-cache engine in TURNS: an eager engine (`Engine(eager=True)`:
    every step launched from the host) and a graph engine (the captured step,
    replayed; built on the eager engine's params and packs), each turn a
    request of its own: prefill, a warm-up chunk and the timed chunks.  A
    graph engine's second turn is a second request on the same graph.

    Launch checks against `expected_launches` (and, with `use_fused_stages`,
    the stage kernels' per-step counts against `want_stages`;
    `rowlane=False` hands in the stage packs without the row-lane layout,
    None leaves the engine's rule): an
    eager turn counts every kernel's launches per step; a graph turn counts
    the prefill's through the wrappers, plus the warm-up step's and the
    captured step's in the turn that captures, and nothing per replay, and
    the captured step's kernel nodes equal the per-step counts.  The small-T
    chains are on with `quant` (the pipeline's int4 packs in `params`) or
    `chain` (plain packs, built by the engine: `use_fused_chains`).  Emits one `engine` line per
    turn (a graph turn with its nodes by kernel and the device ms of one
    replay) and one `engine_turns` line."""
    from vibevoice_tpu_torch.engine import generate as G
    kw = dict(max_steps=max_steps, batch=batch, prompt_len=prompt_len, dtype=torch.bfloat16,
              kv_dtype=kv_dtype, device=dev, use_fused_chains=chain, use_fused_stages=stages)
    if rowlane is False:
        params = without_rowlane(params, cfg, batch)
    eager = G.Engine(params, cfg, bench_gen(G), eager=True, **kw)
    eng = G.Engine(eager.params, cfg, bench_gen(G), **kw)  # the eager engine's packs
    engines = {"eager": eager, "graph": eng}
    if stages and stage_launches(eng) != want_stages:
        raise RuntimeError(f"stage packs give {stage_launches(eng)} launches per step, "
                           f"want {want_stages}")
    if not (eng.use_flash_decode and eng.cache_len >= 4096):
        raise RuntimeError(f"engine is off the long-cache path: cache {eng.cache_len}")
    want_prefill, want_step = expected_launches(cfg, quant, eng)
    steps = warm_steps + sum(timed_chunks)
    ids = np.random.default_rng(SEED).integers(0, 1000, (batch, prompt_len)).astype(np.int32)
    mask = np.ones((batch, prompt_len), np.int32)
    sim = np.zeros((batch, prompt_len), bool)
    hop = cfg.speech_compress_ratio
    counters = kernel_counters()
    summary = {mode: {"ms_per_frame": [], "audio_s_per_s": []} for mode in engines}
    run = None
    for mode in TURNS:
        e = engines[mode]
        captures = mode == "graph" and e.graph is None
        replays0 = e.replays
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        state, _ = e.prefill(ids, mask, sim, generator=gen)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = {k: c.launches for k, c in counters.items()}
        state, _ = e.decode_chunk(state, warm_steps)
        f_prev = int(state.frames.sum())
        chunks = []
        for n in timed_chunks:
            t0 = time.perf_counter()
            state, _ = e.decode_chunk(state, n)
            f_now = int(state.frames.sum())  # waits for the device
            dt = time.perf_counter() - t0
            chunks.append({"steps": n, "frames": f_now - f_prev, "wall_s": dt})
            f_prev = f_now
        launches = {k: c.launches for k, c in counters.items()}

        # through the wrappers: every step eagerly; with the graph the
        # warm-up step and the captured one, in the turn that captures
        wrapped = steps if mode == "eager" else (2 if captures else 0)
        want = {k: want_prefill[k] + wrapped * want_step[k] for k in counters}
        if prefill_launches != want_prefill or launches != want:
            raise RuntimeError(f"{mode} kernel launches: prefill {prefill_launches} (want "
                               f"{want_prefill}), run {launches} (want {want}) over {steps} "
                               "decode steps")
        graph_info = {}
        if mode == "graph":
            if e.replays - replays0 != steps - captures:
                raise RuntimeError(f"{e.replays - replays0} replays for {steps} steps")
            nodes, other = graph_launches(e.graph)
            if nodes != merge_stages(want_step):
                raise RuntimeError(f"the captured step's kernel nodes {nodes} differ from "
                                   f"the step's launches {merge_stages(want_step)}")
            graph_info = dict(graph_nodes=nodes, graph_other_nodes=other,
                              capture_s=e.capture_s if captures else None)
        emitted = state.emitted[:, : state.host_step]
        audio = state.audio[:, : state.host_step]
        if not bool(emitted.all()):
            raise RuntimeError("a forced-diffusion step emitted no frame")
        if not bool(torch.isfinite(audio).all()) or float(audio.abs().max()) == 0.0:
            raise RuntimeError("engine audio is not finite or is all zero")
        if mode == "graph":
            # after the checks: each replay advances the state by a step
            graph_info["device_ms_per_replay"] = cuda_ms(lambda i: e.graph.replay(), 10)
        frames = sum(c["frames"] for c in chunks)
        wall = sum(c["wall_s"] for c in chunks)
        ms = (1e3 * wall / frames) if frames else None
        aps = (frames * hop / 24000.0 / wall) if frames else None
        summary[mode]["ms_per_frame"].append(ms)
        summary[mode]["audio_s_per_s"].append(aps)
        if mode == "graph":
            for k in ("capture_s", "graph_nodes", "device_ms_per_replay"):
                if graph_info.get(k) is not None:
                    summary[mode].setdefault(k, []).append(graph_info[k])
        emit("engine", mode=mode, kv=kv_dtype, quant=quant, batch=batch, fused_stages=stages,
             rowlane=uses_rowlane_any(eng), prompt_len=prompt_len,
             flash_prefill=eng.use_flash_prefill,
             codec_launches=codec_launches(eng), cache_slots=eng.cache_len, prefill_s=prefill_s,
             decode_steps=steps, prefill_launches=prefill_launches, kernel_launches=launches,
             launches_per_step=want_step, chunks=chunks, ms_per_frame=ms, audio_s_per_s=aps,
             audio_absmax=float(audio.abs().max()), **graph_info, card=card)
        if captures:
            # executed on the device: the prefill's, the warm-up step's and
            # one step's per replay
            run = Run(launches, {k: want_prefill[k] + steps * want_step[k] for k in counters},
                      state, e)
        elif mode == "graph":
            run = run._replace(state=state)
    emit("engine_turns", kv=kv_dtype, quant=quant, batch=batch, fused_stages=stages,
         rowlane=uses_rowlane_any(eng), prompt_len=prompt_len, turns=TURNS, **summary,
         card=card)
    del eager, engines
    return run


def graph_kernels(graph):
    """The names of the nodes of a CUDA graph captured with keep_graph=True,
    read through libcuda: a kernel node by its function's name, any other
    node by its type."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL is 0
            names.append(f"graph node of type {kind.value}")
            continue
        params = (ctypes.c_byte * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2: the function first
        name = ctypes.c_char_p()
        if (cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params)
                or cu.cuFuncGetName(ctypes.byref(name),
                                    ctypes.c_void_p(ctypes.c_void_p.from_buffer(params).value))):
            raise RuntimeError("reading a kernel node failed")
        names.append(name.value.decode())
    return names


# the kernels' entry functions (by the identifier in their mangled symbol,
# which carries its length) -> the wrapper whose counter counts their launches;
# the row-lane stage call is the stage kernel on the row-lane pack, so
# `cluster_kernel` nodes count under fused_stage_chain (see `merge_stages`)
NODE_KERNELS = (("flash_wgmma_kernel", "flash_attention_prefill"),
                ("flash_f32_kernel", "flash_attention_prefill"),
                ("mma_kernel", "decode_attention"), ("f32_kernel", "decode_attention"),
                ("int4_matmul_kernel", "int4_matmul"),
                ("chain_q_kernel", "fused_block_chain_batched"),
                ("chain_p_kernel", "fused_block_chain"),
                ("head_q_kernel", "fused_head_solver_step"),
                ("head_bf16_kernel", "fused_head_bf16"),
                ("cluster_kernel", "fused_stage_chain"))


def graph_launches(graph):
    """{counter name: kernel nodes} of a graph captured with keep_graph=True
    (`graph_kernels`), every counter of `kernel_counters` present, the two
    stage counters merged (`merge_stages`); and the count of other nodes."""
    out = merge_stages(dict.fromkeys(kernel_counters(), 0))
    other = 0
    for name in graph_kernels(graph):
        key = next((k for fn, k in NODE_KERNELS if f"{len(fn)}{fn}" in name), None)
        if key is None:
            other += 1
        else:
            out[key] += 1
    return out, other


def merge_stages(launches):
    """Launch counts by wrapper with the row-lane stage calls added to the
    stage kernel's: one kernel function serves both."""
    out = dict(launches)
    out["fused_stage_chain"] += out.pop("fused_stage_chain_rowlane")
    return out


def codec_graph(eng, state, dev, card):
    """The codec half of one decode step of `eng` at its batch (the acoustic
    decoder on one latent frame a row and the semantic encoder on its
    samples, from `state`'s streaming states: every stage and chain call of
    the step) captured in a CUDA graph: its nodes and its device time per
    replay: the codec's share of the engine's captured step."""
    from vibevoice_tpu_torch.models import tokenizer as tok
    p, cfg = eng.params, eng.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    latent = torch.randn((eng.batch, 1, cfg.acoustic_vae_dim), generator=gen,
                         device=dev).to(torch.bfloat16)

    def codec():
        chunk, _ = tok.decoder_apply_streaming(
            p["acoustic_decoder"], cfg.acoustic_tokenizer, latent, state.acoustic_state,
            fused_packs=p.get("_vocoder_packs"), large_packs=p.get("_vocoder_packs_large"))
        return tok.encoder_apply_streaming(
            p["semantic_encoder"], cfg.semantic_tokenizer, chunk, state.semantic_state,
            fused_packs=p.get("_semantic_packs"), large_packs=p.get("_semantic_packs_large"))[0]

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):  # the kernels' scratch of the capture stream
        want = codec()
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        got = codec()
    names = graph_kernels(graph)
    graph.instantiate()
    ms = cuda_ms(lambda i: graph.replay(), 20)
    agree("codec graph replay", got, want)
    kinds = {}
    for nm in names:
        key = next((k for k in ("cluster_kernel", "chain_p_kernel", "chain_q_kernel")
                    if k in nm), "other")
        kinds[key] = kinds.get(key, 0) + 1
    emit("codec_graph", batch=eng.batch, rowlane=uses_rowlane_any(eng), nodes=len(names),
         nodes_by_kind=kinds, device_ms=ms, card=card)


def without_rowlane(params, cfg, batch):
    """`params` with the large-T stage packs that the engine's batch rule
    builds at `batch` but without the row-lane layout: how an engine runs
    with the row-lane layout off."""
    from vibevoice_tpu_torch.models import tokenizer as tok
    return dict(params, _vocoder_packs_large=tok.pack_decoder_stages_large(
        params["acoustic_decoder"], cfg.acoustic_tokenizer, fold_conv=batch == 1,
        fold_head=False), _semantic_packs_large=tok.pack_encoder_stages_large(
        params["semantic_encoder"], cfg.semantic_tokenizer, chunk_t=cfg.speech_compress_ratio,
        fold_conv=batch == 1))


def uses_rowlane_any(eng) -> bool:
    return any(uses_rowlane(pk, eng.batch) for key in ("_vocoder_packs_large",
                                                        "_semantic_packs_large")
               for pk in (eng.params.get(key) or {}).values())


def attention_operands(state, batch, dev):
    """The decode step's own visibility and lengths, for the kernels line."""
    wp = int(state.write_pos)
    lengths = torch.full((2 * batch,), wp + 1, dtype=torch.int32, device=dev)
    vis = state.visible.clone()
    vis[:, wp] = 1
    return vis, lengths


def stage_frames(cfg):
    """{(pack key, stage index): frames per call} of the sigma-VAE stages at
    streaming decode (one 7.5 Hz frame per call)."""
    ac, se = cfg.acoustic_tokenizer, cfg.semantic_tokenizer
    out, t = {}, 1
    for i in range(len(ac.decoder_depths_resolved())):
        t *= ac.decoder_ratios[i - 1] if i else 1
        out[("_vocoder_packs", i)] = t
    t = cfg.speech_compress_ratio
    for i, stride in enumerate([1] + list(reversed(se.encoder_ratios))):
        t //= stride
        out[("_semantic_packs", i)] = t
    return out


def quant_entries(params, cfg, launches, dev):
    """The kernels-line entries of the three int4 kernels, measured on the
    quantized engine's own weights and packs at its B=1 shapes: per launch,
    averaged over the launches of one decode step (the 28 layers' qkv / o /
    gateup / down GEMVs at M=2; the vocoder's and the re-encode's two packed
    stages; one solver step of the head at N=2).  Each timing loop rotates
    over copies of the weights (the layers', then clones) that exceed L2."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    layers = params["lm"]["layers"]
    per_shape = []
    for name in ("qkv", "o", "gateup", "down"):
        ws = [lp[name]["w"] if name in ("qkv", "o") else lp[name] for lp in layers]
        size = ws[0]["qint4"].numel()
        ws = ws + [{k: v.clone() for k, v in ws[i % len(ws)].items()}
                   for i in range(max(0, copies_for(size) - len(ws)))]
        x = torch.randn((2, 2 * ws[0]["qint4"].shape[0]), generator=gen,
                        device=dev).to(torch.bfloat16)
        per_shape.append(measure_int4(x, ws))
    stages = chain_results(params, cfg, gen, dev)
    head = params["_diffusion_head_packq"]
    heads = [head] + [{k: v.clone() for k, v in head.items()}
                      for _ in range(copies_for(fh.pack_bytes(head)) - 1)]
    fl = params["diffusion_head"]["final_linear"]
    x, mods, fmod, _ = head_inputs(head, 2, fl.shape[1], gen, dev)
    head_r = measure_head(heads, x, mods, fmod, fl.contiguous())
    del heads

    src = "vibevoice_tpu_torch/csrc/"
    return [
        {"name": "int4_matmul", "route": "cuda", "source": src + "int4_matmul.cu",
         "replaces": "vibevoice_tpu/ops/int4_matmul.py:101",
         "launches": launches["int4_matmul"], **mean_entry(per_shape),
         "per": "launch, mean over the decode step's qkv/o/gateup/down GEMVs at M=2"},
        {"name": "fused_block_chain_batched", "route": "cuda",
         "source": src + "fused_block_chain.cu",
         "replaces": "vibevoice_tpu/ops/fused_blocks.py:290",
         "launches": launches["fused_block_chain_batched"], **mean_entry(stages),
         "per": "launch, mean over the step's four packed stages at B=1"},
        {"name": "fused_head_solver_step", "route": "cuda", "source": src + "fused_head.cu",
         "replaces": "vibevoice_tpu/ops/fused_head.py:130",
         "launches": launches["fused_head_solver_step"], **head_r,
         "per": "launch: one solver step at N=2"},
    ]


def chain_results(params, cfg, gen, dev):
    """`measure_chain` on each packed small-T stage of `params` (the
    vocoder's two, then the re-encode's two) at B=1 and its frames per call,
    each timing loop rotating over clones of the pack that exceed L2."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    out = []
    frames = stage_frames(cfg)
    for key in ("_vocoder_packs", "_semantic_packs"):
        for i, pack in sorted(params[key].items()):
            x, ctx = chain_inputs(pack, 1, frames[(key, i)], gen, dev)
            clones = [pack] + [{k: v.clone() for k, v in pack.items()}
                               for _ in range(copies_for(fb.pack_bytes(pack)) - 1)]
            out.append(measure_chain(clones, x, ctx))
            del clones
    return out


def mean_entry(rs):
    """Per-launch means of several kernel_vs_plain results; the error and
    tolerance are those of the result closest to its tolerance."""
    out = {k: sum(r[k] for r in rs) / len(rs) for k in ("ms", "plain_ms", "bound_ms")}
    worst = max(rs, key=lambda r: r["max_abs_err"] / r["tol"] if r["tol"] else 0.0)
    out["max_abs_err"], out["tol"] = worst["max_abs_err"], worst["tol"]
    out["bound_by"] = rs[0]["bound_by"]
    lib = [r["library_ms"] for r in rs]
    out["library_ms"] = None if None in lib else sum(lib) / len(lib)
    return out


def stage_entries(runs, cfg, dev):
    """The kernels-line entries of the two stage kernels, measured on the
    packs the engines of the main path built, at their shapes: per launch,
    averaged over one decode step's calls.  `runs` maps each kernel to
    (engine, launches in its run)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ac, se = cfg.acoustic_tokenizer, cfg.semantic_tokenizer
    src = "vibevoice_tpu_torch/csrc/fused_stage.cu"
    replaces = {"fused_stage_chain": "vibevoice_tpu/ops/fused_stage.py:516",
                "fused_stage_chain_rowlane": "vibevoice_tpu/ops/fused_stage.py:404"}
    entries = []
    for name, (eng, launches) in runs.items():
        rs = []
        t = 1
        for i in range(len(ac.decoder_depths_resolved())):
            t *= ac.decoder_ratios[i - 1] if i else 1
            pack = eng.params["_vocoder_packs_large"].get(i)
            if pack is not None and uses_rowlane(pack, eng.batch) == (name != "fused_stage_chain"):
                rs.append(measure_stage(pack, eng.batch, t, gen, dev))
        t = cfg.speech_compress_ratio
        for i, stride in enumerate([1] + list(reversed(se.encoder_ratios))):
            t //= stride
            pack = eng.params["_semantic_packs_large"].get(i)
            if pack is not None and uses_rowlane(pack, eng.batch) == (name != "fused_stage_chain"):
                rs.append(measure_stage(pack, eng.batch, t, gen, dev))
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces[name],
                        "launches": launches, **mean_entry(rs),
                        "per": f"launch, mean over the step's {len(rs)} calls at B={eng.batch}"})
    return entries


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


class PromptHidden:
    """Keeps the last position's final hidden state of every prompt forward
    (T > 1) the engine runs, which `Engine.prefill` does not return: wraps
    `qwen2.forward` while the context is open."""

    def __enter__(self):
        from vibevoice_tpu_torch.models import qwen2
        self.module, self.forward, self.rows = qwen2, qwen2.forward, []

        def spy(*args, **kw):
            hidden, cache = self.forward(*args, **kw)
            if hidden.shape[1] > 1:
                self.rows.append(hidden[:, -1].float().clone())
            return hidden, cache

        qwen2.forward = spy
        return self

    def __exit__(self, *exc):
        self.module.forward = self.forward


PROMPT_LONG, PROMPT_16K = 4096, 16384
# flash and dense prefills of one bf16 prompt: the last hidden state after 28
# layers, each of whose attention outputs may differ by a bf16 step (2^-8)
# where the two paths round P at different points and sum in another order
# (relative L2 error)
HIDDEN_REL_TOL = 0.05


def prompt_inputs(batch, prompt_len):
    ids = np.random.default_rng(SEED).integers(0, 1000, (batch, prompt_len)).astype(np.int32)
    return ids, np.ones((batch, prompt_len), np.int32), np.zeros((batch, prompt_len), bool)


def timed_prefill(eng, dev):
    """One prefill: its seconds, `torch.cuda.max_memory_allocated()` over it
    (`max_bytes`) and that peak above what was allocated before it (`peak`),
    the prompt's last hidden state and the launches by kernel."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    ids, mask, sim = prompt_inputs(eng.batch, eng.prompt_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with PromptHidden() as hid:
        t0 = time.perf_counter()
        state, _ = eng.prefill(ids, mask, sim, generator=gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    max_bytes = torch.cuda.max_memory_allocated()
    del state
    if len(hid.rows) != 1 or not bool(torch.isfinite(hid.rows[0]).all()):
        raise RuntimeError("prefill ran no single finite prompt forward")
    return dict(s=secs, max_bytes=max_bytes, peak=max_bytes - base, hidden=hid.rows[0],
                launches={k: c.launches for k, c in counters.items()})


def fp32_prompt_hidden(params, cfg, dev):
    """The 4096-token prompt's last hidden state from an fp32 copy of the LM
    (flash prefill in fp32, no cache): the yardstick both bf16 prefills are
    held against."""
    from vibevoice_tpu_torch.models import qwen2
    ids, mask, _ = prompt_inputs(1, PROMPT_LONG)
    as32 = lambda t: t.float() if torch.is_tensor(t) and t.is_floating_point() else t
    lm = {"embed": as32(params["lm"]["embed"]), "final_norm_w": as32(params["lm"]["final_norm_w"]),
          "layers": [{k: ({kk: as32(vv) for kk, vv in v.items()} if isinstance(v, dict)
                          else as32(v)) for k, v in lp.items()}
                     for lp in params["lm"]["layers"]]}
    ids, mask = torch.as_tensor(ids, device=dev).long(), torch.as_tensor(mask, device=dev)
    with torch.no_grad():
        hidden, _ = qwen2.forward(lm, cfg.decoder, qwen2.embed_rows(lm, ids),
                                  qwen2.positions_from_mask(mask), None, pad_mask=mask,
                                  use_flash=True)
    return hidden[:, -1].float()


def phase_long_prompt(params, cfg, dev, card):
    """The long-prompt path at 1.5B, bf16, B=1: a 4096-token prompt (flash
    prefill by the engine's auto rule) with the small-T chains on plain
    packs, prefill and 8 + 16 decode steps, every kernel's launches asserted
    (28 flash launches in the prefill, none per step; 4 plain-chain launches
    per step and 4 in the prefill).  Then the same prompt's prefill through
    the dense path beside the flash one, in turns (dense, flash, flash,
    dense): times, peak memory and the last hidden state; and a 16 384-token
    flash prefill with its peak memory.  Returns the main run (`Run`)."""
    from vibevoice_tpu_torch.engine import generate as G
    n_layers = cfg.decoder.num_hidden_layers
    run = run_engine(params, cfg, dev, "model", 8, (16,), card, prompt_len=PROMPT_LONG,
                     max_steps=64, chain=True)
    launches, eng = run.launches, run.eng
    if not (eng.use_flash_prefill and launches["flash_attention_prefill"] == n_layers
            and codec_launches(eng)["fused_block_chain"] == 4):
        raise RuntimeError(f"the long-prompt engine is off its path: {launches}")
    packed = dict(params, _vocoder_packs=eng.params["_vocoder_packs"],
                  _semantic_packs=eng.params["_semantic_packs"])
    engines = {flash: G.Engine(packed, cfg, bench_gen(G), max_steps=64, batch=1,
                               prompt_len=PROMPT_LONG, dtype=torch.bfloat16, device=dev,
                               use_flash_prefill=flash) for flash in (True, False)}
    runs = {True: [], False: []}
    for flash in (False, True, True, False):
        runs[flash].append(timed_prefill(engines[flash], dev))
    for flash, rs in runs.items():
        got = [r["launches"]["flash_attention_prefill"] for r in rs]
        if got != [n_layers if flash else 0] * 2:
            raise RuntimeError(f"flash={flash} prefills launched flash prefill {got} times")
    h_flash, h_dense = runs[True][0]["hidden"], runs[False][0]["hidden"]
    rel = float((h_flash - h_dense).norm() / h_dense.norm())
    h32 = fp32_prompt_hidden(params, cfg, dev)
    rel32 = {name: float((h - h32).norm() / h32.norm())
             for name, h in (("flash", h_flash), ("dense", h_dense))}
    emit("prefill_flash_vs_dense", prompt=PROMPT_LONG, batch=1, dtype="bf16",
         flash_s=[r["s"] for r in runs[True]], dense_s=[r["s"] for r in runs[False]],
         flash_peak_bytes=[r["peak"] for r in runs[True]],
         dense_peak_bytes=[r["peak"] for r in runs[False]],
         flash_max_memory_allocated=[r["max_bytes"] for r in runs[True]],
         dense_max_memory_allocated=[r["max_bytes"] for r in runs[False]],
         hidden_rel_err=rel, hidden_max_abs_err=float((h_flash - h_dense).abs().max()),
         hidden_absmax=float(h_dense.abs().max()), tol=HIDDEN_REL_TOL,
         hidden_rel_err_vs_fp32=rel32,
         flash_repeat_equal=bool(torch.equal(h_flash, runs[True][1]["hidden"])), card=card)
    if not rel <= HIDDEN_REL_TOL:
        raise RuntimeError(f"flash and dense prefills disagree: {rel} > {HIDDEN_REL_TOL}")
    # the flash path is no further from fp32 than twice the dense path's own
    # bf16 error
    if not rel32["flash"] <= max(2 * rel32["dense"], 0.01):
        raise RuntimeError(f"flash prefill is off the fp32 prefill: {rel32}")
    del engines, packed
    torch.cuda.empty_cache()
    e16 = G.Engine(params, cfg, bench_gen(G), max_steps=64, batch=1, prompt_len=PROMPT_16K,
                   dtype=torch.bfloat16, device=dev)
    r16 = timed_prefill(e16, dev)
    if not e16.use_flash_prefill or r16["launches"]["flash_attention_prefill"] != n_layers:
        raise RuntimeError(f"the 16K prefill is off the flash path: {r16['launches']}")
    emit("prefill_16k", prompt=PROMPT_16K, batch=1, dtype="bf16", cache_slots=e16.cache_len,
         prefill_s=r16["s"], max_memory_allocated=r16["max_bytes"], peak_bytes=r16["peak"],
         peak_vs_4096_flash=r16["peak"] / runs[True][0]["peak"], launches=r16["launches"],
         card=card)
    del e16
    torch.cuda.empty_cache()
    return run


def long_prompt_entries(eng, launches, cfg, dev):
    """The kernels-line entries of flash prefill (one layer's prompt attention
    at the engine's shape, B=1, T=4096, H=12, KVH=2, D=128, random bf16 q/k/v)
    and of the plain chain (measured on the engine's own four packs at B=1,
    per launch, averaged over the step's four stages)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    dec = cfg.decoder
    flash = measure_flash(*flash_inputs(1, eng.prompt_len, 0, gen, dev, dec.num_attention_heads,
                                        dec.num_key_value_heads, dec.head_dim))
    src = "vibevoice_tpu_torch/csrc/"
    return [
        {"name": "flash_attention_prefill", "route": "cuda", "source": src + "flash_prefill.cu",
         "replaces": "vibevoice_tpu/ops/flash_attention.py:84",
         "launches": launches["flash_attention_prefill"], **flash,
         "per": f"launch: one layer's prompt attention, B=1, T={eng.prompt_len}"},
        {"name": "fused_block_chain", "route": "cuda", "source": src + "fused_block_chain.cu",
         "replaces": "vibevoice_tpu/ops/fused_blocks.py:367",
         "launches": launches["fused_block_chain"],
         **mean_entry(chain_results(eng.params, cfg, gen, dev)),
         "per": "launch, mean over the step's four plain-pack stages at B=1"},
    ]


# ---------------------------------------------------------------------------
# phase 6: the pipeline
# ---------------------------------------------------------------------------

def register_forced_engine(tts, G, script, voices, max_new_tokens, **engine_kw):
    """A force_diffusion engine under the key `generate` will ask for (random
    weights almost never pick the diffusion token by themselves), with the
    int4 chain on when the pipeline holds its packs, and the large-T stage
    kernels with the pipeline's `use_fused_stages`.  `script` is one script
    (`voices` its voices) or a batch of them (`voices` one list per script);
    `engine_kw` goes to the engine."""
    b, t0 = tts.processor(script, voices).input_ids.shape
    bucket = max(tts.prompt_bucket, -(-t0 // tts.prompt_bucket) * tts.prompt_bucket)
    key = (b, bucket, max_new_tokens)
    if key not in tts._engines:
        gen = G.GenerationConfig(
            speech_start_id=tts.tokenizer.speech_start_id,
            speech_end_id=tts.tokenizer.speech_end_id,
            speech_diffusion_id=tts.tokenizer.speech_diffusion_id,
            eos_id=tts.tokenizer.eos_id, cfg_scale=tts.cfg_scale, ddpm_steps=tts.ddpm_steps,
            algorithm_type=tts.algorithm_type, force_diffusion=True, max_length_times=64.0)
        tts._engines[key] = G.Engine(tts.params, tts.cfg, gen, max_steps=max_new_tokens,
                                     batch=b, prompt_len=bucket, dtype=tts.dtype,
                                     device=tts.device,
                                     use_fused_stages=tts.use_fused_stages, **engine_kw)
    return tts._engines[key]


def phase_pipeline(dev, card, quant=None):
    """Three requests through `VibeVoiceTTS.generate` with a streamer; with
    `quant` in the quantized serving configuration (QUANT_MODES, or int4f),
    and then the first again with `use_fused_stages=True`."""
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.engine.streamer import AudioStreamer
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    modes = dict(QUANT_MODES, quantize=quant) if quant else {}
    t0 = time.perf_counter()
    tts = VibeVoiceTTS.from_random(vibevoice_1_5b(), seed=SEED + 2, dtype=torch.bfloat16,
                                   ddpm_steps=5, cfg_scale=1.3,
                                   algorithm_type="sde-dpmsolver++", device=dev, **modes)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    voices = [rng.normal(0, 0.05, 48000).astype(np.float32),
              rng.normal(0, 0.05, 36000).astype(np.float32)]
    scripts = [("Speaker 1: Good morning, and welcome to the show.", voices[:1]),
               ("Speaker 1: Did you hear the news?\nSpeaker 2: I did, it is remarkable.\n"
                "Speaker 1: Tell me more.", voices),
               ("Speaker 1: " + "This is a longer passage read aloud. " * 6, voices[1:])]
    max_new, stop_after, hop = 3840, 24, tts.cfg.speech_compress_ratio
    counters = kernel_counters()
    requests = [(script, vs, False) for script, vs in scripts]
    if quant:
        requests.append((*scripts[0], True))
    for i, (script, vs, stages) in enumerate(requests):
        if stages:
            tts.use_fused_stages = True
            tts._engines.clear()
        eng = register_forced_engine(tts, G, script, vs, max_new)
        want_prefill, want_step = expected_launches(tts.cfg, quant, eng)
        if stages and want_step["fused_stage_chain"] != 8:
            raise RuntimeError(f"pipeline engine has {want_step} stage launches per step")
        if not (eng.use_flash_decode and eng.cache_len >= 4096):
            raise RuntimeError(f"pipeline engine is off the long-cache path: {eng.cache_len}")
        streamer = AudioStreamer(batch_size=1)
        seen = []
        captures = eng.graph is None
        for c in counters.values():
            c.launches = 0
        res, metrics = tts.generate(script, vs, max_new_tokens=max_new, seed=i,
                                    audio_streamer=streamer,
                                    stop_check_fn=lambda: len(seen) >= stop_after,
                                    on_step=seen.append)
        launches = {k: c.launches for k, c in counters.items()}
        chunks = list(streamer.get_stream(0))
        audio = res.audio[0]
        if audio is None or not np.isfinite(audio).all() or np.abs(audio).max() == 0:
            raise RuntimeError(f"request {i}: audio missing, non-finite or all zero")
        if len(chunks) != res.steps or not np.array_equal(np.concatenate(chunks), audio):
            raise RuntimeError(f"request {i}: streamed chunks differ from the buffered audio")
        if len(audio) != res.steps * hop or res.steps < stop_after:
            raise RuntimeError(f"request {i}: {res.steps} steps, {len(audio)} samples")
        # through the wrappers: the prefill, and the warm-up and captured
        # steps where this request captured the engine's step; the graph
        # holds one step's launches and the replays count nowhere
        want = {k: want_prefill[k] + (2 if captures else 0) * want_step[k] for k in counters}
        nodes, _ = graph_launches(eng.graph)
        if launches != want or nodes != merge_stages(want_step):
            raise RuntimeError(f"request {i}: launches {launches}, want {want}; graph nodes "
                               f"{nodes}, want {merge_stages(want_step)}")
        emit("pipeline", quant=quant, fused_stages=stages, request=i, speakers=len(vs),
             prompt_bucket=eng.prompt_len, captured=captures, capture_s=eng.capture_s,
             graph_nodes=nodes,
             cache_slots=eng.cache_len, steps=res.steps, kernel_launches=launches,
             setup_s=setup_s if i == 0 else None, wall_s=metrics["wall_s"],
             audio_sec=metrics["audio_sec"], rtf=metrics["rtf"], card=card)
    del tts
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: a small model on the card against the same model on the CPU
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
    rnd = lambda w: (torch.randn(w.shape, generator=gen, device=gen.device) * 0.05).to(w)
    for lp in head["layers"]:
        lp["ada_w"] = rnd(lp["ada_w"])
    for k in ("final_ada_w", "final_linear"):
        head[k] = rnd(head[k])
    dev = head["final_linear"].device
    params["speech_scaling_factor"] = torch.tensor(0.8, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.1, device=dev)


def phase_reference(dev, quant=False, stages=False, b=2, flash_chain=False):
    """fp32 on both sides.  With `quant` the model is first put through
    `VibeVoiceTTS(quantize="int4", int4_group_size=32, quantize_tokenizer=
    "int4k", quantize_diffusion="int4k", tokenizer_min_dim=4)` on the CPU, so
    the card runs every int4 kernel (the tiny stacks' unpacked stages take int8
    FFNs) and the CPU their plain versions.  With `stages` the engines run
    `use_fused_stages=True, fused_stage_t_min=7` (the tiny stacks' T >= 7
    stages: folded convs at b=1, the row-lane layout, by default, at b=2).
    With `flash_chain` the model has head_dim 128 (hidden 512, 4 heads) and
    the engines run flash prefill, forced on, and the small-T chains on plain
    fp32 packs."""
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    # head_dim 64 (hidden 256), or 128 (hidden 512), as the kernels take it
    cfg = tiny_config(hidden_size=512 if flash_chain else 256, vocab_size=320)
    gen = torch.Generator().manual_seed(SEED)
    params = V.init_model(cfg, generator=gen, device="cpu")
    _live_audio_path(params, gen)
    if quant:
        params = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.float32,
                              device="cpu", int4_group_size=32, tokenizer_min_dim=4,
                              **QUANT_MODES).params
    rng = np.random.default_rng(SEED)
    # a 72-token prompt: the quantized prefill (144 rows) takes the dequantized route
    t, steps = (72 if quant else 40), 24
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    ids[:, -1] = 258
    mask = np.ones((b, t), np.int32)
    mask[b - 1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(steps, b, cfg.acoustic_vae_dim)).astype(np.float32)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                             eos_id=256, cfg_scale=1.3, ddpm_steps=3, force_diffusion=True,
                             max_length_times=64.0)
    counters = kernel_counters()
    out = {}
    for where in ("cpu", dev):
        eng = G.Engine(params, cfg, gcfg, max_steps=steps, batch=b, prompt_len=t,
                       inject_latent_noise=True, use_flash_decode=True, device=where,
                       use_fused_chains=flash_chain,
                       use_fused_stages=stages, fused_stage_t_min=7,
                       use_flash_prefill=flash_chain)
        for c in counters.values():
            c.launches = 0
        out[str(where)] = (G.generate(eng, ids, mask, sim, latent_noise=noise),
                           {k: c.launches for k, c in counters.items()})
    (ref, cpu_launches), (got, gpu_launches) = out["cpu"], out[str(dev)]
    n_layers = cfg.decoder.num_hidden_layers
    # every step diffuses: 3 + 3 packed stages, 3 solver steps and the
    # stage kernels once per large-T pack each; flash prefill once per layer.
    # The card decodes through the captured step: the prefill's step 0, the
    # warm-up step and the captured one go through the wrappers, and the
    # graph holds one step
    step = {"decode_attention": n_layers,
            "int4_matmul": 4 * n_layers if quant else 0,
            "fused_block_chain_batched": 6 if quant else 0,
            "fused_head_solver_step": 3 if quant else 0,
            "fused_head_bf16": 3 if bf16_head_route(eng) else 0,
            "flash_attention_prefill": 0,
            "fused_block_chain": 6 if flash_chain else 0,
            **stage_launches(eng)}
    pre = dict(step, decode_attention=0, flash_attention_prefill=n_layers if flash_chain else 0)
    want = {k: pre[k] + 2 * n for k, n in step.items()}
    if stages and sum(stage_launches(eng).values()) != 4:
        raise RuntimeError(f"tiny engine stage packs: {stage_launches(eng)}")
    nodes, _ = graph_launches(eng.graph)
    if any(cpu_launches.values()) or gpu_launches != want or nodes != merge_stages(step):
        raise RuntimeError(f"launches: cpu {cpu_launches}, gpu {gpu_launches}, want {want}; "
                           f"graph nodes {nodes}, want {merge_stages(step)}")
    if not np.array_equal(got.tokens, ref.tokens):
        raise RuntimeError(f"tokens differ: {got.tokens} vs {ref.tokens}")
    a, w = np.concatenate(got.audio), np.concatenate(ref.audio)
    if not (np.isfinite(a).all() and np.isfinite(w).all()):
        raise RuntimeError("tiny-model audio is not finite")
    err, scale = float(np.abs(a - w).max()), float(np.abs(w).max())
    tol = 1e-3 * scale  # fp32 on both; sums in another order on the card
    emit("reference", model=f"tiny_config(hidden_size={cfg.decoder.hidden_size})", batch=b,
         fused_stages=stages, flash_prefill_and_plain_chain=flash_chain,
         modes=dict(QUANT_MODES, int4_group_size=32) if quant else None, steps=steps,
         kernel_launches=gpu_launches, audio_max_abs_err=err, audio_absmax=scale, tol=tol)
    if not (scale > 0 and err <= tol):
        raise RuntimeError(f"card and CPU disagree: {err} > {tol}")


# ---------------------------------------------------------------------------
# phase 8: the serving deployment
# ---------------------------------------------------------------------------

# torch dtype -> safetensors dtype, for the smoke's own checkpoint writer
ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def flat_from_params(p):
    """The smoke's own inverse of `utils.checkpoint.params_from_flat`: a
    params tree -> {reference name: tensor} in the reference's layouts
    (linear [out, in], conv [Cout, Cin, K], transposed conv [Cin, Cout, K])."""
    out = {}

    def wb(name, node, kind):
        w = node["w"]
        out[f"{name}.weight"] = {"lin": lambda: w.t(), "conv": lambda: w.permute(2, 1, 0),
                                 "convt": lambda: w.permute(0, 2, 1)}[kind]().contiguous()
        if node.get("b") is not None:
            out[f"{name}.bias"] = node["b"]

    def stack(prefix, st):
        if "up" in st:
            for i, c in enumerate(st["up"]):
                wb(f"{prefix}.upsample_layers.{i}.0." + ("conv.conv" if i == 0 else
                                                          "convtr.convtr"), c,
                   "conv" if i == 0 else "convt")
        else:
            for i, c in enumerate(st["down"]):
                wb(f"{prefix}.downsample_layers.{i}.0.conv.conv", c, "conv")
        for i, blocks in enumerate(st["stages"]):
            for j, bp in enumerate(blocks):
                base = f"{prefix}.stages.{i}.{j}"
                out[f"{base}.norm.weight"] = bp["norm_w"]
                wb(f"{base}.mixer.conv.conv.conv", bp["mixer"], "conv")
                out[f"{base}.gamma"] = bp["gamma"]
                out[f"{base}.ffn_norm.weight"] = bp["ffn_norm_w"]
                wb(f"{base}.ffn.linear1", bp["ffn1"], "lin")
                wb(f"{base}.ffn.linear2", bp["ffn2"], "lin")
                out[f"{base}.ffn_gamma"] = bp["ffn_gamma"]
        if st["final_norm_w"] is not None:
            out[f"{prefix}.norm.weight"] = st["final_norm_w"]
        wb(f"{prefix}.head.conv.conv", st["head"], "conv")

    lm = "model.language_model"
    out[f"{lm}.embed_tokens.weight"] = p["lm"]["embed"]
    out[f"{lm}.norm.weight"] = p["lm"]["final_norm_w"]
    for i, lp in enumerate(p["lm"]["layers"]):
        b = f"{lm}.layers.{i}"
        out[f"{b}.input_layernorm.weight"] = lp["input_norm_w"]
        out[f"{b}.post_attention_layernorm.weight"] = lp["post_norm_w"]
        for n in "qkvo":
            wb(f"{b}.self_attn.{n}_proj", lp[n], "lin")
        for n in ("gate", "up", "down"):
            out[f"{b}.mlp.{n}_proj.weight"] = lp[n].t().contiguous()
    stack("model.acoustic_tokenizer.encoder", p["acoustic_encoder"])
    stack("model.acoustic_tokenizer.decoder", p["acoustic_decoder"])
    stack("model.semantic_tokenizer.encoder", p["semantic_encoder"])
    for name in ("acoustic_connector", "semantic_connector"):
        wb(f"model.{name}.fc1", p[name]["fc1"], "lin")
        wb(f"model.{name}.fc2", p[name]["fc2"], "lin")
        out[f"model.{name}.norm.weight"] = p[name]["norm_w"]
    h, hp = "model.prediction_head", p["diffusion_head"]
    for ref, ours in (("noisy_images_proj", "noisy_proj"), ("cond_proj", "cond_proj"),
                      ("t_embedder.mlp.0", "t_mlp1"), ("t_embedder.mlp.2", "t_mlp2"),
                      ("final_layer.adaLN_modulation.1", "final_ada_w"),
                      ("final_layer.linear", "final_linear")):
        out[f"{h}.{ref}.weight"] = hp[ours].t().contiguous()
    for i, lp in enumerate(hp["layers"]):
        out[f"{h}.layers.{i}.adaLN_modulation.1.weight"] = lp["ada_w"].t().contiguous()
        out[f"{h}.layers.{i}.norm.weight"] = lp["norm_w"]
        for n in ("gate", "up", "down"):
            out[f"{h}.layers.{i}.ffn.{n}_proj.weight"] = lp[n].t().contiguous()
    out["model.speech_scaling_factor"] = p["speech_scaling_factor"]
    out["model.speech_bias_factor"] = p["speech_bias_factor"]
    if p["lm_head"] is not None:
        out["lm_head.weight"] = p["lm_head"].t().contiguous()
    return out


def write_safetensors(path, tensors) -> int:
    """The smoke's own safetensors writer (the card's machine has no
    `safetensors`): an 8-byte little-endian header length, the JSON header
    (padded to 8 bytes), then each tensor's bytes in order.  Returns the
    file's size."""
    import struct
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for t in tensors.values():
            f.write(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().data)
    return 8 + len(h) + off


def hf_config(cfg) -> dict:
    """The config in the HF schema that `configs.config_from_json` reads."""
    import dataclasses
    d = dataclasses.asdict(cfg)
    return {"acoustic_tokenizer_config": d["acoustic_tokenizer"],
            "semantic_tokenizer_config": d["semantic_tokenizer"],
            "diffusion_head_config": d["diffusion_head"], "decoder_config": d["decoder"],
            "acoustic_vae_dim": d["acoustic_vae_dim"], "semantic_vae_dim": d["semantic_vae_dim"]}


def write_checkpoint(path, params, cfg) -> int:
    """`params` as an HF-format checkpoint directory: two shards split by
    bytes, `model.safetensors.index.json`, `config.json` and
    `preprocessor_config.json`.  Raises first if the disk lacks the room.
    Returns the shards' bytes."""
    import shutil
    flat = flat_from_params(params)
    need = sum(nbytes(t) for t in flat.values())
    free = shutil.disk_usage(path).free
    if free < need + (64 << 20):
        raise RuntimeError(f"the checkpoint needs {need} bytes (+64 MiB), {free} are free "
                           f"under {path}")
    names, half, acc, weight_map, total = list(flat), need / 2, 0, {}, 0
    shards = ([], [])
    for n in names:
        shards[acc >= half].append(n)
        acc += nbytes(flat[n])
    for i, part in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        total += write_safetensors(os.path.join(path, fname), {n: flat[n] for n in part})
        weight_map.update(dict.fromkeys(part, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": need}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"processor_class": "VibeVoiceProcessor", "speech_tok_compress_ratio":
                   cfg.speech_compress_ratio, "db_normalize": True,
                   "audio_processor": {"sampling_rate": 24000, "target_dB_FS": -25}}, f)
    return total


def tree_leaves(tree, path="params"):
    """[(path, leaf)] of a params tree, None leaves included."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_leaves(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def assert_bit_equal_trees(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        raise RuntimeError("the loaded tree's structure differs from the source's")
    for (path, a), (_, b) in zip(g, w):
        if (a is None) != (b is None) or (a is not None and (
                a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b))):
            raise RuntimeError(f"{path}: the loaded leaf differs from the source's")


def load_presets(root):
    """demo/voices/*.wav through the port's `load_audio`, named as the serving
    CLI names them (en-Alice_woman.wav -> en-Alice)."""
    from vibevoice_tpu_torch.processor.audio import load_audio
    d = os.path.join(root, "demo", "voices")
    return {f.split("_")[0]: load_audio(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".wav")}


class RecordingTTS:
    """The pipeline as the server's worker sees it, recording each batch
    (its scripts in queue order, voices, seed, streamed or not, and the
    worker's clock around `generate`).  The host clock only: it runs on the
    worker thread beside the pipeline's CUDA work."""

    def __init__(self, tts):
        self.tts, self.batches = tts, []

    def generate(self, scripts, voices, max_new_tokens=None, seed=0, audio_streamer=None):
        rec = {"scripts": list(scripts), "voices": voices, "seed": seed,
               "stream": audio_streamer is not None, "t_start": time.perf_counter()}
        kw = {} if audio_streamer is None else {"audio_streamer": audio_streamer}
        res, metrics = self.tts.generate(scripts, voices, max_new_tokens=max_new_tokens,
                                         seed=seed, **kw)
        rec.update(t_end=time.perf_counter(), metrics=metrics)
        self.batches.append(rec)
        return res, metrics


def http_request(port, path, body, stream=False):
    """One request from a client thread (no CUDA call): {status, body (the
    WAV, or the streamed PCM after its header), t_send, t_first (the first
    PCM bytes), t_done}."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t_send = time.perf_counter()
    conn.request("POST", path, body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = {"status": resp.status, "t_send": t_send, "stream": stream,
           "batch_size": resp.getheader("X-Batch-Size")}
    if stream and resp.status == 200:
        header = resp.read(44)
        first = resp.read(2)
        out["t_first"] = time.perf_counter()
        out["body"] = header + first + resp.read()
    else:
        out["body"] = resp.read()
        out["t_first"] = time.perf_counter()
    out["t_done"] = time.perf_counter()
    conn.close()
    return out


def get_json(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.load(r)


def send_batch(port, requests, stagger_s=0.1):
    """`requests` [(path, body)] from one client thread each, started
    `stagger_s` apart (so they queue in this order, within the server's
    max_wait_ms); returns their results in order."""
    import threading
    results = [None] * len(requests)

    def client(i, path, body):
        try:
            results[i] = http_request(port, path, body, stream=path == "/tts/stream")
        except Exception as e:  # surfaced below as a failed request
            results[i] = {"status": None, "error": repr(e)}

    threads = [threading.Thread(target=client, args=(i, *r)) for i, r in enumerate(requests)]
    for th in threads:
        th.start()
        time.sleep(stagger_s)
    for th in threads:
        th.join(timeout=900)
    return results


def wav_pcm(data: bytes, name: str, want_samples: int, stream: bool) -> np.ndarray:
    """PCM16 samples of a mono 24 kHz WAV (a streamed one: its header of
    unknown length, then the PCM); raises unless it holds exactly
    `want_samples` samples, not all zero."""
    import io
    import struct
    import wave
    if stream:
        ok = data[:4] == b"RIFF" and data[8:16] == b"WAVEfmt " and data[36:40] == b"data"
        ch, sr, _, _, bits = struct.unpack("<HIIHH", data[22:36]) if ok else (0, 0, 0, 0, 0)
        fmt, pcm = (ch, sr, bits // 8), np.frombuffer(data[44:], "<i2")
    else:
        with wave.open(io.BytesIO(data)) as w:
            fmt = (w.getnchannels(), w.getframerate(), w.getsampwidth())
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    if fmt != (1, 24000, 2) or len(pcm) != want_samples or not np.any(pcm):
        raise RuntimeError(f"{name}: WAV {fmt} with {len(pcm)} samples (want mono 24 kHz "
                           f"PCM16 of {want_samples}), all zero: {not np.any(pcm)}")
    return pcm


FOUR_SPEAKER_LINES = (
    "Welcome back to the program. Today we have four guests around the table, and "
    "each of them has spent years working on how machines learn to speak.",
    "Thank you for having me. I think the most surprising thing for listeners is how "
    "much of natural speech lives in the pauses and the breathing, not in the words.",
    "I agree, and that is exactly why long-form generation is so hard. A single "
    "sentence can sound perfect while a whole conversation drifts apart over minutes.",
    "From the engineering side, the hard part is keeping every speaker consistent "
    "while serving many requests at once on a single accelerator without stalls.",
    "So let us start there. What does consistency mean for a voice that has to last "
    "for an hour?")


def phase_serving(dev, card, root):
    """The serving deployment: a full-width 1.5B bf16 checkpoint written in
    the reference's names, loaded through `VibeVoiceTTS.from_pretrained` in
    the quantized configuration with the fused stages, and served through
    `TTSServer` to client threads: a single request, a batch of 4, a batch
    of 3 whose engine is captured on the worker thread under traffic (one
    request streamed), the same batch again through /tts, a four-speaker
    request past 1024 prompt tokens (flash prefill) and a single request
    again.  Returns the wrappers' launches while serving and the launches
    that ran on the device (the wrappers' and each replay's graph nodes)."""
    import gc
    import tempfile
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.serving.server import TTSServer, wav_bytes
    from vibevoice_tpu_torch.utils.checkpoint import load_hf_checkpoint
    bf = torch.bfloat16
    cfg = vibevoice_1_5b()
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    src = V.init_model(cfg, dtype=bf, device=dev, generator=gen)
    _live_audio_path(src, gen)  # else the random codec's audio rounds to silent PCM16
    for k in ("speech_scaling_factor", "speech_bias_factor"):
        src[k] = src[k].to(bf)
    parts = {k: sum(x.numel() for _, x in tree_leaves(v) if x is not None)
             for k, v in src.items()}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        size = write_checkpoint(d, src, cfg)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded, _ = load_hf_checkpoint(d, dtype=bf, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert_bit_equal_trees(loaded, src)
        del loaded, src
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tts = VibeVoiceTTS.from_pretrained(d, dtype=bf, device=dev, ddpm_steps=5,
                                           algorithm_type="sde-dpmsolver++",
                                           use_fused_stages=True, **QUANT_MODES)
        torch.cuda.synchronize()
        pretrained_s = time.perf_counter() - t0
    emit("checkpoint", model="vibevoice_1_5b", dtype="bf16", shards=2, bytes=size,
         params=sum(parts.values()), params_by_part=parts, write_s=write_s, load_s=load_s,
         load_gb_per_s=size / load_s / 1e9, bit_equal_to_source=True,
         from_pretrained_s=pretrained_s, modes=dict(QUANT_MODES, use_fused_stages=True),
         text_tokenizer=type(tts.tokenizer).__name__, card=card)

    presets = load_presets(root)
    steps, hop = 64, cfg.speech_compress_ratio
    names = ["en-Alice", "en-Bob", "en-Carol", "en-Dave"]
    one = "Speaker 1: Good morning, and welcome to the show about voices."
    batch4 = [f"Speaker 1: Request {i} asks for a short greeting, read aloud." for i in range(4)]
    batch3 = [f"Speaker 1: Request {i} of three, the middle one streamed." for i in range(3)]
    again = "Speaker 1: Good evening, and thanks for staying with the show."
    four = "\n".join(f"Speaker {i % 4 + 1}: {line}" for i, line in enumerate(FOUR_SPEAKER_LINES))
    body = lambda script, voice, seed, **kw: dict(script=script, voice=voice, seed=seed,
                                                   max_new_tokens=steps, **kw)
    waves = [
        ("a", [("/tts", body(one, names[0], 11))]),
        ("b", [("/tts", body(s, names[i], 21)) for i, s in enumerate(batch4)]),
        ("c", [("/tts/stream" if i == 1 else "/tts",
                body(s, names[i], 31, **({"buffer_sec": 0.5} if i == 1 else {})))
               for i, s in enumerate(batch3)]),
        ("c-again", [("/tts", body(s, names[i], 31)) for i, s in enumerate(batch3)]),
        ("d", [("/tts", body(four, names, 41))]),
        ("a-again", [("/tts", body(again, names[1], 12))]),
    ]
    voices_of = lambda v: [presets[n] for n in v] if isinstance(v, list) else [presets[v]]
    # the engines the batches ask for, forced to diffuse every step; decode
    # attention on, as a real podcast request's cache (4096+ slots) takes it
    keys = {}
    for tag, reqs in waves:
        scripts = [b["script"] for _, b in reqs]
        eng = register_forced_engine(tts, G, scripts, [voices_of(b["voice"]) for _, b in reqs],
                                     steps, use_flash_decode=True)
        keys[tag] = (eng.batch, eng.prompt_len, steps)
    b2 = register_forced_engine(tts, G, batch4[:2], [voices_of(n) for n in names[:2]], steps,
                                use_flash_decode=True)
    if keys["a"] != keys["a-again"] or keys["c"] != keys["c-again"]:
        raise RuntimeError(f"the repeated requests ask for other engines: {keys}")
    if not (keys["d"][1] >= 1024 and tts._engines[keys["d"]].use_flash_prefill):
        raise RuntimeError(f"the four-speaker request is off flash prefill: {keys['d']}")
    # warm every engine but B=3's, one by one (each captures its step on
    # this thread): B=3 stays cold, to be captured on the worker under traffic
    warm_keys = sorted({keys["a"], keys["b"], keys["d"], (2, b2.prompt_len, steps)})
    engines = []
    torch.cuda.reset_peak_memory_stats(dev)  # the peaks below: the warm-up's, the serving's
    for key in warm_keys:
        a0, r0 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        tts.warm(batch_sizes=(key[0],), prompt_buckets=[key[1]], max_new_tokens=(steps,))
        eng = tts._engines[key]
        engines.append(dict(key=key, capture_s=eng.capture_s,
                            allocated_delta=torch.cuda.memory_allocated(dev) - a0,
                            reserved_delta=torch.cuda.memory_reserved(dev) - r0))
    emit("serving_warm", engines=engines, engines_registered=sorted(tts._engines),
         memory_allocated=torch.cuda.memory_allocated(dev),
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         memory_reserved=torch.cuda.memory_reserved(dev), card=card)
    cold = tts._engines[keys["c"]]
    if cold.graph is not None or any(tts._engines[k].captures != 1 for k in warm_keys):
        raise RuntimeError("the warm-up did not capture each warmed engine once")

    counters = kernel_counters()
    replays0 = {k: e.replays for k, e in tts._engines.items()}
    rec = RecordingTTS(tts)
    srv = TTSServer(tts, port=0, max_batch=4, max_wait_ms=500, voice_presets=presets)
    srv.frontend.tts = rec
    submitted, submit = [], srv.frontend.submit_request

    def recording_submit(*a, **k):  # the frontend's requests, for their queue and wall s
        r = submit(*a, **k)
        submitted.append(r)
        return r

    srv.frontend.submit_request = recording_submit
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    srv.start()
    results = {}
    try:
        for tag, reqs in waves:
            results[tag] = send_batch(srv.port, reqs)
        metrics, healthz = (get_json(srv.port, path) for path in ("/metrics", "/healthz"))
    finally:
        srv.stop()
    launches = {k: c.launches for k, c in counters.items()}
    torch.cuda.synchronize()
    peak_serving = torch.cuda.max_memory_allocated(dev)
    bad = [(tag, r.get("status"), r.get("error") or r["body"][:200])
           for tag, rs in results.items() for r in rs if r.get("status") != 200]
    if bad or metrics["errors"] or not healthz.get("ok"):
        raise RuntimeError(f"failed requests {bad}; /metrics errors {metrics['errors']}")
    if metrics["batched_requests_max"] < 4:
        raise RuntimeError(f"no batch of 4 formed: {metrics}")
    idle = [k for k in launches
            if k not in ("fused_block_chain", "fused_head_bf16") and launches[k] == 0]
    if idle:
        raise RuntimeError(f"kernels of the serving path never launched while serving: {idle}")

    # the batches as the worker formed them, one per wave; each request's
    # frontend record (matched by script within its wave) and PCM
    if [sorted(b["scripts"]) for b in rec.batches] != \
            [sorted(b["script"] for _, b in reqs) for _, reqs in waves]:
        raise RuntimeError(f"the worker formed other batches: "
                           f"{[b['scripts'] for b in rec.batches]}")
    batches = {tag: b for (tag, _), b in zip(waves, rec.batches)}
    pb = tts.prompt_bucket
    for b in batches.values():
        t = tts.processor(b["scripts"], b["voices"]).input_ids.shape[1]
        b["bucket"] = max(pb, -(-t // pb) * pb)
    rows, pcm, at = {}, {}, 0
    for tag, reqs in waves:
        mine = submitted[at: at + len(reqs)]
        at += len(reqs)
        for (path, b), r in zip(reqs, results[tag]):
            rows[(tag, b["script"])] = next(x for x in mine if x.script == b["script"])
            pcm[(tag, b["script"])] = wav_pcm(r["body"], f"{tag} {path}", steps * hop,
                                              r["stream"])
    if not np.array_equal(pcm[("c", batch3[1])], pcm[("c-again", batch3[1])]):
        raise RuntimeError("the streamed request's PCM differs from the same request's "
                           "through /tts")

    # engines: no warmed engine captured again, B=3 captured once (under
    # traffic), each graph's kernel nodes equal to one eager step's launches
    graphs = []
    for key, eng in sorted(tts._engines.items()):
        per_step = expected_launches(cfg, "int4", eng)[1]
        want = merge_stages(per_step)
        nodes, other = graph_launches(eng.graph)
        if nodes != want:
            raise RuntimeError(f"engine {key}: graph nodes {nodes}, want {want}")
        if eng.captures != 1:
            raise RuntimeError(f"engine {key} captured its step {eng.captures} times")
        graphs.append(dict(key=key, captured_under_traffic=eng is cold, capture_s=eng.capture_s,
                           replays=eng.replays - replays0[key], launches_per_step=per_step,
                           graph_nodes=nodes,
                           graph_other_nodes=other, rowlane=uses_rowlane_any(eng),
                           flash_prefill=eng.use_flash_prefill))
    emit("serving_engines", engines=graphs, card=card)
    device_launches = dict(launches)
    for g in graphs:  # each replay runs one step's launches (its graph's nodes)
        for k, n in g["launches_per_step"].items():
            device_launches[k] += g["replays"] * n

    # the stream's first bytes went out before its batch ended
    _, sm = rows[("c", batch3[1])].future.result()
    ttfb_into_batch = metrics["ttfb_s_last"] - sm["queue_s"]
    if not ttfb_into_batch < sm["wall_s"]:
        raise RuntimeError(f"the stream's first bytes came {ttfb_into_batch} s into its batch, "
                           f"whose wall time is {sm['wall_s']} s")

    # the same batches through tts.generate on this thread, the server
    # stopped: each request's PCM equal to its HTTP response's; (a) runs after
    # (a-again) served another request on its engine
    direct = {}
    for tag, _ in waves:
        if tag.endswith("again"):
            continue
        bt = batches[tag]
        t0 = time.perf_counter()
        res, m = tts.generate(bt["scripts"], bt["voices"], max_new_tokens=steps,
                              seed=bt["seed"])
        wall = time.perf_counter() - t0
        for i, script in enumerate(bt["scripts"]):
            got = np.frombuffer(wav_bytes(res.audio[i])[44:], "<i2")
            if not np.array_equal(got, pcm[(tag, script)]):
                raise RuntimeError(f"{tag}: row {i}'s HTTP PCM differs from tts.generate's")
        direct[tag] = dict(batch=len(bt["scripts"]), wall_s=wall,
                           audio_s_per_s=m["audio_sec"] / wall)

    # one line per request, then the summary
    http = {}
    for tag, reqs in waves:
        for (path, b), r in zip(reqs, results[tag]):
            _, m = rows[(tag, b["script"])].future.result()
            emit("serving", request=tag, endpoint=path, batch_size=m["batch_size"],
                 prompt_bucket=batches[tag]["bucket"], speakers=len(voices_of(b["voice"])),
                 queue_s=m["queue_s"], wall_s=m["wall_s"], audio_s=steps * hop / 24000,
                 client_s=r["t_done"] - r["t_send"], ttfb_s=r["t_first"] - r["t_send"],
                 http_overhead_s=None if r["stream"] else
                 r["t_done"] - r["t_send"] - m["queue_s"] - m["wall_s"], card=card)
        span = max(r["t_done"] for r in results[tag]) - min(r["t_send"] for r in results[tag])
        http[tag] = dict(batch=len(reqs), audio_s_per_s=len(reqs) * steps * hop / 24000 / span,
                         worker_wall_s=batches[tag]["t_end"] - batches[tag]["t_start"])
    emit("serving_summary", http=http, direct_generate=direct, metrics_rtf=metrics["rtf"],
         metrics=metrics, ttfb_into_batch_s=ttfb_into_batch, stream_batch_wall_s=sm["wall_s"],
         max_memory_allocated_serving=peak_serving,
         launches=launches, device_launches=device_launches, card=card)
    del tts, rec, srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches, device_launches


# ---------------------------------------------------------------------------
# phase 9: the 1.5B trains on the card
# ---------------------------------------------------------------------------

FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (TF32 is off)
# one ~70-byte line a turn; two rows of six turns alternate two speakers
TRAIN_LINES = (
    " Welcome back to the show, today we talk about trains and timetables.",
    " Thanks for having me, I have been looking forward to this for weeks.",
    " Let us start with the basics: why do trains still run late so often?",
    " Mostly it is the track work, and a few old signals that fail in rain.",
    " And what could a small town do about it, short of building new line?",
    " Better buses to the station help, and honest delay boards help more.",
    " Our second guest builds the software that plans every crew shift.",
    " It is a puzzle: every engineer needs rest, and every train needs one.",
    " How long does the planner take to find a good plan for a whole week?",
    " About an hour on one machine, and we rerun it when a storm comes in.",
    " That is faster than I expected, given how many rules there must be.",
    " The rules are the easy part; the hard part is agreeing on the goals.",
)
TRAIN_ROWS, TRAIN_TURNS, TRAIN_STEPS = 2, 6, 4


def speech_batch(params, cfg, dev, root, turns=TRAIN_TURNS):
    """2 rows x `turns` turns of the demo voices (8 s, 60 frames each) through
    the port's data pipeline with the byte tokenizer; the semantic features
    come from the port's semantic encoder on the card, under no_grad."""
    from vibevoice_tpu_torch import data as D
    from vibevoice_tpu_torch.models import tokenizer as tok
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    clips = list(load_presets(root).values())
    examples = []
    for r in range(TRAIN_ROWS):
        lines = [(1 + j % 2, TRAIN_LINES[r * TRAIN_TURNS + j]) for j in range(turns)]
        audio = [clips[(r * TRAIN_TURNS + j) % len(clips)] for j in range(turns)]
        examples.append((lines, audio))

    @torch.no_grad()
    def semantic_fn(speech):
        x = torch.from_numpy(speech).to(dev)[..., None]
        return tok.encoder_apply(params["semantic_encoder"], cfg.semantic_tokenizer,
                                 x).cpu().numpy()

    return D.build_training_batch(ByteFallbackTokenizer(), examples,
                                  hop=cfg.speech_compress_ratio, semantic_fn=semantic_fn,
                                  semantic_dim=cfg.semantic_vae_dim)


def encoder_flops(enc, cfg, samples: int, rows: int) -> int:
    """Forward FLOPs of a σ-VAE encoder over `rows` clips of `samples`: two
    per weight element per output position of its conv or linear."""
    strides = [1] + list(reversed(cfg.encoder_ratios))
    t, n = samples, 0
    for i, stage in enumerate(enc["stages"]):
        t //= strides[i]
        n += enc["down"][i]["w"].numel() * t
        n += sum(blk[k]["w"].numel() for blk in stage for k in ("mixer", "ffn1", "ffn2")) * t
    n += enc["head"]["w"].numel() * t
    return 2 * n * rows


def train_step_flops(params, cfg, batch, mul: int) -> dict:
    """Model FLOPs of one training step from the shapes: 6 per weight
    element per row for the trained products (forward + two backward), dense
    attention's two products over every (query, key) pair, the acoustic
    encoder's forward alone (it runs under no_grad)."""
    dec = cfg.decoder
    b, t = batch.input_ids.shape
    two_d = lambda tree: sum(p.numel() for p in _tensors(tree) if p.dim() > 1)
    frames = batch.speech_masks.size
    out = {
        "lm_products": 6 * two_d(params["lm"]["layers"]) * b * t,
        "logits": 6 * dec.hidden_size * dec.vocab_size * b * t,
        "attention": 3 * 4 * b * t * t * dec.num_attention_heads * dec.head_dim
        * dec.num_hidden_layers,
        "diffusion_head": 6 * two_d(params["diffusion_head"]) * frames * mul,
        "connectors": (6 * two_d(params["acoustic_connector"])
                       + 2 * two_d(params["semantic_connector"])) * frames,
        "acoustic_encoder": encoder_flops(params["acoustic_encoder"], cfg.acoustic_tokenizer,
                                          batch.speech_tensors.shape[1],
                                          batch.speech_tensors.shape[0]),
    }
    out["total"] = sum(out.values())
    return out


def _tensors(tree):
    return [x for _, x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class StepMarks:
    """CUDA events at the parts of an eager `train_step`: the audio encode
    (under no_grad, inside the forward), the rest of the forward, the
    backward and the optimizer.  It wraps the model's `training_forward` and
    `encode_voice_prompts` and the optimizer's `update` while it is
    entered."""

    PARTS = ("encode", "forward", "backward", "optimizer")

    def __init__(self, V, opt):
        self.V, self.opt = V, opt

    def _mark(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[name] = e

    def _wrap(self, fn, before, after):
        def run(*a, **k):
            if before:
                self._mark(before)
            out = fn(*a, **k)
            self._mark(after)
            return out
        return run

    def __enter__(self):
        self.events = {}
        self.saved = (self.V.training_forward, self.V.encode_voice_prompts, self.opt.update)
        tf, enc, update = self.saved
        self.V.training_forward = self._wrap(tf, None, "forward_end")
        self.V.encode_voice_prompts = self._wrap(enc, "encode_start", "encode_end")
        self.opt.update = self._wrap(update, "backward_end", "optimizer_end")
        self._mark("start")
        return self

    def __exit__(self, *exc):
        self.V.training_forward, self.V.encode_voice_prompts, self.opt.update = self.saved
        self._mark("end")

    def parts_ms(self) -> dict:
        e = self.events
        e["end"].synchronize()
        ms = lambda a, b: e[a].elapsed_time(e[b])
        enc = ms("encode_start", "encode_end")
        return {"encode": enc, "forward": ms("start", "forward_end") - enc,
                "backward": ms("forward_end", "backward_end"),
                "optimizer": ms("backward_end", "optimizer_end"),
                "step": ms("start", "end")}


FROZEN = ("acoustic_encoder", "acoustic_decoder", "semantic_encoder")


def phase_train(dev, card, root):
    """The training path at full width and depth: `init_model(vibevoice_1_5b,
    float32)` on the card, a batch of 2 rows x 6 turns from `demo/voices`
    through `data.build_training_batch`, `init_scaling_stats`, then
    `make_optimizer(lr=1e-4, warmup_steps=2, total_steps=100)` and 4
    `train_step`s.  Checks: finite losses; step 1 (lr 0) leaves every
    parameter bit-equal; step 2 decays each >=2-d frozen-tokenizer weight by
    (1 - lr1 * wd) and leaves its 1-d leaves as they were; ce_loss falls;
    no kernel wrapper launches; TF32 is off."""
    import gc
    from vibevoice_tpu_torch import train as T
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.models import vibevoice as V
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_memory", allocated_before=torch.cuda.memory_allocated(),
         reserved_before=torch.cuda.memory_reserved())
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cfg = vibevoice_1_5b()
    t0 = time.perf_counter()
    params = V.init_model(cfg, dtype=torch.float32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = speech_batch(params, cfg, dev, root)
    params = T.init_scaling_stats(params, cfg, torch.Generator(device=dev).manual_seed(SEED),
                                  batch, device=dev)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    b, t = batch.input_ids.shape
    n_tok = int(batch.attention_mask.sum())
    mul = cfg.diffusion_head.ddpm_batch_mul
    if (b, t) != (TRAIN_ROWS, 1024) or batch.speech_masks.shape != (12, 60):
        raise RuntimeError(f"batch {batch.input_ids.shape}, frames {batch.speech_masks.shape}")
    lr, wd = 1e-4, 0.01
    opt = T.make_optimizer(params, lr=lr, weight_decay=wd, warmup_steps=2, total_steps=100)
    step = T.make_train_step(cfg, opt, device=dev, eager=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on for fp32 matmuls or convolutions")
    n_params = sum(p.numel() for p in opt.leaves)
    flops = train_step_flops(params, cfg, batch, mul)
    emit("train_setup", model="vibevoice_1_5b", dtype="fp32", params=n_params,
         leaves=len(opt.leaves), batch=[b, t], tokens=n_tok, clips=batch.speech_masks.shape[0],
         frames=int(batch.speech_masks.sum()), diffusion_rows=batch.speech_masks.size * mul,
         init_s=init_s, batch_and_scaling_s=batch_s,
         speech_scaling_factor=params["speech_scaling_factor"].item(),
         speech_bias_factor=params["speech_bias_factor"].item(), step_flops=flops,
         allocated=torch.cuda.memory_allocated())
    before = [p.detach().to("cpu", copy=True) for p in opt.leaves]
    frozen = {id(p) for name in FROZEN for p in _tensors(params[name])}
    losses, parts = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        lr_i = opt.schedule(opt.count)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with StepMarks(V, opt) as marks:
            m = step(params, batch, gen)
        loss = {k: float(v) for k, v in m.items()}
        wall = time.perf_counter() - t0
        p_ms = marks.parts_ms()
        losses.append(loss)
        parts.append(p_ms)
        emit("train", step=i + 1, lr=lr_i, wall_s=wall, device_ms=p_ms["step"],
             tokens_per_s=n_tok / wall, padded_tokens_per_s=b * t / wall, **loss,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             allocated_after=torch.cuda.memory_allocated(), model_flops=flops["total"],
             flops_per_s=flops["total"] / wall,
             fp32_peak_share=flops["total"] / wall / FP32_FLOPS, card=card)
        if not all(np.isfinite(v) for v in loss.values()):
            raise RuntimeError(f"step {i + 1}: loss not finite: {loss}")
        if i == 0:  # lr(0) = 0: nothing moves
            changed = [j for j, (p, w) in enumerate(zip(opt.leaves, before))
                       if not torch.equal(p.detach().cpu(), w)]
            if changed:
                raise RuntimeError(f"step 1 (lr 0) changed {len(changed)} leaves")
        elif i == 1:  # the frozen tokenizers only decay, by (1 - lr1 * wd)
            factor = np.float32(1.0 - lr_i * wd)
            worst, n_frozen = 0.0, 0
            for p, w in zip(opt.leaves, before):
                if id(p) not in frozen:
                    continue
                n_frozen += 1
                w = w.to(dev)
                want = w * float(factor) if p.dim() > 1 else w
                rel = float(((p.detach() - want).abs() / want.abs().clamp_min(1e-30)).max())
                worst = max(worst, rel)
            emit("train_frozen_decay", leaves=n_frozen, factor=float(factor),
                 max_rel_err=worst, bit_equal=worst == 0.0)
            if worst > 2.0 ** -23:
                raise RuntimeError(f"frozen tokenizer weights: {worst} off (1 - lr*wd)")
    del before
    mean = {k: float(np.mean([p[k] for p in parts[1:]])) for k in parts[0]}
    emit("train_parts", steps=f"2-{TRAIN_STEPS}", **{k + "_ms": v for k, v in mean.items()},
         card=card)
    graph = phase_train_graph(T, cfg, params, opt, batch, dev, card, n_tok, mean["step"])
    losses += graph
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    if launched:
        raise RuntimeError(f"kernels launched while training: {launched}")
    for run in (losses[:TRAIN_STEPS], graph):
        if not run[-1]["ce_loss"] < run[0]["ce_loss"]:
            raise RuntimeError(f"ce_loss did not fall: {[l['ce_loss'] for l in losses]}")
    del opt, step, params
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the segments of one graph memory
    pool (`torch.cuda.graph_pool_handle()`)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def phase_train_graph(T, cfg, params, opt, batch, dev, card, n_tok, eager_ms):
    """Phase 9's captured steps: after the eager ones, with the same params
    and optimizer, TRAIN_STEPS steps of `make_train_step` as it runs by
    default on the card: the first a real step on a side stream and the
    capture, the rest replays.  Each step is timed on the host and by CUDA
    events around the call (the batch's copy in, the replay, the metrics'
    copy out).  Raises on a loss that is not finite or a step that did not
    replay.  Returns the losses."""
    gstep = T.make_train_step(cfg, opt, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    losses, ms, walls = [], [], []
    peak_capture = pool = reserved = None
    for i in range(TRAIN_STEPS):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        lr_i = opt.schedule(opt.count)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        m = gstep(params, batch, gen)
        end.record()
        loss = {k: float(v) for k, v in m.items()}
        walls.append(time.perf_counter() - t0)
        ms.append(start.elapsed_time(end))
        losses.append(loss)
        if i == 0:
            peak_capture = torch.cuda.max_memory_allocated()
            pool, reserved = pool_bytes(gstep.pool), torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
        emit("train_graph", step=TRAIN_STEPS + i + 1, captured=i == 0, lr=lr_i,
             wall_s=walls[-1], device_ms=ms[-1], tokens_per_s=n_tok / walls[-1], **loss,
             card=card)
        if not all(np.isfinite(v) for v in loss.values()):
            raise RuntimeError(f"captured step {i + 1}: loss not finite: {loss}")
    if not (gstep.captures == 1 and gstep.replays == TRAIN_STEPS - 1):
        raise RuntimeError(f"{gstep.captures} captures, {gstep.replays} replays")
    replay_ms = float(np.mean(ms[1:]))
    emit("train_graph_summary", capture_s=gstep.capture_s, first_step_wall_s=walls[0],
         replay_device_ms=replay_ms, replay_device_ms_each=ms[1:],
         replay_wall_ms=1e3 * float(np.mean(walls[1:])), eager_step_device_ms=eager_ms,
         eager_over_replay=eager_ms / replay_ms, pool_bytes=pool,
         reserved_growth_over_capture=reserved - reserved0,
         max_memory_allocated_capture=peak_capture,
         max_memory_allocated_replays=torch.cuda.max_memory_allocated(), card=card)
    del gstep
    return losses


def tiny_train_batch(cfg, pad_to_multiple=64, seed=SEED):
    """Two examples, three clips of 3, 1 and 2 frames (the short ones leave
    frames masked out), random semantic features."""
    from vibevoice_tpu_torch import data as D
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    rng = np.random.default_rng(seed)
    hop = cfg.speech_compress_ratio
    examples = [([(1, " Hello there."), (2, " Hi.")],
                 [rng.normal(0, 0.1, 3 * hop - 8), rng.normal(0, 0.1, hop)]),
                ([(1, " Short.")], [rng.normal(0, 0.1, 2 * hop - 4)])]
    sem = lambda s: rng.normal(0, 0.1, (len(s), s.shape[1] // hop,
                                        cfg.semantic_vae_dim)).astype(np.float32)
    return D.build_training_batch(ByteFallbackTokenizer(), examples, hop=hop, semantic_fn=sem,
                                  semantic_dim=cfg.semantic_vae_dim,
                                  pad_to_multiple=pad_to_multiple)


TRAIN_REL_TOL = 1e-5  # of a leaf's largest magnitude (or of 1): fp32, sums in another order


def phase_train_reference(dev, steps=2):
    """`tiny_config(vocab_size=320)` in fp32 takes `steps` train_steps on the
    card and on the CPU from the same weights, batch and injected noise and
    timesteps (the VAE samples with fix_std 0), lr 1e-2 from the second step:
    the losses and every parameter afterwards agree within TRAIN_REL_TOL.
    Returns the largest relative disagreements."""
    import copy
    import dataclasses
    from vibevoice_tpu_torch import train as T
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.weights import to_device
    cfg = tiny_config(vocab_size=320)
    cfg = dataclasses.replace(cfg, acoustic_tokenizer=dataclasses.replace(
        cfg.acoustic_tokenizer, fix_std=0.0))
    gen = torch.Generator().manual_seed(SEED)
    params = V.init_model(cfg, generator=gen, device="cpu")
    _live_audio_path(params, gen)
    batch = tiny_train_batch(cfg)
    rng = np.random.default_rng(SEED)
    n = batch.speech_masks.size * cfg.diffusion_head.ddpm_batch_mul
    inj = [(rng.normal(size=(n, cfg.acoustic_vae_dim)).astype(np.float32),
            rng.integers(0, cfg.diffusion_head.ddpm_num_steps, n).astype(np.int32))
           for _ in range(steps)]
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = {}
    for where in ("cpu", dev):
        p = to_device(copy.deepcopy(params), where)
        opt = T.make_optimizer(p, lr=1e-2, warmup_steps=1, total_steps=10)
        step = T.make_train_step(cfg, opt, device=where)
        losses = [{k: float(v) for k, v in step(p, batch, None, nz, ts).items()}
                  for nz, ts in inj]
        out[str(where)] = (losses, [x.detach().cpu() for x in opt.leaves])
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out["cpu"], out[str(dev)]
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    loss_err = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(l_gpu, l_cpu) for k in w)
    param_err = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1.0)
                    for g, w in zip(p_gpu, p_cpu))
    emit("train_reference", model="tiny_config(vocab_size=320)", steps=steps,
         losses_cpu=l_cpu, losses_gpu=l_gpu, loss_max_rel_err=loss_err,
         param_max_rel_err=param_err, tol=TRAIN_REL_TOL, kernel_launches=launched)
    if launched:
        raise RuntimeError(f"kernels launched while training: {launched}")
    if not (loss_err <= TRAIN_REL_TOL and param_err <= TRAIN_REL_TOL):
        raise RuntimeError(f"card and CPU training disagree: losses {loss_err}, "
                           f"params {param_err} > {TRAIN_REL_TOL}")
    return loss_err, param_err


def train_turns(cfg, make_params, batch, dev, inj, turns, lr=1e-4, steps=None):
    """Train steps from `make_params()` in turns, each model released before
    the next: `turns` holds (name, mesh or None, eager).  `inj` holds one
    (injected noise, timesteps) pair a step; with None every turn draws from
    a generator of one seed (`steps` steps).  Returns per turn the losses of
    every step, every leaf afterwards (on the host), the step's captures,
    replays and last capture's seconds, its graphs' node names
    (`graph_kernels`) and the collectives of its last call."""
    import gc
    from vibevoice_tpu_torch import train as T
    from vibevoice_tpu_torch.parallel import model_param_specs
    out = {}
    for name, mesh, eager in turns:
        params = make_params()
        opt = T.make_optimizer(params, lr=lr, weight_decay=0.01, warmup_steps=1,
                               total_steps=100, mesh=mesh,
                               specs=None if mesh is None else model_param_specs(params, cfg))
        step = T.make_train_step(cfg, opt, device=dev, mesh=mesh, eager=eager)
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        losses = []
        for i in range(len(inj) if inj is not None else steps):
            args = (None, *inj[i]) if inj is not None else (gen,)
            with Collectives() as coll:
                m = step(params, batch, *args)
                losses.append(torch.stack([m[k] for k in T.METRICS]).cpu())
        out[name] = dict(losses=losses, leaves=[p.detach().cpu() for p in opt.leaves],
                         captures=step.captures, replays=step.replays,
                         capture_s=step.capture_s,
                         nodes=[graph_kernels(c.graph) for c in step.graphs.values()],
                         collectives={k: v["calls"] for k, v in coll.calls.items()})
        del params, opt, m, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_eager_vs_graph(cfg, make_params, batch, dev, steps, injected, lr=1e-4):
    """`steps` train steps from `make_params()` on one batch, first eager
    (`make_train_step(eager=True)`), then captured (the default on the card),
    with one generator seed (drawn noise: the timesteps, the diffusion noise
    and the VAE sample) or injected noise and timesteps with no generator
    (`train_turns`)."""
    n = batch.speech_masks.size * cfg.diffusion_head.ddpm_batch_mul
    rng = np.random.default_rng(SEED + 3)
    inj = [(rng.normal(size=(n, cfg.acoustic_vae_dim)).astype(np.float32),
            rng.integers(0, cfg.diffusion_head.ddpm_num_steps, n).astype(np.int32))
           for _ in range(steps)]
    return train_turns(cfg, make_params, batch, dev, inj if injected else None,
                       (("eager", None, True), ("graph", None, False)), lr=lr, steps=steps)


def bit_equal_runs(runs, a="eager", b="graph") -> dict:
    """Two turns of `train_turns` compared: whether the losses of every step
    and every leaf afterwards are bit-equal, and how many leaves differ."""
    (l_e, p_e), (l_g, p_g) = ((runs[t]["losses"], runs[t]["leaves"]) for t in (a, b))
    losses_equal = all(torch.equal(x, y) for x, y in zip(l_e, l_g))
    differ = [i for i, (x, y) in enumerate(zip(p_e, p_g)) if not torch.equal(x, y)]
    return dict(losses_equal=losses_equal, leaves=len(p_e), leaves_differ=len(differ),
                first_leaf_differs=differ[0] if differ else None,
                **{f"losses_{t}": [x.tolist() for x in runs[t]["losses"]] for t in (a, b)})


# ---------------------------------------------------------------------------
# phase 10: the parallel paths, two ranks on one card over gloo
# ---------------------------------------------------------------------------

# 10a/10b: a 1024-token prompt (flash prefill by the auto rule) and a
# 4096-slot cache (decode attention); 10c: the served configuration at a
# global B=4; 10d: context-parallel and ring prefill at the 1.5B layer shape
PAR_PROMPT, PAR_STEPS = 1024, 3072
DP_BATCH, DP_PROMPT, DP_STEPS = 4, 256, 3840
CP_T, RING_T = 8192, 4096
PAR_RANKS = 2
# the TP runs (weights, KV cache, warm-up steps, timed steps); fp32 is the
# well-conditioned one, held over the whole run
PAR_TP_RUNS = (("bf16", "model", 8, 16), ("fp32", "model", 8, 16), ("int8", "int8", 8, 8))
PAR_TIMEOUT_S = 600  # a rank still alive then is killed, and the run fails
# TP against the unsharded engine in fp32, on the prompt's last hidden state
# and the first frame (relative L2): the split reorders fp32 sums (~1e-7
# each) over 28 layers and the head; a rank that summed wrong or missed a
# collective is O(1) off.  Later frames are not held: the random model feeds
# each frame back into the LM and grows a difference ~5x a frame (fp32 TP
# against fp32: 5e-5, 2e-4, 1e-3, 7e-3, 5e-2, ... ~1 by the tenth frame)
FP32_TOL = 1e-3


def parallel_gen(G):
    """`bench_gen` under the deterministic solver: with injected noise, two
    runs of one weight set differ by their arithmetic alone."""
    import dataclasses
    return dataclasses.replace(bench_gen(G), algorithm_type="dpmsolver++")


def _as_fp32(tree):
    if isinstance(tree, dict):
        return {k: _as_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_fp32(v) for v in tree]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.float()
    return tree


def parallel_params(cfg, dev, kind):
    """The phase's weights, made from the seed the same way in every process:
    the bf16 1.5B with a live audio path (`_live_audio_path`: the head's
    adaLN and final layers random, so the audio depends on the LM), then as
    `kind` says: "bf16", "fp32" (the same values in fp32), "int8" (the LM and
    head int8, `utils.quantize.quantize_model`) or "int4" (the served
    configuration, `QUANT_MODES` through `VibeVoiceTTS`)."""
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    from vibevoice_tpu_torch.utils.quantize import quantize_model
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    _live_audio_path(params, torch.Generator(device=dev).manual_seed(SEED + 10))
    if kind == "fp32":
        return _as_fp32(params)
    if kind == "int8":
        return quantize_model(params, cfg.decoder.tie_word_embeddings, mode="int8")
    if kind == "int4":
        return VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.bfloat16,
                            device=dev, **QUANT_MODES).params
    return params


def parallel_inputs(batch, prompt_len, frames, cfg):
    """Prompt ids, mask (rows 1 and 3 left-padded at B=4), speech mask and the
    injected noise [frames, B, latent], from the seed."""
    rng = np.random.default_rng(SEED + 7)
    ids = rng.integers(0, 1000, (batch, prompt_len)).astype(np.int32)
    mask = np.ones((batch, prompt_len), np.int32)
    if batch >= 4:
        mask[1, :37] = 0
        mask[3, :101] = 0
    sim = np.zeros((batch, prompt_len), bool)
    noise = rng.normal(size=(frames, batch, cfg.acoustic_vae_dim)).astype(np.float32)
    return ids, mask, sim, noise


class Collectives:
    """Counts the `torch.distributed` collectives made while it is open (the
    port calls them through the module): per kind, the calls, the bytes each
    sent and the host seconds inside them (with gloo on CUDA tensors a call
    also waits for the card to reach it)."""
    KINDS = ("all_reduce", "all_gather", "all_to_all_single", "broadcast")

    def __enter__(self):
        import torch.distributed as dist
        self.dist, self.orig, self.calls = dist, {}, {}

        def wrap(kind, fn):
            def timed(*a, **kw):
                t = a[1] if kind in ("all_gather", "all_to_all_single") else a[0]
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                rec = self.calls.setdefault(kind, {"calls": 0, "bytes": [], "s": 0.0})
                rec["calls"] += 1
                rec["bytes"].append(t.numel() * t.element_size())
                rec["s"] += time.perf_counter() - t0
                return out
            return timed

        for k in self.KINDS:
            self.orig[k] = getattr(dist, k)
            setattr(dist, k, wrap(k, self.orig[k]))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.dist, k, fn)


def par_run(eng, inputs, warm, timed, dev):
    """Prefill, a warm-up chunk and a timed chunk of `eng`: the tokens, audio
    and emitted flags so far (this engine's rows), the prompt's last hidden
    state, the wrappers' launches in the prefill and over the decode steps,
    ms per frame of the timed chunk and the collectives made in it."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    ids, mask, sim, noise = inputs
    with PromptHidden() as hid:
        state, _ = eng.prefill(ids, mask, sim, generator=torch.Generator(device=dev)
                               .manual_seed(SEED), latent_noise=noise)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prefill = {k: c.launches for k, c in counters.items()}
    state, _ = eng.decode_chunk(state, warm)
    f0 = int(state.frames.sum())
    with Collectives() as coll:
        t0 = time.perf_counter()
        state, _ = eng.decode_chunk(state, timed)
        frames = int(state.frames.sum()) - f0  # waits for the card
        wall = time.perf_counter() - t0
    n = state.host_step
    if len(hid.rows) != 1:
        raise RuntimeError(f"{len(hid.rows)} prompt forwards in one prefill")
    return dict(state=state, tokens=state.tokens[:, :n].cpu(),
                audio=state.audio[:, :n].float().cpu(), emitted=state.emitted[:, :n].cpu(),
                hidden=hid.rows[0].cpu(), prefill_launches=prefill,
                step_launches={k: c.launches - prefill[k] for k, c in counters.items()},
                frames=frames, wall_s=wall, ms_per_frame=1e3 * wall / max(frames, 1),
                collectives={k: dict(v, per_step=v["calls"] / timed)
                             for k, v in coll.calls.items()})


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _slim(r):
    """What a rank hands back of a `par_run` (CPU tensors and numbers)."""
    return {k: v for k, v in r.items() if k != "state"}


def _rank_tp(rank, dev, card, cfg):
    """10a and 10b on this rank (`PAR_TP_RUNS`: bf16, the same weights in
    fp32, int8 + int8 KV): the TP=2 engine over the rank's shard, eager (gloo
    collectives cannot be captured); 28 flash launches in the prefill, 28
    decode-attention launches a step, asserted.  10b also hands back the
    int8 cache's slot scales and each slot's largest |int8| on this rank's
    lanes."""
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.parallel import make_mesh, shard_params
    n_layers = cfg.decoder.num_hidden_layers
    mesh = make_mesh(data=1, model=PAR_RANKS)
    out = {}
    for kind, kv, warm, timed in PAR_TP_RUNS:
        full = parallel_params(cfg, dev, kind)
        local = shard_params(full, mesh, cfg=cfg)
        del full
        torch.cuda.empty_cache()
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        eng = G.Engine(local, cfg, parallel_gen(G), max_steps=PAR_STEPS, batch=1,
                       prompt_len=PAR_PROMPT, dtype=dtype, kv_dtype=kv, device=dev,
                       inject_latent_noise=True, mesh=mesh, eager=True)
        if not (eng.use_flash_prefill and eng.use_flash_decode and eng.cache_len == 4096):
            raise RuntimeError("the TP engine is off the kernels' path")
        r = par_run(eng, parallel_inputs(1, PAR_PROMPT, warm + timed + 1, cfg), warm, timed,
                    dev)
        steps = warm + timed
        want_pre = dict.fromkeys(kernel_counters(), 0)
        want_pre["flash_attention_prefill"] = n_layers
        want_step = dict.fromkeys(kernel_counters(), 0)
        want_step["decode_attention"] = n_layers * steps
        if r["prefill_launches"] != want_pre or r["step_launches"] != want_step:
            raise RuntimeError(f"TP rank {rank} ({kind}): launches {r['prefill_launches']} / "
                               f"{r['step_launches']}, want {want_pre} / {want_step}")
        cache = r["state"].cache
        if kv == "int8":
            r["k_scale"], r["v_scale"] = cache.k_scale.cpu(), cache.v_scale.cpu()
            r["k_qmax"] = cache.k.abs().amax(dim=-1).cpu()
            r["v_qmax"] = cache.v.abs().amax(dim=-1).cpu()
        coll = r["collectives"]
        ar = coll.get("all_reduce", {"calls": 0, "bytes": [0], "s": 0.0, "per_step": 0})
        emit("parallel_tp", rank=rank, weights=kind, kv=kv, backend=mesh.backend("model"),
             cache_lanes=int(cache.k.shape[-1]), local_heads=[
                 cfg.decoder.num_attention_heads // PAR_RANKS,
                 cfg.decoder.num_key_value_heads // PAR_RANKS],
             prefill_launches=r["prefill_launches"], step_launches=r["step_launches"],
             steps=steps, timed_steps=timed, ms_per_frame=r["ms_per_frame"],
             all_reduces_per_step=ar["per_step"], all_reduce_bytes_max=max(ar["bytes"]),
             all_reduce_bytes_per_step=sum(ar["bytes"]) / timed,
             all_reduce_ms_per_step=1e3 * ar["s"] / timed,
             all_reduce_share=ar["s"] / r["wall_s"],
             other_collectives={k: v["calls"] for k, v in coll.items() if k != "all_reduce"},
             note="eager; gloo stages every collective through the host: not a TP speed",
             card=card)
        if set(coll) - {"all_reduce"} or max(ar["bytes"]) > 16384:
            raise RuntimeError(f"TP rank {rank}: a step made {coll}")
        out[kind] = _slim(r)
        del eng, local, r, cache
        torch.cuda.empty_cache()
    return out


def _rank_dp(rank, dev, card, cfg):
    """10c on this rank: the served configuration (int4 + int4k + head int4k
    + fused stages) on a DP=2 mesh over the global B=4 batch, 2 rows a rank,
    its own captured step; kernel nodes per step asserted against the step's
    launches at the rank's batch, no collective in the timed steps;
    `dp_scaling_report` over the ranks."""
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.parallel import make_mesh
    from vibevoice_tpu_torch.parallel.multihost import dp_scaling_report
    mesh = make_mesh(data=PAR_RANKS, model=1)
    params = parallel_params(cfg, dev, "int4")
    eng = G.Engine(params, cfg, parallel_gen(G), max_steps=DP_STEPS, batch=DP_BATCH,
                   prompt_len=DP_PROMPT, dtype=torch.bfloat16, device=dev,
                   inject_latent_noise=True, mesh=mesh, use_fused_stages=True)
    warm, timed = 8, 16
    r = par_run(eng, parallel_inputs(DP_BATCH, DP_PROMPT, warm + timed + 1, cfg), warm, timed,
                dev)
    want_pre, want_step = expected_launches(cfg, "int4", eng)
    nodes, other = graph_launches(eng.graph)
    if (eng.captures != 1 or nodes != merge_stages(want_step)
            or r["prefill_launches"] != want_pre
            or r["step_launches"] != {k: 2 * v for k, v in want_step.items()}):
        raise RuntimeError(f"DP rank {rank}: captures {eng.captures}, nodes {nodes}, launches "
                           f"{r['prefill_launches']} / {r['step_launches']}; want "
                           f"{merge_stages(want_step)}, {want_pre}")
    if r["collectives"]:
        raise RuntimeError(f"DP rank {rank}: a step made {r['collectives']}")
    replays = eng.replays  # before the timing loop's replays below
    rows = eng.gather(r["state"])
    n = r["tokens"].shape[1]
    if not torch.equal(rows.tokens[2 * rank:2 * rank + 2, :n].cpu(), r["tokens"]):
        raise RuntimeError("the gathered rows are not in global order")
    audio_s = r["frames"] * cfg.speech_compress_ratio / 24000.0
    report = dp_scaling_report(audio_s, r["wall_s"])
    device_ms = cuda_ms(lambda i: eng.graph.replay(), 10)
    emit("parallel_dp", rank=rank, rows=[2 * rank, 2 * rank + 1], local_batch=eng.batch,
         graph_nodes=nodes, graph_other_nodes=other, captures=eng.captures,
         capture_s=eng.capture_s, ms_per_frame=r["ms_per_frame"],
         device_ms_per_replay=device_ms, collectives_in_steps=r["collectives"],
         rowlane=uses_rowlane_any(eng), stage_launches_per_step=stage_launches(eng),
         dp_scaling_report=report,
         note="two ranks share one card: not a scaling figure", card=card)
    r["graph_nodes"], r["replays"] = nodes, replays
    out = _slim(r)
    del eng, params, r, rows
    torch.cuda.empty_cache()
    return out


def _rank_cp_ring(rank, dev, card):
    """10d on this rank: `cp_prefill_attention` at T=8192 (this rank's 4096
    rows, the flash kernel at row_offset rank * 4096 over S=8192) and
    `ring_prefill_attention` at T=4096, both over the data axis, with their
    wall ms, the all-gather's and peak memory."""
    from vibevoice_tpu_torch.ops import flash_attention as fa
    from vibevoice_tpu_torch.parallel import make_mesh
    from vibevoice_tpu_torch.parallel.context_parallel import cp_prefill_attention, gather_kv
    from vibevoice_tpu_torch.parallel.ring_attention import ring_prefill_attention
    mesh = make_mesh(data=PAR_RANKS, model=1)
    out = {}

    def wall_ms(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return res, ts

    for case, t, seed in (("cp", CP_T, SEED + 20), ("ring", RING_T, SEED + 21)):
        q, k, v, mask = flash_inputs(1, t, 0, torch.Generator(device=dev).manual_seed(seed), dev)
        n = t // PAR_RANKS
        rows = slice(rank * n, (rank + 1) * n)
        args = tuple(x[:, rows].contiguous() for x in (q, k, v, mask))
        del q, k, v, mask
        before = fa.flash_attention_prefill.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with Collectives() as coll:
            if case == "cp":
                got, ms = wall_ms(lambda: cp_prefill_attention(*args, mesh))
            else:
                got, ms = wall_ms(lambda: ring_prefill_attention(*args, mesh))
        peak = torch.cuda.max_memory_allocated() - base
        launches = fa.flash_attention_prefill.launches - before
        gather = wall_ms(lambda: gather_kv(args[1], args[2], args[3], mesh))[1] \
            if case == "cp" else None
        want_launches = 3 if case == "cp" else 0
        if launches != want_launches:
            raise RuntimeError(f"{case} rank {rank}: {launches} flash launches, want "
                               f"{want_launches}")
        emit("parallel_" + case, rank=rank, t=t, rows=[rank * n, (rank + 1) * n],
             row_offset=rank * n, key_slots=t if case == "cp" else n,
             shape={"q": list(args[0].shape), "k": list(args[1].shape)}, wall_ms=ms,
             all_gather_ms=gather, peak_bytes=peak, flash_launches=launches,
             collectives={kk: vv["calls"] for kk, vv in coll.calls.items()},
             note="gloo through the host: not a CP speed", card=card)
        out[case] = got.cpu()
        out[case + "_launches"] = launches
        del got, args
        torch.cuda.empty_cache()
    return out


def spawn_ranks(target, world, work, args, timeout, what):
    """`target(rank, world, store, work, *args)` in `world` spawned
    processes, joined with a deadline (a rank still alive then is killed);
    each rank's `rank{r}.pt`, or RuntimeError with every failed rank's
    traceback."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(work, "store")
    procs = [ctx.Process(target=target, args=(r, world, store, work) + tuple(args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(work, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif r in alive:
            errors.append(f"rank {r} still alive after {timeout} s: killed")
        elif p.exitcode != 0:
            errors.append(f"rank {r} exited with {p.exitcode}")
    if errors:
        raise RuntimeError(f"{what} ranks failed:\n" + "\n".join(errors))
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _gloo_rank(rank, world, store, out_dir, fn, *args):
    """A spawned gloo rank on `cuda:0`: `fn(rank, dev, *args)`'s result saved
    to `out_dir`; a failure leaves its traceback there and a non-zero
    exit."""
    import datetime
    import traceback
    import torch.distributed as dist
    try:
        from vibevoice_tpu_torch.device import resolve_device
        torch.cuda.set_device(0)
        dev = resolve_device("cuda")
        dist.init_process_group("gloo", init_method="file://" + store, world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
        out = fn(rank, dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _parallel_rank(rank, dev, card):
    """One rank of phase 10 (a spawned process, `_gloo_rank`): 10a-10d in
    order."""
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    cfg = vibevoice_1_5b()
    return {"tp": _rank_tp(rank, dev, card, cfg), "dp": _rank_dp(rank, dev, card, cfg),
            "cp": _rank_cp_ring(rank, dev, card)}


def parallel_references(dev, card, cfg):
    """The unsharded runs phase 10 is held against, on this process, on the
    same card, with the same weights, inputs and injected noise: 10a the bf16
    engine and the fp32 one (also the yardstick: how far bf16 arithmetic
    alone moves the hidden state and the audio); 10b the int8 + int8 KV
    engine; 10c the served configuration at B=4 and at B=2 on rows 0-1 and
    2-3; 10d the plain version of flash prefill over all rows."""
    from vibevoice_tpu_torch.engine import generate as G
    refs = {}
    for kind, kv, warm, timed in PAR_TP_RUNS:
        params = parallel_params(cfg, dev, kind)
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        eng = G.Engine(params, cfg, parallel_gen(G), max_steps=PAR_STEPS, batch=1,
                       prompt_len=PAR_PROMPT, dtype=dtype, kv_dtype=kv, device=dev,
                       inject_latent_noise=True, eager=True)
        r = par_run(eng, parallel_inputs(1, PAR_PROMPT, warm + timed + 1, cfg), warm, timed,
                    dev)
        if kv == "int8":
            r["k_scale"], r["v_scale"] = r["state"].cache.k_scale.cpu(), \
                r["state"].cache.v_scale.cpu()
        refs[kind] = _slim(r)
        del eng, params, r
        torch.cuda.empty_cache()
    params = parallel_params(cfg, dev, "int4")
    ids, mask, sim, noise = parallel_inputs(DP_BATCH, DP_PROMPT, 25, cfg)
    for name, rows in (("b4", slice(0, 4)), ("b2_0", slice(0, 2)), ("b2_1", slice(2, 4))):
        b = rows.stop - rows.start
        eng = G.Engine(params, cfg, parallel_gen(G), max_steps=DP_STEPS, batch=b,
                       prompt_len=DP_PROMPT, dtype=torch.bfloat16, device=dev,
                       inject_latent_noise=True, use_fused_stages=True)
        inputs = (ids[rows], mask[rows], sim[rows], noise[:, rows])
        refs[name] = _slim(par_run(eng, inputs, 8, 16, dev))
        del eng
        torch.cuda.empty_cache()
    del params
    from vibevoice_tpu_torch.ops import flash_attention as fa
    for case, t, seed in (("cp", CP_T, SEED + 20), ("ring", RING_T, SEED + 21)):
        q, k, v, mask = flash_inputs(1, t, 0, torch.Generator(device=dev).manual_seed(seed), dev)
        refs["flash_" + case] = fa.flash_attention_prefill_ref(q, k, v, mask).cpu()
        refs["kernel_" + case] = fa.flash_attention_prefill(q, k, v, mask).cpu()
        del q, k, v, mask
    torch.cuda.empty_cache()
    return refs


def phase_parallel(dev, card):
    """Phase 10: the parallel paths as two ranks on this one card, over gloo
    (NCCL refuses two ranks on one device): the unsharded references first,
    on this process, then with what this process holds released, two ranks
    spawned (a `file://` store in a temporary directory, a finite timeout)
    that run 10a-10d; then every rank's results held against the references.
    Returns each kernel's launches on each rank (`parallel_launches`)."""
    import gc
    import shutil
    import tempfile
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    cfg = vibevoice_1_5b()
    t_start = time.perf_counter()
    refs = parallel_references(dev, card, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    emit("parallel_references", seconds=time.perf_counter() - t_start,
         allocated=torch.cuda.memory_allocated(), card=card)

    work = tempfile.mkdtemp(prefix="vv_parallel_")
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(_gloo_rank, PAR_RANKS, work, (_parallel_rank, card), PAR_TIMEOUT_S,
                            "phase 10")
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 10a / 10b.  The random 1.5B grows any difference ~5x a fed-back frame
    # (FP32_TOL), so two runs that differ in arithmetic decorrelate within
    # ~10 frames and a run is held where it is well conditioned: the
    # prompt's last hidden state and the first frame.  bf16 and int8: each
    # within twice the distance between the unsharded bf16 and fp32 engines
    # (TP only reorders bf16 sums: an independent error of that size puts it
    # ~1.4x apart), the bf16 hidden state also within twice that of the
    # fp32 engine's; fp32: within FP32_TOL of the unsharded fp32 engine.
    # The whole run's distances are reported by frame.  Tokens equal; both
    # ranks hold the same values.
    yard_h = rel_l2(refs["bf16"]["hidden"], refs["fp32"]["hidden"])
    yard_f0 = rel_l2(refs["bf16"]["audio"][:, 0], refs["fp32"]["audio"][:, 0])
    yard_run = rel_l2(refs["bf16"]["audio"], refs["fp32"]["audio"])
    for kind in ("bf16", "fp32", "int8"):
        ref = refs[kind]
        got = [rk["tp"][kind] for rk in ranks]
        d_hidden = [rel_l2(g["hidden"], ref["hidden"]) for g in got]
        d_f0 = [rel_l2(g["audio"][:, 0], ref["audio"][:, 0]) for g in got]
        d_run = [rel_l2(g["audio"], ref["audio"]) for g in got]
        d_frames = [rel_l2(got[0]["audio"][:, f], ref["audio"][:, f])
                    for f in range(ref["audio"].shape[1])]
        same_tokens = all(torch.equal(g["tokens"], ref["tokens"]) for g in got)
        ranks_equal = torch.equal(got[0]["audio"], got[1]["audio"])
        check = dict(weights=kind, hidden_rel_l2=d_hidden, first_frame_rel_l2=d_f0,
                     audio_rel_l2=d_run, audio_rel_l2_by_frame=d_frames,
                     bf16_vs_fp32=dict(hidden=yard_h, first_frame=yard_f0, audio=yard_run),
                     tokens_equal=same_tokens, ranks_audio_equal=ranks_equal,
                     unsharded_ms_per_frame=ref["ms_per_frame"],
                     rank_ms_per_frame=[g["ms_per_frame"] for g in got])
        ok = same_tokens and ranks_equal
        if kind == "fp32":
            check["tol"] = dict(hidden=FP32_TOL, first_frame=FP32_TOL)
            ok = ok and max(d_hidden) <= FP32_TOL and max(d_f0) <= FP32_TOL
        else:
            check["tol"] = dict(hidden=2 * yard_h, first_frame=2 * yard_f0)
            ok = ok and max(d_hidden) <= 2 * yard_h and max(d_f0) <= 2 * yard_f0
        if kind == "bf16":
            check["hidden_rel_l2_vs_fp32"] = [rel_l2(g["hidden"], refs["fp32"]["hidden"])
                                              for g in got]
            ok = ok and max(check["hidden_rel_l2_vs_fp32"]) <= 2 * yard_h
        if kind == "int8":
            # the slot scales: one per slot over ALL lanes, so both ranks
            # store the same scales, and each written slot's largest |int8|
            # over both ranks' lanes is 127 (the slot's amax sets its scale)
            for s in ("k", "v"):
                sc = [g[s + "_scale"] for g in got]
                qmax = torch.maximum(got[0][s + "_qmax"], got[1][s + "_qmax"])
                written = sc[0][:, :, 0].float() > 0
                check[s + "_scales_equal_across_ranks"] = torch.equal(sc[0], sc[1])
                check[s + "_written_slots"] = int(written.sum())
                check[s + "_slot_qmax_127"] = bool((qmax[written] == 127).all())
                same = (sc[0] == ref[s + "_scale"])[:, :, 0]
                check[s + "_scales_equal_unsharded_share"] = float(same[written].float().mean())
                check[s + "_scales_equal_unsharded_share_layer0"] = float(
                    same[0][written[0]].float().mean())
                ok = ok and check[s + "_scales_equal_across_ranks"] \
                    and check[s + "_slot_qmax_127"]
        emit("parallel_tp_check", **check, card=card)
        if not ok:
            raise RuntimeError(f"TP {kind} ranks disagree with the unsharded engine: {check}")

    # 10c: a DP rank is a B=2 engine over its two rows: its tokens and audio
    # equal the unsharded B=2 engine's on those rows bit for bit.  Against
    # the unsharded B=4 engine's rows (other M and row-lane R in the int4 and
    # stage kernels, so other rounding, which the fed-back frames grow)
    # the tokens are equal and the distances are reported beside the one
    # between the unsharded B=2 and B=4 engines.
    b4 = refs["b4"]
    b2_audio = torch.cat([refs["b2_0"]["audio"], refs["b2_1"]["audio"]])
    dist_b4, bit_equal, tokens_ok = [], True, True
    for r, rk in enumerate(ranks):
        g, b2 = rk["dp"], refs[f"b2_{r}"]
        rows = slice(2 * r, 2 * r + 2)
        tokens_ok &= torch.equal(g["tokens"], b4["tokens"][rows])
        bit_equal &= torch.equal(g["tokens"], b2["tokens"]) and torch.equal(g["audio"], b2["audio"])
        dist_b4.append(dict(audio=rel_l2(g["audio"], b4["audio"][rows]),
                            first_frame=rel_l2(g["audio"][:, 0], b4["audio"][rows, 0])))
    emit("parallel_dp_check", equal_to_b2_engines=bit_equal, tokens_equal_b4=tokens_ok,
         rel_l2_vs_b4=dist_b4,
         b2_vs_b4=dict(audio=rel_l2(b2_audio, b4["audio"]),
                       first_frame=rel_l2(b2_audio[:, 0], b4["audio"][:, 0])),
         unsharded_b4_ms_per_frame=b4["ms_per_frame"],
         unsharded_b2_ms_per_frame=[refs["b2_0"]["ms_per_frame"], refs["b2_1"]["ms_per_frame"]],
         rank_ms_per_frame=[rk["dp"]["ms_per_frame"] for rk in ranks], card=card)
    if not (tokens_ok and bit_equal):
        raise RuntimeError("DP ranks disagree with the unsharded B=2 / B=4 engines")

    # 10d: every query row of both ranks against the plain version of flash
    # prefill over all rows in one process: CP runs the flash kernel at
    # row_offset rank * T/n over all T keys, so within one bf16 step of the
    # row's largest output, as the kernel is in phase 2; the ring's fp32
    # softmax, rounded once, and the plain version's (P rounded to bf16
    # before P.V) each lie within a step of the exact rows, so within two of
    # each other.  Reported beside: whether CP equals the kernel run over all
    # rows in one process
    for case, tol in (("cp", ROW_REL_TOL), ("ring", 2 * ROW_REL_TOL)):
        got = torch.cat([rk["cp"][case] for rk in ranks], dim=1)
        want = refs["flash_" + case]
        err, worst, med = agree_rows(case, got, want,
                                     torch.ones(got.shape[:2], dtype=torch.int32), tol=tol)
        emit("parallel_" + case + "_check", t=got.shape[1], against="flash_attention_prefill_ref",
             max_abs_err=err, worst_row_rel=worst, tol=tol, median_abs=med,
             equal_to_one_process_kernel=torch.equal(got, refs["kernel_" + case]), card=card)

    # each kernel's launches on each rank over phase 10, as counted: the
    # wrappers' counts (prefills, eager steps, the DP warm-up and capture,
    # the CP calls) plus the DP rank's graph replays times the kernel nodes
    # read from its graph.  B4 and B7 are one kernel function, so their
    # nodes are not told apart: both entries get their sum
    launches = {}
    for rk in ranks:
        tp, dp = rk["tp"], rk["dp"]
        per = {k: dp["prefill_launches"][k] + dp["step_launches"][k]
               + dp["replays"] * dp["graph_nodes"].get(k, 0) for k in kernel_counters()}
        per["fused_stage_chain"] += per["fused_stage_chain_rowlane"]
        per["fused_stage_chain_rowlane"] = per["fused_stage_chain"]
        per["decode_attention"] += sum(tp[w]["step_launches"]["decode_attention"]
                                       for w in ("bf16", "fp32"))
        per["decode_attention[int8 KV]"] = tp["int8"]["step_launches"]["decode_attention"]
        per["flash_attention_prefill"] += rk["cp"]["cp_launches"] + sum(
            tp[w]["prefill_launches"]["flash_attention_prefill"] for w in ("bf16", "fp32", "int8"))
        for k, v in per.items():
            launches.setdefault(k, []).append(v)
    emit("parallel_summary", seconds=time.perf_counter() - t_start, ranks_s=ranks_s,
         ranks=PAR_RANKS, backend="gloo", launches_per_rank=launches,
         dp_replays=[rk["dp"]["replays"] for rk in ranks],
         dp_graph_nodes=[rk["dp"]["graph_nodes"] for rk in ranks],
         merged=["fused_stage_chain", "fused_stage_chain_rowlane"], card=card)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the sharded training step, two ranks on one card over gloo
# ---------------------------------------------------------------------------

# the fp32 1.5B at full width with its LM cut to 4 layers (two whole copies
# with their gradients and Adam moments fit one card), a global batch of 2
# rows x 3 turns (556 and 554 tokens, padded to 576), two steps: lr 0, then
# 1e-4
SHARD_LAYERS, SHARD_TURNS, SHARD_STEPS = 4, 3, 2
SHARD_LR, SHARD_WD = 1e-4, 0.01
SHARD_RUNS = (("tp", 1, 2), ("dp", 2, 1))  # (name, data, model)
# the losses: fp32, the split reorders sums (the TP all-reduces, the DP
# loss shares) over 4 layers at hidden 1536 and ~10^5 diffusion terms
SHARD_LOSS_TOL = 1e-5
# the updates of step 2 (lr 1e-4): Adam's first moves are close to
# lr * sign(g), so a gradient element near 0 whose sign the reordered sums
# flip moves by up to 2 lr more or less than the unsharded step's; every
# element stays within that, and the mean difference of a leaf within 1% of
# lr (nearly every element agrees)
SHARD_UPDATE_MAX = 2 * SHARD_LR * (1 + 1e-3)
SHARD_UPDATE_MEAN = 1e-2 * SHARD_LR


def shard_train_cfg(layers=SHARD_LAYERS):
    """`vibevoice_1_5b()` with its LM cut to `layers` and the acoustic VAE
    sampling with fix_std 0 (the same latents on every rank and in the
    unsharded run)."""
    import dataclasses
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    cfg = vibevoice_1_5b()
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, num_hidden_layers=layers),
        acoustic_tokenizer=dataclasses.replace(cfg.acoustic_tokenizer, fix_std=0.0))


def shard_train_model(dev, root):
    """Phase 11's model (`shard_train_cfg`) and batch (2 rows x SHARD_TURNS
    turns of the demo voices): the config, a function that makes the seed's
    weights on `dev` with the whole batch's scaling statistics, and the
    batch."""
    import gc
    from vibevoice_tpu_torch import train as T
    from vibevoice_tpu_torch.models import vibevoice as V
    cfg = shard_train_cfg()
    init = lambda: V.init_model(cfg, dtype=torch.float32, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(SEED))
    params = init()
    batch = speech_batch(params, cfg, dev, root, turns=SHARD_TURNS)
    stats = T.init_scaling_stats(params, cfg, None, batch, device=dev)
    stats = {k: stats[k].detach().clone() for k in ("speech_scaling_factor",
                                                     "speech_bias_factor")}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    def make_params():
        p = init()
        p.update({k: v.clone() for k, v in stats.items()})
        return p
    return cfg, make_params, batch


def phase_train_graph_equal(dev, card, root):
    """The captured train step against the eager one on phase 11's model
    (`shard_train_cfg`: the fp32 1.5B at full width, its LM cut to 4
    layers), unsharded: from one set of weights, one batch and one
    generator seed, TRAIN_STEPS eager steps and TRAIN_STEPS captured ones,
    with injected noise and timesteps and then with drawn ones.  The losses
    of every step and every parameter afterwards must be bit-equal."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    cfg, make_params, batch = shard_train_model(dev, root)
    out = {}
    for noise in ("injected", "drawn"):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        runs = train_eager_vs_graph(cfg, make_params, batch, dev, TRAIN_STEPS,
                                    noise == "injected", lr=SHARD_LR)
        got = dict(bit_equal_runs(runs), **{k: runs["graph"][k]
                                            for k in ("captures", "replays", "capture_s")})
        del runs
        gc.collect()
        emit("train_graph_equal", model="vibevoice_1_5b", layers=SHARD_LAYERS, dtype="fp32",
             noise=noise, steps=TRAIN_STEPS, batch=list(batch.input_ids.shape),
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             seconds=time.perf_counter() - t0, card=card, **got)
        if not (got["losses_equal"] and got["leaves_differ"] == 0 and got["captures"] == 1
                and got["replays"] == TRAIN_STEPS - 1):
            raise RuntimeError(f"captured and eager train steps differ ({noise} noise): {got}")
        out[noise] = got
    return out


class ShardMarks(StepMarks):
    """StepMarks with the gradient all-reduce over `data` (the optimizer's
    `sync_grads`) split out of the optimizer: forward (the audio encode
    included), backward, all-reduce, optimizer."""

    PARTS = ("forward", "backward", "allreduce", "optimizer")

    def __enter__(self):
        self.saved_sync = self.opt.sync_grads
        self.opt.sync_grads = self._wrap(self.saved_sync, "backward_end", "allreduce_end")
        super().__enter__()
        self.opt.update = self._wrap(self.saved[2], None, "optimizer_end")
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.opt.sync_grads = self.saved_sync

    def parts_ms(self) -> dict:
        e = self.events
        ms = lambda a, b: e[a].elapsed_time(e[b])
        return {"forward": ms("start", "forward_end"),
                "backward": ms("forward_end", "backward_end"),
                "allreduce": ms("backward_end", "allreduce_end"),
                "optimizer": ms("allreduce_end", "optimizer_end"),
                "step": ms("start", "end")}


def shard_injected(batch, cfg, steps=SHARD_STEPS, seed=SEED):
    """Each step's injected diffusion noise and timesteps of the global batch."""
    rng = np.random.default_rng(seed)
    n = batch.speech_masks.size * cfg.diffusion_head.ddpm_batch_mul
    return [(rng.normal(size=(n, cfg.acoustic_vae_dim)).astype(np.float32),
             rng.integers(0, cfg.diffusion_head.ddpm_num_steps, n).astype(np.int32))
            for _ in range(steps)]


def _load_batch(path):
    from vibevoice_tpu_torch.train import TrainBatch
    with np.load(path) as f:
        return TrainBatch(*(f[k] for k in TrainBatch._fields))


def _shard_ranks(rank, dev, work, card, stats):
    """Phase 11 on this rank: for each of SHARD_RUNS a mesh, this rank's
    shard of the seed's weights and share of the global batch, two
    `train_step`s timed by parts, then every leaf's move held against the
    unsharded step's (`ref.pt`, the trained leaves' updates in the whole
    layout) and the frozen tokenizers' decay; no kernel launches."""
    import gc
    from vibevoice_tpu_torch import data as D, train as T
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.parallel import make_mesh, model_param_specs, shard_params
    from vibevoice_tpu_torch.parallel import split_dims
    cfg = shard_train_cfg()
    batch = _load_batch(os.path.join(work, "batch.npz"))
    inj = shard_injected(batch, cfg)
    ref = torch.load(os.path.join(work, "ref.pt"), mmap=True, weights_only=False)
    counters = kernel_counters()
    out = {}
    for name, data, model in SHARD_RUNS:
        mesh = make_mesh(data=data, model=model)
        torch.cuda.reset_peak_memory_stats()
        params = V.init_model(cfg, dtype=torch.float32, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED))
        params["speech_scaling_factor"] = torch.tensor(stats[0], device=dev)
        params["speech_bias_factor"] = torch.tensor(stats[1], device=dev)
        dims = split_dims(params, model_param_specs(params, cfg), "model")
        local = shard_params(params, mesh, cfg=cfg)
        del params
        gc.collect()
        mine = D.shard_batch(batch, mesh)
        averaged = T.init_scaling_stats(local, cfg, None, mine, device=dev, mesh=mesh)
        averaged = (averaged["speech_scaling_factor"].item(),
                    averaged["speech_bias_factor"].item())
        frozen_ids = {id(p) for k in FROZEN for p in _tensors(local[k])}
        opt = T.make_optimizer(local, lr=SHARD_LR, weight_decay=SHARD_WD, warmup_steps=1,
                               total_steps=100, mesh=mesh,
                               specs=model_param_specs(local, cfg))
        step = T.make_train_step(cfg, opt, device=dev, mesh=mesh, eager=True)
        before = [p.detach().to("cpu", copy=True) for p in opt.leaves]
        for c in counters.values():
            c.launches = 0
        losses, parts = [], []
        for i, (noise, t) in enumerate(inj):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ShardMarks(V, opt) as marks:
                m = step(local, mine, None, noise, t)
            losses.append({k: float(v) for k, v in m.items()})
            wall = time.perf_counter() - t0
            parts.append(dict(marks.parts_ms(), wall_ms=1e3 * wall))
        launched = {k: c.launches for k, c in counters.items() if c.launches}
        peak = torch.cuda.max_memory_allocated()
        lr2 = opt.schedule(1)
        factor = np.float32(1.0 - lr2 * SHARD_WD)
        m_idx = mesh.axis_index("model")
        worst = {"split": [0.0, 0.0], "whole": [0.0, 0.0]}
        frozen_rel, frozen_bit_equal, n_frozen = 0.0, True, 0
        for j, (p, w) in enumerate(zip(opt.leaves, before)):
            w = w.to(dev)
            if id(p) in frozen_ids:
                n_frozen += 1
                want = w * float(factor) if p.dim() > 1 else w
                frozen_bit_equal &= torch.equal(p.detach(), want)
                frozen_rel = max(frozen_rel, float(
                    ((p.detach() - want).abs() / want.abs().clamp_min(1e-30)).max()))
                continue
            upd = p.detach() - w
            want = ref[j]
            if dims[j] is not None:
                n = want.shape[dims[j]] // model
                want = want.narrow(dims[j], m_idx * n, n)
            diff = (upd - want.to(dev)).abs()
            key = "split" if dims[j] is not None else "whole"
            worst[key][0] = max(worst[key][0], float(diff.max()))
            worst[key][1] = max(worst[key][1], float(diff.mean()))
            del w, upd, want, diff
        emit("train_sharded_rank", run=name, rank=rank, mesh=dict(mesh.shape),
             rows=int(mine.input_ids.shape[0]), clips=int(mine.speech_masks.shape[0]),
             losses=losses, steps_ms=parts, max_memory_allocated=peak,
             update_max_abs_diff={k: v[0] for k, v in worst.items()},
             update_worst_leaf_mean_abs_diff={k: v[1] for k, v in worst.items()},
             frozen_leaves=n_frozen, frozen_decay_max_rel_err=frozen_rel,
             frozen_decay_bit_equal=frozen_bit_equal, scaling_stats_averaged=averaged,
             kernel_launches=launched, note="gloo on one card: not a TP or DP speed",
             card=card)
        out[name] = dict(losses=losses, parts=parts, peak=peak, worst=worst,
                         frozen_rel=frozen_rel, n_frozen=n_frozen, launched=launched,
                         averaged=averaged, q_width=int(local["lm"]["layers"][0]["q"]["w"]
                                                        .shape[1]))
        del opt, step, local, before, mine, marks
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train_sharded(dev, card, root):
    """Phase 11: the sharded training step as two gloo ranks on this card.
    This process first takes SHARD_STEPS unsharded steps of the fp32 1.5B
    (full width, LM cut to SHARD_LAYERS) on the global batch and keeps each
    trained leaf's update, releases the model, then spawns two ranks that
    run 11a TP=2 (data 1, model 2) and 11b DP=2 (data 2, model 1) from the
    same weights, batch and injected noise.  Holds: every rank's losses
    equal each other's and the unsharded step's within SHARD_LOSS_TOL;
    every gathered update within SHARD_UPDATE_MAX of the unsharded one and
    each leaf's mean difference within SHARD_UPDATE_MEAN; the frozen
    tokenizers' (1 - lr*wd) decay exact; the DP ranks' averaged scaling
    statistics the mean of their shares'; no kernel launches."""
    import gc
    import shutil
    import tempfile
    from vibevoice_tpu_torch import data as D, train as T
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.parallel.mesh import Mesh
    gc.collect()
    torch.cuda.empty_cache()
    cfg = shard_train_cfg()
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = V.init_model(cfg, dtype=torch.float32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    batch = speech_batch(params, cfg, dev, root, turns=SHARD_TURNS)
    if batch.input_ids.shape != (TRAIN_ROWS, 576):
        raise RuntimeError(f"phase 11 batch {batch.input_ids.shape}, want (2, 576)")
    # each DP rank's share's statistics, averaged: what the ranks must get
    shares = [T.init_scaling_stats(params, cfg, None,
                                   D.shard_batch(batch, Mesh(2, 1, rank=r, groups={})),
                                   device=dev) for r in range(2)]
    share_mean = tuple(float(np.mean([s[k].item() for s in shares]))
                       for k in ("speech_scaling_factor", "speech_bias_factor"))
    del shares
    params = T.init_scaling_stats(params, cfg, None, batch, device=dev)
    stats = (params["speech_scaling_factor"].item(), params["speech_bias_factor"].item())
    frozen_ids = {id(p) for k in FROZEN for p in _tensors(params[k])}
    opt = T.make_optimizer(params, lr=SHARD_LR, weight_decay=SHARD_WD, warmup_steps=1,
                           total_steps=100)
    step = T.make_train_step(cfg, opt, device=dev, eager=True)
    trained = [j for j, p in enumerate(opt.leaves) if id(p) not in frozen_ids]
    before = {j: opt.leaves[j].detach().to("cpu", copy=True) for j in trained}
    losses, parts = [], []
    for noise, t in shard_injected(batch, cfg):
        with ShardMarks(V, opt) as marks:
            losses.append({k: float(v) for k, v in step(params, batch, None, noise, t).items()})
        parts.append(marks.parts_ms())
    ref = {j: opt.leaves[j].detach().cpu() - before[j] for j in trained}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in opt.leaves)
    del opt, step, params, before, marks
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_sharded_reference", model="vibevoice_1_5b", layers=SHARD_LAYERS, dtype="fp32",
         params=n_params, batch=list(batch.input_ids.shape), clips=batch.speech_masks.shape[0],
         frames=int(batch.speech_masks.sum()), speech_scaling_factor=stats[0],
         speech_bias_factor=stats[1], losses=losses, steps_ms=parts,
         max_memory_allocated=peak, allocated_after=torch.cuda.memory_allocated(),
         seconds=time.perf_counter() - t_start, card=card)

    work = tempfile.mkdtemp(prefix="vv_train_sharded_")
    try:
        np.savez(os.path.join(work, "batch.npz"), **batch._asdict())
        torch.save(ref, os.path.join(work, "ref.pt"))
        del ref
        t0 = time.perf_counter()
        ranks = spawn_ranks(_gloo_rank, PAR_RANKS, work, (_shard_ranks, work, card, stats),
                            PAR_TIMEOUT_S, "phase 11")
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    cfg_dec = cfg.decoder
    for name, data, model in SHARD_RUNS:
        got = [rk[name] for rk in ranks]
        loss_err = max(abs(g["losses"][i][k] - losses[i][k]) / abs(losses[i][k])
                       for g in got for i in range(SHARD_STEPS) for k in losses[i])
        same = all(g["losses"] == got[0]["losses"] for g in got)
        upd_max = max(max(v[0] for v in g["worst"].values()) for g in got)
        upd_mean = max(max(v[1] for v in g["worst"].values()) for g in got)
        frozen_rel = max(g["frozen_rel"] for g in got)
        launched = [g["launched"] for g in got]
        q_want = cfg_dec.num_attention_heads * cfg_dec.head_dim // model
        check = dict(run=name, data=data, model=model, loss_max_rel_err=loss_err,
                     loss_tol=SHARD_LOSS_TOL, ranks_losses_equal=same,
                     update_max_abs_diff=upd_max, update_tol=SHARD_UPDATE_MAX,
                     update_leaf_mean_abs_diff=upd_mean, update_mean_tol=SHARD_UPDATE_MEAN,
                     frozen_decay_max_rel_err=frozen_rel,
                     frozen_leaves=[g["n_frozen"] for g in got],
                     q_widths=[g["q_width"] for g in got], kernel_launches=launched,
                     peak_bytes=[g["peak"] for g in got],
                     unsharded_peak_bytes=peak,
                     steps_ms=[g["parts"] for g in got], unsharded_steps_ms=parts,
                     note="gloo on one card: not a TP or DP speed", card=card)
        ok = (loss_err <= SHARD_LOSS_TOL and same and upd_max <= SHARD_UPDATE_MAX
              and upd_mean <= SHARD_UPDATE_MEAN and frozen_rel <= 2.0 ** -23
              and not any(launched) and all(w == q_want for w in check["q_widths"]))
        if name == "dp":
            avg = [g["averaged"] for g in got]
            check["scaling_stats_averaged"] = avg
            check["scaling_stats_share_mean"] = share_mean
            stat_err = max(abs(a[k] - share_mean[k]) / abs(share_mean[k])
                           for a in avg for k in (0, 1))
            check["scaling_stats_max_rel_err"] = stat_err
            ok = ok and stat_err <= 1e-5
        emit("train_sharded_check", **check)
        if not ok:
            raise RuntimeError(f"phase 11 {name} ranks disagree with the unsharded step: "
                               f"{check}")
    emit("train_sharded_summary", seconds=time.perf_counter() - t_start, ranks_s=ranks_s,
         ranks=PAR_RANKS, backend="gloo", card=card)
    return ranks


def _tiny_tp_train_rank(rank, dev, work, steps):
    """One rank of `phase_train_sharded_reference`: the tiny untied model's
    TP=2 steps on `dev` and then on the CPU; the losses and every leaf."""
    import copy
    from vibevoice_tpu_torch import train as T
    from vibevoice_tpu_torch.parallel import make_mesh, model_param_specs, shard_params
    from vibevoice_tpu_torch.weights import to_device
    cfg, params = tiny_untied(torch.Generator().manual_seed(SEED))
    batch = tiny_train_batch(cfg)
    inj = shard_injected(batch, cfg, steps)
    mesh = make_mesh(data=1, model=2)
    local = shard_params(params, mesh, cfg=cfg)
    out = {}
    for where in (dev, torch.device("cpu")):
        p = to_device(copy.deepcopy(local), where)
        opt = T.make_optimizer(p, lr=1e-2, warmup_steps=1, total_steps=10, mesh=mesh,
                               specs=model_param_specs(p, cfg))
        step = T.make_train_step(cfg, opt, device=where, mesh=mesh, eager=True)
        losses = [{k: float(v) for k, v in step(p, batch, None, nz, ts).items()}
                  for nz, ts in inj]
        out[where.type] = (losses, [x.detach().cpu() for x in opt.leaves])
    return out


def tiny_untied(gen):
    """`tiny_config(vocab_size=320)` with an untied `lm_head` (split by
    column under TP) and the VAE at fix_std 0, and its params on the CPU
    with a live audio path."""
    import dataclasses
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import vibevoice as V
    cfg = tiny_config(vocab_size=320)
    cfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, tie_word_embeddings=False),
        acoustic_tokenizer=dataclasses.replace(cfg.acoustic_tokenizer, fix_std=0.0))
    params = V.init_model(cfg, generator=gen, device="cpu")
    _live_audio_path(params, gen)
    return cfg, params


def phase_train_sharded_reference(dev, steps=2):
    """The tiny untied model's TP=2 train steps as two gloo ranks, on the
    card and on the CPU in each rank: the losses and every leaf afterwards
    agree within TRAIN_REL_TOL.  Returns the largest relative
    disagreements."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="vv_tiny_tp_train_")
    try:
        ranks = spawn_ranks(_gloo_rank, PAR_RANKS, work, (_tiny_tp_train_rank, work, steps),
                            PAR_TIMEOUT_S, "tiny TP train")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    loss_err = param_err = 0.0
    for rk in ranks:
        (l_gpu, p_gpu), (l_cpu, p_cpu) = rk["cuda"], rk["cpu"]
        loss_err = max(loss_err, max(abs(g[k] - w[k]) / abs(w[k])
                                     for g, w in zip(l_gpu, l_cpu) for k in w))
        param_err = max(param_err, max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                                       1.0)
                                       for g, w in zip(p_gpu, p_cpu)))
    emit("train_sharded_tiny_reference", model="tiny_config(vocab_size=320), untied lm_head",
         mesh={"data": 1, "model": 2}, steps=steps, losses=[rk["cuda"][0] for rk in ranks],
         loss_max_rel_err=loss_err, param_max_rel_err=param_err, tol=TRAIN_REL_TOL)
    if not (loss_err <= TRAIN_REL_TOL and param_err <= TRAIN_REL_TOL):
        raise RuntimeError(f"TP training on the card and on the CPU disagree: losses "
                           f"{loss_err}, params {param_err} > {TRAIN_REL_TOL}")
    return loss_err, param_err


# ---------------------------------------------------------------------------
# phase 11c: the captured sharded step over an NCCL group of one rank
# ---------------------------------------------------------------------------

MESH_TURNS = (("unsharded", False, False), ("graph", True, False), ("eager", True, True))


def node_counts(names) -> dict:
    """A captured graph's nodes (`graph_kernels`): kernel nodes, the NCCL
    kernels among them, and the other nodes (copies, fills, memsets)."""
    kernels = [n for n in names if not n.startswith("graph node of type")]
    return dict(kernel_nodes=len(kernels), nccl_nodes=sum("nccl" in n.lower() for n in kernels),
                other_nodes=len(names) - len(kernels))


def mesh_train_turns(cfg, make_params, batch, inj, dev, mesh, lr=SHARD_LR):
    """`train_turns` with injected noise in three turns: "unsharded"
    (captured, no mesh), "graph" (captured on `mesh`) and "eager"
    (`eager=True` on `mesh`)."""
    return train_turns(cfg, make_params, batch, dev, inj,
                       [(n, mesh if on_mesh else None, eager) for n, on_mesh, eager in MESH_TURNS],
                       lr=lr)


def compare_mesh_turns(runs) -> dict:
    """`mesh_train_turns`' turns compared: the mesh's captured and eager
    turns bit-equal (`bit_equal_runs`), and each against the unsharded
    captured turn: the largest relative loss difference, and of each leaf
    (from the same start: the difference of the updates) the largest and
    the worst leaf's mean absolute difference."""
    out = bit_equal_runs(runs, "graph", "eager")
    u = runs["unsharded"]
    for turn in ("graph", "eager"):
        r = runs[turn]
        loss = max(float(((a.double() - b.double()).abs() / b.double().abs()).max())
                   for a, b in zip(r["losses"], u["losses"]))
        diffs = [(a - b).abs() for a, b in zip(r["leaves"], u["leaves"])]
        out[turn + "_vs_unsharded"] = dict(
            loss_max_rel_err=loss, update_max_abs_diff=max(float(d.max()) for d in diffs),
            update_leaf_mean_abs_diff=max(float(d.mean()) for d in diffs))
    return out


def _nccl_rank(rank, world, store, out_dir, fn, *args):
    """A spawned rank of an NCCL default group on `cuda:0` (one rank a
    card): `fn(rank, dev, *args)`'s result saved to `out_dir`; a failure
    leaves its traceback there and a non-zero exit."""
    import datetime
    import traceback
    import torch.distributed as dist
    try:
        from vibevoice_tpu_torch.device import resolve_device
        torch.cuda.set_device(0)
        dev = resolve_device("cuda")
        dist.init_process_group("nccl", init_method="file://" + store, world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
        out = fn(rank, dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def one_rank_nccl_mesh():
    """The (1, 1) mesh over an NCCL default group of one rank, with that group
    as both its `data` and its `model` group: every collective the sharded
    step guards with `mesh.group(...)` is issued, over NCCL."""
    import torch.distributed as dist
    from vibevoice_tpu_torch.parallel.mesh import Mesh
    g = dist.group.WORLD
    return Mesh(1, 1, rank=0, groups={"data": g, "model": g})


def _train_nccl_rank(rank, dev, root):
    """Phase 11c's child: phase 11's model and batch (`shard_train_model`),
    SHARD_STEPS steps
    of injected noise in `mesh_train_turns` on `one_rank_nccl_mesh()`."""
    cfg, make_params, batch = shard_train_model(dev, root)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = mesh_train_turns(cfg, make_params, batch, shard_injected(batch, cfg), dev,
                            one_rank_nccl_mesh())
    got = compare_mesh_turns(runs)
    return dict(got, batch=list(batch.input_ids.shape),
                losses_unsharded=[x.tolist() for x in runs["unsharded"]["losses"]],
                graph={k: runs["graph"][k] for k in ("captures", "replays", "capture_s")},
                nodes=[node_counts(n) for n in runs["graph"]["nodes"]],
                unsharded_nodes=[node_counts(n) for n in runs["unsharded"]["nodes"]],
                eager_step_collectives=runs["eager"]["collectives"],
                kernel_launches={k: c.launches for k, c in counters.items() if c.launches},
                max_memory_allocated=torch.cuda.max_memory_allocated())


def phase_train_graph_nccl(dev, card, root):
    """Phase 11c: the sharded step captured over NCCL, in a spawned child
    whose NCCL default group holds one rank (NCCL refuses two ranks on one
    card): on `one_rank_nccl_mesh()` and phase 11's model, SHARD_STEPS
    captured and SHARD_STEPS eager steps from the same weights, batch and
    injected noise must be bit-equal (losses, every leaf), and both within
    phase 11's tolerances of the unsharded captured step (the clip sums its
    split and whole leaves' squares apart, so not bit-equal to it).  Prints
    the graph's kernel, NCCL and other nodes.  A one-rank communicator shows
    that the step's NCCL work is captured on this card image, not a TP or DP
    speed."""
    import gc
    import shutil
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="vv_train_nccl_")
    try:
        got = spawn_ranks(_nccl_rank, 1, work, (_train_nccl_rank, root), PAR_TIMEOUT_S,
                          "phase 11c")[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("train_graph_nccl", model="vibevoice_1_5b", layers=SHARD_LAYERS, dtype="fp32",
         mesh={"data": 1, "model": 1}, backend="nccl", ranks=1, steps=SHARD_STEPS,
         loss_tol=SHARD_LOSS_TOL, update_tol=SHARD_UPDATE_MAX,
         update_mean_tol=SHARD_UPDATE_MEAN, seconds=time.perf_counter() - t0,
         note="one NCCL rank: the collectives are captured, not a TP or DP speed",
         card=card, **got)
    ok = (got["losses_equal"] and got["leaves_differ"] == 0 and not got["kernel_launches"]
          and got["graph"]["captures"] == 1 and got["graph"]["replays"] == SHARD_STEPS - 1)
    for turn in ("graph", "eager"):
        d = got[turn + "_vs_unsharded"]
        ok = ok and (d["loss_max_rel_err"] <= SHARD_LOSS_TOL
                     and d["update_max_abs_diff"] <= SHARD_UPDATE_MAX
                     and d["update_leaf_mean_abs_diff"] <= SHARD_UPDATE_MEAN)
    if not ok:
        raise RuntimeError(f"phase 11c: the captured sharded step over NCCL fails: {got}")
    return got


# ---------------------------------------------------------------------------
# phase 12: the caption and quality-evaluation path through the port's CLIs
# ---------------------------------------------------------------------------

QUALITY_STEPS = 32
QUALITY_DDPM = 5
# None: `--canonical`, the harness's fifteen candidates
QUALITY_CANDIDATES = None
CAPTION_SLOTS = 4096  # prompt + steps: the decode-attention kernel's cache
BATCH_STEPS = 48
BATCH_LINES = ("Speaker 1: Here are the markets this morning, in brief.",
               "Speaker 1: A second script, read in the same batch as the first one.\n"
               "Speaker 2: With a second speaker, who answers it.",
               "Speaker 1: The third script runs alone, in a batch of its own.")


class PathRecorder:
    """While active: `VibeVoiceTTS._engine` hands out force-diffusion engines
    (built as `register_forced_engine` builds them; random weights almost
    never pick the diffusion token), and each `VibeVoiceTTS.generate` call
    is recorded: its engine's shape and flags, the wrappers' launches during
    the call, the captured step's kernel nodes, the replays, and its steps
    and timing.  `from_pretrained` calls are timed.  `on_step`, when set,
    is handed to every `generate` call."""

    def __init__(self, tts_cls, G):
        self.cls, self.G = tts_cls, G
        self.calls, self.loads, self.on_step = [], [], None
        self._engine = self._generate = self._from_pretrained = None
        self._current = None

    def __enter__(self):
        rec, G = self, self.G
        self._engine, self._generate = self.cls._engine, self.cls.generate
        self._from_pretrained = self.cls.__dict__["from_pretrained"]

        def engine(tts, batch, prompt_len, max_steps):
            bucket = max(tts.prompt_bucket,
                         -(-prompt_len // tts.prompt_bucket) * tts.prompt_bucket)
            key = (batch, bucket, max_steps)
            if key not in tts._engines:
                gen = G.GenerationConfig(
                    speech_start_id=tts.tokenizer.speech_start_id,
                    speech_end_id=tts.tokenizer.speech_end_id,
                    speech_diffusion_id=tts.tokenizer.speech_diffusion_id,
                    eos_id=tts.tokenizer.eos_id, cfg_scale=tts.cfg_scale,
                    ddpm_steps=tts.ddpm_steps, algorithm_type=tts.algorithm_type,
                    force_diffusion=True, max_length_times=64.0)
                tts._engines[key] = G.Engine(
                    tts.params, tts.cfg, gen, max_steps=max_steps, batch=batch,
                    prompt_len=bucket, dtype=tts.dtype, kv_dtype=tts.kv_dtype,
                    device=tts.device, use_fused_stages=tts.use_fused_stages)
            eng = tts._engines[key]
            rec._current = (eng, eng.graph is not None, eng.replays)
            return eng

        def generate(tts, *args, **kw):
            counters = kernel_counters()
            for c in counters.values():
                c.launches = 0
            if rec.on_step is not None:
                kw["on_step"] = rec.on_step
            res, metrics = rec._generate(tts, *args, **kw)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            eng, had_graph, replays0 = rec._current
            rec._current = None
            nodes, _ = graph_launches(eng.graph)
            captured = not had_graph and eng.graph is not None
            replays = eng.replays - replays0
            # on the device: the wrappers' launches but the captured step's
            # (capturing runs nothing), and each replay's kernel nodes
            device = merge_stages(launches)
            for k, n in nodes.items():
                device[k] += replays * n - (n if captured else 0)
            rec.calls.append(dict(
                batch=eng.batch, prompt_len=eng.prompt_len, cache_slots=eng.cache_len,
                flash_prefill=eng.use_flash_prefill, flash_decode=eng.use_flash_decode,
                codec=codec_launches(eng), head_pack="_diffusion_head_packq" in eng.params,
                steps=res.steps, captured=captured, capture_s=eng.capture_s if captured else None,
                replays=replays, launches=launches, graph_nodes=nodes, device_launches=device,
                wall_s=metrics["wall_s"], audio_sec=metrics["audio_sec"], rtf=metrics["rtf"],
                engine=eng))
            return res, metrics

        def from_pretrained(cls, *args, **kw):
            t0 = time.perf_counter()
            tts = rec._from_pretrained.__func__(cls, *args, **kw)
            torch.cuda.synchronize()
            rec.loads.append(time.perf_counter() - t0)
            return tts

        self.cls._engine, self.cls.generate = engine, generate
        self.cls.from_pretrained = classmethod(from_pretrained)
        return self

    def __exit__(self, *exc):
        self.cls._engine, self.cls.generate = self._engine, self._generate
        self.cls.from_pretrained = self._from_pretrained
        return False

    def check(self, cfg, call, quant, what):
        """The call's launches against `expected_launches` for its engine:
        through the wrappers the prefill's (and, in the call that captured,
        the warm-up step's and the captured step's), the graph's kernel nodes
        one step's.  Drops the call's engine."""
        eng = call.pop("engine")
        head = eng.gen.ddpm_steps if call["head_pack"] else 0
        want_prefill, want_step = expected_launches(cfg, quant, eng, head=head)
        want = {k: want_prefill[k] + (2 if call["captured"] else 0) * want_step[k]
                for k in want_prefill}
        if call["launches"] != want or call["graph_nodes"] != merge_stages(want_step):
            raise RuntimeError(f"{what}: launches {call['launches']}, want {want}; graph "
                               f"nodes {call['graph_nodes']}, want {merge_stages(want_step)}")
        if call["replays"] + (1 if call["captured"] else 0) + 1 != call["steps"]:
            raise RuntimeError(f"{what}: {call['replays']} replays for {call['steps']} steps")
        call["launches_per_step"] = want_step
        return call


def wav_file(path, want_samples: int, what: str) -> np.ndarray:
    """The samples (as floats) of a mono 24 kHz PCM16 wav file; raises unless
    it holds exactly `want_samples` samples, not all zero (as `wav_pcm`)."""
    with open(path, "rb") as f:
        pcm = wav_pcm(f.read(), what, want_samples, stream=False)
    return pcm.astype(np.float64) / 32767


def check_captions(files, duration, what):
    """The SRT, VTT and JSON beside the wav: present, one cue per JSON
    segment, the segments in order inside [0, duration] and ending at it;
    with no ffmpeg (the WPM rung) they start at 0 and none overlaps the
    next."""
    import shutil
    for ext in ("srt", "vtt", "json"):
        if not os.path.isfile(files.get(ext, "")):
            raise RuntimeError(f"{what}: no {ext} caption file")
    with open(files["json"]) as f:
        segs = json.load(f)["segments"]
    with open(files["srt"]) as f:
        srt_cues = f.read().count(" --> ")
    with open(files["vtt"]) as f:
        vtt_cues = f.read().count(" --> ")
    end = round(duration, 3)
    wpm = shutil.which("ffmpeg") is None
    ok = (segs and srt_cues == vtt_cues == len(segs) and segs[-1]["end"] == end
          and all(0 <= s["start"] <= s["end"] <= end for s in segs)
          and all(a["start"] <= b["start"] for a, b in zip(segs, segs[1:])))
    if wpm:
        ok = ok and segs[0]["start"] == 0 and all(
            a["end"] <= b["start"] for a, b in zip(segs, segs[1:]))
    if not ok:
        raise RuntimeError(f"{what}: caption segments {segs} do not tile [0, {end}] "
                           f"({srt_cues} SRT / {vtt_cues} VTT cues)")
    return dict(segments=len(segs), rung="words-per-minute" if wpm else "ffmpeg available",
                first=segs[0], last=segs[-1])


def write_live_checkpoint(ckpt, dev, card):
    """A full-width 1.5B bf16 checkpoint in `ckpt` (random, from the seed,
    with a live audio path), by phase 8's writer: phases 12 and 13 load it
    through `--model_path`."""
    import gc
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.models import vibevoice as V
    bf = torch.bfloat16
    cfg = vibevoice_1_5b()
    os.makedirs(ckpt)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    src = V.init_model(cfg, dtype=bf, device=dev, generator=gen)
    _live_audio_path(src, gen)
    for k in ("speech_scaling_factor", "speech_bias_factor"):
        src[k] = src[k].to(bf)
    t0 = time.perf_counter()
    size = write_checkpoint(ckpt, src, cfg)
    emit("captions_checkpoint", bytes=size, write_s=time.perf_counter() - t0, card=card)
    del src
    gc.collect()
    torch.cuda.empty_cache()


def phase_captions_quality(dev, card, root, ckpt):
    """The caption and quality-evaluation path, as users run it, on the
    full-width 1.5B bf16 checkpoint `ckpt` (`write_live_checkpoint`)
    loaded through `--model_path`, the engines forced to diffuse
    (`PathRecorder`):
    12a `scripts.quality_eval.main` with the canonical candidates (or
    QUALITY_CANDIDATES), 5 solver steps and 32 new tokens on the builtin
    two-speaker script: every metric finite, the verdict's three ladders,
    and each candidate's kernels (B2 in int4/int4f, B3 in int4k, B4 in fs,
    B8 in dh4) at `expected_launches`' counts;
    12b `demo.inference_simple_captions.main` on a four-speaker script of the
    demo voices (a prompt past 1024 tokens: flash prefill) with steps to a
    4096-slot cache (decode attention), a `FrameClockCaptionTracker` fed by
    the same `generate` call: a mono 24 kHz wav, finite and not silent, its
    SRT, VTT and JSON tiling it, the tracker's clock the steps' audio;
    12c `demo.batch_inference_simple_captions.main` on three scripts at
    --batch_size 2: one `Saved audio to:` line per script, each file there.
    Returns the launches that ran on the device, by kernel, over the phase."""
    import contextlib
    import gc
    import io
    import tempfile
    from vibevoice_tpu_torch.caption.simple import FrameClockCaptionTracker
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.demo import batch_inference_simple_captions as batch_cli
    from vibevoice_tpu_torch.demo import inference_simple_captions as caption_cli
    from vibevoice_tpu_torch.demo.inference_from_file import VoiceMapper, parse_txt_script
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.processor import VibeVoiceProcessor
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    from vibevoice_tpu_torch.scripts import quality_eval as QE
    cfg = vibevoice_1_5b()
    hop = cfg.speech_compress_ratio
    t_phase = time.perf_counter()
    # every row is B=1 or B=2 without the fused stages: no row-lane call
    total = dict(merge_stages(dict.fromkeys(kernel_counters(), 0)),
                 fused_stage_chain_rowlane=0)

    def add(call):
        if call["launches"]["fused_stage_chain_rowlane"]:
            raise RuntimeError(f"a row-lane stage call on the caption path: {call}")
        for k, v in call["device_launches"].items():
            total[k] += v

    with tempfile.TemporaryDirectory() as work:
        # 12a: the quality harness over the candidates
        cands = QUALITY_CANDIDATES or QE.CANONICAL_CANDIDATES
        argv = ["--model_path", ckpt, "--ddpm_steps", str(QUALITY_DDPM), "--max_new_tokens",
                str(QUALITY_STEPS), "--output_dir", os.path.join(work, "quality")]
        argv += ["--canonical"] if QUALITY_CANDIDATES is None else ["--candidates", *cands]
        t0 = time.perf_counter()
        with PathRecorder(VibeVoiceTTS, G) as rec, contextlib.redirect_stdout(io.StringIO()):
            results = QE.main(argv)
        quality_s = time.perf_counter() - t0
        names = ["bf16"] + list(cands)
        if len(rec.calls) != len(names) or len(rec.loads) != len(names):
            raise RuntimeError(f"quality_eval made {len(rec.calls)} requests and "
                               f"{len(rec.loads)} loads for {len(names)} configurations")
        per = {}
        for name, call, load_s in zip(names, rec.calls, rec.loads):
            modes = {} if name == "bf16" else QE.CANDIDATES[name]
            call = rec.check(cfg, call, modes.get("quantize"), f"12a {name}")
            add(call)
            m = {} if name == "bf16" else results[f"{name}/builtin_smoke"]
            if name != "bf16" and not all(isinstance(m[k], float) and np.isfinite(m[k])
                                          for k in ("mel_l2", "lsd_db", "snr_db")):
                raise RuntimeError(f"12a {name}: metrics not finite: {m}")
            per[name] = dict(from_pretrained_s=load_s, rtf=call["rtf"], wall_s=call["wall_s"],
                             audio_sec=call["audio_sec"], steps=call["steps"],
                             capture_s=call["capture_s"],
                             **{k: m[k] for k in ("mel_l2", "lsd_db", "snr_db") if k in m},
                             launches_per_step={k: v for k, v in call["launches_per_step"]
                                                .items() if v})
        kernels_in = {k: [n for n in names if per[n]["launches_per_step"].get(k)]
                      for k in ("int4_matmul", "fused_block_chain_batched",
                                "fused_stage_chain", "fused_head_solver_step")}
        if not all(kernels_in.values()):
            raise RuntimeError(f"12a: a kernel ran in no candidate: {kernels_in}")
        verdict = results["verdict"]
        if set(verdict["recommended"]) != {"B1", "B>=2", "tokenizer"} or \
                set(verdict["verdicts"]) != set(cands):
            raise RuntimeError(f"12a: the verdict lacks its ladders: {verdict}")
        base_rtf = per["bf16"]["rtf"]
        emit("quality_eval", canonical=QUALITY_CANDIDATES is None, candidates=len(cands),
             ddpm_steps=QUALITY_DDPM, max_new_tokens=QUALITY_STEPS, seconds=quality_s,
             per_candidate=per, rtf_vs_bf16={n: per[n]["rtf"] / base_rtf for n in names},
             kernels_in=kernels_in, recommended=verdict["recommended"],
             passed=sorted(c for c, v in verdict["verdicts"].items() if v["pass"]),
             note="random weights: a test of the plumbing, not a quality statement",
             card=card)
        del rec, results
        gc.collect()
        torch.cuda.empty_cache()

        # 12b: the caption CLI on a four-speaker podcast to a 4096-slot cache
        names4 = ("Alice", "Bob", "Carol", "Dave")
        lines = "\n".join(f"Speaker {names4[i % 4]}: {line}"
                          for i, line in enumerate(FOUR_SPEAKER_LINES))
        txt = os.path.join(work, "roundtable.txt")
        with open(txt, "w", encoding="utf-8") as f:
            f.write(lines + "\n")
        script, speakers = parse_txt_script(lines)
        mapper = VoiceMapper()
        voices = [mapper.get_voice_path(s) for s in speakers]
        if len(set(voices)) != 4:
            raise RuntimeError(f"the four speakers map to {voices}")
        proc = VibeVoiceProcessor.from_pretrained(ckpt, tokenizer=ByteFallbackTokenizer())
        t_prompt = proc(script, voices).input_ids.shape[1]
        bucket = -(-t_prompt // 256) * 256
        steps = CAPTION_SLOTS - bucket
        tracker = FrameClockCaptionTracker(
            [(f"Speaker {sid + 1}", t.strip()) for sid, t in proc._parse_script(script)],
            speech_end_id=ByteFallbackTokenizer().speech_end_id, hop=hop)
        out_dir = os.path.join(work, "captions")
        t0 = time.perf_counter()
        with PathRecorder(VibeVoiceTTS, G) as rec, contextlib.redirect_stdout(io.StringIO()):
            rec.on_step = tracker.update
            out = caption_cli.main(["--model_path", ckpt, "--txt_path", txt, "--output_dir",
                                    out_dir, "--ddpm_steps", str(QUALITY_DDPM),
                                    "--max_new_tokens", str(steps)])
        caption_s = time.perf_counter() - t0
        (call,) = rec.calls
        call = rec.check(cfg, call, None, "12b")
        add(call)
        if not (call["flash_prefill"] and call["flash_decode"] and t_prompt >= 1024
                and call["cache_slots"] >= CAPTION_SLOTS and call["steps"] == steps):
            raise RuntimeError(f"12b is off the flash prefill / decode attention path: "
                               f"prompt {t_prompt}, {call}")
        if not (call["launches"]["flash_attention_prefill"] == cfg.decoder.num_hidden_layers
                and call["graph_nodes"]["decode_attention"] == cfg.decoder.num_hidden_layers):
            raise RuntimeError(f"12b: flash prefill / decode attention launches {call}")
        files = out["files"]
        pcm = wav_file(files["wav"], steps * hop, "12b")
        duration = len(pcm) / 24000.0
        caps = check_captions(files, duration, "12b")
        want_clock = call["steps"] * hop / 24000.0
        if abs(tracker.clock - want_clock) > 1e-9:
            raise RuntimeError(f"12b: the frame clock reads {tracker.clock} s after "
                               f"{call['steps']} steps ({want_clock} s)")
        emit("captions_cli", prompt_tokens=t_prompt, prompt_bucket=call["prompt_len"],
             cache_slots=call["cache_slots"], steps=call["steps"], seconds=caption_s,
             from_pretrained_s=rec.loads[0], wall_s=call["wall_s"], rtf=call["rtf"],
             capture_s=call["capture_s"], audio_s=duration, peak=float(np.abs(pcm).max()),
             prefill_launches={k: v for k, v in call["launches"].items() if v},
             graph_nodes={k: v for k, v in call["graph_nodes"].items() if v},
             device_launches={k: v for k, v in call["device_launches"].items() if v},
             captions=caps, tracker_clock_s=tracker.clock, tracker_bounds=len(tracker.bounds),
             card=card)
        del rec, call
        gc.collect()
        torch.cuda.empty_cache()

        # 12c: the batch CLI, three scripts at --batch_size 2
        bdir = os.path.join(work, "batch_in")
        os.makedirs(bdir)
        for i, text in enumerate(BATCH_LINES):
            with open(os.path.join(bdir, f"episode_{i}.txt"), "w", encoding="utf-8") as f:
                f.write(text)
        t0 = time.perf_counter()
        printed = io.StringIO()
        with PathRecorder(VibeVoiceTTS, G) as rec, contextlib.redirect_stdout(printed):
            saved = batch_cli.main(["--model_path", ckpt, "--input_dir", bdir, "--output_dir",
                                    os.path.join(work, "batch_out"), "--batch_size", "2",
                                    "--ddpm_steps", str(QUALITY_DDPM), "--max_new_tokens",
                                    str(BATCH_STEPS)])
        batch_s = time.perf_counter() - t0
        tail = printed.getvalue().splitlines()[-len(BATCH_LINES):]
        want_names = [f"episode_{i}.wav" for i in range(len(BATCH_LINES))]
        if (len(saved) != len(BATCH_LINES) or tail != [f"Saved audio to: {p}" for p in saved]
                or [os.path.basename(p) for p in saved] != want_names
                or not all(os.path.isfile(p) for p in saved)):
            raise RuntimeError(f"12c: stdout ends in {tail}, saved {saved}")
        if [c["batch"] for c in rec.calls] != [2, 1]:
            raise RuntimeError(f"12c: batches {[c['batch'] for c in rec.calls]}")
        for i, call in enumerate(rec.calls):
            add(rec.check(cfg, call, None, f"12c batch {i}"))
        for p in saved:
            wav_file(p, BATCH_STEPS * hop, f"12c {os.path.basename(p)}")
        emit("batch_cli", scripts=len(BATCH_LINES), batch_size=2, seconds=batch_s,
             batches=[dict(batch=c["batch"], prompt_bucket=c["prompt_len"], wall_s=c["wall_s"],
                           rtf=c["rtf"], captured=c["captured"]) for c in rec.calls],
             saved_lines=tail, card=card)
        del rec
    gc.collect()
    torch.cuda.empty_cache()
    emit("captions_quality", seconds=time.perf_counter() - t_phase, device_launches=total,
         card=card)
    return total


# ---------------------------------------------------------------------------
# phase 13: the web demos, the warm CLI and the podcast pipeline
# ---------------------------------------------------------------------------

DEMO_DDPM = 5  # the web demos' solver steps
DEMO_STEPS = 512  # the web demos' max_new_tokens
PIPELINE_STEPS = 512  # the batch CLI's default max_new_tokens
PIPELINE_TIMEOUT_S = 300


def _demo_yields(event, args, stop=None):
    """Run a demo's event function (its generator) to its end; returns its
    yields.  With `stop`, calls it after the first streamed chunk."""
    out = []
    for y in event(*args):
        out.append(y)
        if stop is not None and y[0] is not None and len(
                [x for x in out if x[0] is not None]) == 1:
            stop()
    return out


def _update_value(u):
    return u.get("value") if isinstance(u, dict) else None


def forced_module() -> int:
    """`python -m <module> <args>` with the port's engines forced to diffuse
    (`PathRecorder`), each `generate` call checked against
    `expected_launches` and recorded in the JSON file `$VV_FORCED_RECORD`:
    phase 13d puts this in place of `python` on the pipeline's PATH."""
    import runpy
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    args = sys.argv[1:]
    if args[:1] != ["-m"]:
        raise SystemExit(f"forced_module runs `-m <module>`, got {args}")
    sys.argv = [args[1], *args[2:]]
    with PathRecorder(VibeVoiceTTS, G) as rec:
        runpy.run_module(args[1], run_name="__main__", alter_sys=True)
    calls = [rec.check(vibevoice_1_5b(), c, None, f"13d call {i}")
             for i, c in enumerate(rec.calls)]
    with open(os.environ["VV_FORCED_RECORD"], "w") as f:
        json.dump(dict(calls=calls, loads=rec.loads), f, default=str)
    return 0


def phase_demos_pipelines(dev, card, root, ckpt):
    """The rest of the port's entry points, on the full-width 1.5B bf16
    checkpoint `ckpt` (`write_live_checkpoint`):
    13a `scripts.warm_serving_cache.main` with `--batch_sizes 1 2 --quantize
    int4`: the kernel libraries all present (phase 1 built them), both
    engines built, prefilled and captured;
    13b the web demo's event function, from its UI built on the gradio stub
    (`tests/_gradio_stub.py`), `--quantize int4`, on
    `demo/text_examples/2p_dialogue.txt` with the UI's default voices: the
    streamed chunks concatenate to the complete audio, the last log says
    "Done", B2 runs at its 112 launches a step; a second request stopped
    after its first streamed chunk ends with "Generation stopped.";
    13c the captions demo on `demo/text_examples/4p_roundtable.txt` with four
    voices (a 1024-token bucket: flash prefill) and steps to a 4096-slot
    cache (decode attention): live captions arrive with the stream, the
    SRT/VTT/JSON package tiles the complete audio;
    13d `vibevoice_tpu_torch/pipelines/run_podcast_pipeline.sh` for real
    with MODEL_PATH the checkpoint and BATCH_SIZE=2 over two scripts: one
    wav and one srt per script, both upload hooks fire for each.
    The demos' and the pipeline's engines are forced to diffuse
    (`PathRecorder`; the pipeline's CLI through `forced_module`).  Returns
    the launches that ran on the device, by kernel, over the phase."""
    import contextlib
    import gc
    import io
    import shutil
    import tempfile
    from tests import _gradio_stub as stub
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.demo import gradio_demo as GD
    from vibevoice_tpu_torch.demo import gradio_demo_with_captions as GC
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.ops import cuda_build
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.scripts import warm_serving_cache as warm_cli
    cfg = vibevoice_1_5b()
    hop = cfg.speech_compress_ratio
    t_phase = time.perf_counter()
    total = dict(merge_stages(dict.fromkeys(kernel_counters(), 0)),
                 fused_stage_chain_rowlane=0)
    seconds = {}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # 13a: the warm CLI, int4 at B=1 and B=2
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = warm_cli.main(["--model_path", ckpt, "--batch_sizes", "1", "2", "--quantize",
                             "int4"])
    torch.cuda.synchronize()
    seconds["13a"] = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    engines = list(out["tts"]._engines.values())
    n_src = len(cuda_build.SOURCES)
    want = [f"warmed engine (batch={b}, prompt=256, max_new=256)" for b in (1, 2)]
    if (out["build"]["present"] != n_src or out["build"]["compiled"] != 0
            or [l for l in lines if l.startswith("warmed engine")] != want
            or [e.captures for e in engines] != [1, 1]):
        raise RuntimeError(f"13a: {lines}, captures {[e.captures for e in engines]}")
    # on the device: the prefills and warm-up steps (the captures ran nothing)
    device = merge_stages({k: c.launches for k, c in counters.items()})
    for e in engines:
        for k, n in graph_launches(e.graph)[0].items():
            device[k] -= n
    add(device)
    emit("warm_cli", seconds=seconds["13a"], lines=lines, build=out["build"],
         capture_s=[e.capture_s for e in engines],
         graph_nodes=[{k: v for k, v in graph_launches(e.graph)[0].items() if v}
                      for e in engines], card=card)
    del out, engines
    gc.collect()
    torch.cuda.empty_cache()

    def read_script(name):
        with open(os.path.join(root, "demo", "text_examples", name), encoding="utf-8") as f:
            return "\n".join(l for l in f.read().strip().split("\n") if l.strip())

    # 13b: the web demo's event function, from the stub-built UI, in int4
    t0 = time.perf_counter()
    with PathRecorder(VibeVoiceTTS, G) as rec:
        demo = GD.VibeVoiceDemo(ckpt, DEMO_DDPM, quantize="int4", device=dev)
        ui = GD.create_demo_interface(demo, gr=stub)
        buttons = {b.kw["args"][0]: b for b in ui.by_kind("Button")}
        event = buttons["Generate"].events[-1]["fn"]
        stop = buttons["Stop"].events[0]["fn"]
        voices = [d.kw["value"] for d in ui.by_kind("Dropdown")]
        script = read_script("2p_dialogue.txt")
        args = (demo._get_num_speakers_from_script(script), script, *voices, 1.3)
        ys = _demo_yields(event, args)
        stopped = _demo_yields(event, args, stop=stop)
    seconds["13b"] = time.perf_counter() - t0
    streamed = [y[0][1] for y in ys if y[0] is not None]
    complete = [_update_value(y[1]) for y in ys if _update_value(y[1]) is not None]
    if not (len(complete) == 1 and streamed and "Done" in ys[-1][2]
            and np.array_equal(GD.convert_to_16_bit_wav(np.concatenate(streamed)),
                               complete[0][1])
            and len(complete[0][1]) == DEMO_STEPS * hop and np.abs(complete[0][1]).max() > 0):
        raise RuntimeError(f"13b: logs {[y[2] for y in ys]}, {len(streamed)} chunks")
    if stopped[-1][2] != "Generation stopped.":
        raise RuntimeError(f"13b stop: logs {[y[2] for y in stopped]}")
    calls = [rec.check(cfg, c, "int4", f"13b request {i}") for i, c in enumerate(rec.calls)]
    if len(calls) != 2 or calls[0]["launches_per_step"]["int4_matmul"] != 112 \
            or not calls[1]["steps"] < DEMO_STEPS:
        raise RuntimeError(f"13b: {len(calls)} requests, {calls}")
    for c in calls:
        add(c["device_launches"])
    emit("gradio_demo", quantize="int4", script="2p_dialogue.txt", voices=voices[:2],
         seconds=seconds["13b"], from_pretrained_s=rec.loads[0],
         logs=[y[2] for y in ys], chunks=[len(c) for c in streamed],
         audio_s=len(complete[0][1]) / 24000, steps=calls[0]["steps"],
         wall_s=calls[0]["wall_s"], rtf=calls[0]["rtf"], capture_s=calls[0]["capture_s"],
         prompt_bucket=calls[0]["prompt_len"],
         launches_per_step={k: v for k, v in calls[0]["launches_per_step"].items() if v},
         stopped_steps=calls[1]["steps"], stopped_logs=[y[2] for y in stopped], card=card)
    del rec, demo, ui, event, stop, ys, stopped, calls
    gc.collect()
    torch.cuda.empty_cache()

    # 13c: the captions demo to a 4096-slot cache
    t0 = time.perf_counter()
    with PathRecorder(VibeVoiceTTS, G) as rec:
        cdemo = GC.VibeVoiceDemoWithCaptions(ckpt, DEMO_DDPM, device=dev)
        script = read_script("4p_roundtable.txt")
        voices = cdemo.available_voices[:4]
        t_prompt = cdemo.tts.processor(script, [cdemo.voice_presets[v] for v in voices]
                                       ).input_ids.shape[1]
        steps = CAPTION_SLOTS - -(-t_prompt // 256) * 256
        ys = list(cdemo.generate_with_captions(4, script, *voices, cfg_scale=1.3,
                                               max_new_tokens=steps))
    seconds["13c"] = time.perf_counter() - t0
    if len(rec.calls) != 1:
        raise RuntimeError(f"13c: {len(rec.calls)} requests, logs {[y[2] for y in ys]}")
    (call,) = rec.calls
    call = rec.check(cfg, call, None, "13c")
    add(call["device_launches"])
    streamed = [y for y in ys if y[0] is not None]
    sr, audio = ys[-1][1]
    files = dict(zip(("srt", "vtt", "json"), ys[-1][5] or ()))
    if not (call["prompt_len"] >= 1024 and call["flash_prefill"] and call["flash_decode"]
            and call["launches"]["flash_attention_prefill"] == cfg.decoder.num_hidden_layers
            and call["graph_nodes"]["decode_attention"] == cfg.decoder.num_hidden_layers
            and call["cache_slots"] >= CAPTION_SLOTS and call["steps"] == steps):
        raise RuntimeError(f"13c is off the flash prefill / decode attention path: prompt "
                           f"{t_prompt}, {call}")
    if not (streamed and all(y[4] for y in streamed) and "Done" in ys[-1][2]
            and np.array_equal(GD.convert_to_16_bit_wav(
                np.concatenate([y[0][1] for y in streamed])), audio)
            and len(audio) == steps * hop):
        raise RuntimeError(f"13c: logs {[y[2] for y in ys]}, captions {[y[4] for y in ys]}")
    caps = check_captions(files, len(audio) / sr, "13c")
    emit("gradio_demo_captions", script="4p_roundtable.txt", voices=voices,
         prompt_tokens=t_prompt, prompt_bucket=call["prompt_len"],
         cache_slots=call["cache_slots"], steps=call["steps"], seconds=seconds["13c"],
         from_pretrained_s=rec.loads[0], wall_s=call["wall_s"], rtf=call["rtf"],
         capture_s=call["capture_s"], audio_s=len(audio) / sr, chunks=len(streamed),
         live_captions=[y[4] for y in streamed][:3], captions=caps,
         prefill_launches={k: v for k, v in call["launches"].items() if v},
         graph_nodes={k: v for k, v in call["graph_nodes"].items() if v}, card=card)
    del rec, cdemo, ys, streamed, audio, call
    gc.collect()
    torch.cuda.empty_cache()

    # 13d: the podcast pipeline for real, its batch CLI forced to diffuse
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        scripts = os.path.join(work, "scripts")
        out_dir = os.path.join(work, "out")
        shim = os.path.join(work, "bin")
        for d in (scripts, out_dir, shim):
            os.makedirs(d)
        names = [f"episode_{i}" for i in range(2)]
        for name, text in zip(names, BATCH_LINES):
            with open(os.path.join(scripts, f"{name}.txt"), "w", encoding="utf-8") as f:
                f.write(text)
        uploads = os.path.join(work, "uploads.log")
        hook = os.path.join(work, "upload.sh")
        with open(hook, "w") as f:
            f.write(f"#!/bin/sh\necho \"$0 $1\" >> {uploads}\n")
        for kind in ("audio", "srt"):
            os.symlink(hook, os.path.join(work, f"upload_{kind}.sh"))
        os.chmod(hook, 0o755)
        with open(os.path.join(shim, "python"), "w") as f:
            f.write(f"#!/bin/sh\nexec {sys.executable} -c 'import sys; sys.path.insert(0, "
                    f"{json.dumps(root)}); import chip_smoke; "
                    f"sys.exit(chip_smoke.forced_module())' \"$@\"\n")
        os.chmod(os.path.join(shim, "python"), 0o755)
        record = os.path.join(work, "record.json")
        env = dict(os.environ, PATH=f"{shim}:{os.environ.get('PATH', '')}", MODEL_PATH=ckpt,
                   BATCH_SIZE="2", SCRIPTS_DIR=scripts, OUTPUT_DIR=out_dir,
                   LOG_DIR=os.path.join(work, "logs"), VV_FORCED_RECORD=record,
                   UPLOAD_AUDIO_CMD=os.path.join(work, "upload_audio.sh"),
                   UPLOAD_SRT_CMD=os.path.join(work, "upload_srt.sh"))
        env.pop("PIPELINE_DRY_RUN", None)
        proc = subprocess.run(
            ["bash", os.path.join(root, "vibevoice_tpu_torch", "pipelines",
                                  "run_podcast_pipeline.sh"), "2026-01-05", "smoke", "key"],
            capture_output=True, text=True, timeout=PIPELINE_TIMEOUT_S, env=env)
        seconds["13d"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"13d: the pipeline exited {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(record) as f:
            rec = json.load(f)
        with open(uploads) as f:
            ups = f.read().splitlines()
        wavs = sorted(os.path.basename(p) for p in os.listdir(out_dir) if p.endswith(".wav"))
        srts = sorted(os.path.basename(p) for p in os.listdir(out_dir) if p.endswith(".srt"))
        for name in names:
            wav_file(os.path.join(out_dir, f"{name}.wav"), PIPELINE_STEPS * hop, f"13d {name}")
        audio_ups = [u for u in ups if "upload_audio.sh" in u]
        srt_ups = [u for u in ups if "upload_srt.sh" in u]
        if not (wavs == [f"{n}.wav" for n in names] and srts == [f"{n}.srt" for n in names]
                and len(audio_ups) == len(srt_ups) == len(names)
                and [c["batch"] for c in rec["calls"]] == [2]):
            raise RuntimeError(f"13d: wavs {wavs}, srts {srts}, uploads {ups}, "
                               f"batches {[c['batch'] for c in rec['calls']]}")
        add(rec["calls"][0]["device_launches"])
        mp3 = shutil.which("ffmpeg") is not None
        emit("podcast_pipeline", seconds=seconds["13d"], scripts=len(names), batch_size=2,
             wavs=wavs, srts=srts, uploads=[u.split()[-1].rsplit("/", 1)[-1] for u in ups],
             mp3=mp3, from_pretrained_s=rec["loads"][0], wall_s=rec["calls"][0]["wall_s"],
             rtf=rec["calls"][0]["rtf"], steps=rec["calls"][0]["steps"],
             capture_s=rec["calls"][0]["capture_s"], card=card)
    emit("demos_pipelines", seconds=time.perf_counter() - t_phase, parts_s=seconds,
         device_launches=total, card=card)
    return total


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 2, the latent-attention decode kernel (DeepSeek-V2's MLA)
# ---------------------------------------------------------------------------

# the 45k DeepSeek-V2-Lite cell's operands: 27 layers, 8 cache rows (4 rows
# and their CFG-negative streams) of 53 248 slots, the window ~4 000 steps
# into the episodes (the positive rows see 49 057 slots, the negative ones
# slot 0 and their 4 001 decoded slots)
MLA_SHAPE = dict(layers=27, rows=8, slots=53248, prompt=45056, write_pos=49056)
MLA_SCALE = 192 ** -0.5 * (0.1 * 0.707 * np.log(40) + 1) ** 2


def mla_operands(dev, gen, layers, rows, slots, prompt, write_pos):
    """q [rows, 16, 576], one cache [layers, rows, slots, 576], the visibility
    and lengths of the cell's window (`MLA_SHAPE`)."""
    q = (0.3 * torch.randn((rows, 16, 576), generator=gen, device=dev)).to(torch.bfloat16)
    cache = torch.empty((layers, rows, slots, 576), dtype=torch.bfloat16, device=dev)
    for li in range(layers):
        cache[li] = torch.randn((rows, slots, 576), generator=gen, device=dev)
    vis = torch.zeros((rows, slots), dtype=torch.int32, device=dev)
    half = rows // 2
    vis[:half, :write_pos + 1] = 1
    vis[half:, 0] = 1
    vis[half:, prompt:write_pos + 1] = 1
    lengths = torch.full((rows,), write_pos + 1, dtype=torch.int32, device=dev)
    return q, cache, vis, lengths


def mla_bound_ms(vis, lengths):
    """The least time of one call: the visible slots' bytes (and q, out, the
    mask) over HBM's rate, or its operations over the bf16 peak."""
    from vibevoice_tpu_torch.ops.mla_decode_attention import live_bytes
    visible = int(vis.sum())
    rows = vis.shape[0]
    nbytes = live_bytes(rows, visible, int(lengths.sum()))
    flops = 2 * visible * 16 * (576 + 512)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_mla(dev, card):
    """The latent-attention decode kernel against its plain version at the
    cell's operands (layers 0 and 26), two calls bit-equal, and its time a
    launch over the 27 layers (each layer's visible latents, ~225 MB, larger
    than L2) against its bound, the plain version's and SDPA's (the 16 heads
    over the latent as one KV head, the yardstick); then the launches on the
    main path: the kernel nodes of a DeepSeek-V2-Lite VibeVoice engine's
    captured step.  Returns the grouped expert kernel's nodes in that step
    and the kernels-line entry."""
    import torch.nn.functional as F
    from vibevoice_tpu_torch.ops import mla_decode_attention as mla
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    q, cache, vis, lengths = mla_operands(dev, gen, **MLA_SHAPE)
    err, worst = 0.0, 0.0
    for layer in (0, cache.shape[0] - 1):
        got = mla.mla_decode_attention(q, cache, layer, vis, lengths, MLA_SCALE)
        want = mla.mla_decode_attention_ref(q, cache, layer, vis, lengths, MLA_SCALE)
        err = max(err, (got.float() - want.float()).abs().max().item())
        worst = max(worst, want.float().abs().max().item())
    stable = torch.equal(*(mla.mla_decode_attention(q, cache, 0, vis, lengths, MLA_SCALE)
                           for _ in range(2)))
    tol = 2 ** -6 * worst
    if not (err <= tol and stable):
        raise RuntimeError(f"mla_decode_attention: error {err} > {tol} or two calls differ")
    n_layers = cache.shape[0]
    ms = cuda_ms(lambda i: mla.mla_decode_attention(q, cache, i % n_layers, vis, lengths,
                                                    MLA_SCALE), 4 * n_layers)
    plain_ms = cuda_ms(lambda i: mla.mla_decode_attention_ref(q, cache, i % n_layers, vis,
                                                              lengths, MLA_SCALE), 4)
    mask = ((vis > 0) & (torch.arange(vis.shape[1], device=dev)[None] < lengths[:, None]))

    def lib(i):
        lat = cache[i % n_layers][:, None]                               # [B, 1, S, 576]
        F.scaled_dot_product_attention(q[:, :, None], lat, lat[..., :512],
                                       attn_mask=mask[:, None, None], scale=MLA_SCALE,
                                       enable_gqa=True)
    lib_ms = cuda_ms(lib, n_layers)
    bms, by = mla_bound_ms(vis, lengths)
    n_splits = mla.plan(vis.shape[0], vis.shape[1], torch.cuda.get_device_properties(
        dev).multi_processor_count)
    emit("kernel_vs_plain", kernel="mla_decode_attention", **MLA_SHAPE,
         visible=int(vis.sum()), n_splits=n_splits, max_abs_err=err, tol=tol,
         bit_stable=stable, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
         bound_by=by, bound_share=bms / ms, card=card)
    del q, cache, vis, lengths
    torch.cuda.empty_cache()
    per_step, moe_per_step = mla_engine_launches(dev)
    return moe_per_step, {"name": "mla_decode_attention", "route": "cuda",
            "source": "vibevoice_tpu_torch/csrc/mla_decode_attention.cu",
            "replaces": "none (the JAX package has no latent attention)",
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err, "bit_stable": stable,
            "per": f"launch: one layer at the 45k DeepSeek-V2-Lite cell's operands ({MLA_SHAPE})",
            "launches": f"one per layer per decode step: {per_step} in the captured step "
                        f"of a DeepSeek-V2-Lite engine",
            "device_launches": per_step, "parallel_launches": 0, "serving_launches": 0,
            "serving_device_launches": 0, "caption_quality_launches": 0,
            "demo_pipeline_launches": 0,
            "off_paths": "the DeepSeek-V2 decoder runs on no serving, parallel, caption or "
                         "demo path"}


def mla_engine_launches(dev):
    """The MLA kernel's and the grouped expert kernel's nodes in the
    captured step of a DeepSeek-V2-Lite VibeVoice (all 27 layers, the bf16
    weights ~31 GB) with a 6 144-slot cache; the captured step's outputs
    equal the eager step's."""
    import dataclasses
    from vibevoice_tpu_torch.configs import DeepseekV2Config, vibevoice_1_5b, DiffusionHeadConfig
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V
    cfg = dataclasses.replace(vibevoice_1_5b(), decoder=DeepseekV2Config(),
                              diffusion_head=DiffusionHeadConfig(hidden_size=2048))
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 12))
    params["speech_scaling_factor"] = torch.tensor(0.8, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.1, device=dev)
    gen = G.GenerationConfig(speech_start_id=102396, speech_end_id=102397,
                             speech_diffusion_id=102398, eos_id=100001, force_diffusion=True,
                             ddpm_steps=10)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, 100000, (2, 4096))
    mask = np.ones((2, 4096), np.int32)
    mask[1, :700] = 0
    outs = []
    for eager in (True, False):
        eng = G.Engine(params, cfg, gen, max_steps=64, batch=2, prompt_len=4096,
                       dtype=torch.bfloat16, device=dev, inject_latent_noise=True, eager=eager)
        noise = torch.randn((64, 2, 64), generator=torch.Generator(device=dev).manual_seed(3),
                            device=dev).to(torch.bfloat16)
        st, _ = eng.prefill(ids, mask, np.zeros((2, 4096), bool), latent_noise=noise)
        st, o = eng.decode_chunk(st, 6)
        outs.append(o.audio_chunk.float().cpu())
        if not eager:
            names = graph_kernels(eng.graph)
        del eng, st
    if not torch.equal(outs[0][1:], outs[1][1:]):
        raise RuntimeError("the captured DeepSeek-V2 step differs from the eager one")
    torch.cuda.empty_cache()
    n = sum("10mla_kernel" in x for x in names)
    n_moe = sum("18moe_experts_kernel" in x for x in names)
    from vibevoice_tpu_torch.models import deepseek_v2
    if n_moe != deepseek_v2.grouped_layers(cfg.decoder, 4, dev):
        raise RuntimeError(f"{n_moe} grouped expert nodes in the captured step; the engine's "
                           f"counter says {deepseek_v2.grouped_layers(cfg.decoder, 4, dev)}")
    del params
    torch.cuda.empty_cache()
    emit("mla_engine", layers=cfg.decoder.num_hidden_layers, graph_nodes=len(names),
         mla_nodes=n, moe_experts_nodes=n_moe, audio_abs_mean=float(outs[1].abs().mean()))
    return n, n_moe


# the 45k DeepSeek-V2-Lite cell's expert layers: 64 experts of H 2 048 and F
# 1 408, a decode call's 8 rows (B = 4 and their CFG-negative streams) hitting
# ~24 experts; three copies of the experts (3.3 GB) rotated, each larger
# than L2
MOE_SHAPE = dict(experts=64, hidden=2048, inter=1408, rows=8, hit=24, copies=3)


def moe_routing(dev, gen, experts, rows, hit):
    """w [rows, experts] fp32 of a decode call of the cell: positive row r
    takes block r of 6 of `hit` experts drawn from the seed, its CFG-negative
    stream (row r + rows / 2, which shares its input embedding, so their
    routings overlap) 4 of those and 2 of the next block, so the call hits
    `hit` distinct experts; softmax-sized weights."""
    perm = torch.randperm(experts, generator=gen, device=dev)[:hit].tolist()
    half, w = rows // 2, torch.zeros((rows, experts), device=dev)
    for r in range(half):
        blk, nxt = perm[6 * r:6 * r + 6], perm[(6 * r + 6) % hit:(6 * r + 6) % hit + 6]
        w[r, blk] = 1.0
        w[r + half, blk[:4] + nxt[4:]] = 1.0
    return w * (0.05 + 0.25 * torch.rand((rows, experts), generator=gen, device=dev))


def phase_moe(dev, card, device_launches):
    """The grouped expert kernel against the plain version in fp32 on the
    same bf16 operands (and the plain bf16 version's error beside it) at the
    cell's operands (`MOE_SHAPE`), two calls bit-equal, its time a layer with
    the experts rotated through copies against its bound and the plain
    version's; `device_launches` its nodes in `phase_mla`'s captured step.
    Returns the kernels-line entry."""
    from vibevoice_tpu_torch.ops import moe_experts as me
    sh = MOE_SHAPE
    e, hd, f, n = sh["experts"], sh["hidden"], sh["inter"], sh["rows"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def nrm(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
    copies = [(nrm(e, hd, f), nrm(e, hd, f), nrm(e, f, hd)) for _ in range(sh["copies"])]
    h = torch.randn((n, hd), generator=gen, device=dev).to(torch.bfloat16)
    w = moe_routing(dev, gen, e, n, sh["hit"])
    hit = int((w != 0).any(dim=0).sum())
    ex = copies[0]
    got = me.moe_experts(h, w, *ex)
    exact = me.moe_experts_ref(h.float(), w, *(t.float() for t in ex))
    err = (got - exact).abs().max().item()
    plain_err = (me.moe_experts_ref(h, w, *ex) - exact).abs().max().item()
    tol = 2 ** -7 * exact.abs().max().item()
    stable = torch.equal(got, me.moe_experts(h, w, *ex))
    del exact
    if not (err <= tol and stable):
        raise RuntimeError(f"moe_experts: error {err} > {tol} or two calls differ")
    k = len(copies)
    ms = cuda_ms(lambda i: me.moe_experts(h, w, *copies[i % k]), 26 * k)
    plain_ms = cuda_ms(lambda i: me.moe_experts_ref(h, w, *copies[i % k]), 2 * k)
    nbytes = me.hit_bytes(w, hd, f)
    bms = nbytes / HBM_BYTES_PER_S * 1e3
    p = me.plan_for(dev, n, hd, f, e)
    emit("kernel_vs_plain", kernel="moe_experts", **sh, hit_experts=hit, plan=p._asdict(),
         max_abs_err=err, tol=tol, plain_bf16_err=plain_err, bit_stable=stable, ms=ms,
         plain_ms=plain_ms, bound_ms=bms, bound_by="bytes", bound_share=bms / ms, card=card)
    del copies, ex, got, h, w
    torch.cuda.empty_cache()  # the 3.3 GB of experts go back to the card for the later phases
    return {"name": "moe_experts", "route": "cuda",
            "source": "vibevoice_tpu_torch/csrc/moe_experts.cu",
            "replaces": "none (the JAX package has no mixture of experts)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": "bytes",
            "max_abs_err": err, "plain_bf16_err": plain_err, "bit_stable": stable,
            "per": f"launch: one expert layer at the 45k DeepSeek-V2-Lite cell's operands "
                   f"({sh}, {hit} experts hit)",
            "launches": f"one per expert layer per decode step: {device_launches} in the "
                        f"captured step of a DeepSeek-V2-Lite engine",
            "device_launches": device_launches, "parallel_launches": 0, "serving_launches": 0,
            "serving_device_launches": 0, "caption_quality_launches": 0,
            "demo_pipeline_launches": 0,
            "off_paths": "the DeepSeek-V2 decoder runs on no serving, parallel, caption or "
                         "demo path"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU only",
              file=sys.stderr)
        return 2
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine.generate import resolve_device
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.ops import cuda_build
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    emit("setup", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # 1. build
    build_s, logs = cuda_build.build_all()
    emit("build", seconds=build_s, sources=sorted(cuda_build.SOURCES.values()))
    # registers and spills of every entry function, as ptxas reports them
    for name, log in logs.items():
        emit("ptxas", source=cuda_build.SOURCES[name], entries=ptxas_report(log))

    # 2. kernel against plain
    phase_kernels(dev)
    phase_int4_kernels(dev)
    head_bf16 = phase_head_bf16(dev)
    phase_stage_kernels(dev)
    phase_flash_kernel(dev)
    phase_plain_chain(dev)
    moe_nodes, mla_entry = phase_mla(dev, card)
    moe_entry = phase_moe(dev, card, moe_nodes)

    # 3-4. engine, bf16 then int8 KV
    cfg = vibevoice_1_5b()
    t0 = time.perf_counter()
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    torch.cuda.synchronize()
    emit("init", model="vibevoice_1_5b", dtype="bf16", seconds=time.perf_counter() - t0)
    runs, device_launches = {}, {}
    for kv, warm, chunks in (("model", 16, (32, 32)), ("int8", 8, (8,))):
        r = run_engine(params, cfg, dev, kv, warm, chunks, card)
        vis, lengths = attention_operands(r.state, 1, dev)
        runs[kv] = (r.launches["decode_attention"], r.state.cache, vis, lengths)
        device_launches["decode_attention" + ("[int8 KV]" if kv == "int8" else "")] = \
            r.device_launches["decode_attention"]
        if kv == "model":  # the bf16 head on its kernel
            head_bf16 = head_bf16_entry(head_bf16, r.eng, r.launches["fused_head_bf16"])
            device_launches["fused_head_bf16"] = r.device_launches["fused_head_bf16"]
        del r
    entries = [kernel_entry("decode_attention", *runs["model"], False, dev, cfg.decoder),
               kernel_entry("decode_attention[int8 KV]", *runs["int8"], True, dev,
                            cfg.decoder), head_bf16]
    del runs
    # the large-T stages at B=2: the row-lane layout turned off (8 stage calls
    # per step), then by default (the JAX engine's rule: 4 stage calls and 4
    # row-lane calls), each in turns eager, graph, graph, eager; each also
    # replays the codec half of a step from a CUDA graph of its own
    stage_runs = {}
    for rowlane in (False, None):
        want = ({"fused_stage_chain": 8, "fused_stage_chain_rowlane": 0} if rowlane is False
                else {"fused_stage_chain": 4, "fused_stage_chain_rowlane": 4})
        r = run_engine(params, cfg, dev, "model", 8, (16,), card, batch=2, stages=True,
                       want_stages=want, rowlane=rowlane)
        codec_graph(r.eng, r.state, dev, card)
        if rowlane is None:
            stage_runs["fused_stage_chain_rowlane"] = (
                r.eng, r.launches["fused_stage_chain_rowlane"])
            device_launches["fused_stage_chain_rowlane"] = \
                r.device_launches["fused_stage_chain_rowlane"]
        del r
    # the stage calls per step that the engine's packs give at B=4 and B=32,
    # by default and with the row-lane layout off (packed, not run)
    from vibevoice_tpu_torch.engine import generate as G
    for b in (4, 32):
        for rowlane in (None, False):
            eng = G.Engine(params if rowlane is None else without_rowlane(params, cfg, b),
                           cfg, bench_gen(G), max_steps=16, batch=b, prompt_len=256,
                           dtype=torch.bfloat16, device=dev, use_fused_stages=True)
            per_step = stage_launches(eng)
            if (per_step["fused_stage_chain_rowlane"] > 0) != (rowlane is None):
                raise RuntimeError(f"B={b}: the row-lane rule gives {per_step}")
            emit("stage_policy", batch=b, rowlane=uses_rowlane_any(eng),
                 launches_per_step=per_step)
            del eng
    # the long-prompt path: flash prefill and the plain-pack chains
    r = phase_long_prompt(params, cfg, dev, card)
    entries += long_prompt_entries(r.eng, r.launches, cfg, dev)
    for k in ("flash_attention_prefill", "fused_block_chain"):
        device_launches[k] = r.device_launches[k]
    del r
    torch.cuda.empty_cache()

    # 5. the quantized engine on the same weights: int4, int4 with the large-T
    # stage kernels (8 calls per step, transition convs folded), then int4f
    for quant, warm, chunks in (("int4", 16, (32, 32)), ("int4f", 8, (8,))):
        t0 = time.perf_counter()
        qparams = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.bfloat16,
                               device=dev, **dict(QUANT_MODES, quantize=quant)).params
        torch.cuda.synchronize()
        emit("quantize", modes=dict(QUANT_MODES, quantize=quant),
             seconds=time.perf_counter() - t0)
        r = run_engine(qparams, cfg, dev, "model", warm, chunks, card, quant)
        if quant == "int4":
            entries += quant_entries(qparams, cfg, r.launches, dev)
            for k in ("int4_matmul", "fused_block_chain_batched", "fused_head_solver_step"):
                device_launches[k] = r.device_launches[k]
            del r
            r = run_engine(
                qparams, cfg, dev, "model", warm, chunks, card, quant, stages=True,
                want_stages={"fused_stage_chain": 8, "fused_stage_chain_rowlane": 0})
            stage_runs["fused_stage_chain"] = (r.eng, r.launches["fused_stage_chain"])
            device_launches["fused_stage_chain"] = r.device_launches["fused_stage_chain"]
            entries += stage_entries(stage_runs, cfg, dev)
            del stage_runs
        del r
        del qparams
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # 6. pipeline, bf16 then quantized
    phase_pipeline(dev, card)
    phase_pipeline(dev, card, quant="int4")

    # 7. reference on a small input: plain, quantized, large-T stage kernels
    phase_reference(dev)
    phase_reference(dev, quant=True)
    phase_reference(dev, stages=True, b=1)
    phase_reference(dev, stages=True, b=2)
    phase_reference(dev, flash_chain=True)

    # 8. the serving deployment: a 1.5B checkpoint loaded and served over HTTP
    root = os.path.dirname(os.path.abspath(__file__))
    serving, serving_device = phase_serving(dev, card, root)

    # 9. the training path: the full-width 1.5B takes fp32 AdamW steps, and a
    # tiny model trains on the card as on the CPU
    phase_train(dev, card, root)
    phase_train_reference(dev)

    # 10. the parallel paths: TP and DP engines, CP and ring prefill, as two
    # ranks on this card over gloo, held against the unsharded runs
    parallel = phase_parallel(dev, card)

    # 11. the sharded training step: TP=2 and DP=2 ranks of the fp32 1.5B
    # (LM cut to 4 layers) on this card over gloo, held against the
    # unsharded step; and the tiny model's TP=2 step on the card as on the CPU
    phase_train_graph_equal(dev, card, root)
    phase_train_sharded(dev, card, root)
    phase_train_sharded_reference(dev)
    # 11c. the sharded step captured over NCCL: one rank's NCCL group as the
    # mesh's data and model groups, captured against eager
    phase_train_graph_nccl(dev, card, root)

    # 12. the caption and quality-evaluation path: the quality harness, the
    # caption CLI to a 4096-slot cache and the batch CLI, on a checkpoint;
    # 13. the web demos, the warm CLI and the podcast pipeline on it
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        ckpt = os.path.join(work, "ckpt")
        write_live_checkpoint(ckpt, dev, card)
        captions = phase_captions_quality(dev, card, root, ckpt)
        demos = phase_demos_pipelines(dev, card, root, ckpt)

    emit("done", seconds=time.perf_counter() - t_start)
    # beside the wrappers' count of the main path's run (the prefill, the
    # warm-up step and the captured one), the launches that ran on the device;
    # and both counts while the serving path ran (the row-lane calls under
    # fused_stage_chain_rowlane)
    for e in entries:
        e["device_launches"] = device_launches[e["name"]]
        e["parallel_launches"] = parallel[e["name"]]
        key = e["name"].split("[")[0]
        if key.startswith("fused_stage_chain"):
            # one kernel function: a graph's nodes give the two calls' sum
            e["parallel_launches_of"] = "fused_stage_chain + fused_stage_chain_rowlane"
        if not e["name"].endswith("[int8 KV]"):
            e["serving_launches"] = serving[key]
            e["serving_device_launches"] = serving_device[key]
        # on the device while phase 12 ran, and while phase 13 ran (no int8
        # KV in either)
        e["caption_quality_launches"] = (0 if e["name"].endswith("[int8 KV]") else
                                         captions[key])
        e["demo_pipeline_launches"] = (0 if e["name"].endswith("[int8 KV]") else demos[key])
    entries += [mla_entry, moe_entry]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
