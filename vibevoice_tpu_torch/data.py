"""Training data pipeline: scripts + target audio -> TrainBatch.

The port's copy of `vibevoice_tpu/data.py` (numpy throughout).  The
reference ships only the training-shaped forward ("release training code"
TODO, README.md:42); its inputs (`modeling_vibevoice.py:332-477`) are built
from (script, per-turn target audio) pairs:

  sequence = system prompt + per-turn [" Speaker N: text\\n", speech_start,
             diffusion x F_turn, speech_end] + eos
  acoustic_input_mask : True at the diffusion-token positions (speech frames
                        spliced into the LM input)
  acoustic_loss_mask  : input mask shifted left by one — the hidden state
                        that PREDICTS each frame conditions its denoising
  labels              : next-token CE targets (-100 on pads)
  speech_tensors      : per-turn target audio, one row per turn
  speech_semantic_tensors : semantic-encoder features of the target audio
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .processor.processor import SYSTEM_PROMPT
from .train import TrainBatch


def build_training_example(tokenizer, parsed_turns: Sequence[Tuple[int, str]],
                           turn_audio: Sequence[np.ndarray], hop: int = 3200):
    """One example: returns (ids, acoustic input mask, speech clips)."""
    ids: List[int] = list(tokenizer.encode(SYSTEM_PROMPT))
    aim: List[bool] = [False] * len(ids)
    clips: List[np.ndarray] = []
    for (sid, text), wav in zip(parsed_turns, turn_audio):
        t = tokenizer.encode(f" Speaker {sid}:{text}\n")
        ids += t
        aim += [False] * len(t)
        wav = np.asarray(wav, np.float32)
        frames = max(1, math.ceil(len(wav) / hop))
        wav = np.pad(wav, (0, frames * hop - len(wav)))
        clips.append(wav)
        ids += [tokenizer.speech_start_id] + [tokenizer.speech_diffusion_id] * frames \
            + [tokenizer.speech_end_id]
        aim += [False] + [True] * frames + [False]
    ids.append(tokenizer.eos_id)
    aim.append(False)
    return ids, aim, clips


def build_training_batch(tokenizer, examples, hop: int = 3200,
                         semantic_fn: Optional[Callable] = None,
                         semantic_dim: int = 128,
                         pad_to_multiple: int = 64) -> TrainBatch:
    """examples: list of (parsed_turns, turn_audio_list) -> TrainBatch.

    `semantic_fn(audio [N, T] numpy) -> [N, F, semantic_dim]` (anything
    `np.asarray` takes) supplies semantic features (the model's semantic
    encoder); zeros when absent.
    """
    encoded = [build_training_example(tokenizer, turns, audio, hop)
               for turns, audio in examples]
    max_len = max(len(e[0]) for e in encoded)
    max_len = -(-max_len // pad_to_multiple) * pad_to_multiple
    b = len(encoded)

    ids = np.zeros((b, max_len), np.int32)
    att = np.zeros((b, max_len), np.int32)
    aim = np.zeros((b, max_len), bool)
    labels = np.full((b, max_len), -100, np.int32)

    all_clips: List[np.ndarray] = []
    for i, (e_ids, e_aim, clips) in enumerate(encoded):
        n = len(e_ids)
        ids[i, :n] = e_ids
        att[i, :n] = 1
        aim[i, :n] = e_aim
        labels[i, : n - 1] = e_ids[1:]
        all_clips.extend(clips)

    # loss mask: hidden at position p-1 predicts the frame at position p
    alm = np.zeros_like(aim)
    alm[:, :-1] = aim[:, 1:]

    n_clips = len(all_clips)
    frame_counts = [len(c) // hop for c in all_clips]
    max_frames = max(frame_counts)
    speech = np.zeros((n_clips, max_frames * hop), np.float32)
    smask = np.zeros((n_clips, max_frames), bool)
    for i, (c, f) in enumerate(zip(all_clips, frame_counts)):
        speech[i, : len(c)] = c
        smask[i, :f] = True

    if semantic_fn is not None:
        sem = np.asarray(semantic_fn(speech))
    else:
        sem = np.zeros((n_clips, max_frames, semantic_dim), np.float32)

    return TrainBatch(
        input_ids=ids, attention_mask=att, labels=labels,
        speech_tensors=speech, speech_masks=smask,
        speech_semantic_tensors=sem,
        acoustic_input_mask=aim, acoustic_loss_mask=alm,
    )


def clip_owners(batch: TrainBatch) -> np.ndarray:
    """The row of each clip [N]: the clips come in row order, and a row's
    speech positions (`acoustic_input_mask`, row-major) are its clips' valid
    frames (`speech_masks`) in clip order.  ValueError when the counts do not
    line up so, or when a row's loss positions (`acoustic_loss_mask`) are not
    as many as its speech positions."""
    want = np.asarray(batch.acoustic_input_mask).sum(axis=1)
    if not np.array_equal(np.asarray(batch.acoustic_loss_mask).sum(axis=1), want):
        raise ValueError("each row needs as many loss positions as speech positions")
    frames = np.asarray(batch.speech_masks).sum(axis=1)
    owners = np.empty(len(frames), np.int64)
    row, have = 0, 0
    for i, f in enumerate(frames):
        while row < len(want) and have == want[row]:
            row, have = row + 1, 0
        if row == len(want) or have + f > want[row]:
            raise ValueError(f"clip {i}'s {f} valid frames do not fit the speech positions "
                             "of the rows")
        owners[i], have = row, have + f
    if frames.sum() != want.sum():
        raise ValueError("the clips' valid frames do not fill the rows' speech positions")
    return owners


def shard_batch(batch: TrainBatch, mesh) -> TrainBatch:
    """This data rank's share of a global batch: its rows r*B/dp .. (r+1)*B/dp
    and the clips those rows own (`clip_owners`), with T, F and the audio
    length of the global batch kept, so each rank's latents and packed frames
    are the global batch's (re-padding a rank's own examples would change F,
    the audio length and the σ-VAE encoder's padding).  Ranks may hold
    different numbers of clips.  The whole batch without a data axis."""
    dp = 1 if mesh is None else mesh.shape["data"]
    if dp == 1:
        return batch
    b = np.asarray(batch.input_ids).shape[0]
    if b % dp:
        raise ValueError(f"{b} rows do not split over {dp} data ranks")
    n = b // dp
    lo = mesh.axis_index("data") * n
    owners = clip_owners(batch)
    clips = (owners >= lo) & (owners < lo + n)
    rows = slice(lo, lo + n)
    return TrainBatch(
        input_ids=np.asarray(batch.input_ids)[rows],
        attention_mask=np.asarray(batch.attention_mask)[rows],
        labels=np.asarray(batch.labels)[rows],
        speech_tensors=np.asarray(batch.speech_tensors)[clips],
        speech_masks=np.asarray(batch.speech_masks)[clips],
        speech_semantic_tensors=np.asarray(batch.speech_semantic_tensors)[clips],
        acoustic_input_mask=np.asarray(batch.acoustic_input_mask)[rows],
        acoustic_loss_mask=np.asarray(batch.acoustic_loss_mask)[rows])


__all__ = ["build_training_example", "build_training_batch", "clip_owners", "shard_batch"]
