"""The traffic generator: the same inputs from the same seed, the same work
from every seed."""
import numpy as np
import torch

from portbench import traffic
from portbench.reference import configs
from portbench.tests.conftest import tiny_cell


def batch(seed, index=0):
    cell = tiny_cell()
    cfg = configs.config_from_dict(cell.config_file)
    return traffic.podcast_batch(cell.traffic, cell.config_file["token_ids"], cfg, seed, index,
                                 "cpu", torch.float32)


def test_portbench_batch_is_reproducible_from_the_seed():
    a, b = batch(2 ** 31 + 7), batch(2 ** 31 + 7)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
        elif torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            assert x == y
    c = batch(2 ** 31 + 8)
    assert not np.array_equal(a.ids, c.ids) and not torch.equal(a.latent_noise, c.latent_noise)


def test_portbench_every_seed_has_the_same_lengths():
    lengths = {tuple(sorted(batch(s).lengths)) for s in range(6)}
    orders = {tuple(batch(s).lengths) for s in range(6)}
    assert len(lengths) == 1 and len(orders) > 1


def test_portbench_prompt_layout():
    cell = tiny_cell()
    tr, ids = cell.traffic, cell.config_file["token_ids"]
    bt = batch(5)
    assert bt.ids.shape == (tr["batch"], tr["prompt_len"])
    for r, n in enumerate(bt.lengths):
        row = bt.ids[r]
        assert bt.attention_mask[r].sum() == n and bt.attention_mask[r, -n:].all()
        assert row[-1] == ids["speech_start"]
        assert bt.speech_mask[r].sum() == tr["speakers"] * tr["voice_frames"]
        assert (row[bt.speech_mask[r]] == ids["speech_diffusion"]).all()
    assert bt.speech_tensors.shape[0] == tr["batch"] * tr["speakers"]
    assert torch.isfinite(bt.speech_tensors).all() and bt.speech_tensors.abs().max() < 1
