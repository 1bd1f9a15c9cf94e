"""The yardstick's operation and byte counts on hand-computed shapes."""
import pytest

from portbench import work
from portbench.reference import configs


def test_portbench_least_seconds_picks_the_larger_bound():
    t, kind = work.least_seconds(989e12, 3.35e12 * 2)
    assert kind == "bytes" and t == pytest.approx(2.0)
    t, kind = work.least_seconds(989e12 * 3, 3.35e12)
    assert kind == "operations" and t == pytest.approx(3.0)


def test_portbench_decode_attention_work():
    # 2 rows, 12 heads of 128, 2 KV heads; rows see 100 and 3 of 101 slots, bf16
    flops, nbytes = work.decode_attention_work(12, 128, 2, [100, 3], [101, 101], 2)
    assert flops == 4 * 103 * 12 * 128
    q_and_out = 2 * 2 * 12 * 128 * 2
    kv = 2 * 103 * 2 * 128 * 2
    mask = 4 * 202 + 4 * 2
    assert nbytes == q_and_out + kv + mask


def test_portbench_codec_flops_by_hand():
    """A two-stage decoder and encoder, counted by hand."""
    ac = configs.AcousticTokenizerConfig(vae_dim=2, decoder_n_filters=4, decoder_ratios=(2,),
                                         encoder_depths=(1, 1), kernel_size=3,
                                         last_kernel_size=3, ffn_expansion=2)
    # dims [8, 4]: stem conv k3 2->8 at T=1; blocks of 8 at T=1; transposed conv
    # 8 -> 4 with k=4 at T=1; blocks of 4 at T=2; head k3 4->1 at T=2
    want = (2 * 1 * 3 * 2 * 8 + (2 * 1 * 7 * 8 + 4 * 1 * 8 * 2 * 8)
            + 2 * 1 * 8 * 4 * 4 + (2 * 2 * 7 * 4 + 4 * 2 * 4 * 2 * 4) + 2 * 2 * 3 * 4 * 1)
    assert work.decoder_frame_flops(ac) == want
    se = configs.SemanticTokenizerConfig(vae_dim=3, encoder_n_filters=4, encoder_ratios=(2,),
                                         encoder_depths=(1, 1), kernel_size=3,
                                         last_kernel_size=3, ffn_expansion=2)
    # dims [4, 8]: stem k3 1->4 at T=2; blocks of 4 at T=2; down conv k4 4->8 at
    # T=1; blocks of 8 at T=1; head k3 8->3 at T=1
    want = (2 * 2 * 3 * 1 * 4 + (2 * 2 * 7 * 4 + 4 * 2 * 4 * 2 * 4) + 2 * 1 * 4 * 4 * 8
            + (2 * 1 * 7 * 8 + 4 * 1 * 8 * 2 * 8) + 2 * 1 * 3 * 8 * 3)
    assert work.encoder_frame_flops(se) == want


def test_portbench_step_work_lm_by_hand():
    cfg = configs.config_from_dict({"decoder_config": {
        "vocab_size": 320, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2}})
    w = work.step_work(cfg, 1, [10], [2], ddpm_steps=3, elem=2)
    lm_weights = 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128)
    assert w["lm_flops"] == 2 * 2 * lm_weights + 4 * 12 * 2 * 4 * 16 + 2 * 64 * 5
    assert w["lm_bytes"] == lm_weights * 2 + 2 * 12 * 2 * 32 * 2 + 2 * 2 * 2 * 32 * 2
    assert w["flops"] == sum(w[k] for k in w if k.endswith("_flops"))
    assert w["bytes"] == sum(w[k] for k in w if k.endswith("_bytes"))


def test_portbench_weights_bytes_match_the_tree():
    """The step's sigma-VAE and head bytes are their weights as the
    benchmark makes them (biases and scales included)."""
    import torch
    from portbench import weights
    from portbench.tests.conftest import tiny_cell
    cfg = configs.config_from_dict(tiny_cell().config_file)
    p = weights.make_weights(cfg, 0, "cpu", torch.float32)

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel() if torch.is_tensor(tree) else 0
    w = work.step_work(cfg, 1, [1], [1], 3, elem=1)
    assert w["sigma_vae_bytes"] == count(p["acoustic_decoder"]) + count(p["semantic_encoder"])
