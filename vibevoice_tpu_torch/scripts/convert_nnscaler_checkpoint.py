"""Convert an nnscaler training checkpoint to the port's params tree.

The port of `scripts/convert_nnscaler_checkpoint.py` (the reference's
`vibevoice/scripts/convert_nnscaler_checkpoint_to_transformers.py:20-131`):
strips the `model.model.` prefix (:53), handles a tied or untied lm_head
(:46-56), merges `model_part-*` shards, and writes either the port's native
`.npz` checkpoint or an HF-style flat safetensors file (verified by loading
it back).  The tensors are converted on the card unless `--device cpu` is
given:

  python -m vibevoice_tpu_torch.scripts.convert_nnscaler_checkpoint \\
      --checkpoint ckpt_dir --config config.json --output out_dir
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil

import torch


def load_nnscaler_state(ckpt_path: str, device="cpu") -> dict:
    """torch.load the checkpoint (single file or model_part-* shards) and
    return a flat state dict of fp32 tensors on `device`, with
    `model.model.` stripped."""
    paths = [ckpt_path]
    if os.path.isdir(ckpt_path):
        parts = sorted(glob.glob(os.path.join(ckpt_path, "*model_part-*")))
        paths = parts or sorted(glob.glob(os.path.join(ckpt_path, "*.pt")))
    sd = {}
    for p in paths:
        blob = torch.load(p, map_location="cpu", weights_only=False)
        state = blob.get("model", blob.get("state_dict", blob)) if isinstance(blob, dict) else blob
        for k, v in state.items():
            if not isinstance(v, torch.Tensor):
                continue
            # nnscaler prefixes the wrapped module with an extra `model.`
            if k.startswith("model.model."):
                k = k[len("model."):]
            sd[k] = v.detach().to(device, torch.float32)
    return sd


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vibevoice_tpu_torch.scripts.convert_nnscaler_checkpoint")
    ap.add_argument("--checkpoint", required=True, help="nnscaler ckpt file/dir")
    ap.add_argument("--config", required=True, help="model config JSON (reference layout)")
    ap.add_argument("--output", required=True, help="output dir")
    ap.add_argument("--format", choices=["native", "safetensors"], default="native")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs import config_from_json
    from ..device import resolve_device
    from ..utils.checkpoint import (load_hf_checkpoint, params_from_flat, save_native,
                                    save_safetensors)
    device = resolve_device(args.device)

    cfg = config_from_json(args.config)
    sd = load_nnscaler_state(args.checkpoint, device)
    print(f"loaded {len(sd)} tensors")

    if "lm_head.weight" not in sd and not cfg.decoder.tie_word_embeddings:
        # untied head missing -> fall back to tied weights (ref :46-56)
        sd["lm_head.weight"] = sd["model.language_model.embed_tokens.weight"]

    os.makedirs(args.output, exist_ok=True)
    if args.format == "safetensors":
        save_safetensors(sd, os.path.join(args.output, "model.safetensors"))
        shutil.copy(args.config, os.path.join(args.output, "config.json"))
        # verify by reloading through the importer
        params, _ = load_hf_checkpoint(args.output, cfg, device=device)
        print("reload verification OK")
    else:
        params = params_from_flat(sd, cfg)
        save_native(params, os.path.join(args.output, "params"))
        print("native checkpoint saved")
    n = sum(v.numel() for v in sd.values())
    print(f"total parameters: {n/1e9:.2f}B -> {args.output}")
    return params


if __name__ == "__main__":
    main()
