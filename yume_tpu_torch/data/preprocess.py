"""Preprocessing CLI: VAE latents and umT5 embeddings to disk (counterpart
of yume_tpu/data/preprocess.py; reference
fastvideo/data_preprocess/preprocess_vae_latents.py and
preprocess_text_embeddings.py). Writes ``latent/``, ``prompt_embed/``,
``prompt_attention_mask/`` and the ``videos2caption.json`` manifest that
:class:`.latent_dataset.LatentDataset` reads.

    python -m yume_tpu_torch.data.preprocess --data_dir ./mp4_frame \
        --output_dir ./latents [--max_samples N]
    python -m yume_tpu_torch.data.preprocess --smoke --device cpu --output_dir /tmp/l

The pipeline comes from the sampling CLI's ``load_pipeline`` with random
weights made from seed 0, as the reference's; it runs on ``--device``
(default ``cuda``). ``--smoke`` (or no ``--data_dir``) encodes two
synthetic 5-frame 32×32 clips through the smoke config.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="yume_tpu_torch latent preprocessing")
    p.add_argument("--config", default="ti2v-5B")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_frames", type=int, default=33)
    p.add_argument("--height", type=int, default=352)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max_samples", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda", help="device of the pipeline (cuda or cpu)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from .. import sample
    from .tokenizer import Tokenizer

    shim = sample.build_argparser().parse_args(
        ["--config", args.config, "--device", args.device, "--seed", "0"]
        + (["--smoke"] if args.smoke else []))
    cfg, pipe = sample.load_pipeline(shim)
    tok = Tokenizer(seq_len=cfg.t5.text_len, vocab_size=cfg.t5.vocab_size)
    vae_dtype = next(pipe.vae.parameters()).dtype

    for sub in ("latent", "prompt_embed", "prompt_attention_mask"):
        os.makedirs(os.path.join(args.output_dir, sub), exist_ok=True)

    if args.smoke or not args.data_dir:
        samples = [{"video": np.random.default_rng(i).uniform(
            -1, 1, (5, 32, 32, 3)).astype(np.float32),
            "caption": f"smoke sample {i}", "video_id": f"smoke{i}"} for i in range(2)]
    else:
        from .dataset import ControlVideoDataset

        ds = ControlVideoDataset(args.data_dir, n_sample_frames=args.num_frames,
                                 height=args.height, width=args.width)
        n = min(len(ds), args.max_samples) if args.max_samples else len(ds)
        samples = (ds[i] for i in range(n))

    manifest = []
    for i, s in enumerate(samples):
        video = torch.from_numpy(s["video"])[None].to(pipe.device, vae_dtype)
        with torch.no_grad():
            latent = pipe.vae.encode(video)[0].float().cpu().numpy()
        ids, mask = tok([s["caption"]])
        embed = pipe.encode_text(ids, mask)[0].float().cpu().numpy()
        name = f"{s['video_id']}_{i:06d}.npy"
        np.save(os.path.join(args.output_dir, "latent", name), latent)
        np.save(os.path.join(args.output_dir, "prompt_embed", name), embed)
        np.save(os.path.join(args.output_dir, "prompt_attention_mask", name), mask[0])
        manifest.append({"latent_path": name, "prompt_embed_path": name,
                         "prompt_attention_mask": name, "caption": s["caption"],
                         "length": int(latent.shape[0])})
        print(f"[{i}] {name}: latent {latent.shape}")

    with open(os.path.join(args.output_dir, "videos2caption.json"), "w") as f:
        json.dump(manifest, f)
    print(f"wrote {len(manifest)} samples to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
