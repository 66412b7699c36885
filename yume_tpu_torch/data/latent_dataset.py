"""Precomputed latents and text embeddings (counterpart of
yume_tpu/data/latent_dataset.py; reference LatentDataset,
fastvideo/dataset/latent_datasets.py:9-130): reads what
``python -m yume_tpu_torch.data.preprocess`` writes, with classifier-free
guidance dropout of the text at ``cfg_rate`` to ``uncond_embed.npy``.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

import numpy as np


class LatentDataset:
    def __init__(self, json_path: str, *, cfg_rate: float = 0.0, seed: int = 0):
        self.data_dir = os.path.dirname(json_path)
        self.latent_dir = os.path.join(self.data_dir, "latent")
        self.embed_dir = os.path.join(self.data_dir, "prompt_embed")
        self.mask_dir = os.path.join(self.data_dir, "prompt_attention_mask")
        with open(json_path) as f:
            self.annotations: List[Dict] = json.load(f)
        self.cfg_rate = cfg_rate
        self.rng = random.Random(seed)
        self.uncond_embed = self.uncond_mask = None
        uncond = os.path.join(self.data_dir, "uncond_embed.npy")
        if os.path.exists(uncond):
            self.uncond_embed = np.load(uncond)
            self.uncond_mask = np.ones(self.uncond_embed.shape[0], np.int32)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, idx: int) -> Dict:
        a = self.annotations[idx]
        latent = np.load(os.path.join(self.latent_dir, a["latent_path"]))
        if (self.cfg_rate > 0 and self.rng.random() < self.cfg_rate
                and self.uncond_embed is not None):
            embed, mask = self.uncond_embed, self.uncond_mask
        else:
            embed = np.load(os.path.join(self.embed_dir, a["prompt_embed_path"]))
            mask = np.load(os.path.join(self.mask_dir, a["prompt_attention_mask"]))
        return {"latents": latent, "context": embed, "context_mask": mask,
                "caption": a.get("caption", "")}
