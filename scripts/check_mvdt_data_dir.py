"""MVDT keep counts on ``--data_dir`` batches: the JAX trainer against the
port, on the CPU.

A ``--data_dir`` batch holds ``(num_frames - 1) / s_t + 1`` latent frames;
the JAX trainer counts ``latent_frame_zero`` more and takes its MVDT keep
counts from that geometry's unpacked tokens. This script writes one
9-frame clip, runs ``yume_tpu.train.main --MVDT --data_dir`` and
``yume_tpu_torch.train.main`` outside the smoke run (the 5B config replaced
by the trainer's smoke pipeline config, 9 frames of 64×64) and prints, for
each, the token count of every masked pass and its keep count; then the
same counts at the 5B's full width (33 frames of 352×640).

    JAX_PLATFORMS=cpu python scripts/check_mvdt_data_dir.py
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_tree(root):
    import cv2

    base = os.path.join(root, "Keys_W_Mouse_·", "walk_frames_0-9")
    os.makedirs(os.path.dirname(base))
    vw = cv2.VideoWriter(base + ".mp4", cv2.VideoWriter_fourcc(*"mp4v"), 16, (64, 64))
    rng = np.random.default_rng(0)
    for _ in range(9):
        vw.write(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    vw.release()
    with open(base + ".txt", "w", encoding="utf-8") as f:
        f.write("Start Frame: 0\nEnd Frame: 9\nKeys: W\nMouse: ·\n")


def run_jax(root, out):
    from yume_tpu import configs, train
    from yume_tpu.models import dit

    cfg = configs.PipelineConfig(
        name="small", dit=configs.DiTConfig(
            model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128, freq_dim=32,
            text_dim=16, text_len=16, num_heads=4, num_layers=2, framepack=True),
        vae=configs.VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                              temporal_downsample=(True, False), stride=(2, 8, 8),
                              patchify=2),
        t5=configs.T5Config(vocab_size=256, dim=16, dim_attn=16, dim_ffn=24, num_heads=2,
                            num_layers=1, text_len=16),
        latent_frame_zero=2)
    configs.CONFIGS["ti2v-5B"] = lambda: cfg
    seen, real = [], dit.WanDiT._maybe_mask

    def spy(self, tokens, mod, cos, sin, rng, keep):
        seen.append((int(tokens.shape[1]), keep))
        return real(self, tokens, mod, cos, sin, rng, keep)

    dit.WanDiT._maybe_mask = spy
    train.main(["--data_dir", root, "--MVDT", "--num_frames", "9", "--height", "64",
                "--width", "64", "--max_train_steps", "3", "--checkpointing_steps", "0",
                "--output_dir", out])
    # the trace of dit.init runs the geometry's 7 frames; the steps the batch's
    return sorted(set(s for s in seen if s[1] is not None))


def run_port(root, out):
    from yume_tpu_torch import configs, train
    from yume_tpu_torch.models.dit import WanDiT

    configs.CONFIGS["ti2v-5B"] = lambda: train.smoke_config(False)
    seen, real = [], WanDiT._maybe_mask
    WanDiT._maybe_mask = lambda self, tokens, *a: seen.append(
        (tokens.shape[1], a[-1])) or real(self, tokens, *a)
    train.main(["--device", "cpu", "--MVDT", "--data_dir", root, "--num_frames", "9",
                "--height", "64", "--width", "64", "--max_train_steps", "3",
                "--checkpointing_steps", "0", "--output_dir", out])
    return [s for s in seen if s[1] is not None]


def main():
    from yume_tpu_torch.models.dit import packed_token_count

    with tempfile.TemporaryDirectory() as d:
        write_tree(os.path.join(d, "clips"))
        jax_seen = run_jax(os.path.join(d, "clips"), os.path.join(d, "jax"))
        port_seen = run_port(os.path.join(d, "clips"), os.path.join(d, "port"))
    ratios = [0.30 + 0.025 * i for i in range(9)]
    print("small geometry: batch 5 latent frames of 8x8, packed tokens",
          packed_token_count(3, 2, 8, 8, (1, 2, 2)))
    print("  JAX (tokens, keep) of each masked pass traced:", jax_seen)
    print("  port (tokens, keep) of each masked pass:", port_seen)
    batch = packed_token_count(1, 8, 22, 40, (1, 2, 2))
    unpacked = (9 + 8) * 11 * 20
    print(f"5B full width, 33 frames of 352x640: batch {batch} packed tokens; JAX's keeps "
          f"from {unpacked} unpacked: {[int(unpacked * (1 - r)) for r in ratios]}; "
          f"the port's: {[int(batch * (1 - r)) for r in ratios]}")


if __name__ == "__main__":
    main()
