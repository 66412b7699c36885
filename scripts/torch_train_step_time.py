"""Time the PyTorch port's 5B full fine-tune step on one GPU, as phase 7a of
chip_smoke.py runs it, for the package of a given checkout:

    python3 scripts/torch_train_step_time.py [--root DIR] [--steps N] [--label L]

``--root`` is the checkout whose ``yume_tpu_torch`` is imported (default:
this one), so two commits compare on one card by running this script once
per checkout, alternating (A, B, B, A). The model, state and batches are
chip_smoke.py's: the full-width Yume-5B DiT with its MVDT side block,
random bf16 parameters from seed 6, per-block remat, clipped AdamW + EMA
over 2,805 packed tokens. Two warm-up steps (kernel builds, allocator),
then ``--steps`` timed ones, each on the host's clock between two
``torch.cuda.synchronize()``. Prints one JSON line: the label, the card's
name and power limit, every step time, their median and the peak device
memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

TRAIN_F_HIST, TRAIN_LFZ, TRAIN_H, TRAIN_W = 9, 8, 22, 40
TEXT_LEN = 512


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_step_time: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import yume_tpu_torch
    from yume_tpu_torch.configs import ti2v_5b
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.pipelines.ti2v import _random_init_
    from yume_tpu_torch.training.train_step import (TrainConfig, draw_step, init_train_state,
                                                    make_train_step, trainable_params)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(ti2v_5b().dit, mvdt=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    model = WanDiT(cfg, torch.bfloat16, device="meta", param_dtype=torch.bfloat16,
                   remat=True).to_empty(device="cuda")
    _random_init_(model, gen)
    tc = TrainConfig(latent_frame_zero=TRAIN_LFZ)
    state = init_train_state(trainable_params(model), tc)
    step_fn = make_train_step(model, tc)
    f = TRAIN_F_HIST + TRAIN_LFZ

    def batch(step):
        g = torch.Generator(device="cuda").manual_seed(100 + step)
        return {"latents": torch.randn((1, f, TRAIN_H, TRAIN_W, cfg.in_dim), generator=g,
                                       device="cuda"),
                "context": torch.randn((1, TEXT_LEN, cfg.text_dim), generator=g,
                                       device="cuda") * 0.02}

    times, losses = [], []
    for i in range(2 + args.steps):
        b = batch(i)
        draws = draw_step(b, tc, torch.Generator(device="cuda").manual_seed(200 + i))
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, metrics = step_fn(state, b, draws)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    timed = times[2:]
    print(json.dumps({"label": args.label, "package": yume_tpu_torch.__file__, "card": smi,
                      "warmup_s": times[:2], "step_s": timed,
                      "median_step_s": statistics.median(timed), "min_step_s": min(timed),
                      "losses": losses,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
