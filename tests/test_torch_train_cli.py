"""The port's training entry point, ``python -m yume_tpu_torch.train``, on the CPU
at its ``--smoke`` size: the plain flow-matching run, ``--MVDT``, ADD
distillation (``--Distil``, with ``--MVDT``), LoRA with
the in-training validation rollout, the same for ``--config i2v-14B`` (and
its ``--data_dir`` branch), sequence-parallel training at ``--sp 2`` (two
spawned gloo ranks) against the one-rank run, the refusals (``--sp`` with
``--MVDT`` or ``--lora_rank``, as the reference's asserts; a full 14B
fine-tune on a CUDA device, not ported), and a
``--checkpointing_steps``/``--resume`` round trip through the async
checkpointer that must give the same losses and parameters as the run it
interrupted (the CPU is deterministic, so bit for bit).
"""

import os

import numpy as np
import pytest
import torch

from torch_parity import torch_threads
from yume_tpu_torch import train

BASE = ["--smoke", "--device", "cpu", "--max_train_steps", "2",
        "--checkpointing_steps", "0"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("extra", [[], ["--MVDT"], ["--remat", "--optimizer", "adam8bit"],
                                   ["--lora_rank", "4", "--validation_steps", "2"],
                                   ["--Distil", "--MVDT"]],
                         ids=["plain", "mvdt", "remat-adam8bit", "lora-validation",
                              "distil-mvdt"])
def test_smoke_runs(tmp_path, extra, capsys):
    assert train.main(BASE + ["--output_dir", str(tmp_path)] + extra) == 0
    run = train.main.last_run
    assert len(run["losses"]) == 2
    assert np.isfinite(run["losses"]).all() and np.isfinite(run["grad_norms"]).all()
    if "--Distil" in extra:
        # the ADD discriminator trains beside the generator: finite GAN and
        # hinge losses, printed on every step's line
        assert np.isfinite(run["gan_losses"]).all() and np.isfinite(run["d_losses"]).all()
        assert capsys.readouterr().out.count(" gan_loss=") == 2
    if "--lora_rank" not in extra:
        assert all(g > 0 for g in run["grad_norms"])
    else:
        # from a random init the head projection is zero (as flax initialises
        # it), so no gradient reaches the adapters: the smoke run only shows
        # that the LoRA path runs end to end
        # rank-4 adapters of the 8 attention projections of 2 blocks
        assert run["trainable"] == 2 * 8 * 4 * (64 + 64)
        assert os.path.exists(tmp_path / "generated_test_video" / "val_latents_step2.npy")


@pytest.mark.parametrize("extra", [[], ["--MVDT", "--Distil"],
                                   ["--lora_rank", "4", "--validation_steps", "2"],
                                   ["--data_dir"]],
                         ids=["plain", "mvdt-distil", "lora-validation", "data-dir"])
def test_i2v_smoke_runs(tmp_path, extra):
    if extra == ["--data_dir"]:
        from test_torch_data import write_clip

        base = str(tmp_path / "clips" / "Keys_W_Mouse_·" / "walk_frames_0-9")
        write_clip(base + ".mp4", 9, seed=42)
        with open(base + ".txt", "w", encoding="utf-8") as f:
            f.write("Start Frame: 0\nEnd Frame: 9\nKeys: W\nMouse: ·\n")
        extra = ["--data_dir", str(tmp_path / "clips"), "--max_train_steps", "3"]
    assert train.main(BASE + ["--config", "i2v-14B", "--output_dir", str(tmp_path / "o")]
                      + extra) == 0
    run = train.main.last_run
    assert np.isfinite(run["losses"]).all() and np.isfinite(run["grad_norms"]).all()
    if "--lora_rank" in extra:
        # rank-4 adapters of the 10 projections (k_img and v_img too) of 2 blocks
        assert run["trainable"] == 2 * 10 * 4 * (64 + 64)
        assert os.path.exists(tmp_path / "o" / "generated_test_video" /
                              "val_latents_step2.npy")
    else:
        assert all(g > 0 for g in run["grad_norms"])
    if "--Distil" in extra:
        assert np.isfinite(run["gan_losses"]).all() and np.isfinite(run["d_losses"]).all()
    if "--data_dir" in extra:
        # 9 frames of 64×64: the i2v branch packs 4 history + 2 tail latent
        # frames of 16×16, the v2v branch 3 + 2 (seed 42 + 31 draws i2v first)
        assert run["branch"][0] == "i2v"
        assert {(b, n) for b, n in zip(run["branch"], run["packed_tokens"])} <= {
            ("i2v", 288), ("v2v", 272)}
        assert len(run["encode_s"]) == 3


@pytest.mark.parametrize("flag", [["--sp", "2", "--MVDT"], ["--sp", "2", "--lora_rank", "4"]])
def test_unported_flags_refuse(tmp_path, flag):
    """What the reference refuses under ``--sp`` (its asserts), refused with
    its reasons before any rank starts."""
    match = "dense-only" if "--MVDT" in flag else "--sp with --lora_rank is not supported"
    with pytest.raises(ValueError, match=match):
        train.main(BASE + ["--output_dir", str(tmp_path)] + flag)


# the exported EMA's change from its initial weights, relative L2 over the
# export, of the --sp 2 run against one rank's
EXPORT_MOVE_REL = 1e-4


def _exported(path):
    from yume_tpu_torch.utils.checkpoint import load_safetensors_state_dict

    return load_safetensors_state_dict(str(path))


def _clip_tree(root):
    """A ``--data_dir`` tree of one 9-frame clip with its controls."""
    from test_torch_data import write_clip

    base = str(root / "Keys_W_Mouse_·" / "walk_frames_0-9")
    write_clip(base + ".mp4", 9, seed=42)
    with open(base + ".txt", "w", encoding="utf-8") as f:
        f.write("Start Frame: 0\nEnd Frame: 9\nKeys: W\nMouse: ·\n")
    return str(root)


@pytest.mark.parametrize("flags", [["--sp_kind", "ring", "--Distil"], ["--config", "i2v-14B"],
                                   ["--sp_kind", "usp", "--data_dir"]],
                         ids=["ring-distil", "i2v", "usp-data-dir"])
def test_sp_smoke_matches_one_rank(tmp_path, monkeypatch, capfd, flags):
    """``--sp 2`` (two spawned gloo ranks) against the one-rank run: the
    losses within 1e-5 and the grad norms within 1e-4 relative; the
    exported EMA within 1e-5, and its change from the initial weights (a
    0-step run's export) within EXPORT_MOVE_REL; both ranks end with the
    same parameters; rank 0 alone prints and saves one set of checkpoints,
    from which ``--resume`` continues (the 14B, whose export is the resumed
    run's); under ``--data_dir`` rank 0 alone reads and encodes the clips
    and hands each batch to the other."""
    i2v = "--config" in flags
    if "--data_dir" in flags:
        flags = flags + [_clip_tree(tmp_path / "clips")]
    # the discriminator's DINO ViT takes seconds a step on the CPU: one step
    steps = 1 if "--Distil" in flags else 2
    common = ["--smoke", "--device", "cpu", "--checkpointing_steps", "1"] + flags
    one, sp, init = tmp_path / "one", tmp_path / "sp", tmp_path / "init"
    export = ["--export_torch_dir", str(sp / "export")]
    train.main(common + ["--output_dir", str(one), "--max_train_steps", str(steps + i2v),
                         "--export_torch_dir", str(one / "export")])
    want = train.main.last_run
    train.main(["--smoke", "--device", "cpu", "--max_train_steps", "0", "--output_dir",
                str(init), "--export_torch_dir", str(init / "export")]
               + (flags if i2v else []))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # each spawned rank: one thread
    capfd.readouterr()
    train.main(common + ["--sp", "2", "--output_dir", str(sp), "--max_train_steps", str(steps)]
               + ([] if i2v else export))
    got = train.main.last_run
    out = capfd.readouterr().out
    assert "launch: 2 ranks over gloo" in out and out.count(f"step {steps}/{steps} ") == 1
    checksums = got["param_checksums"]
    assert len(checksums) == 2 and checksums[0] == checksums[1]
    keys = ["losses", "gan_losses", "d_losses"] if "--Distil" in flags else ["losses"]
    for key in keys:
        np.testing.assert_allclose(got[key], want[key][:steps], rtol=1e-5, atol=0, err_msg=key)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"][:steps], rtol=1e-4, atol=0)
    assert sorted(os.listdir(sp)) == [f"checkpoint-{i}.pt" for i in range(1, steps + 1)] + (
        [] if i2v else ["export"])
    if "--data_dir" in flags:
        assert out.count("dataset: 1 clips") == 1 and len(got["encode_s"]) == steps
    if i2v:
        train.main(common + ["--sp", "2", "--output_dir", str(sp), "--max_train_steps", "3",
                             "--resume"] + export)
        assert capfd.readouterr().out.count("resumed at step 2") == 1
        np.testing.assert_allclose(train.main.last_run["losses"], want["losses"][2:],
                                   rtol=1e-5, atol=0)
        assert "checkpoint-3.pt" in os.listdir(sp)
    exp_got, exp_want = _exported(sp / "export"), _exported(one / "export")
    exp_init = _exported(init / "export")
    assert set(exp_got) == set(exp_want) == set(exp_init)
    for name, t in exp_want.items():
        torch.testing.assert_close(exp_got[name], t, atol=1e-5, rtol=0, msg=name)
    # the EMA moves by ~lr·(1 - decay) a step, far below the 1e-5 above
    moved = torch.cat([(t - exp_init[n]).reshape(-1) for n, t in exp_want.items()])
    moved_got = torch.cat([(exp_got[n] - exp_init[n]).reshape(-1) for n in exp_want])
    assert moved.norm() > 0
    assert (moved_got - moved).norm() <= EXPORT_MOVE_REL * moved.norm()


def test_full_14b_fine_tune_on_cuda_refuses_before_allocating(tmp_path):
    """Refused before any CUDA call (this sandbox has no card), naming FSDP's
    item; LoRA and --smoke go on."""
    with pytest.raises(NotImplementedError, match="FSDP.*item 8"):
        train.main(["--config", "i2v-14B", "--device", "cuda", "--output_dir",
                    str(tmp_path)])


def test_lora_refuses_distil(tmp_path):
    with pytest.raises(ValueError, match="plain flow-matching"):
        train.main(BASE + ["--output_dir", str(tmp_path), "--lora_rank", "4", "--Distil"])


def test_checkpoint_resume_round_trip(tmp_path):
    whole, split = tmp_path / "whole", tmp_path / "split"
    common = ["--smoke", "--device", "cpu", "--checkpointing_steps", "2", "--MVDT"]
    train.main(common + ["--output_dir", str(whole), "--max_train_steps", "4"])
    want = train.main.last_run["losses"]
    train.main(common + ["--output_dir", str(split), "--max_train_steps", "2"])
    assert train.main.last_run["losses"] == want[:2]
    train.main(common + ["--output_dir", str(split), "--max_train_steps", "4", "--resume"])
    assert train.main.last_run["losses"] == want[2:]
    a = torch.load(whole / "checkpoint-4.pt", weights_only=True)
    b = torch.load(split / "checkpoint-4.pt", weights_only=True)
    assert a["step"] == b["step"] == 4
    for part in ("params", "ema_params"):
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), (part, name)
    for name, t in a["opt_state"]["mu"].items():
        assert torch.equal(t, b["opt_state"]["mu"][name]), name
