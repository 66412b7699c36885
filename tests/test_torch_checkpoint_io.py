"""The trainer's checkpoint I/O against the JAX package on the CPU:

* ``export_dit_state_dict`` equals JAX's key for key and bit for bit: the
  tiny 5B DiT with MVDT (``sideblock.*``, ``mask_token``), the tiny 14B DiT
  (``img_emb.proj.*``, ``k_img``/``v_img``), and with LoRA adapters merged;
* ``save_sharded_safetensors`` (written by hand) in JAX's layout: the same
  shard names, index and key deal; JAX's reader (the ``safetensors``
  package) reads every tensor back bit for bit, and JAX's converter maps
  the files back onto the parameters it started from;
* ``train.main``: ``--export_torch_dir`` after training (the EMA, LoRA
  merged) loads through ``sample.load_torch_weights``; ``--ckpt_dir`` loads
  that export strictly (a missing or unknown tensor raises, ``--MVDT``
  over a checkpoint without the side block too) and ``--data_dir`` takes
  its encoders from ``--ckpt_dir`` when ``--encoders_dir`` is not given;
* the async ``Checkpointer``: a save holds the state as it was when
  ``save`` returned, the newest three files remain.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import perturb, port_config, torch_threads
from yume_tpu.configs import DiTConfig
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.training import lora as jlora
from yume_tpu.utils import checkpoint as jckpt
from yume_tpu_torch import sample, train
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.training import lora as tlora
from yume_tpu_torch.training.train_step import TrainConfig, init_train_state
from yume_tpu_torch.utils import checkpoint as tckpt
from yume_tpu_torch.utils import convert

CFG_5B = DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128, freq_dim=32,
                   text_dim=16, num_heads=4, num_layers=2, framepack=True, mvdt=True)
CFG_14B = DiTConfig(model_type="i2v", in_dim=18, out_dim=8, dim=64, ffn_dim=128, freq_dim=32,
                    text_dim=16, num_heads=4, num_layers=2, framepack=True,
                    image_context_len=5, image_dim=12)
SMOKE = ["--smoke", "--device", "cpu", "--max_train_steps", "2", "--checkpointing_steps", "0"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _jax_params(cfg, seed):
    dit = JaxDiT(cfg, dtype=jnp.float32)
    kw = {}
    if cfg.image_context_len:
        kw["clip_context"] = jnp.zeros((1, 5, 12))
    if cfg.mvdt:
        kw.update(mvdt_rng=jax.random.PRNGKey(0), mvdt_keep=20)
    shapes = jax.eval_shape(
        lambda k: dit.init(k, jnp.zeros((1, 4, 8, 8, cfg.in_dim)), jnp.zeros((1, 4)),
                           jnp.zeros((1, 8, 16)), packed=True, latent_frame_zero=2, **kw),
        jax.random.PRNGKey(0))
    return {"params": perturb(shapes["params"], seed)}


def _port_model(cfg, params):
    model = tdit.WanDiT(port_config(cfg), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(model, convert.dit_state_dict(params, cfg.num_layers))
    return model


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        assert g.dtype == np.float32 and g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


@pytest.mark.parametrize("cfg,lora", [(CFG_5B, False), (CFG_14B, False), (CFG_14B, True)],
                         ids=["5b-mvdt", "14b", "14b-lora-merged"])
def test_export_equals_jax(cfg, lora):
    params = _jax_params(cfg, 3)
    model = _port_model(cfg, params)
    if lora:
        # adapters with a non-zero B, as after training
        lora_j = jlora.init_lora(jax.random.PRNGKey(4), params, rank=4)
        lora_j = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, lora_j)
        lora_t = {k: torch.from_numpy(v.copy())
                  for k, v in convert.lora_state_dict(lora_j).items()}
        tlora.LoRAModel(model, lora_t)
        got = tckpt.export_dit_state_dict(tlora.base_state_dict(model), lora_t)
        want = jckpt.export_dit_state_dict(jlora.merge_lora(params, lora_j), cfg.num_layers)
    else:
        got = tckpt.export_dit_state_dict(model.state_dict())
        want = jckpt.export_dit_state_dict(params, cfg.num_layers)
    names = {"5b-mvdt": ("sideblock.ffn.0.weight", "mask_token"),
             "14b": ("img_emb.proj.0.weight", "blocks.1.cross_attn.v_img.weight")}
    for k in names["5b-mvdt" if cfg.mvdt else "14b"]:
        assert k in got
    _assert_same(got, want)


def test_writer_layout_and_jax_reads_it_bit_for_bit(tmp_path):
    params = _jax_params(CFG_14B, 5)
    sd = tckpt.export_dit_state_dict(_port_model(CFG_14B, params).state_dict())
    # a bf16 tensor, a 0-d and an empty one are written as F32 too
    sd.update(extra_bf16=torch.randn(3, 5).to(torch.bfloat16), extra_scalar=torch.tensor(2.5),
              extra_empty=torch.zeros(0, 4))
    n_bytes = tckpt.save_sharded_safetensors(sd, str(tmp_path / "port"))
    jckpt.save_sharded_safetensors({k: v.float().numpy() for k, v in sd.items()},
                                   str(tmp_path / "jax"))
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d)) == [
            f"diffusion_pytorch_model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)] + [
            "diffusion_pytorch_model.safetensors.index.json"]
    index = [json.load(open(tmp_path / d / "diffusion_pytorch_model.safetensors.index.json"))
             for d in ("port", "jax")]
    assert index[0] == index[1]
    assert index[0]["metadata"]["total_size"] == n_bytes == sum(
        v.numel() * 4 for v in sd.values())
    want = {k: v.float().numpy() for k, v in sd.items()}
    _assert_same(jckpt.load_safetensors_state_dict(str(tmp_path / "port")), want)
    _assert_same(tckpt.load_safetensors_state_dict(str(tmp_path / "port")), want)
    # the reference's converter maps the port's files back onto its parameters
    back = jckpt.convert_dit_state_dict(
        {k: v for k, v in jckpt.load_safetensors_state_dict(str(tmp_path / "port")).items()
         if not k.startswith("extra")}, CFG_14B.num_layers)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_b) == len(flat_p)
    for path, leaf in flat_b:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_p[path]))


def _encoders_into(d):
    """The 5B trainer's smoke VAE and umT5 (port modules, seeded) as the
    released ``.pth`` files in ``d``."""
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline

    pipe = TI2VPipeline.from_config(train.smoke_config(False), device="cpu", seed=3,
                                    init_t5=True, init_dit=False, dtype=torch.float32)
    torch.save(pipe.vae.state_dict(), os.path.join(d, sample.VAE_FILE))
    torch.save(pipe.t5.state_dict(), os.path.join(d, sample.T5_FILE))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``train.main --smoke --lora_rank 4 --export_torch_dir``: the EMA
    adapters merged into the base, beside the smoke encoders."""
    d = tmp_path_factory.mktemp("export")
    out = tmp_path_factory.mktemp("run")
    train.main(SMOKE + ["--output_dir", str(out), "--lora_rank", "4",
                        "--export_torch_dir", str(d)])
    run = train.main.last_run
    _encoders_into(str(d))
    return d, run


def test_export_cli_loads_through_the_sample_loader(exported):
    d, run = exported
    assert run["export"]["tensors"] == len(tckpt.load_safetensors_state_dict(str(d)))
    pipe = sample.load_torch_weights(train.smoke_config(False), str(d), device="cpu",
                                     dtype=torch.float32)
    sd = tckpt.load_safetensors_state_dict(str(d))
    for k, v in pipe.dit.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_ckpt_dir_loads_strictly(exported, tmp_path):
    d, _ = exported
    cfg = train.smoke_config(False).dit
    model = tdit.WanDiT(cfg, torch.float32, device="meta").to_empty(device="cpu")
    train.load_dit_checkpoint(model, str(d))
    sd = tckpt.load_safetensors_state_dict(str(d))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    assert train.main(SMOKE + ["--output_dir", str(tmp_path / "a"), "--ckpt_dir", str(d)]) == 0
    assert np.isfinite(train.main.last_run["losses"]).all()
    # a checkpoint without the MVDT side block does not load into an MVDT DiT
    with pytest.raises(KeyError, match="lacks"):
        train.main(SMOKE + ["--output_dir", str(tmp_path / "b"), "--ckpt_dir", str(d),
                            "--MVDT"])
    # a tensor missing, then one the model does not have
    for name, change in (("missing", lambda s: s.pop("head.head.bias")),
                         ("unknown", lambda s: s.update({"blocks.9.extra": torch.ones(2)}))):
        bad = tmp_path / name
        s = dict(sd)
        change(s)
        tckpt.save_sharded_safetensors(s, str(bad))
        with pytest.raises(KeyError, match="lacks" if name == "missing" else "unknown"):
            train.main(SMOKE + ["--output_dir", str(tmp_path / "c"), "--ckpt_dir", str(bad)])
    with pytest.raises(SystemExit, match="no DiT safetensors"):
        train.main(SMOKE + ["--output_dir", str(tmp_path / "d"), "--ckpt_dir", str(tmp_path)])


def test_data_dir_takes_its_encoders_from_ckpt_dir(exported, tmp_path, monkeypatch):
    from test_torch_data import write_clip

    d, _ = exported
    root = tmp_path / "clips"
    base = str(root / "Keys_W_Mouse_·" / "walk_frames_0-9")
    write_clip(base + ".mp4", 9, seed=41)
    with open(base + ".txt", "w", encoding="utf-8") as f:
        f.write("Start Frame: 0\nEnd Frame: 9\nKeys: W\nMouse: ·\n")
    seen = []
    load = sample.load_torch_weights

    def spy(cfg, ckpt_dir, **kw):
        seen.append(ckpt_dir)
        return load(cfg, ckpt_dir, **kw)

    monkeypatch.setattr(sample, "load_torch_weights", spy)
    assert train.main(SMOKE + ["--output_dir", str(tmp_path / "o"), "--data_dir", str(root),
                               "--ckpt_dir", str(d), "--max_train_steps", "1"]) == 0
    assert seen == [str(d)]
    assert np.isfinite(train.main.last_run["losses"]).all()


def test_checkpointer_snapshots_and_keeps_three(tmp_path):
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(5)}
    state = init_train_state(params, TrainConfig())
    ck = tckpt.Checkpointer(str(tmp_path))
    for step in range(1, 6):
        state.step = step
        with torch.no_grad():
            for p in state.params.values():
                p.fill_(float(step))
        ck.save(state)
        with torch.no_grad():  # the next step's in-place update
            for p in state.params.values():
                p.add_(100.0)
    ck.close()
    assert len(ck.hold_s) == 5
    files = tckpt.checkpoints(str(tmp_path))
    assert [os.path.basename(f) for f in files] == [f"checkpoint-{s}.pt" for s in (3, 4, 5)]
    for s, f in zip((3, 4, 5), files):
        saved = torch.load(f, weights_only=True)
        assert saved["step"] == s
        assert all(torch.equal(t, torch.full_like(t, float(s)))
                   for t in saved["params"].values())
    restored = tckpt.restore_checkpoint(str(tmp_path), init_train_state(
        {"w": torch.ones(4, 3), "b": torch.ones(5)}, TrainConfig()))
    assert restored.step == 5 and torch.equal(restored.params["b"], torch.full((5,), 5.0))


def test_checkpointer_raises_a_failed_write(tmp_path):
    state = init_train_state({"w": torch.zeros(2)}, TrainConfig())
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    ck = tckpt.Checkpointer(str(blocker))
    ck.save(state)
    with pytest.raises(OSError):
        ck.wait()
