"""Configuration dataclasses of the PyTorch port: the port's own copy of
yume_tpu/configs/__init__.py, field for field and default for default
(``tests/test_torch_configs.py`` pins that the two agree), so the port
imports nothing of the JAX package.

Single typed config tree replacing the reference's three config layers
(EasyDict WAN_CONFIGS, per-driver argparse, diffusers register_to_config;
see reference wan/configs/__init__.py:15-20, wan23/configs/wan_ti2v_5B.py,
wan23/textimage2video.py:129-142, wan/image2video.py:140-153).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Wan DiT backbone hyper-parameters.

    Mirrors reference wan23/modules/model.py:380-395 (5B) and
    wan/modules/model.py:554-600 (14B).
    """

    model_type: str = "ti2v"  # 't2v' | 'i2v' | 'ti2v'
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 48
    dim: int = 3072
    ffn_dim: int = 14336
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 48
    num_heads: int = 24
    num_layers: int = 30
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    # FramePack history compression (reference wan23/modules/model.py:588-741)
    framepack: bool = True
    # MVDT side interpolater + mask token (reference wan23/modules/model.py:531-545)
    mvdt: bool = False
    mask_ratio: float = 0.3
    # 14B i2v variant: CLIP image-context branch with 257 tokens prepended
    # to the text context (reference wan/modules/model.py:370-371).
    image_context_len: int = 0  # 257 for i2v-14B, 0 otherwise
    image_dim: int = 1280  # CLIP feature width feeding MLPProj (14B)
    # RoPE table length (reference wan23/modules/model.py:475: rope_params(1024, ...))
    rope_max_len: int = 1024
    rope_theta: float = 10000.0
    # W8A8: run the big block matmuls as int8×int8 on the tensor cores
    # with dynamic per-token activation scales (ops/quant_matmul.py)
    w8a8: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def __post_init__(self):
        assert self.dim % self.num_heads == 0
        assert (self.dim // self.num_heads) % 2 == 0


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Causal 3D VAE hyper-parameters.

    Wan2.2 values from reference wan23/modules/vae2_2.py:909-1070 and
    wan23/configs/wan_ti2v_5B.py:16-17; Wan2.1 values from
    wan/modules/vae.py:483-663.
    """

    z_dim: int = 48
    base_dim: int = 160
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    dropout: float = 0.0
    stride: Tuple[int, int, int] = (4, 16, 16)
    # Wan2.2 patchifies 2x2 pixels into channels before the encoder
    # (reference wan23/modules/vae2_2.py:286-320).
    patchify: int = 2
    # 'wan22': AvgDown/DupUp shortcut stages (vae2_2.py); 'wan21': plain
    # residual stages with channel-halving upsamples (wan/modules/vae.py).
    arch: str = "wan22"


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umT5-XXL encoder (reference wan/modules/t5.py:472-513)."""

    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_distance: int = 128
    dropout: float = 0.0
    text_len: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """XLM-RoBERTa-CLIP ViT-H/14 visual encoder (reference wan/modules/clip.py:501-541)."""

    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32
    out_tokens: int = 257  # use_31_block: tokens from the 31st block


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full generation-pipeline configuration (one model generation)."""

    name: str = "ti2v-5B"
    dit: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    clip: CLIPConfig | None = None
    num_train_timesteps: int = 1000
    # number of trailing latent frames denoised per autoregressive segment
    # (reference fastvideo/sample/sample.py:769-790: 9 for 14B; sample_5b.py: 8)
    latent_frame_zero: int = 8
    # segments export at 16 fps (reference fastvideo/sample/sample.py:862,
    # sample_5b.py:1080: 2 s = 32 frames @ 16 fps)
    sample_fps: int = 16
    sample_shift: float = 5.0
    sample_steps: int = 50
    sample_guide_scale: float = 5.0
    # dual-expert MoE boundary: sigma ≥ boundary → high-noise expert
    # (reference wan23/configs/wan_i2v_A14B.py:36; None = single-expert)
    boundary: float | None = None
    frame_num: int = 121
    sample_neg_prompt: str = (
        "色调艳丽,过曝,静态,细节模糊不清,字幕,风格,作品,画作,画面,静止,整体发灰,最差质量,"
        "低质量,JPEG压缩残留,丑陋的,残缺的,多余的手指,画得不好的手部,画得不好的脸部,畸形的,"
        "毁容的,形态畸形的肢体,手指融合,静止不动的画面,杂乱的背景,三条腿,背景人很多,倒着走"
    )

    def check_i2v_channels(self) -> "PipelineConfig":
        """Validate the coupled i2v channel arithmetic that tiny smoke
        configs (sample.py/train.py/tests) must keep in sync with the real
        14B numbers: the DiT input is [x (z), msk (stride_t·(stride_t+... )),
        VAE(y) (z)] → in_dim = 2·z + mask_ch where mask_ch = vae.stride[0]
        (4 for Wan2.1: 36 = 16+4+16), out_dim = z, and the CLIP branch's
        token count/width must match the DiT cross-attn image slots."""
        if self.dit.model_type == "i2v":
            z, s0 = self.vae.z_dim, self.vae.stride[0]
            assert self.dit.in_dim == 2 * z + s0, (
                f"i2v in_dim must be 2*z_dim+stride_t = {2 * z + s0}, "
                f"got {self.dit.in_dim}")
            assert self.dit.out_dim == z, (self.dit.out_dim, z)
            if self.clip is not None:
                assert self.dit.image_context_len == self.clip.out_tokens, (
                    self.dit.image_context_len, self.clip.out_tokens)
                assert self.dit.image_dim == self.clip.dim, (
                    self.dit.image_dim, self.clip.dim)
        return self


def ti2v_5b() -> PipelineConfig:
    """Yume-1.5 / 5B / 720P (reference wan23/textimage2video.py:129-142)."""
    return PipelineConfig(
        name="ti2v-5B",
        dit=DiTConfig(
            model_type="ti2v", in_dim=48, out_dim=48, dim=3072, ffn_dim=14336,
            num_heads=24, num_layers=30, framepack=True,
        ),
        vae=VAEConfig(z_dim=48, base_dim=160, stride=(4, 16, 16), patchify=2,
                      temporal_downsample=(False, True, True)),
        latent_frame_zero=8,
        sample_shift=5.0,
        frame_num=121,
    )


def i2v_a14b() -> PipelineConfig:
    """Stock Wan2.2 I2V A14B dual-expert MoE (reference
    wan23/configs/wan_i2v_A14B.py): two 14B experts (low/high noise) over
    the Wan2.1 VAE, first-frame msk/y conditioning, boundary 0.900,
    per-expert guide scale (3.5, 3.5). No CLIP branch — conditioning is
    the 4-ch msk + 16-ch VAE(y) concat (in_dim 36 = 16+4+16)."""
    return PipelineConfig(
        name="i2v-A14B",
        dit=DiTConfig(
            model_type="i2v", in_dim=36, out_dim=16, dim=5120, ffn_dim=13824,
            freq_dim=256, num_heads=40, num_layers=40, framepack=False,
        ),
        vae=VAEConfig(z_dim=16, base_dim=96, stride=(4, 8, 8), patchify=1,
                      dim_mult=(1, 2, 4, 4), temporal_downsample=(True, True, False),
                      arch="wan21"),
        latent_frame_zero=1,   # single-shot i2v: no autoregressive tail
        sample_shift=5.0,
        # 40 = WanI2V.generate()'s default (wan23/image2video.py:234); the
        # reference config file itself sets sample_steps=5 (that fork's
        # distilled setting), which is NOT what stock serving uses
        sample_steps=40,
        frame_num=81,
        sample_fps=16,
        boundary=0.900,
    ).check_i2v_channels()


def i2v_14b() -> PipelineConfig:
    """Yume-1.0 / 14B / 540P (reference wan/image2video.py:140-153).

    in_dim=36: 16 latent channels + 20 mask/conditioning channels
    (4-channel msk repeated + 16-ch VAE(y); reference wan/image2video.py:300-369).
    """
    return PipelineConfig(
        name="i2v-14B",
        dit=DiTConfig(
            model_type="i2v", in_dim=36, out_dim=16, dim=5120, ffn_dim=13824,
            num_heads=40, num_layers=40, framepack=True,
            image_context_len=257, text_dim=4096,
        ),
        vae=VAEConfig(z_dim=16, base_dim=96, stride=(4, 8, 8), patchify=1,
                      dim_mult=(1, 2, 4, 4), temporal_downsample=(True, True, False),
                      arch="wan21"),
        clip=CLIPConfig(),
        latent_frame_zero=9,
        sample_shift=3.0,
        frame_num=81,
        sample_fps=16,
    ).check_i2v_channels()


CONFIGS = {
    "ti2v-5B": ti2v_5b,
    "i2v-14B": i2v_14b,
    "i2v-A14B": i2v_a14b,
}
