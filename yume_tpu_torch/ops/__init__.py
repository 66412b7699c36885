"""ops of the PyTorch port (see the package docstring)."""


def kernel_launches() -> dict:
    """The launch counts of the DiT's and the discriminator's kernels, by
    wrapper (0 on the CPU, where their plain versions run): what a rank of
    a ``--sp``/``--pp`` run reports."""
    from . import bias_act as ba
    from . import flash_attention as fl
    from . import fused_adaln as fa
    from . import quant_matmul as qm

    return {f.__name__: f.launches for f in (
        fl.flash_attention, fl.flash_attention_partial, fa.adaln_norm, fa.adaln_residual,
        fa.qk_norm_rope, fa.rms_norm, qm.q8_dot, fl.flash_attention_bwd_dq,
        fl.flash_attention_bwd_dkv, ba.bias_act)}
