"""Prompt refinement hook (the template part of
yume_tpu/data/prompt_refine.py; ``TemplateRefiner`` is pinned equal to the
reference's by ``tests/test_torch_configs.py``).

The reference refines prompts with a local HuggingFace VLM (InternVL) or a
remote expansion service. Both need model files or a network, so the port
has only the deterministic template refiner and refuses the others.
"""

from __future__ import annotations

from typing import Optional


class TemplateRefiner:
    """Deterministic no-model refinement: keeps the control clause and adds
    the standard scene/style skeleton the trained model expects."""

    def __call__(self, prompt: str, image=None) -> str:
        if "first-person view" not in prompt:
            prompt = (
                "This video depicts a city walk scene with a first-person "
                "view (FPV)." + prompt
            )
        return prompt


def get_refiner(model_path: Optional[str] = None) -> TemplateRefiner:
    """The template refiner when no model is named; a model path or
    'remote' (the HF and remote refiners) raises NotImplementedError."""
    if model_path:
        raise NotImplementedError(
            f"not ported: the prompt refiner {model_path!r} needs model files or a "
            "network, which ROADMAP lists as not queued; without --refiner_model "
            "the template refiner runs")
    return TemplateRefiner()
