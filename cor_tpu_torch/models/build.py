"""The model factory with the reference's public signature, the port's
counterpart of ``cor_tpu.models.build``.

``build_model_with_query_support_feat`` looks the sizes up in the model
tables, draws the port's seeded init (``core_model.init_core_model``), then
does the reference's checkpoint surgery: from a SAM ``.pth`` only
``image_encoder.*`` and ``mask_decoder.*``, so the prompt encoder's
``no_mask_embed`` stays at its seeded init; from a SigLIP ``.bin`` both
towers. Freezing is the trainer's (``train/optim.trainable_mask``).

Returns (model, CoreConfig): the ``CoreModel`` in fp32, on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

from cor_tpu_torch.models.core_model import CoreConfig, CoreModel, init_core_model


def build_model_with_query_support_feat(
    sam_model: str = "sam_base",
    siglip_model: str = "ViT-SO400M-14-SigLIP-384",
    sam_checkpoint_path: Optional[str] = None,
    siglip_checkpoint_path: Optional[str] = None,
    mask_pooling: str = "MaskedPooling",
    multimask_output: bool = False,
    compute_dtype: str = "bfloat16",
    seed: int = 0,
) -> Tuple[CoreModel, CoreConfig]:
    from cor_tpu_torch.utils.convert import load_sam_weights, load_siglip_weights

    cfg = CoreConfig(sam_model=sam_model, siglip_model=siglip_model, mask_pooling=mask_pooling,
                     multimask_output=multimask_output, compute_dtype=compute_dtype)
    model = init_core_model(cfg, seed)
    if sam_checkpoint_path:
        load_sam_weights(model, sam_checkpoint_path, cfg.encoder.depth)
    if siglip_checkpoint_path:
        sig = cfg.support.siglip
        load_siglip_weights(model, siglip_checkpoint_path, sig.vision.depth, sig.text.depth)
    return model, cfg
