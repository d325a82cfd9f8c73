from stswincl_tpu_torch.ckpt.checkpoint import (SEG_ENCODER_SUBTREES,
                                                latest_step, load_checkpoint,
                                                save_checkpoint,
                                                translate_pretrain_to_seg,
                                                translate_seg_to_pretrain)
from stswincl_tpu_torch.ckpt.from_jax import (jax_path, load_from_jax,
                                              state_dict_from_jax,
                                              to_jax_layout)

__all__ = ["SEG_ENCODER_SUBTREES", "jax_path", "latest_step",
           "load_checkpoint", "load_from_jax", "save_checkpoint",
           "state_dict_from_jax", "to_jax_layout",
           "translate_pretrain_to_seg", "translate_seg_to_pretrain"]
