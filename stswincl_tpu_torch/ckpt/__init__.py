from stswincl_tpu_torch.ckpt.checkpoint import (SEG_ENCODER_SUBTREES,
                                                latest_step, load_checkpoint,
                                                save_checkpoint,
                                                translate_pretrain_to_seg,
                                                translate_seg_to_pretrain)
from stswincl_tpu_torch.ckpt.from_jax import (jax_path, load_from_jax,
                                              state_dict_from_jax,
                                              to_jax_layout)
from stswincl_tpu_torch.ckpt.torch_import import (import_pixpro_state_dict,
                                                  import_reference,
                                                  import_torchvision_resnet18,
                                                  import_tswinplus_state_dict,
                                                  load_torch_file)

__all__ = ["SEG_ENCODER_SUBTREES", "import_pixpro_state_dict",
           "import_reference", "import_torchvision_resnet18",
           "import_tswinplus_state_dict", "jax_path", "latest_step",
           "load_torch_file",
           "load_checkpoint", "load_from_jax", "save_checkpoint",
           "state_dict_from_jax", "to_jax_layout",
           "translate_pretrain_to_seg", "translate_seg_to_pretrain"]
