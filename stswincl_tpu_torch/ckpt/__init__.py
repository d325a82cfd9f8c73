from stswincl_tpu_torch.ckpt.from_jax import (jax_path, load_from_jax,
                                              state_dict_from_jax,
                                              to_jax_layout)

__all__ = ["jax_path", "load_from_jax", "state_dict_from_jax",
           "to_jax_layout"]
