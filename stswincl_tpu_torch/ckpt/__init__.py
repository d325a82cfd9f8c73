from stswincl_tpu_torch.ckpt.from_jax import load_from_jax, state_dict_from_jax

__all__ = ["load_from_jax", "state_dict_from_jax"]
