from .jax_params import (fold_state_dict, fold_weight_norm, mpd_state_from_jax,
                         mrd_state_from_jax, seeded_init_,
                         vector_field_state_from_jax, vocoder_state_from_jax)
from .torch_ckpt import (load_flowhigh_checkpoint, optim_state_to_reference,
                         reference_param_order, scheduler_state_to_reference,
                         vector_field_state_from_reference,
                         vocoder_config_from_json, vocoder_state_from_reference,
                         vocoder_state_to_reference)

__all__ = ["fold_weight_norm", "fold_state_dict", "vector_field_state_from_jax",
           "vocoder_state_from_jax", "mpd_state_from_jax", "mrd_state_from_jax",
           "seeded_init_", "load_flowhigh_checkpoint",
           "vector_field_state_from_reference", "vocoder_config_from_json",
           "vocoder_state_from_reference", "vocoder_state_to_reference",
           "reference_param_order",
           "optim_state_to_reference", "scheduler_state_to_reference"]
