from .jax_params import (fold_state_dict, fold_weight_norm, seeded_init_,
                         vector_field_state_from_jax, vocoder_state_from_jax)

__all__ = ["fold_weight_norm", "fold_state_dict", "vector_field_state_from_jax",
           "vocoder_state_from_jax", "seeded_init_"]
