import torch

from .conv import conv1d, conv1d_plain, conv_transpose1d, conv_transpose1d_plain
from .flash_attn import flash_attention, flash_attention_plain
from .fused_act import snake_activation1d, snake_activation1d_plain
from .fused_conv import (act_conv1d, act_conv1d_plain, act_conv_plan, amp_unit,
                         amp_unit_plain, amp_unit_plan)
from .probes import (act_firs_only, act_firs_only_plain, mxu_fir,
                     mxu_fir_plain, snake_only, snake_only_plain)
from .iir import sosfilt, sosfilt_plain

# every kernel wrapper of the port; each carries a ``launches`` count of its
# float32 instance
KERNELS = (snake_activation1d, conv1d, conv_transpose1d, act_conv1d, amp_unit,
           flash_attention)
# the reduced-precision instances (wrapper, dot_dtype); each counts its
# launches in ``wrapper.variant_launches[dot_dtype]``
VARIANTS = ((conv1d, torch.bfloat16), (conv1d, torch.int8),
            (conv_transpose1d, torch.bfloat16), (act_conv1d, torch.bfloat16),
            (act_conv1d, torch.int8), (amp_unit, torch.bfloat16),
            (amp_unit, torch.int8))
# the instances on bfloat16 feature maps (``vocoder_storage_dtype``; kernel
# C's with the vocoder's compute dtype bf16), by (wrapper, dot_dtype); each
# counts its launches in ``wrapper.storage_launches[dot_dtype]``
STORAGE_VARIANTS = ((snake_activation1d, torch.float32),
                    *((fn, dt) for fn in (conv1d, act_conv1d, amp_unit)
                      for dt in (torch.float32, torch.bfloat16, torch.int8)),
                    (conv_transpose1d, torch.float32),
                    (conv_transpose1d, torch.bfloat16))


# the probe kernels (``ops/probes.py``), on no model path: G, H (its four
# instances also counted in ``mxu_fir.instance_launches``) and kernel A's
# firs-only instance
PROBES = (snake_only, mxu_fir, act_firs_only)
# the data pipeline's kernels (``dsp.filters.sosfiltfilt`` on the card), on
# no model path
DSP_KERNELS = (sosfilt,)


def reset_launch_counts() -> None:
    for fn in KERNELS + PROBES + DSP_KERNELS:
        fn.launches = 0
    for fn, dot_dtype in VARIANTS:
        fn.variant_launches[dot_dtype] = 0
    for fn, dot_dtype in STORAGE_VARIANTS:
        fn.storage_launches[dot_dtype] = 0
    for inst in mxu_fir.instance_launches:
        mxu_fir.instance_launches[inst] = 0


__all__ = [
    "snake_activation1d", "snake_activation1d_plain",
    "conv1d", "conv1d_plain", "conv_transpose1d", "conv_transpose1d_plain",
    "act_conv1d", "act_conv1d_plain", "amp_unit", "amp_unit_plain",
    "flash_attention", "flash_attention_plain",
    "snake_only", "snake_only_plain", "mxu_fir", "mxu_fir_plain",
    "act_firs_only", "act_firs_only_plain", "sosfilt", "sosfilt_plain",
    "act_conv_plan", "amp_unit_plan", "KERNELS", "VARIANTS",
    "STORAGE_VARIANTS", "PROBES", "DSP_KERNELS",
    "reset_launch_counts",
]
