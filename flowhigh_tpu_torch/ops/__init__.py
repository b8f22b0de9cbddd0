from .conv import conv1d, conv1d_plain, conv_transpose1d, conv_transpose1d_plain
from .fused_act import snake_activation1d, snake_activation1d_plain

# every kernel wrapper of the port; each carries a ``launches`` count
KERNELS = (snake_activation1d, conv1d, conv_transpose1d)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "snake_activation1d", "snake_activation1d_plain",
    "conv1d", "conv1d_plain", "conv_transpose1d", "conv_transpose1d_plain",
    "KERNELS", "reset_launch_counts",
]
