"""The vector field: the work of one forward over ``frames`` frames of a
batch of ``batch`` (the configuration's ``model`` group).

Dots, 2 operations a multiply-add: the input Linear (2 dim_in -> dim), the
depthwise position conv, per layer the fused q k v projection, the scores
and the weighted sum (2 frames^2 heads dim_head each), the output
projection, and the GEGLU feed-forward (dim -> 2 inner, inner -> dim), the
head (dim -> dim_in). Other operations: five a score (scale, mask, max,
exp, divide), the norms, GELU and residuals at about ten an activation.
Bytes: the inputs and output once, and the float32 weights."""

from __future__ import annotations


def weights(model: dict) -> int:
    d, din = model["dim"], model["dim_in"]
    inner = int(d * model["ff_mult"] * 2 / 3)
    h = model["heads"] * model["dim_head"]
    layer = (2 * 2 * (d * d + d) + 2 * model["heads"] * model["dim_head"]
             + 3 * h * d + h * d + 2 * inner * d + 2 * inner + inner * d + d)
    return (din + d // 2 + d * d + d + 2 * din * d + d
            + d * model["conv_pos_embed_kernel_size"] + d
            + model["depth"] * layer + d + din * d)


def forward(model: dict, frames: int, batch: int = 1) -> dict:
    d, din, n = model["dim"], model["dim_in"], frames
    inner = int(d * model["ff_mult"] * 2 / 3)
    h = model["heads"] * model["dim_head"]
    dots = 2.0 * n * (2 * din * d + model["conv_pos_embed_kernel_size"] * d
                      + d * din)
    per_layer = 2.0 * n * (3 * d * h + h * d + d * 2 * inner + inner * d) \
        + 2.0 * 2 * n * n * h
    dots += model["depth"] * per_layer
    other = model["depth"] * (5.0 * model["heads"] * n * n + 10.0 * n * d * 4)
    byt = 4.0 * (3 * n * din + weights(model) / batch)
    return {"dots": batch * dots, "other": batch * other,
            "bytes": batch * byt}
