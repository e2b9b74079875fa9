"""The table of peaks: NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the card's full power limit of 700 W. A card set below it
runs slower under load; every share is stated beside the card's limit."""

from __future__ import annotations

# FLOP/s by the configuration's compute dtype; float32 is the rate outside
# the tensor cores (the configurations turn TF32 off)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float64": 34e12}
PEAK_BYTES_PER_S = 3.35e12  # HBM3
ELEM_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}


def msda_bound_s(shapes, dtype: str, backward: bool = False) -> float:
    """The least time one MSDA call can take: the larger of its bytes over
    the memory's rate and its operations over the peak. `shapes` are the
    registered op's input shapes: value [B, S, H, D], the flat spatial
    shapes, loc [B, Lq, H, L, P, 2], attn [B, Lq, H, L, P] (the backward
    op: grad_out [B, Lq, H * D] after them). Bytes: value, loc, attn and
    the output once each (the backward: those read, grad_out, and the three
    gradients written); loc and attn are f32 unless the model is f64.
    Operations: 2 per multiply-add, B x Lq x H x L x P x 4 corners x D of
    them forward, twice that backward."""
    value, loc = shapes[0], shapes[2]
    B, S, H, D = value
    _, Lq, _, L, P, _ = loc
    eb = ELEM_BYTES[dtype]
    lb = 8 if dtype == "float64" else 4
    n_value, n_out = B * S * H * D, B * Lq * H * D
    n_loc, n_attn = B * Lq * H * L * P * 2, B * Lq * H * L * P
    if backward:
        nbytes = (2 * n_value * eb + 2 * (n_loc + n_attn) * lb
                  + n_out * eb)
        flops = 4 * B * Lq * H * L * P * 4 * D
    else:
        nbytes = (n_value + n_out) * eb + (n_loc + n_attn) * lb
        flops = 2 * B * Lq * H * L * P * 4 * D
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
