"""Feature-rate resampling (port of ``avi_talking_tpu/ops/resample.py``).

wav2vec2 features are resampled from the model's 50 fps to the 25 fps video
rate with ``align_corners=True`` linear interpolation; lip sync depends on
it. The formula is written out (fp32 ``arange * scale``, floor/clip gather,
lerp) exactly as the JAX version does, rather than calling
``F.interpolate``, so the two agree to fp32 rounding.
"""

from __future__ import annotations

import torch


def linear_interpolate(x: torch.Tensor, output_len: int, axis: int = 1) -> torch.Tensor:
    """Linear resample along ``axis`` to ``output_len`` with align_corners=True:
    output index ``i`` reads source coordinate ``i * (L_in - 1) / (L_out - 1)``
    (0 when ``L_out == 1``)."""
    axis = axis % x.dim()
    in_len = x.shape[axis]
    if in_len == output_len:
        return x
    if output_len == 1:
        return x.narrow(axis, 0, 1)
    if in_len == 1:
        reps = [1] * x.dim()
        reps[axis] = output_len
        return x.repeat(*reps)

    scale = (in_len - 1) / (output_len - 1)
    coords = torch.arange(output_len, dtype=torch.float32, device=x.device) * scale
    lo = torch.clamp(torch.floor(coords).to(torch.int64), 0, in_len - 1)
    hi = torch.clamp(lo + 1, 0, in_len - 1)
    frac = (coords - lo.to(torch.float32)).to(x.dtype)

    x_lo = torch.index_select(x, axis, lo)
    x_hi = torch.index_select(x, axis, hi)
    shape = [1] * x.dim()
    shape[axis] = output_len
    return x_lo + (x_hi - x_lo) * frac.reshape(shape)
