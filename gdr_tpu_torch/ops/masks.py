"""Positional-validity logit mask of the decode vocabulary (a copy of
``gdr_tpu/ops/masks.py``).

With the position-aware codec, step *p* of the decoder may only emit one of
``{p*kary+2 … p*kary+kary+1}`` or EOS, and the last step only EOS.  The
full-vocab head adds this ``[L, V]`` table of 0 / −1e9 to its logits.
"""

from __future__ import annotations

import numpy as np

from gdr_tpu_torch.ops.codec import EOS_ID, TOKEN_OFFSET

NEG_INF = -1e9


def positional_logit_mask(kary: int, max_output_length: int,
                          position: bool = True) -> np.ndarray:
    """Additive mask [L, V] f32: 0 where valid, -1e9 elsewhere.  Row p
    masks the logits that predict output position p."""
    if position:
        vocab = kary * max_output_length + TOKEN_OFFSET
    else:
        vocab = kary + TOKEN_OFFSET
    mask = np.full((max_output_length, vocab), NEG_INF, dtype=np.float32)
    for p in range(max_output_length):
        if p == max_output_length - 1:
            mask[p, EOS_ID] = 0.0
            continue
        if position:
            lo = p * kary + TOKEN_OFFSET
            mask[p, lo:lo + kary] = 0.0
        else:
            mask[p, TOKEN_OFFSET:TOKEN_OFFSET + kary] = 0.0
        mask[p, EOS_ID] = 0.0
    return mask
