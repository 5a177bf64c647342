"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card (``"cuda"``). A CUDA device without CUDA
    raises — the port never carries on on the CPU unless asked to.

    Choosing the card also pins full-f32 matmuls and convolutions: TF32
    is switched off for both, so an f32 product on the card is f32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the card unless "
                "the caller passes device='cpu'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
