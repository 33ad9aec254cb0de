"""repro_torch — the PyTorch/CUDA port of ``repro`` (MPO compression of
pre-trained language models), for one NVIDIA H100.

It imports ``torch`` and never ``jax`` or anything of ``repro``.  It serves
and fine-tunes the dense family and serves the SSM family::

    from repro_torch import Session
    s = Session.init("bert-base", smoke=False)            # on the card
    handle = s.serve(8, 256, paged=True, weight_cache=False)
    tokens = handle.generate({"tokens": prompts}, num_tokens=32)
    m = Session.init("mamba2-130m", smoke=False)          # SSD-scan prefill
    autotune.get_tuner().stats()       # the measured plans' verdicts, on the card
"""

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import MPOConfig
from repro_torch.kernels import autotune
from repro_torch.pipeline.session import ServeHandle, Session

__all__ = ["Session", "ServeHandle", "MPOConfig", "ModelConfig", "autotune", "configs"]
