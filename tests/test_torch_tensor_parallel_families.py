"""Tensor parallelism on torch.distributed (gloo, the CPU) against the JAX
package, for the families beside the dense LM: the SSM (mamba2-780m: a tied
embedding, mamba's projections gathered on use), the hybrid (zamba2-2.7b:
its shared attention and MLP block split), the encoder-decoder
(whisper-medium: the encoder's, the decoder's and the cross-attention's
heads) and the VLM (llava-next: the projector gathered on use), on meshes
(1, 2), (1, 4) and (2, 2) of (data, model), f32 smoke configs.  The cases
are ``tests/_torch_tp_cases.py``'s.
"""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_tp as tt  # noqa: E402
from _torch_tp_cases import *  # noqa: E402,F401,F403

ARCHS = tt.ARCHS["b"]
