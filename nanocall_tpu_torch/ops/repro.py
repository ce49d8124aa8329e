"""K10: the row-major reshape copy of the repository's one Pallas kernel
(tools/exp_mosaic_repro.py:31): an (R, M, L) float32 tensor stored as
(R, M * L), (8, 128, 4) -> (8, 512) in the repro.

CPU tensors run the plain version, `x.reshape(R, M * L).clone()`; CUDA
tensors run the kernel of csrc/reshape_copy.cu, or the call raises.  The
two are bit-equal: the copy does no arithmetic.  tools/torch_reshape_repro.py
runs it.
"""

from __future__ import annotations

import torch

from . import _cuda, hmm


def reshape_copy_plain(x: torch.Tensor) -> torch.Tensor:
    R, M, L = x.shape
    return x.reshape(R, M * L).clone()


def reshape_copy_kernel(x: torch.Tensor) -> torch.Tensor:
    """K10 on the card: one thread per output element."""
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"the reshape copy takes an (R, M, L) tensor, got "
                         f"{tuple(x.shape)}")
    R, M, L = x.shape
    hmm._check("x", x, torch.float32, (R, M, L), dev)
    hmm._require_cuda(dev, "reshape copy")
    out = torch.empty((R, M * L), dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_reshape_copy(
        x.data_ptr(), R, M, L, out.data_ptr(), hmm._device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "reshape_copy kernel launch")
    _cuda.count_launch(reshape_copy_kernel)
    return out


reshape_copy_kernel.launches = 0


def reshape_copy(x: torch.Tensor) -> torch.Tensor:
    """K10 on the tensor's device: (R, M, L) -> (R, M * L), row-major."""
    if x.device.type == "cpu":
        return reshape_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no reshape copy for device {x.device}")
    return reshape_copy_kernel(x)
