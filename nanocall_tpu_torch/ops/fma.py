"""K8: the FMA chain behind roofline.measure_fma_peak
(nanocall_tpu/roofline.py:340-392).

fma_chain(x, c, d, T, k) returns the (B, n) float32 carry after T steps of
k dependent `x = x*c + d`, each rounded once, as one FMA rounds.  CPU
tensors run the plain version, a torch loop; CUDA tensors run the kernel
of csrc/fma_chain.cu, or the call raises.

The plain version forms each FMA in float64 and rounds it once to float32:
the product of two float32 values is exact in float64, and so is the sum
whenever its bits span at most 53 places.  On measure_fma_peak's inputs
(x in [0.9, 1.1], c = 0.9999, d = 1e-4) the product's bits run from 2^0
down to 2^-48 and d's from 2^-14 down to 2^-37, so every sum is exact and
the one rounding is the FMA's own: the kernel is held to the plain version
bit for bit.  JAX's chain rounds once per FMA too, where XLA contracts
`x * c + d` into an FMA, as its CPU backend does.
"""

from __future__ import annotations

import torch

from . import _cuda, hmm


def fma_chain_plain(x: torch.Tensor, c, d, T: int, k: int) -> torch.Tensor:
    """T * k dependent float32 `x = x * c + d`, each formed in float64 and
    rounded once to float32 (the FMA's rounding where the float64 sum is
    exact: above); c and d are float32, as the kernel takes them."""
    c = torch.tensor(c, dtype=torch.float32, device=x.device).double()
    d = torch.tensor(d, dtype=torch.float32, device=x.device).double()
    for _ in range(T * k):
        x = (x.double() * c + d).float()
    return x


def fma_chain_kernel(x: torch.Tensor, c, d, T: int, k: int) -> torch.Tensor:
    """K8 on the card: one block per row, the T steps inside the block."""
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"the FMA chain takes a (B, n) carry, got "
                         f"{tuple(x.shape)}")
    B, n = x.shape
    hmm._check("x", x, torch.float32, (B, n), dev)
    if n not in (1024, 2048, 4096, 8192):
        raise ValueError(f"the FMA chain kernel takes n in 1024, 2048, 4096 "
                         f"or 8192 lanes per row, got {n}")
    if T < 0 or k < 0:
        raise ValueError(f"T and k must be >= 0, got T={T}, k={k}")
    hmm._require_cuda(dev, "FMA chain")
    out = torch.empty_like(x)
    lib = _cuda.load()
    err = lib.nc_fma_chain(
        x.data_ptr(), B, n, T, k, float(c), float(d), out.data_ptr(),
        *_cuda.target(dev))
    _cuda.check(err, "fma_chain kernel launch")
    _cuda.count_launch(fma_chain_kernel)
    return out


fma_chain_kernel.launches = 0


def fma_chain(x: torch.Tensor, c, d, T: int, k: int) -> torch.Tensor:
    """K8 on the tensor's device: the (B, n) carry after T steps of k
    dependent FMAs."""
    if x.device.type == "cpu":
        return fma_chain_plain(x, c, d, T, k)
    if x.device.type != "cuda":
        raise ValueError(f"no FMA chain for device {x.device}")
    return fma_chain_kernel(x, c, d, T, k)
