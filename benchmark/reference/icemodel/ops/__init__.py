"""Device-side numerical building blocks: ELL sparse operators, the
hand-written kernels (stack SpMV, the DIVA operator, the heat equation's
column solves), the tridiagonal solver and the Krylov solvers.

TF32 stays off: the stress-balance operator's coefficients span ~1e13 and
the GMRES orthogonalisation degrades visibly under reduced-precision
matrix products (the same finding that keeps the reference's Krylov
products out of its low-precision matrix unit)."""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
assert torch.backends.cuda.matmul.allow_tf32 is False


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. The default is the card;
    without one it raises rather than falling back to the host, which a
    caller has to ask for by name (device="cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available "
            "(pass device='cpu' to run on the host)")
    return device
