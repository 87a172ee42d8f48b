"""Device resolution and the fp32 matmul policy.

Entry points of the package take ``device=None`` and resolve it here:
``None`` means the CUDA card, and a machine without one raises instead of
quietly running on the CPU.  Tests and small CPU runs pass
``device='cpu'`` explicitly.

fp32 matmul policy: every product in the package runs in full float32 (or
float64).  TF32 keeps about three decimal digits, and reduced-precision
products measurably move converged optima (the JAX package pins
``precision=HIGHEST`` for the same reason: viabel_tpu/families.py:89-99).
`resolve_device` applies the policy whenever it hands out a CUDA device,
so `weighted_moments`, `central_moments` and the covariance products never
run in TF32.
"""
import torch

__all__ = ['resolve_device', 'fp32_matmul_policy', 'default_generator']


def fp32_matmul_policy():
    """Forbid TF32 in matrix products and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def resolve_device(device=None):
    """``None`` -> the CUDA card (raises without one); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run on '
                'the CPU')
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda':
        fp32_matmul_policy()
    return device


def default_generator(device, seed=0):
    """A seeded `torch.Generator` on ``device`` (the counterpart of the
    JAX package's default ``PRNGKey(0)``)."""
    return torch.Generator(device=device).manual_seed(seed)
