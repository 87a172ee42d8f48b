"""Published peaks, by the name `torch.cuda.get_device_name` gives.

NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power limit:
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores (the
port runs its products in full float32: no TF32), 495 TFLOP/s in TF32.
A card that the table does not name has no peak, and a share of a peak
on it is not measured.
"""

PEAKS = {
    'NVIDIA H100 80GB HBM3': dict(bytes_per_s=3.35e12, f32_flops=67e12,
                                  tf32_flops=495e12),
}


def peak(kind, what):
    """The card `kind`'s peak `what`, or None for a card not in the
    table."""
    return PEAKS.get(kind, {}).get(what)
