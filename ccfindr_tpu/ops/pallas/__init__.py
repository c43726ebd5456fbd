"""GPU kernels (Pallas, Triton route)."""
